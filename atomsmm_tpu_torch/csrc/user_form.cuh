// The math of the generated user pair forms (ops/pairtrace.py), for the
// card and for the host alike: each helper is __host__ __device__, so a
// host compiler builds the very text K1 and K2 compile. In float32 the
// card takes what pair_forms.cuh's rsqrt_t, erfc_t and exp_t take
// (rsqrtf, erfcf, expf); the host, which has no rsqrtf, takes
// 1 / sqrtf(x), as torch's float32 rsqrt does on the CPU. In float64 both
// take 1 / sqrt(x), as ops/rv.py::make_rv does.
#pragma once

#include <math.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace userform {

__host__ __device__ __forceinline__ float u_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
__host__ __device__ __forceinline__ double u_rsqrt(double x) {
  return 1.0 / sqrt(x);
}

#define USERFORM_UNARY(NAME, F32, F64)                                   \
  __host__ __device__ __forceinline__ float NAME(float x) { return F32(x); } \
  __host__ __device__ __forceinline__ double NAME(double x) { return F64(x); }

USERFORM_UNARY(u_exp, expf, exp)
USERFORM_UNARY(u_log, logf, log)
USERFORM_UNARY(u_sqrt, sqrtf, sqrt)
USERFORM_UNARY(u_erfc, erfcf, erfc)
USERFORM_UNARY(u_erf, erff, erf)
USERFORM_UNARY(u_tanh, tanhf, tanh)
USERFORM_UNARY(u_sin, sinf, sin)
USERFORM_UNARY(u_cos, cosf, cos)
USERFORM_UNARY(u_abs, fabsf, fabs)
USERFORM_UNARY(u_atan, atanf, atan)
USERFORM_UNARY(u_asin, asinf, asin)
USERFORM_UNARY(u_acos, acosf, acos)
USERFORM_UNARY(u_sinh, sinhf, sinh)
USERFORM_UNARY(u_cosh, coshf, cosh)
USERFORM_UNARY(u_expm1, expm1f, expm1)
USERFORM_UNARY(u_log1p, log1pf, log1p)
#undef USERFORM_UNARY

__host__ __device__ __forceinline__ float u_pow(float x, float y) {
  return powf(x, y);
}
__host__ __device__ __forceinline__ double u_pow(double x, double y) {
  return pow(x, y);
}

// sign(x): 1, -1, or 0 at 0 (torch.sign; the tangent of |x|)
template <typename T>
__host__ __device__ __forceinline__ T u_sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

}  // namespace userform
