// Newton half-stencil cell-pair sweep for Hopper (sm_90a).
//
// Replaces atomsmm_tpu/ops/pallas_pair.py::_half_kernel. Each home cell c
// meets the 14 half-stencil cells nbr[c, k] (k = 0 is c itself, then the 13
// lexicographically positive directions). On every (home atom, candidate)
// slot it applies the per-slot minimum image, the cutoff test, the
// relative-offset exclusion bitmask and one of the built-in pair forms, and
// accumulates the force -2 du/dr^2 dx on the home atom and the reaction on
// the candidate.
//
// What bounds it: the pair-slot arithmetic, mostly the reciprocal square
// root and the 6th/12th powers of the pair forms; far sweep 343 cells x 14
// directions x 112^2 slots, near sweep 1331 x 14 x 36^2 on the 30k water
// headline. Its design keeps every pair tile out of device memory: one
// thread block per (home cell, direction), one home atom per thread in
// registers, the candidate cell staged in shared memory, and the reaction
// sums accumulated there with shared-memory atomics. Device memory sees only
// the staged bucket features and the per-(cell, direction) outputs, which
// the host-side wrapper (ops/pair_kernel.py) reduces and scatters to atoms.
// There is no cross-block reduction and no global atomic.
//
// The plain PyTorch twin of this file is ops/pair_kernel.py::half_pair_plain
// with ops/pairfuncs.py::form_u_dudr2, line for line.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double ONE_4PI_EPS0 = 138.935456;

template <typename T>
struct Params {
  T rc2;       // mask cutoff squared
  T sw_rs;     // full form: switch start
  T sw_inv_w;  // full form: 1 / (r_cut - r_switch)
  T k_rf;      // reaction field
  T c_rf;
  T n_rs;      // near form: switch start
  T n_inv_w;   // near form: 1 / (rc_in - rs_in)
  T n_rc;      // near form: cutoff
  T n_rcinv;   // near form: 1 / cutoff
  T near_sign; // +1 near force, -1 inside the fused far force
  int has_full;
  int use_switch;
  int has_near;
};

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return 1.0 / sqrt(x); }

// Quintic switch S(x) = 1 - 10x^3 + 15x^4 - 6x^5 on x clipped to [0, 1],
// and dS/dx = -30 x^2 (1 - x)^2 (zero at both clip ends).
template <typename T>
__device__ __forceinline__ void switch_quintic(T x, T& s, T& ds_dx) {
  x = x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
  s = T(1) + x * x * x * (T(-10) + x * (T(15) - T(6) * x));
  T om = T(1) - x;
  ds_dx = T(-30) * x * x * om * om;
}

// Energy u and du/dr^2 of one pair at squared distance r2, with qq the
// charge product and (sig, eps) the Lorentz-Berthelot pair parameters.
template <typename T>
__device__ __forceinline__ void pair_form(const Params<T>& p, T r2, T qq,
                                          T sig, T eps, T& u, T& dudr2) {
  const T kc = T(ONE_4PI_EPS0);
  T rinv = rsqrt_t(r2);
  T r = r2 * rinv;
  T rinv2 = rinv * rinv;
  u = T(0);
  dudr2 = T(0);
  if (p.has_full) {
    // switched LJ + reaction-field Coulomb (NonbondedForce, method cutoff)
    T t = sig * rinv;
    T t2 = t * t;
    T s6 = t2 * t2 * t2;
    T ulj = T(4) * eps * s6 * (s6 - T(1));
    T dulj = T(-12) * eps * s6 * (T(2) * s6 - T(1)) * rinv2;
    T sw = T(1), dsw = T(0);
    if (p.use_switch) {
      T ds_dx;
      switch_quintic((r - p.sw_rs) * p.sw_inv_w, sw, ds_dx);
      dsw = ds_dx * p.sw_inv_w * T(0.5) * rinv;
    }
    T uc = kc * qq * (rinv + p.k_rf * r2 - p.c_rf);
    T duc = kc * qq * (p.k_rf - T(0.5) * rinv * rinv2);
    u += ulj * sw + uc;
    dudr2 += dulj * sw + ulj * dsw + duc;
  }
  if (p.has_near) {
    // shifted-force LJ + Coulomb, switched to zero at n_rc (alpha = 0)
    T xs = (r - p.n_rs) * p.n_inv_w;
    if (xs < T(1)) {
      T sw, ds_dx;
      switch_quintic(xs, sw, ds_dx);
      T dsw_dr = ds_dx * p.n_inv_w;
      T cq = kc * qq;
      T t = sig * rinv;
      T t2 = t * t;
      T s6 = t2 * t2 * t2;
      T base = T(4) * eps * s6 * (s6 - T(1)) + cq * rinv;
      T dbase = -rinv * (T(24) * eps * s6 * (T(2) * s6 - T(1)) + cq * rinv);
      T tc = sig * p.n_rcinv;
      T tc2 = tc * tc;
      T s6c = tc2 * tc2 * tc2;
      T base_c = T(4) * eps * s6c * (s6c - T(1)) + cq * p.n_rcinv;
      T dbase_c =
          -p.n_rcinv * (T(24) * eps * s6c * (T(2) * s6c - T(1)) + cq * p.n_rcinv);
      T sh = base - base_c - dbase_c * (r - p.n_rc);
      T un = sh * sw;
      T dun_dr = (dbase - dbase_c) * sw + sh * dsw_dr;
      u += p.near_sign * un;
      dudr2 += p.near_sign * dun_dr * T(0.5) * rinv;
    }
  }
}

// One block per (home cell c, direction k): blockIdx.x = c * s_half + k.
//   hf  (ncells, cap, 8) [x y z q sigma eps 0 0]; padding slots read zeros
//   hm  (ncells, cap, 2) [atom id (n = padding), exclusion bits]
//   nbr (ncells, s_half) half-stencil cell map, column 0 = the cell itself
//   box (3,) orthorhombic edge lengths
//   oh  (ncells, s_half, cap, 4) per home atom [fx fy fz e]
//   oc  (ncells, s_half, cap, 3) per candidate atom: reaction sums
template <typename T>
__global__ void half_pair_kernel(const T* __restrict__ hf,
                                 const int* __restrict__ hm,
                                 const int* __restrict__ nbr,
                                 const T* __restrict__ box, int cap,
                                 int s_half, int n, Params<T> p,
                                 T* __restrict__ oh, T* __restrict__ oc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + cap;
  T* sz = sy + cap;
  T* sq = sz + cap;
  T* ss = sq + cap;
  T* se = ss + cap;
  T* rx = se + cap;
  T* ry = rx + cap;
  T* rz = ry + cap;
  int* sid = reinterpret_cast<int*>(rz + cap);

  const int b = blockIdx.x;
  const int c = b / s_half;
  const int k = b - c * s_half;
  const int t = threadIdx.x;
  const int nc = nbr[c * s_half + k];

  for (int j = t; j < cap; j += blockDim.x) {
    const T* f = hf + ((size_t)nc * cap + j) * 8;
    sx[j] = f[0];
    sy[j] = f[1];
    sz[j] = f[2];
    sq[j] = f[3];
    ss[j] = f[4];
    se[j] = f[5];
    sid[j] = hm[((size_t)nc * cap + j) * 2];
    rx[j] = T(0);
    ry[j] = T(0);
    rz[j] = T(0);
  }

  const bool active = t < cap;
  T xi = T(0), yi = T(0), zi = T(0), qi = T(0), si = T(0), ei = T(0);
  int oid_h = n;
  unsigned exc_h = 0u;
  if (active) {
    const T* f = hf + ((size_t)c * cap + t) * 8;
    xi = f[0];
    yi = f[1];
    zi = f[2];
    qi = f[3];
    si = f[4];
    ei = f[5];
    oid_h = hm[((size_t)c * cap + t) * 2];
    exc_h = (unsigned)hm[((size_t)c * cap + t) * 2 + 1];
  }
  __syncthreads();

  const T bx = box[0], by = box[1], bz = box[2];
  const T ibx = T(1) / bx, iby = T(1) / by, ibz = T(1) / bz;
  const bool self_col = (k == 0);
  const T w = self_col ? T(0.5) : T(1);
  T fx = T(0), fy = T(0), fz = T(0), e = T(0);

  if (active && oid_h < n) {
    for (int jj = 0; jj < cap; ++jj) {
      // staggered start: the lanes of a warp touch distinct candidates, so
      // the shared-memory reaction atomics below never collide in a warp
      int j = t + jj;
      if (j >= cap) j -= cap;
      const int oid_c = sid[j];
      T dx = xi - sx[j];
      T dy = yi - sy[j];
      T dz = zi - sz[j];
      dx -= bx * rint(dx * ibx);
      dy -= by * rint(dy * iby);
      dz -= bz * rint(dz * ibz);
      const T r2 = dx * dx + dy * dy + dz * dz;
      int off = oid_c - oid_h + 16;
      off = off < 0 ? 0 : (off > 31 ? 31 : off);
      const unsigned bit = (exc_h >> off) & 1u;
      if (oid_c < n && r2 < p.rc2 && bit == 0u) {
        const T qq = qi * sq[j];
        const T sig = T(0.5) * (si + ss[j]);
        const T eps = sqrt(ei * se[j]);
        T u, dudr2;
        pair_form(p, r2, qq, sig, eps, u, dudr2);
        const T fm = T(2) * dudr2;
        const T gx = fm * dx, gy = fm * dy, gz = fm * dz;
        fx -= gx;
        fy -= gy;
        fz -= gz;
        e += w * u;
        if (!self_col) {
          atomicAdd(&rx[j], gx);
          atomicAdd(&ry[j], gy);
          atomicAdd(&rz[j], gz);
        }
      }
    }
  }
  __syncthreads();

  const size_t row = ((size_t)c * s_half + k) * cap;
  if (active) {
    T* o = oh + (row + t) * 4;
    o[0] = fx;
    o[1] = fy;
    o[2] = fz;
    o[3] = e;
  }
  for (int j = t; j < cap; j += blockDim.x) {
    T* o = oc + (row + j) * 3;
    o[0] = rx[j];
    o[1] = ry[j];
    o[2] = rz[j];
  }
}

template <typename T>
int launch(const T* hf, const int* hm, const int* nbr, const T* box,
           int ncells, int cap, int s_half, int n, const double* scal,
           const int* flags, T* oh, T* oc, void* stream) {
  if (cap < 1 || cap > 1024 || ncells < 1 || s_half < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params<T> p;
  p.rc2 = (T)scal[0];
  p.sw_rs = (T)scal[1];
  p.sw_inv_w = (T)scal[2];
  p.k_rf = (T)scal[3];
  p.c_rf = (T)scal[4];
  p.n_rs = (T)scal[5];
  p.n_inv_w = (T)scal[6];
  p.n_rc = (T)scal[7];
  p.n_rcinv = (T)scal[8];
  p.near_sign = (T)scal[9];
  p.has_full = flags[0];
  p.use_switch = flags[1];
  p.has_near = flags[2];
  const int threads = ((cap + 31) / 32) * 32;
  const size_t smem = (size_t)cap * (9 * sizeof(T) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        half_pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)ncells * (unsigned)s_half;
  half_pair_kernel<T><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      hf, hm, nbr, box, cap, s_half, n, p, oh, oc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. `scal` and `flags` are host
// arrays: scal = [rc2, sw_rs, sw_inv_w, k_rf, c_rf, n_rs, n_inv_w, n_rc,
// n_rcinv, near_sign], flags = [has_full, use_switch, has_near]. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int half_pair_f32(const float* hf, const int* hm, const int* nbr,
                             const float* box, int ncells, int cap,
                             int s_half, int n, const double* scal,
                             const int* flags, float* oh, float* oc,
                             void* stream) {
  return launch<float>(hf, hm, nbr, box, ncells, cap, s_half, n, scal, flags,
                       oh, oc, stream);
}

extern "C" int half_pair_f64(const double* hf, const int* hm, const int* nbr,
                             const double* box, int ncells, int cap,
                             int s_half, int n, const double* scal,
                             const int* flags, double* oh, double* oc,
                             void* stream) {
  return launch<double>(hf, hm, nbr, box, ncells, cap, s_half, n, scal, flags,
                        oh, oc, stream);
}
