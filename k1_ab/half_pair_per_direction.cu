// K1's earlier body behind K1's present interface: a drop-in replacement of
// atomsmm_tpu_torch/csrc/half_pair.cu, for measurement only (k1_timing.py).
//
// The body is the per-(home cell, direction) sweep the redesigned K1
// replaced: one thread block per (home cell, direction), one home atom per
// thread in registers, the candidate cell staged in shared memory with no
// overlap of copy and compute, every slot of the candidate cell walked by
// every thread with the pair form behind the slot test, and the reaction
// sums accumulated with shared-memory atomics. Only its inputs and output
// follow the present interface: the block gathers its atoms through the
// bucket ids (no staged copy), and adds the home atoms' [fx fy fz e] and the
// candidates' reactions to the zeroed per-atom (n + 1, 4) tensor by global
// atomics. So the two bodies can be timed behind the same wrapper, and the
// gain of the per-atom output told apart from that of the body.

#include "pair_forms.cuh"

namespace {

using namespace pairforms;

__device__ __forceinline__ void add_row(float* row, float a, float b, float c,
                                        float d) {
  atomicAdd(reinterpret_cast<float4*>(row), make_float4(a, b, c, d));
}

__device__ __forceinline__ void add_row(double* row, double a, double b,
                                        double c, double d) {
  atomicAdd(row, a);
  atomicAdd(row + 1, b);
  atomicAdd(row + 2, c);
  if (d != 0.0) atomicAdd(row + 3, d);
}

// One block per (home cell c, direction k): blockIdx.x = c * s_half + k.
// Arguments as in csrc/half_pair.cu.
template <typename T, bool COLS, bool DAMPED>
__global__ void half_pair_kernel(const T* __restrict__ x, const T* __restrict__ q,
                                 const T* __restrict__ sig,
                                 const T* __restrict__ eps,
                                 const int* __restrict__ excbits,
                                 const int* __restrict__ exc,
                                 const int* __restrict__ bucket,
                                 const int* __restrict__ nbr,
                                 const T* __restrict__ box, int cap,
                                 int s_half, int n, int m, Params<T> p,
                                 T* __restrict__ out) {
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
    const int id = bucket[(size_t)nc * cap + j];
    const bool real = id < n;
    sid[j] = id;
    sx[j] = real ? x[3 * (size_t)id] : T(0);
    sy[j] = real ? x[3 * (size_t)id + 1] : T(0);
    sz[j] = real ? x[3 * (size_t)id + 2] : T(0);
    sq[j] = real ? q[id] : T(0);
    ss[j] = real ? sig[id] : T(0);
    se[j] = real ? eps[id] : T(0);
    rx[j] = T(0);
    ry[j] = T(0);
    rz[j] = T(0);
  }

  const int hid = t < cap ? bucket[(size_t)c * cap + t] : n;
  const bool home = hid < n;
  T xi = T(0), yi = T(0), zi = T(0), qi = T(0), si = T(0), ei = T(0);
  unsigned exc_h = 0u;
  ExcCols cols;
  if (home) {
    xi = x[3 * (size_t)hid];
    yi = x[3 * (size_t)hid + 1];
    zi = x[3 * (size_t)hid + 2];
    qi = q[hid];
    si = sig[hid];
    ei = eps[hid];
    if (!COLS) exc_h = (unsigned)excbits[hid];
  }
  if (COLS) load_exc_cols(home ? exc + (size_t)hid * m : nullptr, m, cols);
  __syncthreads();

  const T bx = box[0], by = box[1], bz = box[2];
  const T ibx = T(1) / bx, iby = T(1) / by, ibz = T(1) / bz;
  const bool self_col = (k == 0);
  const T w = self_col ? T(0.5) : T(1);
  T fx = T(0), fy = T(0), fz = T(0), e = T(0);

  if (home) {
    for (int jj = 0; jj < cap; ++jj) {
      // staggered start: the lanes of a warp touch distinct candidates, so
      // the shared-memory reaction atomics below never collide in a warp
      int j = t + jj;
      if (j >= cap) j -= cap;
      const int cid = sid[j];
      const T dx = min_image(xi - sx[j], bx, ibx);
      const T dy = min_image(yi - sy[j], by, iby);
      const T dz = min_image(zi - sz[j], bz, ibz);
      const T r2 = dx * dx + dy * dy + dz * dz;
      const bool excl = COLS ? (cid == hid || excluded_by_cols(cols, m, cid))
                             : excluded_by_bits(exc_h, hid, cid);
      if (cid < n && r2 < p.rc2 && !excl) {
        const T qq = qi * sq[j];
        const T sg = T(0.5) * (si + ss[j]);
        const T ep = sqrt(ei * se[j]);
        T u, dudr2;
        pair_form<T, DAMPED>(p, r2, qq, sg, ep, u, dudr2);
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

  if (home) add_row(out + 4 * (size_t)hid, fx, fy, fz, e);
  if (!self_col) {
    for (int j = t; j < cap; j += blockDim.x) {
      const int id = sid[j];
      if (id < n && (rx[j] != T(0) || ry[j] != T(0) || rz[j] != T(0))) {
        add_row(out + 4 * (size_t)id, rx[j], ry[j], rz[j], T(0));
      }
    }
  }
}

template <typename T, bool COLS, bool DAMPED>
int launch_form(const T* x, const T* q, const T* sig, const T* eps,
                const int* excbits, const int* exc, const int* bucket,
                const int* nbr, const T* box, int ncells, int cap, int s_half,
                int n, int m, const Params<T>& p, T* out,
                cudaStream_t stream) {
  const int threads = ((cap + 31) / 32) * 32;
  const size_t smem = (size_t)cap * (9 * sizeof(T) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        half_pair_kernel<T, COLS, DAMPED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)ncells * (unsigned)s_half;
  half_pair_kernel<T, COLS, DAMPED><<<blocks, threads, smem, stream>>>(
      x, q, sig, eps, excbits, exc, bucket, nbr, box, cap, s_half, n, m, p,
      out);
  return (int)cudaGetLastError();
}

template <typename T, bool COLS>
int launch_cols(const T* x, const T* q, const T* sig, const T* eps,
                const int* excbits, const int* exc, const int* bucket,
                const int* nbr, const T* box, int ncells, int cap, int s_half,
                int n, int m, const Params<T>& p, T* out,
                cudaStream_t stream) {
  if (damped(p)) {
    return launch_form<T, COLS, true>(x, q, sig, eps, excbits, exc, bucket,
                                      nbr, box, ncells, cap, s_half, n, m, p,
                                      out, stream);
  }
  return launch_form<T, COLS, false>(x, q, sig, eps, excbits, exc, bucket,
                                     nbr, box, ncells, cap, s_half, n, m, p,
                                     out, stream);
}

template <typename T>
int launch(const T* x, const T* q, const T* sig, const T* eps,
           const int* excbits, const int* exc, const int* bucket,
           const int* nbr, const T* box, int ncells, int cap, int s_half,
           int n, int m, const double* scal, const int* flags, T* out,
           void* stream) {
  if (cap < 1 || cap > 1024 || ncells < 1 || s_half < 1 || n < 0 || m < 0 ||
      m > MAX_EXC || (exc != nullptr && m < 1) ||
      (exc == nullptr && excbits == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params<T> p = make_params<T>(scal, flags);
  cudaStream_t s = (cudaStream_t)stream;
  if (exc != nullptr) {
    return launch_cols<T, true>(x, q, sig, eps, excbits, exc, bucket, nbr,
                                box, ncells, cap, s_half, n, m, p, out, s);
  }
  return launch_cols<T, false>(x, q, sig, eps, excbits, exc, bucket, nbr, box,
                               ncells, cap, s_half, n, 0, p, out, s);
}

}  // namespace

extern "C" int half_pair_f32(const float* x, const float* q, const float* sig,
                             const float* eps, const int* excbits,
                             const int* exc, const int* bucket, const int* nbr,
                             const float* box, int ncells, int cap, int s_half,
                             int n, int m, const double* scal,
                             const int* flags, float* out, void* stream) {
  return launch<float>(x, q, sig, eps, excbits, exc, bucket, nbr, box, ncells,
                       cap, s_half, n, m, scal, flags, out, stream);
}

extern "C" int half_pair_f64(const double* x, const double* q,
                             const double* sig, const double* eps,
                             const int* excbits, const int* exc,
                             const int* bucket, const int* nbr,
                             const double* box, int ncells, int cap,
                             int s_half, int n, int m, const double* scal,
                             const int* flags, double* out, void* stream) {
  return launch<double>(x, q, sig, eps, excbits, exc, bucket, nbr, box,
                        ncells, cap, s_half, n, m, scal, flags, out, stream);
}
