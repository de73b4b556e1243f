// Newton half-stencil cell-pair sweep for Hopper (sm_90a).
//
// Replaces atomsmm_tpu/ops/pallas_pair.py::_half_kernel. Each home cell c
// meets the 14 half-stencil cells nbr[c, k] (k = 0 is c itself, then the 13
// lexicographically positive directions). On every (home atom, candidate)
// slot it applies the per-slot minimum image, the cutoff test, the
// exclusions and one of the built-in pair forms (pair_forms.cuh), and
// accumulates the force -2 du/dr^2 dx on the home atom and the reaction on
// the candidate. Exclusions take one of two forms, a template parameter:
// the relative-offset bitmask (one shift per slot), or, for systems whose
// excluded pairs lie more than +-14 atom indices apart, a compare of the
// candidate id with the home atom's exclusion id columns, held in
// registers, plus the self test hid != cid.
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

#include "pair_forms.cuh"

namespace {

using namespace pairforms;

// One block per (home cell c, direction k): blockIdx.x = c * s_half + k.
//   hf  (ncells, cap, 8) [x y z q sigma eps 0 0]; padding slots read zeros
//   hm  (ncells, cap, 2) [atom id (n = padding), exclusion bits]
//   hx  (ncells, cap, m) exclusion id columns (-1 padded), read only by the
//       column form (COLS), which systems without the bitmask take
//   nbr (ncells, s_half) half-stencil cell map, column 0 = the cell itself
//   box (3,) orthorhombic edge lengths
//   oh  (ncells, s_half, cap, 4) per home atom [fx fy fz e]
//   oc  (ncells, s_half, cap, 3) per candidate atom: reaction sums
template <typename T, bool COLS, bool DAMPED>
__global__ void half_pair_kernel(const T* __restrict__ hf,
                                 const int* __restrict__ hm,
                                 const int* __restrict__ hx,
                                 const int* __restrict__ nbr,
                                 const T* __restrict__ box, int cap,
                                 int s_half, int n, int m, Params<T> p,
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
  ExcCols cols;
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
  if (COLS) load_exc_cols(active ? hx + ((size_t)c * cap + t) * m : nullptr,
                          m, cols);
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
      const T dx = min_image(xi - sx[j], bx, ibx);
      const T dy = min_image(yi - sy[j], by, iby);
      const T dz = min_image(zi - sz[j], bz, ibz);
      const T r2 = dx * dx + dy * dy + dz * dz;
      const bool excl = COLS ? (oid_c == oid_h || excluded_by_cols(cols, m, oid_c))
                             : excluded_by_bits(exc_h, oid_h, oid_c);
      if (oid_c < n && r2 < p.rc2 && !excl) {
        const T qq = qi * sq[j];
        const T sig = T(0.5) * (si + ss[j]);
        const T eps = sqrt(ei * se[j]);
        T u, dudr2;
        pair_form<T, DAMPED>(p, r2, qq, sig, eps, u, dudr2);
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

template <typename T, bool COLS, bool DAMPED>
int launch_form(const T* hf, const int* hm, const int* hx, const int* nbr,
                const T* box, int ncells, int cap, int s_half, int n, int m,
                const Params<T>& p, T* oh, T* oc, cudaStream_t stream) {
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
      hf, hm, hx, nbr, box, cap, s_half, n, m, p, oh, oc);
  return (int)cudaGetLastError();
}

template <typename T, bool COLS>
int launch_cols(const T* hf, const int* hm, const int* hx, const int* nbr,
                const T* box, int ncells, int cap, int s_half, int n, int m,
                const Params<T>& p, T* oh, T* oc, cudaStream_t stream) {
  if (damped(p)) {
    return launch_form<T, COLS, true>(hf, hm, hx, nbr, box, ncells, cap,
                                      s_half, n, m, p, oh, oc, stream);
  }
  return launch_form<T, COLS, false>(hf, hm, hx, nbr, box, ncells, cap,
                                     s_half, n, m, p, oh, oc, stream);
}

template <typename T>
int launch(const T* hf, const int* hm, const int* hx, const int* nbr,
           const T* box, int ncells, int cap, int s_half, int n, int m,
           const double* scal, const int* flags, T* oh, T* oc, void* stream) {
  if (cap < 1 || cap > 1024 || ncells < 1 || s_half < 1 || m < 0 ||
      m > MAX_EXC || (hx != nullptr && m < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params<T> p = make_params<T>(scal, flags);
  cudaStream_t s = (cudaStream_t)stream;
  if (hx != nullptr) {
    return launch_cols<T, true>(hf, hm, hx, nbr, box, ncells, cap, s_half, n,
                                m, p, oh, oc, s);
  }
  return launch_cols<T, false>(hf, hm, hx, nbr, box, ncells, cap, s_half, n,
                               0, p, oh, oc, s);
}

}  // namespace

// Plain C entry points, bound with ctypes. `scal` and `flags` are host
// arrays (pair_forms.cuh::make_params). `hx` is null for the bitmask form,
// else the (ncells, cap, m) exclusion id columns, 1 <= m <= 16. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int half_pair_f32(const float* hf, const int* hm, const int* hx,
                             const int* nbr, const float* box, int ncells,
                             int cap, int s_half, int n, int m,
                             const double* scal, const int* flags, float* oh,
                             float* oc, void* stream) {
  return launch<float>(hf, hm, hx, nbr, box, ncells, cap, s_half, n, m, scal,
                       flags, oh, oc, stream);
}

extern "C" int half_pair_f64(const double* hf, const int* hm, const int* hx,
                             const int* nbr, const double* box, int ncells,
                             int cap, int s_half, int n, int m,
                             const double* scal, const int* flags, double* oh,
                             double* oc, void* stream) {
  return launch<double>(hf, hm, hx, nbr, box, ncells, cap, s_half, n, m, scal,
                        flags, oh, oc, stream);
}
