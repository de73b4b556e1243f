// Flat tile-pair sweep for Hopper (sm_90a).
//
// Replaces atomsmm_tpu/ops/tilepair.py::_tile_kernel. Atoms are sorted in
// serpentine cell order and cut into blocks of B atoms (ops/blocks.py);
// ops/tilepair.py::build_tile_pairs lists the Newton block pairs whose
// periodic bounding boxes lie within the build radius, two candidate blocks
// per entry. Entry e evaluates home block hb[e] against candidate blocks
// cb[e, 0] and cb[e, 1] as one dense (B, 2B) tile:
//   * the candidate coordinates are shifted by the entry's integer wrap
//     vectors (wrap[e, half] * box) instead of a per-slot minimum image;
//   * exclusions and the self pair are one relative-offset bitmask test;
//     sentinel slots carry coordinates poisoned at 1e4 nm (and the
//     sentinel's self bit), so the kernel needs no id-validity compares;
//   * a half whose candidate block is the home block at zero wrap (the self
//     tile) holds both orderings of each pair: energy weight 1/2 and no
//     reaction; every other half weighs 1 and carries the reaction.
//
// What bounds it: the pair-slot arithmetic of the pair forms
// (pair_forms.cuh), on dense tiles: at 30k water and a 0.9 nm cutoff the
// list holds about 16.6k entries x 64 x 128 = 136 M slots. One thread block
// per entry, one home atom per thread (B threads) with its sums in
// registers; the 2B candidates, pre-shifted by their wrap, staged in shared
// memory, and the reaction sums accumulated there with shared-memory
// atomics (staggered start, as in half_pair.cu). On the TPU the home and
// reaction sums accumulated race-free only because Pallas grid programs ran
// in order; CUDA blocks run concurrently, so each block adds its home sums
// and its reaction sums to the (NB + 1, B, 4) accumulator with global
// atomics, one per atom and component. The accumulator therefore sums in an
// order that changes from run to run: float32 results differ in their last
// bits between runs, float64 ones far below the tests' tolerances. Entries
// whose home block is the sentinel NB (the unused tail of the list) return
// at once; reactions aimed at the sentinel block are not written.
//
// The plain PyTorch twin of this file is ops/tilepair.py::tile_pair_plain.

#include "pair_forms.cuh"

namespace {

using namespace pairforms;

constexpr int MAX_B = 128;

//   fs   (NB + 1, B, 8) [x y z q sigma eps 0 0] in sorted block order; the
//        sentinel block NB and padding slots sit at the poison coordinate
//   ms   (NB + 1, B, 2) [atom id (n = padding), exclusion bits]
//   hb   (E,) home block, NB = unused entry
//   cb   (E, 2) candidate blocks, NB = none
//   wrap (E, 2, 3) integer periodic shift of each candidate half
//   acc  (NB + 1, B, 4) [fx fy fz e], zeroed by the caller, added to here
template <typename T>
__global__ void __launch_bounds__(MAX_B)
tile_pair_kernel(const T* __restrict__ fs, const int* __restrict__ ms,
                 const int* __restrict__ hb, const int* __restrict__ cb,
                 const int* __restrict__ wrap, const T* __restrict__ box,
                 int nb, Params<T> p, T* __restrict__ acc) {
  __shared__ T sx[2 * MAX_B], sy[2 * MAX_B], sz[2 * MAX_B];
  __shared__ T sq[2 * MAX_B], ss[2 * MAX_B], se[2 * MAX_B];
  __shared__ T rx[2 * MAX_B], ry[2 * MAX_B], rz[2 * MAX_B];
  __shared__ int sid[2 * MAX_B];

  const int ent = blockIdx.x;
  const int h = hb[ent];
  if (h >= nb) return;  // the whole block leaves: no barrier is skipped
  const int b = blockDim.x;
  const int t = threadIdx.x;
  const int cblk[2] = {cb[2 * ent], cb[2 * ent + 1]};
  const int* w = wrap + 6 * ent;
  const T bx = box[0], by = box[1], bz = box[2];
  bool self_half[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int* wh = w + 3 * half;
    self_half[half] =
        cblk[half] == h && wh[0] == 0 && wh[1] == 0 && wh[2] == 0;
    const int j = half * b + t;
    const size_t src = (size_t)cblk[half] * b + t;
    const T* f = fs + src * 8;
    sx[j] = f[0] + T(wh[0]) * bx;
    sy[j] = f[1] + T(wh[1]) * by;
    sz[j] = f[2] + T(wh[2]) * bz;
    sq[j] = f[3];
    ss[j] = f[4];
    se[j] = f[5];
    sid[j] = ms[src * 2];
    rx[j] = T(0);
    ry[j] = T(0);
    rz[j] = T(0);
  }
  const size_t home = (size_t)h * b + t;
  const T* f = fs + home * 8;
  const T xi = f[0], yi = f[1], zi = f[2], qi = f[3], si = f[4], ei = f[5];
  const int oid_h = ms[home * 2];
  const unsigned exc_h = (unsigned)ms[home * 2 + 1];
  __syncthreads();

  const int b2 = 2 * b;
  T fx = T(0), fy = T(0), fz = T(0), e = T(0);
  for (int jj = 0; jj < b2; ++jj) {
    // staggered start: the lanes of a warp touch distinct candidates, so
    // the shared-memory reaction atomics never collide in a warp
    int j = t + jj;
    if (j >= b2) j -= b2;
    const T dx = xi - sx[j];
    const T dy = yi - sy[j];
    const T dz = zi - sz[j];
    const T r2 = dx * dx + dy * dy + dz * dz;
    if (r2 < p.rc2 && !excluded_by_bits(exc_h, oid_h, sid[j])) {
      const bool self = j < b ? self_half[0] : self_half[1];
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
      e += self ? T(0.5) * u : u;
      if (!self) {
        atomicAdd(&rx[j], gx);
        atomicAdd(&ry[j], gy);
        atomicAdd(&rz[j], gz);
      }
    }
  }
  __syncthreads();

  T* o = acc + home * 4;
  atomicAdd(o, fx);
  atomicAdd(o + 1, fy);
  atomicAdd(o + 2, fz);
  atomicAdd(o + 3, e);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (self_half[half] || cblk[half] >= nb) continue;
    const int j = half * b + t;
    T* oc = acc + ((size_t)cblk[half] * b + t) * 4;
    atomicAdd(oc, rx[j]);
    atomicAdd(oc + 1, ry[j]);
    atomicAdd(oc + 2, rz[j]);
  }
}

template <typename T>
int launch(const T* fs, const int* ms, const int* hb, const int* cb,
           const int* wrap, const T* box, int n_entries, int nb, int b,
           const double* scal, const int* flags, T* acc, void* stream) {
  if (b < 1 || b > MAX_B || nb < 1 || n_entries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_entries == 0) return 0;
  const Params<T> p = make_params<T>(scal, flags);
  tile_pair_kernel<T><<<(unsigned)n_entries, b, 0, (cudaStream_t)stream>>>(
      fs, ms, hb, cb, wrap, box, nb, p, acc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. `scal` and `flags` are host
// arrays (pair_forms.cuh::make_params); 1 <= b <= 128. `acc` must hold
// zeros (or sums to add to). Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int tile_pair_f32(const float* fs, const int* ms, const int* hb,
                             const int* cb, const int* wrap, const float* box,
                             int n_entries, int nb, int b, const double* scal,
                             const int* flags, float* acc, void* stream) {
  return launch<float>(fs, ms, hb, cb, wrap, box, n_entries, nb, b, scal,
                       flags, acc, stream);
}

extern "C" int tile_pair_f64(const double* fs, const int* ms, const int* hb,
                             const int* cb, const int* wrap, const double* box,
                             int n_entries, int nb, int b, const double* scal,
                             const int* flags, double* acc, void* stream) {
  return launch<double>(fs, ms, hb, cb, wrap, box, n_entries, nb, b, scal,
                        flags, acc, stream);
}
