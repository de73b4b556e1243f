// Atom-block pair sweep for Hopper (sm_90a), "K4".
//
// Replaces no Pallas kernel: the JAX package runs this sweep,
// atomsmm_tpu/ops/blocks.py::block_pair_sums, as XLA operations. A sweep of
// pair slots as PyTorch operations costs hundreds of times a kernel on this
// card, so the block lists get their own. Atoms are sorted in serpentine
// cell order and cut into blocks of B atoms (ops/blocks.py); home block i
// lists its candidate blocks cand[i, :] (ascending, -1 padded, itself
// first), each block pair once (Newton at block level). The kernel
// computes what the JAX sweep computes:
//   * every home atom against every atom of its candidate blocks, the
//     displacement's minimum image per slot (pair_forms.cuh::Image), the
//     cutoff, the self pair and the exclusions (the relative-offset bitmask,
//     or the split form: the bitmask and each atom's far ids);
//   * the pair form through pair_forms.cuh::pair_form, every form K1 to K3
//     take (reaction field, Ewald and damped, near, the fused far form,
//     the virial flag, softcore and its lambda derivative);
//   * per-atom [fx fy fz e] rows of an (N + 1, 4) output, as K1 gives (row
//     N: the padding). A pair's energy sits whole on its home atom.
//
// What bounds it: instruction slots and the slowest blocks, as in K3. At
// 30k water the far list (r_build 1.0 nm) holds some 469 x 60 block pairs,
// each 64 x 64 slots, of which about 2% are in range. The design is K3's:
//   * one thread block of four warps per (home block, chunk of its
//     candidate list): the chunk's candidate blocks (up to 512 atoms in
//     float32, 256 in float64) are staged in shared memory at once, with the
//     home block's atoms, each atom moved to the periodic image nearest the
//     home block's first atom, so that a block is compact in the staged
//     frame; the bounding box of each group of 32 staged candidates comes
//     from a warp reduction;
//   * each home atom is tested against the groups' boxes with the minimum
//     image of its distance to the box's centre per dimension (exact: the
//     periodic distance of a point to an interval), at 1.0001 r_c^2 so that
//     rounding can never cull a pair the slot test would take: a few bits
//     per atom say which groups it can reach;
//   * warp w takes the home atoms w, w + 4, ... that reach anything, and for
//     each the groups it can reach: the lanes test the group's 32
//     candidates and push their hits on the warp's queue in shared memory
//     (hit_queue.cuh); whenever 32 are queued every lane evaluates one;
//   * the self block takes each pair once (the candidate behind the home
//     atom in the block) at weight 1 with its reaction: the same sums as
//     both orderings at weight 1/2 without reaction, with half the
//     evaluations;
//   * a popped batch is ordered by home atom: the home sums meet by a
//     segmented shuffle reduction, one lane per home atom adds the run's
//     total to that atom's sums in shared memory, which only its warp
//     writes; the reactions go to the candidates' sums by shared-memory
//     atomics;
//   * at the end each thread adds its home atom's row and its candidates'
//     reaction rows to the output by global atomics, one vector atomic per
//     nonzero row in float32, and skips the zero rows (most candidates are
//     out of reach of most home atoms).
// The grid is (NB, chunks of the list): all first chunks, which hold the
// self blocks, start before any second one. A chunk past a row's last
// candidate leaves at once. The global atomics sum in an order that changes
// from run to run: float32 rows differ in their last bits between runs,
// float64 ones far below the tests' tolerances.
//
// The plain PyTorch twin of this file is ops/blocks.py::block_pair_plain.

#include "hit_queue.cuh"
#include "pair_forms.cuh"

namespace {

using namespace pairforms;

constexpr int MAX_B = 128;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned NO_HIT = 0xffffffffu;

// candidate atoms staged at once: 16 groups of 32, one bit each in a
// home atom's reach mask; half as many in float64, so that a block's
// shared memory stays under the 48 KB of a default launch
template <typename T>
constexpr int slots() {
  return sizeof(T) == 4 ? 512 : 256;
}

// A staged atom: position in the home block's frame and atom id (n =
// padding), read by the slot test with one 16-byte load in float32.
template <typename T>
struct alignas(4 * sizeof(T)) Pos {
  T x, y, z;
  int id;
};

template <typename T>
struct Par {
  T q, s, e;
};

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

// dynamic shared memory of a block of b home atoms and `cs` staged
// candidate slots (the carving in the kernel): about 27 KB at b = 64
template <typename T>
size_t smem_bytes(int b, int cs, int per_chunk) {
  const int groups = (cs + 31) / 32;
  return (size_t)(cs + b) * sizeof(Pos<T>) +
         (size_t)(3 * cs + 4 * b + 6 * groups) * sizeof(T) +
         (size_t)(cs + b) * sizeof(Par<T>) +
         (size_t)(4 * b + per_chunk) * sizeof(unsigned) +
         (size_t)WARPS * hitqueue::DEPTH * sizeof(unsigned);
}

// `v` moved to its periodic image nearest `ref`
template <typename T>
__device__ __forceinline__ Pos<T> near_image(const Image<T, false>& img,
                                             const T* __restrict__ x, int id,
                                             T rx, T ry, T rz) {
  T dx = x[3 * (size_t)id] - rx;
  T dy = x[3 * (size_t)id + 1] - ry;
  T dz = x[3 * (size_t)id + 2] - rz;
  img.apply(dx, dy, dz);
  return Pos<T>{rx + dx, ry + dy, rz + dz, id};
}

//   x      (N, 3) positions; q, sig, eps (N,) per-atom parameters
//   excbits (N + 1,) relative-offset exclusion bits; exc_far (N, m) the far
//          ids of the split form (EXC_SPLIT), sorted ascending, -1 padded
//   order  (NB B,) sorted atom ids, sentinel n
//   cand   (NB, k) candidate block ids, ascending, -1 padded
//   out    (N + 1, 4) [fx fy fz e], zeroed by the caller, added to here
template <typename T, bool DAMPED, int EXC>
__global__ void __launch_bounds__(THREADS)
    block_pair_kernel(const T* __restrict__ x, const T* __restrict__ q,
                      const T* __restrict__ sig, const T* __restrict__ eps,
                      const int* __restrict__ excbits,
                      const int* __restrict__ exc_far,
                      const int* __restrict__ order,
                      const int* __restrict__ cand, const T* __restrict__ box,
                      int n, int b, int k, int per_chunk, int m, Params<T> p,
                      T* __restrict__ out) {
  const int h = blockIdx.x;
  const int e0 = blockIdx.y * per_chunk;
  const int cs = per_chunk * b;
  const int groups = (cs + 31) / 32;
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Pos<T>* cpos = reinterpret_cast<Pos<T>*>(smem_raw);      // [cs]
  Pos<T>* hpos = cpos + cs;                                // [b]
  T* rx = reinterpret_cast<T*>(hpos + b);                  // [cs] each
  T* ry = rx + cs;
  T* rz = ry + cs;
  T* hs = rz + cs;                                         // [b][4]
  T* boxes = hs + 4 * b;                                   // [groups][6]
  Par<T>* cpar = reinterpret_cast<Par<T>*>(boxes + 6 * groups);  // [cs]
  Par<T>* hpar = cpar + cs;                                // [b]
  unsigned* hexc = reinterpret_cast<unsigned*>(hpar + b);  // [b]
  unsigned* hreach = hexc + b;                             // [b]
  unsigned* hfar = hreach + b;                             // [b][2]
  int* cblk = reinterpret_cast<int*>(hfar + 2 * b);        // [per_chunk]
  unsigned* queues = reinterpret_cast<unsigned*>(cblk + per_chunk);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int c = -1;
  if (t < per_chunk && e0 + t < k) c = cand[(size_t)h * k + e0 + t];
  if (t < per_chunk) cblk[t] = c;
  // the row's candidates come first: their count, and the barrier
  const int ncand = __syncthreads_count(c >= 0);
  if (ncand == 0) return;  // the whole block leaves: no barrier is skipped

  const Image<T, false> img(box);
  // the home block's first atom is real (only the last block is padded,
  // at its end): the frame every staged position is imaged into
  const int ref_id = order[(size_t)h * b];
  const T fx = x[3 * (size_t)ref_id], fy = x[3 * (size_t)ref_id + 1],
          fz = x[3 * (size_t)ref_id + 2];
  const int live = ncand * b;
  for (int j = t; j < cs; j += THREADS) {
    const int id = j < live ? order[(size_t)cblk[j / b] * b + j % b] : n;
    if (id < n) {
      cpos[j] = near_image(img, x, id, fx, fy, fz);
      cpar[j] = Par<T>{q[id], sig[id], eps[id]};
    } else {
      cpos[j] = Pos<T>{fx, fy, fz, n};
    }
    rx[j] = T(0);
    ry[j] = T(0);
    rz[j] = T(0);
  }
  if (t < b) {
    const int id = order[(size_t)h * b + t];
    if (id < n) {
      hpos[t] = near_image(img, x, id, fx, fy, fz);
      hpar[t] = Par<T>{q[id], sig[id], eps[id]};
      hexc[t] = (unsigned)excbits[id];
      if (EXC == EXC_SPLIT) {
        const FarFilter f = far_filter(exc_far + (size_t)id * m, m);
        hfar[2 * t] = f.lo;
        hfar[2 * t + 1] = f.hi;
      }
    } else {
      hpos[t] = Pos<T>{fx, fy, fz, n};
    }
    hs[4 * t] = T(0);
    hs[4 * t + 1] = T(0);
    hs[4 * t + 2] = T(0);
    hs[4 * t + 3] = T(0);
  }
  __syncthreads();

  // each group's bounding box, over its real slots, as centre and half
  // extent; a group without one gets a negative extent and is never reached
  for (int g = warp; g < groups; g += WARPS) {
    const int j = 32 * g + lane;
    const bool real = j < cs && cpos[j].id < n;
    const Pos<T> v = cpos[real ? j : 32 * g];
    const T big = T(1e30);
    T lx = real ? v.x : big, ly = real ? v.y : big, lz = real ? v.z : big;
    T ux = real ? v.x : -big, uy = real ? v.y : -big, uz = real ? v.z : -big;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lx = fmin(lx, __shfl_xor_sync(hitqueue::FULL_WARP, lx, d));
      ly = fmin(ly, __shfl_xor_sync(hitqueue::FULL_WARP, ly, d));
      lz = fmin(lz, __shfl_xor_sync(hitqueue::FULL_WARP, lz, d));
      ux = fmax(ux, __shfl_xor_sync(hitqueue::FULL_WARP, ux, d));
      uy = fmax(uy, __shfl_xor_sync(hitqueue::FULL_WARP, uy, d));
      uz = fmax(uz, __shfl_xor_sync(hitqueue::FULL_WARP, uz, d));
    }
    const bool any = __ballot_sync(hitqueue::FULL_WARP, real) != 0u;
    if (lane == 0) {
      T* bg = boxes + 6 * g;
      bg[0] = any ? T(0.5) * (lx + ux) : T(0);
      bg[1] = any ? T(0.5) * (ly + uy) : T(0);
      bg[2] = any ? T(0.5) * (lz + uz) : T(0);
      bg[3] = any ? T(0.5) * (ux - lx) : T(-1);
      bg[4] = any ? T(0.5) * (uy - ly) : T(-1);
      bg[5] = any ? T(0.5) * (uz - lz) : T(-1);
    }
  }
  __syncthreads();

  // the groups this thread's home atom can reach, one bit each
  if (t < b) {
    unsigned reach = 0u;
    const Pos<T> hp = hpos[t];
    if (hp.id < n) {
      const T rc2_wide = p.rc2 * T(1.0001);
      for (int g = 0; g < groups; ++g) {
        const T* bg = boxes + 6 * g;
        if (bg[3] < T(0)) continue;
        T dx = hp.x - bg[0], dy = hp.y - bg[1], dz = hp.z - bg[2];
        img.apply(dx, dy, dz);
        const T gx = fmax(fabs(dx) - bg[3], T(0));
        const T gy = fmax(fabs(dy) - bg[4], T(0));
        const T gz = fmax(fabs(dz) - bg[5], T(0));
        if (gx * gx + gy * gy + gz * gz < rc2_wide) reach |= 1u << g;
      }
    }
    hreach[t] = reach;
  }
  __syncthreads();

  unsigned* queue = queues + warp * hitqueue::DEPTH;
  int queued = 0;

  // One popped hit per lane (code = home << 16 | candidate, NO_HIT for a
  // lane without one): the pair form, the reaction to the candidate's sums,
  // and the home sums of each run of equal home atoms to its first lane.
  auto evaluate = [&](unsigned code) {
    const bool on = code != NO_HIT;
    const int hh = on ? (int)(code >> 16) : -1;
    T sx = T(0), sy = T(0), sz = T(0), se = T(0);
    if (on) {
      const int j = (int)(code & 0xffffu);
      const Pos<T> hp = hpos[hh];
      const Par<T> hq = hpar[hh];
      const Pos<T> cj = cpos[j];
      const Par<T> cq = cpar[j];
      T dx = hp.x - cj.x;
      T dy = hp.y - cj.y;
      T dz = hp.z - cj.z;
      img.apply(dx, dy, dz);
      const T r2 = dx * dx + dy * dy + dz * dz;
      T dudr2;
      pair_form<T, DAMPED>(p, r2, hq.q * cq.q, T(0.5) * (hq.s + cq.s),
                           sqrt(hq.e * cq.e), se, dudr2);
      const T fm = T(2) * dudr2;
      const T gx = fm * dx, gy = fm * dy, gz = fm * dz;
      sx = -gx;
      sy = -gy;
      sz = -gz;
      atomicAdd(&rx[j], gx);
      atomicAdd(&ry[j], gy);
      atomicAdd(&rz[j], gz);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int kk = __shfl_down_sync(hitqueue::FULL_WARP, hh, d);
      const T ax = __shfl_down_sync(hitqueue::FULL_WARP, sx, d);
      const T ay = __shfl_down_sync(hitqueue::FULL_WARP, sy, d);
      const T az = __shfl_down_sync(hitqueue::FULL_WARP, sz, d);
      const T ae = __shfl_down_sync(hitqueue::FULL_WARP, se, d);
      if (lane + d < 32 && kk == hh) {
        sx += ax;
        sy += ay;
        sz += az;
        se += ae;
      }
    }
    const int before = __shfl_up_sync(hitqueue::FULL_WARP, hh, 1);
    if (on && (lane == 0 || before != hh)) {
      T* row = hs + 4 * hh;
      row[0] += sx;
      row[1] += sy;
      row[2] += sz;
      row[3] += se;
    }
    __syncwarp();  // the next batch may continue this home atom in another lane
  };

  // the warp's home atoms (warp, warp + WARPS, ...) in turn, each against
  // the groups it can reach
  const int looked_up = warp + WARPS * lane;
  const unsigned my_reach = looked_up < b ? hreach[looked_up] : 0u;
  unsigned homes = __ballot_sync(hitqueue::FULL_WARP, my_reach != 0u);
  while (homes != 0u) {
    const int hl = __ffs(homes) - 1;
    homes &= homes - 1u;
    unsigned todo = __shfl_sync(hitqueue::FULL_WARP, my_reach, hl);
    const int hh = warp + WARPS * hl;
    const Pos<T> hp = hpos[hh];
    const unsigned exc_h = hexc[hh];
    FarFilter filt{0u, 0u};
    const int* far_row = nullptr;
    if (EXC == EXC_SPLIT) {
      filt = FarFilter{hfar[2 * hh], hfar[2 * hh + 1]};
      far_row = exc_far + (size_t)hp.id * m;
    }
    while (todo != 0u) {
      const int g = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int j = 32 * g + lane;
      const Pos<T> cj = cpos[j < cs ? j : 32 * g];
      T dx = hp.x - cj.x;
      T dy = hp.y - cj.y;
      T dz = hp.z - cj.z;
      img.apply(dx, dy, dz);
      const T r2 = dx * dx + dy * dy + dz * dz;
      bool hit = (j < cs) & (cj.id < n) & (r2 < p.rc2);
      // in the self block each pair once: the candidate behind the home atom
      if (hit && cblk[j / b] == h) hit = j % b > hh;
      if (hit) hit = !excluded_by_bits(exc_h, hp.id, cj.id);
      if (EXC == EXC_SPLIT && hit) {
        hit = !excluded_far(filt, far_row, m, hp.id, cj.id);
      }
      const int slot = hitqueue::reserve(hit, queued);
      if (hit) queue[slot] = ((unsigned)hh << 16) | (unsigned)j;
      __syncwarp();
      if (queued >= 32) {
        queued -= 32;
        const unsigned code = queue[queued + lane];
        __syncwarp();
        evaluate(code);
      }
    }
  }
  if (queued > 0) evaluate(lane < queued ? queue[lane] : NO_HIT);
  __syncthreads();

  if (t < b) {
    const T* row = hs + 4 * t;
    const int id = hpos[t].id;
    if (id < n && (row[0] != T(0) || row[1] != T(0) || row[2] != T(0) ||
                   row[3] != T(0))) {
      add_row(out + (size_t)id * 4, row[0], row[1], row[2], row[3]);
    }
  }
  for (int j = t; j < live; j += THREADS) {
    const int id = cpos[j].id;
    if (id < n && (rx[j] != T(0) || ry[j] != T(0) || rz[j] != T(0))) {
      add_row(out + (size_t)id * 4, rx[j], ry[j], rz[j], T(0));
    }
  }
}

template <typename T, bool DAMPED, int EXC>
void run(dim3 grid, size_t smem, cudaStream_t st, const T* x, const T* q,
         const T* sig, const T* eps, const int* excbits, const int* exc_far,
         const int* order, const int* cand, const T* box, int n, int b, int k,
         int per_chunk, int m, const Params<T>& p, T* out) {
  block_pair_kernel<T, DAMPED, EXC><<<grid, THREADS, smem, st>>>(
      x, q, sig, eps, excbits, exc_far, order, cand, box, n, b, k, per_chunk,
      m, p, out);
}

template <typename T>
int launch(const T* x, const T* q, const T* sig, const T* eps,
           const int* excbits, const int* exc_far, const int* order,
           const int* cand, const T* box, int n, int nb, int b, int k, int m,
           const double* scal, const int* flags, T* out, void* stream) {
  if (b < 1 || b > MAX_B || nb < 1 || k < 1 || n < 1 || m < 0 ||
      (exc_far != nullptr) != (m > 0) || !flags_valid(flags)) {
    return (int)cudaErrorInvalidValue;
  }
  // candidate blocks per thread block: as many as fill the staged slots,
  // at most one a thread (each thread reads one entry of the list)
  const int per_chunk = slots<T>() / b < THREADS ? slots<T>() / b : THREADS;
  const int chunks = (k + per_chunk - 1) / per_chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const Params<T> p = make_params<T>(scal, flags);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)nb, (unsigned)chunks);
  const size_t smem = smem_bytes<T>(b, per_chunk * b, per_chunk);
  const bool split = exc_far != nullptr;
  if (damped(p)) {
    if (split) {
      run<T, true, EXC_SPLIT>(grid, smem, st, x, q, sig, eps, excbits,
                              exc_far, order, cand, box, n, b, k, per_chunk,
                              m, p, out);
    } else {
      run<T, true, EXC_BITS>(grid, smem, st, x, q, sig, eps, excbits, exc_far,
                             order, cand, box, n, b, k, per_chunk, m, p, out);
    }
  } else {
    if (split) {
      run<T, false, EXC_SPLIT>(grid, smem, st, x, q, sig, eps, excbits,
                               exc_far, order, cand, box, n, b, k, per_chunk,
                               m, p, out);
    } else {
      run<T, false, EXC_BITS>(grid, smem, st, x, q, sig, eps, excbits,
                              exc_far, order, cand, box, n, b, k, per_chunk,
                              m, p, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. `scal` and `flags` are host
// arrays (pair_forms.cuh::make_params); 1 <= b <= 128; exc_far is null
// (m = 0) for the bitmask form. `out` must hold zeros (or sums to add to).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int block_pair_f32(const float* x, const float* q, const float* sig,
                              const float* eps, const int* excbits,
                              const int* exc_far, const int* order,
                              const int* cand, const float* box, int n,
                              int nb, int b, int k, int m, const double* scal,
                              const int* flags, float* out, void* stream) {
  return launch<float>(x, q, sig, eps, excbits, exc_far, order, cand, box, n,
                       nb, b, k, m, scal, flags, out, stream);
}

extern "C" int block_pair_f64(const double* x, const double* q,
                              const double* sig, const double* eps,
                              const int* excbits, const int* exc_far,
                              const int* order, const int* cand,
                              const double* box, int n, int nb, int b, int k,
                              int m, const double* scal, const int* flags,
                              double* out, void* stream) {
  return launch<double>(x, q, sig, eps, excbits, exc_far, order, cand, box, n,
                        nb, b, k, m, scal, flags, out, stream);
}
