// Flat tile-pair sweep for Hopper (sm_90a).
//
// Replaces atomsmm_tpu/ops/tilepair.py::_tile_kernel. Atoms are sorted in
// serpentine cell order and cut into blocks of B atoms (ops/blocks.py);
// ops/tilepair.py::build_tile_pairs lists the Newton block pairs whose
// periodic bounding boxes lie within the build radius, two candidate blocks
// per entry. Entry e evaluates home block hb[e] against candidate blocks
// cb[e, 0] and cb[e, 1] as one (B, 2B) tile:
//   * the candidate coordinates are shifted by the entry's integer wrap
//     vectors (wrap[e, half] * box) instead of a per-slot minimum image;
//   * exclusions and the self pair are one relative-offset bitmask test;
//     sentinel slots carry coordinates poisoned at 1e4 nm (and the
//     sentinel's self bit), so the kernel needs no id-validity compares;
//   * a half whose candidate block is the home block at zero wrap (the self
//     tile) holds both orderings of each pair (in the TPU kernel and the
//     plain twin: energy weight 1/2 and no reaction); every other half
//     weighs 1 and carries the reaction.
//
// What bounds it: instruction slots and the slowest block, not operations or
// bytes. At 30k water and a 0.9 nm cutoff the list's 13.3k live entries hold
// 109 M slots of which 5% are in range, and the hits cluster: only 15% of
// the (home atom, 32 candidates) groups hold any hit, and most entries hold
// next to none, while the 469 self tiles hold 4,032 each. A thread per home
// atom that walks all 2B candidates spends its time on slots that miss, and
// runs the pair form (five times a test) for one or two live lanes of its
// warp. The design, one thread block of four warps per entry:
//   * the block stages the 2B candidates, pre-shifted by their wrap, and
//     its B home atoms in shared memory, and the bounding box of each group
//     of 32 candidates (a warp reduction);
//   * each home atom is tested against the boxes: a few bits per atom say
//     which groups it can reach (21% of them at 30k). The cutoff of this
//     test is 1.0001 r_cut^2, so that rounding can never cull a pair the
//     slot test would take; the poison coordinate stays finite in it (a gap
//     of 1e4 nm squares to 1e8);
//   * warp w takes the home atoms w, w + 4, ... that reach anything, one
//     after the other, and for each the groups it can reach: the lanes run
//     across the group's 32 candidates, test, and push their hits (home
//     atom, candidate) on the warp's queue in shared memory
//     (hit_queue.cuh); whenever 32 are queued every lane evaluates one.
//     The warps never meet in a barrier inside that loop: each has its own
//     queue;
//   * the kernel ends when its slowest block does, and the self tiles are
//     tens of times slower than most. So a self tile takes each pair once
//     (the candidate behind the home atom in the block) at weight 1 with
//     its reaction: half the evaluations of both orderings at weight 1/2,
//     and the same sums. A block has four warps whatever B. And the grid
//     walks the list twice: its first E blocks take the entries that hold a
//     self tile and leave the others at once, its last E blocks take the
//     others, so that the slow blocks start first and the light ones fill
//     in around them;
//   * a popped batch is ordered by home atom, so the home sums meet by a
//     segmented shuffle reduction, and one lane per home atom adds the
//     run's total to that atom's sums in shared memory, which only its warp
//     writes. The reactions go to the candidates' sums by shared-memory
//     atomics (compare-and-swap loops on this card), the only atomics of
//     the loop;
//   * at the end each thread adds its home atom's row and its candidates'
//     reaction rows to the (NB + 1, B, 4) accumulator by global atomics,
//     one vector atomic per row in float32, and skips rows that are zero
//     (most are: most atoms of an entry are out of reach of its other
//     side). The energy column sums to the energy; a pair's energy sits
//     whole on its home atom.
// On the TPU the sums accumulated race-free because Pallas grid programs
// ran in order; CUDA blocks run concurrently, so the accumulator sums in an
// order that changes from run to run: float32 results differ in their last
// bits between runs, float64 ones far below the tests' tolerances. Entries
// whose home block is the sentinel NB (the unused tail of the list) return
// at once; reactions aimed at the sentinel block are not written.
//
// The cutoff is decided as the float64 reference decides it: the slot test
// takes r2 < rc2_hi, and a hit whose float32 r2 lies within
// pair_forms.cuh::CUT_BAND of r_cut^2 is kept only where the displacement
// again in float64 is in range. That displacement is taken from the
// unshifted staged coordinates of both atoms (fs), the entry's wrap x box
// added to the candidate's in float64, so the pre-shifted float32
// candidate of shared memory is not rounded into it twice
// (within_tile_f64). In float64 every hit is kept.
//
// A user pair function (CustomNonbondedForce) takes the form axis U, as in
// K1 and K2 (pair_forms.cuh::user_pair): the staged atoms carry its
// P <= 5 columns, fs columns 3 ... 3 + P - 1, in place of (q, sigma,
// epsilon), each thread reads the runtime constants into registers once,
// and a hit calls the generated UserPair::eval. Such a kernel is built
// alone, for one dtype, by _build.build_user: a wrapper source defines
// ATOMSMM_USER_EXC (not read here: K3 takes the bitmask alone) and
// includes the generated header and this file, which then gives the entry
// point tile_pair_user in place of the built-in ones.
//
// The plain PyTorch twin of this file is ops/tilepair.py::tile_pair_plain.

#include "hit_queue.cuh"
#include "pair_forms.cuh"

namespace {

using namespace pairforms;

constexpr int MAX_B = 128;
constexpr int WARPS = 4;            // warps of a block, whatever b
constexpr int THREADS = 32 * WARPS;
constexpr int NO_HIT = 0xffff;  // a queue code no (home, candidate) pair has

// A staged atom: position and atom id (n = padding), read by the slot test
// with one 16-byte load in float32; its pair parameters beside it.
template <typename T>
struct alignas(4 * sizeof(T)) Pos {
  T x, y, z;
  int id;
};

template <typename T>
struct Par {
  T q, s, e;
};

// what an atom stages beside its position: a built-in form's Par, or a
// user form's columns
template <typename T, class U>
using ParOf = std::conditional_t<U::USER, Cols<T, U::NCOLS>, Par<T>>;

template <typename T, class U>
__device__ __forceinline__ ParOf<T, U> load_par(const T* f) {
  ParOf<T, U> r;
  if constexpr (U::USER) {
#pragma unroll
    for (int kc = 0; kc < U::NCOLS; ++kc) r.c[kc] = f[3 + kc];
  } else {
    r = Par<T>{f[3], f[4], f[5]};
  }
  return r;
}

// A hit in the cutoff band decided in float64: home atom `hi` and
// candidate `ci` (rows of fs) from their unshifted staged coordinates, the
// candidate's wrap `wh` x box added in float64, against r_cut^2 in
// float64.
template <typename T>
__device__ __noinline__ bool within_tile_f64(double rc2,
                                             const T* __restrict__ fs,
                                             const T* __restrict__ box,
                                             const int* __restrict__ wh,
                                             size_t hi, size_t ci) {
  const T* a = fs + hi * 8;
  const T* c = fs + ci * 8;
  double d2 = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double dk =
        (double)a[k] - ((double)c[k] + (double)wh[k] * (double)box[k]);
    d2 += dk * dk;
  }
  return d2 < rc2;
}

// acc[row] += (a, b, c, d) by global atomics
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

template <typename T>
__device__ __forceinline__ T gap(T lo, T hi, T v) {
  return fmax(fmax(lo - v, v - hi), T(0));
}

// dynamic shared memory of a block of b home atoms (the carving in the
// kernel): at most 34 KB (b = 128, float64; a user form of five columns
// 39 KB)
template <typename T, class U>
size_t smem_bytes(int b) {
  const int groups = (2 * b + 31) / 32;
  return (size_t)3 * b * sizeof(Pos<T>) +
         (size_t)3 * b * sizeof(ParOf<T, U>) +
         (size_t)(6 * groups + 6 * b + 4 * b) * sizeof(T) +
         (size_t)2 * b * sizeof(unsigned) +
         (size_t)WARPS * hitqueue::DEPTH * sizeof(unsigned short);
}

//   fs   (NB + 1, B, 8) [x y z q sigma eps 0 0] in sorted block order (a
//        user form: [x y z c_0 ... c_P-1 0 ...]); the sentinel block NB
//        and padding slots sit at the poison coordinate
//   ms   (NB + 1, B, 2) [atom id (n = padding), exclusion bits]
//   hb   (E,) home block, NB = unused entry
//   cb   (E, 2) candidate blocks, NB = none
//   wrap (E, 2, 3) integer periodic shift of each candidate half
//   consts (C,) a user form's runtime constants (U::USER; else null)
//   acc  (NB + 1, B, 4) [fx fy fz e], zeroed by the caller, added to here
template <typename T, bool DAMPED, class U = BuiltIn>
__global__ void __launch_bounds__(THREADS)
    tile_pair_kernel(const T* __restrict__ fs, const int* __restrict__ ms,
                     const int* __restrict__ hb, const int* __restrict__ cb,
                     const int* __restrict__ wrap, const T* __restrict__ box,
                     int n_entries, int nb, int b, Params<T> p,
                     const T* __restrict__ consts, int dconst,
                     T* __restrict__ acc) {
  using PT = ParOf<T, U>;
  // blocks [0, E): entries with a self tile; blocks [E, 2E): the others
  const bool self_pass = blockIdx.x < n_entries;
  const int ent = self_pass ? blockIdx.x : blockIdx.x - n_entries;
  const int h = hb[ent];
  if (h >= nb) return;  // the whole block leaves: no barrier is skipped
  const int cblk[2] = {cb[2 * ent], cb[2 * ent + 1]};
  const int* w = wrap + 6 * ent;
  bool self_half[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int* wh = w + 3 * half;
    self_half[half] =
        cblk[half] == h && wh[0] == 0 && wh[1] == 0 && wh[2] == 0;
  }
  if ((self_half[0] || self_half[1]) != self_pass) return;

  const int b2 = 2 * b;
  const int groups = (b2 + 31) / 32;
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Pos<T>* cpos = reinterpret_cast<Pos<T>*>(smem_raw);       // [2b]
  Pos<T>* hpos = cpos + b2;                                 // [b]
  T* boxes = reinterpret_cast<T*>(hpos + b);                // [groups][6]
  T* rx = boxes + 6 * groups;                               // [2b] each
  T* ry = rx + b2;
  T* rz = ry + b2;
  T* hs = rz + b2;                                          // [b][4]
  PT* cpar = reinterpret_cast<PT*>(hs + 4 * b);             // [2b]
  PT* hpar = cpar + b2;                                     // [b]
  unsigned* hexc = reinterpret_cast<unsigned*>(hpar + b);   // [b]
  unsigned* hreach = hexc + b;                              // [b]
  unsigned short* queues =
      reinterpret_cast<unsigned short*>(hreach + b);        // [WARPS][DEPTH]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const T bx = box[0], by = box[1], bz = box[2];
  for (int j = t; j < b2; j += THREADS) {
    const int half = j >= b;
    const int* wh = w + 3 * half;
    const size_t src = (size_t)cblk[half] * b + (j - half * b);
    const T* f = fs + src * 8;
    cpos[j] = Pos<T>{f[0] + T(wh[0]) * bx, f[1] + T(wh[1]) * by,
                     f[2] + T(wh[2]) * bz, ms[src * 2]};
    cpar[j] = load_par<T, U>(f);
    rx[j] = T(0);
    ry[j] = T(0);
    rz[j] = T(0);
  }
  // this thread's home atom, in registers for the box tests
  T xi = T(0), yi = T(0), zi = T(0);
  if (t < b) {
    const size_t home = (size_t)h * b + t;
    const T* f = fs + home * 8;
    xi = f[0];
    yi = f[1];
    zi = f[2];
    hpos[t] = Pos<T>{xi, yi, zi, ms[home * 2]};
    hpar[t] = load_par<T, U>(f);
    hexc[t] = (unsigned)ms[home * 2 + 1];
    hs[4 * t] = T(0);
    hs[4 * t + 1] = T(0);
    hs[4 * t + 2] = T(0);
    hs[4 * t + 3] = T(0);
  }
  __syncthreads();

  // the bounding box of each group of 32 candidates (its first slot always
  // exists and stands in for the slots past 2b)
  for (int g = warp; g < groups; g += WARPS) {
    const int j = 32 * g + lane;
    const Pos<T> v = cpos[j < b2 ? j : 32 * g];
    T lx = v.x, ly = v.y, lz = v.z, ux = v.x, uy = v.y, uz = v.z;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lx = fmin(lx, __shfl_xor_sync(hitqueue::FULL_WARP, lx, d));
      ly = fmin(ly, __shfl_xor_sync(hitqueue::FULL_WARP, ly, d));
      lz = fmin(lz, __shfl_xor_sync(hitqueue::FULL_WARP, lz, d));
      ux = fmax(ux, __shfl_xor_sync(hitqueue::FULL_WARP, ux, d));
      uy = fmax(uy, __shfl_xor_sync(hitqueue::FULL_WARP, uy, d));
      uz = fmax(uz, __shfl_xor_sync(hitqueue::FULL_WARP, uz, d));
    }
    if (lane == 0) {
      T* bg = boxes + 6 * g;
      bg[0] = lx;
      bg[1] = ly;
      bg[2] = lz;
      bg[3] = ux;
      bg[4] = uy;
      bg[5] = uz;
    }
  }
  __syncthreads();

  // the groups this thread's home atom can reach, one bit each
  if (t < b) {
    const T rc2_wide = p.rc2 * T(1.0001);
    unsigned reach = 0u;
    for (int g = 0; g < groups; ++g) {
      const T* bg = boxes + 6 * g;
      const T gx = gap(bg[0], bg[3], xi);
      const T gy = gap(bg[1], bg[4], yi);
      const T gz = gap(bg[2], bg[5], zi);
      if (gx * gx + gy * gy + gz * gz < rc2_wide) reach |= 1u << g;
    }
    hreach[t] = reach;
  }
  __syncthreads();

  unsigned short* queue = queues + warp * hitqueue::DEPTH;
  int queued = 0;
  T cs[U::NCONSTS > 0 ? U::NCONSTS : 1];  // a user form's constants
  if constexpr (U::USER) {
#pragma unroll
    for (int kc = 0; kc < U::NCONSTS; ++kc) cs[kc] = consts[kc];
  }

  // One popped hit per lane (code = home << 8 | candidate, NO_HIT for a lane
  // without one): the pair form, the reaction to the candidate's sums, and
  // the home sums of each run of equal home atoms to the run's first lane.
  auto evaluate = [&](int code) {
    const bool on = code != NO_HIT;
    const int hh = code >> 8;
    T sx = T(0), sy = T(0), sz = T(0), se = T(0);
    const int j = code & 0xff;
    const Pos<T> hp = hpos[on ? hh : 0];
    const Pos<T> cj = cpos[on ? j : 0];
    const T dx = hp.x - cj.x;
    const T dy = hp.y - cj.y;
    const T dz = hp.z - cj.z;
    const T r2 = dx * dx + dy * dy + dz * dz;
    // a hit in the cutoff band is decided again in float64; one it drops
    // adds zeros, and its lane stays in the reduction below
    bool keep = on;
    if (on && sizeof(T) != sizeof(double) && r2 >= p.rc2_lo) {
      const int half = j >= b;
      keep = within_tile_f64(p.rc2_exact, fs, box, w + 3 * half,
                             (size_t)h * b + hh,
                             (size_t)cblk[half] * b + (j - half * b));
    }
    if (keep) {
      const PT hq = hpar[hh];
      const PT cq = cpar[j];
      T dudr2;
      if constexpr (U::USER) {
        user_pair<U>(p, cs, dconst, r2, hq.c, cq.c, se, dudr2);
      } else {
        pair_form<T, DAMPED>(p, r2, hq.q * cq.q, T(0.5) * (hq.s + cq.s),
                             sqrt(hq.e * cq.e), se, dudr2);
      }
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
      const int k = __shfl_down_sync(hitqueue::FULL_WARP, hh, d);
      const T ax = __shfl_down_sync(hitqueue::FULL_WARP, sx, d);
      const T ay = __shfl_down_sync(hitqueue::FULL_WARP, sy, d);
      const T az = __shfl_down_sync(hitqueue::FULL_WARP, sz, d);
      const T ae = __shfl_down_sync(hitqueue::FULL_WARP, se, d);
      if (lane + d < 32 && k == hh) {
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
  const unsigned reach = looked_up < b ? hreach[looked_up] : 0u;
  unsigned homes = __ballot_sync(hitqueue::FULL_WARP, reach != 0u);
  while (homes != 0u) {
    const int hl = __ffs(homes) - 1;
    homes &= homes - 1u;
    unsigned todo = __shfl_sync(hitqueue::FULL_WARP, reach, hl);
    const int hh = warp + WARPS * hl;
    const Pos<T> hp = hpos[hh];
    const unsigned exc_h = hexc[hh];
    while (todo != 0u) {
      const int g = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int j = 32 * g + lane;
      const Pos<T> cj = cpos[j < b2 ? j : 32 * g];
      const T dx = hp.x - cj.x;
      const T dy = hp.y - cj.y;
      const T dz = hp.z - cj.z;
      const T r2 = dx * dx + dy * dy + dz * dz;
      bool hit = (j < b2) & (r2 < p.rc2_hi) &
                 !excluded_by_bits(exc_h, hp.id, cj.id);
      if (self_pass) {
        // in a self tile each pair once: the candidate behind the home atom
        const bool self = j < b ? self_half[0] : self_half[1];
        hit &= !(self && (j < b ? j : j - b) <= hh);
      }
      const int slot = hitqueue::reserve(hit, queued);
      if (hit) queue[slot] = (unsigned short)((hh << 8) | j);
      __syncwarp();
      if (queued >= 32) {
        queued -= 32;
        const int code = queue[queued + lane];
        __syncwarp();
        evaluate(code);
      }
    }
  }
  if (queued > 0) evaluate(lane < queued ? (int)queue[lane] : NO_HIT);
  __syncthreads();

  if (t < b) {
    const T* row = hs + 4 * t;
    if (row[0] != T(0) || row[1] != T(0) || row[2] != T(0) ||
        row[3] != T(0)) {
      add_row(acc + ((size_t)h * b + t) * 4, row[0], row[1], row[2], row[3]);
    }
  }
  for (int j = t; j < b2; j += THREADS) {
    const int half = j >= b;
    if (cblk[half] >= nb) continue;
    if (rx[j] != T(0) || ry[j] != T(0) || rz[j] != T(0)) {
      add_row(acc + ((size_t)cblk[half] * b + (j - half * b)) * 4, rx[j],
              ry[j], rz[j], T(0));
    }
  }
}

template <typename T, class U = BuiltIn>
int launch(const T* fs, const int* ms, const int* hb, const int* cb,
           const int* wrap, const T* box, int n_entries, int nb, int b,
           const double* scal, const int* flags, const T* consts,
           int dconst, T* acc, void* stream) {
  if (b < 1 || b > MAX_B || nb < 1 || n_entries < 0 ||
      n_entries > 0x3fffffff || !flags_valid(flags)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_entries == 0) return 0;
  const Params<T> p = make_params<T>(scal, flags);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes<T, U>(b);
  const unsigned grid = 2u * (unsigned)n_entries;
  if constexpr (!U::USER) {  // a user form carries its own Coulomb kernel
    if (damped(p)) {
      tile_pair_kernel<T, true, U><<<grid, THREADS, smem, st>>>(
          fs, ms, hb, cb, wrap, box, n_entries, nb, b, p, consts, dconst,
          acc);
      return (int)cudaGetLastError();
    }
  }
  tile_pair_kernel<T, false, U><<<grid, THREADS, smem, st>>>(
      fs, ms, hb, cb, wrap, box, n_entries, nb, b, p, consts, dconst, acc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. `scal` and `flags` are host
// arrays (pair_forms.cuh::make_params); 1 <= b <= 128. `acc` must hold
// zeros (or sums to add to). Returns cudaGetLastError() after the launch
// (0 on success).
#ifndef ATOMSMM_USER_EXC
extern "C" int tile_pair_f32(const float* fs, const int* ms, const int* hb,
                             const int* cb, const int* wrap, const float* box,
                             int n_entries, int nb, int b, const double* scal,
                             const int* flags, float* acc, void* stream) {
  return launch<float>(fs, ms, hb, cb, wrap, box, n_entries, nb, b, scal,
                       flags, nullptr, -1, acc, stream);
}

extern "C" int tile_pair_f64(const double* fs, const int* ms, const int* hb,
                             const int* cb, const int* wrap, const double* box,
                             int n_entries, int nb, int b, const double* scal,
                             const int* flags, double* acc, void* stream) {
  return launch<double>(fs, ms, hb, cb, wrap, box, n_entries, nb, b, scal,
                        flags, nullptr, -1, acc, stream);
}
#else
// The entry point of a user form's build (_build.build_user): the
// generated UserPair in its working type UserPair::T. fs carries the
// function's `ncols` columns at 3 ... 3 + ncols - 1; `consts` the
// (nconsts,) runtime constants on the device; `dconst` the constant the
// dlambda flag seeds. `ncols` and `nconsts` must equal the header's, and
// the flags those a user form takes (the dlambda and virial flags).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the build does not take.
extern "C" int tile_pair_user(const UserPair::T* fs, const int* ms,
                              const int* hb, const int* cb, const int* wrap,
                              const UserPair::T* box, int n_entries, int nb,
                              int b, int ncols, int nconsts,
                              const UserPair::T* consts, int dconst,
                              const double* scal, const int* flags,
                              UserPair::T* acc, void* stream) {
  if (ncols != UserPair::NCOLS || ncols > 5 ||
      nconsts != UserPair::NCONSTS ||
      (flags[5] && (dconst < 0 || dconst >= nconsts)) || flags[0] ||
      flags[2] || flags[4] || flags[7]) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<UserPair::T, UserPair>(fs, ms, hb, cb, wrap, box, n_entries,
                                       nb, b, scal, flags, consts, dconst,
                                       acc, stream);
}
#endif
