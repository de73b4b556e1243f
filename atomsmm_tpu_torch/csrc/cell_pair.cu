// Full-stencil cell-pair sweep for Hopper (sm_90a), without Newton.
//
// Replaces atomsmm_tpu/ops/pallas_pair.py::_pair_kernel. It runs where the
// cell grid is too small for half-stencil maps (a dimension below
// 2 * reach + 1): small solvated boxes, down to one cell. Each home cell c
// meets every deduplicated stencil cell nbr[c, s] (-1 padded), both
// orderings of each pair: on every (home atom, candidate) slot it applies the
// per-slot minimum image, the cutoff test (in float32, a hit near r_c is
// decided again in float64: pair_forms.cuh::keeps_hit), the exclusions
// and one of the built-in pair forms (pair_forms.cuh), and sums on the home
// atom F_i = -sum 2 du/dr^2 dx and E_i = 1/2 sum u. It writes no reactions.
//
// What bounds it: instruction slots and latency, not operations or bytes. The
// work is small (700 waters: 2,100 home atoms against 2,100 candidates
// each, 4.4 M slot tests, 0.64 M of them in range) and the pair form costs
// five times the test, so what matters is that no lane idles through a
// form, that no padding is tested, and that enough warps are in flight.
// Cell capacities reach past 1,024 slots (216 waters fill one cell of
// 1,112), so nothing assumes a whole cell in a block or in shared memory.
// The design:
//   * the kernel gathers and writes per atom itself: it reads the atoms
//     through the bucket ids and writes one [fx fy fz e] row per real atom
//     of a zeroed (n + 1, 4) tensor; the wrapper is a zero fill, the launch
//     and the energy sum;
//   * a warp owns one home atom for its whole stencil, its lanes run across
//     32 candidates at a time. Every hit of a warp belongs to that atom, so
//     the lanes' partial sums meet by shuffles at the end and the row is a
//     plain store: no atomics, and a result that does not change from run
//     to run;
//   * test, compact, then evaluate with full warps: the lanes push their
//     hits (displacement and pair parameters) on the warp's queue in shared
//     memory (hit_queue.cuh) and evaluate 32 at a time;
//   * padding is never tested: build_cell_buckets puts a cell's real ids
//     first, so a candidate cell's walk ends at its first sentinel, a block
//     whose first home slot holds the sentinel leaves at once, and -1
//     stencil columns are skipped;
//   * a block of 8 warps stages a stencil cell 256 candidates at a time in
//     shared memory, and the walk is pipelined two loads deep: while the block computes one chunk, the atoms of the next
//     are on their way into registers and the bucket ids of the one after
//     behind them, so neither of the two dependent loads (bucket id, then
//     the atom) is waited for where it is started;
//   * where there are few atoms (216 waters: 648), `split` warps share a
//     home atom and divide each chunk's candidates between them, so that
//     about 2,048 warps are in flight; their sums meet in shared memory in
//     a fixed order.
// A replica axis: the grid's second dimension runs over K rows (replicas or
// lambda states); a block offsets its inputs by its row's strides (0 where
// the rows share an array), takes its row's lambda
// (pair_forms.cuh::Rows) and stores into its row's (n + 1, 4) slice of the
// output. A row's blocks are those of the single-row launch and sum in the
// same order, so each row of a batched launch equals its single-row launch
// bit for bit, over any home-cell range.
// The minimum image rounds by two additions, in fractional coordinates for
// a (3, 3) cell (TRI; pair_forms.cuh::Image). With a type-pair table
// (TABLE: NBFIX, the 10-12 term) a staged candidate and a queued hit carry
// the int32 LJ type in place of (sigma, epsilon), and the evaluation reads
// the pair's (sigma, epsilon, A, B) row through the read-only cache
// (pair_forms.cuh::load_pair_row). Exclusions take the three forms of
// pair_forms.cuh (EXC): the bitmask, at most 16 id columns in registers,
// or the split form (the bitmask within +-14 indices, the home atom's far
// ids folded into a 64-bit filter and scanned from global memory for a
// slot in range outside that window whose filter bit is set, before the
// hit is queued).
//
// The plain PyTorch twin of this file is ops/pair_kernel.py::full_pair_plain.

#include "hit_queue.cuh"
#include "pair_forms.cuh"

namespace {

using namespace pairforms;

constexpr int WARPS = 8;             // warps of a block
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = THREADS;       // candidates staged at a time
constexpr int TARGET_WARPS = 2048;   // home-atom warps wanted in flight

// A staged candidate: position and atom id, read by the slot test with one
// 16-byte load in float32; its pair parameters beside it: (q, sigma,
// epsilon), or (q, LJ type) in the TABLE form.
template <typename T>
struct alignas(4 * sizeof(T)) Cand {
  T x, y, z;
  int id;
};

template <typename T, bool TABLE>
struct Par {
  T q, s, e;
};

template <typename T>
struct Par<T, true> {
  T q;
  int t;
};

// A queued hit: the displacement and the candidate's pair parameters (the
// staged chunk it came from may be gone when it is evaluated).
template <typename T, bool TABLE>
struct alignas(2 * sizeof(T)) Hit {
  T dx, dy, dz, q, s, e;
};

template <typename T>
struct alignas(2 * sizeof(T)) Hit<T, true> {
  T dx, dy, dz, q;
  int t;
};

template <typename T>
__device__ __forceinline__ Hit<T, false> make_hit(T dx, T dy, T dz,
                                                  const Par<T, false>& p) {
  return Hit<T, false>{dx, dy, dz, p.q, p.s, p.e};
}

template <typename T>
__device__ __forceinline__ Hit<T, true> make_hit(T dx, T dy, T dz,
                                                 const Par<T, true>& p) {
  return Hit<T, true>{dx, dy, dz, p.q, p.t};
}

__device__ __forceinline__ void store_row(float* row, float a, float b,
                                          float c, float d) {
  *reinterpret_cast<float4*>(row) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store_row(double* row, double a, double b,
                                          double c, double d) {
  *reinterpret_cast<double2*>(row) = make_double2(a, b);
  *reinterpret_cast<double2*>(row + 2) = make_double2(c, d);
}

// One block per (home cell, group of WARPS / split home slots) of the home
// cells c0 ... c0 + gridDim.x / blocks_per_cell - 1, and per row
// (blockIdx.y); warp w holds home slot i0 + w / split and tests the
// 32-candidate groups w % split, w % split + split, ... of every staged
// chunk. The arrays below are row 0's; block (b, k) offsets each by k
// times its stride in `rows`, and `out` by k (n + 1) 4.
//   x (n, 3); q, sig, eps (n,)     atoms, gathered through the ids
//   types (n,); table (T, T, 4)    LJ types and type-pair rows (TABLE)
//   excbits (n + 1,)               exclusion bits (bitmask form)
//   exc (n, m)                     far ids, sorted ascending, -1
//                                  padded (EXC_SPLIT; else null)
//   bucket (ncells, cap)           atom ids, real ids first, then n
//   nbr (ncells, s)                stencil cells, -1 padded
//   box (3,) or (3, 3)             edge lengths, or the cell matrix (TRI)
//   out (K, n + 1, 4)              zeroed; per row and real atom
//                                  [fx fy fz e]
template <typename T, int EXC, bool DAMPED, bool TRI, bool TABLE>
__global__ void __launch_bounds__(THREADS)
    cell_pair_kernel(const T* __restrict__ x, const T* __restrict__ q,
                     const T* __restrict__ sig, const T* __restrict__ eps,
                     const int* __restrict__ types,
                     const T* __restrict__ table,
                     const int* __restrict__ excbits,
                     const int* __restrict__ exc,
                     const int* __restrict__ bucket,
                     const int* __restrict__ nbr, const T* __restrict__ box,
                     int c0, int cap, int s, int n, int m, int ntypes,
                     int split, Params<T> p0, Rows<T> rows,
                     T* __restrict__ out) {
  __shared__ Cand<T> cand[CHUNK];
  __shared__ Par<T, TABLE> par[CHUNK];
  __shared__ Hit<T, TABLE> queue[WARPS][hitqueue::DEPTH];
  __shared__ T parts[WARPS][4];

  const int row = blockIdx.y;
  x += row * rows.x;
  q += row * rows.q;
  sig += row * rows.sig;
  eps += row * rows.eps;
  if (TABLE) types += row * rows.types;
  bucket += row * rows.bucket;
  box += row * rows.box;
  out += (size_t)row * (n + 1) * 4;
  const Params<T> p = row_params(p0, rows, row);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per_block = WARPS / split;  // home slots of a block
  const int blocks_per_cell = (cap + per_block - 1) / per_block;
  const int local = blockIdx.x / blocks_per_cell;
  const int c = c0 + local;
  const int i0 = (blockIdx.x - local * blocks_per_cell) * per_block;
  const int* hrow = bucket + (size_t)c * cap;
  if (hrow[i0] >= n) return;  // only padding from here on: the block leaves

  const int i = i0 + warp / split;
  const int part = warp - (warp / split) * split;
  const int hid = i < cap ? hrow[i] : n;
  const bool home = hid < n;
  T xi = T(0), yi = T(0), zi = T(0), qi = T(0), si = T(0), ei = T(0);
  int ti = 0;
  unsigned exc_h = 0u;
  if (home) {
    xi = x[3 * (size_t)hid];
    yi = x[3 * (size_t)hid + 1];
    zi = x[3 * (size_t)hid + 2];
    qi = q[hid];
    if (TABLE) {
      ti = types[hid];
    } else {
      si = sig[hid];
      ei = eps[hid];
    }
    exc_h = (unsigned)excbits[hid];
  }
  const int* far_row =
      (EXC == EXC_SPLIT && home) ? exc + (size_t)hid * m : nullptr;
  FarFilter far_bits{0u, 0u};
  if (EXC == EXC_SPLIT) far_bits = far_filter(far_row, m);

  const Image<T, TRI> image(box);
  const int* nrow = nbr + (size_t)c * s;
  T fx = T(0), fy = T(0), fz = T(0), e = T(0);
  Hit<T, TABLE>* my_queue = queue[warp];
  int queued = 0;

  auto evaluate = [&](const Hit<T, TABLE>& h) {
    const T r2 = h.dx * h.dx + h.dy * h.dy + h.dz * h.dz;
    T u, dudr2;
    if constexpr (TABLE) {
      const PairRow<T> row = load_pair_row(table, ntypes, ti, h.t);
      pair_form<T, DAMPED, true>(p, r2, qi * h.q, row.sig, row.eps, u, dudr2,
                                 row.a, row.b);
    } else {
      pair_form<T, DAMPED>(p, r2, qi * h.q, T(0.5) * (si + h.s),
                           sqrt(ei * h.e), u, dudr2);
    }
    const T fm = T(2) * dudr2;
    fx -= fm * h.dx;
    fy -= fm * h.dy;
    fz -= fm * h.dz;
    e += u;
  };

  // The walk over the stencil's chunks, two dependent loads deep: while
  // the block computes chunk k from shared memory, the atoms of chunk
  // k + 1 are on their way into registers and the bucket ids of chunk k + 2
  // behind them, so no load is waited for where it is started.
  auto next_column = [&](int k) {
    while (k < s && nrow[k] < 0) ++k;
    return k;
  };
  // the chunk after the one at (col, j0) that held cnt real atoms: a full
  // chunk may have more of its cell behind it, else the next cell
  auto advance = [&](int& col, int& j0, int cnt) {
    if (cnt == CHUNK && j0 + CHUNK < cap) {
      j0 += CHUNK;
    } else {
      col = next_column(col + 1);
      j0 = 0;
    }
  };
  // this thread's slot of the chunk at (col, j0): its bucket id
  auto load_id = [&](int col, int j0) {
    const int j = j0 + t;
    return (col < s && j < cap) ? bucket[(size_t)nrow[col] * cap + j] : n;
  };
  Cand<T> atom;
  Par<T, TABLE> atom_par;
  auto load_atom = [&](int a) {
    atom.id = a;
    if (a < n) {
      atom.x = x[3 * (size_t)a];
      atom.y = x[3 * (size_t)a + 1];
      atom.z = x[3 * (size_t)a + 2];
      atom_par.q = q[a];
      if constexpr (TABLE) {
        atom_par.t = types[a];
      } else {
        atom_par.s = sig[a];
        atom_par.e = eps[a];
      }
    }
  };

  int col = next_column(0), j0 = 0;     // the chunk about to be computed
  int id = load_id(col, j0);
  int cnt = __syncthreads_count(id < n);  // its real atoms
  load_atom(id);
  int col_next = col, j0_next = j0;     // the chunk after it
  advance(col_next, j0_next, cnt);
  id = load_id(col_next, j0_next);
  while (col < s) {
    __syncthreads();  // the chunk before this one has been read
    if (atom.id < n) {
      cand[t] = atom;
      par[t] = atom_par;
    }
    // the next chunk's real atoms; the barrier makes this chunk visible
    const int cnt_next = __syncthreads_count(id < n);
    int col_after = col_next, j0_after = j0_next;
    advance(col_after, j0_after, cnt_next);
    const int id_after = load_id(col_after, j0_after);
    load_atom(id);

    if (home) {
      for (int base = 32 * part; base < cnt; base += 32 * split) {
        const int j = base + lane;
        const Cand<T> cj = cand[j];
        T dx = xi - cj.x, dy = yi - cj.y, dz = zi - cj.z;
        image.apply(dx, dy, dz);
        const T r2 = dx * dx + dy * dy + dz * dz;
        const bool excl = excluded_by_bits(exc_h, hid, cj.id);
        bool hit = (j < cnt) & (r2 < p.rc2_hi) & !excl;
        if (EXC == EXC_SPLIT && hit) {
          hit = !excluded_far(far_bits, far_row, m, hid, cj.id);
        }
        if (hit) hit = keeps_hit<T, TRI>(p, r2, x, box, hid, cj.id);
        const int slot = hitqueue::reserve(hit, queued);
        if (hit) my_queue[slot] = make_hit(dx, dy, dz, par[j]);
        __syncwarp();
        if (queued >= 32) {
          queued -= 32;
          const Hit<T, TABLE> h = my_queue[queued + lane];
          __syncwarp();
          evaluate(h);
        }
      }
    }
    cnt = cnt_next;
    col = col_next;
    col_next = col_after;
    j0_next = j0_after;
    id = id_after;
  }
  if (lane < queued) evaluate(my_queue[lane]);

  // the lanes' sums to lane 0, then the partitions' sums to partition 0
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    fx += __shfl_xor_sync(hitqueue::FULL_WARP, fx, d);
    fy += __shfl_xor_sync(hitqueue::FULL_WARP, fy, d);
    fz += __shfl_xor_sync(hitqueue::FULL_WARP, fz, d);
    e += __shfl_xor_sync(hitqueue::FULL_WARP, e, d);
  }
  if (split > 1) {
    if (lane == 0) {
      parts[warp][0] = fx;
      parts[warp][1] = fy;
      parts[warp][2] = fz;
      parts[warp][3] = e;
    }
    __syncthreads();
    if (part == 0) {
      for (int k = 1; k < split; ++k) {
        fx += parts[warp + k][0];
        fy += parts[warp + k][1];
        fz += parts[warp + k][2];
        e += parts[warp + k][3];
      }
    }
  }
  if (home && part == 0 && lane == 0) {
    store_row(out + 4 * (size_t)hid, fx, fy, fz, T(0.5) * e);
  }
}

// The kernel's arguments, as the C entry point receives them.
template <typename T>
struct Args {
  const T *x, *q, *sig, *eps;
  const int* types;
  const T* table;
  const int *excbits, *exc, *bucket, *nbr;
  const T* box;
  int ncells, c0, c1, cap, s, n, m, ntypes, k_rows;
  Rows<T> rows;
};

template <typename T, int EXC, bool DAMPED, bool TRI, bool TABLE>
int launch_form(const Args<T>& a, int split, unsigned blocks,
                const Params<T>& p, T* out, cudaStream_t st) {
  cell_pair_kernel<T, EXC, DAMPED, TRI, TABLE>
      <<<dim3(blocks, a.k_rows), THREADS, 0, st>>>(
          a.x, a.q, a.sig, a.eps, a.types, a.table, a.excbits, a.exc,
          a.bucket, a.nbr, a.box, a.c0, a.cap, a.s, a.n, a.m, a.ntypes, split,
          p, a.rows, out);
  return (int)cudaGetLastError();
}

// The instantiation of the template axes each launch selects at run time.
template <typename T, int EXC, bool DAMPED, bool TRI>
int launch_table(const Args<T>& a, int split, unsigned blocks,
                 const Params<T>& p, T* out, cudaStream_t st) {
  if (a.table != nullptr) {
    return launch_form<T, EXC, DAMPED, TRI, true>(a, split, blocks, p, out,
                                                  st);
  }
  return launch_form<T, EXC, DAMPED, TRI, false>(a, split, blocks, p, out,
                                                 st);
}

template <typename T, int EXC, bool DAMPED>
int launch_box(const Args<T>& a, int tri, int split, unsigned blocks,
               const Params<T>& p, T* out, cudaStream_t st) {
  if (tri) {
    return launch_table<T, EXC, DAMPED, true>(a, split, blocks, p, out, st);
  }
  return launch_table<T, EXC, DAMPED, false>(a, split, blocks, p, out, st);
}

template <typename T, int EXC>
int launch_damped(const Args<T>& a, int tri, int split, unsigned blocks,
                  const Params<T>& p, T* out, cudaStream_t st) {
  if (damped(p)) {
    return launch_box<T, EXC, true>(a, tri, split, blocks, p, out, st);
  }
  return launch_box<T, EXC, false>(a, tri, split, blocks, p, out, st);
}

template <typename T>
int launch(const Args<T>& a, int tri, const double* scal, const int* flags,
           T* out, void* stream) {
  const bool has_table = a.table != nullptr;
  if (a.cap < 1 || a.ncells < 1 || a.c0 < 0 || a.c1 < a.c0 ||
      a.c1 > a.ncells || a.s < 1 || a.n < 0 || a.m < 0 ||
      (a.exc != nullptr && a.m < 1) || a.excbits == nullptr ||
      (has_table && (a.types == nullptr || a.ntypes < 1)) ||
      !flags_valid(flags, has_table) || !rows_valid(a.k_rows, a.rows)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.c1 == a.c0) return 0;  // an empty home range: nothing to launch
  // warps that share a home atom: 1 where the atoms alone fill the card (a
  // function of n alone, so that a row is summed in the same order whatever
  // the home range)
  int split = 1;
  while (split < WARPS && (long long)a.n * split < TARGET_WARPS) split *= 2;
  const int per_block = WARPS / split;
  const long long blocks =
      (long long)(a.c1 - a.c0) * ((a.cap + per_block - 1) / per_block);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params<T> p = make_params<T>(scal, flags);
  cudaStream_t st = (cudaStream_t)stream;
  if (a.exc != nullptr) {
    return launch_damped<T, EXC_SPLIT>(a, tri, split, (unsigned)blocks, p,
                                       out, st);
  }
  Args<T> bits = a;
  bits.m = 0;
  return launch_damped<T, EXC_BITS>(bits, tri, split, (unsigned)blocks, p,
                                    out, st);
}

}  // namespace

// Plain C entry points, bound with ctypes; the arguments of half_pair.cu's
// and the home-cell range [c0, c1) after `ncells`: only the atoms of those
// cells get their rows (0 <= c0 <= c1 <= ncells; c0 = 0, c1 = ncells sweeps
// every cell, and an empty range launches nothing). The stencil cells of a
// home cell are read wherever they lie, so the rows of disjoint ranges sum
// to the rows of the whole sweep, bit for bit: force decomposition over
// home cells (parallel/spatial.py). `scal` and `flags` are host arrays
// (pair_forms.cuh::make_params). `excbits` and `exc` give the exclusions
// as in half_pair.cu: the bitmask alone, or with the far ids, the split
// form (sorted ascending, -1 padded, any m >= 1). `table` is null for
// Lorentz-Berthelot combining, else the (ntypes, ntypes, 4) type-pair table
// with the (n,) int32 LJ types in `types`. `box` holds the (3,) edge
// lengths when `tri` is 0, else the (3, 3) cell matrix, rows = lattice
// vectors. Every row of `bucket` holds its real ids first. `k_rows`,
// `strides` and `lamb_rows` give the replica axis as in half_pair.cu, and
// `out` holds k_rows zeroed (n + 1, 4) slices. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int cell_pair_f32(const float* x, const float* q, const float* sig,
                             const float* eps, const int* types,
                             const float* table, const int* excbits,
                             const int* exc, const int* bucket, const int* nbr,
                             const float* box, int ncells, int c0, int c1,
                             int cap, int s, int n, int m, int tri,
                             int ntypes, int k_rows, const long long* strides,
                             const float* lamb_rows, const double* scal,
                             const int* flags, float* out, void* stream) {
  const Rows<float> rows{strides[0], strides[1], strides[2], strides[3],
                         strides[4], strides[5], strides[6], lamb_rows};
  const Args<float> a{x,   q,      sig, eps,    types, table, excbits,
                      exc, bucket, nbr, box, ncells, c0,  c1,
                      cap, s,      n,   m,   ntypes, k_rows, rows};
  return launch<float>(a, tri, scal, flags, out, stream);
}

extern "C" int cell_pair_f64(const double* x, const double* q,
                             const double* sig, const double* eps,
                             const int* types, const double* table,
                             const int* excbits, const int* exc,
                             const int* bucket, const int* nbr,
                             const double* box, int ncells, int c0, int c1,
                             int cap, int s, int n, int m, int tri,
                             int ntypes, int k_rows, const long long* strides,
                             const double* lamb_rows, const double* scal,
                             const int* flags, double* out, void* stream) {
  const Rows<double> rows{strides[0], strides[1], strides[2], strides[3],
                          strides[4], strides[5], strides[6], lamb_rows};
  const Args<double> a{x,   q,      sig, eps,    types, table, excbits,
                       exc, bucket, nbr, box, ncells, c0,  c1,
                       cap, s,      n,   m,   ntypes, k_rows, rows};
  return launch<double>(a, tri, scal, flags, out, stream);
}
