// Newton half-stencil cell-pair sweep for Hopper (sm_90a).
//
// Replaces atomsmm_tpu/ops/pallas_pair.py::_half_kernel. Each home cell c
// meets the half-stencil cells nbr[c, k] (k = 0 is c itself, then the
// lexicographically positive directions). On every (home atom, candidate)
// slot it applies the per-slot minimum image, the cutoff test (in
// float32, a hit near r_c is decided again in float64:
// pair_forms.cuh::keeps_hit), the exclusions and one of the built-in
// pair forms (pair_forms.cuh), and adds
// the force -2 du/dr^2 dx to the home atom and its reaction to the
// candidate. Exclusions take one of three forms, a template parameter
// (pair_forms.cuh, EXC): the relative-offset bitmask (one shift per slot);
// for systems whose excluded pairs lie more than +-14 atom indices apart, a
// compare of the candidate id with the home atom's exclusion id columns
// (at most 16), held in registers, plus the self test hid != cid; or, for
// wider tables, the bitmask for the pairs within +-14 indices and the home
// atom's row of far ids in global memory, folded into a 64-bit filter in
// registers and scanned for a hit outside that window whose filter bit is
// set (the split form: the test runs in the walk, on hits only).
//
// What bounds it: the slot tests and the latency of each block's chain of
// directions. On the 30k water headline the far sweep has 343 cells x 14
// directions x 112^2 = 60.2 M slots, 36.7 M of them between real atoms and
// 5.6 M in range; the near sweep 1331 x 14 x 36^2 = 24.1 M, 9.5 M and
// 1.0 M. A slot test (minimum image, r^2, exclusion) is about 21 float
// operations, a pair form 100-200. The design:
//   * one block per home cell; its home atoms stay in registers for all
//     directions, and their force and energy accumulate there;
//   * the block gathers its atoms itself through the bucket ids, and stages
//     the next direction's candidate cell into a second shared-memory
//     buffer with cp.async while the current one is computed; only the
//     slots up to each cell's last real atom are tested;
//   * cull, then evaluate: for each direction each thread first tests its
//     candidate slots and records the hits as bits in registers (four 32-bit
//     words per 128 slots), then walks only the set bits, so a warp runs the
//     pair form as often as its busiest lane has hits, not once per slot;
//     each lane starts its walk at its own word and bit, so that the lanes'
//     reaction atomics rarely meet on one candidate. The walk's loop is not
//     unrolled: four inlined copies of the pair form made the far sweep
//     slower;
//   * PARTS = 2 candidate partitions of the home cell share a block (one
//     where a block would exceed 1,024 threads): the far grid's 343 cells
//     alone give too few warps to hide the walk's latency. Their home sums
//     are combined in shared memory at the end;
//   * the minimum image rounds by two additions on the float pipes instead
//     of rint (the same result, half to even; pair_forms.cuh::Image,
//     shared with K2 and K3); a (3, 3) cell (TRI) rounds in fractional
//     coordinates through inv(H), 18 products a slot where the (3,) box
//     takes 6;
//   * output: one zeroed (n + 1, 4) [fx fy fz e] tensor per atom. A
//     direction's reaction sums meet in shared memory (compare-and-swap
//     loops: this card has no native shared-memory float add), and at its
//     end the block adds them to the candidates' rows, and at the end its
//     home sums to the home atoms' rows, by global atomics (one vector
//     red.global.add.v4.f32 per row in float32). A version that added
//     every hit's reaction to device memory directly, and staged all
//     directions at once, was slower at both 30k shapes. Float32 results
//     vary in their last bits from run to run;
//   * a replica axis: the grid is (ncells, K), and block (c, k) sweeps home
//     cell c of row k, its inputs offset by the row's strides (0 where the
//     rows share one, as the lambda states of one configuration share x
//     and the bucket), its lambda the row's (pair_forms.cuh::Rows),
//     its reactions and home sums added to the row's own (n + 1, 4) slice
//     of the output. K replicas or lambda states take one launch; a row of
//     it computes what the single-row launch computes (the same blocks, the
//     same order within each; float32 last bits vary by the atomics as
//     they do between two single-row launches);
//   * NBFIX tables and the 10-12 term (TABLE, a template parameter): the
//     staged candidate carries its int32 LJ type in place of (sigma,
//     epsilon), and each hit reads its pair's (sigma, epsilon, A, B) row
//     of the (T, T, 4) table from global memory through the read-only
//     cache (pair_forms.cuh::load_pair_row): two gathers a pair more than
//     Lorentz-Berthelot, from a table of a few KB that stays in L1.
//
// The plain PyTorch twin of this file is ops/pair_kernel.py::half_pair_plain
// with ops/pairfuncs.py::form_u_dudr2.

#include <cuda_pipeline.h>

#include "pair_forms.cuh"

namespace {

using namespace pairforms;

constexpr int CHUNK = 128;  // candidate slots culled into one hit mask
constexpr int PARTS = 2;    // candidate partitions of a block

// A staged candidate: position and atom id (n = padding), read by the slot
// test with one 16-byte load in float32; its pair parameters beside it:
// (q, sigma, epsilon), or (q, LJ type) in the TABLE form.
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

// out[row] += (a, b, c, d) by global atomics
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

// The kernel's arguments, as the C entry point receives them.
template <typename T>
struct Args {
  const T *x, *q, *sig, *eps;
  const int* types;
  const T* table;
  const int *excbits, *exc, *bucket, *nbr;
  const T* box;
  int ncells, cap, s_half, n, m, ntypes, k_rows;
  Rows<T> rows;
};

// One block per (home cell, row), threads = round_up(parts * cap, 32):
// thread t = part * cap + i holds home slot i and tests the candidate slots
// j = part + parts * s of every direction. The arrays below are row 0's;
// block (c, k) offsets each by k times its stride in `rows`, and `out` by
// k (n + 1) 4.
//   x (n, 3); q, sig, eps (n,)     atoms, gathered through the ids
//   types (n,); table (T, T, 4)    LJ types and type-pair rows (TABLE)
//   excbits (n + 1,)               exclusion bits (bitmask form)
//   exc (n, m)                     far ids, sorted ascending, -1
//                                  padded (EXC_SPLIT; else null)
//   bucket (ncells, cap)           atom ids, n = padding
//   nbr (ncells, s_half)           half-stencil cell map, column 0 = c
//   box (3,) or (3, 3)             edge lengths, or the cell matrix (TRI)
//   out (K, n + 1, 4)              zeroed; per row and atom [fx fy fz e]
template <typename T, int EXC, bool DAMPED, bool TRI, bool TABLE, int MAXT>
__global__ void __launch_bounds__(MAXT)
    half_pair_kernel(const T* __restrict__ x, const T* __restrict__ q,
                     const T* __restrict__ sig, const T* __restrict__ eps,
                     const int* __restrict__ types,
                     const T* __restrict__ table,
                     const int* __restrict__ excbits,
                     const int* __restrict__ exc,
                     const int* __restrict__ bucket,
                     const int* __restrict__ nbr, const T* __restrict__ box,
                     int cap, int s_half, int n, int m, int ntypes, int parts,
                     Params<T> p0, Rows<T> rows, T* __restrict__ out) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Cand<T>* cand = reinterpret_cast<Cand<T>*>(smem_raw);  // [2][cap]
  Par<T, TABLE>* par =
      reinterpret_cast<Par<T, TABLE>*>(cand + 2 * cap);  // [2][cap]
  T* rx = reinterpret_cast<T*>(par + 2 * cap);           // [2][cap] each
  T* ry = rx + 2 * cap;
  T* rz = ry + 2 * cap;
  T* hs = rz + 2 * cap;  // [parts][cap][4] when parts > 1
  int* ext = reinterpret_cast<int*>(hs + (parts > 1 ? parts * cap * 4 : 0));

  const int c = blockIdx.x;
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
  const int part = t / cap;
  const int i = t - part * cap;
  const int* nrow = nbr + (size_t)c * s_half;

  for (int j = t; j < 2 * cap; j += blockDim.x) {
    rx[j] = T(0);
    ry[j] = T(0);
    rz[j] = T(0);
  }
  if (t < 2) ext[t] = 0;
  __syncthreads();

  // Slot t of a candidate cell into buffer b: the id now, the atom's
  // features by cp.async; ext[b] becomes one past the last real atom.
  auto stage = [&](int b, int id) {
    if (t < cap) {
      Cand<T>& cd = cand[b * cap + t];
      cd.id = id;
      if (id < n) {
        const T* xa = x + 3 * (size_t)id;
        Par<T, TABLE>& pr = par[b * cap + t];
        __pipeline_memcpy_async(&cd.x, xa, sizeof(T));
        __pipeline_memcpy_async(&cd.y, xa + 1, sizeof(T));
        __pipeline_memcpy_async(&cd.z, xa + 2, sizeof(T));
        __pipeline_memcpy_async(&pr.q, q + id, sizeof(T));
        if constexpr (TABLE) {
          __pipeline_memcpy_async(&pr.t, types + id, sizeof(int));
        } else {
          __pipeline_memcpy_async(&pr.s, sig + id, sizeof(T));
          __pipeline_memcpy_async(&pr.e, eps + id, sizeof(T));
        }
        atomicMax(&ext[b], t + 1);
      }
    }
    __pipeline_commit();
  };

  // the home atom of this thread, in registers for every direction
  const int hid = part < parts ? bucket[(size_t)c * cap + i] : n;
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
  T fx = T(0), fy = T(0), fz = T(0), e = T(0);

  stage(0, t < cap ? bucket[(size_t)nrow[0] * cap + t] : n);
  int id_next = (s_half > 1 && t < cap) ? bucket[(size_t)nrow[1] * cap + t] : n;

  for (int k = 0; k < s_half; ++k) {
    const int b = k & 1;
    // ids two directions ahead; the next direction's atoms into the other
    // buffer, in flight while this direction is computed
    const int id_after = (k + 2 < s_half && t < cap)
                             ? bucket[(size_t)nrow[k + 2] * cap + t]
                             : n;
    if (k + 1 < s_half) {
      stage(b ^ 1, id_next);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    const int eb = ext[b];

    if (home) {
      const Cand<T>* cb = cand + b * cap;
      const Par<T, TABLE>* pb = par + b * cap;
      T* rxb = rx + b * cap;
      T* ryb = ry + b * cap;
      T* rzb = rz + b * cap;
      const bool self_dir = (k == 0);
      const T w = self_dir ? T(0.5) : T(1);
      const int ns = (eb - part + parts - 1) / parts;  // this partition's slots
      for (int s0 = 0; s0 < ns; s0 += CHUNK) {
        // cull: one bit per slot in range, not excluded, not padding
        unsigned b0 = 0u, b1 = 0u, b2 = 0u, b3 = 0u;
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          const int sb = s0 + 32 * wd;
          const int lim = min(32, ns - sb);
          unsigned word = 0u;
#pragma unroll 4
          for (int bb = 0; bb < lim; ++bb) {
            const Cand<T> cj = cb[part + parts * (sb + bb)];
            T dx = xi - cj.x, dy = yi - cj.y, dz = zi - cj.z;
            image.apply(dx, dy, dz);
            const T r2 = dx * dx + dy * dy + dz * dz;
            const bool excl = excluded_by_bits(exc_h, hid, cj.id);
            const bool hit = (cj.id < n) & (r2 < p.rc2_hi) & !excl;
            word |= (unsigned)hit << bb;
          }
          if (wd == 0) b0 = word;
          if (wd == 1) b1 = word;
          if (wd == 2) b2 = word;
          if (wd == 3) b3 = word;
        }
        // evaluate the hits; each lane starts at its own word and bit, so
        // that the lanes' reaction atomics rarely meet on one candidate
#pragma unroll 1
        for (int ww = 0; ww < 4; ++ww) {
          const int wd = (ww + (lane >> 3)) & 3;
          unsigned word = wd == 0 ? b0 : (wd == 1 ? b1 : (wd == 2 ? b2 : b3));
          if (word == 0u) continue;
          const int span = min(32, ns - s0 - 32 * wd);
          const int rot = (lane * span) >> 5;
          word = __funnelshift_r(word, word, rot);
          while (word != 0u) {
            const int bit = __ffs(word) - 1;
            word &= word - 1u;
            const int j = part + parts * (s0 + 32 * wd + ((bit + rot) & 31));
            const Cand<T> cj = cb[j];
            if (EXC == EXC_SPLIT &&
                excluded_far(far_bits, far_row, m, hid, cj.id)) {
              continue;
            }
            const Par<T, TABLE> pj = pb[j];
            T dx = xi - cj.x, dy = yi - cj.y, dz = zi - cj.z;
            image.apply(dx, dy, dz);
            const T r2 = dx * dx + dy * dy + dz * dz;
            if (!keeps_hit<T, TRI>(p, r2, x, box, hid, cj.id)) continue;
            const T qprod = qi * pj.q;
            T u, dudr2;
            if constexpr (TABLE) {
              const PairRow<T> row = load_pair_row(table, ntypes, ti, pj.t);
              pair_form<T, DAMPED, true>(p, r2, qprod, row.sig, row.eps, u,
                                         dudr2, row.a, row.b);
            } else {
              const T sg = T(0.5) * (si + pj.s);
              const T ep = sqrt(ei * pj.e);
              pair_form<T, DAMPED>(p, r2, qprod, sg, ep, u, dudr2);
            }
            const T fm = T(2) * dudr2;
            const T gx = fm * dx, gy = fm * dy, gz = fm * dz;
            fx -= gx;
            fy -= gy;
            fz -= gz;
            e += w * u;
            if (!self_dir) {
              atomicAdd(&rxb[j], gx);
              atomicAdd(&ryb[j], gy);
              atomicAdd(&rzb[j], gz);
            }
          }
        }
      }
    }
    __syncthreads();
    if (t == 0) ext[b] = 0;
    // the candidates' reaction sums of this direction to their atoms
    if (k > 0 && t < eb) {
      const int id = cand[b * cap + t].id;
      const T gx = rx[b * cap + t], gy = ry[b * cap + t], gz = rz[b * cap + t];
      if (id < n && (gx != T(0) || gy != T(0) || gz != T(0))) {
        add_row(out + 4 * (size_t)id, gx, gy, gz, T(0));
      }
      rx[b * cap + t] = T(0);
      ry[b * cap + t] = T(0);
      rz[b * cap + t] = T(0);
    }
    __syncthreads();
    id_next = id_after;
  }

  // home sums: the partitions' parts combined, one atomic row per atom
  if (parts > 1) {
    if (part < parts) {
      T* h = hs + 4 * (size_t)t;
      h[0] = fx;
      h[1] = fy;
      h[2] = fz;
      h[3] = e;
    }
    __syncthreads();
    if (t < cap) {
      for (int pp = 1; pp < parts; ++pp) {
        const T* h = hs + 4 * ((size_t)pp * cap + t);
        fx += h[0];
        fy += h[1];
        fz += h[2];
        e += h[3];
      }
    }
  }
  if (t < cap && home) add_row(out + 4 * (size_t)hid, fx, fy, fz, e);
}

template <typename T, bool TABLE>
size_t smem_bytes(int cap, int parts) {
  return (size_t)2 * cap *
             (sizeof(Cand<T>) + sizeof(Par<T, TABLE>) + 3 * sizeof(T)) +
         (parts > 1 ? (size_t)parts * cap * 4 * sizeof(T) : 0) +
         2 * sizeof(int);
}

template <typename T, int EXC, bool DAMPED, bool TRI, bool TABLE, int MAXT>
int launch_form(const Args<T>& a, int parts, int threads, const Params<T>& p,
                T* out, cudaStream_t stream) {
  auto kernel = half_pair_kernel<T, EXC, DAMPED, TRI, TABLE, MAXT>;
  const size_t smem = smem_bytes<T, TABLE>(a.cap, parts);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a.ncells, a.k_rows), threads, smem, stream>>>(
      a.x, a.q, a.sig, a.eps, a.types, a.table, a.excbits, a.exc, a.bucket,
      a.nbr, a.box, a.cap, a.s_half, a.n, a.m, a.ntypes, parts, p, a.rows,
      out);
  return (int)cudaGetLastError();
}

// The instantiation of the template axes each launch selects at run time:
// blocks of up to 256 threads take the register budget of 256 threads,
// larger ones that of 1,024 (64 a thread; a budget of 128 for blocks of up
// to 512 left the far grid's 343 blocks too few per SM for one wave).
template <typename T, int EXC, bool DAMPED, bool TRI, bool TABLE>
int launch_size(const Args<T>& a, int parts, const Params<T>& p, T* out,
                cudaStream_t stream) {
  const int threads = ((parts * a.cap + 31) / 32) * 32;
  if (threads <= 256) {
    return launch_form<T, EXC, DAMPED, TRI, TABLE, 256>(a, parts, threads, p,
                                                        out, stream);
  }
  return launch_form<T, EXC, DAMPED, TRI, TABLE, 1024>(a, parts, threads, p,
                                                       out, stream);
}

template <typename T, int EXC, bool DAMPED, bool TRI>
int launch_table(const Args<T>& a, int parts, const Params<T>& p, T* out,
                 cudaStream_t stream) {
  if (a.table != nullptr) {
    return launch_size<T, EXC, DAMPED, TRI, true>(a, parts, p, out, stream);
  }
  return launch_size<T, EXC, DAMPED, TRI, false>(a, parts, p, out, stream);
}

template <typename T, int EXC, bool DAMPED>
int launch_box(const Args<T>& a, int tri, int parts, const Params<T>& p,
               T* out, cudaStream_t stream) {
  if (tri) {
    return launch_table<T, EXC, DAMPED, true>(a, parts, p, out, stream);
  }
  return launch_table<T, EXC, DAMPED, false>(a, parts, p, out, stream);
}

template <typename T, int EXC>
int launch_damped(const Args<T>& a, int tri, int parts, const Params<T>& p,
                  T* out, cudaStream_t stream) {
  if (damped(p)) {
    return launch_box<T, EXC, true>(a, tri, parts, p, out, stream);
  }
  return launch_box<T, EXC, false>(a, tri, parts, p, out, stream);
}

template <typename T>
int launch(const Args<T>& a, int tri, const double* scal, const int* flags,
           T* out, void* stream) {
  const bool has_table = a.table != nullptr;
  if (a.cap < 1 || a.cap > 1024 || a.ncells < 1 || a.s_half < 1 || a.n < 0 ||
      a.m < 0 || (a.exc != nullptr && a.m < 1) || a.excbits == nullptr ||
      (has_table && (a.types == nullptr || a.ntypes < 1)) ||
      !flags_valid(flags, has_table) || !rows_valid(a.k_rows, a.rows)) {
    return (int)cudaErrorInvalidValue;
  }
  // one block: at most 1,024 threads
  const int parts = PARTS * a.cap <= 1024 ? PARTS : 1024 / a.cap;
  const Params<T> p = make_params<T>(scal, flags);
  cudaStream_t s = (cudaStream_t)stream;
  if (a.exc != nullptr) {
    return launch_damped<T, EXC_SPLIT>(a, tri, parts, p, out, s);
  }
  Args<T> bits = a;
  bits.m = 0;
  return launch_damped<T, EXC_BITS>(bits, tri, parts, p, out, s);
}

}  // namespace

// Plain C entry points, bound with ctypes. `scal` and `flags` are host
// arrays (pair_forms.cuh::make_params). `excbits` (never null) alone gives the
// bitmask form; with `exc` the split form: the bitmask of the pairs within
// +-14 indices and in `exc` each atom's (n, m) far ids, sorted ascending
// and -1 padded, any m >= 1. `table` is null for Lorentz-Berthelot combining (`types`
// null, `ntypes` 0), else the (ntypes, ntypes, 4) type-pair table
// [sigma, epsilon, A, B] with the (n,) int32 LJ types in `types`; `sig`
// and `eps` are then not read. `box` holds the (3,) edge lengths when
// `tri` is 0, else the (3, 3) cell matrix, rows = lattice vectors
// (pair_forms.cuh::Image). `k_rows` rows (replicas or lambda states) run
// in one launch: `strides` is a host array of seven element strides
// between rows (x, q, sig, eps, types, bucket, box; 0 where the rows
// share the array), `lamb_rows` null or a device table of the rows'
// softcore lambdas, (k_rows,) of the working type, and `out` holds k_rows
// zeroed (n + 1, 4) slices. Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int half_pair_f32(const float* x, const float* q, const float* sig,
                             const float* eps, const int* types,
                             const float* table, const int* excbits,
                             const int* exc, const int* bucket, const int* nbr,
                             const float* box, int ncells, int cap, int s_half,
                             int n, int m, int tri, int ntypes, int k_rows,
                             const long long* strides,
                             const float* lamb_rows, const double* scal,
                             const int* flags, float* out, void* stream) {
  const Rows<float> rows{strides[0], strides[1], strides[2], strides[3],
                         strides[4], strides[5], strides[6], lamb_rows};
  const Args<float> a{x,      q,   sig, eps,    types, table,  excbits,
                      exc,    bucket, nbr, box, ncells, cap, s_half,
                      n,      m,   ntypes, k_rows, rows};
  return launch<float>(a, tri, scal, flags, out, stream);
}

extern "C" int half_pair_f64(const double* x, const double* q,
                             const double* sig, const double* eps,
                             const int* types, const double* table,
                             const int* excbits, const int* exc,
                             const int* bucket, const int* nbr,
                             const double* box, int ncells, int cap,
                             int s_half, int n, int m, int tri, int ntypes,
                             int k_rows, const long long* strides,
                             const double* lamb_rows, const double* scal,
                             const int* flags, double* out, void* stream) {
  const Rows<double> rows{strides[0], strides[1], strides[2], strides[3],
                          strides[4], strides[5], strides[6], lamb_rows};
  const Args<double> a{x,      q,   sig, eps,    types, table,  excbits,
                       exc,    bucket, nbr, box, ncells, cap, s_half,
                       n,      m,   ntypes, k_rows, rows};
  return launch<double>(a, tri, scal, flags, out, stream);
}
