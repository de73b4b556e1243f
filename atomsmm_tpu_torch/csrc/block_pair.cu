// Atom-block pair sweep for Hopper (sm_90a), "K4".
//
// Replaces no Pallas kernel: the JAX package runs this sweep,
// atomsmm_tpu/ops/blocks.py::block_pair_sums, as XLA operations. A sweep of
// pair slots as PyTorch operations costs hundreds of times a kernel on this
// card, so the block lists get their own. Atoms are sorted in serpentine
// cell order and cut into blocks of B atoms (ops/blocks.py); home block i
// lists its candidate blocks cand[i, :] (ascending, -1 padded, itself
// first), each block pair once (Newton at block level). The sweep computes
// what the JAX sweep computes:
//   * every home atom against every atom of its candidate blocks, the
//     displacement's minimum image, the cutoff, the self pair and the
//     exclusions (the relative-offset bitmask, or the split form: the
//     bitmask and each atom's far ids);
//   * the pair form through pair_forms.cuh::pair_form, every form K1 to K3
//     take (reaction field, Ewald and damped, near, the fused far form,
//     the virial flag, softcore and its lambda derivative);
//   * per-atom [fx fy fz e] rows of an (N + 1, 4) output, as K1 gives (row
//     N: the padding). A pair's energy sits whole on its home atom.
//
// What bounds it on this card: issue slots, the latency of each step of
// a block's work, and the sweep's tail; not bytes, nor the pair form
// (k1_ab/k4_variants.py times K4 with each part taken out, and
// k1_ab/block_groups.py counts what it tests). At 30k water the far list
// (r_build 1.0 nm) holds 26,363 block pairs of 64 x 64 slots, 4% of them
// in range, in rows of 1 to 124 candidates (K 145). A block per (row,
// chunk of K) would leave most of its grid idle, a chunk staged by
// dependent gathers behind a barrier would wait on each, an image per slot
// costs three roundings a test, and 32-atom groups span most of a block.
// The design, part by part:
//   * a pack kernel (block_pair_pack_kernel, launched by the same C entry
//     point, one thread block per atom block) writes a packed copy of the
//     atoms, a block at a time: B rows of [x y z q], B rows of [sigma/2
//     sqrt(epsilon) id excbits] in the working type (the integers by their
//     bits; padding rows id N), and two rows of the block's frame as a
//     home block (below). Inside a block the atoms go in the serpentine
//     order of a 4^3 grid over the block's own box (ops/blocks.py::
//     packed_order is its plain twin), so that 8 consecutive atoms are
//     compact; no sum depends on the order inside a block. Once a sweep,
//     not each time a block is staged. The same kernel counts each row's
//     candidates, and its last thread block (the last to finish, by an
//     atomic count) lists the live work items, (home block, CHUNK of its
//     candidates): level by level, the self chunks first (the nearest
//     blocks cost most), and in each level the longest rows first;
//   * K4 (block_pair_kernel) runs a persistent grid, as many thread blocks
//     as the card keeps resident, which claim items by an atomic counter.
//     No block is launched for a chunk past a row's end, and no host read
//     is needed: the counters (the pack kernel's, the claims, and the
//     (home atom, group) pairs tested, one add a warp at its end) lie in a
//     row past the output's, zeroed by the sweep's own zero fill, so a
//     sweep is four device operations (the fill, the pack, K4, the energy
//     sum). Thread 0 claims three items ahead, each step's load used an
//     item after it was issued;
//   * thread 0 streams the packed blocks of the items, each home block
//     before its candidates, through a ring of STAGES buffers: a 1-D bulk
//     copy (cp.async.bulk, completing on an mbarrier) a block, issued up to
//     a ring ahead, so the next item's copies are in flight while the
//     block works on this one. A thread block takes an item a turn: its
//     home block, then its (one or two) candidate blocks as one row of
//     slots;
//   * what the simpler designs measured at path (o)'s far / near lists
//     against this one in one call (k1_ab/k4_variants.py, K4 alone, NVIDIA
//     H100 80GB HBM3, 700 W): a static stride 1.09x / 0.83x its time, a
//     thread block per item (a grid over the list, the blocks past the
//     live items leaving at once) 0.95x / 0.85x, the threads' own loads in
//     place of the bulk copies 1.06x / 1.00x, a ring of one item 0.99x /
//     0.98x, reactions summed in shared memory 1.23x / 1.20x. So the bulk
//     copies and the L2 reductions earn their place; the persistent grid,
//     its claims and the ring's depth past one item do not, at this list;
//   * the home block's frame: its centre c is the middle of its box, and
//     every atom staged, home or candidate, is moved to its image nearest
//     c once, after it lands. With E_d the largest |staged - c|_d over the
//     home atoms, where E_d + r_c < (1/2 - FRAME_MARGIN) L_d in every
//     dimension, a pair in range lies within L_d / 2 of c, so its staged
//     displacement is the minimum image, and a pair out of range stays out:
//     the slot test, the group-box reach test and the evaluation then take
//     no image. Elsewhere (boxes under about 2 (r_c + E)) they take it per
//     test, as the JAX sweep does; ops/blocks.py::block_frames is the plain
//     twin of the test. x - c rounds at the box's scale, so a float32 hit
//     near r_c is decided again in float64 from the stored coordinates
//     (pair_forms.cuh::keeps_hit), as K1 and K2 decide theirs;
//   * the candidates are cut into 8-atom groups, each with its box (a
//     shuffle reduction over 8 lanes). Warp w owns home atoms w, w + 4, ...
//     (an even share of each block's geometry): their reach masks (one bit
//     a group) list its (home atom, group) pairs, which it tests four at a
//     time (four groups of 8 lanes), pushing the hits on its queue
//     (hit_queue.cuh) and evaluating them 32 at a time; the exclusions are
//     tested at the evaluation, on the pairs in range. At path (o)'s far
//     list (k1_ab/block_groups.py) 32-atom groups in list order leave
//     24.3 M of the 108.0 M slots to test, 8-atom groups 15.5 M in list
//     order, 14.5 M in Morton order and 13.9 M in this serpentine order,
//     for 4.54 M pairs in range;
//   * the self block takes each pair once (the candidate behind the home
//     atom in the packed block) at weight 1 with its reaction: the same
//     sums as both orderings at weight 1/2 without reaction;
//   * a popped batch is ordered by home atom (a warp's list is): the home
//     sums meet by a segmented shuffle reduction that stops at the longest
//     run, and one lane a run adds them to the warp's own row of that atom
//     in shared memory, flushed once an item by one reduction a nonzero
//     row; the reactions go straight to the output by reductions in L2
//     (summed in shared memory first, they cost more, above). The warps' leftover hits are merged in
//     warp order (still one run a home atom) and evaluated a batch a warp.
// The reductions sum in an order that changes from run to run: float32
// rows differ in their last bits between runs, float64 ones far below the
// tests' tolerances.
//
// The plain PyTorch twin of this file is ops/blocks.py::block_pair_plain.

#include <stdint.h>

#include "hit_queue.cuh"
#include "pair_forms.cuh"

namespace {

using namespace pairforms;

constexpr int MAX_B = 128;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PACK_THREADS = 256;
constexpr int GROUP = 8;               // atoms a group, one reach bit each
constexpr int MAX_GROUPS = MAX_B / GROUP;
constexpr int CHUNK = 2;               // candidate blocks a work item
constexpr unsigned NO_HIT = 0xffffffffu;
constexpr int END = -0x7fffffff - 1;  // a ring buffer's meta after the last
constexpr double FRAME_MARGIN = 1e-4;  // ops/blocks.py::FRAME_MARGIN

// ring buffers a thread block: two items (a home block and CHUNK
// candidates each) in float32, one and a block in float64, whose rows are
// twice as wide
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 4 ? 6 : 4;
}

// The packed copy: per atom block, B rows of PosQ, B rows of ParI, and two
// rows of its frame as a home block ([cx cy cz 0], [Ex Ey Ez 0]).
template <typename T>
struct alignas(4 * sizeof(T)) PosQ {
  T x, y, z, q;
};

template <typename T>
struct alignas(4 * sizeof(T)) ParI {
  T s, e;
  int id, bits;
};

// The same rows once a block has landed and been imaged in place: the
// position in the home block's frame and the atom id (N = padding), read
// by the slot test with one 16-byte load in float32, and the pair
// parameters.
template <typename T>
struct alignas(4 * sizeof(T)) Pos {
  T x, y, z;
  int id;
};

template <typename T>
struct alignas(4 * sizeof(T)) Par {
  T s, e, q;
};

static_assert(sizeof(PosQ<float>) == 16 && sizeof(ParI<float>) == 16 &&
                  sizeof(Pos<float>) == 16 && sizeof(Par<float>) == 16,
              "packed float32 rows are 16 bytes");
static_assert(sizeof(PosQ<double>) == 32 && sizeof(ParI<double>) == 32 &&
                  sizeof(Pos<double>) == 32 && sizeof(Par<double>) == 32,
              "packed float64 rows are 32 bytes");

__host__ __device__ constexpr size_t align_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

// A thread block's shared memory at block size b, in bytes from its base.
template <typename T>
struct Layout {
  size_t elem, ring, hpos, hpar, hs, gbox, hexc, hfar, list, queue, merged,
      ints, bars, bytes;
  __host__ __device__ explicit Layout(int b) {
    const int groups = (b + GROUP - 1) / GROUP;
    elem = (size_t)(2 * b + 2) * 4 * sizeof(T);
    ring = 0;
    hpos = align_up(ring + (size_t)stages<T>() * elem, 128);
    hpar = hpos + (size_t)b * sizeof(Pos<T>);
    hs = hpar + (size_t)b * sizeof(Par<T>);
    gbox = align_up(hs + (size_t)WARPS * 4 * b * sizeof(T), 16);
    hexc = gbox + (size_t)6 * CHUNK * MAX_GROUPS * sizeof(T);
    hfar = hexc + (size_t)b * sizeof(unsigned);
    list = hfar + (size_t)2 * b * sizeof(unsigned);
    queue = align_up(list + (size_t)WARPS * ((b + WARPS - 1) / WARPS) *
                                CHUNK * groups * sizeof(unsigned short),
                     16);
    merged = queue + (size_t)WARPS * hitqueue::DEPTH * sizeof(unsigned);
    ints = merged + (size_t)WARPS * hitqueue::DEPTH * sizeof(unsigned);
    bars = align_up(ints + (size_t)(stages<T>() + WARPS) * sizeof(int), 8);
    bytes = align_up(bars + (size_t)stages<T>() * sizeof(uint64_t), 128);
  }
};

// Everything both kernels read, by value.
template <typename T>
struct Args {
  const T* x;
  const T* q;
  const T* sig;
  const T* eps;
  const int* excbits;
  const int* exc_far;
  const int* order;
  const int* cand;
  const T* box;
  int n, nb, b, k, m;
  T* out;              // (n + 2, 4): rows, then the counters' row
  unsigned char* packed;  // nb blocks of 2 b + 2 rows (Layout::elem bytes)
  int2* items;         // (nb k,) live work items (home block, chunk)
  int* counts;         // (nb,) candidates a row, then the item count
};

// the counters in the row past the output's (zeroed with the output): the
// pack kernel's finished blocks, the items claimed, the (home atom, group)
// pairs tested
template <typename T>
__device__ __forceinline__ int* counters(const Args<T>& a) {
  return reinterpret_cast<int*>(a.out + (size_t)(a.n + 1) * 4);
}

// a row added to the output by reductions whose results are not read,
// so that no thread waits on them
__device__ __forceinline__ void add_row(float* row, float a, float b, float c,
                                        float d) {
  atomicAdd(row, a);
  atomicAdd(row + 1, b);
  atomicAdd(row + 2, c);
  if (d != 0.0f) atomicAdd(row + 3, d);
}

__device__ __forceinline__ void add_row(double* row, double a, double b,
                                        double c, double d) {
  atomicAdd(row, a);
  atomicAdd(row + 1, b);
  atomicAdd(row + 2, c);
  if (d != 0.0) atomicAdd(row + 3, d);
}

// --- the bulk copy and its barrier (PTX) ---------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// `bytes` from global `src` into shared `dst`, completing on `bar`: the
// issuing thread's arrival, expecting that many bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// an arrival without bytes: completes the phase of a barrier of count 1
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0u;
}

// wait for the phase of `parity` to complete; a copy that never lands (a
// fault: a block lands in microseconds) traps after 2^26 polls rather than
// spinning on
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned long long spin = 0; !mbar_try(bar, parity); ++spin) {
    if (spin > (1ull << 26)) __trap();
  }
}

// a buffer the threads wrote or read is handed back to the bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = fmin(v, __shfl_xor_sync(hitqueue::FULL_WARP, v, d));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = fmax(v, __shfl_xor_sync(hitqueue::FULL_WARP, v, d));
  }
  return v;
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(hitqueue::FULL_WARP, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// A cell's place on the serpentine walk of a 4^3 grid: z fastest, its
// direction flipped on odd rows, y flipped on odd x planes
// (ops/blocks.py::packed_order)
__device__ __forceinline__ int serpentine4(int cx, int cy, int cz) {
  const int ey = (cx & 1) ? 3 - cy : cy;
  const int row = cx * 4 + ey;
  const int ez = (row & 1) ? 3 - cz : cz;
  return row * 4 + ez;
}

template <typename T>
__device__ __forceinline__ int cell4(T v, T lo, T scale) {
  const int c = (int)((v - lo) * scale);
  return c < 0 ? 0 : (c > 3 ? 3 : c);
}

// --- the pack kernel --------------------------------------------------------

// Block j: its row's candidate count, its atoms packed in serpentine order;
// the last block to finish writes the work items (the file's note).
template <typename T>
__global__ void __launch_bounds__(PACK_THREADS)
    block_pair_pack_kernel(Args<T> a) {
  __shared__ int keys[MAX_B];
  __shared__ T red[6][PACK_THREADS / 32];
  __shared__ int last;
  extern __shared__ int build[];  // the item builder's arrays
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int b = a.b, n = a.n;

  int count = 0;
  for (int e0 = 0; e0 < a.k; e0 += PACK_THREADS) {
    const int e = e0 + t;
    count += __syncthreads_count(e < a.k && a.cand[(size_t)j * a.k + e] >= 0);
  }

  const Image<T, false> img(a.box);
  const int ref = a.order[(size_t)j * b];
  const int id = t < b ? a.order[(size_t)j * b + t] : n;
  const bool real = id < n;
  T lx = T(0), ly = T(0), lz = T(0);
  if (real) {
    const T rx = a.x[3 * (size_t)ref], ry = a.x[3 * (size_t)ref + 1],
            rz = a.x[3 * (size_t)ref + 2];
    T dx = a.x[3 * (size_t)id] - rx;
    T dy = a.x[3 * (size_t)id + 1] - ry;
    T dz = a.x[3 * (size_t)id + 2] - rz;
    img.apply(dx, dy, dz);
    lx = rx + dx;
    ly = ry + dy;
    lz = rz + dz;
  }
  const T big = T(1e30);
  T v[6] = {real ? lx : big,  real ? ly : big,  real ? lz : big,
            real ? -lx : big, real ? -ly : big, real ? -lz : big};
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    v[c] = warp_min(v[c]);
    if (lane == 0) red[c][warp] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    v[c] = red[c][0];
    for (int w = 1; w < PACK_THREADS / 32; ++w) v[c] = fmin(v[c], red[c][w]);
  }
  // lo = v[0..2], hi = -v[3..5]
  if (t < b) {
    int key = 64;
    if (real) {
      const T sx = -v[3] - v[0], sy = -v[4] - v[1], sz = -v[5] - v[2];
      const T fx = sx > T(0) ? T(4) / sx : T(0);
      const T fy = sy > T(0) ? T(4) / sy : T(0);
      const T fz = sz > T(0) ? T(4) / sz : T(0);
      key = serpentine4(cell4(lx, v[0], fx), cell4(ly, v[1], fy),
                        cell4(lz, v[2], fz));
    }
    keys[t] = key;
  }
  __syncthreads();
  // the block's frame as a home block: the centre of its box, and the
  // largest distance of an atom staged about it, per dimension
  unsigned char* blk = a.packed + (size_t)j * (2 * b + 2) * 4 * sizeof(T);
  const T cx = T(0.5) * (v[0] - v[3]), cy = T(0.5) * (v[1] - v[4]),
          cz = T(0.5) * (v[2] - v[5]);
  T ext[3] = {T(0), T(0), T(0)};
  if (real) {
    T dx = a.x[3 * (size_t)id] - cx;
    T dy = a.x[3 * (size_t)id + 1] - cy;
    T dz = a.x[3 * (size_t)id + 2] - cz;
    img.apply(dx, dy, dz);
    ext[0] = fabs((cx + dx) - cx);
    ext[1] = fabs((cy + dy) - cy);
    ext[2] = fabs((cz + dz) - cz);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ext[c] = warp_max(ext[c]);
    if (lane == 0) red[c][warp] = ext[c];
  }
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      for (int w = 1; w < PACK_THREADS / 32; ++w) {
        ext[c] = fmax(ext[c], red[c][w]);
      }
    }
    T* fr = reinterpret_cast<T*>(blk + (size_t)2 * b * 4 * sizeof(T));
    fr[0] = cx;
    fr[1] = cy;
    fr[2] = cz;
    fr[3] = T(0);
    fr[4] = ext[0];
    fr[5] = ext[1];
    fr[6] = ext[2];
    fr[7] = T(0);
  }
  if (t < b) {
    const int key = keys[t];
    int rank = 0;
    for (int u = 0; u < b; ++u) {
      const int ku = keys[u];
      rank += (ku < key) | ((ku == key) & (u < t));
    }
    PosQ<T>* pq = reinterpret_cast<PosQ<T>*>(blk);
    ParI<T>* pr = reinterpret_cast<ParI<T>*>(blk + (size_t)b * sizeof(PosQ<T>));
    if (real) {
      pq[rank] = PosQ<T>{a.x[3 * (size_t)id], a.x[3 * (size_t)id + 1],
                         a.x[3 * (size_t)id + 2], a.q[id]};
      pr[rank] = ParI<T>{T(0.5) * a.sig[id], sqrt(a.eps[id]), id,
                         a.excbits[id]};
    } else {
      pq[rank] = PosQ<T>{T(0), T(0), T(0), T(0)};
      pr[rank] = ParI<T>{T(0), T(0), n, 0};
    }
  }

  // the last block to finish lists the work items
  if (t == 0) {
    a.counts[j] = count;
    __threadfence();
    last = atomicAdd(counters(a), 1) == a.nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int levels = (a.k + CHUNK - 1) / CHUNK;
  int* hist = build;                // [levels + 1] rows by chunk count
  int* cursor = hist + levels + 1;  // [levels + 1]
  int* above = cursor + levels + 1;  // [levels + 2]: rows with >= v chunks
  int* base = above + levels + 2;   // [levels + 1]: first item of level c
  for (int i = t; i <= levels; i += PACK_THREADS) {
    hist[i] = 0;
    cursor[i] = 0;
  }
  __syncthreads();
  for (int h = t; h < a.nb; h += PACK_THREADS) {
    atomicAdd(&hist[(__ldcg(a.counts + h) + CHUNK - 1) / CHUNK], 1);
  }
  __syncthreads();
  if (warp == 0) {
    // above[v] = rows with at least v chunks, from the top
    int carry = 0;
    for (int top = levels; top >= 0; top -= 32) {
      const int lv = top - lane;
      const int s = warp_inclusive_sum(lv >= 0 ? hist[lv] : 0);
      if (lv >= 0) above[lv] = s + carry;
      carry += __shfl_sync(hitqueue::FULL_WARP, s, 31);
    }
    if (lane == 0) above[levels + 1] = 0;
    __syncwarp();
    // level c holds above[c + 1] items, the rows with more than c chunks
    carry = 0;
    for (int c0 = 0; c0 <= levels; c0 += 32) {
      const int c = c0 + lane;
      const int live = c < levels ? above[c + 1] : 0;
      const int s = warp_inclusive_sum(live);
      if (c <= levels) base[c] = carry + s - live;
      carry += __shfl_sync(hitqueue::FULL_WARP, s, 31);
    }
  }
  __syncthreads();
  // level by level (the self chunks first: the nearest blocks cost most),
  // and in each level the rows by chunk count, longest first: a row of v
  // chunks takes a place among those of v after the above[v + 1] longer
  // ones, the same place at each of its levels
  for (int h = t; h < a.nb; h += PACK_THREADS) {
    const int nc = (__ldcg(a.counts + h) + CHUNK - 1) / CHUNK;
    if (nc == 0) continue;
    const int place = above[nc + 1] + atomicAdd(&cursor[nc], 1);
    for (int c = 0; c < nc; ++c) a.items[base[c] + place] = make_int2(h, c);
  }
  if (t == 0) a.counts[a.nb] = base[levels];
}

// --- K4 -------------------------------------------------------------------

//   inputs and outputs in Args (the file's note and the C entry points)
template <typename T, bool DAMPED, int EXC>
__global__ void __launch_bounds__(THREADS)
    block_pair_kernel(Args<T> a, Params<T> p) {
  constexpr int S = stages<T>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int b = a.b, n = a.n;
  const int groups = (b + GROUP - 1) / GROUP;
  // lanes a home atom in the reach test: a power of two, at most 8
  const int split = b * 8 <= THREADS ? 8 : b * 4 <= THREADS ? 4
                    : b * 2 <= THREADS ? 2 : 1;
  const Layout<T> lay(b);
  unsigned char* ring = smem_raw + lay.ring;
  Pos<T>* hpos = reinterpret_cast<Pos<T>*>(smem_raw + lay.hpos);
  Par<T>* hpar = reinterpret_cast<Par<T>*>(smem_raw + lay.hpar);
  // each warp's home sums [b][4], single writer
  T* hs = reinterpret_cast<T*>(smem_raw + lay.hs) + (size_t)warp * 4 * b;
  T* hs_all = reinterpret_cast<T*>(smem_raw + lay.hs);
  // the boxes of the item's candidate groups [CHUNK groups][6]
  T* gbox = reinterpret_cast<T*>(smem_raw + lay.gbox);
  unsigned* hexc = reinterpret_cast<unsigned*>(smem_raw + lay.hexc);
  unsigned* hfar = reinterpret_cast<unsigned*>(smem_raw + lay.hfar);
  // each warp's part of the list: its home atoms' (home, group) pairs
  unsigned short* wlist =
      reinterpret_cast<unsigned short*>(smem_raw + lay.list) +
      (size_t)warp * ((b + WARPS - 1) / WARPS) * CHUNK * groups;
  unsigned* queue = reinterpret_cast<unsigned*>(smem_raw + lay.queue) +
                    warp * hitqueue::DEPTH;
  unsigned* merged = reinterpret_cast<unsigned*>(smem_raw + lay.merged);
  int* meta = reinterpret_cast<int*>(smem_raw + lay.ints);  // [S]
  int* scan = meta + S;                                     // [WARPS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  const unsigned elem = (unsigned)lay.elem;

  const Image<T, false> img(a.box);
  const T rc = sqrt(p.rc2);
  const T rc2_wide = p.rc2 * T(1.0001);
  const T frame = T(0.5) - T(FRAME_MARGIN);
  const int nitems = a.counts[a.nb];
  int* work = counters(a) + 1;

  if (t == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s]);
    mbar_init_fence();
  }
  for (int i = t; i < WARPS * 4 * b; i += THREADS) hs_all[i] = T(0);

  // the producer, thread 0 alone: the item it issues from (home block h,
  // its n candidates c[0..n)), the next item, the record after it and one
  // more claimed index, and the blocks issued so far; each item's home
  // block goes before its candidates (meta ~(h | n << 24), then meta c)
  int cur_h = -1, cur_n = 0, pos_in_item = 0;
  int cur_c[CHUNK];
  int nxt_h = -1;
  int nxt_c[CHUNK];
  int2 pend = make_int2(-1, 0);
  int pend_idx = 0;
  unsigned produced = 0;
  // an item's record (home block, chunk) from the list, or none
  auto record = [&](int idx) {
    return idx < nitems ? a.items[idx] : make_int2(-1, 0);
  };
  // the item of record v: its home block, and its candidates' loads
  auto open_item = [&](int2 v) {
    nxt_h = v.x;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int e = v.y * CHUNK + i;
      nxt_c[i] = v.x >= 0 && e < a.k ? a.cand[(size_t)v.x * a.k + e] : -1;
    }
  };
  // Claims run three items ahead, each step used one item after its load
  // was issued, so that thread 0 never waits on them: the next item
  // becomes the current one, the pending record becomes the next item,
  // the claimed index's record is loaded, and one more index is claimed.
  auto advance = [&]() {
    cur_h = nxt_h;
    cur_n = 0;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      cur_c[i] = nxt_c[i];
      cur_n += nxt_c[i] >= 0;
    }
    pos_in_item = 0;
    open_item(pend);
    pend = record(pend_idx);
    pend_idx = pend_idx < nitems ? atomicAdd(work, 1) : nitems;
  };
  if (t == 0) {
    const int first = atomicAdd(work, 1);
    open_item(record(first));
    const int second = first < nitems ? atomicAdd(work, 1) : nitems;
    pend = record(second);
    pend_idx = second < nitems ? atomicAdd(work, 1) : nitems;
    advance();
  }
  unsigned consumed = 0;
  bool ended = false;
  auto fill = [&]() {
    while (!ended && produced - consumed < (unsigned)S) {
      const int s = (int)(produced % S);
      ++produced;
      if (cur_h < 0) {
        // no item left: the consumers find the end marker
        meta[s] = END;
        mbar_arrive(&bars[s]);
        ended = true;
        break;
      }
      int blk = cur_h;
      if (pos_in_item > 0) {
        blk = cur_c[0];
#pragma unroll
        for (int i = 0; i + 1 < CHUNK; ++i) cur_c[i] = cur_c[i + 1];
      }
      meta[s] = pos_in_item == 0 ? ~(blk | (cur_n << 24)) : blk;
      bulk_load(ring + (size_t)s * elem, a.packed + (size_t)blk * elem, elem,
                &bars[s]);
      if (++pos_in_item > cur_n) advance();
    }
  };

  // the frame (the home block's) and the home block
  T cx = T(0), cy = T(0), cz = T(0);
  bool fast = false;
  int home = -1;

  // the home rows of every warp, added up, to the output once
  auto flush_home = [&]() {
    if (t < b && home >= 0) {
      const int id = hpos[t].id;
      T row[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          row[c] += hs_all[(size_t)w * 4 * b + 4 * t + c];
          hs_all[(size_t)w * 4 * b + 4 * t + c] = T(0);
        }
      }
      if (id < n && (row[0] != T(0) || row[1] != T(0) || row[2] != T(0) ||
                     row[3] != T(0))) {
        add_row(a.out + (size_t)id * 4, row[0], row[1], row[2], row[3]);
      }
    }
  };

  // a landed home block: its frame (the pack kernel's rows after its
  // atoms), then its atoms staged in it, a thread an atom
  auto stage_home = [&](const unsigned char* st, int blk) {
    const PosQ<T>* pq = reinterpret_cast<const PosQ<T>*>(st);
    const ParI<T>* pr =
        reinterpret_cast<const ParI<T>*>(st + (size_t)b * sizeof(PosQ<T>));
    const T* fr = reinterpret_cast<const T*>(st + (size_t)2 * b * 4 * sizeof(T));
    cx = fr[0];
    cy = fr[1];
    cz = fr[2];
    fast = fr[4] + rc < frame * img.b[0] && fr[5] + rc < frame * img.b[1] &&
           fr[6] + rc < frame * img.b[2];
    if (t < b) {
      const PosQ<T> v = pq[t];
      const ParI<T> r = pr[t];
      if (r.id < n) {
        T dx = v.x - cx, dy = v.y - cy, dz = v.z - cz;
        img.apply(dx, dy, dz);
        hpos[t] = Pos<T>{cx + dx, cy + dy, cz + dz, r.id};
        hpar[t] = Par<T>{r.s, r.e, v.q};
        hexc[t] = (unsigned)r.bits;
        if (EXC == EXC_SPLIT) {
          const FarFilter f = far_filter(a.exc_far + (size_t)r.id * a.m, a.m);
          hfar[2 * t] = f.lo;
          hfar[2 * t + 1] = f.hi;
        }
      } else {
        hpos[t] = Pos<T>{cx, cy, cz, n};
        hexc[t] = 0u;
      }
    }
    home = blk;
  };

  int queued = 0;
  // the warp's (home atom, group) pairs tested, to the counters at the end
  unsigned tested = 0u;

  // The item's candidate blocks as one row of slots: block i's atoms at
  // slots i * span ... (span = its groups' 8 slots each), padding past b.
  static_assert(CHUNK >= 1 && CHUNK <= 2, "an item's blocks: one or two");
  const int span = groups * GROUP;
  Pos<T>* cpos0 = nullptr;
  Pos<T>* cpos1 = nullptr;
  Par<T>* cpar0 = nullptr;
  Par<T>* cpar1 = nullptr;

  // One popped hit per lane (code = home << 8 | slot, NO_HIT for a lane
  // without one): the pair form, the reaction straight to the candidate's
  // output row, and the home sums of each run of equal home atoms to its
  // first lane, in the warp's own rows.
  auto evaluate = [&](unsigned code) {
    const bool on = code != NO_HIT;
    const int hh = on ? (int)(code >> 8) : -1;
    T sx = T(0), sy = T(0), sz = T(0), se = T(0);
    int v = on ? (int)(code & 0xffu) : 0;
    const bool second = v >= span;
    if (second) v -= span;
    const Pos<T> hp = hpos[on ? hh : 0];
    const Pos<T> cj = (second ? cpos1 : cpos0)[v];
    // an excluded pair keeps its lane in its home atom's run, adding zeros
    bool live = on && !excluded_by_bits(hexc[hh], hp.id, cj.id);
    if (EXC == EXC_SPLIT && live) {
      live = !excluded_far(FarFilter{hfar[2 * hh], hfar[2 * hh + 1]},
                           a.exc_far + (size_t)hp.id * a.m, a.m, hp.id,
                           cj.id);
    }
    T dx = hp.x - cj.x;
    T dy = hp.y - cj.y;
    T dz = hp.z - cj.z;
    if (!fast) img.apply(dx, dy, dz);
    const T r2 = dx * dx + dy * dy + dz * dz;
    if (live) live = keeps_hit<T, false>(p, r2, a.x, a.box, hp.id, cj.id);
    if (live) {
      const Par<T> hq = hpar[hh];
      const Par<T> cq = (second ? cpar1 : cpar0)[v];
      T dudr2;
      // the packed columns hold sigma / 2 and sqrt(epsilon)
      pair_form<T, DAMPED>(p, r2, hq.q * cq.q, hq.s + cq.s, hq.e * cq.e, se,
                           dudr2);
      const T fm = T(2) * dudr2;
      const T gx = fm * dx, gy = fm * dy, gz = fm * dz;
      sx = -gx;
      sy = -gy;
      sz = -gz;
      // the reaction straight to the candidate's output row: reductions
      // in L2 that no thread waits on (summed in shared memory first, they
      // measured slower: k1_ab/k4_variants.py)
      T* row = a.out + (size_t)cj.id * 4;
      atomicAdd(row, gx);
      atomicAdd(row + 1, gy);
      atomicAdd(row + 2, gz);
    }

    // the runs' sums by doubling, until no run is longer than d
    for (int d = 1; d < 32; d <<= 1) {
      const int kk = __shfl_down_sync(hitqueue::FULL_WARP, hh, d);
      if (!__any_sync(hitqueue::FULL_WARP, on && lane + d < 32 && kk == hh)) {
        break;
      }
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

  // the item's landed candidate blocks (nc of them, cb0 and cb1): staged in
  // the frame (a thread a slot), their groups' boxes, the reach of each
  // warp's home atoms, its (home atom, group) pairs tested four at a time,
  // the hits evaluated
  auto sweep = [&](int nc, int cb0, int cb1) {
    const T big = T(1e30);
    for (int v0 = 0; v0 < CHUNK * span; v0 += THREADS) {
      const int sv = v0 + t;
      const bool second = sv >= span;
      const int v = second ? sv - span : sv;
      Pos<T>* cp = second ? cpos1 : cpos0;
      Par<T>* cq = second ? cpar1 : cpar0;
      bool real = false;
      Pos<T> pv{cx, cy, cz, n};
      if (v < b && (second ? 1 : 0) < nc) {
        const PosQ<T> pq = reinterpret_cast<const PosQ<T>*>(cp)[v];
        const ParI<T> pr = reinterpret_cast<const ParI<T>*>(cq)[v];
        real = pr.id < n;
        if (real) {
          T dx = pq.x - cx, dy = pq.y - cy, dz = pq.z - cz;
          img.apply(dx, dy, dz);
          pv = Pos<T>{cx + dx, cy + dy, cz + dz, pr.id};
        }
        cp[v] = pv;
        cq[v] = Par<T>{pr.s, pr.e, pq.q};
      }
      // the box of group sv / 8 over its 8 lanes
      T lx = real ? pv.x : big, ly = real ? pv.y : big, lz = real ? pv.z : big;
      T ux = real ? pv.x : -big, uy = real ? pv.y : -big,
        uz = real ? pv.z : -big;
#pragma unroll
      for (int d = 1; d < GROUP; d <<= 1) {
        lx = fmin(lx, __shfl_xor_sync(hitqueue::FULL_WARP, lx, d));
        ly = fmin(ly, __shfl_xor_sync(hitqueue::FULL_WARP, ly, d));
        lz = fmin(lz, __shfl_xor_sync(hitqueue::FULL_WARP, lz, d));
        ux = fmax(ux, __shfl_xor_sync(hitqueue::FULL_WARP, ux, d));
        uy = fmax(uy, __shfl_xor_sync(hitqueue::FULL_WARP, uy, d));
        uz = fmax(uz, __shfl_xor_sync(hitqueue::FULL_WARP, uz, d));
      }
      const unsigned any =
          (__ballot_sync(hitqueue::FULL_WARP, real) >> (lane & ~7)) & 0xffu;
      const int g = sv / GROUP;
      if ((lane & 7) == 0 && g < CHUNK * groups) {
        T* bg = gbox + 6 * g;
        bg[0] = any ? T(0.5) * (lx + ux) : T(0);
        bg[1] = any ? T(0.5) * (ly + uy) : T(0);
        bg[2] = any ? T(0.5) * (lz + uz) : T(0);
        bg[3] = any ? T(0.5) * (ux - lx) : T(-1);
        bg[4] = any ? T(0.5) * (uy - ly) : T(-1);
        bg[5] = any ? T(0.5) * (uz - lz) : T(-1);
      }
    }
    __syncthreads();

    // the reach of the warp's home atoms (w, w + WARPS, ...: each warp
    // owns an even share of the block), `split` adjacent lanes a home atom,
    // listed in the warp's own part of the list in home order
    const int ngroups = nc * groups;
    const int hh_r = warp + WARPS * (lane / split), part = lane % split;
    unsigned mask = 0u;
    if (hh_r < b) {
      const Pos<T> hp = hpos[hh_r];
      if (hp.id < n) {
        for (int g = part; g < ngroups; g += split) {
          const T* bg = gbox + 6 * g;
          if (bg[3] < T(0)) continue;
          T dx = hp.x - bg[0], dy = hp.y - bg[1], dz = hp.z - bg[2];
          if (!fast) img.apply(dx, dy, dz);
          const T gx = fmax(fabs(dx) - bg[3], T(0));
          const T gy = fmax(fabs(dy) - bg[4], T(0));
          const T gz = fmax(fabs(dz) - bg[5], T(0));
          if (gx * gx + gy * gy + gz * gz < rc2_wide) mask |= 1u << g;
        }
      }
    }
    for (int d = 1; d < split; d <<= 1) {
      mask |= __shfl_xor_sync(hitqueue::FULL_WARP, mask, d);
    }
    if (part != 0 || hh_r >= b) mask = 0u;
    const int count = __popc(mask);
    const int incl = warp_inclusive_sum(count);
    const int total = __shfl_sync(hitqueue::FULL_WARP, incl, 31);
    tested += (unsigned)total;
    int at = incl - count;
    while (mask != 0u) {
      const int g = __ffs(mask) - 1;
      mask &= mask - 1u;
      wlist[at++] = (unsigned short)((hh_r << 5) | g);
    }
    __syncwarp();

    // the warp's list, four pairs a round, 8 lanes a pair; in the self
    // block each pair once, the candidate behind the home atom
    const bool self0 = cb0 == home, self1 = nc > 1 && cb1 == home;
    for (int e0 = 0; e0 < total; e0 += 32 / GROUP) {
      const int e = e0 + lane / GROUP;
      bool hit = false;
      unsigned code = 0u;
      if (e < total) {
        const unsigned c = wlist[e];
        const int hh = (int)(c >> 5);
        const int sv = (int)((c & 31u) * GROUP) + (lane & (GROUP - 1));
        const bool second = sv >= span;
        const int v = second ? sv - span : sv;
        if (v < b) {
          const Pos<T> hp = hpos[hh];
          const Pos<T> cj = (second ? cpos1 : cpos0)[v];
          T dx = hp.x - cj.x;
          T dy = hp.y - cj.y;
          T dz = hp.z - cj.z;
          if (!fast) img.apply(dx, dy, dz);
          const T r2 = dx * dx + dy * dy + dz * dz;
          // the exclusions are tested at the evaluation, on the few pairs
          // in range
          const bool self = second ? self1 : self0;
          hit = (cj.id < n) & (r2 < p.rc2_hi) & (!self | (v > hh));
          code = ((unsigned)hh << 8) | (unsigned)sv;
        }
      }
      const int slot = hitqueue::reserve(hit, queued);
      if (hit) queue[slot] = code;
      __syncwarp();
      if (queued >= 32) {
        queued -= 32;
        const unsigned cd = queue[queued + lane];
        __syncwarp();
        evaluate(cd);
      }
    }
    // the warps' leftover hits, in warp order (a home atom's hits come
    // from its one warp, so they stay together), evaluated 32 at a time, a
    // batch a warp; the loop's next barrier closes the item
    if (lane == 0) scan[warp] = queued;
    __syncthreads();
    int off = 0, left = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? scan[w] : 0;
      left += scan[w];
    }
    for (int i = lane; i < queued; i += 32) merged[off + i] = queue[i];
    queued = 0;
    __syncthreads();
    for (int m0 = 32 * warp; m0 < left; m0 += 32 * WARPS) {
      evaluate(m0 + lane < left ? merged[m0 + lane] : NO_HIT);
    }
  };

  // the consumer, every thread: an item a turn, its home block and its
  // candidates as they land; their buffers go back to the producer once
  // every thread is done with them
  unsigned phase = 0u;
  auto landed = [&]() {
    const int s = (int)(consumed % S);
    mbar_wait(&bars[s], (phase >> s) & 1u);
    phase ^= 1u << s;
    ++consumed;
    return s;
  };
  for (;;) {
    fence_proxy_async();
    __syncthreads();
    if (t == 0) fill();
    __syncthreads();
    const int sh = landed();
    const int mt = meta[sh];
    if (mt == END) break;
    const int nc = (~mt) >> 24;
    flush_home();
    stage_home(ring + (size_t)sh * elem, (~mt) & 0xffffff);
    const int s0 = landed();
    const int cb0 = meta[s0];
    cpos0 = reinterpret_cast<Pos<T>*>(ring + (size_t)s0 * elem);
    cpar0 = reinterpret_cast<Par<T>*>(ring + (size_t)s0 * elem +
                                      (size_t)b * sizeof(PosQ<T>));
    int cb1 = -1;
    if (nc > 1) {
      const int s1 = landed();
      cb1 = meta[s1];
      cpos1 = reinterpret_cast<Pos<T>*>(ring + (size_t)s1 * elem);
      cpar1 = reinterpret_cast<Par<T>*>(ring + (size_t)s1 * elem +
                                        (size_t)b * sizeof(PosQ<T>));
    } else {
      cpos1 = cpos0;
      cpar1 = cpar0;
    }
    sweep(nc, cb0, cb1);
  }
  flush_home();
  if (lane == 0 && tested != 0u) {
    atomicAdd(reinterpret_cast<unsigned*>(counters(a)) + 2, tested);
  }
}

// the item builder's shared arrays (the pack kernel's dynamic memory)
int pack_smem(int k) {
  const int levels = (k + CHUNK - 1) / CHUNK;
  return (4 * levels + 5) * (int)sizeof(int);
}

template <typename T, bool DAMPED, int EXC>
int run(const Args<T>& args, const Params<T>& p, cudaStream_t st) {
  auto kernel = block_pair_kernel<T, DAMPED, EXC>;
  const size_t smem = Layout<T>(args.b).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess) {
    return (int)err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = sms * per_sm;
  kernel<<<grid, THREADS, smem, st>>>(args, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* q, const T* sig, const T* eps,
           const int* excbits, const int* exc_far, const int* order,
           const int* cand, const T* box, int n, int nb, int b, int k, int m,
           const double* scal, const int* flags, T* out, void* packed,
           int* work, void* stream) {
  if (b < 1 || b > MAX_B || nb < 1 || k < 1 || n < 1 || m < 0 ||
      (exc_far != nullptr) != (m > 0) ||
      !flags_valid(flags)) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> args{x, q, sig, eps, excbits, exc_far, order, cand, box, n, nb,
               b, k, m, out, static_cast<unsigned char*>(packed),
               reinterpret_cast<int2*>(work),
               work + (size_t)2 * nb * k};
  const Params<T> p = make_params<T>(scal, flags);
  cudaStream_t st = (cudaStream_t)stream;
  const int psmem = pack_smem(k);
  if (psmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_pair_pack_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, psmem);
    if (err != cudaSuccess) return (int)err;
  }
  block_pair_pack_kernel<T><<<nb, PACK_THREADS, psmem, st>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (damped(p)) {
    return exc_far != nullptr ? run<T, true, EXC_SPLIT>(args, p, st)
                              : run<T, true, EXC_BITS>(args, p, st);
  }
  return exc_far != nullptr ? run<T, false, EXC_SPLIT>(args, p, st)
                            : run<T, false, EXC_BITS>(args, p, st);
}

}  // namespace

// Plain C entry points, bound with ctypes: the pack kernel, then K4, on
// `stream`. `scal` and `flags` are host arrays (pair_forms.cuh::
// make_params); 1 <= b <= 128; exc_far is null (m = 0) for the bitmask
// form. `out` is (n + 2, 4) and must hold zeros (or sums to add to in its
// first n + 1 rows, and zeros in the last, which holds the sweep's two
// counters); `packed` is scratch of nb * 2 * b * 4 values of the working
// type, `work` scratch of 2 nb k + nb + 1 ints. The last row's first three
// ints count the pack kernel's finished blocks, the items claimed and the
// (home atom, 8-atom group) pairs K4 tested. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int block_pair_f32(const float* x, const float* q, const float* sig,
                              const float* eps, const int* excbits,
                              const int* exc_far, const int* order,
                              const int* cand, const float* box, int n,
                              int nb, int b, int k, int m, const double* scal,
                              const int* flags, float* out, void* packed,
                              int* work, void* stream) {
  return launch<float>(x, q, sig, eps, excbits, exc_far, order, cand, box, n,
                       nb, b, k, m, scal, flags, out, packed, work, stream);
}

extern "C" int block_pair_f64(const double* x, const double* q,
                              const double* sig, const double* eps,
                              const int* excbits, const int* exc_far,
                              const int* order, const int* cand,
                              const double* box, int n, int nb, int b, int k,
                              int m, const double* scal, const int* flags,
                              double* out, void* packed, int* work,
                              void* stream) {
  return launch<double>(x, q, sig, eps, excbits, exc_far, order, cand, box, n,
                        nb, b, k, m, scal, flags, out, packed, work, stream);
}
