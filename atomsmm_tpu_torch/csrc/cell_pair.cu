// Full-stencil cell-pair sweep for Hopper (sm_90a), without Newton.
//
// Replaces atomsmm_tpu/ops/pallas_pair.py::_pair_kernel. It runs where the
// cell grid is too small for half-stencil maps (a dimension below
// 2 * reach + 1): small solvated boxes, down to one cell. Each home cell c
// meets every deduplicated stencil cell nbr[c, s] (-1 padded), both
// orderings of each pair: on every (home atom, candidate) slot it applies the
// per-slot minimum image, the cutoff test, the exclusions and one of the
// built-in pair forms (pair_forms.cuh), and sums on the home atom
// F_i = -sum 2 du/dr^2 dx and E_i = 1/2 sum u. It writes no reactions, so it
// needs no atomics.
//
// What bounds it: the pair-slot arithmetic, as in half_pair.cu, on twice
// the slots (no Newton). Cell capacities reach past 1,024 atoms here (216
// waters at a 0.9 nm cutoff fill one cell of 1,112 slots; 71 KB of staged
// candidates in float64), so nothing assumes one thread per home atom of a
// whole cell or one whole cell in shared memory. One thread block per
// (home cell, candidate tile, home chunk): TILE = 128 threads, one home atom
// of the chunk per thread with its sums and exclusion columns in registers,
// against one tile of up to TILE candidates of one stencil cell, staged in
// static shared memory (6.5 KB in float64). The grid then has enough blocks
// to fill the card even for one cell (9 x 9 blocks at cap 1,112). Each block
// writes its own partial sums; the wrapper (ops/pair_kernel.py) adds the
// tiles of a home cell, a sum over a fixed axis, so the result does not
// depend on the order in which blocks run.
//
// Padding columns of nbr (-1) stand for the sentinel cell, whose slots are
// all masked: their tiles are skipped. Exclusions: the relative-offset
// bitmask when the system has one, else the id columns (the template
// parameter COLS), as in half_pair.cu; the CPU tests show that both forms
// give the same mask.
//
// The plain PyTorch twin of this file is ops/pair_kernel.py::full_pair_plain.

#include "pair_forms.cuh"

namespace {

using namespace pairforms;

constexpr int TILE = 128;

// blockIdx.x = c * n_tiles + tile, tile = s * tiles_per_cell + piece;
// blockIdx.y = home chunk.
//   hf  (ncells, cap, 8) [x y z q sigma eps 0 0]; padding slots read zeros
//   hm  (ncells, cap, 2) [atom id (n = padding), exclusion bits]
//   hx  (ncells, cap, m) exclusion id columns, read only when COLS
//   nbr (ncells, s) stencil cells, -1 padded
//   out (ncells, n_tiles, cap, 4) per home atom and tile [fx fy fz e/2]
template <typename T, bool COLS>
__global__ void __launch_bounds__(TILE)
cell_pair_kernel(const T* __restrict__ hf, const int* __restrict__ hm,
                 const int* __restrict__ hx, const int* __restrict__ nbr,
                 const T* __restrict__ box, int cap, int s, int tiles_per_cell,
                 int n, int m, Params<T> p, T* __restrict__ out) {
  __shared__ T sx[TILE], sy[TILE], sz[TILE], sq[TILE], ss[TILE], se[TILE];
  __shared__ int sid[TILE];

  const int n_tiles = s * tiles_per_cell;
  const int c = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - c * n_tiles;
  const int sc = tile / tiles_per_cell;
  const int j0 = (tile - sc * tiles_per_cell) * TILE;
  const int jn = min(TILE, cap - j0);
  const int nc = nbr[c * s + sc];
  const int t = threadIdx.x;
  const int hi = blockIdx.y * TILE + t;

  if (nc >= 0 && t < jn) {
    const T* f = hf + ((size_t)nc * cap + j0 + t) * 8;
    sx[t] = f[0];
    sy[t] = f[1];
    sz[t] = f[2];
    sq[t] = f[3];
    ss[t] = f[4];
    se[t] = f[5];
    sid[t] = hm[((size_t)nc * cap + j0 + t) * 2];
  }

  const bool active = hi < cap;
  T xi = T(0), yi = T(0), zi = T(0), qi = T(0), si = T(0), ei = T(0);
  int oid_h = n;
  unsigned exc_h = 0u;
  ExcCols cols;
  if (active) {
    const T* f = hf + ((size_t)c * cap + hi) * 8;
    xi = f[0];
    yi = f[1];
    zi = f[2];
    qi = f[3];
    si = f[4];
    ei = f[5];
    oid_h = hm[((size_t)c * cap + hi) * 2];
    exc_h = (unsigned)hm[((size_t)c * cap + hi) * 2 + 1];
  }
  if (COLS) load_exc_cols(active ? hx + ((size_t)c * cap + hi) * m : nullptr,
                          m, cols);
  __syncthreads();

  const T bx = box[0], by = box[1], bz = box[2];
  const T ibx = T(1) / bx, iby = T(1) / by, ibz = T(1) / bz;
  T fx = T(0), fy = T(0), fz = T(0), e = T(0);

  if (nc >= 0 && active && oid_h < n) {
    for (int j = 0; j < jn; ++j) {
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
        pair_form(p, r2, qq, sig, eps, u, dudr2);
        const T fm = T(2) * dudr2;
        fx -= fm * dx;
        fy -= fm * dy;
        fz -= fm * dz;
        e += u;
      }
    }
  }

  if (active) {
    T* o = out + (((size_t)c * n_tiles + tile) * cap + hi) * 4;
    o[0] = fx;
    o[1] = fy;
    o[2] = fz;
    o[3] = T(0.5) * e;
  }
}

template <typename T>
int launch(const T* hf, const int* hm, const int* hx, const int* nbr,
           const T* box, int ncells, int cap, int s, int n, int m,
           const double* scal, const int* flags, T* out, void* stream) {
  if (cap < 1 || ncells < 1 || s < 1 || m < 0 || m > MAX_EXC ||
      (hx != nullptr && m < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_per_cell = (cap + TILE - 1) / TILE;
  const long long bx = (long long)ncells * s * tiles_per_cell;
  if (bx > 0x7fffffffLL || tiles_per_cell > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Params<T> p = make_params<T>(scal, flags);
  const dim3 grid((unsigned)bx, (unsigned)tiles_per_cell);
  cudaStream_t st = (cudaStream_t)stream;
  if (hx != nullptr) {
    cell_pair_kernel<T, true><<<grid, TILE, 0, st>>>(
        hf, hm, hx, nbr, box, cap, s, tiles_per_cell, n, m, p, out);
  } else {
    cell_pair_kernel<T, false><<<grid, TILE, 0, st>>>(
        hf, hm, hx, nbr, box, cap, s, tiles_per_cell, n, 0, p, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. `scal` and `flags` are host
// arrays (pair_forms.cuh::make_params); `hx` is null for the bitmask form,
// else the (ncells, cap, m) exclusion id columns, 1 <= m <= 16. `out` holds
// (ncells, s * ceil(cap / 128), cap, 4). Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int cell_pair_f32(const float* hf, const int* hm, const int* hx,
                             const int* nbr, const float* box, int ncells,
                             int cap, int s, int n, int m, const double* scal,
                             const int* flags, float* out, void* stream) {
  return launch<float>(hf, hm, hx, nbr, box, ncells, cap, s, n, m, scal, flags,
                       out, stream);
}

extern "C" int cell_pair_f64(const double* hf, const int* hm, const int* hx,
                             const int* nbr, const double* box, int ncells,
                             int cap, int s, int n, int m, const double* scal,
                             const int* flags, double* out, void* stream) {
  return launch<double>(hf, hm, hx, nbr, box, ncells, cap, s, n, m, scal,
                        flags, out, stream);
}
