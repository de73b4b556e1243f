// Built-in pair forms shared by the pair kernels (half_pair.cu,
// cell_pair.cu, tile_pair.cu, block_pair.cu): the kernels' scalar block,
// the float32 cutoff band, the quintic switch and (u, du/dr^2) of one pair.
//
// Each kernel takes one of the built-in forms, selected by flags, with
// host-computed f64 scalars (ops/pairfuncs.py::PairForm): the full form
// (switched LJ + reaction-field or Ewald direct-space Coulomb, or the damped
// Coulomb smoothed by the switch), the RESPA near form (shifted-force LJ +
// Coulomb, damped by erfc(alpha r) under PME), the fused far form (full
// minus near), and Beutler softcore LJ with its lambda derivative (the
// alchemical decoupling of a solute). A softcore form reads the solute
// indicator through the charge product: its force puts 2 solute - 1 (+-1)
// in the charge column, so qq = -1 marks a solute-solvent pair and
// cross = (1 - qq) / 2. The damped forms use CUDA's
// own erfcf/erfc and expf/exp, once per slot, shared by both halves of the
// far form; whether a form is damped is a template parameter (DAMPED, from
// alpha != 0 at launch), so the undamped forms carry no erfc code. Under
// the virial flag (any form but the dlambda one) pair_form returns the
// pair's virial w = -2 r^2 du/dr^2 = d . F in place of u, and the force is
// unchanged: the energy column then sums to W = -dU(s x, s box)/ds at
// s = 1. A kernel given a type-pair table (the TABLE instantiations: NBFIX
// force fields, and those with the legacy 10-12 term) reads each pair's
// (sig, eps, A, B) row from it (load_pair_row) instead of combining by
// Lorentz-Berthelot; under the hbond flag, A/r^12 - B/r^10 joins the full
// half's LJ term before the switch. The Lorentz-Berthelot instantiations
// (TABLE = false) carry no table code. The plain PyTorch twin of
// pair_form is ops/pairfuncs.py::form_u_dudr2, line for line.
//
// K1 and K2 take a user pair function too (CustomNonbondedForce): its form
// axis U is BuiltIn for the forms above, or the struct UserPair that
// ops/pairtrace.py generates from the traced function and _build.py
// compiles into a library of its own (user_pair below). A user form stages
// up to five per-atom columns (Cols) where a built-in form stages (q,
// sigma, epsilon), reads its runtime constants (the force's globals and
// captured scalars) from a device array once per thread, and keeps the
// slot test, the cutoff band, the exclusions, the images and the virial
// flag of the built-in forms.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pairforms {

constexpr double ONE_4PI_EPS0 = 138.935456;
constexpr double TWO_OVER_SQRT_PI = 1.1283791670955126;
constexpr int EXC_OFF = 16;  // exclusion bit of relative offset 0 (self)
constexpr double ALPHA_SC = 0.5;  // softcore alpha (pairfuncs.py::ALPHA_SC)

// The half-width of the band about the cutoff, relative to r_cut^2, in
// which a float32 hit is decided again in float64 (keeps_hit).
constexpr double CUT_BAND = 1.0 / 16384.0;

template <typename T>
struct Params {
  T rc2;       // mask cutoff squared
  T rc2_lo;    // r_cut^2 (1 - CUT_BAND): below it a hit is in range
  T rc2_hi;    // r_cut^2 (1 + CUT_BAND): the slot test's threshold
  double rc2_exact;  // r_cut^2 in float64, the reference's threshold
  T sw_rs;     // full form: switch start
  T sw_inv_w;  // full form: 1 / (r_cut - r_switch)
  T k_rf;      // reaction field
  T c_rf;
  T n_rs;      // near form: switch start
  T n_inv_w;   // near form: 1 / (rc_in - rs_in)
  T n_rc;      // near form: cutoff
  T n_rcinv;   // near form: 1 / cutoff
  T near_sign; // +1 near force, -1 inside the fused far force
  T alpha;     // damping of c(r) = erfc(alpha r)/r (0: c = 1/r)
  T n_ec;      // near form: c(n_rc)
  T n_dec;     // near form: c'(n_rc)
  T lamb;      // softcore: lambda
  int has_full;
  int use_switch;
  int has_near;
  int ewald;    // full form's Coulomb: k qq c(r) (PME direct), else RF
  int softcore; // Beutler softcore LJ (undamped instantiation only)
  int dlambda;  // softcore: d u / d lambda in place of u, no force
  int smoothed; // full form: the switch multiplies the Coulomb too
  int hbond;    // full half: + A/r^12 - B/r^10 (TABLE instantiations only)
  int virial;   // -2 r^2 du/dr^2 in place of u, force unchanged
};

// The kernels' C entry points all take the same host arrays:
// scal = [rc2, sw_rs, sw_inv_w, k_rf, c_rf, n_rs, n_inv_w, n_rc, n_rcinv,
// near_sign, alpha, n_ec, n_dec, lamb, rc2 in float64], flags = [has_full,
// use_switch, has_near, ewald, softcore, dlambda, smoothed, hbond, virial].
template <typename T>
inline Params<T> make_params(const double* scal, const int* flags) {
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
  p.alpha = (T)scal[10];
  p.n_ec = (T)scal[11];
  p.n_dec = (T)scal[12];
  p.lamb = (T)scal[13];
  p.rc2_exact = scal[14];
  p.rc2_lo = (T)(scal[14] * (1.0 - CUT_BAND));
  p.rc2_hi = (T)(scal[14] * (1.0 + CUT_BAND));
  if (sizeof(T) == sizeof(double)) p.rc2_lo = p.rc2_hi = p.rc2;
  p.has_full = flags[0];
  p.use_switch = flags[1];
  p.has_near = flags[2];
  p.ewald = flags[3];
  p.softcore = flags[4];
  p.dlambda = flags[5];
  p.smoothed = flags[6];
  p.hbond = flags[7];
  p.virial = flags[8];
  return p;
}

// The replica axis of a launch (grid dimension y, one row per replica or
// lambda state): the element strides between consecutive rows of each
// per-row input (0: every row reads the same array, as the lambda states
// of one configuration share x and the bucket) and, where the rows' forms
// differ in their softcore lambda, a device table of the rows' lambdas,
// (K,) in the working type, which replaces the host block's lambda row by
// row. Every other scalar and every flag is the host block's: the rows of
// a launch share their form. Each row writes its own (n + 1, 4) slice of
// the output. A user form's rows read their column block and their
// runtime constants at the row's strides too: row k of a (K, C) table of
// constants plays the part of a built-in form's row lambda.
template <typename T>
struct Rows {
  long long x, q, sig, eps, types, bucket, box;
  const T* lamb;  // (K,) on the device, or null
  // a user form's (n + 1, P) column block and (C,) runtime constants: the
  // row's own constants are the built-in forms' row lambda
  long long cols = 0, consts = 0;
};

// The host-side checks of a launch's rows: 1..65,535 rows (the grid's y
// limit) and no negative stride.
template <typename T>
inline bool rows_valid(int k_rows, const Rows<T>& r) {
  return k_rows >= 1 && k_rows <= 65535 && r.x >= 0 && r.q >= 0 &&
         r.sig >= 0 && r.eps >= 0 && r.types >= 0 && r.bucket >= 0 &&
         r.box >= 0 && r.cols >= 0 && r.consts >= 0;
}

// Row `row`'s parameter block: p, its lambda read from the table where
// there is one. A lambda of the working type is the value that
// make_params casts from the host block's double, so a row equals a
// single-row launch whose host block holds the same lambda; every other
// field stays the kernel parameter's.
template <typename T>
__device__ __forceinline__ Params<T> row_params(const Params<T>& p,
                                                const Rows<T>& rows, int row) {
  Params<T> r = p;
  if (rows.lamb != nullptr) r.lamb = rows.lamb[row];
  return r;
}

// A flag block the kernels take: the virial flag replaces u, which the
// dlambda flag has already replaced, so the two together are refused; the
// 10-12 term reads its coefficients from the table, so hbond without one
// is refused.
inline bool flags_valid(const int* flags, bool has_table = false) {
  return !(flags[5] && flags[8]) && !(flags[7] && !has_table);
}

// One row of a (ntypes, ntypes, 4) type-pair table: the pair's sigma,
// epsilon and 10-12 coefficients A, B. The table stays in global memory
// and is read through the read-only cache: T^2 x 4 values, a few KB for
// the tens of types real force fields have.
template <typename T>
struct PairRow {
  T sig, eps, a, b;
};

template <typename T>
__device__ __forceinline__ PairRow<T> load_pair_row(const T* __restrict__ table,
                                                    int ntypes, int ti,
                                                    int tj) {
  const T* row = table + 4 * ((size_t)ti * ntypes + tj);
  return PairRow<T>{__ldg(row), __ldg(row + 1), __ldg(row + 2),
                    __ldg(row + 3)};
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return 1.0 / sqrt(x); }
__device__ __forceinline__ float erfc_t(float x) { return erfcf(x); }
__device__ __forceinline__ double erfc_t(double x) { return erfc(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// Round half to even, as torch.round and jnp.round do, by two additions on
// the float pipes, not rint's conversion unit: adding and subtracting
// 1.5 * 2^23 (1.5 * 2^52 in float64) rounds exactly as rint does for
// |v| < 2^22 (2^51).
__device__ __forceinline__ float round_even(float v) {
  return __fsub_rn(__fadd_rn(v, 12582912.0f), 12582912.0f);
}
__device__ __forceinline__ double round_even(double v) {
  return __dsub_rn(__dadd_rn(v, 6755399441055744.0), 6755399441055744.0);
}

// Minimum image of one displacement component of an orthorhombic box.
__device__ __forceinline__ float min_image(float d, float b, float ib) {
  return d - b * round_even(d * ib);
}
__device__ __forceinline__ double min_image(double d, double b, double ib) {
  return d - b * round_even(d * ib);
}

// The minimum image of a pair's displacement, from a kernel's box
// argument. TRI = false: the (3,) edge lengths, each component rounded on
// its own (min_image). TRI = true: the (3, 3) cell matrix H (rows = lattice
// vectors), 9 values, row-major, whose inverse each thread forms once from
// the adjugate; the image rounds in fractional coordinates,
// d - round(d inv(H)) H, as ops/pbc.py::minimum_image does (exact for a
// reduced cell while the cutoff is at most half its smallest perpendicular
// width). The inverse here and torch.linalg.inv's differ in the last
// bits, which moves a displacement by as much.
template <typename T, bool TRI>
struct Image;

template <typename T>
struct Image<T, false> {
  T b[3], ib[3];
  template <typename S>
  __device__ explicit Image(const S* __restrict__ box) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b[k] = (T)box[k];
      ib[k] = T(1) / b[k];
    }
  }
  __device__ __forceinline__ void apply(T& dx, T& dy, T& dz) const {
    dx = min_image(dx, b[0], ib[0]);
    dy = min_image(dy, b[1], ib[1]);
    dz = min_image(dz, b[2], ib[2]);
  }
};

template <typename T>
struct Image<T, true> {
  T h[9], hi[9];
  template <typename S>
  __device__ explicit Image(const S* __restrict__ box) {
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = (T)box[k];
    hi[0] = h[4] * h[8] - h[5] * h[7];
    hi[1] = h[2] * h[7] - h[1] * h[8];
    hi[2] = h[1] * h[5] - h[2] * h[4];
    hi[3] = h[5] * h[6] - h[3] * h[8];
    hi[4] = h[0] * h[8] - h[2] * h[6];
    hi[5] = h[2] * h[3] - h[0] * h[5];
    hi[6] = h[3] * h[7] - h[4] * h[6];
    hi[7] = h[1] * h[6] - h[0] * h[7];
    hi[8] = h[0] * h[4] - h[1] * h[3];
    const T idet = T(1) / (h[0] * hi[0] + h[1] * hi[3] + h[2] * hi[6]);
#pragma unroll
    for (int k = 0; k < 9; ++k) hi[k] *= idet;
  }
  __device__ __forceinline__ void apply(T& dx, T& dy, T& dz) const {
    const T s0 = round_even(dx * hi[0] + dy * hi[3] + dz * hi[6]);
    const T s1 = round_even(dx * hi[1] + dy * hi[4] + dz * hi[7]);
    const T s2 = round_even(dx * hi[2] + dy * hi[5] + dz * hi[8]);
    dx -= s0 * h[0] + s1 * h[3] + s2 * h[6];
    dy -= s0 * h[1] + s1 * h[4] + s2 * h[7];
    dz -= s0 * h[2] + s1 * h[5] + s2 * h[8];
  }
};

// The cutoff test, decided as the float64 reference decides it. A float32
// r2 carries the rounding of the coordinates' difference, of the image
// shift and of a staged frame, up to about ulp(L) per component for
// coordinates of size L, so a pair within that of r_cut could fall on
// either side of it. The truncated Ewald force jumps there by k |qq|
// [erfc(a rc)/rc^2 + (2a / sqrt(pi)) exp(-a^2 rc^2)/rc] (0.38 kJ/mol/nm for
// an O-O pair of TIP3P at 0.9 nm and a = 2.92/nm), more than 1e-4 of the
// largest force. So the slot test takes r2 < rc2_hi, and a hit whose r2
// lies in the band [rc2_lo, rc2_hi), CUT_BAND of r_cut^2 either side (2^-14
// relative: more than that rounding for coordinates below about 60 nm at a
// 0.9 nm cutoff), is kept only where within_cutoff_f64 says so: the
// displacement again in float64 from the stored float32 coordinates of
// both atoms, by the minimum image ops/pbc.py takes, against r_cut^2 in
// float64. The band holds a few thousand of the 10^8 slots of a 30k-atom
// sweep, and the test is made on hits only, outside the slot loop. In
// float64 rc2_lo = rc2_hi = rc2 and every hit is kept.
template <typename T, bool TRI>
__device__ __noinline__ bool within_cutoff_f64(double rc2,
                                               const T* __restrict__ x,
                                               const T* __restrict__ box,
                                               int i, int j) {
  const Image<double, TRI> img(box);
  double dx = (double)x[3 * (size_t)i] - (double)x[3 * (size_t)j];
  double dy = (double)x[3 * (size_t)i + 1] - (double)x[3 * (size_t)j + 1];
  double dz = (double)x[3 * (size_t)i + 2] - (double)x[3 * (size_t)j + 2];
  img.apply(dx, dy, dz);
  return dx * dx + dy * dy + dz * dz < rc2;
}

template <typename T, bool TRI>
__device__ __forceinline__ bool keeps_hit(const Params<T>& p, T r2,
                                          const T* __restrict__ x,
                                          const T* __restrict__ box, int i,
                                          int j) {
  if (sizeof(T) == sizeof(double) || r2 < p.rc2_lo) return true;
  return within_cutoff_f64<T, TRI>(p.rc2_exact, x, box, i, j);
}

// Relative-offset exclusion bitmask: bit (cid - hid + 16) of the home atom's
// bits, clamped to [0, 31] (offsets beyond +-14 are never set).
__device__ __forceinline__ bool excluded_by_bits(unsigned exc_h, int hid,
                                                 int cid) {
  int off = cid - hid + EXC_OFF;
  off = off < 0 ? 0 : (off > 31 ? 31 : off);
  return ((exc_h >> off) & 1u) != 0u;
}

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
// charge product, (sig, eps) the pair parameters (combined, or the table's
// row) and (a1012, b1012) the row's 10-12 coefficients, read only by a
// TABLE instantiation under the hbond flag; DAMPED must equal
// p.alpha != 0.
template <typename T, bool DAMPED, bool TABLE = false>
__device__ __forceinline__ void pair_form_energy(const Params<T>& p, T r2,
                                                 T qq, T sig, T eps, T& u,
                                                 T& dudr2, T a1012 = T(0),
                                                 T b1012 = T(0)) {
  const T kc = T(ONE_4PI_EPS0);
  T rinv = rsqrt_t(r2);
  T r = r2 * rinv;
  T rinv2 = rinv * rinv;
  u = T(0);
  dudr2 = T(0);
  if (!DAMPED && p.softcore) {
    // Beutler softcore LJ: 4 eps lambda inv (inv - 1) S(r) cross with
    // inv = 1 / (ALPHA_SC (1 - lambda) + (r / sig)^6)
    const T cross = T(0.5) * (T(1) - qq);
    T sw = T(1), dsw = T(0);
    if (p.use_switch) {
      T ds_dx;
      switch_quintic((r - p.sw_rs) * p.sw_inv_w, sw, ds_dx);
      dsw = ds_dx * p.sw_inv_w * T(0.5) * rinv;
    }
    const T isig2 = T(1) / (sig * sig);
    const T t = r2 * isig2;
    const T inv = T(1) / (T(ALPHA_SC) * (T(1) - p.lamb) + t * t * t);
    const T c4 = T(4) * eps * cross;
    if (p.dlambda) {
      u = c4 *
          (inv * (inv - T(1)) +
           p.lamb * T(ALPHA_SC) * inv * inv * (T(2) * inv - T(1))) *
          sw;
      return;
    }
    const T usc = c4 * p.lamb * inv * (inv - T(1));
    const T dusc =
        c4 * p.lamb * inv * inv * (T(1) - T(2) * inv) * T(3) * t * t * isig2;
    u = usc * sw;
    dudr2 = dusc * sw + usc * dsw;
    return;
  }
  // Coulomb kernel c(r) = erfc(alpha r)/r and dc/dr, shared by both halves
  T ec = rinv, dec = -rinv2;
  if (DAMPED) {
    T ar = p.alpha * r;
    ec = erfc_t(ar) * rinv;
    dec = -(ec + T(TWO_OVER_SQRT_PI) * p.alpha * exp_t(-ar * ar)) * rinv;
  }
  T cq = kc * qq;
  if (p.has_full) {
    // switched LJ + reaction-field or Ewald direct-space Coulomb
    T t = sig * rinv;
    T t2 = t * t;
    T s6 = t2 * t2 * t2;
    T ulj = T(4) * eps * s6 * (s6 - T(1));
    T dulj = T(-12) * eps * s6 * (T(2) * s6 - T(1)) * rinv2;
    if (TABLE && p.hbond) {
      // A/r^12 - B/r^10 and its -6A/r^14 + 5B/r^12, inside the switch
      T inv10 = rinv2 * rinv2;
      inv10 = inv10 * inv10 * rinv2;
      ulj = ulj + (a1012 * rinv2 - b1012) * inv10;
      dulj = dulj + (T(5) * b1012 - T(6) * a1012 * rinv2) * inv10 * rinv2;
    }
    T sw = T(1), dsw = T(0);
    if (p.use_switch) {
      T ds_dx;
      switch_quintic((r - p.sw_rs) * p.sw_inv_w, sw, ds_dx);
      dsw = ds_dx * p.sw_inv_w * T(0.5) * rinv;
    }
    // the branches keep their own sums: merged, nvcc schedules the
    // reaction-field arithmetic differently and its float32 rounding moves
    if (p.smoothed) {
      // the (damped) Coulomb inside the switch, no shift
      T uc = cq * ec;
      T duc = cq * dec * T(0.5) * rinv;
      u += (ulj + uc) * sw;
      dudr2 += (dulj + duc) * sw + (ulj + uc) * dsw;
    } else if (p.ewald) {
      T uc = cq * ec;
      T duc = cq * dec * T(0.5) * rinv;
      u += ulj * sw + uc;
      dudr2 += dulj * sw + ulj * dsw + duc;
    } else {
      T uc = kc * qq * (rinv + p.k_rf * r2 - p.c_rf);
      T duc = kc * qq * (p.k_rf - T(0.5) * rinv * rinv2);
      u += ulj * sw + uc;
      dudr2 += dulj * sw + ulj * dsw + duc;
    }
  }
  if (p.has_near) {
    // shifted-force LJ + Coulomb kernel, switched to zero at n_rc
    T xs = (r - p.n_rs) * p.n_inv_w;
    if (xs < T(1)) {
      T sw, ds_dx;
      switch_quintic(xs, sw, ds_dx);
      T dsw_dr = ds_dx * p.n_inv_w;
      T t = sig * rinv;
      T t2 = t * t;
      T s6 = t2 * t2 * t2;
      T base = T(4) * eps * s6 * (s6 - T(1)) + cq * ec;
      T dbase = T(-24) * eps * s6 * (T(2) * s6 - T(1)) * rinv + cq * dec;
      T tc = sig * p.n_rcinv;
      T tc2 = tc * tc;
      T s6c = tc2 * tc2 * tc2;
      T base_c = T(4) * eps * s6c * (s6c - T(1)) + cq * p.n_ec;
      T dbase_c =
          T(-24) * eps * s6c * (T(2) * s6c - T(1)) * p.n_rcinv + cq * p.n_dec;
      T sh = base - base_c - dbase_c * (r - p.n_rc);
      T un = sh * sw;
      T dun_dr = (dbase - dbase_c) * sw + sh * dsw_dr;
      u += p.near_sign * un;
      dudr2 += p.near_sign * dun_dr * T(0.5) * rinv;
    }
  }
}

// pair_form_energy, with the pair's virial -2 r^2 du/dr^2 in place of u
// under the virial flag: what the kernels call.
template <typename T, bool DAMPED, bool TABLE = false>
__device__ __forceinline__ void pair_form(const Params<T>& p, T r2, T qq,
                                          T sig, T eps, T& u, T& dudr2,
                                          T a1012 = T(0), T b1012 = T(0)) {
  pair_form_energy<T, DAMPED, TABLE>(p, r2, qq, sig, eps, u, dudr2, a1012,
                                     b1012);
  if (p.virial) u = T(-2) * r2 * dudr2;
}

// Whether a parameter block selects the damped forms (DAMPED above).
template <typename T>
inline bool damped(const Params<T>& p) {
  return p.alpha != T(0);
}

// The exclusion forms of K1 and K2, a template axis of both (EXC):
//   EXC_BITS   the relative-offset bitmask alone (every excluded pair lies
//              within +-EXC_WINDOW atom indices);
//   EXC_SPLIT  the bitmask for the pairs within +-EXC_WINDOW and, for the
//              rest, a row of far ids per atom of any width, sorted
//              ascending and -1 padded. Each home atom folds its row once
//              into a 64-bit filter (bit id mod 64, FarFilter) held in two
//              registers; a slot that passed the cutoff and the bitmask,
//              lies outside the window and finds its filter bit set scans
//              the row from global memory through the read-only cache
//              (excluded_far). A row of a few ids (an Amber protein's)
//              sets few bits, so most slots skip the scan, and a home
//              atom's row stays in L1 over its walk.
constexpr int EXC_BITS = 0;
constexpr int EXC_SPLIT = 1;
constexpr int EXC_WINDOW = 14;  // ops/neighbors.py::EXC_WINDOW

// EXC_SPLIT: a home atom's far ids folded into 64 bits, bit (id mod 64);
// zero for a null row (a thread without a home atom).
struct FarFilter {
  unsigned lo, hi;
};

__device__ __forceinline__ FarFilter far_filter(const int* __restrict__ row,
                                                int m) {
  FarFilter f{0u, 0u};
  if (row == nullptr) return f;
  for (int k = 0; k < m; ++k) {
    const int c = __ldg(row + k);
    if (c < 0) break;
    const unsigned bit = 1u << (c & 31);
    if (c & 32) {
      f.hi |= bit;
    } else {
      f.lo |= bit;
    }
  }
  return f;
}

// EXC_SPLIT: whether candidate `cid` is one of the far ids of the home atom
// `hid`, whose row of m ids (sorted ascending, -1 padded) starts at `row`
// and folds into `f`. Candidates within +-EXC_WINDOW are the bitmask's and
// are not looked up, nor are those whose filter bit is clear; the scan
// stops at the first padding entry or the first id above cid.
__device__ __forceinline__ bool excluded_far(const FarFilter& f,
                                             const int* __restrict__ row,
                                             int m, int hid, int cid) {
  const int d = cid - hid;
  if (d >= -EXC_WINDOW && d <= EXC_WINDOW) return false;
  const unsigned word = (cid & 32) ? f.hi : f.lo;
  if (((word >> (cid & 31)) & 1u) == 0u) return false;
  for (int k = 0; k < m; ++k) {
    const int c = __ldg(row + k);
    if (c < 0 || c > cid) return false;
    if (c == cid) return true;
  }
  return false;
}

// The form axis of K1 and K2: BuiltIn selects pair_form above; a
// generated UserPair (USER = true, NCOLS columns, NCONSTS constants, eval
// and eval_dconst) selects user_pair.
struct BuiltIn {
  static constexpr bool USER = false;
  static constexpr int NCOLS = 1;
  static constexpr int NCONSTS = 1;
};

// A user form's per-atom columns, staged where a built-in form stages its
// (q, sigma, epsilon).
template <typename T, int P>
struct Cols {
  T c[P];
};

// (u, du/dr^2) of a user form U at r2 between the columns ci and cj, its
// runtime constants in cs: U::eval, with the pair's virial -2 r^2 du/dr^2
// in place of u under the virial flag; under the dlambda flag u is
// du/d cs[dconst] (U::eval_dconst, the tangent seeded on that constant)
// and there is no force, as the softcore form's dlambda flag gives dU/dλ.
template <class U, typename T>
__device__ __forceinline__ void user_pair(const Params<T>& p,
                                          const T* __restrict__ cs,
                                          int dconst, T r2,
                                          const T* __restrict__ ci,
                                          const T* __restrict__ cj, T& u,
                                          T& dudr2) {
  if (p.dlambda) {
    T value;
    U::eval_dconst(r2, ci, cj, cs, dconst, value, u);
    dudr2 = T(0);
    return;
  }
  U::eval(r2, ci, cj, cs, u, dudr2);
  if (p.virial) u = T(-2) * r2 * dudr2;
}

}  // namespace pairforms
