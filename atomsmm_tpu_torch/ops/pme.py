"""Smooth particle-mesh Ewald, the reciprocal sum (counterpart of
atomsmm_tpu/ops/pme.py), for orthorhombic and triclinic boxes.

The JAX package spreads charges with one-hot matrices on the TPU's matrix
unit and takes the reciprocal forces with ``jax.value_and_grad``. The port
spreads with one ``index_add_`` (a scatter, which a GPU does directly) and
computes the forces explicitly, in the classic SPME way (Essmann et al.,
J. Chem. Phys. 103, 8577 (1995)):

    Q(g)   = sum_i q_i Wx_i(g1) Wy_i(g2) Wz_i(g3)         (spread)
    E      = sum_m W(m) |Q^(m)|^2                           (energy)
    phi(g) = dE/dQ(g) = 2 K1 K2 K3 irfftn(B(m) Q^(m))(g)    (convolution)
    F_i    = -q_i sum_g phi(g) d[Wx Wy Wz]_i(g)/dx_i        (gather)

with Q^ = rfftn(Q), B(m) = k_e/(2 pi V) exp(-pi^2 |m~|^2/alpha^2)/|m~|^2
|b1 b2 b3|^2 (m~ = m/L; in a (3, 3) cell H, m~ = inv(H) m, so that
|m~|^2 = m^T G m with the reciprocal metric G = inv(H)^T inv(H)) and
W(m) = B(m) times the half-spectrum weights
(2 for the interior k3 columns, whose conjugate twins rfftn does not
store). irfftn divides by K1 K2 K3 and rebuilds the Hermitian half itself,
so phi needs B without those weights. The fractional grid coordinates
are u = x/L K, or x inv(H) K in a (3, 3) cell, whose force gathers the
u-space gradient back through inv(H)^T. No autograd graph is built over the
N x order^3 scatter entries. The functions run unchanged on CPU and CUDA
tensors; there is no hand kernel here (the JAX package's reciprocal sum is
XLA, not Pallas).

Direct space (erfc pairs) lives in the pair kernels (ops/pairfuncs.py,
LJ_SW_EWALD); this module adds the reciprocal term, the self energy and
the excluded-pair erf corrections.

>>> import torch
>>> w = bspline_weights(torch.tensor([0.0, 0.3], dtype=torch.float64), 4)
>>> [round(float(v), 12) for v in w.sum(-1)]
[1.0, 1.0]
>>> alpha, grid, order = choose_pme_parameters(0.9, [6.6947] * 3)
>>> round(alpha, 5), grid, order
(2.92029, (45, 45, 45), 6)
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..units import ONE_4PI_EPS0
from .pbc import _inv, box_volume, minimum_image

#: reciprocal-sum evaluations so far in this process (energy, or energy and
#: forces), counted like the pair kernels' launches; reset by callers
EVALUATIONS = {"reciprocal": 0}


def reset_evaluations():
    EVALUATIONS["reciprocal"] = 0


# --------------------------------------------------------------------------
# B-splines
# --------------------------------------------------------------------------


def _bspline_values(t, order: int):
    """M_order(t + j), j = 0..order-1, by the recurrence
    M_n(u) = [u M_{n-1}(u) + (n-u) M_{n-1}(u-1)] / (n-1) from M_2."""
    u = t[..., None] + torch.arange(order, dtype=t.dtype, device=t.device)
    m = torch.clamp(1.0 - torch.abs(u - 1.0), min=0.0)  # M_2
    for n in range(3, order + 1):
        m_shift = torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], -1)
        m = (u * m + (n - u) * m_shift) / (n - 1)
    return m


def bspline_derivative(t, order: int):
    """d/dt M_order(t + j) = M_{order-1}(t + j) - M_{order-1}(t + j - 1):
    branch-free and exact at t = 0, where the rows sum to 0 (telescoping)."""
    if order < 3:
        raise ValueError(
            f"B-spline derivative requires order >= 3, got {order}")
    wl = _bspline_values(t, order - 1)
    zero = torch.zeros_like(wl[..., :1])
    return torch.cat([wl, zero], -1) - torch.cat([zero, wl], -1)


class _BSplineWeights(torch.autograd.Function):
    """The spline weights with their analytic derivative: autograd through
    the max/abs kinks of the M_2 seed would pick subgradients whose rows sum
    to -1 at t == 0 exactly (an atom on a grid plane)."""

    @staticmethod
    def forward(ctx, t, order):
        ctx.order = order
        ctx.save_for_backward(t)
        return _bspline_values(t, order)

    @staticmethod
    def backward(ctx, grad):
        (t,) = ctx.saved_tensors
        return (grad * bspline_derivative(t, ctx.order)).sum(-1), None


def bspline_weights(t, order: int):
    """Cardinal B-spline values M_order(t + j) for j = 0..order-1, t in
    [0, 1), shape t.shape + (order,); they sum to 1. Differentiable, with
    the analytic derivative (bspline_derivative)."""
    if order < 2:
        raise ValueError(f"B-spline order must be >= 2, got {order}")
    return _BSplineWeights.apply(t, order)


def _bspline_moduli(k: int, order: int) -> np.ndarray:
    """|b(m)|^2 for one dimension (Euler exponential spline factors), host
    float64."""
    def M(n, u):
        if n == 2:
            return max(1.0 - abs(u - 1.0), 0.0)
        return (u * M(n - 1, u) + (n - u) * M(n - 1, u - 1)) / (n - 1)

    mvals = [M(order, j + 1.0) for j in range(order - 1)]
    m = np.arange(k)
    denom = np.zeros(k, dtype=np.complex128)
    for j in range(order - 1):
        denom += mvals[j] * np.exp(2j * np.pi * m * j / k)
    b2 = 1.0 / np.maximum(np.abs(denom) ** 2, 1e-14)
    # the Nyquist mode of an even grid: the denominator cancels exactly for
    # odd orders, and the mode's Gaussian weight is ~e^-30 anyway
    if k % 2 == 0:
        b2[k // 2] = 0.0
    return b2


# --------------------------------------------------------------------------
# Spreading and gathering
# --------------------------------------------------------------------------


def _fractional(x, box):
    """Fractional coordinates: x/L, or x inv(H) in a (3, 3) cell."""
    return x / box if box.ndim == 1 else torch.matmul(x, _inv(box))


def _spline_setup(x, box, grid_shape, order: int, with_derivative: bool):
    """Flat grid indices (N, order^3) of each atom's spline support and the
    weights (N, 3, order) of the three dimensions (and their
    t-derivatives), each computed for all three dimensions at once. Weight
    j of a dimension sits at grid point floor(u) - j, u = x/L K (x inv(H) K
    in a (3, 3) cell)."""
    u = _fractional(x, box) * _grid_constants(grid_shape, order, x.dtype,
                                              x.device).kvec
    m0 = torch.floor(u)
    t = u - m0
    m0 = m0.long()
    j = torch.arange(order, device=x.device)
    k1, k2, k3 = grid_shape
    ix = torch.remainder(m0[:, 0, None] - j, k1)
    iy = torch.remainder(m0[:, 1, None] - j, k2)
    iz = torch.remainder(m0[:, 2, None] - j, k3)
    idx = ((ix[:, :, None, None] * k2 + iy[:, None, :, None]) * k3
           + iz[:, None, None, :]).reshape(x.shape[0], -1)
    w = bspline_weights(t, order)
    dw = bspline_derivative(t, order) if with_derivative else None
    return idx, w, dw


def _outer3(a, b, c):
    """(N, o, o, o) products a_j b_k c_l, flattened to (N, o^3)."""
    n = a.shape[0]
    return (a[:, :, None, None] * (b[:, None, :, None]
                                   * c[:, None, None, :])).reshape(n, -1)


def _spread(idx, w, q, grid_shape):
    """The charge grid from _spline_setup's indices and weights: one
    index_add of the N x order^3 weighted entries (on the card the scatter
    adds with atomics, so float32 grids change in their last bits from run
    to run)."""
    vals = q[:, None] * _outer3(w[:, 0], w[:, 1], w[:, 2])
    k1, k2, k3 = grid_shape
    return vals.new_zeros(k1 * k2 * k3).index_add(
        0, idx.reshape(-1), vals.reshape(-1)).reshape(grid_shape)


def spread_charges(x, box, q, grid_shape: Tuple[int, int, int],
                   order: int = 4):
    """Spread point charges onto the (K1, K2, K3) grid with B-splines."""
    if order < 3:
        raise ValueError(f"PME spline_order must be >= 3, got {order}")
    grid_shape = tuple(grid_shape)
    idx, w, _ = _spline_setup(x, box, grid_shape, order, False)
    return _spread(idx, w, q, grid_shape)


# --------------------------------------------------------------------------
# Reciprocal sum
# --------------------------------------------------------------------------


class _GridConstants(NamedTuple):
    f1: torch.Tensor    # (K1, 1, 1) squared integer frequencies
    f2: torch.Tensor    # (1, K2, 1)
    f3: torch.Tensor    # (1, 1, K3//2+1), the rfft half
    m1: torch.Tensor    # (K1, 1, 1) signed integer frequencies
    m2: torch.Tensor    # (1, K2, 1)
    m3: torch.Tensor    # (1, 1, K3//2+1)
    b2: torch.Tensor    # |b1 b2 b3|^2 on the half spectrum
    w3: torch.Tensor    # half-spectrum column weights (1 or 2)
    kvec: torch.Tensor  # (K1, K2, K3)


@functools.lru_cache(maxsize=16)
def _grid_constants(grid_shape, order: int, dtype, device) -> _GridConstants:
    """Per-grid constants on the device, made once per (grid, order, dtype,
    device) so that an evaluation copies nothing from the host."""
    k1, k2, k3 = grid_shape
    k3r = k3 // 2 + 1

    def freqs(k):
        m = np.arange(k)
        return np.where(m <= k // 2, m, m - k).astype(np.float64)

    b2 = (_bspline_moduli(k1, order)[:, None, None]
          * _bspline_moduli(k2, order)[None, :, None]
          * _bspline_moduli(k3, order)[None, None, :k3r])
    w3 = np.full(k3r, 2.0)
    w3[0] = 1.0
    if k3 % 2 == 0:
        w3[-1] = 1.0

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    m1 = freqs(k1)[:, None, None]
    m2 = freqs(k2)[None, :, None]
    m3 = np.arange(k3r, dtype=np.float64)[None, None, :]
    return _GridConstants(
        t(m1 ** 2), t(m2 ** 2), t(m3 ** 2), t(m1), t(m2), t(m3), t(b2), t(w3),
        t(np.asarray(grid_shape)))


def _influence_full(box, alpha, grid_shape, order: int):
    """B(m) on the half spectrum (K1, K2, K3//2+1): Gaussian filter, spline
    moduli and the k_e/(2 pi V) prefactor, without the half-spectrum column
    weights. In a (3, 3) cell |m~|^2 = m^T G m, G = inv(H)^T inv(H)."""
    c = _grid_constants(tuple(grid_shape), int(order), box.dtype, box.device)
    if box.ndim == 1:
        inv2 = 1.0 / (box * box)
        m2 = c.f1 * inv2[0] + c.f2 * inv2[1] + c.f3 * inv2[2]
    else:
        inv_h = _inv(box)
        g = torch.matmul(inv_h.T, inv_h)
        m2 = (g[0, 0] * c.f1 + g[1, 1] * c.f2 + g[2, 2] * c.f3
              + 2.0 * (g[0, 1] * c.m1 * c.m2 + g[0, 2] * c.m1 * c.m3
                       + g[1, 2] * c.m2 * c.m3))
    pos = m2 > 0
    safe = torch.where(pos, m2, torch.ones_like(m2))
    filt = torch.where(pos, torch.exp(-(math.pi ** 2 / alpha ** 2) * safe)
                       / safe, torch.zeros_like(m2))
    return ONE_4PI_EPS0 / (2.0 * math.pi * box_volume(box)) * filt * c.b2


def pme_influence(box, alpha, grid_shape, order: int):
    """W(m) with E = sum_m W(m) |Q^(m)|^2 over the rfft half spectrum:
    the Gaussian filter, the B-spline moduli, the k_e/(2 pi V) prefactor
    and the double-count weights of the interior k3 columns."""
    w3 = _grid_constants(tuple(grid_shape), int(order), box.dtype,
                         box.device).w3
    return _influence_full(box, alpha, grid_shape, order) * w3


def pme_reciprocal_from_grid(Q, box, alpha, grid_shape, order: int = 4):
    """FFT and reciprocal convolution of an already spread charge grid."""
    qhat = torch.fft.rfftn(Q)
    w = pme_influence(box, alpha, grid_shape, order)
    return torch.sum(w * (qhat.real ** 2 + qhat.imag ** 2))


def pme_reciprocal_energy(x, box, q, alpha, grid_shape, order: int = 4):
    """Reciprocal-space PME energy [kJ/mol] (differentiable by autograd)."""
    EVALUATIONS["reciprocal"] += 1
    Q = spread_charges(x, box, q, grid_shape, order)
    return pme_reciprocal_from_grid(Q, box, alpha, grid_shape, order)


def _convolve(qhat, box, alpha, grid_shape, order: int):
    """(E, B(m) Q^(m)): the energy on the half spectrum and the convolved
    spectrum whose inverse transform is the grid potential."""
    b = _influence_full(box, alpha, grid_shape, order)
    w3 = _grid_constants(grid_shape, int(order), box.dtype, box.device).w3
    energy = torch.sum(b * w3 * (qhat.real ** 2 + qhat.imag ** 2))
    return energy, b * qhat


def _grid_potential(bq, grid_shape):
    """phi = dE/dQ on the grid: 2 K1 K2 K3 irfftn(B Q^)."""
    k1, k2, k3 = grid_shape
    return torch.fft.irfftn(bq, s=grid_shape) * (2.0 * k1 * k2 * k3)


def _gather(phi, idx, w, dw, q, box, grid_shape, order: int):
    """F_i = -q_i (K/L) sum over the support of phi times the weight
    products with one factor differentiated, per dimension; in a (3, 3)
    cell the u-space gradient times K goes back through inv(H)^T."""
    wx, wy, wz = w.unbind(1)
    dx, dy, dz = dw.unbind(1)
    phi_at = phi.reshape(-1)[idx]                        # (N, order^3)
    kvec = _grid_constants(grid_shape, order, q.dtype, q.device).kvec
    grad_u = torch.stack([
        (phi_at * _outer3(dx, wy, wz)).sum(-1),
        (phi_at * _outer3(wx, dy, wz)).sum(-1),
        (phi_at * _outer3(wx, wy, dz)).sum(-1)], -1) * kvec
    if box.ndim == 1:
        return grad_u * (-q[:, None] / box)
    return torch.matmul(grad_u, _inv(box).T) * -q[:, None]


def pme_reciprocal_energy_forces(x, box, q, alpha, grid_shape,
                                 order: int = 4):
    """(E, forces (N, 3)) of the reciprocal sum, forces explicit: spline
    weights, spread, rfftn, convolution with B(m), irfftn to the grid
    potential phi = dE/dQ, and a gather with the spline-derivative
    weights."""
    if order < 3:
        raise ValueError(f"PME spline_order must be >= 3, got {order}")
    EVALUATIONS["reciprocal"] += 1
    grid_shape, order = tuple(grid_shape), int(order)
    x, q = x.detach(), q.detach()
    idx, w, dw = _spline_setup(x, box, grid_shape, order, True)
    qhat = torch.fft.rfftn(_spread(idx, w, q, grid_shape))
    energy, bq = _convolve(qhat, box, alpha, grid_shape, order)
    phi = _grid_potential(bq, grid_shape)
    return energy, _gather(phi, idx, w, dw, q, box, grid_shape, order)


# --------------------------------------------------------------------------
# Corrections
# --------------------------------------------------------------------------


def pme_self_energy(q, alpha):
    return -ONE_4PI_EPS0 * alpha / math.sqrt(math.pi) * torch.sum(q * q)


def _excluded_pairs(x, box, exclusions):
    """(i, j, valid, minimum-image x_i - x_j) over the (N*M,) flattened
    exclusion table, each pair once (j > i)."""
    n, m = exclusions.shape
    ii = torch.arange(n, device=x.device).repeat_interleave(m)
    ej = exclusions.reshape(-1).long()
    valid = ej > ii
    j = torch.clamp(ej, 0, n - 1)
    return ii, j, valid, minimum_image(x[ii] - x[j], box)


def _erf_over_r(alpha, r2):
    """(r, erf(alpha r)/r) over the excluded pairs, with the r -> 0 limit
    2 alpha/sqrt(pi) where r2 = 0 (a Drude particle on its core) and r = 1
    there, so that no NaN reaches either branch or a backward pass."""
    apart = r2 > 0
    r = torch.sqrt(torch.where(apart, r2, torch.ones_like(r2)))
    limit = torch.zeros_like(r) + 2.0 * alpha / math.sqrt(math.pi)
    return r, torch.where(apart, torch.erf(alpha * r) / r, limit)


def pme_exclusion_correction(x, box, q, exclusions, alpha):
    """Remove the reciprocal-space interactions of excluded pairs:
    -k_e q_i q_j erf(alpha r)/r summed over each excluded pair once. A
    coincident excluded pair takes the r -> 0 limit -k_e q_i q_j 2
    alpha/sqrt(pi) (the JAX package gives NaN there)."""
    ii, j, valid, d = _excluded_pairs(x, box, exclusions)
    r2 = torch.sum(d * d, dim=-1)
    _, erf_r = _erf_over_r(alpha, torch.where(valid, r2, torch.ones_like(r2)))
    e = -ONE_4PI_EPS0 * q[ii] * q[j] * erf_r
    return torch.sum(torch.where(valid, e, torch.zeros_like(e)))


def pme_exclusion_correction_forces(x, box, q, exclusions, alpha):
    """(E, forces (N, 3)) of pme_exclusion_correction, forces explicit:
    with e(r) = -k qq erf(a r)/r, de/dr = -k qq [(2a/sqrt(pi)) exp(-a² r²)
    - erf(a r)/r]/r, and F_i = -de/dr (x_i - x_j)/r = -F_j. A coincident
    pair takes the limits: its energy as in pme_exclusion_correction, its
    force 0 (d = 0 there)."""
    ii, j, valid, d = _excluded_pairs(x, box, exclusions)
    r2 = torch.sum(d * d, dim=-1)
    r, erf_r = _erf_over_r(alpha, torch.where(valid, r2, torch.ones_like(r2)))
    cq = torch.where(valid, -ONE_4PI_EPS0 * q[ii] * q[j],
                     torch.zeros_like(r))
    de_dr = cq * (2.0 / math.sqrt(math.pi) * alpha
                  * torch.exp(-(alpha * r) ** 2) - erf_r) / r
    g = (-de_dr / r)[:, None] * d
    forces = torch.zeros_like(x)
    forces.index_add_(0, ii, g)
    forces.index_add_(0, j, -g)
    return torch.sum(cq * erf_r), forces


def pme_corrections(x, box, q, exclusions, alpha):
    """Self energy + excluded-pair corrections (everything but the pair
    loop and the FFT term)."""
    return pme_self_energy(q, alpha) + pme_exclusion_correction(
        x, box, q, exclusions, alpha)


def pme_corrections_forces(x, box, q, exclusions, alpha):
    """(E, forces) of pme_corrections; the self energy has no force."""
    e, f = pme_exclusion_correction_forces(x, box, q, exclusions, alpha)
    return pme_self_energy(q, alpha) + e, f


# --------------------------------------------------------------------------
# Parameter selection (openmm-compatible heuristics, host numpy)
# --------------------------------------------------------------------------


def _good_fft_size(n: int, multiple_of: int = 1) -> int:
    """Smallest size >= n with only factors 2, 3, 5 (and divisible by
    `multiple_of`)."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1 and n % multiple_of == 0:
            return n
        n += 1


#: grid spacing factors relative to the order-4 openmm rule that keep the
#: accuracy of order 4 (the JAX package's measured table)
_ORDER_SPACING_FACTOR = {4: 1.0, 5: 0.85, 6: 0.75, 7: 0.70, 8: 0.65}


def choose_pme_parameters(r_cut, box, tol: float = 5e-4, alpha=None,
                          grid=None, order: int = 6, multiple_of: int = 1):
    """(alpha, (K1, K2, K3), order) from the cutoff and an error tolerance:
    alpha = sqrt(-log(2 tol))/r_cut (openmm.NonbondedForce), and
    K_d = ceil(f 2 alpha L_d / (3 tol^(1/5))) rounded up to a 2-3-5 size,
    with f the order's spacing factor (1 at order 4: openmm's rule); a
    (3, 3) cell sizes each dimension by its lattice vector's length."""
    box = np.asarray(box, np.float64)
    lengths = box if box.ndim == 1 else np.linalg.norm(box, axis=1)
    if alpha is None:
        alpha = math.sqrt(-math.log(2.0 * tol)) / float(r_cut)
    if grid is None:
        factor = _ORDER_SPACING_FACTOR.get(order, 1.0 if order < 4 else 0.65)
        grid = [
            _good_fft_size(
                int(math.ceil(factor * 2.0 * alpha * L / (3.0 * tol ** 0.2))),
                multiple_of)
            for L in lengths
        ]
    return float(alpha), tuple(int(g) for g in grid), int(order)


def pme_validity_lengths(alpha, grid_shape, order, r_cut):
    """Per-dimension box lengths up to which a static (alpha, grid) still
    meets its design tolerance: the grid rule inverted,
    L_max = K 3 tol^0.2 / (2 alpha f), with tol recovered from alpha."""
    alpha = float(alpha)
    tol = 0.5 * math.exp(-((alpha * float(r_cut)) ** 2))
    factor = _ORDER_SPACING_FACTOR.get(int(order),
                                       1.0 if order < 4 else 0.65)
    return tuple(
        k * 3.0 * tol ** 0.2 / (2.0 * alpha * factor) for k in grid_shape
    )


def ewald_reference_energy(x, box, q, alpha, kmax: int = 12):
    """Slow direct Ewald reciprocal sum over plane waves |m_d| <= kmax (no
    mesh): the test oracle of the PME sum. In a (3, 3) cell each wave
    vector is inv(H) m."""
    r = torch.arange(-kmax, kmax + 1, dtype=x.dtype, device=x.device)
    ms = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    ms = ms[(ms != 0).any(-1)]
    m_tilde = (ms / box[None, :] if box.ndim == 1
               else torch.matmul(ms, _inv(box).T))
    m2 = torch.sum(m_tilde * m_tilde, dim=1)
    phase = 2.0 * math.pi * (x @ m_tilde.T)
    s_re = torch.sum(q[:, None] * torch.cos(phase), dim=0)
    s_im = torch.sum(q[:, None] * torch.sin(phase), dim=0)
    filt = torch.exp(-math.pi ** 2 * m2 / alpha ** 2) / m2
    return ONE_4PI_EPS0 / (2.0 * math.pi * box_volume(box)) * torch.sum(
        filt * (s_re ** 2 + s_im ** 2))
