"""SETTLE — closed-form constraints for 3-site rigid molecules (counterpart
of atomsmm_tpu/ops/settle.py).

The position stage is the Miyamoto & Kollman (1992) geometric
construction: an exact, branch-free sequence of rotations over all
molecules at once (one (M, ...) batch). The velocity stage solves the
3-constraint RATTLE system exactly with one batched 3x3 adjugate solve,
valid for any triangle. Both are PyTorch operations; the molecules'
atoms are gathered as one (M, 3, 3) block and written back with one
index_copy / index_add.

Eligibility (checked on the host in partition_constraints): molecules
whose three constraints form a triangle with an apex atom A and two
symmetric satellite atoms B, C (m_B == m_C and d_AB == d_AC: every rigid
3-site water model). Anything else stays on SHAKE/RATTLE
(ops/constraints.py).

The clamps (sin phi and sin psi into [-1, 1], a2b2 - gamma^2 and
1 - sin^2 theta at 0, the 1e-30 floor under a normalisation) are what keep
a float32 step on the card free of NaN when rounding pushes an argument
past its domain.

Examples — one TIP3P-like water, displaced then reset exactly:

>>> import torch
>>> f64 = torch.float64
>>> masses = torch.tensor([15.9994, 1.008, 1.008], dtype=f64)
>>> ss = make_settle_set([[0, 1, 2]], d_ab=0.09572, d_bc=0.15139,
...                      masses=masses)
>>> ra, rb, rc = float(ss.ra[0]), float(ss.rb[0]), float(ss.rc[0])
>>> x0 = torch.tensor([[0.0, ra, 0.0],          # apex on the symmetry axis
...                    [-rc, -rb, 0.0], [rc, -rb, 0.0]], dtype=f64)
>>> float(settle_residual(ss, x0)) < 1e-12     # on the manifold already
True
>>> x1 = x0 + 0.004 * torch.tensor([[0.3, -1.0, 0.2],
...                                 [-0.8, 0.5, -0.1], [0.6, 0.4, 0.9]],
...                                dtype=f64)
>>> x = settle_positions(ss, x1, x0, masses)
>>> float(settle_residual(ss, x)) < 1e-12      # exact in ONE shot
True
>>> com1 = (masses[:, None] * x1).sum(0)       # COM is never moved
>>> com = (masses[:, None] * x).sum(0)
>>> bool(torch.allclose(com, com1, atol=1e-15))
True
>>> v = torch.tensor([[0.1, 0.4, -0.2], [1.5, -0.3, 0.8], [-0.9, 0.2, 0.1]],
...                  dtype=f64)
>>> vv = settle_velocities(ss, x0, v, masses)
>>> r_ab = x0[0] - x0[1]                       # exact tangency after one solve
>>> bool(abs(torch.dot(vv[0] - vv[1], r_ab)) < 1e-14)
True
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import resolve_device
from .constraints import ConstraintSet
from .neighbors import _host


@dataclasses.dataclass
class SettleSet:
    """triplets (M, 3) atom indices (apex A, satellites B, C; held as
    int64); ra/rb/rc (M,) canonical-triangle geometry [nm]:
      ra — |A - COM| along the symmetry axis,
      rb — distance from the COM plane to the BC line,
      rc — half the B-C distance.
    """

    triplets: torch.Tensor = None
    ra: torch.Tensor = None
    rb: torch.Tensor = None
    rc: torch.Tensor = None

    def __post_init__(self):
        if self.triplets is not None:
            self.triplets = torch.as_tensor(self.triplets).long()

    @property
    def size(self) -> int:
        return 0 if self.triplets is None else self.triplets.shape[0]


def _settle_equal(a, b, rtol=1e-9):
    """The one SETTLE-eligibility equality test (leg lengths, satellite
    masses), shared by partition_constraints and make_settle_set so that a
    group one accepts the other never rejects."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(a),
                                                          np.abs(b))))


def make_settle_set(triplets, d_ab, d_bc, masses, dtype=None,
                    device=None) -> SettleSet:
    """Geometry parameters from target distances (on the host).

    d_ab: apex-satellite distance (== d_ac); d_bc: satellite-satellite.
    Scalars or (M,) arrays. masses: the full (N,) masses, used for the
    mass-weighted apex/COM split m_A * ra == (m_B + m_C) * rb. The set is
    made on `device` in `dtype`; by default those of `masses` when it is a
    tensor, else the CUDA card and torch's default dtype.
    """
    triplets = _host(triplets).astype(np.int64).reshape(-1, 3)
    m = triplets.shape[0]
    if isinstance(masses, torch.Tensor):
        device = masses.device if device is None else device
        if dtype is None and masses.is_floating_point():
            dtype = masses.dtype
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    d_ab = np.broadcast_to(np.asarray(_host(d_ab), np.float64), (m,))
    d_bc = np.broadcast_to(np.asarray(_host(d_bc), np.float64), (m,))
    mass = _host(masses).astype(np.float64)
    ma = mass[triplets[:, 0]]
    mb = mass[triplets[:, 1]]
    mc = mass[triplets[:, 2]]
    if not _settle_equal(mb, mc):
        raise ValueError("SETTLE requires equal satellite masses (m_B == m_C)")
    rc = 0.5 * d_bc
    h2 = d_ab * d_ab - rc * rc
    if not np.all(h2 > 1e-6 * d_ab * d_ab):
        raise ValueError(
            "SETTLE requires a non-degenerate triangle (d_BC < 2 d_AB): a "
            "linear or impossible geometry has no apex height and would "
            "produce NaN dynamics")
    h = np.sqrt(h2)  # apex height above the BC line
    ra = (mb + mc) * h / (ma + mb + mc)
    rb = h - ra

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return SettleSet(triplets=torch.as_tensor(triplets, device=device),
                     ra=t(ra), rb=t(rb), rc=t(rc))


def partition_constraints(cons, masses):
    """Split a ConstraintSet into (SettleSet | None, ConstraintSet | None).

    Host-side (numpy) analysis: groups constraints by connected atoms; any
    group of exactly 3 constraints over 3 atoms forming an isoceles
    triangle (two equal distances from a common apex, equal satellite
    masses, a positive apex height) becomes a SETTLE molecule; everything
    else stays iterative. Both sets are made on the device and in the dtype
    of cons.d0.
    """
    if cons is None or cons.size == 0:
        return None, cons
    pairs = _host(cons.pairs).astype(np.int64)
    d0 = _host(cons.d0).astype(np.float64)
    mass = _host(masses).astype(np.float64)

    parent = {}

    def find(a):
        while parent.setdefault(a, a) != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in pairs:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[ri] = rj
    groups = {}
    for k, (i, j) in enumerate(pairs):
        groups.setdefault(find(int(i)), []).append(k)

    settle_rows, settle_dab, settle_dbc, rest = [], [], [], []
    for ks in groups.values():
        ok = False
        if len(ks) == 3:
            atoms = sorted({int(a) for k in ks for a in pairs[k]})
            if len(atoms) == 3:
                # the side opposite each vertex, keyed by that vertex
                opp = {}
                for k in ks:
                    i, j = (int(a) for a in pairs[k])
                    (v,) = set(atoms) - {i, j}
                    opp[v] = d0[k]
                # a duplicated pair leaves opp short: not a triangle
                if len(opp) == 3:
                    for apex in atoms:
                        b, c = (a for a in atoms if a != apex)
                        d_ab, d_ac, d_bc = opp[c], opp[b], opp[apex]
                        # equal apex legs, equal satellite masses and a
                        # positive apex height; a linear (h = 0) or
                        # impossible (h^2 < 0) triangle stays on SHAKE
                        h2 = d_ab * d_ac - 0.25 * d_bc * d_bc
                        if (_settle_equal(d_ab, d_ac)
                                and _settle_equal(mass[b], mass[c])
                                and h2 > 1e-6 * d_ab * d_ac):
                            settle_rows.append((apex, b, c))
                            settle_dab.append(d_ab)
                            settle_dbc.append(d_bc)
                            ok = True
                            break
        if not ok:
            rest.extend(ks)

    dtype, device = cons.d0.dtype, cons.d0.device
    sset = None
    if settle_rows:
        sset = make_settle_set(np.asarray(settle_rows, np.int64),
                               np.asarray(settle_dab), np.asarray(settle_dbc),
                               mass, dtype=dtype, device=device)
    rest_cons = None
    if rest:
        rest = np.asarray(sorted(rest))
        rest_cons = ConstraintSet(
            pairs=torch.as_tensor(pairs[rest], device=device),
            d0=torch.as_tensor(d0[rest], dtype=dtype, device=device))
    return sset, rest_cons


def _normalize(v, eps=1e-30):
    return v * torch.rsqrt(torch.clamp_min(torch.sum(v * v, -1, keepdim=True),
                                           eps))


def _dot(u, w):
    return torch.sum(u * w, -1)


def settle_positions(ss: SettleSet, x, x_ref, masses):
    """Exact position projection after an unconstrained move.

    x: unconstrained positions; x_ref: positions before the move (on the
    constraint manifold). Returns x with every SETTLE molecule reset to its
    rigid geometry, the molecular centre of mass untouched.
    """
    tr = ss.triplets
    a0, b0, c0 = x_ref[tr].unbind(1)
    a1, b1, c1 = x[tr].unbind(1)
    ma, mb, mc = masses[tr][..., None].unbind(1)
    ra, rb, rc = ss.ra, ss.rb, ss.rc

    com = (ma * a1 + mb * b1 + mc * c1) / (ma + mb + mc)

    # primed frame: origin at the new COM, z' normal to the old molecular
    # plane, x' normal to (z', apex) so that the apex lies in the y'-z' plane
    b0v, c0v = b0 - a0, c0 - a0
    a1v, b1v, c1v = a1 - com, b1 - com, c1 - com
    n0 = _normalize(torch.linalg.cross(b0v, c0v, dim=-1))
    n1 = _normalize(torch.linalg.cross(a1v, n0, dim=-1))
    n2 = torch.linalg.cross(n0, n1, dim=-1)  # unit by construction

    def to_primed(v):
        return _dot(v, n1), _dot(v, n2), _dot(v, n0)

    xb0, yb0, _ = to_primed(b0v)
    xc0, yc0, _ = to_primed(c0v)
    _, ya1, za1 = to_primed(a1v)  # the x' component is 0 by construction
    xb1, yb1, zb1 = to_primed(b1v)
    xc1, yc1, zc1 = to_primed(c1v)

    # tilt (phi about x', psi about y') matching the out-of-plane motion
    sinphi = torch.clamp(za1 / ra, -1.0, 1.0)
    cosphi = torch.sqrt(1.0 - sinphi * sinphi)
    sinpsi = torch.clamp((zb1 - zc1) / (2.0 * rc * cosphi), -1.0, 1.0)
    cospsi = torch.sqrt(1.0 - sinpsi * sinpsi)

    ya2 = ra * cosphi
    xb2 = -rc * cospsi
    yb2 = -rb * cosphi - rc * sinpsi * sinphi
    yc2 = -rb * cosphi + rc * sinpsi * sinphi

    # in-plane rotation theta from the SHAKE condition (corrections along
    # the old bond directions: Miyamoto & Kollman eqs. A5-A9)
    alpha = xb2 * (xb0 - xc0) + yb0 * yb2 + yc0 * yc2
    beta = xb2 * (yc0 - yb0) + xb0 * yb2 + xc0 * yc2
    gamma = xb0 * yb1 - xb1 * yb0 + xc0 * yc1 - xc1 * yc0
    a2b2 = alpha * alpha + beta * beta
    sinth = (alpha * gamma
             - beta * torch.sqrt(torch.clamp_min(a2b2 - gamma * gamma, 0.0))
             ) / a2b2
    costh = torch.sqrt(torch.clamp_min(1.0 - sinth * sinth, 0.0))

    xa3, ya3, za3 = -ya2 * sinth, ya2 * costh, za1
    xb3 = xb2 * costh - yb2 * sinth
    yb3 = xb2 * sinth + yb2 * costh
    xc3 = -xb2 * costh - yc2 * sinth
    yc3 = -xb2 * sinth + yc2 * costh

    def back(px, py, pz):
        return (com + px[:, None] * n1 + py[:, None] * n2
                + pz[:, None] * n0)

    new = torch.stack([back(xa3, ya3, za3), back(xb3, yb3, zb1),
                       back(xc3, yc3, zc1)], 1)
    return x.index_copy(0, tr.reshape(-1), new.reshape(-1, 3))


def settle_velocities(ss: SettleSet, x, v, masses):
    """Exact velocity projection (the RATTLE stage) for every triangle: the
    3x3 system for the three Lagrange multipliers solved in closed form
    (batched adjugate), exact for any triangle."""
    tr = ss.triplets
    xa, xb, xc = x[tr].unbind(1)
    va, vb, vc = v[tr].unbind(1)
    im_a, im_b, im_c = (1.0 / masses[tr]).unbind(1)

    # constraint bond vectors: 1 = (A,B), 2 = (B,C), 3 = (C,A)
    r1, r2, r3 = xa - xb, xb - xc, xc - xa

    # A_lk = w_lk (r_l . r_k): (im_i + im_j) on the diagonal, minus the
    # inverse mass of the shared atom off the diagonal
    a11 = (im_a + im_b) * _dot(r1, r1)
    a22 = (im_b + im_c) * _dot(r2, r2)
    a33 = (im_c + im_a) * _dot(r3, r3)
    a12 = -im_b * _dot(r1, r2)
    a13 = -im_a * _dot(r1, r3)
    a23 = -im_c * _dot(r2, r3)
    rhs1 = -_dot(va - vb, r1)
    rhs2 = -_dot(vb - vc, r2)
    rhs3 = -_dot(vc - va, r3)

    det = (a11 * (a22 * a33 - a23 * a23)
           - a12 * (a12 * a33 - a23 * a13)
           + a13 * (a12 * a23 - a22 * a13))
    inv_det = 1.0 / torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
    # symmetric adjugate
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    l1 = ((c11 * rhs1 + c12 * rhs2 + c13 * rhs3) * inv_det)[:, None]
    l2 = ((c12 * rhs1 + c22 * rhs2 + c23 * rhs3) * inv_det)[:, None]
    l3 = ((c13 * rhs1 + c23 * rhs2 + c33 * rhs3) * inv_det)[:, None]

    dv = torch.stack([im_a[:, None] * (l1 * r1 - l3 * r3),
                      im_b[:, None] * (l2 * r2 - l1 * r1),
                      im_c[:, None] * (l3 * r3 - l2 * r2)], 1)
    return v.index_add(0, tr.reshape(-1), dv.reshape(-1, 3))


def settle_residual(ss: SettleSet, x):
    """max relative geometry error over all SETTLE molecules."""
    a, b, c = x[ss.triplets].unbind(1)
    h = ss.ra + ss.rb  # apex height above the BC line
    d_ab = torch.sqrt(h * h + ss.rc * ss.rc)  # target apex-satellite
    d_bc = 2.0 * ss.rc

    def err(u, w, d0):
        r = torch.sqrt(torch.sum((u - w) ** 2, -1))
        return (r - d0).abs() / d0

    return torch.max(torch.stack([err(a, b, d_ab), err(a, c, d_ab),
                                  err(b, c, d_bc)]))
