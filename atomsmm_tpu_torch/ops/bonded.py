"""Harmonic bonds and angles, periodic torsions, harmonic impropers
(counterpart of atomsmm_tpu/ops/bonded.py).

Bonded terms use direct (non-minimum-image) displacements: positions stay
unwrapped during dynamics, so molecules stay whole. Forces come from
autograd; the atoms are gathered with `index_select`, whose backward pass
is one `index_add_` (advanced indexing goes back through a sort-based
`index_put_`: half as many device operations again for the same forces).
Each function takes a stack of K systems (x (K, N, 3)) as it takes one:
the gathers run along the atom axis and the sums over the terms, so it
returns (K,) energies, row k that of row k alone.
"""
from __future__ import annotations

import math

import torch


def _rows(x, idx, column: int):
    """x[..., idx[:, column], :] for an (M, C) integer index tensor."""
    return torch.index_select(x, -2, idx[:, column])


def harmonic_bond_energy(x, idx, r0, k):
    """E = sum 0.5 k (|x_i - x_j| - r0)^2; idx (B,2), r0/k (B,)."""
    dx = _rows(x, idx, 0) - _rows(x, idx, 1)
    r = torch.sqrt(torch.sum(dx * dx, dim=-1) + 1e-32)
    return torch.sum(0.5 * k * (r - r0) ** 2, dim=-1)


def harmonic_angle_energy(x, idx, theta0, k):
    """E = sum 0.5 k (theta - theta0)^2; idx (A,3) for atoms i-j-k (j central)."""
    a = _rows(x, idx, 0) - _rows(x, idx, 1)
    b = _rows(x, idx, 2) - _rows(x, idx, 1)
    na = torch.sqrt(torch.sum(a * a, dim=-1) + 1e-32)
    nb = torch.sqrt(torch.sum(b * b, dim=-1) + 1e-32)
    cos_t = torch.sum(a * b, dim=-1) / (na * nb)
    cos_t = torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    return torch.sum(0.5 * k * (theta - theta0) ** 2, dim=-1)


def dihedral_angle(x, idx):
    """Signed dihedral phi for atoms i-j-k-l; idx (T, 4)."""
    xi, xj, xk, xl = (_rows(x, idx, c) for c in range(4))
    b1, b2, b3 = xj - xi, xk - xj, xl - xk
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    m1 = torch.linalg.cross(
        n1, b2 / torch.linalg.norm(b2, dim=-1, keepdim=True))
    xc = torch.sum(n1 * n2, dim=-1)
    yc = torch.sum(m1 * n2, dim=-1)
    return torch.arctan2(yc, xc)


def periodic_torsion_energy(x, idx, periodicity, phase, k):
    """E = sum k (1 + cos(n phi - phase)); idx (T,4) for dihedral i-j-k-l."""
    phi = dihedral_angle(x, idx)
    return torch.sum(k * (1.0 + torch.cos(periodicity * phi - phase)), dim=-1)


def harmonic_improper_energy(x, idx, phi0, k):
    """CHARMM-style harmonic improper: E = sum k (phi - phi0)^2 with the
    difference wrapped to (-pi, pi] (idx (I,4); k carries NO 1/2, the
    CHARMM convention of CHAMBER prmtop force constants). torch.round
    rounds half to even, as jnp.round does."""
    phi = dihedral_angle(x, idx)
    dphi = phi - phi0
    dphi = dphi - 2.0 * math.pi * torch.round(dphi / (2.0 * math.pi))
    return torch.sum(k * dphi * dphi, dim=-1)
