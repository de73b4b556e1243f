"""Harmonic bonds and angles (counterpart of atomsmm_tpu/ops/bonded.py).

Bonded terms use direct (non-minimum-image) displacements: positions stay
unwrapped during dynamics, so molecules stay whole. Forces come from
autograd.
"""
from __future__ import annotations

import torch


def harmonic_bond_energy(x, idx, r0, k):
    """E = sum 0.5 k (|x_i - x_j| - r0)^2; idx (B,2), r0/k (B,)."""
    dx = x[idx[:, 0]] - x[idx[:, 1]]
    r = torch.sqrt(torch.sum(dx * dx, dim=-1) + 1e-32)
    return torch.sum(0.5 * k * (r - r0) ** 2)


def harmonic_angle_energy(x, idx, theta0, k):
    """E = sum 0.5 k (theta - theta0)^2; idx (A,3) for atoms i-j-k (j central)."""
    a = x[idx[:, 0]] - x[idx[:, 1]]
    b = x[idx[:, 2]] - x[idx[:, 1]]
    na = torch.sqrt(torch.sum(a * a, dim=-1) + 1e-32)
    nb = torch.sqrt(torch.sum(b * b, dim=-1) + 1e-32)
    cos_t = torch.sum(a * b, dim=-1) / (na * nb)
    cos_t = torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    return torch.sum(0.5 * k * (theta - theta0) ** 2)
