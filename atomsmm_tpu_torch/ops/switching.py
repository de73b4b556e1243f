"""Switching and shifted-potential transformations (counterpart of
atomsmm_tpu/ops/switching.py): the quintic switching polynomial over
[rswitch, rcut], and the shifted-force form U(r) - U(rc) - U'(rc) (r - rc)
that takes energy and force continuously to zero at the cutoff.

>>> import torch
>>> float(switch_quintic(torch.tensor(0.5, dtype=torch.float64), 0.7, 0.9))
1.0
>>> float(switch_quintic(torch.tensor(0.9, dtype=torch.float64), 0.7, 0.9))
0.0
>>> round(float(switch_quintic(torch.tensor(0.8, dtype=torch.float64), 0.7, 0.9)), 6)
0.5
>>> sf = shifted_force(lambda r, q: q / r)
>>> r = torch.tensor(0.9, dtype=torch.float64)
>>> float(sf(r, 0.9, 2.0))   # zero at the cutoff
0.0
>>> round(float(shifted_potential(lambda r, q: q / r)(r / 2, 0.9, 2.0)), 6)
2.222222
"""
from __future__ import annotations

import torch


def switch_quintic(r, r_switch, r_cut):
    """OpenMM-style quintic switching function S(r).

    S = 1 for r <= r_switch; S = 0 for r >= r_cut; in between
    S(u) = 1 - 10 u^3 + 15 u^4 - 6 u^5 with u = (r - rs)/(rc - rs).
    """
    u = (r - r_switch) * (1.0 / (r_cut - r_switch))
    u = torch.clamp(u, 0.0, 1.0)
    return 1.0 + u * u * u * (-10.0 + u * (15.0 - 6.0 * u))


def _at(rc, r):
    """The cutoff as a tensor of r's dtype and device."""
    return torch.as_tensor(rc, dtype=r.dtype, device=r.device)


def shifted_force(u_fn):
    """Transform u(r) -> u(r) - u(rc) - u'(rc) (r - rc).

    Returns sf(r, rc, *args) given u_fn(r, *args), where u_fn returns a
    scalar at a scalar r (the derivative at the cutoff comes from
    torch.func.grad, not from hand differentiation)."""
    du = torch.func.grad(u_fn, argnums=0)

    def sf(r, rc, *args):
        rc_t = _at(rc, r)
        return u_fn(r, *args) - u_fn(rc_t, *args) - du(rc_t, *args) * (
            r - rc_t)

    return sf


def shifted_potential(u_fn):
    """Transform u(r) -> u(r) - u(rc): energy (not force) continuous at rc."""

    def sp(r, rc, *args):
        return u_fn(r, *args) - u_fn(_at(rc, r), *args)

    return sp
