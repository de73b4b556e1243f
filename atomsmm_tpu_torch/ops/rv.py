"""r²-native pair evaluation carrier (counterpart of atomsmm_tpu/ops/rv.py).

Pair distances enter evaluators as r². The identity f = -2 (du/dr²) Δx
gives forces without a 1/r divide, and every pair primitive derives from
one reciprocal square root: rinv = rsqrt(r²), r = r² rinv.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Rv(NamedTuple):
    r2: torch.Tensor
    rinv: torch.Tensor
    r: torch.Tensor


def make_rv(r2) -> Rv:
    # f64 (the CPU reference path) takes the exact 1/sqrt; f32 the rsqrt
    if r2.dtype == torch.float64:
        rinv = 1.0 / torch.sqrt(r2)
    else:
        rinv = torch.rsqrt(r2)
    return Rv(r2, rinv, r2 * rinv)


def rv_parts(r):
    """(r, 1/r, r²) from either an Rv or a plain distance tensor."""
    if isinstance(r, Rv):
        return r.r, r.rinv, r.r2
    inv = 1.0 / r
    return r, inv, r * r


def pair_eval(pair_fn, r2m, pi, pj, with_tangent: bool):
    """Evaluate pair_fn on masked r² (invalid slots pre-set to 1.0).

    Returns (u, dudr2) with dudr2 = du/d(r²) from ``torch.func.jvp`` when
    with_tangent, else (u, None). The force on atom i is -2 dudr2 Δx_ij."""
    takes = getattr(pair_fn, "takes_rv", False)

    def f(s):
        rv = make_rv(s)
        return pair_fn(rv if takes else rv.r, pi, pj)

    if with_tangent:
        return torch.func.jvp(f, (r2m,), (torch.ones_like(r2m),))
    return f(r2m), None
