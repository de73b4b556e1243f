"""Quintic switching function (counterpart of atomsmm_tpu/ops/switching.py).

>>> import torch
>>> float(switch_quintic(torch.tensor(0.5, dtype=torch.float64), 0.7, 0.9))
1.0
>>> float(switch_quintic(torch.tensor(0.9, dtype=torch.float64), 0.7, 0.9))
0.0
>>> round(float(switch_quintic(torch.tensor(0.8, dtype=torch.float64), 0.7, 0.9)), 6)
0.5
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
