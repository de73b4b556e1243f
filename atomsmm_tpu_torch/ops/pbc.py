"""Periodic boundary helpers (counterpart of atomsmm_tpu/ops/pbc.py),
orthorhombic boxes only: a box is a (3,) tensor of edge lengths. A (3, 3)
cell matrix raises InputError (triclinic boxes are a later slice).

Examples:

>>> import torch
>>> box = torch.tensor([2.0, 2.0, 2.0], dtype=torch.float64)
>>> [round(v, 6) for v in minimum_image(torch.tensor([1.9, -1.9, 0.4], dtype=torch.float64), box).tolist()]
[-0.1, 0.1, 0.4]
>>> float(minimum_image(torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64), box)[0])  # half-box edge
1.0
>>> float(box_volume(box))
8.0
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import InputError


def _check_orthorhombic(box) -> None:
    if box.ndim != 1:
        raise InputError(
            "atomsmm_tpu_torch supports orthorhombic (3,) boxes only; "
            "triclinic (3, 3) cells are not ported yet")


def box_volume(box: torch.Tensor) -> torch.Tensor:
    """Cell volume [nm^3]."""
    _check_orthorhombic(box)
    return torch.prod(box)


def minimum_image(dx: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement; dx (..., 3), box (3,). Rounds half to
    even (``torch.round``), like ``jnp.round``, and multiplies by the
    reciprocal box as the JAX package does."""
    _check_orthorhombic(box)
    return dx - box * torch.round(dx * (1.0 / box))


def max_cutoff(box) -> float:
    """Largest cutoff the minimum-image convention supports: half the
    smallest edge (host-side helper)."""
    box = np.asarray(torch.as_tensor(box).detach().cpu(), np.float64)
    if box.ndim != 1:
        _check_orthorhombic(box)
    return 0.5 * float(box.min())


def validate_cutoffs(system, box) -> None:
    """Enforce the minimum-image validity bound r_cut <= max_cutoff(box)
    for every cutoff force of the system (checked at Context construction)."""
    bound = max_cutoff(box)
    seen = []

    def visit(f):
        rc = getattr(f, "r_cut", None)
        if rc is not None:
            seen.append((type(f).__name__, float(rc)))
        inner = getattr(f, "full", None)
        if inner is not None:
            visit(inner)

    for f in getattr(system, "forces", ()):
        visit(f)
    for name, rc in seen:
        if np.isfinite(rc) and rc > bound + 1e-9:
            raise InputError(
                f"{name}.r_cut = {rc:.4f} nm exceeds the minimum-image bound "
                f"max_cutoff(box) = {bound:.4f} nm (half the smallest box "
                f"edge); shrink the cutoff or use a larger box"
            )
