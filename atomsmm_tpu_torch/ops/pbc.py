"""Periodic boundary helpers, orthorhombic and reduced triclinic boxes
(counterpart of atomsmm_tpu/ops/pbc.py).

A box is one of two tensors, told apart by its shape:

* ``(3,)``: orthorhombic edge lengths; the minimum image is
  ``dx - box * round(dx / box)``;
* ``(3, 3)``: the triclinic cell matrix H, rows = lattice vectors (a, b,
  c) in OpenMM's reduced form (a along x, b in the xy plane, off-diagonal
  elements at most half the corresponding diagonal). The minimum image
  goes through fractional coordinates: s = dx inv(H); dx - round(s) H,
  exact for reduced cells while the cutoff is at most half the smallest
  perpendicular width (``max_cutoff``).

Every consumer takes both forms: the dense pair path, bonded terms,
SETTLE and virtual sites, PME, virials, the cell lists (the grid and
stencil sized from perpendicular widths, fractional binning) and the cell
sweeps K1 and K2, which take H with inv(H) and round each slot in
fractional coordinates (csrc/pair_forms.cuh::Image). The tile list and
K3 take (3,) boxes only, as the JAX package's tile list does. inv(H) is
taken with ``torch.linalg.inv_ex``, which does not read an
error flag back to the host.

Examples:

>>> import torch
>>> box = torch.tensor([2.0, 2.0, 2.0], dtype=torch.float64)
>>> [round(v, 6) for v in minimum_image(torch.tensor([1.9, -1.9, 0.4], dtype=torch.float64), box).tolist()]
[-0.1, 0.1, 0.4]
>>> float(minimum_image(torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64), box)[0])  # half-box edge
1.0

A sheared cell that generates the same lattice as the cube above (b -> a+b)
gives the same minimum images:

>>> h = torch.tensor([[2.0, 0.0, 0.0], [2.0, 2.0, 0.0], [0.0, 0.0, 2.0]], dtype=torch.float64)
>>> [round(v, 6) for v in minimum_image(torch.tensor([1.9, -1.9, 0.4], dtype=torch.float64), h).tolist()]
[-0.1, 0.1, 0.4]
>>> float(box_volume(box)), float(box_volume(h))
(8.0, 8.0)
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import InputError


def is_triclinic(box) -> bool:
    """The box is a (3, 3) cell matrix."""
    return torch.as_tensor(box).ndim == 2


def cell_matrix(box: torch.Tensor) -> torch.Tensor:
    """(3, 3) cell matrix H (rows = lattice vectors) for either box form."""
    return torch.diag(box) if box.ndim == 1 else box


def _inv(box: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(box).inverse


def box_volume(box: torch.Tensor) -> torch.Tensor:
    """Cell volume [nm^3] for either box form."""
    if box.ndim == 1:
        return torch.prod(box)
    return torch.abs(torch.linalg.det(box))


def minimum_image(dx: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement; dx (..., 3), box (3,) or (3, 3).

    Orthorhombic: rounds half to even (``torch.round``, like
    ``jnp.round``) and multiplies by the reciprocal box, as the JAX package
    does. Triclinic: rounds in fractional coordinates."""
    if box.ndim == 1:
        return dx - box * torch.round(dx * (1.0 / box))
    s = torch.matmul(dx, _inv(box))
    return dx - torch.matmul(torch.round(s), box)


def wrap_positions(x: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Wrap positions into the primary cell."""
    if box.ndim == 1:
        return x - box * torch.floor(x / box)
    s = torch.matmul(x, _inv(box))
    return x - torch.matmul(torch.floor(s), box)


def pair_displacement(xi: torch.Tensor, xj: torch.Tensor, box: torch.Tensor):
    """Minimum-image displacement xi - xj, any broadcastable shapes (..., 3)."""
    return minimum_image(xi - xj, box)


def perp_widths(box: torch.Tensor) -> torch.Tensor:
    """(3,) perpendicular widths of the cell along each lattice direction.
    For a vector box these are the edge lengths; for a matrix box
    d_i = V / |a_j x a_k|, the distance between the two cell faces spanned
    by the other two lattice vectors. Cell-list sizing and the coverage
    guards use these: a sheared cell's faces are closer than its edges."""
    if box.ndim == 1:
        return box
    areas = torch.stack([
        torch.linalg.norm(torch.linalg.cross(box[1], box[2])),
        torch.linalg.norm(torch.linalg.cross(box[2], box[0])),
        torch.linalg.norm(torch.linalg.cross(box[0], box[1])),
    ])
    return box_volume(box) / areas


def host_widths(box) -> np.ndarray:
    """perp_widths of either box form (a tensor on any device, an array or
    a list) as a host float64 array."""
    if isinstance(box, torch.Tensor):
        box = box.detach().cpu()
    return perp_widths(torch.as_tensor(np.asarray(box, np.float64))).numpy()


def max_cutoff(box) -> float:
    """Largest cutoff the minimum-image convention supports: half the
    smallest perpendicular width of the cell (host-side helper)."""
    return 0.5 * float(host_widths(box).min())


def validate_cutoffs(system, box) -> None:
    """Enforce the minimum-image validity bound r_cut <= max_cutoff(box)
    for every cutoff force of the system (checked at Context construction
    and at every box a Context is given). A skewed cell's perpendicular
    widths lie far below its edge lengths, so a cutoff that looks safe by
    edge length could return non-minimum images."""
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
                f"max_cutoff(box) = {bound:.4f} nm (half the smallest "
                f"perpendicular width of the cell); shrink the cutoff or "
                f"use a larger box"
            )


def triclinic_from_lengths_angles(a, b, c, alpha, beta, gamma):
    """Reduced (3, 3) cell matrix (numpy) from lengths [nm] and angles
    [degrees] (the CRYST1 / AMBER box convention; a along x, b in the xy
    plane)."""
    al, be, ga = (np.radians(v) for v in (alpha, beta, gamma))
    bx, by = b * np.cos(ga), b * np.sin(ga)
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    h = np.array([[a, 0.0, 0.0], [bx, by, 0.0], [cx, cy, cz]])
    h[np.abs(h) < 1e-12] = 0.0
    return h
