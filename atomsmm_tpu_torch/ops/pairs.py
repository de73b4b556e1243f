"""Dense (all-pairs) nonbonded evaluator (counterpart of
atomsmm_tpu/ops/pairs.py) and the explicit pair-list sum that the exception
force uses, both torch operations on any device.

Chunked, masked evaluation of an arbitrary pair energy function with
exclusions; forces come from autograd. It is the path of a System without
a NeighborSpec and of NonbondedForce(method='nocutoff') (the JAX package
runs it under XLA on its device, so here PyTorch operations on the card
are its port), and the deterministic reference that the golden energies
and the cell-list path are checked against. A chunk of `chunk` rows holds
(chunk, N) intermediates (a few tens of MB at N = 4,096), and the autograd
graph keeps every chunk's until the backward pass.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .pbc import minimum_image


def dense_pair_energy(
    pair_fn: Callable,
    x: torch.Tensor,
    box: torch.Tensor,
    per_particle: Dict[str, torch.Tensor],
    exclusions: torch.Tensor,
    r_cut,
    chunk: int = 256,
) -> torch.Tensor:
    """Sum of pair_fn over all unique pairs with r < r_cut, minus exclusions.

    pair_fn(r, pi, pj) -> energy; per_particle maps names to (N,) parameter
    tensors; exclusions is the (N, M) symmetric table padded with -1.
    """
    n = x.shape[0]
    j_ids = torch.arange(n, device=x.device)[None, :]
    rc2 = torch.as_tensor(float(r_cut), dtype=x.dtype) ** 2
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        ii = torch.arange(lo, hi, device=x.device)
        dx = minimum_image(x[lo:hi, None, :] - x[None, :, :], box)
        r2 = torch.sum(dx * dx, dim=-1)
        mask = (j_ids > ii[:, None]) & (r2 < rc2)
        exc = exclusions[lo:hi]
        excluded = torch.any(j_ids[:, None, :] == exc[:, :, None], dim=1)
        mask &= ~excluded
        r = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
        pi = {k: v[lo:hi, None] for k, v in per_particle.items()}
        pj = {k: v[None, :] for k, v in per_particle.items()}
        e = pair_fn(r, pi, pj)
        total = total + torch.sum(torch.where(mask, e, torch.zeros_like(e)))
    return total


def pairlist_energy(
    pair_fn: Callable,
    x: torch.Tensor,
    box: torch.Tensor,
    pairs: torch.Tensor,
    pair_params: Dict[str, torch.Tensor],
    mask: torch.Tensor | None = None,
    rows: bool = False,
) -> torch.Tensor:
    """Sum pair_fn(r, params) over an explicit (P, 2) pair list with
    per-pair parameters, at the minimum image and with no cutoff.

    Used for exceptions (atomsmm/forces.py::NonbondedExceptionsForce).
    Padded entries are masked (mask False): pad indices with 0 and
    parameters with benign values. With `rows`, x is a stack (K, N, 3) and
    box (K, 3) or (K, 3, 3), and the result (K,).
    """
    pairs = pairs.long()
    # index_select: its backward pass is one index_add_
    dx = minimum_image(torch.index_select(x, -2, pairs[:, 0])
                       - torch.index_select(x, -2, pairs[:, 1]), box, rows)
    r2 = torch.sum(dx * dx, dim=-1)
    if mask is None:
        return torch.sum(pair_fn(torch.sqrt(r2), pair_params), dim=-1)
    r = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
    e = pair_fn(r, pair_params)
    return torch.sum(torch.where(mask, e, torch.zeros_like(e)), dim=-1)
