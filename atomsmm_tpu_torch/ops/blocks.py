"""Serpentine atom blocks (counterpart of the prologue of
atomsmm_tpu/ops/blocks.py, the part the tile-pair list shares).

Atoms sort by the serpentine (boustrophedon) order of their fine-grid cell,
so consecutive B-atom blocks are spatially compact, and each block gets a
periodic axis-aligned bounding box. The row-tile lists of the JAX module
(``BlockNeighborSpec``, ``build_block_lists``) are an experimental alternate
that is not ported.
"""
from __future__ import annotations

import torch


def _serpentine_key(xw, box, grid):
    """Boustrophedon cell ordering: walk z, flip direction each z-row, flip y
    each x-plane, so consecutive cells are always spatially adjacent and
    blocks cut from the sorted order have bounded AABBs. xw are wrapped
    coordinates in [0, box)."""
    gx, gy, gz = grid
    g = torch.as_tensor(grid, dtype=xw.dtype, device=xw.device)
    hi = torch.as_tensor(grid, dtype=torch.int32, device=xw.device) - 1
    c = torch.minimum(torch.clamp((xw * (g / box)).to(torch.int32), min=0), hi)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    ey = torch.where(cx % 2 == 1, gy - 1 - cy, cy)
    row = cx * gy + ey
    ez = torch.where(row % 2 == 1, gz - 1 - cz, cz)
    return (row * gz + ez).to(torch.int32)


def sorted_block_aabbs(x, box, sort_grid, block_size, n_blocks, n_padded):
    """Serpentine-sort atoms, cut consecutive blocks, and compute per-block
    AABBs from wrapped coordinates. Returns (order (n_padded,) int32 with
    sentinel N, ctr (NB, 3), ext (NB, 3), empty (NB,)). The sort is stable,
    as JAX's argsort is, so ties keep index order."""
    n = x.shape[0]
    xw = x - box * torch.floor(x * (1.0 / box))
    order = torch.argsort(_serpentine_key(xw, box, sort_grid),
                          stable=True).to(torch.int32)
    order = torch.cat([order, order.new_full((n_padded - n,), n)])

    xw_pad = torch.cat([xw, xw.new_zeros((1, 3))])
    xs = xw_pad[order.long()].reshape(n_blocks, block_size, 3)
    real = (order < n).reshape(n_blocks, block_size, 1)
    big = torch.as_tensor(1e30, dtype=x.dtype, device=x.device)
    lo = torch.min(torch.where(real, xs, big), dim=1).values      # (NB, 3)
    hi = torch.max(torch.where(real, xs, -big), dim=1).values
    empty = ~torch.any(real, dim=1)[:, 0]
    ctr = 0.5 * (lo + hi)
    ext = 0.5 * (hi - lo)
    return order, ctr, ext, empty
