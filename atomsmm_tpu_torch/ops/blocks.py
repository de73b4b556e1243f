"""Atom-block neighbor lists (counterpart of atomsmm_tpu/ops/blocks.py): a
neighbor backend a System can carry in place of the cell lists.

  * atoms sort by the serpentine (boustrophedon) order of their fine-grid
    cell, so consecutive B-atom blocks are spatially compact and every home
    block but the last is full;
  * each home block lists its candidate blocks by periodic AABB distance
    (a block pair is kept when the gap between the two boxes is at most
    r_build), Newton at block level: only j >= i, each block pair once,
    each row cut to its first K (ascending, so the block itself comes
    first); a row with more than K is flagged, never silently cut short;
  * the sweep takes every home atom against every atom of its candidate
    blocks, minimum image per slot: the self block at energy weight 1/2
    without reaction (both orderings of each pair lie inside it), every
    other block at weight 1 with the reaction.

On the card the sweep is the hand-written kernel csrc/block_pair.cu (K4),
launched by ``block_pair_cuda``; on the CPU its plain twin
``block_pair_plain``, which writes the home and reaction sums back in
sorted space and unsorts them once, as the JAX package does. A user pair
function (CustomNonbondedForce) takes ``block_pair_energy_fn``: the same
slots as torch operations on any device, forces by autograd.

The lists are rebuilt as the cell buckets are (Context rebuilds after every
outer step, or every K-th under neighbor_update_every with the staleness
guard): valid while no atom moved more than skin/2 since the build. A
block list holds no stencil, so no box change can leave it undercovering.

What neither package's block path takes raises InputError: a (3, 3) box
(the serpentine sort and the AABBs wrap with edge lengths), a type-pair
table (NBFIX, the 10-12 term: the JAX sweep stages the LJ type as a float
column) and a spatial mesh (the JAX package sends the block order to the
cell-sharded sweep). A stack of K systems (x (K, N, 3)) builds one list a
row; its forces evaluate the rows one after another.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import InputError
from .neighbors import _host, moved_beyond_half_skin, split_exclusions
from .pair_kernel import (
    _PLAIN_SLOTS,
    _checked,
    _form_block,
    _launch,
    _rc2,
    excluded,
)
from .pairfuncs import form_u_dudr2
from .pbc import minimum_image


def _keys(name: str):
    prefix = "nbr" if name == "default" else f"nbr_{name}"
    return (
        f"{prefix}_order",     # (NB*B,) sorted atom ids, sentinel n padded
        f"{prefix}_cand",      # (NB, K) candidate block ids, -1 padded
        f"{prefix}_xref",
        f"{prefix}_boxref",
        f"{prefix}_overflow",
    )


@dataclasses.dataclass
class BlockNeighborSpec:
    """Static-shape block-list configuration (counterpart of NeighborSpec).
    The device of its tensors is the device the sweep runs on.

    The exclusion table is read as NeighborSpec reads it
    (NeighborSpec.exclusion_form): the relative-offset bitmask `excbits`
    where every excluded pair lies within +-14 atom indices, else that
    bitmask and each atom's far ids `exclusions_far`; both derive from
    `exclusions` when not given."""

    exclusions: torch.Tensor = None        # (N, M) int32, -1 padded
    r_build: float = 0.0                   # cutoff + skin
    skin: float = 0.0
    block_size: int = 64
    n_blocks: int = 1
    max_cand: int = 16                     # K
    block_chunk: int = 8                   # home blocks per plain-sweep chunk
    sort_grid: Tuple[int, int, int] = (8, 8, 8)
    excbits: torch.Tensor = None           # (N + 1,) int32
    exclusions_far: torch.Tensor = None    # (N, R) int32, 'split' form

    def __post_init__(self):
        if self.excbits is None and self.exclusions is not None:
            exc = self.exclusions
            bits, far = split_exclusions(exc.shape[0], exc.cpu().numpy())
            self.excbits = torch.as_tensor(bits, device=exc.device)
            self.exclusions_far = (None if far is None else
                                   torch.as_tensor(far, device=exc.device))

    @property
    def n_padded(self) -> int:
        return self.n_blocks * self.block_size

    @property
    def exclusion_form(self) -> str:
        """'bits' or 'split' (NeighborSpec.exclusion_form)."""
        return "bits" if self.exclusions_far is None else "split"


def _vector_box(box, rows: bool = False):
    """Raise InputError unless `box` holds edge lengths: (3,), or (K, 3)
    for a stack (`rows`)."""
    if box.ndim != (2 if rows else 1):
        raise InputError(
            "the block lists take a (3,) box: the serpentine sort and the "
            "block AABBs wrap with edge lengths, in the JAX package too; a "
            "(3, 3) cell runs on the cell lists (make_neighbor_spec)")


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


def _stacked(fn, x, box):
    """fn(x, box) -> tuple of tensors, over the rows of a stack (x (K, N,
    3), box (K, 3)) one after another, each output stacked on a new first
    axis; fn itself for a single system."""
    if x.ndim == 2:
        return fn(x, box)
    outs = [fn(xk, bk) for xk, bk in zip(x, box)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def build_block_lists(spec: BlockNeighborSpec, x, box):
    """(order, cand, overflow): serpentine-sort atoms, list candidate blocks
    by periodic AABB distance (Newton: j >= i only), each row its first K
    hits in ascending order (the block itself first), -1 padded; overflow
    (a device bool) where some row holds more than K. On the device of x.
    Over a stack (x (K, N, 3), box (K, 3)) each output gains a leading
    row axis, row k what row k alone gets."""
    _vector_box(box, x.ndim == 3)

    def one(x, box):
        nb = spec.n_blocks
        order, ctr, ext, empty = sorted_block_aabbs(
            x, box, spec.sort_grid, spec.block_size, nb, spec.n_padded)
        # periodic center distance minus extents, clamped at 0 per dim
        dc = torch.abs(minimum_image(ctr[:, None, :] - ctr[None, :, :], box))
        gap = torch.clamp(dc - ext[:, None, :] - ext[None, :, :], min=0.0)
        d2 = torch.sum(gap * gap, dim=-1)                    # (NB, NB)
        ids = torch.arange(nb, dtype=torch.int32, device=x.device)
        rb2 = torch.as_tensor(spec.r_build, dtype=x.dtype,
                              device=x.device) ** 2
        keep = ((d2 <= rb2) & (ids[None, :] >= ids[:, None])
                & ~empty[None, :] & ~empty[:, None])
        key = torch.where(keep, ids[None, :], torch.full_like(ids, nb))
        skey = torch.sort(key, dim=1).values[:, :spec.max_cand]
        cand = torch.where(skey < nb, skey, torch.full_like(skey, -1))
        overflow = torch.any(torch.sum(keep, dim=1) > spec.max_cand)
        return order, cand.to(torch.int32).contiguous(), overflow

    return _stacked(one, x, box)


def block_list_extras(spec, x, box,
                      name: str = "default") -> Dict[str, torch.Tensor]:
    ko, kc, kx, kbox, kov = _keys(name)
    order, cand, overflow = build_block_lists(spec, x, box)
    return {ko: order, kc: cand, kx: x, kbox: box, kov: overflow}


def needs_rebuild(spec, extra, x, box, name: str = "default"):
    """Some atom moved more than skin/2 since the reference build, or the
    box changed (a device bool; (K,) for a stack)."""
    _, _, kx, kbox, _ = _keys(name)
    return moved_beyond_half_skin(spec.skin, extra[kx], extra[kbox], x, box)


def update_blocks(spec, extra, x, box, name: str = "default",
                  force: bool = False):
    """Rebuild the lists and store x and box as the new reference.
    force=True rebuilds unconditionally, as Context does after every outer
    step and at the boundaries of grouped updates (a conditional skin/2
    rebuild would race the two-displacement staleness bound); otherwise the
    rebuilt entries replace the kept ones where needs_rebuild holds, chosen
    on the device (neighbors.update_neighbors). The overflow flag is
    sticky."""
    keys = _keys(name)
    ko, kc, kx, kbox, kov = keys
    order, cand, overflow = build_block_lists(spec, x, box)
    rebuilt = (order, cand, x, box, extra[kov] | overflow)
    if force:
        return dict(zip(keys, rebuilt))
    need = needs_rebuild(spec, extra, x, box, name)
    kept = tuple(extra[k] for k in keys)
    return {k: torch.where(need.reshape(need.shape + (1,) * (new.ndim
                                                             - need.ndim)),
                           new, old)
            for k, new, old in zip(keys, rebuilt, kept)}


def make_block_spec(
    box,
    n: int,
    r_cut_max: float,
    skin: float = 0.1,
    exclusions=None,
    block_size: int = 64,
    max_cand: int | None = None,
    occupancy_from=None,
    cand_safety: float = 1.25,
    block_chunk: int | None = None,
    device=None,
) -> BlockNeighborSpec:
    """Host-side setup. K (max candidate blocks per home block) comes from
    geometry, the Minkowski sum of the AABB-overlap cube (side 2 s, s the
    side of a block's volume) with a ball of radius r_build, halved by
    Newton, times a fragmentation margin of 2 for the snake-wrapped
    blocks, or from a measured configuration (`occupancy_from`, then
    retune_block_spec). The exclusion table lies on `device` (default: the
    CUDA card; without one pass device="cpu")."""
    from ..utils import resolve_device

    device = resolve_device(device)
    box = np.asarray(_host(box), np.float64)
    _vector_box(box)
    r_build = float(r_cut_max) + float(skin)
    nb = -(-n // block_size)
    rho = n / float(np.prod(box))
    side = (block_size / rho) ** (1.0 / 3.0)
    # serpentine sort grid: cells of roughly one block volume
    sort_grid = tuple(max(1, int(round(b / side))) for b in box)
    if max_cand is None:
        a = 2.0 * side
        vol = (
            a ** 3
            + 6.0 * a * a * r_build
            + 3.0 * math.pi * a * r_build ** 2
            + (4.0 / 3.0) * math.pi * r_build ** 3
        )
        est = vol * rho / block_size / 2.0
        frag = 2.0
        max_cand = int(math.ceil(est * max(cand_safety, 1.0) * frag)) + 4
    max_cand = min(max_cand, nb)
    exclusions = (np.full((n, 1), -1, np.int32) if exclusions is None
                  else _host(exclusions).astype(np.int32))
    if block_chunk is None:
        block_chunk = _chunk_for(nb, block_size, max_cand)
    spec = BlockNeighborSpec(
        exclusions=torch.as_tensor(exclusions, device=device),
        r_build=r_build,
        skin=float(skin),
        block_size=block_size,
        n_blocks=nb,
        max_cand=max_cand,
        block_chunk=block_chunk,
        sort_grid=sort_grid,
    )
    if occupancy_from is not None:
        spec = retune_block_spec(spec, occupancy_from, box, cand_safety)
    return spec


def _chunk_for(nb: int, b: int, k: int) -> int:
    per_blk = b * k * b * 4
    return max(1, min(nb, (48 << 20) // max(per_blk, 1)))


def retune_block_spec(spec: BlockNeighborSpec, x, box, safety: float = 1.25,
                      floor: int = 0):
    """Measure the real max candidate-block count at configuration x (the
    max over the rows of a stack) and resize K: ceil(count x safety) + 2,
    at least `floor` (overflow recovery passes the current K + 4, so that
    K only grows) and at most NB (the sweep's work scales linearly with
    K)."""
    dev = spec.excbits.device if spec.excbits is not None else None
    x = torch.as_tensor(x, device=dev)
    box = torch.as_tensor(box, dtype=x.dtype, device=x.device)
    wide = dataclasses.replace(spec, max_cand=spec.n_blocks)
    _, cand, _ = build_block_lists(wide, x, box)
    count = int(torch.max(torch.sum(cand >= 0, dim=-1)))
    k = min(max(int(math.ceil(count * safety)) + 2, floor), spec.n_blocks)
    return dataclasses.replace(
        spec, max_cand=k,
        block_chunk=_chunk_for(spec.n_blocks, spec.block_size, k))


# --------------------------------------------------------------------------
# The sweep: K4 and its plain twin
# --------------------------------------------------------------------------


def _refuse_table(form=None, per_particle=None):
    """Neither package's block sweep reads a type-pair table."""
    if (form is not None and form.table) or (
            per_particle is not None and "lj_type" in per_particle):
        raise InputError(
            "the block lists take no type-pair table (NBFIX, the 10-12 "
            "term): the JAX package's block sweep stages the LJ type as a "
            "float column and cannot gather the table either; such a "
            "system runs on the cell lists (make_neighbor_spec)")


def _block_chunks(spec, x, box, per_particle, order, cand, r_cut):
    """The slots of the sweep, a chunk of home blocks at a time, as torch
    operations on the device of x: yields (bi (C,) home blocks, hid (C, B)
    and cid (C, K B) atom ids (sentinel N), d (C, B, K B, 3) minimum-image
    displacements, mask (C, B, K B) of real, in-range, non-excluded slots,
    w_col (C, 1, K B) energy weights (1/2 in the self block), j_col
    (C, K B) reaction weights (0 in the self block and padding), pi and pj
    the per-particle columns of the home and candidate atoms)."""
    n = x.shape[0]
    b, nb, k = spec.block_size, spec.n_blocks, cand.shape[1]
    dev = x.device
    rc2 = _rc2(r_cut, x.dtype)
    xp = torch.cat([x, x.new_zeros((1, 3))])
    pp = {key: torch.cat([v, v.new_zeros((1,))])
          for key, v in per_particle.items()}
    ids = order.reshape(nb, b).long()
    bits = spec.excbits
    far = spec.exclusions_far
    if far is not None:
        far = torch.cat([far, far.new_full((1, far.shape[1]), -1)])
    chunk = max(1, min(spec.block_chunk, _PLAIN_SLOTS // (b * k * b)))
    for lo in range(0, nb, chunk):
        bi = torch.arange(lo, min(lo + chunk, nb), device=dev)
        c = bi.shape[0]
        hid = ids[bi]                                        # (C, B)
        cj = cand[bi].long()                                 # (C, K)
        valid = cj >= 0
        cjc = torch.where(valid, cj, torch.zeros_like(cj))
        cid = torch.where(valid[:, :, None], ids[cjc],
                          torch.full_like(ids[cjc], n)).reshape(c, k * b)
        d = minimum_image(xp[hid][:, :, None, :] - xp[cid][:, None, :, :], box)
        r2 = torch.sum(d * d, dim=-1)
        h3, c3 = hid[:, :, None], cid[:, None, :]
        mask = (h3 < n) & (c3 < n) & (r2 < rc2) & ~excluded(
            h3, c3, bits[hid][:, :, None],
            None if far is None else far[hid][:, :, None, :])
        is_self = (cjc == bi[:, None]) & valid               # (C, K)
        w_col = torch.where(is_self, 0.5, 1.0).to(x.dtype)
        w_col = w_col.repeat_interleave(b, dim=1)[:, None, :]
        j_col = (~is_self & valid).to(x.dtype).repeat_interleave(b, dim=1)
        pi = {key: v[hid][:, :, None] for key, v in pp.items()}
        pj = {key: v[cid][:, None, :] for key, v in pp.items()}
        yield bi, hid, cid, cj, d, r2, mask, w_col, j_col, pi, pj


def block_pair_plain(x, per_particle, order, cand, spec, box, form, r_cut,
                     with_forces: bool = True):
    """Plain PyTorch twin of K4 (the JAX package's ``block_pair_sums``):
    the per-atom (N + 1, 4) [fx fy fz e] (row N: the padding, zero). Each
    home atom takes the force of all its slots and the energy of its slots
    at weight 1/2 in the self block (both orderings of each pair lie inside
    it) and 1 elsewhere; the candidates of the other blocks take the
    reaction. The sums are written back in sorted space (a candidate
    block's atoms lie at sorted rows j B ... j B + B - 1) and unsorted once.
    Exclusions in the spec's form. Home blocks run `spec.block_chunk` at a
    time, fewer where a chunk would exceed 2M pair slots."""
    _refuse_table(form, per_particle)
    n = x.shape[0]
    b, nb = spec.block_size, spec.n_blocks
    dev = x.device
    within = torch.arange(b, device=dev)
    f_sorted = x.new_zeros((nb * b + b, 4))
    for bi, _, _, cj, d, r2, mask, w_col, j_col, pi, pj in _block_chunks(
            spec, x, box, per_particle, order, cand, r_cut):
        r2m = torch.where(mask, r2, torch.ones_like(r2))
        u, dudr2 = form_u_dudr2(form, r2m, pi["charge"] * pj["charge"],
                                0.5 * (pi["sigma"] + pj["sigma"]),
                                torch.sqrt(pi["epsilon"] * pj["epsilon"]))
        zero = torch.zeros_like(u)
        home = x.new_zeros(bi.shape + (b, 4))
        home[..., 3] = torch.sum(torch.where(mask, u, zero) * w_col, dim=-1)
        home_rows = (bi[:, None] * b + within).reshape(-1)
        if with_forces:
            g = torch.where(mask, 2.0 * dudr2, zero)[..., None] * d
            home[..., :3] = -torch.sum(g, dim=2)
            react = torch.sum(g, dim=1) * j_col[..., None]     # (C, K B, 3)
            blk = torch.where(cj >= 0, cj, torch.full_like(cj, nb))
            tgt = (blk[:, :, None] * b + within).reshape(-1)
            f_sorted.index_add_(0, tgt, torch.nn.functional.pad(
                react, (0, 1)).reshape(-1, 4))
        f_sorted.index_add_(0, home_rows, home.reshape(-1, 4))
    rows = x.new_zeros((n + 1, 4))
    rows.index_add_(0, order.long(), f_sorted[:nb * b])
    rows[n] = 0.0
    return rows


def block_pair_energy_fn(pair_fn, x, box, per_particle, spec, order, cand,
                         r_cut):
    """Sum of a Python pair function pair_fn(r, pi, pj) over the block
    list, as torch operations on the device of x (the slots and weights of
    block_pair_plain); differentiable in x, so forces come by autograd.
    per_particle holds any (N,) tensors, gathered into pi / pj. The path
    for user expressions (CustomNonbondedForce), which no hand-written
    kernel can take, as neighbors.cell_pair_energy_fn is on the cells."""
    from .rv import pair_eval

    _vector_box(box)
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for _, _, _, _, _, r2, mask, w_col, _, pi, pj in _block_chunks(
            spec, x, box, per_particle, order, cand, r_cut):
        r2m = torch.where(mask, r2, torch.ones_like(r2))
        u, _ = pair_eval(pair_fn, r2m, pi, pj, with_tangent=False)
        total = total + torch.sum(torch.where(mask, u, torch.zeros_like(u))
                                  * w_col)
    return total


#: K4's frame test: a home block's frame needs no per-slot image where
#: E_d + r_c < (1/2 - FRAME_MARGIN) L_d in every dimension
FRAME_MARGIN = 1e-4


def packed_order(x, box, order, block_size):
    """The atom order of K4's packed copy (csrc/block_pair.cu, the pack
    kernel), in plain PyTorch: `order` (NB*B,) with each block's atoms
    ordered by a serpentine walk of a 4^3 grid over the block's own box
    (the atoms imaged next to the block's first atom), padding last, ties
    in list order, so that 8 consecutive atoms are compact. The kernel
    computes the same keys in its working type; a key that rounds the
    other way at a cell boundary moves an atom to a neighbouring group,
    which changes no sum."""
    n = x.shape[0]
    ids = order.reshape(-1, block_size).long()
    real = ids < n
    xp = torch.cat([x, x.new_zeros((1, 3))])
    ref = xp[ids[:, :1]]
    local = ref + minimum_image(xp[ids] - ref, box)
    big = torch.as_tensor(1e30, dtype=x.dtype, device=x.device)
    lo = torch.where(real[..., None], local, big).amin(dim=1, keepdim=True)
    hi = torch.where(real[..., None], local, -big).amax(dim=1, keepdim=True)
    span = hi - lo
    scale = torch.where(span > 0, 4.0 / torch.where(span > 0, span, 1.0),
                        torch.zeros_like(span))
    c = torch.clamp(((local - lo) * scale).to(torch.int64), 0, 3)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    ey = torch.where(cx % 2 == 1, 3 - cy, cy)
    row = cx * 4 + ey
    ez = torch.where(row % 2 == 1, 3 - cz, cz)
    key = torch.where(real, row * 4 + ez, torch.full_like(row, 64))
    perm = torch.argsort(key, dim=1, stable=True)
    return torch.gather(ids, 1, perm).reshape(-1).to(order.dtype)


def block_frames(x, box, ids, r_cut):
    """K4's frame of each home block, in plain PyTorch: (ctr (NB, 3),
    staged (NB, B, 3), exact (NB,)). A block's atoms `ids` (NB, B), in list
    order as the pack kernel reads them (sentinel N for padding), are
    imaged next to the first, the frame's centre `ctr` is the middle of
    their box, and every atom the block meets is staged at
    ctr + minimum_image(x - ctr). With
    E_d the largest |staged - ctr|_d over the block's atoms, `exact` holds
    where E_d + r_cut < (1/2 - FRAME_MARGIN) L_d in every dimension: a
    pair within r_cut of a home atom then lies within L_d / 2 of ctr, so
    its staged displacement is the minimum image, and a pair out of range
    stays out. K4 then tests slots and group boxes without an image."""
    n = x.shape[0]
    real = ids < n
    xp = torch.cat([x, x.new_zeros((1, 3))])
    xs = xp[ids.long()]
    ref = xs[:, :1]
    local = ref + minimum_image(xs - ref, box)
    big = torch.as_tensor(1e30, dtype=x.dtype, device=x.device)
    lo = torch.where(real[..., None], local, big).amin(dim=1)
    hi = torch.where(real[..., None], local, -big).amax(dim=1)
    ctr = 0.5 * (lo + hi)
    staged = ctr[:, None] + minimum_image(xs - ctr[:, None], box)
    ext = torch.where(real[..., None], (staged - ctr[:, None]).abs(),
                      torch.zeros_like(staged)).amax(dim=1)
    exact = torch.all(ext + r_cut < (0.5 - FRAME_MARGIN) * box, dim=1)
    return ctr, staged, exact


def block_pair_cuda(x, per_particle, order, cand, spec, box, form, r_cut):
    """Launch K4 on PyTorch's current stream over the (NB, K) candidate
    list; returns the per-atom (N + 1, 4) [fx fy fz e], allocated and
    zeroed here (a pair's energy sits whole on its home atom; the self
    block takes each pair once, with its reaction). Checks device, dtype,
    shape and contiguity first and raises if the launch is refused. The
    spec's exclusion form selects the kernel's (the bitmask, or the
    bitmask and the far ids). The C entry point runs the pack kernel and
    K4: the output's zero fill also zeroes their counters (a row past the
    (N + 1, 4) rows returned, read by k4_tested_pairs), and the packed copy
    and the work list are scratch, so a sweep is the fill, the two kernels
    and the caller's energy sum."""
    import ctypes

    _vector_box(box)
    _refuse_table(form, per_particle)
    n = x.shape[0]
    nb, b = spec.n_blocks, spec.block_size
    k = cand.shape[1]
    bits, far = spec.excbits, spec.exclusions_far
    m = 0 if far is None else far.shape[1]
    q, sig, eps = (per_particle[key] for key in ("charge", "sigma", "epsilon"))
    exc = [("excbits", bits, torch.int32, (n + 1,))]
    if far is not None:
        exc.append(("far exclusions", far, torch.int32, (n, m)))
    dev = _checked("block_pair",
                   ("x", x, x.dtype, (n, 3)),
                   ("charge", q, x.dtype, (n,)),
                   ("sigma", sig, x.dtype, (n,)),
                   ("epsilon", eps, x.dtype, (n,)), *exc,
                   ("order", order, torch.int32, (nb * b,)),
                   ("cand", cand, torch.int32, (nb, k)),
                   ("box", box, x.dtype, (3,)))
    if not 1 <= b <= 128:
        raise ValueError(f"block_pair: block size {b} outside the kernel's "
                         "1..128 (one thread per home atom)")
    out = torch.zeros((n + 2, 4), dtype=x.dtype, device=dev)
    packed = torch.empty((nb, 2 * b + 2, 4), dtype=x.dtype, device=dev)
    work = torch.empty((2 * nb * k + nb + 1,), dtype=torch.int32, device=dev)
    scal, flags = _form_block(form, r_cut, x.dtype)
    _launch("block_pair", x.dtype, x.data_ptr(), q.data_ptr(),
            sig.data_ptr(), eps.data_ptr(), bits.data_ptr(),
            None if far is None else far.data_ptr(), order.data_ptr(),
            cand.data_ptr(), box.data_ptr(), n, nb, b, k, m,
            ctypes.addressof(scal), ctypes.addressof(flags), out.data_ptr(),
            packed.data_ptr(), work.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return out[:n + 1]


def k4_tested_pairs(rows) -> int:
    """The (home atom, 8-atom group) pairs that K4 tested in the sweep
    whose rows block_pair_cuda returned: its third counter, in the row
    past those rows. A host read, for measurements."""
    full = rows.new_empty(0).set_(rows.untyped_storage(),
                                  rows.storage_offset(),
                                  (rows.shape[0] + 1, 4))
    return int(full[-1].view(torch.int32)[2])


def block_pair_rows(form, x, box, per_particle, spec, order, cand, r_cut,
                    with_forces: bool = True):
    """The per-atom (N + 1, 4) rows of the sweep: K4 for a CUDA tensor, its
    plain twin for a CPU tensor."""
    _vector_box(box)
    _refuse_table(form, per_particle)
    if x.is_cuda:
        pp = {key: v.contiguous() for key, v in per_particle.items()}
        return block_pair_cuda(x.contiguous(), pp, order, cand, spec,
                               box.contiguous(), form, r_cut)
    return block_pair_plain(x, per_particle, order, cand, spec, box, form,
                            r_cut, with_forces)


def block_pair_energy_forces(form, x, box, per_particle, spec, order, cand,
                             r_cut):
    """(energy, forces (N, 3)) over the block list: K4 on the card, its
    plain twin on the CPU. `form` is the built-in pair form
    (ops/pairfuncs.py::PairForm)."""
    rows = block_pair_rows(form, x, box, per_particle, spec, order, cand,
                           r_cut)
    return rows[:, 3].sum(), rows[:-1, :3]


def block_pair_energy(form, x, box, per_particle, spec, order, cand, r_cut):
    """The energy over the block list (the sweep's energy column)."""
    rows = block_pair_rows(form, x, box, per_particle, spec, order, cand,
                           r_cut, with_forces=False)
    return rows[:, 3].sum()
