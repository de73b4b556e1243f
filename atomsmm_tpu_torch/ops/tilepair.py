"""Flat tile-pair nonbonded sweep (counterpart of atomsmm_tpu/ops/tilepair.py):
the tile-list builder, the wrapper of the CUDA kernel csrc/tile_pair.cu (K3)
and its plain PyTorch twin. A standalone entry point: Context does not
dispatch it, and a TilePairSpec attached to a System raises.

The tile list is the NAMD/OpenMM-GPU formulation of the pair sweep:

  * atoms sort by serpentine cell key (ops/blocks.py); consecutive B-atom
    home blocks are dense by construction;
  * a flat list of Newton block pairs (i <= j, periodic AABB gap <=
    r_build) is built on the device, two candidate blocks per entry, so
    each entry is one dense (B, 2B) pair tile and the total work follows
    the sum of candidate counts, not NB x K_max;
  * per-entry integer wrap vectors (from the AABB centres at build time)
    replace the per-slot minimum image, so positions must be staged
    continuously relative to the build reference (pass xref; see _stage);
  * exclusions and self pairs are one relative-offset bitmask op (excluded
    pairs within +-14 atom indices, checked at setup); sentinel slots carry
    coordinates poisoned at 1e4 nm.

K3 runs one thread block per entry: it culls the tile by the bounding boxes
of its 32-candidate groups, tests what is left with its lanes across the
candidates, evaluates the hits 32 at a time and adds its home and reaction
sums to one accumulator with global atomics (csrc/tile_pair.cu says what
that means for summation order). On a CUDA tensor the wrapper launches it or raises;
on a CPU tensor it runs the plain twin, ``tile_pair_plain``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .blocks import sorted_block_aabbs
from .neighbors import _host, make_exclusion_bits, moved_beyond_half_skin
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

POISON = 1.0e4        # sentinel coordinate [nm]


def _keys(name: str):
    prefix = "nbr" if name == "default" else f"nbr_{name}"
    return (
        f"{prefix}_order",     # (NB*B,) int32 sorted atom ids, sentinel n
        f"{prefix}_hb",        # (E,) int32 home block per entry, sentinel NB
        f"{prefix}_cb",        # (E, 2) int32 candidate blocks, sentinel NB
        f"{prefix}_wrap",      # (E, 2, 3) int32 periodic wrap per half
        f"{prefix}_xref",
        f"{prefix}_boxref",
        f"{prefix}_overflow",
    )


@dataclasses.dataclass
class TilePairSpec:
    """Static-shape flat tile-pair configuration. The device of excbits is
    the device the sweep runs on."""

    excbits: torch.Tensor = None     # (N+1,) int32 relative-offset exclusion bits
    r_build: float = 0.0             # cutoff + skin
    skin: float = 0.0
    block_size: int = 64
    n_blocks: int = 1
    max_entries: int = 1             # E
    sort_grid: Tuple[int, int, int] = (8, 8, 8)
    multi_image: bool = False

    @property
    def n_padded(self) -> int:
        return self.n_blocks * self.block_size


def _check_vector_box(box):
    """The tile list and K3 take (3,) boxes: the JAX package's tile list
    has no triclinic form either."""
    if box.ndim != 1:
        from ..utils import InputError

        raise InputError("the tile list and K3 take (3,) boxes; a (3, 3) "
                         "cell runs on the cell lists (make_neighbor_spec)")


def _check_no_table(form=None, per_particle=None):
    """The tile list and K3 combine by Lorentz-Berthelot only: no Context
    path runs them in either package, and their staging has no type
    column. A table form (NBFIX, the 10-12 term) runs on the cell lists
    (K1 and K2)."""
    if (form is not None and form.table) or (
            per_particle is not None and "lj_type" in per_particle):
        from ..utils import InputError

        raise InputError("the tile list and K3 take no type-pair table "
                         "(NBFIX, the 10-12 term); such a system runs on "
                         "the cell lists (make_neighbor_spec)")


def make_tilepair_spec(
    box,
    n: int,
    r_cut_max: float,
    skin: float = 0.1,
    exclusions=None,
    block_size: int = 64,
    max_entries: int | None = None,
    occupancy_from=None,
    entry_safety: float = 1.25,
    multi_image: bool | None = None,
    device=None,
) -> TilePairSpec:
    """Host-side setup. The entry budget E comes from the Minkowski volume of
    a block (exact for cubic blocks) times a fragmentation margin, or, much
    tighter, from a measured configuration (`occupancy_from`).

    multi_image=None auto-selects: small boxes (where one block pair can
    reach through two periodic images) enumerate all 27 image offsets; large
    boxes use the per-pair nearest image. Raises ValueError when an excluded
    pair spans more than +-14 atom indices (the bitmask cannot hold it).
    The bitmask lies on `device` (default: the CUDA card; without one pass
    device="cpu")."""
    from ..utils import resolve_device

    device = resolve_device(device)
    box = np.asarray(_host(box), np.float64)
    _check_vector_box(box)
    r_build = float(r_cut_max) + float(skin)
    nb = -(-n // block_size)
    rho = n / float(np.prod(box))
    side = (block_size / rho) ** (1.0 / 3.0)
    sort_grid = tuple(max(1, int(round(b / side))) for b in box)
    if multi_image is None:
        # block AABBs span up to ~2 sort cells -> ext_sum <= ~4 sides; the
        # build's `second` flag backstops this heuristic
        multi_image = bool(float(np.min(box)) < 4.0 * side + 2.0 * r_build)
    if exclusions is None:
        exclusions = np.full((n, 1), -1, np.int32)
    if max_entries is None:
        a = side
        vol = (
            a ** 3
            + 6.0 * a * a * r_build
            + 3.0 * math.pi * a * r_build ** 2
            + (4.0 / 3.0) * math.pi * r_build ** 3
        )
        pairs = nb * (vol * rho / block_size) / 2.0
        frag = 1.8
        max_entries = int(math.ceil(pairs / 2.0 * entry_safety * frag)) + nb
    spec = TilePairSpec(
        excbits=torch.as_tensor(make_exclusion_bits(n, _host(exclusions)),
                                device=device),
        r_build=r_build,
        skin=float(skin),
        block_size=block_size,
        n_blocks=nb,
        max_entries=max_entries,
        sort_grid=sort_grid,
        multi_image=multi_image,
    )
    if occupancy_from is not None:
        x = torch.as_tensor(occupancy_from)
        spec = retune_tilepair_spec(
            spec, x, torch.as_tensor(box, dtype=x.dtype, device=x.device),
            entry_safety)
    return spec


def _block_geometry(spec: TilePairSpec, x, box):
    """(order, ctr, ext, empty): sorted atom ids + per-block periodic AABBs."""
    return sorted_block_aabbs(x, box, spec.sort_grid, spec.block_size,
                              spec.n_blocks, spec.n_padded)


def _wrap_set(spec: TilePairSpec):
    """Candidate image offsets. Single-image mode ([None]) uses the per-pair
    nearest-image wrap, valid when no block pair can be in range through two
    images at once (checked at build via the safety flag). Multi-image mode
    enumerates all 27 offsets (small boxes; exact whenever the minimum-image
    convention itself holds, box/2 > r_cut)."""
    if not spec.multi_image:
        return [None]
    return [(wx, wy, wz) for wx in (-1, 0, 1) for wy in (-1, 0, 1)
            for wz in (-1, 0, 1)]


def _acceptance(spec: TilePairSpec, x, box):
    """(order, keep (NB, NB, W), wvec_single, second): the Newton block-pair
    acceptance tensor over the image-offset set."""
    nb = spec.n_blocks
    order, ctr, ext, empty = _block_geometry(spec, x, box)
    dtype, dev = x.dtype, x.device

    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    r_build = torch.as_tensor(spec.r_build, dtype=dtype, device=dev)
    rb2 = r_build ** 2
    ext_sum = ext[:, None, :] + ext[None, :, :]
    dc_raw = ctr[:, None, :] - ctr[None, :, :]
    valid = ~empty[None, :] & ~empty[:, None]

    keeps = []
    wvec_single = None
    for w in _wrap_set(spec):
        if w is None:
            wvec_single = torch.round(dc_raw / box).to(torch.int32)
            d = dc_raw - wvec_single.to(dtype) * box
            newton = ids[None, :] >= ids[:, None]
        else:
            d = dc_raw - torch.as_tensor(w, dtype=dtype, device=dev) * box
            if w >= (0, 0, 0):
                newton = ids[None, :] >= ids[:, None]
            else:
                # lex-negative wraps: the (j, i, -w) twin is lex-positive
                newton = ids[None, :] > ids[:, None]
        gap = torch.clamp(torch.abs(d) - ext_sum, min=0.0)
        d2 = torch.sum(gap * gap, dim=-1)
        keeps.append((d2 <= rb2) & newton & valid)
    keep = torch.stack(keeps, dim=2)                  # (NB, NB, W)

    if not spec.multi_image:
        # single-image safety: some kept pair could also reach through a
        # second image in some dim -> rebuild the spec with multi_image=True
        d_min = torch.abs(dc_raw - torch.round(dc_raw / box) * box)
        slack = (box - d_min - ext_sum) - r_build
        inf = torch.full_like(slack, math.inf)
        second = torch.min(torch.where(keep[:, :, 0, None], slack, inf)) <= 0.0
    else:
        second = torch.zeros((), dtype=torch.bool, device=dev)
    return order, keep, wvec_single, second


def build_tile_pairs(spec: TilePairSpec, x, box):
    """(order, hb, cb, wrap, overflow): flat Newton block-pair list, two
    candidate blocks packed per entry, grouped by home block, built on the
    device of x. Unused entries have hb = cb = NB and zero wrap.

    overflow (a device bool) also encodes the single-image safety violation
    (a block pair that could reach through two images: rebuild the spec
    with multi_image=True)."""
    nb = spec.n_blocks
    e_max = spec.max_entries
    wraps = _wrap_set(spec)
    nw = len(wraps)
    dev = x.device
    i32, i64 = torch.int32, torch.int64
    ids = torch.arange(nb, dtype=i64, device=dev)
    order, keep, wvec_single, second = _acceptance(spec, x, box)

    counts = torch.sum(keep, dim=(1, 2))                          # (NB,)
    starts = torch.cumsum(counts, 0) - counts
    ecounts = (counts + 1) // 2
    estarts = torch.cumsum(ecounts, 0) - ecounts
    overflow = (torch.sum(ecounts) > e_max) | second

    big = nb * nb * nw
    flat_id = (ids[:, None, None] * (nb * nw) + ids[None, :, None] * nw
               + torch.arange(nw, dtype=i64, device=dev)[None, None, :])
    key = torch.where(keep, flat_id, torch.full_like(flat_id, big)).reshape(-1)
    skey = torch.sort(key).values                                 # (NB^2 W,)
    live = skey < big
    i_of = torch.where(live, skey // (nb * nw), nb)
    rem = torch.where(live, skey % (nb * nw), 0)
    j_of = torch.where(live, rem // nw, nb)
    w_of = rem % nw

    p = torch.arange(skey.shape[0], dtype=i64, device=dev)
    i_c = torch.clamp(i_of, 0, nb - 1)
    prow = p - starts[i_c]
    ent = torch.where(live, estarts[i_c] + prow // 2, e_max)
    ent = torch.where(ent < e_max, ent, e_max)         # overflow -> dropped row
    half = prow % 2

    hb = torch.full((e_max + 1,), nb, dtype=i32, device=dev)
    cb = torch.full((e_max + 1, 2), nb, dtype=i32, device=dev)
    hb[ent] = torch.where(live, i_of, nb).to(i32)
    cb[ent, half] = torch.where(live, j_of, nb).to(i32)

    if spec.multi_image:
        wv = torch.as_tensor(wraps, dtype=i32, device=dev)[w_of]
    else:
        wv = wvec_single.reshape(-1, 3)[torch.clamp(skey, 0, nb * nb - 1)]
    wrap = torch.zeros((e_max + 1, 2, 3), dtype=i32, device=dev)
    wrap[ent, half] = torch.where(live[:, None], wv, torch.zeros_like(wv))
    return (order, hb[:e_max].contiguous(), cb[:e_max].contiguous(),
            wrap[:e_max].contiguous(), overflow)


def retune_tilepair_spec(spec: TilePairSpec, x, box, safety: float = 1.25):
    """Measure the real entry count for configuration x and resize E
    (switching to multi-image mode when the single-image wrap is unsafe)."""
    x = torch.as_tensor(x)
    box = torch.as_tensor(box, device=x.device)
    _, keep, _, second = _acceptance(spec, x, box)
    if bool(second):
        spec = dataclasses.replace(spec, multi_image=True)
        _, keep, _, _ = _acceptance(spec, x, box)
    counts = torch.sum(keep, dim=(1, 2))
    total = int(torch.sum((counts + 1) // 2))
    return dataclasses.replace(spec,
                               max_entries=int(math.ceil(total * safety)) + 8)


def tilepair_extras(spec, x, box, name: str = "default") -> Dict[str, torch.Tensor]:
    ko, kh, kc, kw, kx, kbox, kov = _keys(name)
    order, hb, cb, wrap, overflow = build_tile_pairs(spec, x, box)
    return {ko: order, kh: hb, kc: cb, kw: wrap, kx: x, kbox: box,
            kov: overflow}


def needs_rebuild(spec, extra, x, box, name: str = "default"):
    _, _, _, _, kx, kbox, _ = _keys(name)
    return moved_beyond_half_skin(spec.skin, extra[kx], extra[kbox], x, box)


def update_tile_pairs(spec, extra, x, box, name: str = "default"):
    """Rebuild the list when some atom moved more than skin/2 since the
    build (or the box changed), else keep it. The predicate is read on the
    host, one device sync per call; the overflow flag is sticky."""
    keys = _keys(name)
    ko, kh, kc, kw, kx, kbox, kov = keys
    if not bool(needs_rebuild(spec, extra, x, box, name)):
        return {k: extra[k] for k in keys}
    order, hb, cb, wrap, overflow = build_tile_pairs(spec, x, box)
    return {ko: order, kh: hb, kc: cb, kw: wrap, kx: x, kbox: box,
            kov: extra[kov] | overflow}


# --------------------------------------------------------------------------
# Evaluation: K3 and its plain twin
# --------------------------------------------------------------------------


def _stage(spec, x, box, per_particle, excbits, order, xref=None):
    """Sorted block-major staging: fs (NB+1, B, 8) [x y z q sigma eps 0 0]
    and ms (NB+1, B, 2) int32 [atom id, exclusion bits], the sentinel block
    NB and padding slots at the poison coordinate.

    Coordinates must live in the same periodic image the tile list was built
    in (the per-entry wrap vectors come from build-time AABB centres).
    Wrapping the current positions breaks that whenever an atom crosses a
    box face between rebuilds: it teleports by a box length while its block
    assignment is stale. With `xref` (the build-time reference positions)
    each atom is staged at wrap(xref) + min_image(x - xref): continuous
    across faces, exact for displacements < box/2 (the skin/2 reuse window
    is far tighter). xref=None wraps x directly, valid only at the build
    configuration."""
    _check_no_table(per_particle=per_particle)
    n = x.shape[0]
    b = spec.block_size
    nb = spec.n_blocks
    if xref is None:
        xw = x - box * torch.floor(x * (1.0 / box))
    else:
        xref_w = xref - box * torch.floor(xref * (1.0 / box))
        xw = xref_w + minimum_image(x - xref, box)
    feats = x.new_zeros((n + 1, 8))
    feats[:n, :3] = xw
    feats[:n, 3] = per_particle["charge"]
    feats[:n, 4] = per_particle["sigma"]
    feats[:n, 5] = per_particle["epsilon"]
    feats[n, :3] = POISON
    idx = order.long()
    fs = torch.cat([feats[idx].reshape(nb, b, 8),
                    feats[n].expand(1, b, 8)])
    meta = torch.zeros((n + 1, 2), dtype=torch.int32, device=x.device)
    meta[:, 0] = torch.arange(n + 1, dtype=torch.int32, device=x.device)
    meta[:, 1] = excbits
    ms = torch.cat([meta[idx].reshape(nb, b, 2), meta[n].expand(1, b, 2)])
    return fs.contiguous(), ms.contiguous()


def tile_pair_plain(fs, ms, hb, cb, wrap, box, form, r_cut,
                    chunk: int | None = None):
    """Plain PyTorch twin of K3 (the JAX package's ``_tile_xla_eval``):
    the same inputs and the same (NB+1, B, 4) accumulator [fx fy fz e] of
    home sums plus reaction sums, with the kernel's masks, weights and wrap
    shifts. Entries run `chunk` at a time (default: 2M pair slots)."""
    nb1, b, _ = fs.shape
    rc2 = _rc2(r_cut, fs.dtype)
    chunk = chunk or max(1, _PLAIN_SLOTS // (2 * b * b))
    acc = fs.new_zeros((nb1, b, 4))
    for lo in range(0, hb.shape[0], chunk):
        h = hb[lo:lo + chunk].long()                     # (K,)
        c = cb[lo:lo + chunk].long()                     # (K, 2)
        w = wrap[lo:lo + chunk]                          # (K, 2, 3)
        k = h.shape[0]
        home = fs[h][:, :, None, :]                      # (K, B, 1, 8)
        shift = w.to(fs.dtype) * box                     # (K, 2, 3)
        cand = fs[c].clone()                             # (K, 2, B, 8)
        cand[..., :3] = cand[..., :3] + shift[:, :, None, :]
        cand = cand.reshape(k, 1, 2 * b, 8)
        oid_h = ms[h][..., 0][:, :, None]                # (K, B, 1)
        exc_h = ms[h][..., 1][:, :, None]
        oid_c = ms[c][..., 0].reshape(k, 1, 2 * b)       # (K, 1, 2B)
        d = home[..., :3] - cand[..., :3]                # (K, B, 2B, 3)
        r2 = torch.sum(d * d, dim=-1)
        mask = (r2 < rc2) & ~excluded(oid_h, oid_c, exc_h)
        self_half = (c == h[:, None]) & torch.all(w == 0, dim=-1)   # (K, 2)
        w_col = torch.where(self_half, 0.5, 1.0).to(fs.dtype)
        w_col = w_col.repeat_interleave(b, dim=1)[:, None, :]       # (K, 1, 2B)
        j_col = (~self_half).to(fs.dtype).repeat_interleave(b, dim=1)
        r2m = torch.where(mask, r2, torch.ones_like(r2))
        qq = home[..., 3] * cand[..., 3]
        sig = 0.5 * (home[..., 4] + cand[..., 4])
        eps = torch.sqrt(home[..., 5] * cand[..., 5])
        u, dudr2 = form_u_dudr2(form, r2m, qq, sig, eps)
        zero = torch.zeros_like(u)
        e_row = torch.sum(torch.where(mask, u, zero) * w_col, dim=-1)  # (K, B)
        g = torch.where(mask, 2.0 * dudr2, zero)[..., None] * d
        f_home = torch.cat([-torch.sum(g, dim=2), e_row[..., None]], dim=-1)
        rows = torch.sum(g, dim=1) * j_col[..., None]    # (K, 2B, 3)
        rows = torch.cat([rows, rows.new_zeros(rows.shape[:2] + (1,))], -1)
        acc.index_add_(0, h, f_home)
        acc.index_add_(0, c[:, 0], rows[:, :b])
        acc.index_add_(0, c[:, 1], rows[:, b:])
    return acc


def tile_pair_cuda(fs, ms, hb, cb, wrap, box, form, r_cut):
    """Launch K3 on PyTorch's current stream; returns the (NB+1, B, 4)
    accumulator [fx fy fz e] allocated (zeroed) here. Checks device,
    dtype, shape and contiguity first and raises if the launch is
    refused."""
    import ctypes

    _check_vector_box(box)
    _check_no_table(form)
    nb1, b, _ = fs.shape
    e = hb.shape[0]
    dev = _checked("tile_pair",
                   ("fs", fs, fs.dtype, (nb1, b, 8)),
                   ("ms", ms, torch.int32, (nb1, b, 2)),
                   ("hb", hb, torch.int32, (e,)),
                   ("cb", cb, torch.int32, (e, 2)),
                   ("wrap", wrap, torch.int32, (e, 2, 3)),
                   ("box", box, fs.dtype, (3,)))
    if not 1 <= b <= 128:
        raise ValueError(f"tile_pair: block size {b} outside the kernel's "
                         "1..128 (one lane per home atom)")
    acc = torch.zeros((nb1, b, 4), dtype=fs.dtype, device=dev)
    scal, flags = _form_block(form, r_cut, fs.dtype)
    _launch("tile_pair", fs.dtype, fs.data_ptr(), ms.data_ptr(),
            hb.data_ptr(), cb.data_ptr(), wrap.data_ptr(), box.data_ptr(),
            e, nb1 - 1, b, ctypes.addressof(scal), ctypes.addressof(flags),
            acc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return acc


def tile_pair_energy_forces(form, x, box, per_particle, spec, order, hb,
                            cb, wrap, r_cut, xref=None):
    """(energy, forces (N, 3)) over the flat tile-pair list: K3 for a CUDA
    tensor, its plain twin for a CPU tensor. `form` is the pair form
    (ops/pairfuncs.py::PairForm) the kernel evaluates.

    Pass `xref` (the positions the list was built at) whenever x may have
    drifted since the build; see _stage for why."""
    n = x.shape[0]
    nb = spec.n_blocks
    fs, ms = _stage(spec, x, box, per_particle, spec.excbits, order, xref)
    if x.is_cuda:
        acc = tile_pair_cuda(fs, ms, hb, cb, wrap, box.contiguous(), form,
                             r_cut)
    else:
        acc = tile_pair_plain(fs, ms, hb, cb, wrap, box, form, r_cut)
    energy = torch.sum(acc[:nb, :, 3])
    forces = x.new_zeros((n + 1, 3))
    forces.index_add_(0, order.long(), acc[:nb, :, :3].reshape(-1, 3))
    return energy, forces[:n]


def tile_pair_energy(form, x, box, per_particle, spec, order, hb, cb, wrap,
                     r_cut, xref=None):
    e, _ = tile_pair_energy_forces(form, x, box, per_particle, spec, order,
                                   hb, cb, wrap, r_cut, xref)
    return e
