"""Cell-list pair evaluation (counterpart of atomsmm_tpu/ops/neighbors.py),
the production nonbonded path.

  * rebuild: bin atoms into a static cell grid with one sort of packed int32
    keys and scatter them into fixed-capacity buckets (ncells, cap) of atom
    ids, padded with the sentinel id N;
  * evaluation: each home cell meets its stencil cells. With Newton
    half-stencil maps (every grid dimension >= 2*reach + 1) the sweep visits
    each cell pair once (K1, csrc/half_pair.cu); grids too small for half
    maps take the full-stencil sweep (K2, csrc/cell_pair.cu), and so do
    grids whose cells hold more atoms than K1 takes (1,024, one thread a
    home atom: a long cutoff in a box of a few cells). On the card
    each runs its hand-written CUDA kernel, on the CPU its plain PyTorch
    twin (ops/pair_kernel.py). A user pair function (CustomNonbondedForce)
    takes the callable sweep, cell_pair_energy_fn: the full stencil's
    slots as torch operations on any device, forces by autograd.

A (3, 3) triclinic box takes the same stencil topology: the grid and the
reach are sized from the cell's perpendicular widths and atoms are binned
in fractional coordinates. Its sweep is the same K1 or K2 launch (or plain
twin on the CPU): the kernels and the twins take the minimum image of
either box form, so nothing else tells the two forms apart.

Shapes are static (NeighborSpec). Bucket overflow is flagged, never
silently dropped: the flag stays on the device and Context.step reads it
once per call. The box may move (the MC barostat scales it), but the grid
and the stencil reach stay: a box that shrank until the stencil no longer
covers the cutoff would drop pairs, so `coverage_deficient` is tested on
each barostat trial (an uncovered trial is rejected), at every box a
Context is given, and at the box each Context.step ends with.

A stack of K systems (replicas or lambda states, x (K, N, 3), box (K, 3)
or (K, 3, 3): a stacked State, state.py) shares one spec, grid and
capacity: its buckets are (K, ncells, cap), its overflow, coverage and
staleness flags (K,), one per row, and row k of each equals what the
single system of row k gets. A retune on any row's overflow resizes the
shared spec for every row.

A System may carry block lists instead (ops/blocks.py: BlockNeighborSpec,
as default spec, near spec or both): every function here that takes a
spec takes one, and dispatches to that module; their extras hold the
sorted order and the candidate blocks (``nbr_order``, ``nbr_cand``) in
place of the bucket, and make_aux hands a force both (``"cand"`` beside
``"bucket"`` = the order), which sends its sweep to the block kernel.

Each build stores the positions and box it binned (``nbr_xref``,
``nbr_boxref``) and whether the stencil covers the cutoff there
(``nbr_undercover``). Context rebuilds at every outer step by default
(``update_neighbors(force=True)``): the conditional rebuild of the JAX
package, a displacement test, costs a host sync per step in eager PyTorch
unless both branches run, and the forces do not depend on which valid
bucket is used. Context(neighbor_update_every=K) rebuilds every K steps
and samples `staleness_flags` after every step in between.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .pbc import _inv, host_widths, minimum_image, perp_widths

# State.extra keys (the default spec; named specs use nbr_<name>_bucket ...)
NBR_BUCKET = "nbr_bucket"
NBR_XREF = "nbr_xref"
NBR_BOXREF = "nbr_boxref"
NBR_OVERFLOW = "nbr_overflow"

EXC_OFF = 16     # exclusion bit for relative offset 0 (self)
EXC_WINDOW = 14  # max |i - j| representable in the exclusion bitmask


def _keys(name: str):
    if name == "default":
        return NBR_BUCKET, NBR_XREF, NBR_BOXREF, NBR_OVERFLOW
    return (f"nbr_{name}_bucket", f"nbr_{name}_xref", f"nbr_{name}_boxref",
            f"nbr_{name}_overflow")


def _cover_key(name: str) -> str:
    return "nbr_undercover" if name == "default" else f"nbr_{name}_undercover"


def stale_key(name: str) -> str:
    """The State.extra key of a spec's sticky staleness flag."""
    return "nbr_stale" if name == "default" else f"nbr_{name}_stale"


def _is_block(spec) -> bool:
    from .blocks import BlockNeighborSpec

    return isinstance(spec, BlockNeighborSpec)


def iter_specs(system):
    """(name, spec) pairs for every neighbor spec attached to a system:
    cell lists (NeighborSpec) and block lists (BlockNeighborSpec); any
    other spec raises."""
    specs = {}
    if getattr(system, "neighbors", None) is not None:
        specs["default"] = system.neighbors
    specs.update(getattr(system, "extra_neighbor_specs", None) or {})
    for name, spec in specs.items():
        if not (isinstance(spec, NeighborSpec) or _is_block(spec)):
            raise NotImplementedError(
                f"{type(spec).__name__} ({name!r}) cannot be attached to a "
                "System: the TilePairSpec is a standalone entry point "
                "(build_tile_pairs + tile_pair_energy_forces in "
                "ops/tilepair.py); attach a NeighborSpec or a "
                "BlockNeighborSpec instead")
        yield name, spec


@dataclasses.dataclass
class NeighborSpec:
    """Static-shape cell-list configuration, attached to a System. The device
    of its tensors is the device the sweep runs on.

    nbr_cells is the (ncells, S) map of neighboring cell ids, -1-padded after
    deduplication. The half-stencil maps have column 0 = the cell itself and
    then the lexicographically positive directions; inv[c, k] = c - d_k.
    They are None when the grid is too small.

    `exclusions` is the whole (N, M) table; the sweeps read it in one of
    two forms (exclusion_form): 'bits', the relative-offset bitmask
    excbits (bit j - i + 16 per atom, bit 16 = self) where every excluded
    pair lies within +-14 atom indices; 'split' where some lie farther
    apart, excbits for the pairs within the window and exclusions_far,
    each atom's ids outside it (sorted ascending, -1 padded), for the
    rest. A spec given a table and no excbits (dataclasses.replace,
    interop) derives both from the table (split_exclusions).
    """

    nbr_cells: torch.Tensor = None         # (ncells, S) int32, -1 padded
    exclusions: torch.Tensor = None        # (N, M) int32, -1 padded
    r_build: float = 0.0                   # max cutoff + skin
    skin: float = 0.0
    nbr_cells_half: torch.Tensor = None    # (ncells, S_half) int32
    inv_cells_half: torch.Tensor = None    # (ncells, S_half) int32
    excbits: torch.Tensor = None           # (N + 1,) int32
    exclusions_far: torch.Tensor = None    # (N, R) int32, 'split' form
    grid: Tuple[int, int, int] = (1, 1, 1)
    reach: Tuple[int, int, int] = (1, 1, 1)
    cell_capacity: int = 64
    cell_chunk: int = 4                    # home cells per plain-sweep chunk
    half_stencil: bool = False

    def __post_init__(self):
        if self.excbits is None and self.exclusions is not None:
            exc = self.exclusions
            bits, far = split_exclusions(exc.shape[0], exc.cpu().numpy())
            self.excbits = torch.as_tensor(bits, device=exc.device)
            self.exclusions_far = (None if far is None else
                                   torch.as_tensor(far, device=exc.device))

    @property
    def ncells(self) -> int:
        return int(np.prod(self.grid))

    @property
    def exclusion_form(self) -> str:
        """'bits' or 'split' (the class docstring)."""
        return "bits" if self.exclusions_far is None else "split"


def _neighbor_cell_map(grid, reach=(1, 1, 1)) -> np.ndarray:
    """Host-side: for each cell, the unique neighboring cell ids within
    +-reach cells per dimension (periodic), -1 padded."""
    nx, ny, nz = grid
    rx, ry, rz = reach
    ncells = nx * ny * nz
    s_max = (2 * rx + 1) * (2 * ry + 1) * (2 * rz + 1)
    out = np.full((ncells, s_max), -1, dtype=np.int32)
    for cx in range(nx):
        for cy in range(ny):
            for cz in range(nz):
                cid = (cx * ny + cy) * nz + cz
                seen = set()
                for dx in range(-rx, rx + 1):
                    for dy in range(-ry, ry + 1):
                        for dz in range(-rz, rz + 1):
                            seen.add((((cx + dx) % nx) * ny + ((cy + dy) % ny))
                                     * nz + ((cz + dz) % nz))
                cells = sorted(seen)
                out[cid, : len(cells)] = cells
    used = int((out >= 0).sum(axis=1).max())
    return out[:, :used]


def _half_stencil_maps(grid, reach):
    """(nbr_half, inv_half) or (None, None) when the periodic grid is too
    small for collision-free direction maps (any dim < 2*reach + 1)."""
    nx, ny, nz = grid
    rx, ry, rz = reach
    if nx < 2 * rx + 1 or ny < 2 * ry + 1 or nz < 2 * rz + 1:
        return None, None
    dirs = [(0, 0, 0)]
    for dx in range(-rx, rx + 1):
        for dy in range(-ry, ry + 1):
            for dz in range(-rz, rz + 1):
                if (dx, dy, dz) > (0, 0, 0):
                    dirs.append((dx, dy, dz))
    ncells = nx * ny * nz
    nbr = np.zeros((ncells, len(dirs)), np.int32)
    inv = np.zeros((ncells, len(dirs)), np.int32)
    for cx in range(nx):
        for cy in range(ny):
            for cz in range(nz):
                cid = (cx * ny + cy) * nz + cz
                for k, (dx, dy, dz) in enumerate(dirs):
                    nbr[cid, k] = (((cx + dx) % nx) * ny + ((cy + dy) % ny)) \
                        * nz + ((cz + dz) % nz)
                    inv[cid, k] = (((cx - dx) % nx) * ny + ((cy - dy) % ny)) \
                        * nz + ((cz - dz) % nz)
    return nbr, inv


def split_exclusions(n: int, exclusions):
    """The exclusion table split at the bitmask's window: ((N+1,) int32
    bits, bit (j - i + EXC_OFF) set for every excluded pair within
    +-EXC_WINDOW atom indices and for offset 0 (self), row N (the sentinel)
    carrying the self bit only; the far ids, (N, R) int32, each row the
    atom's excluded ids more than EXC_WINDOW apart, sorted ascending and -1
    padded, or None where there are none). exclusions: (N, M) int32
    j-lists padded with -1."""
    exc = np.asarray(exclusions)
    bits = np.full(n + 1, np.int64(1) << EXC_OFF, dtype=np.int64)
    if not exc.size:
        return bits.astype(np.int32), None
    ii = np.repeat(np.arange(n), exc.shape[1])
    jj = exc.reshape(-1).astype(np.int64)
    ok = jj >= 0
    ii, jj = ii[ok], jj[ok]
    d = jj - ii
    near = np.abs(d) <= EXC_WINDOW
    np.bitwise_or.at(bits, ii[near], np.int64(1) << (d[near] + EXC_OFF))
    if near.all():
        return bits.astype(np.int32), None
    fi, fj = ii[~near], jj[~near]
    order = np.lexsort((fj, fi))
    fi, fj = fi[order], fj[order]
    counts = np.bincount(fi, minlength=n)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    far = np.full((n, int(counts.max())), -1, np.int32)
    far[fi, np.arange(fi.size) - start[fi]] = fj
    return bits.astype(np.int32), far


def make_exclusion_bits(n: int, exclusions) -> np.ndarray:
    """(N+1,) int32: bit (j - i + EXC_OFF) set for every excluded pair and
    for offset 0 (self); row N (the sentinel) carries the self bit only.
    exclusions: (N, M) int32 j-lists padded with -1. Raises ValueError when
    an excluded pair spans more than +-EXC_WINDOW atom indices."""
    bits, far = split_exclusions(n, exclusions)
    if far is not None:
        exc = np.asarray(exclusions)
        span = int(np.abs(np.where(exc >= 0, exc - np.arange(n)[:, None],
                                   0)).max())
        raise ValueError(
            f"the exclusion bitmask holds excluded pairs within "
            f"+-{EXC_WINDOW} atom indices (got {span})")
    return bits


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _max_cell_occupancy(x, box, grid) -> int:
    """Host-side: max atoms in any cell of `grid` for configuration x
    (either box form; a matrix box bins fractionally, as
    build_cell_buckets does); the max over the rows of a stack
    (x (K, N, 3))."""
    x = _host(x)
    box = np.asarray(_host(box), np.float64)
    if x.ndim == 3:
        return max(_max_cell_occupancy(xk, bk, grid)
                   for xk, bk in zip(x, box))
    grid_a = np.asarray(grid)
    if not np.isfinite(x).all():
        bad = int((~np.isfinite(x).all(axis=-1)).sum())
        raise FloatingPointError(
            f"{bad}/{x.shape[0]} positions are non-finite — the trajectory "
            "has diverged; refusing to retune neighbor capacities from it")
    if box.ndim == 2:
        s = x @ np.linalg.inv(box)
        s -= np.floor(s)
        c3 = np.clip((s * grid_a).astype(np.int64), 0, grid_a - 1)
    else:
        w = box / grid_a
        xw = x - box * np.floor(x / box)
        c3 = np.clip((xw / w).astype(np.int64), 0, grid_a - 1)
    cid = (c3[:, 0] * grid[1] + c3[:, 1]) * grid[2] + c3[:, 2]
    return int(np.bincount(cid, minlength=int(np.prod(grid_a))).max())


def _chunk_for(ncells: int, cap: int, s: int) -> int:
    per_cell = cap * s * cap * 4
    return max(1, min(ncells, (48 << 20) // max(per_cell, 1)))


def retune_spec(spec: NeighborSpec, x, box, safety: float = 1.15,
                floor: int = 0) -> NeighborSpec:
    """Resize a spec's cell capacity to the measured max occupancy of `x`
    (same grid and stencil); `floor` sets a minimum capacity (overflow
    recovery passes the current capacity + 4 so capacities only grow)."""
    occ = _max_cell_occupancy(x, box, spec.grid)
    cap = ((max(int(math.ceil(occ * safety)) + 1, floor) + 3) // 4) * 4
    chunk = _chunk_for(spec.ncells, cap, spec.nbr_cells.shape[1])
    return dataclasses.replace(spec, cell_capacity=cap, cell_chunk=chunk)


def retune_neighbor_specs(system, x, box, safety: float = 1.15,
                          grow_only: bool = False):
    """Retune every neighbor spec attached to a system (see retune_spec;
    a block list's K by blocks.retune_block_spec, at a safety of at least
    1.15). grow_only floors each cell capacity, and each K, at its current
    value + 4."""
    from ..utils import replace
    from .blocks import retune_block_spec

    if getattr(system, "neighbors", None) is None:
        return system

    def one(spec):
        if _is_block(spec):
            return retune_block_spec(spec, x, box, max(safety, 1.15),
                                     floor=spec.max_cand + 4 if grow_only
                                     else 0)
        floor = spec.cell_capacity + 4 if grow_only else 0
        return retune_spec(spec, x, box, safety, floor=floor)

    default = one(system.neighbors)
    extra = {name: one(spec)
             for name, spec in (system.extra_neighbor_specs or {}).items()}
    return replace(system, neighbors=default, extra_neighbor_specs=extra or None)


def make_neighbor_spec(
    box,
    n: int,
    r_cut_max: float,
    skin: float = 0.1,
    min_skin: float = 0.04,
    exclusions=None,
    occupancy_floor_from=None,
    device=None,
) -> NeighborSpec:
    """Host-side setup: pick the cell grid and capacity for n atoms in
    `box`, (3,) lengths or a (3, 3) cell matrix, with the largest relevant
    cutoff r_cut_max.

    The grid is the finest one whose cell width still covers
    r_cut_max + min_skin, on the perpendicular widths of a (3, 3) cell (a
    sheared cell's faces are closer than its edges suggest); the skin is
    whatever margin the width leaves,
    capped at `skin`. Capacity is 1.7 x the mean occupancy, raised (never
    lowered) to 1.15 x the measured max occupancy of `occupancy_floor_from`,
    a setup configuration. The exclusions take the bitmask where every
    excluded pair lies within +-14 indices, else the split form
    (NeighborSpec). There is no backend choice: the spec's tensors
    lie on `device` (default: the CUDA card; without one pass
    device="cpu"), and the device of the tensors decides where the sweep
    runs.
    """
    from ..utils import resolve_device

    device = resolve_device(device)
    box = np.asarray(_host(box), np.float64)
    triclinic = box.ndim == 2
    b_eff = host_widths(box)
    target_w = float(r_cut_max) + float(min_skin)
    grid = tuple(max(1, int(np.floor(b / target_w))) for b in b_eff)
    w = b_eff / np.array(grid)
    skin_eff = min(float(np.min(w)) - float(r_cut_max), float(skin))
    skin_eff = max(skin_eff, float(min_skin))
    r_build = float(r_cut_max) + skin_eff
    reach = tuple(int(np.ceil(r_build / wi)) for wi in w)
    vol = abs(float(np.linalg.det(box))) if triclinic else float(
        np.prod(box))
    rho = n / vol
    cell_vol = vol / float(np.prod(grid))
    cap = int(math.ceil(rho * cell_vol * 1.7) + 4)
    if occupancy_floor_from is not None:
        occ_max = _max_cell_occupancy(occupancy_floor_from, box, grid)
        cap = max(cap, int(math.ceil(occ_max * 1.15) + 2))
    cap = ((cap + 7) // 8) * 8
    exclusions = (np.full((n, 1), -1, np.int32) if exclusions is None
                  else _host(exclusions).astype(np.int32))
    ncells = int(np.prod(grid))
    s = min((2 * reach[0] + 1) * (2 * reach[1] + 1) * (2 * reach[2] + 1),
            ncells)
    nbr_half, inv_half = _half_stencil_maps(grid, reach)
    excbits, far = split_exclusions(n, exclusions)

    def dev(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return NeighborSpec(
        nbr_cells=dev(_neighbor_cell_map(grid, reach)),
        exclusions=dev(exclusions),
        r_build=r_build,
        skin=skin_eff,
        nbr_cells_half=dev(nbr_half),
        inv_cells_half=dev(inv_half),
        excbits=dev(excbits),
        exclusions_far=dev(far),
        grid=grid,
        reach=reach,
        cell_capacity=cap,
        cell_chunk=_chunk_for(ncells, cap, s),
        half_stencil=nbr_half is not None,
    )


def build_cell_buckets(spec: NeighborSpec, x, box):
    """Bin atoms into (ncells, cap) id buckets (sentinel N) with one sort.

    A value sort of ``(row ncells + cid) << idx_bits | i`` replaces the
    argsort, on int32 keys where they pack into 31 bits, else int64. Atoms
    past a cell's capacity are routed to one extra dump slot that is cut
    off afterwards, the counterpart of JAX's ``mode="drop"`` scatter, and
    raise the returned overflow flag (a device bool: no host sync). A
    (3, 3) box bins in fractional coordinates (the cells are
    parallelepiped slabs of the lattice). Over a stack (x (K, N, 3), box
    (K, 3) or (K, 3, 3)) the buckets are (K, ncells, cap) and the flags
    (K,), row k what row k alone gets: the keys sort row by row, so one
    sort bins every row.
    """
    rows = x.ndim == 3
    if not rows:
        x, box = x[None], box[None]
    k, n = x.shape[0], x.shape[1]
    dev = x.device
    grid = torch.as_tensor(spec.grid, dtype=torch.int32, device=dev)
    ncells = spec.ncells
    cap = spec.cell_capacity
    if box.ndim == 3:
        s = torch.matmul(x, _inv(box))
        s = s - torch.floor(s)
        c3 = (s * grid.to(s.dtype)).to(torch.int32)
    else:
        b = box[:, None, :]
        w = b / grid.to(box.dtype)
        xw = x - b * torch.floor(x / b)
        c3 = (xw / w).to(torch.int32)
    c3 = torch.minimum(torch.clamp(c3, min=0), grid - 1)
    cid = (c3[..., 0] * spec.grid[1] + c3[..., 1]) * spec.grid[2] + c3[..., 2]

    idx_bits = max(n - 1, 1).bit_length()
    key = torch.int32 if (k * ncells << idx_bits) < 2**31 else torch.int64
    cell = cid.to(key) + ncells * torch.arange(k, dtype=key,
                                               device=dev)[:, None]
    iarr = torch.arange(n, dtype=key, device=dev)
    packed = torch.sort(((cell << idx_bits) | iarr).reshape(-1)).values
    order = (packed & ((1 << idx_bits) - 1)).to(torch.int32)
    sorted_cell = packed >> idx_bits
    pos = torch.arange(k * n, dtype=key, device=dev)
    first = torch.ones(k * n, dtype=torch.bool, device=dev)
    first[1:] = sorted_cell[1:] != sorted_cell[:-1]
    seg_start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = pos - seg_start
    ok = rank < cap
    slot = torch.where(ok, sorted_cell.long() * cap + rank,
                       k * ncells * cap)
    bucket = torch.full((k * ncells * cap + 1,), n, dtype=torch.int32,
                        device=dev)
    bucket[slot] = order
    bucket = bucket[:-1].reshape(k, ncells, cap)
    overflow = torch.any(~ok.reshape(k, n), dim=1)
    return (bucket, overflow) if rows else (bucket[0], overflow[0])


def _covered(spec: NeighborSpec, box, rows: bool = False):
    """The distance the stencil covers along each dim at `box` (reach cell
    widths, on the perpendicular widths of a (3, 3) cell), infinite along
    a dim where the stencil wraps the whole grid: there every cell pair is
    a candidate whatever the cell width. (K, 3) for a stack of boxes."""
    box = torch.as_tensor(box)
    reach = torch.as_tensor(
        [r / g if 2 * r + 1 < g else math.inf
         for g, r in zip(spec.grid, spec.reach)],
        dtype=box.dtype, device=box.device)
    return perp_widths(box, rows) * reach


def coverage_deficient(spec: NeighborSpec, box, rows: bool = False):
    """The stencil reach does not cover the cutoff at `box`: a bool tensor
    on the device of `box`, read without a sync ((K,) for a stack). Only
    dims where the stencil does not wrap the whole grid count. Never for a
    block list, which holds no stencil."""
    if _is_block(spec):
        box = torch.as_tensor(box)
        return torch.zeros(box.shape[:1] if rows else (), dtype=torch.bool,
                           device=box.device)
    return torch.any(_covered(spec, box, rows) < spec.r_build - spec.skin,
                     dim=-1)


def effective_skin(spec: NeighborSpec, box, rows: bool = False):
    """The displacement margin the grid leaves at `box` (a 0-d tensor, (K,)
    for a stack): spec.skin, the margin at the setup box, shrunk to what
    the stencil's reach still covers beyond the cutoff (0 at the coverage
    boundary). After an NPT compression the setup skin would overstate it,
    and the rebuild test and the staleness guard would miss pairs in
    between. Either box form (perpendicular widths). A block list's
    margin is its skin at any box."""
    if _is_block(spec):
        box = torch.as_tensor(box)
        return torch.full(box.shape[:1] if rows else (), spec.skin,
                          dtype=box.dtype, device=box.device)
    margin = torch.min(_covered(spec, box, rows), dim=-1).values \
        - (spec.r_build - spec.skin)
    return torch.clamp(torch.clamp(margin, min=0.0), max=spec.skin)


def _box_changed(box, boxref, rows: bool = False):
    """The box differs from the reference box, per row of a stack."""
    changed = box != boxref
    return changed.reshape(changed.shape[0], -1).any(dim=1) if rows \
        else torch.any(changed)


def moved_beyond_half_skin(skin, xref, boxref, x, box, fraction=0.5):
    """Some atom moved more than `fraction` * skin since the reference
    build xref, or the box changed (a device bool; (K,) for a stack, x
    (K, N, 3)): the rebuild predicate shared by the cell lists
    (needs_rebuild) and the tile-pair list."""
    rows = x.ndim == 3
    disp = minimum_image(x - xref, box, rows)
    moved = torch.max(torch.sum(disp * disp, dim=-1), dim=-1).values > (
        fraction * torch.as_tensor(skin, dtype=x.dtype)) ** 2
    return moved | _box_changed(box, boxref, rows)


def neighbor_list_extras(spec, x, box, name: str = "default") -> Dict[str, torch.Tensor]:
    if _is_block(spec):
        from .blocks import block_list_extras

        return block_list_extras(spec, x, box, name)
    kb, kx, kbox, kov = _keys(name)
    bucket, overflow = build_cell_buckets(spec, x, box)
    return {kb: bucket, kx: x, kbox: box, kov: overflow,
            _cover_key(name): coverage_deficient(spec, box, x.ndim == 3)}


def all_neighbor_extras(system, x, box) -> Dict[str, torch.Tensor]:
    out = {}
    for name, spec in iter_specs(system):
        out.update(neighbor_list_extras(spec, x, box, name))
    return out


def overflow_flags(extra) -> Dict[str, torch.Tensor]:
    """The sticky bucket-overflow flags held in `extra`."""
    return {k: v for k, v in extra.items()
            if k.startswith("nbr") and k.endswith("overflow")}


def unhealthy_flags(extras: Dict[str, torch.Tensor],
                    kinds=("overflow", "undercover")):
    """One device bool per kind of health flag in `extras`: the OR of its
    '*_overflow' (or '*_undercover', ...) entries, False where there are
    none, so that a consumer (the barostat's trial) need not match key
    names itself."""
    dev = next((v.device for v in extras.values()
                if isinstance(v, torch.Tensor)), None)
    out = []
    for kind in kinds:
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        for k, v in extras.items():
            if k.endswith(kind):
                flag = flag | v
        out.append(flag)
    return tuple(out)


def assert_neighbor_health(extras: Dict[str, torch.Tensor]) -> None:
    """Raise if a neighbor list in `extras` overflowed its cell capacity or
    its stencil undercovers the cutoff. Context.step recovers from these
    itself; a caller that builds extras by hand (all_neighbor_extras, then
    make_aux) should call this before trusting an energy. One host read of
    the flags."""
    keys = [k for k in extras
            if k.endswith("overflow") or k.endswith("undercover")]
    values = (torch.stack([extras[k].any() for k in keys]).tolist()
              if keys else [])
    bad = [k for k, v in zip(keys, values) if v]
    if bad:
        raise RuntimeError(
            f"neighbor list unhealthy: {bad}: a cell capacity overflow drops "
            "pairs and an undercovering stencil misses cells; rebuild the "
            "spec with a larger capacity (retune_neighbor_specs) or a finer "
            "grid before trusting energies")


def make_aux(system, extra):
    """The aux dict passed to force evaluations: for each attached neighbor
    spec, its spec and current bucket (cell lists) or its order as
    "bucket" and its candidate blocks as "cand" (block lists). None when
    no neighbor path exists."""
    from . import blocks

    aux = {}
    for name, spec in iter_specs(system):
        if _is_block(spec):
            ko, kc = blocks._keys(name)[:2]
            if ko in extra:
                aux[name] = {"spec": spec, "bucket": extra[ko],
                             "cand": extra[kc]}
            continue
        kb = _keys(name)[0]
        if kb in extra:
            aux[name] = {"spec": spec, "bucket": extra[kb]}
    return aux or None


def staleness_flags(system, extra, x, box):
    """Sticky per-spec flags ({stale_key(name): device bool}): pairs may
    have been missed since the reference build. Sampled after every outer
    step between grouped rebuilds (Context(neighbor_update_every=K)).

    A pair absent at the build can have closed by at most d_i + d_j, so
    none can have entered the cutoff while the two largest displacements
    of distinct atoms sum to no more than the effective skin; a single
    atom falls back to 2 max d. A changed box is stale too. Over a stack
    (x (K, N, 3)) each flag is (K,), one per row."""
    rows = x.ndim == 3
    out = {}
    for name, spec in iter_specs(system):
        _, kx, kbox, _ = _keys(name)
        if kx not in extra:
            continue
        key = stale_key(name)
        prev = extra.get(key, torch.zeros(x.shape[:1] if rows else (),
                                          dtype=torch.bool, device=x.device))
        disp = minimum_image(x - extra[kx], box, rows)
        d2 = torch.sum(disp * disp, dim=-1)
        if d2.shape[-1] >= 2:
            top2 = torch.sqrt(torch.topk(d2, 2).values)
            pair_close = top2[..., 0] + top2[..., 1]
        else:
            pair_close = 2.0 * torch.sqrt(torch.max(d2, dim=-1).values)
        stale = (pair_close > effective_skin(spec, box, rows).to(x.dtype)) \
            | _box_changed(box, extra[kbox], rows)
        out[key] = prev | stale
    return out


def needs_rebuild(spec: NeighborSpec, extra, x, box, name: str = "default"):
    """Some atom moved more than half the effective skin since the
    reference build, or the box changed (a device bool; (K,) for a
    stack). Either kind of spec: a block list's margin is its skin."""
    _, kx, kbox, _ = _keys(name)
    return moved_beyond_half_skin(effective_skin(spec, box, x.ndim == 3),
                                  extra[kx], extra[kbox], x, box)


def update_neighbors(spec: NeighborSpec, extra, x, box, name: str = "default",
                     force: bool = False):
    """Re-bin, and store x and box as the new reference. force=True
    rebuilds unconditionally, as Context does after every outer step and
    at the boundaries of grouped updates; otherwise the rebuilt entries
    replace the kept ones where needs_rebuild holds, chosen by torch.where
    on the device (no host sync: the rebuild is paid either way). The
    overflow and coverage flags are sticky: they OR across rebuilds. Over a
    stack (x (K, N, 3)) the choice and the flags are per row."""
    rows = x.ndim == 3
    keys = _keys(name) + (_cover_key(name),)
    kb, kx, kbox, kov, kcv = keys
    cover_prev = extra.get(kcv, torch.zeros(x.shape[:1] if rows else (),
                                            dtype=torch.bool,
                                            device=x.device))
    bucket, overflow = build_cell_buckets(spec, x, box)
    rebuilt = (bucket, x, box, extra[kov] | overflow,
               cover_prev | coverage_deficient(spec, box, rows))
    if force:
        return dict(zip(keys, rebuilt))
    need = needs_rebuild(spec, extra, x, box, name)
    kept = (extra[kb], extra[kx], extra[kbox], extra[kov], cover_prev)
    return {k: torch.where(need.reshape(need.shape + (1,) * (new.ndim
                                                             - need.ndim)),
                           new, old)
            for k, new, old in zip(keys, rebuilt, kept)}


def update_all_neighbors(system, extra, x, box, force: bool = False):
    """update_neighbors (blocks.update_blocks for a block list) for every
    spec of `system` whose list `extra` holds. The signature is the JAX
    package's; every caller in the port (Context's loops, the barostat)
    passes force=True, and force=False, the device-side select, has no
    production caller yet."""
    from . import blocks

    out = {}
    for name, spec in iter_specs(system):
        if _is_block(spec):
            if blocks._keys(name)[0] in extra:
                out.update(blocks.update_blocks(spec, extra, x, box, name,
                                                force=force))
            continue
        if _keys(name)[0] in extra:
            out.update(update_neighbors(spec, extra, x, box, name,
                                        force=force))
    return out


# --------------------------------------------------------------------------
# Pair evaluation over cell buckets
# --------------------------------------------------------------------------


def takes_half_stencil(spec: NeighborSpec) -> bool:
    """Whether K1 (or its twin) sweeps this spec's grid: it has half maps
    and cells of at most pair_kernel.K1_MAX_CAP atoms (one thread a home
    atom). Otherwise K2 sweeps the full stencil, which gives the same
    result and takes any capacity."""
    from .pair_kernel import K1_MAX_CAP

    return spec.half_stencil and spec.cell_capacity <= K1_MAX_CAP


def _sweep(spec):
    from . import pair_kernel

    return (pair_kernel.half_pair_energy_forces if takes_half_stencil(spec)
            else pair_kernel.full_pair_energy_forces)


def cell_pair_energy(form, x, box, per_particle, spec, bucket, r_cut,
                     lamb=None):
    """Pair energy over the cell buckets (the sweep's energy column); (K,)
    over a stack (x (K, N, 3), `lamb` the rows' softcore lambdas or
    None)."""
    e, _ = _sweep(spec)(form, x, box, per_particle, spec, bucket, r_cut,
                        with_forces=False, lamb=lamb)
    return e


def cell_pair_energy_forces(form, x, box, per_particle, spec, bucket, r_cut,
                            lamb=None):
    """(energy, forces (N, 3)) with explicit symmetric forces: the Newton
    half-stencil sweep (K1) when half maps exist and K1 takes the cell
    capacity (takes_half_stencil), else the full-stencil sweep (K2); the
    CUDA kernel on the card, its plain twin on the CPU;
    either box form. Over a stack (x (K, N, 3), a (K, ncells, cap) bucket,
    a (K, 3) or (K, 3, 3) box, any of them expanded where the rows share
    it) one sweep gives (K,) energies and (K, N, 3) forces."""
    return _sweep(spec)(form, x, box, per_particle, spec, bucket, r_cut,
                        lamb=lamb)


_FN_SLOTS = 1 << 21  # pair slots per chunk of the callable sweep


def cell_pair_energy_fn(pair_fn, x, box, per_particle, spec, bucket, r_cut,
                        cells=None):
    """Sum of a Python pair function pair_fn(r, pi, pj) over the cell list,
    as torch operations on the device of x: every home atom meets every
    slot of its full stencil (spec.nbr_cells), both orderings of a pair,
    each at weight 1/2; slots past r_cut, excluded pairs (the bitmask, the
    exclusion id columns, or both in the split form) and padding are
    masked. per_particle holds
    any (N,) tensors, gathered into pi / pj. Differentiable in x, so forces
    come by autograd. `cells` = (c0, c1) sums over the home atoms of those
    cells only (force decomposition, parallel/spatial.py).

    This is the path for user expressions, which no hand-written kernel can
    take; it evaluates every slot of the stencil, so its cost grows with
    the whole cell list, however few pairs the function leaves nonzero."""
    from .pair_kernel import _rc2, excluded, home_range
    from .rv import pair_eval

    n = x.shape[0]
    ncells, cap = bucket.shape
    nbr = spec.nbr_cells
    s = nbr.shape[1]
    dev = x.device
    rc2 = _rc2(r_cut, x.dtype)
    ids_s = torch.cat([bucket, bucket.new_full((1, cap), n)]).long()
    ncid_all = torch.where(nbr >= 0, nbr, ncells).long()
    xp = torch.cat([x, x.new_zeros((1, 3))])
    pp = {k: torch.cat([v, v.new_zeros((1,))]) for k, v in per_particle.items()}
    exc_bits, exc_cols = spec.excbits, spec.exclusions_far
    if exc_cols is not None:
        exc_cols = torch.cat([exc_cols,
                              exc_cols.new_full((1, exc_cols.shape[1]), -1)])
    chunk = max(1, min(ncells, _FN_SLOTS // (cap * s * cap)))
    c0, c1 = home_range(cells, ncells)
    total = torch.zeros((), dtype=x.dtype, device=dev)
    for lo in range(c0, c1, chunk):
        cells = torch.arange(lo, min(lo + chunk, c1), device=dev)
        b = len(cells)
        hid = ids_s[cells][:, :, None]                        # (B, cap, 1)
        cid = ids_s[ncid_all[cells]].reshape(b, 1, s * cap)   # (B, 1, S cap)
        d = minimum_image(xp[hid] - xp[cid], box)
        r2 = torch.sum(d * d, dim=-1)
        valid = (hid < n) & (cid < n) & (r2 < rc2) & ~excluded(
            hid, cid, exc_bits[hid],
            None if exc_cols is None else exc_cols[hid])
        r2m = torch.where(valid, r2, torch.ones_like(r2))
        pi = {k: v[hid] for k, v in pp.items()}
        pj = {k: v[cid] for k, v in pp.items()}
        u, _ = pair_eval(pair_fn, r2m, pi, pj, with_tangent=False)
        total = total + 0.5 * torch.sum(torch.where(valid, u,
                                                    torch.zeros_like(u)))
    return total
