"""Cell-list pair evaluation (counterpart of atomsmm_tpu/ops/neighbors.py),
the production nonbonded path.

  * rebuild: bin atoms into a static cell grid with one sort of packed int32
    keys and scatter them into fixed-capacity buckets (ncells, cap) of atom
    ids, padded with the sentinel id N;
  * evaluation: each home cell meets its stencil cells. With Newton
    half-stencil maps (every grid dimension >= 2*reach + 1) the sweep visits
    each cell pair once (K1, csrc/half_pair.cu); grids too small for half
    maps take the full-stencil sweep (K2, csrc/cell_pair.cu). On the card
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


def iter_specs(system):
    """(name, spec) pairs for every neighbor spec attached to a system.
    Only cell lists drive a Context: any other spec raises."""
    specs = {}
    if getattr(system, "neighbors", None) is not None:
        specs["default"] = system.neighbors
    specs.update(getattr(system, "extra_neighbor_specs", None) or {})
    for name, spec in specs.items():
        if not isinstance(spec, NeighborSpec):
            raise NotImplementedError(
                f"{type(spec).__name__} ({name!r}) cannot be attached to a "
                "System: the TilePairSpec is a standalone entry point "
                "(build_tile_pairs + tile_pair_energy_forces in "
                "ops/tilepair.py); attach a NeighborSpec instead")
        yield name, spec


@dataclasses.dataclass
class NeighborSpec:
    """Static-shape cell-list configuration, attached to a System. The device
    of its tensors is the device the sweep runs on.

    nbr_cells is the (ncells, S) map of neighboring cell ids, -1-padded after
    deduplication. The half-stencil maps have column 0 = the cell itself and
    then the lexicographically positive directions; inv[c, k] = c - d_k.
    They are None when the grid is too small. excbits is the relative-offset
    exclusion bitmask (bit j - i + 16 per atom, bit 16 = self), None when an
    excluded pair spans more than +-14 atom indices.
    """

    nbr_cells: torch.Tensor = None         # (ncells, S) int32, -1 padded
    exclusions: torch.Tensor = None        # (N, M) int32, -1 padded
    r_build: float = 0.0                   # max cutoff + skin
    skin: float = 0.0
    nbr_cells_half: torch.Tensor = None    # (ncells, S_half) int32
    inv_cells_half: torch.Tensor = None    # (ncells, S_half) int32
    excbits: torch.Tensor = None           # (N + 1,) int32
    grid: Tuple[int, int, int] = (1, 1, 1)
    reach: Tuple[int, int, int] = (1, 1, 1)
    cell_capacity: int = 64
    cell_chunk: int = 4                    # home cells per plain-sweep chunk
    half_stencil: bool = False

    @property
    def ncells(self) -> int:
        return int(np.prod(self.grid))


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


def make_exclusion_bits(n: int, exclusions) -> np.ndarray:
    """(N+1,) int32: bit (j - i + EXC_OFF) set for every excluded pair and
    for offset 0 (self); row N (the sentinel) carries the self bit only.
    exclusions: (N, M) int32 j-lists padded with -1. Raises ValueError when
    an excluded pair spans more than +-EXC_WINDOW atom indices."""
    exc = np.asarray(exclusions)
    bits = np.full(n + 1, np.int64(1) << EXC_OFF, dtype=np.int64)
    if exc.size:
        ii = np.repeat(np.arange(n), exc.shape[1])
        jj = exc.reshape(-1)
        ok = jj >= 0
        ii, jj = ii[ok], jj[ok]
        d = jj - ii
        if d.size and np.abs(d).max() > EXC_WINDOW:
            raise ValueError(
                f"the exclusion bitmask holds excluded pairs within "
                f"+-{EXC_WINDOW} atom indices (got {np.abs(d).max()})")
        np.bitwise_or.at(bits, ii, np.int64(1) << (d + EXC_OFF))
    return bits.astype(np.int32)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _max_cell_occupancy(x, box, grid) -> int:
    """Host-side: max atoms in any cell of `grid` for configuration x
    (either box form; a matrix box bins fractionally, as
    build_cell_buckets does)."""
    x = _host(x)
    box = np.asarray(_host(box), np.float64)
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
    """Retune every neighbor spec attached to a system (see retune_spec).
    grow_only floors each capacity at its current value + 4."""
    from ..utils import replace

    if getattr(system, "neighbors", None) is None:
        return system

    def one(spec):
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
    a setup configuration. There is no backend choice: the spec's tensors
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
    try:
        excbits = torch.as_tensor(make_exclusion_bits(n, exclusions),
                                  device=device)
    except ValueError:  # excluded pair outside the +-14 index window
        excbits = None

    def dev(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return NeighborSpec(
        nbr_cells=dev(_neighbor_cell_map(grid, reach)),
        exclusions=dev(exclusions),
        r_build=r_build,
        skin=skin_eff,
        nbr_cells_half=dev(nbr_half),
        inv_cells_half=dev(inv_half),
        excbits=excbits,
        grid=grid,
        reach=reach,
        cell_capacity=cap,
        cell_chunk=_chunk_for(ncells, cap, s),
        half_stencil=nbr_half is not None,
    )


def build_cell_buckets(spec: NeighborSpec, x, box):
    """Bin atoms into (ncells, cap) id buckets (sentinel N) with one sort.

    When cell id and atom index pack into 31 bits, a value sort of
    ``cid << idx_bits | i`` replaces the argsort. Atoms past a cell's
    capacity are routed to one extra dump slot that is cut off afterwards,
    the counterpart of JAX's ``mode="drop"`` scatter, and raise the returned
    overflow flag (a device bool: no host sync). A (3, 3) box bins in
    fractional coordinates (the cells are parallelepiped slabs of the
    lattice).
    """
    n = x.shape[0]
    dev = x.device
    grid = torch.as_tensor(spec.grid, dtype=torch.int32, device=dev)
    ncells = spec.ncells
    cap = spec.cell_capacity

    if box.ndim == 2:
        s = torch.matmul(x, _inv(box))
        s = s - torch.floor(s)
        c3 = (s * grid.to(s.dtype)).to(torch.int32)
    else:
        w = box / grid.to(box.dtype)
        xw = x - box * torch.floor(x / box)
        c3 = (xw / w).to(torch.int32)
    c3 = torch.minimum(torch.clamp(c3, min=0), grid - 1)
    cid = (c3[:, 0] * spec.grid[1] + c3[:, 1]) * spec.grid[2] + c3[:, 2]

    iarr = torch.arange(n, dtype=torch.int32, device=dev)
    idx_bits = max(n - 1, 1).bit_length()
    if (ncells << idx_bits) < 2**31:
        packed = torch.sort((cid << idx_bits) | iarr).values
        order = packed & ((1 << idx_bits) - 1)
        sorted_cid = packed >> idx_bits
    else:  # > ~2B combined keys: fall back to a stable argsort
        order = torch.argsort(cid, stable=True).to(torch.int32)
        sorted_cid = cid[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_cid[1:] != sorted_cid[:-1]
    seg_start = torch.cummax(torch.where(first, iarr, torch.zeros_like(iarr)),
                             dim=0).values
    rank = iarr - seg_start
    ok = rank < cap
    slot = torch.where(ok, sorted_cid * cap + rank,
                       torch.full_like(rank, ncells * cap))
    bucket = torch.full((ncells * cap + 1,), n, dtype=torch.int32, device=dev)
    bucket[slot.long()] = order
    return bucket[:-1].reshape(ncells, cap), torch.any(~ok)


def _covered(spec: NeighborSpec, box):
    """The distance the stencil covers along each dim at `box` (reach cell
    widths, on the perpendicular widths of a (3, 3) cell), infinite along
    a dim where the stencil wraps the whole grid: there every cell pair is
    a candidate whatever the cell width."""
    box = torch.as_tensor(box)
    reach = torch.as_tensor(
        [r / g if 2 * r + 1 < g else math.inf
         for g, r in zip(spec.grid, spec.reach)],
        dtype=box.dtype, device=box.device)
    return perp_widths(box) * reach


def coverage_deficient(spec: NeighborSpec, box):
    """The stencil reach does not cover the cutoff at `box`: a bool tensor
    on the device of `box`, read without a sync. Only dims where the
    stencil does not wrap the whole grid count."""
    return torch.any(_covered(spec, box) < spec.r_build - spec.skin)


def effective_skin(spec: NeighborSpec, box):
    """The displacement margin the grid leaves at `box` (a 0-d tensor):
    spec.skin, the margin at the setup box, shrunk to what the stencil's
    reach still covers beyond the cutoff (0 at the coverage boundary).
    After an NPT compression the setup skin would overstate it, and the
    rebuild test and the staleness guard would miss pairs in between.
    Either box form (perpendicular widths)."""
    margin = torch.min(_covered(spec, box)) - (spec.r_build - spec.skin)
    return torch.clamp(torch.clamp(margin, min=0.0), max=spec.skin)


def moved_beyond_half_skin(skin, xref, boxref, x, box, fraction=0.5):
    """Some atom moved more than `fraction` * skin since the reference
    build xref, or the box changed (a device bool): the rebuild predicate
    shared by the cell lists (needs_rebuild) and the tile-pair list."""
    disp = minimum_image(x - xref, box)
    moved = torch.max(torch.sum(disp * disp, dim=-1)) > (
        fraction * torch.as_tensor(skin, dtype=x.dtype)) ** 2
    return moved | torch.any(box != boxref)


def neighbor_list_extras(spec, x, box, name: str = "default") -> Dict[str, torch.Tensor]:
    kb, kx, kbox, kov = _keys(name)
    bucket, overflow = build_cell_buckets(spec, x, box)
    return {kb: bucket, kx: x, kbox: box, kov: overflow,
            _cover_key(name): coverage_deficient(spec, box)}


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
    values = (torch.stack([extras[k].reshape(()) for k in keys]).tolist()
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
    spec, its spec and current bucket. None when no neighbor path exists."""
    aux = {}
    for name, spec in iter_specs(system):
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
    atom falls back to 2 max d. A changed box is stale too."""
    out = {}
    for name, spec in iter_specs(system):
        _, kx, kbox, _ = _keys(name)
        if kx not in extra:
            continue
        key = stale_key(name)
        prev = extra.get(key, torch.zeros((), dtype=torch.bool,
                                          device=x.device))
        disp = minimum_image(x - extra[kx], box)
        d2 = torch.sum(disp * disp, dim=-1)
        if d2.shape[0] >= 2:
            top2 = torch.sqrt(torch.topk(d2, 2).values)
            pair_close = top2[0] + top2[1]
        else:
            pair_close = 2.0 * torch.sqrt(torch.max(d2))
        stale = (pair_close > effective_skin(spec, box).to(x.dtype)) \
            | torch.any(box != extra[kbox])
        out[key] = prev | stale
    return out


def needs_rebuild(spec: NeighborSpec, extra, x, box, name: str = "default"):
    """Some atom moved more than half the effective skin since the
    reference build, or the box changed (a device bool)."""
    _, kx, kbox, _ = _keys(name)
    return moved_beyond_half_skin(effective_skin(spec, box), extra[kx],
                                  extra[kbox], x, box)


def update_neighbors(spec: NeighborSpec, extra, x, box, name: str = "default",
                     force: bool = False):
    """Re-bin, and store x and box as the new reference. force=True
    rebuilds unconditionally, as Context does after every outer step and
    at the boundaries of grouped updates; otherwise the rebuilt entries
    replace the kept ones where needs_rebuild holds, chosen by torch.where
    on the device (no host sync: the rebuild is paid either way). The
    overflow and coverage flags are sticky: they OR across rebuilds."""
    keys = _keys(name) + (_cover_key(name),)
    kb, kx, kbox, kov, kcv = keys
    cover_prev = extra.get(kcv, torch.zeros((), dtype=torch.bool,
                                            device=x.device))
    bucket, overflow = build_cell_buckets(spec, x, box)
    rebuilt = (bucket, x, box, extra[kov] | overflow,
               cover_prev | coverage_deficient(spec, box))
    if force:
        return dict(zip(keys, rebuilt))
    need = needs_rebuild(spec, extra, x, box, name)
    kept = (extra[kb], extra[kx], extra[kbox], extra[kov], cover_prev)
    return {k: torch.where(need, new, old)
            for k, new, old in zip(keys, rebuilt, kept)}


def update_all_neighbors(system, extra, x, box, force: bool = False):
    """update_neighbors for every spec of `system` whose bucket `extra`
    holds. The signature is the JAX package's; every caller in the port
    (Context's loops, the barostat) passes force=True, and force=False,
    the device-side select, has no production caller yet."""
    out = {}
    for name, spec in iter_specs(system):
        if _keys(name)[0] in extra:
            out.update(update_neighbors(spec, extra, x, box, name,
                                        force=force))
    return out


# --------------------------------------------------------------------------
# Pair evaluation over cell buckets
# --------------------------------------------------------------------------


def _sweep(spec):
    from . import pair_kernel

    return (pair_kernel.half_pair_energy_forces if spec.half_stencil
            else pair_kernel.full_pair_energy_forces)


def cell_pair_energy(form, x, box, per_particle, spec, bucket, r_cut):
    """Pair energy over the cell buckets (the sweep's energy column)."""
    e, _ = _sweep(spec)(form, x, box, per_particle, spec, bucket, r_cut,
                        with_forces=False)
    return e


def cell_pair_energy_forces(form, x, box, per_particle, spec, bucket, r_cut):
    """(energy, forces (N, 3)) with explicit symmetric forces: the Newton
    half-stencil sweep (K1) when half maps exist, else the full-stencil
    sweep (K2); the CUDA kernel on the card, its plain twin on the CPU;
    either box form."""
    return _sweep(spec)(form, x, box, per_particle, spec, bucket, r_cut)


_FN_SLOTS = 1 << 21  # pair slots per chunk of the callable sweep


def cell_pair_energy_fn(pair_fn, x, box, per_particle, spec, bucket, r_cut):
    """Sum of a Python pair function pair_fn(r, pi, pj) over the cell list,
    as torch operations on the device of x: every home atom meets every
    slot of its full stencil (spec.nbr_cells), both orderings of a pair,
    each at weight 1/2; slots past r_cut, excluded pairs (the bitmask, or
    the exclusion id columns) and padding are masked. per_particle holds
    any (N,) tensors, gathered into pi / pj. Differentiable in x, so forces
    come by autograd.

    This is the path for user expressions, which no hand-written kernel can
    take; it evaluates every slot of the stencil, so its cost grows with
    the whole cell list, however few pairs the function leaves nonzero."""
    from .pair_kernel import _rc2, excluded
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
    exc_bits = exc_cols = None
    if spec.excbits is not None:
        exc_bits = spec.excbits
    else:
        exc = spec.exclusions
        exc_cols = torch.cat([exc, exc.new_full((1, exc.shape[1]), -1)])
    chunk = max(1, min(ncells, _FN_SLOTS // (cap * s * cap)))
    total = torch.zeros((), dtype=x.dtype, device=dev)
    for lo in range(0, ncells, chunk):
        cells = torch.arange(lo, min(lo + chunk, ncells), device=dev)
        b = len(cells)
        hid = ids_s[cells][:, :, None]                        # (B, cap, 1)
        cid = ids_s[ncid_all[cells]].reshape(b, 1, s * cap)   # (B, 1, S cap)
        d = minimum_image(xp[hid] - xp[cid], box)
        r2 = torch.sum(d * d, dim=-1)
        valid = (hid < n) & (cid < n) & (r2 < rc2) & ~excluded(
            hid, cid, None if exc_bits is None else exc_bits[hid],
            None if exc_cols is None else exc_cols[hid])
        r2m = torch.where(valid, r2, torch.ones_like(r2))
        pi = {k: v[hid] for k, v in pp.items()}
        pj = {k: v[cid] for k, v in pp.items()}
        u, _ = pair_eval(pair_fn, r2m, pi, pj, with_tangent=False)
        total = total + 0.5 * torch.sum(torch.where(valid, u,
                                                    torch.zeros_like(u)))
    return total
