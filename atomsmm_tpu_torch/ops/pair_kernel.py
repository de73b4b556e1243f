"""Cell-pair sweeps: the wrappers of the CUDA kernels csrc/half_pair.cu (K1)
and csrc/cell_pair.cu (K2), and their plain PyTorch twins.

K1, the Newton half-stencil sweep (counterpart of
atomsmm_tpu/ops/pallas_pair.py::stage_and_run_half), replaces
``_half_kernel``. One thread block per home cell walks the half-stencil
directions, gathers the atoms itself through the bucket ids, tests every
slot before it evaluates the pair form on the hits, and adds per-atom
[fx fy fz e] to one zeroed (N + 1, 4) tensor by global atomics (row N takes
the padding). The blocks of a CUDA grid run in no order, so where the TPU
accumulated across J-tiles in sequence, the reactions meet in device memory:
the wrapper is a zero fill, the launch and the energy sum.

K2, the full-stencil sweep without Newton (counterpart of
``pallas_pair.py::stage_and_run``), replaces ``_pair_kernel``. It runs where
the grid is too small for half maps. It takes K1's inputs and gives K1's
output: a warp per home atom gathers the atoms through the bucket ids, walks
the real atoms of every stencil cell with its lanes across the candidates,
evaluates the hits 32 at a time and stores the atom's [fx fy fz e] row of
the zeroed (N + 1, 4) tensor. It writes no reactions, so it needs no atomics
and its result does not change from run to run; the wrapper is a zero fill,
the launch and the energy sum. It relies on every bucket row holding its
real ids first, as ``build_cell_buckets`` lays them out.

A table form (NBFIX force fields, the legacy 10-12 term: ``PairForm.table``)
reads each pair's (sigma, epsilon, A, B) from the force's (T, T, 4) type-pair
table instead of combining by Lorentz-Berthelot: the per-particle dict then
carries the LJ types ``lj_type`` (N,) and the table ``pair_table``; the
kernels stage the type in place of (sigma, epsilon) and gather the pair's
row from global memory, the twins stage it in feature column 6.

Exclusions take the relative-offset bitmask when the spec has one, else the
exclusion id columns (pairs more than +-14 indices apart); both kernels and
both twins take either. Both take either box form too: given a (3, 3) cell
matrix, a kernel inverts it per thread and rounds each slot's displacement
in fractional coordinates, as ``pbc.minimum_image`` does.

K2 and its twin take a home-cell range ``cells=(c0, c1)``: only the atoms
of the cells c0 ... c1 - 1 get their rows, the others stay zero, so the rows
of disjoint ranges sum to the rows of the whole sweep bit for bit (force
decomposition over home cells, parallel/spatial.py).

On a CUDA tensor a wrapper launches its kernel or raises; it never falls
back. On a CPU tensor it runs the plain twin, which the tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .neighbors import EXC_OFF
from .pairfuncs import form_u_dudr2
from .pbc import minimum_image

#: kernel launches so far in this process, one plain integer per kernel
#: (half_pair = K1, cell_pair = K2, tile_pair = K3); reset by callers
LAUNCHES = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0}

MAX_EXC = 16      # csrc/pair_forms.cuh: exclusion columns a kernel takes
_PLAIN_SLOTS = 1 << 21  # pair slots per chunk of the full-stencil plain twin


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stage(spec, x, per_particle, bucket):
    """Stage bucket-layout features for the plain twins, one row gather each:
    hf (ncells, cap, 8) [x y z q sigma eps type 0] in the dtype of x (type:
    the LJ type where the dict has ``lj_type``, else 0), and
    hm (ncells, cap, 2) int32 [atom id, exclusion bits]. Padding slots (id N)
    read a zero feature row. Without a bitmask (excluded pairs more than
    +-14 indices apart) the exclusion id columns come back as a third item,
    (ncells, cap, M), -1 padded; else None."""
    n = x.shape[0]
    feats = x.new_zeros((n + 1, 8))
    feats[:n, :3] = x
    feats[:n, 3] = per_particle["charge"]
    feats[:n, 4] = per_particle["sigma"]
    feats[:n, 5] = per_particle["epsilon"]
    if "lj_type" in per_particle:
        feats[:n, 6] = per_particle["lj_type"].to(x.dtype)
    idx = bucket.long()
    meta = torch.zeros((n + 1, 2), dtype=torch.int32, device=x.device)
    meta[:, 0] = torch.arange(n + 1, dtype=torch.int32, device=x.device)
    exc_cols = None
    if spec.excbits is not None:
        meta[:, 1] = spec.excbits
    else:
        exc = spec.exclusions
        exc_cols = torch.cat([exc, exc.new_full((1, exc.shape[1]), -1)])[idx]
    return feats[idx].contiguous(), meta[idx].contiguous(), exc_cols


def _rc2(r_cut, dtype) -> float:
    """r_cut² rounded as the working dtype computes it."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return float(np.asarray(float(r_cut), np_dtype) ** 2)


def excluded(hid, cid, exc_h=None, cols=None):
    """Excluded slots, the self pair included, for broadcastable home ids
    `hid` and candidate ids `cid`: bit (cid - hid + 16) of the home atoms'
    bitmask `exc_h`, or, given the home atoms' exclusion id columns `cols`
    (shaped like hid with a trailing column axis), hid == cid or any column
    equal to cid. The kernels test exactly this per slot."""
    if cols is None:
        off = torch.clamp(cid - hid + EXC_OFF, 0, 31).long()
        return ((exc_h.long() & 0xFFFFFFFF) >> off) & 1 == 1
    return (hid == cid) | torch.any(cid[..., None] == cols.long(), dim=-1)


def pair_table_of(form, per_particle):
    """The (T, T, 4) type-pair table a table form reads, None for
    Lorentz-Berthelot combining; raises where the form and the
    per-particle dict disagree."""
    has = "lj_type" in per_particle
    if form.table != has or has != ("pair_table" in per_particle):
        raise ValueError(
            f"pair form table={form.table} with per-particle keys "
            f"{sorted(per_particle)}: a table form needs 'lj_type' and "
            "'pair_table', a Lorentz-Berthelot form neither")
    return per_particle["pair_table"] if has else None


def _pair_sums(form, rc2, d, valid, home, cand, table=None):
    """Masked (u, 2 du/dr²) of the slots of displacement d, between home
    rows (..., cap_h, 1, 8) and candidate rows (..., 1, cap_c, 8); with a
    type-pair `table` the pair's (sigma, epsilon, A, B) is its row at the
    home and candidate types (feature column 6)."""
    r2 = torch.sum(d * d, dim=-1)
    valid = valid & (r2 < rc2)
    r2m = torch.where(valid, r2, torch.ones_like(r2))
    qq = home[..., 3] * cand[..., 3]
    if table is None:
        sig = 0.5 * (home[..., 4] + cand[..., 4])
        eps = torch.sqrt(home[..., 5] * cand[..., 5])
        u, dudr2 = form_u_dudr2(form, r2m, qq, sig, eps)
    else:
        row = table[home[..., 6].long(), cand[..., 6].long()]
        u, dudr2 = form_u_dudr2(form, r2m, qq, row[..., 0], row[..., 1],
                                row[..., 2], row[..., 3])
    zero = torch.zeros_like(u)
    return torch.where(valid, u, zero), torch.where(valid, 2.0 * dudr2, zero)


def half_pair_plain(x, per_particle, bucket, spec, box, form, r_cut,
                    with_forces: bool = True):
    """Plain PyTorch twin of K1: the same inputs and the same output, the
    per-atom (N + 1, 4) [fx fy fz e] (row N: the padding, zero). Each home
    atom takes the force and the energy of its slots (the self direction's
    energy at weight 1/2, both orderings being inside it), each candidate
    of the other directions the reaction. Exclusions by the relative-offset
    bitmask when the spec has one, else by the id columns. Home cells run
    `spec.cell_chunk` at a time."""
    n = x.shape[0]
    table = pair_table_of(form, per_particle)
    hf, hm, exc_cols = stage(spec, x, per_particle, bucket)
    nbr_half = spec.nbr_cells_half
    ncells, cap, _ = hf.shape
    s_half = nbr_half.shape[1]
    rc2 = _rc2(r_cut, hf.dtype)
    out = x.new_zeros((n + 1, 4))
    w_col = hf.new_ones(s_half)
    w_col[0] = 0.5                 # self column: both orderings inside
    j_col = hf.new_ones(s_half)
    j_col[0] = 0.0                 # self column: no reaction
    for lo in range(0, ncells, spec.cell_chunk):
        cells = torch.arange(lo, min(lo + spec.cell_chunk, ncells),
                             device=hf.device)
        home = hf[cells][:, None, :, None, :]          # (B, 1, cap, 1, 8)
        hid = hm[cells][..., 0][:, None, :, None]      # (B, 1, cap, 1)
        ncid = nbr_half[cells].long()                  # (B, S)
        cand = hf[ncid][:, :, None, :, :]              # (B, S, 1, cap, 8)
        cid = hm[ncid][..., 0][:, :, None, :]          # (B, S, 1, cap)
        d = minimum_image(home[..., :3] - cand[..., :3], box)
        valid = (hid < n) & (cid < n) & ~excluded(
            hid, cid, hm[cells][..., 1][:, None, :, None],
            None if exc_cols is None else exc_cols[cells][:, None, :, None, :])
        u, fm = _pair_sums(form, rc2, d, valid, home, cand, table)
        oh = hf.new_zeros((len(cells), cap, 4))
        oh[..., 3] = torch.sum(u * w_col[None, :, None, None], dim=(1, 3))
        if with_forces:
            g = fm[..., None] * d
            oh[..., :3] = -torch.sum(g, dim=(1, 3))
            react = torch.sum(g, dim=2) * j_col[None, :, None, None]
            out.index_add_(0, cid.reshape(-1).long(),
                           torch.nn.functional.pad(react, (0, 1))
                           .reshape(-1, 4))
        out.index_add_(0, hm[cells][..., 0].reshape(-1).long(),
                       oh.reshape(-1, 4))
    return out


def home_range(cells, ncells):
    """(c0, c1) of a home-cell range, all cells for None; raises
    ValueError unless 0 <= c0 <= c1 <= ncells."""
    if cells is None:
        return 0, ncells
    c0, c1 = (int(c) for c in cells)
    if not 0 <= c0 <= c1 <= ncells:
        raise ValueError(f"home-cell range [{c0}, {c1}) outside the "
                         f"{ncells} cells of the grid")
    return c0, c1


def full_pair_plain(x, per_particle, bucket, spec, box, form, r_cut,
                    with_forces: bool = True, cells=None):
    """Plain PyTorch twin of K2: the same inputs and the same output, the
    per-atom (N + 1, 4) [fx fy fz e] (row N: the padding, zero). Each home
    atom takes the force and half the energy of its slots over the full
    stencil `spec.nbr_cells`, both orderings of each pair, no reactions.
    Padding columns of the stencil (-1) read the sentinel cell, whose slots
    are all masked. Exclusions as in half_pair_plain. Home cells run
    `spec.cell_chunk` at a time, fewer where a chunk would exceed 2M pair
    slots. `cells` = (c0, c1) gives rows to the atoms of those home cells
    only; the chunks stay where the whole sweep puts them (a chunk that
    the range cuts is computed whole and its rows outside the range
    dropped), so every row is the whole sweep's, bit for bit."""
    n = x.shape[0]
    table = pair_table_of(form, per_particle)
    hf, hm, exc_cols = stage(spec, x, per_particle, bucket)
    nbr = spec.nbr_cells
    ncells, cap, _ = hf.shape
    s = nbr.shape[1]
    chunk = max(1, min(spec.cell_chunk, _PLAIN_SLOTS // (cap * s * cap)))
    rc2 = _rc2(r_cut, hf.dtype)
    c0, c1 = home_range(cells, ncells)
    out = x.new_zeros((n + 1, 4))
    hf_s = torch.cat([hf, hf.new_zeros((1, cap, 8))])
    ids_s = torch.cat([hm[..., 0], hm.new_full((1, cap), n)])
    ncid_all = torch.where(nbr >= 0, nbr, ncells).long()
    for lo in range(c0 - c0 % chunk, c1, chunk):
        hi = min(lo + chunk, ncells)
        cells = torch.arange(lo, hi, device=hf.device)
        b = len(cells)
        home = hf[cells][:, :, None, :]                      # (B, cap, 1, 8)
        hid = hm[cells][..., 0][:, :, None]                  # (B, cap, 1)
        ncid = ncid_all[cells]                               # (B, S)
        cand = hf_s[ncid].reshape(b, 1, s * cap, 8)
        cid = ids_s[ncid].reshape(b, 1, s * cap)
        d = minimum_image(home[..., :3] - cand[..., :3], box)
        valid = (hid < n) & (cid < n) & ~excluded(
            hid, cid, hm[cells][..., 1][:, :, None],
            None if exc_cols is None else exc_cols[cells][:, :, None, :])
        u, fm = _pair_sums(form, rc2, d, valid, home, cand, table)
        rows = hf.new_zeros((b, cap, 4))
        rows[..., 3] = 0.5 * torch.sum(u, dim=-1)
        if with_forces:
            rows[..., :3] = -torch.sum(fm[..., None] * d, dim=2)
        keep = slice(max(c0 - lo, 0), min(c1, hi) - lo)
        out.index_add_(0, hid[keep].reshape(-1).long(),
                       rows[keep].reshape(-1, 4))
    return out


def _checked(kernel, *tensors):
    """Refuse what a kernel does not take: each (name, tensor, dtype, shape)
    must be a contiguous CUDA tensor of that dtype and shape, all on the
    device of the first, whose float dtype must be float32 or float64."""
    dev = tensors[0][1].device
    if tensors[0][1].dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel} takes float32 or float64, not "
                        f"{tensors[0][1].dtype}")
    for name, t, want, shape in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{kernel}: {name} must lie on a CUDA device "
                             f"with the others ({dev}), found {t.device}")
        if t.dtype != want or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name}: expected contiguous {want} {tuple(shape)}, "
                f"got {t.dtype} {tuple(t.shape)} "
                f"contiguous={t.is_contiguous()}")
    return dev


def _form_block(form, r_cut, dtype):
    """The host arrays (scal, flags) of pair_forms.cuh::make_params; the
    arrays must outlive the call."""
    import ctypes

    scalars, flags = form.scalars(), form.flags()
    scal = (ctypes.c_double * (1 + len(scalars)))(_rc2(r_cut, dtype), *scalars)
    flags = (ctypes.c_int * len(flags))(*flags)
    return scal, flags


def _launch(kernel, dtype, *args):
    from .. import _build

    lib = _build.load(kernel)
    fn = getattr(lib, f"{kernel}_{'f32' if dtype == torch.float32 else 'f64'}")
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1


def _cell_sweep_cuda(kernel, nbr, x, per_particle, bucket, spec, box, form,
                     r_cut, cells=()):
    """Launch K1 or K2 (they take the same arguments, and K2 the home-cell
    range `cells` = (c0, c1) after ncells) over the stencil map `nbr` on
    PyTorch's current stream; returns the per-atom (N + 1, 4)
    [fx fy fz e], allocated and zeroed here (an empty range launches
    nothing). Checks device, dtype, shape and
    contiguity first and raises if the launch is refused. A spec without
    the exclusion bitmask selects the exclusion-column form; the box's
    shape, (3,) or (3, 3), selects the kernel's minimum image; a table
    form passes the LJ types (as int32) and the (T, T, 4) table, which
    must be a contiguous tensor on the device in the dtype of x."""
    import ctypes

    n = x.shape[0]
    ncells, cap = bucket.shape
    s = nbr.shape[1]
    q, sig, eps = (per_particle[k].contiguous()
                   for k in ("charge", "sigma", "epsilon"))
    table = pair_table_of(form, per_particle)
    tables = ()
    if table is not None:
        types = per_particle["lj_type"].to(torch.int32).contiguous()
        ntypes = table.shape[0]
        tables = (("lj_type", types, torch.int32, (n,)),
                  ("pair_table", table, x.dtype, (ntypes, ntypes, 4)))
    if spec.excbits is not None:
        exc, m = spec.excbits, 0
        exc_check = ("excbits", exc, torch.int32, (n + 1,))
    else:
        exc = spec.exclusions
        m = exc.shape[1]
        if not 1 <= m <= MAX_EXC:
            raise ValueError(f"{kernel}: {m} exclusion columns per atom, the "
                             f"kernel takes 1..{MAX_EXC}")
        exc_check = ("exclusions", exc, torch.int32, (n, m))
    tri = int(box.ndim == 2)
    dev = _checked(kernel,
                   ("x", x, x.dtype, (n, 3)),
                   ("charge", q, x.dtype, (n,)),
                   ("sigma", sig, x.dtype, (n,)),
                   ("epsilon", eps, x.dtype, (n,)),
                   exc_check,
                   ("bucket", bucket, torch.int32, (ncells, cap)),
                   ("stencil map", nbr, torch.int32, (ncells, s)),
                   ("box", box, x.dtype, (3, 3) if tri else (3,)), *tables)
    out = torch.zeros((n + 1, 4), dtype=x.dtype, device=dev)
    if cells and cells[0] == cells[1]:
        return out
    scal, flags = _form_block(form, r_cut, x.dtype)
    _launch(kernel, x.dtype, x.data_ptr(), q.data_ptr(), sig.data_ptr(),
            eps.data_ptr(), types.data_ptr() if tables else None,
            table.data_ptr() if tables else None,
            exc.data_ptr() if m == 0 else None,
            exc.data_ptr() if m else None, bucket.data_ptr(), nbr.data_ptr(),
            box.data_ptr(), ncells, *cells, cap, s, n, m, tri,
            ntypes if tables else 0,
            ctypes.addressof(scal), ctypes.addressof(flags), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return out


def half_pair_cuda(x, per_particle, bucket, spec, box, form, r_cut):
    """Launch K1 (see _cell_sweep_cuda) over the half stencil."""
    cap = bucket.shape[1]
    if not 1 <= cap <= 1024:
        raise ValueError(f"half_pair: cell capacity {cap} outside the "
                         "kernel's 1..1024 (one thread per home atom)")
    return _cell_sweep_cuda("half_pair", spec.nbr_cells_half, x, per_particle,
                            bucket, spec, box, form, r_cut)


def full_pair_cuda(x, per_particle, bucket, spec, box, form, r_cut,
                   cells=None):
    """Launch K2 (see _cell_sweep_cuda) over the full stencil; any cell
    capacity. `cells` = (c0, c1) sweeps the home cells c0 ... c1 - 1 only
    (None: all); a range outside [0, ncells] raises ValueError before the
    launch. Every row of `bucket` must hold its real ids first, in any
    order, and the sentinel N after them, as build_cell_buckets lays them
    out: K2 ends a row's walk at its first sentinel, so atoms behind one are
    left out. This is not checked (only a read of the bucket on the host
    could); full_pair_plain takes any layout."""
    return _cell_sweep_cuda("cell_pair", spec.nbr_cells, x, per_particle,
                            bucket, spec, box, form, r_cut,
                            home_range(cells, bucket.shape[0]))


def _sweep_rows(cuda, plain, form, x, box, per_particle, spec, bucket, r_cut,
                with_forces, **kw):
    """The per-atom (N + 1, 4) rows: the kernel for a CUDA tensor, the
    plain twin for a CPU tensor."""
    if x.is_cuda:
        return cuda(x.contiguous(), per_particle, bucket, spec,
                    box.contiguous(), form, r_cut, **kw)
    return plain(x, per_particle, bucket, spec, box, form, r_cut,
                 with_forces, **kw)


def full_pair_rows(form, x, box, per_particle, spec, bucket, r_cut,
                   with_forces: bool = True, cells=None):
    """K2's per-atom (N + 1, 4) [fx fy fz e] over the home cells `cells`
    (None: all): the kernel for a CUDA tensor, its plain twin for a CPU
    tensor."""
    return _sweep_rows(full_pair_cuda, full_pair_plain, form, x, box,
                       per_particle, spec, bucket, r_cut, with_forces,
                       cells=cells)


def _sweep_energy_forces(cuda, plain, form, x, box, per_particle, spec,
                         bucket, r_cut, with_forces):
    out = _sweep_rows(cuda, plain, form, x, box, per_particle, spec, bucket,
                      r_cut, with_forces)
    energy = out[:, 3].sum()
    return energy, (out[:-1, :3] if with_forces else None)


def half_pair_energy_forces(form, x, box, per_particle, spec, bucket, r_cut,
                            with_forces: bool = True):
    """(energy, forces (N, 3) or None) over the half-stencil cell pairs:
    K1 for a CUDA tensor, its plain twin for a CPU tensor."""
    return _sweep_energy_forces(half_pair_cuda, half_pair_plain, form, x, box,
                                per_particle, spec, bucket, r_cut, with_forces)


def full_pair_energy_forces(form, x, box, per_particle, spec, bucket, r_cut,
                            with_forces: bool = True):
    """(energy, forces (N, 3) or None) over the full-stencil cell pairs:
    K2 for a CUDA tensor, its plain twin for a CPU tensor."""
    return _sweep_energy_forces(full_pair_cuda, full_pair_plain, form, x, box,
                                per_particle, spec, bucket, r_cut, with_forces)

