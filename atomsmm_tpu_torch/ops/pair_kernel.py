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

Exclusions take the spec's form (NeighborSpec.exclusion_form): the
relative-offset bitmask alone, or the split form where some excluded pairs
lie more than +-14 indices apart (the bitmask within the window, each
atom's far ids beside it, a row of any width); both kernels and both twins
take each. Both take either box form too: given a (3, 3) cell
matrix, a kernel inverts it per thread and rounds each slot's displacement
in fractional coordinates, as ``pbc.minimum_image`` does.

K2 and its twin take a home-cell range ``cells=(c0, c1)``: only the atoms
of the cells c0 ... c1 - 1 get their rows, the others stay zero, so the rows
of disjoint ranges sum to the rows of the whole sweep bit for bit (force
decomposition over home cells, parallel/spatial.py).

Both kernels take a replica axis, as the JAX package's vmapped sweep
reaches ``pallas_call`` through its batching rule: given a stack of K rows
(x (K, N, 3), the bucket (K, ncells, cap), the box (K, 3) or (K, 3, 3),
each per-particle column (N,) or (K, N), and the rows' softcore lambdas
(K,) or None) one launch over a (blocks, K) grid sweeps every row into a
(K, N + 1, 4) output. An input the rows share may be an expanded tensor
(stride 0): the K lambda states of one configuration pass x and the
bucket once. Row k of the launch computes what the single-row launch of
row k computes: K2's bit for bit, K1's to its atomics' last bits. The
plain twins take the same stack, with the same per-row arithmetic.

Both kernels take a user pair function (CustomNonbondedForce) in place of a
built-in form, as the Pallas kernels take any ``pair_fn``: a UserForm
(ops/pairtrace.py) carries the function lowered to a list of operations,
which the card runs as the generated device code compiled into K1 or K2
(one library per function, exclusion form and image, built at first use:
_build.build_user) and the plain twins run as torch operations with the
same dual rules. Its (N + 1, P) block of per-particle columns (P <= 5, in
the lowered form's order) takes the place of (charge, sigma, epsilon); its
runtime constants go as a device array. A user form takes the replica axis
as the built-in forms do: over a stack its constants may be a (K, C) table,
row k the constants of row k (the globals of a lambda state), which the
kernels read at the row's offset as a built-in form reads its row's
lambda; the stack's rows then take one launch.

On a CUDA tensor a wrapper launches its kernel or raises; it never falls
back. On a CPU tensor it runs the plain twin, which the tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .neighbors import EXC_OFF
from .pairfuncs import PairForm, form_u_dudr2
from .pairtrace import UserForm
from .pbc import minimum_image

#: kernel launches so far in this process, one plain integer per kernel
#: (half_pair = K1, cell_pair = K2, tile_pair = K3, block_pair = K4 in
#: ops/blocks.py; a launch over K rows counts one); reset by callers
LAUNCHES = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0, "block_pair": 0}
#: launches of K1, K2 and K3 compiled with a user form (_user_sweep_cuda,
#: tilepair.tile_pair_cuda), counted apart from the built-in forms' and
#: reset with them (a launch over K rows counts one)
USER_LAUNCHES = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0}
#: sweeps of the callable cell sweep (neighbors.cell_pair_energy_fn: a pair
#: function as torch operations, forces by autograd), the route of a
#: CustomNonbondedForce whose function does not lower; reset with the
#: launches
CALLABLE_SWEEPS = {"cell": 0}

K1_MAX_CAP = 1024  # K1's cell capacity: one thread a home atom
_PLAIN_SLOTS = 1 << 21  # pair slots per chunk of the full-stencil plain twin


def reset_launches():
    for counts in (LAUNCHES, USER_LAUNCHES, CALLABLE_SWEEPS):
        for k in counts:
            counts[k] = 0


def kernel_form(pair) -> bool:
    """Whether `pair` is a form the kernels take (a built-in PairForm or a
    lowered UserForm), not a pair function for the callable sweeps."""
    return isinstance(pair, (PairForm, UserForm))


def user_columns(form: UserForm, per_particle, n: int, dtype, device):
    """The (N + 1, P) block of a user form's per-particle columns in its
    order, row N zero (P >= 1: a function of r alone stages one zero
    column)."""
    names = form.lowered.names
    cols = torch.zeros((n + 1, max(1, len(names))), dtype=dtype,
                       device=device)
    for k, name in enumerate(names):
        cols[:n, k] = per_particle[name]
    return cols


def _rows(x, per_particle, bucket, box, lamb=None):
    """The inputs of a sweep over a leading row axis (replicas or lambda
    states): x (K, N, 3) as given, or a single system's (N, 3) as one row,
    with the bucket and the box the same way; the per-particle columns stay
    (N,), shared by every row, or (K, N). Returns (single, x, bucket, box,
    lamb) with `lamb` (K,) or None."""
    single = x.ndim == 2
    if single:
        if lamb is not None:
            raise ValueError("a per-row lambda needs a (K, N, 3) stack of "
                             "positions")
        return True, x[None], bucket[None], box[None], None
    k = x.shape[0]
    if bucket.ndim != 3 or bucket.shape[0] != k or box.shape[0] != k \
            or box.ndim not in (2, 3):
        raise ValueError(
            f"a sweep over {k} rows takes a (K, ncells, cap) bucket and a "
            f"(K, 3) or (K, 3, 3) box, got {tuple(bucket.shape)} and "
            f"{tuple(box.shape)}")
    if lamb is not None:
        lamb = torch.as_tensor(lamb, device=x.device).reshape(-1)
        if lamb.shape[0] != k:
            raise ValueError(f"{lamb.shape[0]} lambdas for {k} rows")
    return False, x, bucket, box, lamb


def stage_rows(spec, x, per_particle, bucket, names=None):
    """stage over a row axis: x (K, N, 3), bucket (K, ncells, cap), each
    per-particle column (N,) or (K, N); hf (K, ncells, cap, 8), hm
    (K, ncells, cap, 2) and the far exclusion ids (K, ncells, cap, R) or
    None. Row k is what stage gives for row k alone. `names` (a user
    form's columns, at most 5) puts those columns at 3, 4, ... in place of
    charge, sigma, epsilon and the LJ type."""
    k, n = x.shape[0], x.shape[1]
    feats = x.new_zeros((k, n + 1, 8))
    feats[:, :n, :3] = x
    if names is not None:
        for c, name in enumerate(names):
            feats[:, :n, 3 + c] = per_particle[name]
    else:
        feats[:, :n, 3] = per_particle["charge"]
        feats[:, :n, 4] = per_particle["sigma"]
        feats[:, :n, 5] = per_particle["epsilon"]
    if names is None and "lj_type" in per_particle:
        feats[:, :n, 6] = per_particle["lj_type"].to(x.dtype)
    idx = bucket.long()
    rows = torch.arange(k, device=x.device)[:, None, None]
    meta = torch.zeros((n + 1, 2), dtype=torch.int32, device=x.device)
    meta[:, 0] = torch.arange(n + 1, dtype=torch.int32, device=x.device)
    meta[:, 1] = spec.excbits
    exc_cols = spec.exclusions_far
    if exc_cols is not None:
        exc_cols = torch.cat(
            [exc_cols, exc_cols.new_full((1, exc_cols.shape[1]), -1)])[idx]
    return feats[rows, idx], meta[idx], exc_cols


def stage(spec, x, per_particle, bucket):
    """Stage bucket-layout features for the plain twins, one row gather each:
    hf (ncells, cap, 8) [x y z q sigma eps type 0] in the dtype of x (type:
    the LJ type where the dict has ``lj_type``, else 0), and
    hm (ncells, cap, 2) int32 [atom id, exclusion bits]. Padding slots
    (id N) read a zero feature row. The spec's far exclusion ids (the
    split form) come back as a third item, (ncells, cap, R), -1 padded;
    None in the bitmask form."""
    hf, hm, exc_cols = stage_rows(spec, x[None], per_particle, bucket[None])
    return hf[0], hm[0], None if exc_cols is None else exc_cols[0]


def _rc2(r_cut, dtype) -> float:
    """r_cut² rounded as the working dtype computes it."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return float(np.asarray(float(r_cut), np_dtype) ** 2)


def excluded(hid, cid, exc_h=None, cols=None):
    """Excluded slots, the self pair included, for broadcastable home ids
    `hid` and candidate ids `cid`: bit (cid - hid + 16) of the home atoms'
    bitmask `exc_h`, or, given the home atoms' exclusion id columns `cols`
    (shaped like hid with a trailing column axis), hid == cid or any column
    equal to cid; given both (the split form: the far ids in `cols`), a
    slot either excludes. The kernels test exactly this per slot, in the
    bitmask and the split forms."""
    out = None
    if exc_h is not None:
        off = torch.clamp(cid - hid + EXC_OFF, 0, 31).long()
        out = ((exc_h.long() & 0xFFFFFFFF) >> off) & 1 == 1
    if cols is not None:
        by_cols = (hid == cid) | torch.any(cid[..., None] == cols.long(),
                                           dim=-1)
        out = by_cols if out is None else out | by_cols
    return out


def pair_table_of(form, per_particle):
    """The (T, T, 4) type-pair table a table form reads, None for
    Lorentz-Berthelot combining and for a user form; raises where the form
    and the per-particle dict disagree."""
    if isinstance(form, UserForm):
        return None
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
    home and candidate types (feature column 6); a user form evaluates its
    lowered operations on the columns 3, 4, ... of both rows."""
    r2 = torch.sum(d * d, dim=-1)
    valid = valid & (r2 < rc2)
    r2m = torch.where(valid, r2, torch.ones_like(r2))
    if isinstance(form, UserForm):
        p = len(form.lowered.names)
        u, dudr2 = form.u_dudr2(r2m, [home[..., 3 + c] for c in range(p)],
                                [cand[..., 3 + c] for c in range(p)])
        zero = torch.zeros_like(u)
        return torch.where(valid, u, zero), torch.where(valid, 2.0 * dudr2,
                                                        zero)
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


def _names(form):
    """A user form's column names (stage_rows), None for a built-in
    form."""
    return form.lowered.names if isinstance(form, UserForm) else None


def _row_form(form, lamb, d):
    """`form` with each row's lambda, as a tensor that broadcasts over the
    slots of the displacements d (rows first, a trailing xyz axis), in
    their dtype: the kernels cast a row's lambda to the working type too.
    A user form's (K, C) constants the same way, each constant a tensor
    that broadcasts over the slots. The form itself for lamb None and a
    user form's (C,) constants."""
    if isinstance(form, UserForm):
        c = form.consts
        if c.ndim != 2:
            return form
        shape = (c.shape[0],) + (1,) * (d.ndim - 2) + (c.shape[1],)
        return dataclasses.replace(form, consts=c.to(d.dtype).reshape(shape))
    if lamb is None:
        return form
    shape = (lamb.shape[0],) + (1,) * (d.ndim - 2)
    return dataclasses.replace(form, lamb=lamb.to(d.dtype).reshape(shape))


def _flat_ids(ids, n, k):
    """(K, ...) atom ids as flat rows of a (K (N + 1), 4) output."""
    off = torch.arange(k, device=ids.device) * (n + 1)
    return (ids.reshape(k, -1).long() + off[:, None]).reshape(-1)


def half_pair_plain(x, per_particle, bucket, spec, box, form, r_cut,
                    with_forces: bool = True, lamb=None):
    """Plain PyTorch twin of K1: the same inputs and the same output, the
    per-atom (N + 1, 4) [fx fy fz e] (row N: the padding, zero). Each home
    atom takes the force and the energy of its slots (the self direction's
    energy at weight 1/2, both orderings being inside it), each candidate
    of the other directions the reaction. Exclusions in the spec's form
    (the bitmask, and the far ids in the split form). Home cells
    run `spec.cell_chunk` at a time.

    Over a row axis (x (K, N, 3), bucket (K, ncells, cap), box (K, 3) or
    (K, 3, 3), each per-particle column (N,) or (K, N), `lamb` None or the
    rows' softcore lambdas (K,)) it gives (K, N + 1, 4), row k the sweep of
    row k alone, with spec.cell_chunk // K home cells a chunk."""
    single, x, bucket, box, lamb = _rows(x, per_particle, bucket, box, lamb)
    k, n = x.shape[0], x.shape[1]
    table = pair_table_of(form, per_particle)
    hf, hm, exc_cols = stage_rows(spec, x, per_particle, bucket,
                                  _names(form))
    nbr_half = spec.nbr_cells_half
    _, ncells, cap, _ = hf.shape
    s_half = nbr_half.shape[1]
    rc2 = _rc2(r_cut, hf.dtype)
    out = x.new_zeros((k, n + 1, 4))
    flat = out.view(-1, 4)
    w_col = hf.new_ones(s_half)
    w_col[0] = 0.5                 # self column: both orderings inside
    j_col = hf.new_ones(s_half)
    j_col[0] = 0.0                 # self column: no reaction
    chunk = max(1, spec.cell_chunk // k)
    for lo in range(0, ncells, chunk):
        cells = torch.arange(lo, min(lo + chunk, ncells), device=hf.device)
        home = hf[:, cells][:, :, None, :, None, :]       # (K, B, 1, cap, 1, 8)
        hid = hm[:, cells][..., 0][:, :, None, :, None]   # (K, B, 1, cap, 1)
        ncid = nbr_half[cells].long()                     # (B, S)
        cand = hf[:, ncid][:, :, :, None, :, :]           # (K, B, S, 1, cap, 8)
        cid = hm[:, ncid][..., 0][:, :, :, None, :]       # (K, B, S, 1, cap)
        d = minimum_image(home[..., :3] - cand[..., :3], box, rows=True)
        valid = (hid < n) & (cid < n) & ~excluded(
            hid, cid, hm[:, cells][..., 1][:, :, None, :, None],
            None if exc_cols is None
            else exc_cols[:, cells][:, :, None, :, None, :])
        u, fm = _pair_sums(_row_form(form, lamb, d), rc2, d, valid, home,
                           cand, table)
        oh = hf.new_zeros((k, len(cells), cap, 4))
        oh[..., 3] = torch.sum(u * w_col[None, None, :, None, None],
                               dim=(2, 4))
        if with_forces:
            g = fm[..., None] * d
            oh[..., :3] = -torch.sum(g, dim=(2, 4))
            react = torch.sum(g, dim=3) * j_col[None, None, :, None, None]
            flat.index_add_(0, _flat_ids(cid, n, k),
                            torch.nn.functional.pad(react, (0, 1))
                            .reshape(-1, 4))
        flat.index_add_(0, _flat_ids(hm[:, cells][..., 0], n, k),
                        oh.reshape(-1, 4))
    return out[0] if single else out


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
                    with_forces: bool = True, cells=None, lamb=None):
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
    dropped), so every row is the whole sweep's, bit for bit.

    Over a row axis (as half_pair_plain takes it) it gives (K, N + 1, 4),
    a chunk holding 2M pair slots over all rows. Each atom's row is summed
    whole inside one chunk, so row k equals the sweep of row k alone bit
    for bit, whatever the chunks."""
    single, x, bucket, box, lamb = _rows(x, per_particle, bucket, box, lamb)
    k, n = x.shape[0], x.shape[1]
    table = pair_table_of(form, per_particle)
    hf, hm, exc_cols = stage_rows(spec, x, per_particle, bucket,
                                  _names(form))
    nbr = spec.nbr_cells
    _, ncells, cap, _ = hf.shape
    s = nbr.shape[1]
    chunk = max(1, min(spec.cell_chunk,
                       _PLAIN_SLOTS // (k * cap * s * cap)))
    rc2 = _rc2(r_cut, hf.dtype)
    c0, c1 = home_range(cells, ncells)
    out = x.new_zeros((k, n + 1, 4))
    flat = out.view(-1, 4)
    hf_s = torch.cat([hf, hf.new_zeros((k, 1, cap, 8))], dim=1)
    ids_s = torch.cat([hm[..., 0], hm.new_full((k, 1, cap), n)], dim=1)
    ncid_all = torch.where(nbr >= 0, nbr, ncells).long()
    for lo in range(c0 - c0 % chunk, c1, chunk):
        hi = min(lo + chunk, ncells)
        home_cells = torch.arange(lo, hi, device=hf.device)
        b = len(home_cells)
        home = hf[:, home_cells][:, :, :, None, :]        # (K, B, cap, 1, 8)
        hid = hm[:, home_cells][..., 0][:, :, :, None]    # (K, B, cap, 1)
        ncid = ncid_all[home_cells]                       # (B, S)
        cand = hf_s[:, ncid].reshape(k, b, 1, s * cap, 8)
        cid = ids_s[:, ncid].reshape(k, b, 1, s * cap)
        d = minimum_image(home[..., :3] - cand[..., :3], box, rows=True)
        valid = (hid < n) & (cid < n) & ~excluded(
            hid, cid, hm[:, home_cells][..., 1][:, :, :, None],
            None if exc_cols is None
            else exc_cols[:, home_cells][:, :, :, None, :])
        u, fm = _pair_sums(_row_form(form, lamb, d), rc2, d, valid, home,
                           cand, table)
        rows = hf.new_zeros((k, b, cap, 4))
        rows[..., 3] = 0.5 * torch.sum(u, dim=-1)
        if with_forces:
            rows[..., :3] = -torch.sum(fm[..., None] * d, dim=3)
        keep = slice(max(c0 - lo, 0), min(c1, hi) - lo)
        flat.index_add_(0, _flat_ids(hid[:, keep], n, k),
                        rows[:, keep].reshape(-1, 4))
    return out[0] if single else out


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
    # last, r_cut^2 in float64: a float32 kernel decides the slots within
    # pair_forms.cuh::CUT_BAND of the cutoff against it, in float64
    scal = (ctypes.c_double * (2 + len(scalars)))(
        _rc2(r_cut, dtype), *scalars, _rc2(r_cut, torch.float64))
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


def _row_stride(kernel, name, t, k, shape, dtype, dev):
    """The element stride between the K rows of `t` (K, *shape): 0 where
    the rows share one array (an expanded tensor) or K is 1, else one
    row's size. Each row must be a contiguous CUDA tensor of `dtype` on
    `dev`; raises otherwise."""
    if t.device != dev or not t.is_cuda:
        raise ValueError(f"{kernel}: {name} must lie on a CUDA device with "
                         f"the others ({dev}), found {t.device}")
    row = t[0] if t.ndim else t
    if t.dtype != dtype or tuple(t.shape) != (k, *shape) \
            or not row.is_contiguous():
        raise ValueError(
            f"{kernel}: {name}: expected {k} contiguous rows of {dtype} "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    stride = t.stride(0)
    if k == 1 or stride == 0:
        return 0
    if stride != row.numel():
        raise ValueError(f"{kernel}: {name}: rows {stride} elements apart, "
                         f"expected {row.numel()} (packed) or 0 (shared)")
    return stride


def _cell_sweep_cuda(kernel, nbr, x, per_particle, bucket, spec, box, form,
                     r_cut, cells=(), lamb=None):
    """Launch K1 or K2 (they take the same arguments, and K2 the home-cell
    range `cells` = (c0, c1) after ncells) over the stencil map `nbr` on
    PyTorch's current stream; returns the per-atom (N + 1, 4)
    [fx fy fz e], allocated and zeroed here (an empty range launches
    nothing). Checks device, dtype, shape and
    contiguity first and raises if the launch is refused. The spec's
    exclusion form selects the kernel's (the bitmask alone, or the split
    form: the bitmask and the far ids); the box's
    shape, (3,) or (3, 3), selects the kernel's minimum image; a table
    form passes the LJ types (as int32) and the (T, T, 4) table, which
    must be a contiguous tensor on the device in the dtype of x.

    Over a row axis (x (K, N, 3); see half_pair_plain) one launch sweeps
    every row on a (blocks, K) grid and returns (K, N + 1, 4). x, the
    bucket, the box and each per-particle column pass with their row
    strides: packed rows, or stride 0 where the rows share one array (a
    (N,) column, or an expanded tensor: the lambda states of one
    configuration share x and the bucket). The softcore lambda of each
    row, `lamb` (K,), goes as a device table, a contiguous tensor on the
    device in the dtype of x; the rest of the parameter block is the
    host's, shared by the rows. A user form goes to _user_sweep_cuda."""
    import ctypes

    if isinstance(form, UserForm):
        if lamb is not None:
            raise ValueError(f"{kernel}: a user form takes no rows' lambdas")
        return _user_sweep_cuda(kernel, nbr, x, per_particle, bucket, spec,
                                box, form, r_cut, cells)
    single, x, bucket, box, lamb = _rows(x, per_particle, bucket, box, lamb)
    k, n = x.shape[0], x.shape[1]
    _, ncells, cap = bucket.shape
    s = nbr.shape[1]

    def rows_of(col):
        return col.contiguous().expand(k, n) if col.ndim == 1 else col

    q, sig, eps = (rows_of(per_particle[key]) for key in
                   ("charge", "sigma", "epsilon"))
    table = pair_table_of(form, per_particle)
    types, tables = None, ()
    if table is not None:
        types = rows_of(per_particle["lj_type"].to(torch.int32))
        ntypes = table.shape[0]
        tables = (("pair_table", table, x.dtype, (ntypes, ntypes, 4)),)
    bits, cols, m, exc_checks = _exclusion_tables(kernel, spec, n)
    tri = int(box.ndim == 3)
    lambs = () if lamb is None else (("lamb", lamb, x.dtype, (k,)),)
    dev = _checked(kernel, ("x", x[0], x.dtype, (n, 3)), *exc_checks,
                   ("stencil map", nbr, torch.int32, (ncells, s)), *tables,
                   *lambs)
    strides = (ctypes.c_longlong * 7)(*(
        _row_stride(kernel, name, t, k, shape, dtype, dev)
        if t is not None else 0 for name, t, shape, dtype in (
            ("x", x, (n, 3), x.dtype), ("charge", q, (n,), x.dtype),
            ("sigma", sig, (n,), x.dtype), ("epsilon", eps, (n,), x.dtype),
            ("lj_type", types, (n,), torch.int32),
            ("bucket", bucket, (ncells, cap), torch.int32),
            ("box", box, (3, 3) if tri else (3,), x.dtype))))
    out = torch.zeros((k, n + 1, 4), dtype=x.dtype, device=dev)
    _row_stride(kernel, "out", out, k, (n + 1, 4), x.dtype, dev)
    if cells and cells[0] == cells[1]:
        return out[0] if single else out
    scal, flags = _form_block(form, r_cut, x.dtype)
    _launch(kernel, x.dtype, x.data_ptr(), q.data_ptr(), sig.data_ptr(),
            eps.data_ptr(), types.data_ptr() if table is not None else None,
            table.data_ptr() if table is not None else None,
            None if bits is None else bits.data_ptr(),
            None if cols is None else cols.data_ptr(), bucket.data_ptr(),
            nbr.data_ptr(),
            box.data_ptr(), ncells, *cells, cap, s, n, m, tri,
            ntypes if table is not None else 0, k, ctypes.addressof(strides),
            None if lamb is None else lamb.data_ptr(),
            ctypes.addressof(scal), ctypes.addressof(flags), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return out[0] if single else out


def _exclusion_tables(kernel, spec, n):
    """The spec's exclusion tables for K1 and K2: (bitmask, far ids or
    None, their width, their _checked entries); raises where the spec
    holds no table."""
    bits, far = spec.excbits, spec.exclusions_far
    if bits is None:
        raise ValueError(f"{kernel}: the spec holds no exclusion table")
    m = 0 if far is None else far.shape[1]
    checks = [("excbits", bits, torch.int32, (n + 1,))]
    if far is not None:
        checks.append(("far exclusions", far, torch.int32, (n, m)))
    return bits, far, m, checks


def _user_sweep_cuda(kernel, nbr, x, per_particle, bucket, spec, box, form,
                     r_cut, cells=()):
    """Launch K1 or K2 compiled with a user form (_build.load_user: one
    library per generated header, exclusion form and image) on PyTorch's
    current stream; returns the per-atom (N + 1, 4) [fx fy fz e]. The
    form's working dtype must be x's; its columns are staged as an
    (N + 1, P) block (user_columns) and its constants pass as the device
    array form.consts. Over a row axis (x (K, N, 3), as _cell_sweep_cuda
    takes it) one launch sweeps every row into (K, N + 1, 4): x, the
    bucket, the box, the column block and the constants pass with their
    row strides, the constants (C,) shared by the rows or a (K, C) table,
    row k the constants of row k. Checks its arguments and raises if the
    build or the launch fails; counts the launch in USER_LAUNCHES."""
    import ctypes

    from .. import _build

    low = form.lowered
    if x.dtype != low.dtype:
        raise ValueError(f"{kernel}: the user form was lowered in "
                         f"{low.dtype}, x is {x.dtype}")
    single, x, bucket, box, _ = _rows(x, per_particle, bucket, box)
    k, n = x.shape[0], x.shape[1]
    _, ncells, cap = bucket.shape
    s = nbr.shape[1]
    cols = user_columns(form, per_particle, n, x.dtype, x.device)
    cols = cols.expand(k, *cols.shape)
    consts = form.consts.to(device=x.device, dtype=x.dtype)
    if consts.ndim == 1:
        consts = consts.contiguous().expand(k, low.n_consts)
    elif single or tuple(consts.shape) != (k, low.n_consts):
        raise ValueError(f"{kernel}: constants of shape "
                         f"{tuple(consts.shape)} for {k} rows of "
                         f"{low.n_consts} constants")
    bits, far, m, exc_checks = _exclusion_tables(kernel, spec, n)
    tri = int(box.ndim == 3)
    dev = _checked(kernel, ("x", x[0], x.dtype, (n, 3)), *exc_checks,
                   ("stencil map", nbr, torch.int32, (ncells, s)))
    p = cols.shape[-1]
    strides = (ctypes.c_longlong * 5)(*(
        _row_stride(kernel, name, t, k, shape, dtype, dev)
        for name, t, shape, dtype in (
            ("x", x, (n, 3), x.dtype), ("columns", cols, (n + 1, p), x.dtype),
            ("bucket", bucket, (ncells, cap), torch.int32),
            ("box", box, (3, 3) if tri else (3,), x.dtype))),
        # a form without constants reads none
        _row_stride(kernel, "constants", consts, k, (low.n_consts,), x.dtype,
                    dev) if low.n_consts else 0)
    out = torch.zeros((k, n + 1, 4), dtype=x.dtype, device=dev)
    if cells and cells[0] == cells[1]:
        return out[0] if single else out
    scal, flags = _form_block(form, r_cut, x.dtype)
    fn = _build.load_user(kernel, low.cuda_source(), int(far is not None),
                          tri)
    err = fn(x.data_ptr(), cols.data_ptr(), bits.data_ptr(),
             None if far is None else far.data_ptr(), bucket.data_ptr(),
             nbr.data_ptr(), box.data_ptr(), ncells, *cells, cap, s, n, m,
             p, low.n_consts, consts.data_ptr() if low.n_consts else None,
             form.dconst, k, ctypes.addressof(strides),
             ctypes.addressof(scal), ctypes.addressof(flags), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch on a user form failed: "
                           f"CUDA error {err}")
    USER_LAUNCHES[kernel] += 1
    return out[0] if single else out


def half_pair_cuda(x, per_particle, bucket, spec, box, form, r_cut,
                   lamb=None):
    """Launch K1 (see _cell_sweep_cuda) over the half stencil. A cell
    capacity above K1_MAX_CAP raises ValueError (the sweeps of
    ops/neighbors.py send such grids to K2)."""
    cap = bucket.shape[-1]
    if not 1 <= cap <= K1_MAX_CAP:
        raise ValueError(f"half_pair: cell capacity {cap} outside the "
                         f"kernel's 1..{K1_MAX_CAP} (one thread per home "
                         "atom)")
    return _cell_sweep_cuda("half_pair", spec.nbr_cells_half, x, per_particle,
                            bucket, spec, box, form, r_cut, lamb=lamb)


def full_pair_cuda(x, per_particle, bucket, spec, box, form, r_cut,
                   cells=None, lamb=None):
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
                            home_range(cells, bucket.shape[-2]), lamb=lamb)


def _sweep_rows(cuda, plain, form, x, box, per_particle, spec, bucket, r_cut,
                with_forces, **kw):
    """The per-atom (N + 1, 4) rows ((K, N + 1, 4) over a row axis): the
    kernel for a CUDA tensor, the plain twin for a CPU tensor."""
    if x.is_cuda:
        if x.ndim == 2:
            x, box = x.contiguous(), box.contiguous()
        return cuda(x, per_particle, bucket, spec, box, form, r_cut, **kw)
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
                         bucket, r_cut, with_forces, lamb):
    out = _sweep_rows(cuda, plain, form, x, box, per_particle, spec, bucket,
                      r_cut, with_forces, lamb=lamb)
    energy = out[..., 3].sum(-1)
    return energy, (out[..., :-1, :3] if with_forces else None)


def half_pair_energy_forces(form, x, box, per_particle, spec, bucket, r_cut,
                            with_forces: bool = True, lamb=None):
    """(energy, forces (N, 3) or None) over the half-stencil cell pairs:
    K1 for a CUDA tensor, its plain twin for a CPU tensor. Over a row axis
    (K, N, 3): (K,) energies and (K, N, 3) forces from one launch."""
    return _sweep_energy_forces(half_pair_cuda, half_pair_plain, form, x, box,
                                per_particle, spec, bucket, r_cut, with_forces,
                                lamb)


def full_pair_energy_forces(form, x, box, per_particle, spec, bucket, r_cut,
                            with_forces: bool = True, lamb=None):
    """(energy, forces (N, 3) or None) over the full-stencil cell pairs:
    K2 for a CUDA tensor, its plain twin for a CPU tensor. Over a row axis
    (K, N, 3): (K,) energies and (K, N, 3) forces from one launch."""
    return _sweep_energy_forces(full_pair_cuda, full_pair_plain, form, x, box,
                                per_particle, spec, bucket, r_cut, with_forces,
                                lamb)
