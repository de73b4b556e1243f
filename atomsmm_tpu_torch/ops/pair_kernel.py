"""Cell-pair sweeps: the wrappers of the CUDA kernels csrc/half_pair.cu (K1)
and csrc/cell_pair.cu (K2), and their plain PyTorch twins.

K1, the Newton half-stencil sweep (counterpart of
atomsmm_tpu/ops/pallas_pair.py::stage_and_run_half), replaces
``_half_kernel``. One thread block per (home cell, direction), one home atom
per thread, the candidate cell staged in shared memory, the reaction sums
accumulated there. The blocks of a CUDA grid run in no order, so instead of
the TPU's sequential accumulation across J-tiles every block writes its own
(cell, direction) outputs and the wrapper reduces them:

    f_bucket = oh.sum(direction)[..., :3] + oc[inv_cells_half, direction].sum(direction)

K2, the full-stencil sweep without Newton (counterpart of
``pallas_pair.py::stage_and_run``), replaces ``_pair_kernel``. It runs where
the grid is too small for half maps. One thread block per (home cell,
candidate tile of 128, home chunk of 128); each block writes its partial
[fx fy fz e/2] per home atom and the wrapper adds the tiles of each cell.

Both then scatter bucket slots to atoms (every real atom sits in exactly
one slot; the sentinel row N is dropped). Exclusions take the relative-
offset bitmask when the spec has one, else the exclusion id columns (pairs
more than +-14 indices apart); both kernels and both twins take either.

On a CUDA tensor a wrapper launches its kernel or raises; it never falls
back. On a CPU tensor it runs the plain twin, which the tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .neighbors import EXC_OFF, _scatter_forces
from .pairfuncs import form_u_dudr2
from .pbc import minimum_image

#: kernel launches so far in this process, one plain integer per kernel
#: (half_pair = K1, cell_pair = K2, tile_pair = K3); reset by callers
LAUNCHES = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0}

FULL_TILE = 128   # csrc/cell_pair.cu: candidates per tile, home atoms per block
MAX_EXC = 16      # csrc/pair_forms.cuh: exclusion columns a kernel takes
_PLAIN_SLOTS = 1 << 21  # pair slots per chunk of the full-stencil plain twin


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stage(spec, x, per_particle, bucket):
    """Stage bucket-layout features with one row gather each:
    hf (ncells, cap, 8) [x y z q sigma eps 0 0] in the dtype of x, and
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


def _pair_sums(form, rc2, d, valid, home, cand):
    """Masked (u, 2 du/dr²) of the slots of displacement d, between home
    rows (..., cap_h, 1, 8) and candidate rows (..., 1, cap_c, 8)."""
    r2 = torch.sum(d * d, dim=-1)
    valid = valid & (r2 < rc2)
    r2m = torch.where(valid, r2, torch.ones_like(r2))
    qq = home[..., 3] * cand[..., 3]
    sig = 0.5 * (home[..., 4] + cand[..., 4])
    eps = torch.sqrt(home[..., 5] * cand[..., 5])
    u, dudr2 = form_u_dudr2(form, r2m, qq, sig, eps)
    zero = torch.zeros_like(u)
    return torch.where(valid, u, zero), torch.where(valid, 2.0 * dudr2, zero)


def half_pair_plain(hf, hm, nbr_half, box, form, r_cut, n: int, chunk: int,
                    exc_cols=None, with_forces: bool = True):
    """Plain PyTorch twin of K1: the same inputs, the same (oh, oc)
    outputs, (ncells, S, cap, 4) and (ncells, S, cap, 3). Exclusions by the
    relative-offset bitmask, as the kernel does, or by the id columns
    `exc_cols` when given. Home cells run `chunk` at a time."""
    ncells, cap, _ = hf.shape
    s_half = nbr_half.shape[1]
    rc2 = _rc2(r_cut, hf.dtype)
    oh = hf.new_zeros((ncells, s_half, cap, 4))
    oc = hf.new_zeros((ncells, s_half, cap, 3)) if with_forces else None
    w_col = hf.new_ones(s_half)
    w_col[0] = 0.5                 # self column: both orderings inside
    j_col = hf.new_ones(s_half)
    j_col[0] = 0.0                 # self column: no reaction
    for lo in range(0, ncells, chunk):
        cells = torch.arange(lo, min(lo + chunk, ncells), device=hf.device)
        home = hf[cells][:, None, :, None, :]          # (B, 1, cap, 1, 8)
        hid = hm[cells][..., 0][:, None, :, None]      # (B, 1, cap, 1)
        ncid = nbr_half[cells].long()                  # (B, S)
        cand = hf[ncid][:, :, None, :, :]              # (B, S, 1, cap, 8)
        cid = hm[ncid][..., 0][:, :, None, :]          # (B, S, 1, cap)
        d = minimum_image(home[..., :3] - cand[..., :3], box)
        valid = (hid < n) & (cid < n) & ~excluded(
            hid, cid, hm[cells][..., 1][:, None, :, None],
            None if exc_cols is None else exc_cols[cells][:, None, :, None, :])
        u, fm = _pair_sums(form, rc2, d, valid, home, cand)
        hi = lo + len(cells)
        oh[lo:hi, ..., 3] = torch.sum(u * w_col[None, :, None, None], dim=-1)
        if with_forces:
            g = fm[..., None] * d
            oh[lo:hi, ..., :3] = -torch.sum(g, dim=3)
            oc[lo:hi] = torch.sum(g, dim=2) * j_col[None, :, None, None]
    return oh, oc


def full_pair_plain(hf, hm, nbr, box, form, r_cut, n: int, chunk: int,
                    exc_cols=None, with_forces: bool = True):
    """Plain PyTorch twin of K2: the same inputs, and the kernel's output
    summed over its candidate tiles, (ncells, cap, 4) [fx fy fz e/2] per
    home slot. Padding columns of `nbr` (-1) read the sentinel cell, whose
    slots are all masked. Exclusions as in half_pair_plain. Home cells run
    `chunk` at a time, fewer where a chunk would exceed 2M pair slots."""
    ncells, cap, _ = hf.shape
    s = nbr.shape[1]
    chunk = max(1, min(chunk, _PLAIN_SLOTS // (cap * s * cap)))
    rc2 = _rc2(r_cut, hf.dtype)
    out = hf.new_zeros((ncells, cap, 4))
    hf_s = torch.cat([hf, hf.new_zeros((1, cap, 8))])
    ids_s = torch.cat([hm[..., 0], hm.new_full((1, cap), n)])
    ncid_all = torch.where(nbr >= 0, nbr, ncells).long()
    for lo in range(0, ncells, chunk):
        cells = torch.arange(lo, min(lo + chunk, ncells), device=hf.device)
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
        u, fm = _pair_sums(form, rc2, d, valid, home, cand)
        out[lo:lo + b, :, 3] = 0.5 * torch.sum(u, dim=-1)
        if with_forces:
            out[lo:lo + b, :, :3] = -torch.sum(fm[..., None] * d, dim=2)
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

    scal = (ctypes.c_double * 10)(_rc2(r_cut, dtype), *form.scalars())
    flags = (ctypes.c_int * 3)(*form.flags())
    return scal, flags


def _exc_args(kernel, hf, exc_cols):
    """(pointer or None, m, the int32 columns to keep alive) of the
    exclusion-column form, checked against the staged features hf."""
    if exc_cols is None:
        return None, 0, None
    m = exc_cols.shape[-1]
    if not 1 <= m <= MAX_EXC:
        raise ValueError(f"{kernel}: {m} exclusion columns per atom, the "
                         f"kernel takes 1..{MAX_EXC}")
    cols = exc_cols.to(torch.int32).contiguous()
    _checked(kernel, ("hf", hf, hf.dtype, hf.shape),
             ("exc_cols", cols, torch.int32, hf.shape[:2] + (m,)))
    return cols.data_ptr(), m, cols


def _launch(kernel, dtype, *args):
    from .. import _build

    lib = _build.load(kernel)
    fn = getattr(lib, f"{kernel}_{'f32' if dtype == torch.float32 else 'f64'}")
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1


def half_pair_cuda(hf, hm, nbr_half, box, form, r_cut, n: int,
                   exc_cols=None):
    """Launch K1 on PyTorch's current stream; returns (oh, oc) as allocated
    here. Checks device, dtype, shape and contiguity first and raises if the
    launch is refused. `exc_cols` selects the exclusion-column form."""
    import ctypes

    ncells, cap, _ = hf.shape
    s_half = nbr_half.shape[1]
    dev = _checked("half_pair",
                   ("hf", hf, hf.dtype, (ncells, cap, 8)),
                   ("hm", hm, torch.int32, (ncells, cap, 2)),
                   ("nbr_half", nbr_half, torch.int32, (ncells, s_half)),
                   ("box", box, hf.dtype, (3,)))
    if not 1 <= cap <= 1024:
        raise ValueError(f"half_pair: cell capacity {cap} outside the "
                         "kernel's 1..1024 (one thread per home atom)")
    hx, m, _keep = _exc_args("half_pair", hf, exc_cols)
    oh = torch.empty((ncells, s_half, cap, 4), dtype=hf.dtype, device=dev)
    oc = torch.empty((ncells, s_half, cap, 3), dtype=hf.dtype, device=dev)
    scal, flags = _form_block(form, r_cut, hf.dtype)
    _launch("half_pair", hf.dtype, hf.data_ptr(), hm.data_ptr(), hx,
            nbr_half.data_ptr(), box.data_ptr(), ncells, cap, s_half, n, m,
            ctypes.addressof(scal), ctypes.addressof(flags), oh.data_ptr(),
            oc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return oh, oc


def full_pair_cuda(hf, hm, nbr, box, form, r_cut, n: int, exc_cols=None):
    """Launch K2 on PyTorch's current stream; returns its output summed
    over the candidate tiles, (ncells, cap, 4) [fx fy fz e/2]. Checks
    first and raises if the launch is refused."""
    import ctypes

    ncells, cap, _ = hf.shape
    s = nbr.shape[1]
    dev = _checked("cell_pair",
                   ("hf", hf, hf.dtype, (ncells, cap, 8)),
                   ("hm", hm, torch.int32, (ncells, cap, 2)),
                   ("nbr", nbr, torch.int32, (ncells, s)),
                   ("box", box, hf.dtype, (3,)))
    hx, m, _keep = _exc_args("cell_pair", hf, exc_cols)
    n_tiles = s * (-(-cap // FULL_TILE))
    out = torch.empty((ncells, n_tiles, cap, 4), dtype=hf.dtype, device=dev)
    scal, flags = _form_block(form, r_cut, hf.dtype)
    _launch("cell_pair", hf.dtype, hf.data_ptr(), hm.data_ptr(), hx,
            nbr.data_ptr(), box.data_ptr(), ncells, cap, s, n, m,
            ctypes.addressof(scal), ctypes.addressof(flags), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return out.sum(dim=1)


def half_writeback(oh, oc, inv_cells_half):
    """Bucket forces (ncells, cap, 3): home sums over the directions plus,
    for each direction k, the reaction sums computed by home cell
    inv[c, k] = c - d_k."""
    s_half = inv_cells_half.shape[1]
    dirs = torch.arange(s_half, device=oh.device)[None, :]
    gathered = oc[inv_cells_half.long(), dirs]        # (ncells, S, cap, 3)
    return oh[..., :3].sum(dim=1) + gathered.sum(dim=1)


def half_pair_energy_forces(form, x, box, per_particle, spec, bucket, r_cut,
                            with_forces: bool = True):
    """(energy, forces (N, 3) or None) over the half-stencil cell pairs:
    K1 for a CUDA tensor, its plain twin for a CPU tensor."""
    n = x.shape[0]
    hf, hm, exc_cols = stage(spec, x, per_particle, bucket)
    if x.is_cuda:
        oh, oc = half_pair_cuda(hf, hm, spec.nbr_cells_half, box.contiguous(),
                                form, r_cut, n, exc_cols)
    else:
        oh, oc = half_pair_plain(hf, hm, spec.nbr_cells_half, box, form,
                                 r_cut, n, spec.cell_chunk, exc_cols,
                                 with_forces)
    energy = oh[..., 3].sum()
    if not with_forces:
        return energy, None
    f_bucket = half_writeback(oh, oc, spec.inv_cells_half)
    return energy, _scatter_forces(f_bucket, bucket, n)


def full_pair_energy_forces(form, x, box, per_particle, spec, bucket, r_cut,
                            with_forces: bool = True):
    """(energy, forces (N, 3) or None) over the full-stencil cell pairs:
    K2 for a CUDA tensor, its plain twin for a CPU tensor."""
    n = x.shape[0]
    hf, hm, exc_cols = stage(spec, x, per_particle, bucket)
    if x.is_cuda:
        out = full_pair_cuda(hf, hm, spec.nbr_cells, box.contiguous(), form,
                             r_cut, n, exc_cols)
    else:
        out = full_pair_plain(hf, hm, spec.nbr_cells, box, form, r_cut, n,
                              spec.cell_chunk, exc_cols, with_forces)
    energy = out[..., 3].sum()
    if not with_forces:
        return energy, None
    return energy, _scatter_forces(out[..., :3], bucket, n)
