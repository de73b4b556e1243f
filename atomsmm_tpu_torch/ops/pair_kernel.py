"""Newton half-stencil cell-pair sweep: the wrapper of the CUDA kernel
csrc/half_pair.cu and its plain PyTorch twin (counterpart of
atomsmm_tpu/ops/pallas_pair.py::stage_and_run_half).

The kernel replaces atomsmm_tpu/ops/pallas_pair.py::_half_kernel. It is
bound by the pair-slot arithmetic, mostly the reciprocal square root and the
6th/12th powers of the pair forms, and its design keeps every pair tile in
registers or shared memory: one thread block per (home cell, direction),
one home atom per thread, the candidate cell staged in shared memory, the
reaction sums accumulated there. The blocks of a CUDA grid run in no order,
so instead of the TPU's sequential accumulation across J-tiles every block
writes its own (cell, direction) outputs and this wrapper reduces them:

    f_bucket = oh.sum(direction)[..., :3] + oc[inv_cells_half, direction].sum(direction)

then scatters bucket slots to atoms (every real atom sits in exactly one
slot; the sentinel row N is dropped). The energy is the sum of oh[..., 3].

On a CUDA tensor the wrapper launches the kernel or raises; it never falls
back. On a CPU tensor it runs the plain twin, ``half_pair_plain``, which
the tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .neighbors import KernelNotPortedError, _scatter_forces
from .pairfuncs import form_u_dudr2
from .pbc import minimum_image

#: kernel launches so far in this process (plain integer; reset by callers)
LAUNCHES = 0


def stage(spec, x, per_particle, bucket):
    """Stage bucket-layout features with one row gather each:
    hf (ncells, cap, 8) [x y z q sigma eps 0 0] in the dtype of x, and
    hm (ncells, cap, 2) int32 [atom id, exclusion bits]. Padding slots (id N)
    read a zero feature row. Without a bitmask (excluded pairs more than
    +-14 indices apart) the exclusion id columns come back as a third item,
    (ncells, cap, M), for the plain sweep; else None."""
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


def half_pair_plain(hf, hm, nbr_half, box, form, r_cut, n: int, chunk: int,
                    exc_cols=None, with_forces: bool = True):
    """Plain PyTorch twin of the kernel: the same inputs, the same (oh, oc)
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
        home = hf[cells]                               # (B, cap, 8)
        hid = hm[cells][..., 0]                        # (B, cap)
        ncid = nbr_half[cells].long()                  # (B, S)
        cand = hf[ncid]                                # (B, S, cap, 8)
        cid = hm[ncid][..., 0]                         # (B, S, cap)
        hi = hid[:, None, :, None]
        cj = cid[:, :, None, :]
        d = minimum_image(home[:, None, :, None, :3] - cand[:, :, None, :, :3],
                          box)                         # (B, S, cap, cap, 3)
        r2 = torch.sum(d * d, dim=-1)
        valid = (hi < n) & (cj < n) & (r2 < rc2)
        if exc_cols is None:
            off = torch.clamp(cj - hi + 16, 0, 31).long()
            exc_h = (hm[cells][..., 1].long() & 0xFFFFFFFF)[:, None, :, None]
            valid &= ((exc_h >> off) & 1) == 0
        else:
            cols = exc_cols[cells][:, None, :, None, :].long()
            valid &= (hi != cj) & ~torch.any(cj[..., None] == cols, dim=-1)
        r2m = torch.where(valid, r2, torch.ones_like(r2))
        qq = home[..., 3][:, None, :, None] * cand[..., 3][:, :, None, :]
        sig = 0.5 * (home[..., 4][:, None, :, None] + cand[..., 4][:, :, None, :])
        eps = torch.sqrt(home[..., 5][:, None, :, None]
                         * cand[..., 5][:, :, None, :])
        u, dudr2 = form_u_dudr2(form, r2m, qq, sig, eps)
        u = torch.where(valid, u, torch.zeros_like(u))
        oh[lo:lo + len(cells), ..., 3] = torch.sum(
            u * w_col[None, :, None, None], dim=-1)
        if with_forces:
            fm = torch.where(valid, 2.0 * dudr2, torch.zeros_like(dudr2))
            g = fm[..., None] * d
            oh[lo:lo + len(cells), ..., :3] = -torch.sum(g, dim=3)
            oc[lo:lo + len(cells)] = torch.sum(g, dim=2) \
                * j_col[None, :, None, None]
    return oh, oc


def half_pair_cuda(hf, hm, nbr_half, box, form, r_cut, n: int):
    """Launch the CUDA kernel on PyTorch's current stream; returns (oh, oc)
    as allocated here. Checks device, dtype, shape and contiguity first and
    raises if the launch is refused."""
    global LAUNCHES
    import ctypes

    from .. import _build

    ncells, cap, nf = hf.shape
    s_half = nbr_half.shape[1]
    dev = hf.device
    if hf.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"half_pair_cuda takes float32 or float64, not {hf.dtype}")
    for name, t, dtype, shape in (
            ("hf", hf, hf.dtype, (ncells, cap, 8)),
            ("hm", hm, torch.int32, (ncells, cap, 2)),
            ("nbr_half", nbr_half, torch.int32, (ncells, s_half)),
            ("box", box, hf.dtype, (3,))):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name} must lie on {dev}, found {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if nf != 8 or not 1 <= cap <= 1024:
        raise ValueError(f"cell capacity {cap} outside the kernel's 1..1024")
    lib = _build.load()
    oh = torch.empty((ncells, s_half, cap, 4), dtype=hf.dtype, device=dev)
    oc = torch.empty((ncells, s_half, cap, 3), dtype=hf.dtype, device=dev)
    scal = (ctypes.c_double * 10)(_rc2(r_cut, hf.dtype), *form.scalars())
    flags = (ctypes.c_int * 3)(*form.flags())
    fn = lib.half_pair_f32 if hf.dtype == torch.float32 else lib.half_pair_f64
    err = fn(hf.data_ptr(), hm.data_ptr(), nbr_half.data_ptr(), box.data_ptr(),
             ncells, cap, s_half, n, ctypes.addressof(scal),
             ctypes.addressof(flags), oh.data_ptr(), oc.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"half_pair kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return oh, oc


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
    the CUDA kernel for a CUDA tensor, the plain twin for a CPU tensor."""
    from .neighbors import _cell_pair_sums_half

    n = x.shape[0]
    if not x.is_cuda:
        e, f_bucket = _cell_pair_sums_half(spec, form, x, box, per_particle,
                                           bucket, r_cut, with_forces)
        return e, (None if f_bucket is None
                   else _scatter_forces(f_bucket, bucket, n))
    if not spec.half_stencil:
        raise KernelNotPortedError(
            "no half-stencil maps: the full-stencil kernel "
            "(atomsmm_tpu/ops/pallas_pair.py::_pair_kernel) has no CUDA port")
    if spec.excbits is None:
        raise KernelNotPortedError(
            "excluded pairs span more than +-14 atom indices, so the "
            "exclusion bitmask does not apply; the kernel's exclusion-column "
            "form has no CUDA port yet")
    hf, hm, _ = stage(spec, x, per_particle, bucket)
    oh, oc = half_pair_cuda(hf, hm, spec.nbr_cells_half, box.contiguous(),
                            form, r_cut, n)
    energy = oh[..., 3].sum()
    if not with_forces:
        return energy, None
    f_bucket = half_writeback(oh, oc, spec.inv_cells_half)
    return energy, _scatter_forces(f_bucket, bucket, n)
