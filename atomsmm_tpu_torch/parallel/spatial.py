"""Spatial decomposition over the ranks of a device mesh (counterpart of
atomsmm_tpu/parallel/spatial.py).

  * pair sweeps: FORCE decomposition over home cells. Every rank holds the
    replicated positions and buckets and sweeps its contiguous range of
    home cells [r C', min((r + 1) C', C)), C' = ceil(C / D), on the full
    stencil: K2 (csrc/cell_pair.cu) with that range on the card, its
    plain twin on the CPU. A home atom's row is complete on the one rank
    that owns its cell and zero elsewhere, so one all_reduce of the
    (N + 1, 4) rows gives the rows of the one-rank full-stencil sweep bit
    for bit. The Newton half stencil would write reactions across ranks,
    so a half-stencil spec sweeps its full map here. A user pair function
    (the callable sweep) takes each rank's gradient of its share of the
    energy and one all_reduce of the gradient: no collective is
    differentiated.
  * PME reciprocal sum, atom-sharded: each rank spreads its shard of the
    atoms, one all_reduce of the grid, the FFT and the convolution on
    every rank, each rank's gather of its shard's forces, one all_reduce
    of the forces.
  * PME reciprocal sum, slab FFT (D dividing K1 and K2): reduce_scatter of
    the spread grid along K1, rfft over K3 and fft over K2 on the slab,
    one all_to_all to (K1, K2 / D, K3 // 2 + 1), fft over K1, the rank's
    K2 block of the influence function; the energy is one all_reduce. The
    forces come back along the transpose: ifft over K1, all_to_all back,
    ifft over K2 and irfft over K3 to the rank's slab of the grid
    potential, an all_gather of the slabs and the gather of the rank's
    atom shard.

Every function takes the mesh (a 1-D DeviceMesh) and its axis name; the
collectives run on the mesh's process group (NCCL across cards, gloo on
the CPU). gloo takes CUDA tensors for all_reduce and broadcast only, so on
the card under gloo only the sweeps and the atom-sharded sum run; where a
collective refuses a tensor, the call fails.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import pme
from ..ops.neighbors import cell_pair_energy_fn
from ..ops.pair_kernel import full_pair_rows, kernel_form
from ..ops.pairfuncs import virial_form
from .mesh import mesh_group


def _shard(count, d, r):
    """[lo, hi) of rank r's contiguous share of `count` items over d."""
    per = -(-count // d)
    return min(r * per, count), min((r + 1) * per, count)


def home_cells(ncells, mesh, axis: str = "dp"):
    """(c0, c1): the home cells this rank sweeps."""
    _, d, r = mesh_group(mesh, axis)
    return _shard(ncells, d, r)


def _all_reduce(t, mesh, axis):
    dist.all_reduce(t, group=mesh_group(mesh, axis)[0])
    return t


def sharded_cell_pair_rows(form, x, box, per_particle, spec, bucket, r_cut,
                           mesh, axis: str = "dp", with_forces: bool = True):
    """The per-atom (N + 1, 4) [fx fy fz e] rows of the full-stencil sweep
    of the built-in pair form `form`, each rank sweeping its home cells,
    after one all_reduce: the one-rank full-stencil rows bit for bit."""
    rows = full_pair_rows(form, x, box, per_particle, spec, bucket, r_cut,
                          with_forces,
                          cells=home_cells(bucket.shape[0], mesh, axis))
    return _all_reduce(rows, mesh, axis)


def _local_fn_energy(pair_fn, x, box, per_particle, spec, bucket, r_cut,
                     mesh, axis):
    return cell_pair_energy_fn(pair_fn, x, box, per_particle, spec, bucket,
                               r_cut, cells=home_cells(bucket.shape[0], mesh,
                                                       axis))


def _reduced(energy, *arrays, mesh, axis):
    """(energy, *arrays) summed over the ranks in one all_reduce."""
    energy = energy.detach().reshape(1)
    flat = torch.cat([energy] + [a.reshape(-1) for a in arrays])
    _all_reduce(flat, mesh, axis)
    out, at = [flat[0]], 1
    for a in arrays:
        out.append(flat[at:at + a.numel()].view(a.shape))
        at += a.numel()
    return tuple(out)


def _fn_gradient(energy_of, x):
    """(energy, -d energy/dx) of one rank's share; zeros where the share
    does not depend on x (an empty range)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        e = energy_of(xx)
        if not e.requires_grad:
            return e.detach(), torch.zeros_like(x)
        (g,) = torch.autograd.grad(e, xx, allow_unused=True)
    return e.detach(), torch.zeros_like(x) if g is None else -g


def sharded_cell_pair_energy_forces(pair, x, box, per_particle, spec, bucket,
                                    r_cut, mesh, axis: str = "dp"):
    """(energy, forces (N, 3)): force decomposition of the cell-pair sweep
    over `mesh[axis]`. `pair` is a form the kernels take, a built-in
    PairForm or a lowered user form (K2 or its twin over
    the rank's home cells, one all_reduce of the rows: the one-rank
    full-stencil sweep's numbers exactly) or a pair function pair(r, pi,
    pj) (the callable sweep over the rank's home cells, forces by
    autograd, one all_reduce of energy and gradient)."""
    if kernel_form(pair):
        rows = sharded_cell_pair_rows(pair, x, box, per_particle, spec,
                                      bucket, r_cut, mesh, axis)
        return rows[:, 3].sum(), rows[:-1, :3]
    e, f = _fn_gradient(lambda xx: _local_fn_energy(
        pair, xx, box, per_particle, spec, bucket, r_cut, mesh, axis), x)
    return _reduced(e, f, mesh=mesh, axis=axis)


def sharded_cell_pair_energy(pair, x, box, per_particle, spec, bucket, r_cut,
                             mesh, axis: str = "dp"):
    """The energy of sharded_cell_pair_energy_forces, without the forces:
    each rank's share summed, one all_reduce of the scalar."""
    if kernel_form(pair):
        rows = full_pair_rows(pair, x, box, per_particle, spec, bucket,
                              r_cut, False,
                              cells=home_cells(bucket.shape[0], mesh, axis))
        e = rows[:, 3].sum()
    else:
        e = _local_fn_energy(pair, x, box, per_particle, spec, bucket, r_cut,
                             mesh, axis)
    return _reduced(e, mesh=mesh, axis=axis)[0]


def sharded_cell_pair_virial(pair, x, box, per_particle, spec, bucket, r_cut,
                             mesh, axis: str = "dp"):
    """(W, forces (N, 3)) of the sharded sweep, W = -dU(s x, s box)/ds at
    s = 1: one sweep of the form's virial form (each pair's d . F in the
    energy column), or for a pair function each rank's autograd virial of
    its share and one all_reduce."""
    if kernel_form(pair):
        return sharded_cell_pair_energy_forces(
            virial_form(pair), x, box, per_particle, spec, bucket, r_cut,
            mesh, axis)
    from ..forces import autograd_virial

    w, f = autograd_virial(lambda xx, bb: _local_fn_energy(
        pair, xx, bb, per_particle, spec, bucket, r_cut, mesh, axis), x, box)
    return _reduced(w, f, mesh=mesh, axis=axis)


def _atom_shard(n, mesh, axis):
    """[lo, hi) of this rank's contiguous shard of n atoms."""
    _, d, r = mesh_group(mesh, axis)
    return _shard(n, d, r)


def _forces_of_shard(phi, setup, x, q, box, lo, hi, grid_shape, order,
                     mesh, axis):
    f = x.new_zeros(x.shape)
    f[lo:hi] = pme.gather_forces(phi, setup, q[lo:hi], box, grid_shape, order)
    return _all_reduce(f, mesh, axis)


def sharded_pme_reciprocal_energy(x, box, q, alpha, grid_shape, mesh,
                                  axis: str = "dp", order: int = 4,
                                  with_forces: bool = True):
    """(energy, forces (N, 3) or None) of the PME reciprocal sum with
    atom-sharded spreading, one grid all_reduce, the FFT and convolution on
    every rank, and each rank's gather of its shard's forces combined by
    one all_reduce. Matches ops/pme.pme_reciprocal_energy_forces to
    rounding (the spread adds in another order)."""
    grid_shape = tuple(grid_shape)
    lo, hi = _atom_shard(x.shape[0], mesh, axis)
    setup = pme.spline_setup(x[lo:hi], box, grid_shape, order)
    grid = _all_reduce(pme.spread_setup(setup, q[lo:hi], grid_shape), mesh,
                       axis)
    pme.EVALUATIONS["reciprocal"] += 1
    if not with_forces:
        return pme.pme_reciprocal_from_grid(grid, box, alpha, grid_shape,
                                            order), None
    energy, phi = pme.reciprocal_potential(grid, box, alpha, grid_shape,
                                           order)
    return energy, _forces_of_shard(phi, setup, x, q, box, lo, hi,
                                    grid_shape, order, mesh, axis)


def _transpose(t, d, group, to_k2_blocks):
    """The all_to_all of the slab FFT on a complex tensor: (K1 / D, K2,
    K3r) -> (K1, K2 / D, K3r) with `to_k2_blocks`, and back without."""
    real = torch.view_as_real(t)
    if to_k2_blocks:
        b1, k2, k3r, _ = real.shape
        send = real.reshape(b1, d, k2 // d, k3r, 2).transpose(0, 1)
    else:
        k1, b2, k3r, _ = real.shape
        send = real.reshape(d, k1 // d, b2, k3r, 2)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if to_k2_blocks:  # recv[j]: rank j's K1 block of this rank's K2 block
        return torch.view_as_complex(recv.reshape(-1, *recv.shape[2:]))
    # recv[j]: rank j's K2 block of this rank's K1 block
    return torch.view_as_complex(
        recv.transpose(0, 1).reshape(recv.shape[1], -1, *recv.shape[3:])
        .contiguous())


def sharded_pme_reciprocal_energy_fft(x, box, q, alpha, grid_shape, mesh,
                                      axis: str = "dp", order: int = 4,
                                      with_forces: bool = True):
    """(energy, forces (N, 3) or None) of the PME reciprocal sum with a
    slab-decomposed FFT (see the module docstring). Requires K1 and K2
    divisible by the rank count D (choose_pme_parameters(...,
    multiple_of=D)); matches ops/pme.pme_reciprocal_energy_forces to
    rounding."""
    k1, k2, k3 = grid_shape = tuple(int(k) for k in grid_shape)
    group, d, r = mesh_group(mesh, axis)
    if k1 % d or k2 % d:
        raise ValueError(
            f"slab FFT needs K1 ({k1}) and K2 ({k2}) divisible by the "
            f"device count ({d}); build the grid with "
            "choose_pme_parameters(..., multiple_of=n_devices)")
    lo, hi = _atom_shard(x.shape[0], mesh, axis)
    setup = pme.spline_setup(x[lo:hi], box, grid_shape, order)
    grid = pme.spread_setup(setup, q[lo:hi], grid_shape)
    slab = grid.new_empty((k1 // d, k2, k3))
    # reduce_scatter_tensor, under its newer name where torch has one
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        slab, grid, group=group)                           # K1 block r
    s = torch.fft.fft(torch.fft.rfft(slab, dim=2), dim=1)
    s = torch.fft.fft(_transpose(s, d, group, True), dim=0)
    block = slice(r * (k2 // d), (r + 1) * (k2 // d))
    pme.EVALUATIONS["reciprocal"] += 1
    energy, bq = pme.convolve(s, box, alpha, grid_shape, order, block)
    energy = _reduced(energy, mesh=mesh, axis=axis)[0]
    if not with_forces:
        return energy, None
    t = _transpose(torch.fft.ifft(bq, dim=0), d, group, False)
    phi_slab = torch.fft.irfft(torch.fft.ifft(t, dim=1), n=k3, dim=2) \
        * (2.0 * k1 * k2 * k3)
    slabs = [torch.empty_like(phi_slab) for _ in range(d)]
    dist.all_gather(slabs, phi_slab.contiguous(), group=group)
    return energy, _forces_of_shard(torch.cat(slabs), setup, x, q, box, lo,
                                    hi, grid_shape, order, mesh, axis)
