"""Spatial decomposition of a Context over the ranks of a device mesh
(counterpart of atomsmm_tpu/parallel/mesh.py).

The force objects stay mesh-agnostic. An *active spatial mesh* (a module
registry that `spatial_mesh` sets, and `SpatialContext` around every entry
point that evaluates a force) makes the pair sweeps and the PME reciprocal
sum of forces.py run their sharded forms (parallel/spatial.py):

  * pair sweeps: force decomposition over home cells on the full stencil
    (K2 over each rank's range of home cells), one all_reduce of the
    per-atom rows;
  * PME reciprocal sum: the slab FFT where the rank count divides K1 and
    K2, else atom-sharded spreading with one grid all_reduce;
  * bonded terms, corrections and the neighbor rebuild: replicated.

A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh``; its process
group carries the collectives. The port is SPMD, one process per rank:
every rank builds the same system and state and calls the same entry
points. The caller initialises the process group (``torchrun``, a test,
chip_smoke.py); nothing here does.

Keeping the ranks equal. Each rank runs the replicated parts itself, and on
the card some of them scatter with atomics (the bonded forces' autograd,
the PME corrections), so two ranks can round the same step differently in
the last bits; a trajectory is chaotic, and ranks that bin atoms from
drifted positions would sweep an atom twice or not at all. So at every
rebuild of the cell lists (`update_neighbor_lists`) the state is broadcast
from the first rank of the group (`synchronize_state`: x, v, the box and
the floating extras, the thermostat chains and force caches among them,
one broadcast per dtype; 2.4 MB of x and v at 100k atoms in float32), and
a barostat's trial positions are broadcast before its trial buckets are
built. The buckets are then built from bitwise equal positions on every
rank, and a step(n) ends with bitwise equal states. On one rank nothing is
sent.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch

_ACTIVE: Optional[Tuple[object, str]] = None


def mesh_group(mesh, axis: str = "dp"):
    """(process group, rank count D, this rank's index in the group) of a
    1-D DeviceMesh; TypeError for anything else, ValueError for an axis
    the mesh does not name."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(
            f"expected a 1-D torch.distributed.device_mesh.DeviceMesh, got "
            f"{type(mesh).__name__}"
            + (f" of {mesh.ndim} dimensions" if isinstance(mesh, DeviceMesh)
               else ""))
    names = mesh.mesh_dim_names
    if names is not None and axis not in names:
        raise ValueError(f"mesh axis {axis!r} not in the mesh's {names}")
    return mesh.get_group(0), mesh.size(), mesh.get_local_rank(0)


def active_spatial_mesh():
    """The (mesh, axis) force evaluations shard over, or None."""
    return _ACTIVE


@contextmanager
def spatial_mesh(mesh, axis: str = "dp"):
    """Shard the force evaluations made inside over `mesh[axis]`."""
    global _ACTIVE
    mesh_group(mesh, axis)
    prev = _ACTIVE
    _ACTIVE = (mesh, axis)
    try:
        yield
    finally:
        _ACTIVE = prev


def broadcast_from_first(tensors):
    """The tensors as the group's first rank holds them, under an active
    spatial mesh of more than one rank (one broadcast per dtype); else the
    tensors themselves."""
    if _ACTIVE is None or not tensors:
        return list(tensors)
    import torch.distributed as dist

    group, d, _ = mesh_group(*_ACTIVE)
    if d == 1:
        return list(tensors)
    src = dist.get_global_rank(group, 0)
    out = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        at = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in at])
        dist.broadcast(flat, src, group=group)
        for i, piece in zip(at, flat.split([tensors[i].numel()
                                            for i in at])):
            out[i] = piece.view(tensors[i].shape)
    return out


def synchronize_state(state):
    """`state` with x, v, the box and every floating extra broadcast from
    the first rank of the active spatial mesh (see the module docstring);
    `state` itself without a mesh or on one rank."""
    if _ACTIVE is None or mesh_group(*_ACTIVE)[1] == 1:
        return state
    from ..utils import replace

    keys = [k for k, v in state.extra.items() if v.is_floating_point()]
    x, v, box, *extra = broadcast_from_first(
        [state.x, state.v, state.box] + [state.extra[k] for k in keys])
    return replace(state, x=x, v=v, box=box,
                   extra={**state.extra, **dict(zip(keys, extra))})


class SpatialContext:
    """A Context whose force evaluations are spatially decomposed over
    `mesh` (a 1-D DeviceMesh): the same surface, with the mesh active
    around every entry point that evaluates a force (step, the barostat's
    trials inside it, get_state, getState, retune_neighbors,
    conserved_energy) and around the Context's construction. Every rank
    constructs it with the same system, integrator and state::

        dist.init_process_group("nccl")          # e.g. under torchrun
        mesh = init_device_mesh("cuda", (dist.get_world_size(),),
                                mesh_dim_names=("dp",))
        ctx = SpatialContext(system, integrator, state, mesh=mesh)
        ctx.step(100)      # K2 over each rank's home cells, one all_reduce
    """

    _TRACED = ("step", "get_state", "getState", "retune_neighbors",
               "conserved_energy")

    def __init__(self, system, integrator, state=None, mesh=None,
                 axis: str = "dp", seed: int = 0):
        from ..context import Context

        if mesh is None:
            raise ValueError("SpatialContext requires a mesh (a 1-D "
                             "torch.distributed.device_mesh.DeviceMesh)")
        self._mesh, self._axis = mesh, axis
        with spatial_mesh(mesh, axis):
            self._inner = Context(system, integrator, state, seed=seed)

    def __getattr__(self, name):
        inner = object.__getattribute__(self, "_inner")
        attr = getattr(inner, name)
        if name in self._TRACED and callable(attr):
            mesh, axis = self._mesh, self._axis

            def wrapped(*a, **kw):
                with spatial_mesh(mesh, axis):
                    out = attr(*a, **kw)
                return self if out is inner else out

            return wrapped
        return attr

    @property
    def mesh(self):
        return self._mesh
