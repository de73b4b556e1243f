"""Independent replicas of one system (counterpart of
atomsmm_tpu/parallel/replicas.py).

As in the JAX package the K replicas are one stacked State (state.py):
x and v (K, N, 3), box (K, 3) or (K, 3, 3), every extra with a leading K,
and one torch.Generator per row. A replica step is one batched step of the
whole stack: the forces of all K rows come from one launch of each pair
kernel over a (cells, K) grid (ops/pair_kernel.py), where the JAX package
vmaps its step. Row k's generator is seeded from (seed, k), so its stream
does not depend on K or on the ranks. Over a device mesh (a 1-D
torch.distributed DeviceMesh, one process per rank) rank r of D owns the
contiguous block of K / D rows [r K / D, (r + 1) K / D) and steps that block
in one batched call; `gather_replicas` fills the other ranks' rows in with
one all_reduce per dtype of the zero-padded stack (all_reduce, which gloo
takes for CUDA tensors too, where it refuses all_gather).

>>> import torch
>>> from atomsmm_tpu_torch.state import make_state
>>> reps = replicate_state(make_state(torch.zeros(2, 3),
...                                   box=torch.ones(3)), 3, seed=5)
>>> reps.rows, tuple(reps.x.shape), tuple(reps.box.shape)
(3, (3, 2, 3), (3, 3))
>>> a, b = (torch.rand(2, generator=g) for g in reps.rng[:2])
>>> bool((a != b).all())                        # distinct streams
True
"""
from __future__ import annotations

import numpy as np
import torch

from ..state import State
from ..utils import replace


def replica_block(k_states: int, mesh, axis: str = "dp"):
    """(lo, hi): the replicas [lo, hi) this rank owns over `mesh`; raises
    ValueError unless the rank count divides k_states."""
    from .mesh import mesh_group

    _, d, r = mesh_group(mesh, axis)
    if k_states % d:
        raise ValueError(f"{k_states} replicas do not divide over the {d} "
                         f"ranks of the mesh")
    per = k_states // d
    return r * per, (r + 1) * per


def gather_rows(local, k_states: int, mesh, axis: str = "dp"):
    """(K, ...) from this rank's rows `local` (K / D, ...) of its block
    (replica_block): one all_reduce of the zero-padded stack."""
    import torch.distributed as dist

    from .mesh import mesh_group

    lo, hi = replica_block(k_states, mesh, axis)
    full = local.new_zeros((k_states, *local.shape[1:]))
    full[lo:hi] = local
    dist.all_reduce(full, group=mesh_group(mesh, axis)[0])
    return full


def globals_block(globals, lo: int, hi: int):
    """The globals of the rows [lo, hi): each (K,) tensor cut to them (the
    tensor itself where they are all its rows), every other value shared
    as it is."""
    def cut(v):
        if not (isinstance(v, torch.Tensor) and v.ndim == 1):
            return v
        return v if (lo, hi) == (0, v.shape[0]) else v[lo:hi]

    return {name: cut(v) for name, v in (globals or {}).items()}


def _fields(state):
    """The tensors of a stacked State, by name: x, v, box and each extra."""
    return {"x": state.x, "v": state.v, "box": state.box,
            **{("extra", k): v for k, v in state.extra.items()}}


def gather_replicas(block: State, k_states: int, mesh, axis: str = "dp"):
    """The K-row stacked State whose rows [lo, hi) (this rank's,
    replica_block) are `block` and whose other rows are their owners':
    every tensor gathered in one all_reduce per dtype of a zero-padded
    (K, ...) stack (bool tensors travel as uint8). It keeps the block's
    generators and step counter. Every rank must hold a block of the same
    structure."""
    import torch.distributed as dist

    from .mesh import mesh_group

    group = mesh_group(mesh, axis)[0]
    lo, hi = replica_block(k_states, mesh, axis)
    fields = _fields(block)
    by_wire = {}
    for name, t in fields.items():
        wire = torch.uint8 if t.dtype == torch.bool else t.dtype
        by_wire.setdefault(wire, []).append(name)
    full = {}
    for wire, names in by_wire.items():
        sizes = [fields[nm][0].numel() for nm in names]
        buf = torch.zeros((k_states, sum(sizes)), dtype=wire,
                          device=block.x.device)
        buf[lo:hi] = torch.cat([fields[nm].reshape(hi - lo, -1).to(wire)
                                for nm in names], dim=1)
        dist.all_reduce(buf, group=group)
        for nm, piece in zip(names, buf.split(sizes, dim=1)):
            t = fields[nm]
            full[nm] = piece.reshape(k_states, *t.shape[1:]).to(t.dtype)
    return replace(block, x=full["x"], v=full["v"], box=full["box"],
                   extra={key: full[("extra", key)] for key in block.extra})


def _replica_seed(seed: int, k: int) -> int:
    """The generator seed of replica k: distinct for every (seed, k)."""
    return int(np.random.SeedSequence((seed, k)).generate_state(
        1, np.uint64)[0])


def replica_generators(n: int, seed: int, device):
    """The n generators of a stack on `device`, row k's seeded from
    (seed, k) (where the JAX package folds k into the state's key)."""
    out = []
    for k in range(n):
        rng = torch.Generator(device=device)
        rng.manual_seed(_replica_seed(seed, k))
        out.append(rng)
    return tuple(out)


def replicate_state(state: State, n: int, seed: int = 0) -> State:
    """One stacked State of n copies of `state` (JAX's replicate_state):
    each tensor repeated along a new leading axis, and n generators on the
    state's device (replica_generators)."""
    def rep(t):
        return t.unsqueeze(0).repeat((n,) + (1,) * t.ndim)

    return replace(state, x=rep(state.x), v=rep(state.v), box=rep(state.box),
                   rng=replica_generators(n, seed, state.x.device),
                   extra={key: rep(v) for key, v in state.extra.items()})


def make_replicated_step(step_fn, mesh=None, axis: str = "dp"):
    """Wrap a single-box step (system, state, globals) -> state into a
    replica step (system, states, globals) -> states over a stacked State:
    one batched call of step_fn on the whole stack (the integrators step a
    stack as they step one system; globals may hold (K,) per-row values).
    Over a 1-D DeviceMesh every rank passes the same K replicas, steps its
    own block of K / D in one call (ValueError unless D divides K;
    TypeError for another mesh) and returns the stack the one-process call
    returns, the other ranks' rows gathered (gather_replicas). Each row
    keeps its own generator, which only its owner advances."""
    if mesh is not None:
        from .mesh import mesh_group

        mesh_group(mesh, axis)

    def step(system, states, globals=None):
        if mesh is None:
            return step_fn(system, states, globals)
        lo, hi = replica_block(states.rows, mesh, axis)
        mine = step_fn(system, states.block(lo, hi),
                       globals_block(globals, lo, hi))
        return replace(gather_replicas(mine, states.rows, mesh, axis),
                       rng=states.rng)

    return step
