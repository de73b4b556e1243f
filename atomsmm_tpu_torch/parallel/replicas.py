"""Independent replicas of one system (counterpart of
atomsmm_tpu/parallel/replicas.py).

The JAX package stacks K states along a leading replica axis and vmaps the
step over it, sharded over a device mesh. K1 takes one system per launch,
so here the replicas are a list of States stepped one after another on one
card (a replica axis in the kernels waits for ROADMAP item 4d). Over a
device mesh (a 1-D torch.distributed DeviceMesh, one process per rank) rank
r of D owns the contiguous block of K / D replicas [r K / D, (r + 1) K / D)
and steps those only; `gather_replicas` fills the other ranks' rows in with
one all_reduce per dtype of the zero-padded stack (all_reduce, which gloo
takes for CUDA tensors too, where it refuses all_gather).

>>> import torch
>>> from atomsmm_tpu_torch.state import make_state
>>> reps = replicate_state(make_state(torch.zeros(2, 3),
...                                   box=torch.ones(3)), 3, seed=5)
>>> len(reps), reps[0].x is reps[1].x
(3, False)
>>> a, b = (torch.rand(2, generator=r.rng) for r in reps[:2])
>>> bool((a != b).all())                        # distinct streams
True
"""
from __future__ import annotations

from typing import List

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


def _fields(state):
    """The tensors of a replica, by name: x, v, box and each extra."""
    return {"x": state.x, "v": state.v, "box": state.box,
            **{("extra", k): v for k, v in state.extra.items()}}


def gather_replicas(states, mesh, axis: str = "dp"):
    """The K replicas of `states` with every rank's own block (replica_block)
    taken from its owner: every tensor of rows outside this rank's block
    is replaced by the owner's, in one all_reduce per dtype of a zero-padded
    (K, ...) stack (bool tensors travel as uint8). Each row keeps its own
    generator, which only its owner advances. Every rank must hold States
    of the same structure in every row."""
    import torch.distributed as dist

    from .mesh import mesh_group

    group = mesh_group(mesh, axis)[0]
    k = len(states)
    lo, hi = replica_block(k, mesh, axis)
    template = _fields(states[lo])
    by_wire = {}
    for name, t in template.items():
        wire = torch.uint8 if t.dtype == torch.bool else t.dtype
        by_wire.setdefault(wire, []).append(name)
    rows = [dict() for _ in range(k)]
    dev = states[lo].x.device
    for wire, names in by_wire.items():
        sizes = [template[nm].numel() for nm in names]
        buf = torch.zeros((k, sum(sizes)), dtype=wire, device=dev)
        for i in range(lo, hi):
            f = _fields(states[i])
            buf[i] = torch.cat([f[nm].reshape(-1).to(wire) for nm in names])
        dist.all_reduce(buf, group=group)
        for i in range(k):
            for nm, piece in zip(names, buf[i].split(sizes)):
                rows[i][nm] = piece.view(template[nm].shape).to(
                    template[nm].dtype)
    out = []
    for i, s in enumerate(states):
        if lo <= i < hi:
            out.append(s)
            continue
        f = rows[i]
        out.append(replace(s, x=f["x"], v=f["v"], box=f["box"], extra={
            key: f[("extra", key)] for key in states[lo].extra}))
    return out


def _replica_seed(seed: int, k: int) -> int:
    """The generator seed of replica k: distinct for every (seed, k)."""
    return int(np.random.SeedSequence((seed, k)).generate_state(
        1, np.uint64)[0])


def replicate_state(state: State, n: int, seed: int = 0) -> List[State]:
    """n copies of `state`, each with its own tensors and its own
    torch.Generator on the state's device, seeded from (seed, k) (where the
    JAX package folds k into the state's key)."""
    out = []
    for k in range(n):
        rng = torch.Generator(device=state.x.device)
        rng.manual_seed(_replica_seed(seed, k))
        out.append(replace(state, x=state.x.clone(), v=state.v.clone(),
                           box=state.box.clone(), rng=rng,
                           extra={key: v.clone()
                                  for key, v in state.extra.items()}))
    return out


def make_replicated_step(step_fn, mesh=None, axis: str = "dp"):
    """Wrap a single-box step (system, state, globals) -> state into a
    replica step (system, states, globals) -> states that steps each
    replica of the list in turn. Over a 1-D DeviceMesh every rank passes
    the same K replicas, steps its own block of K / D (ValueError unless D
    divides K; TypeError for another mesh) and returns the list the
    one-process call returns, the other ranks' rows gathered
    (gather_replicas)."""
    if mesh is not None:
        from .mesh import mesh_group

        mesh_group(mesh, axis)

    def step(system, states, globals=None):
        if mesh is None:
            return [step_fn(system, s, globals) for s in states]
        lo, hi = replica_block(len(states), mesh, axis)
        mine = [step_fn(system, s, globals) if lo <= i < hi else s
                for i, s in enumerate(states)]
        return gather_replicas(mine, mesh, axis)

    return step
