"""Independent replicas of one system (counterpart of
atomsmm_tpu/parallel/replicas.py).

The JAX package stacks K states along a leading replica axis and vmaps the
step over it, sharded over a device mesh. K1 takes one system per launch,
so here the replicas are a list of States stepped one after another on one
card; a replica axis in the kernels waits for ROADMAP item 4d, and a mesh
for item 14b.

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


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported: replicas run one after another on "
            "one card (ROADMAP item 14b, more than one GPU)")


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
    replica of the list in turn. A mesh raises (ROADMAP item 14b)."""
    _no_mesh(mesh)

    def step(system, states, globals=None):
        return [step_fn(system, s, globals) for s in states]

    return step
