"""Simulation state (counterpart of atomsmm_tpu/state.py).

One explicit object carries the dynamical state: positions, velocities,
box, a `torch.Generator` for stochastic propagators (where the JAX package
held a key), the outer-step counter and a dict of extended variables
(thermostat chains, force caches, neighbor buckets). Tensors live on the
device of the positions.

A stacked State holds K systems along a leading axis, as the JAX package
stacks its replicas: x and v (K, N, 3), box (K, 3) or (K, 3, 3), every
extra with a leading K (a neighbor bucket (K, ncells, cap), a flag (K,)),
and `rng` a tuple of K generators, one per row. `stack_states` builds one
from K single States and `State.row(k)` takes row k back; the step counter
is shared.

Examples:

>>> import torch
>>> s = make_state(torch.zeros(4, 3), box=torch.full((3,), 2.0), seed=1)
>>> tuple(s.v.shape), s.step
((4, 3), 0)
>>> sorted(s.with_extra(nhc_v=torch.zeros(2)).extra)
['nhc_v']
>>> masses = torch.tensor([1.0, 1.0, 16.0, 16.0])
>>> v = maxwell_boltzmann_velocities(torch.Generator().manual_seed(0), masses, 300.0)
>>> tuple(v.shape)
(4, 3)
>>> stack_states([s, s.with_extra(nhc_v=torch.zeros(2))])
Traceback (most recent call last):
...
ValueError: stack_states: the rows hold different extras
>>> st = stack_states([s, s])
>>> st.rows, tuple(st.x.shape), tuple(st.row(1).box.shape)
(2, (2, 4, 3), (3,))
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .units import BOLTZMANN
from .utils import replace


@dataclasses.dataclass
class State:
    """Dynamical state of a simulation.

    Attributes:
      x:    (N, 3) positions [nm]
      v:    (N, 3) velocities [nm/ps]
      box:  (3,) orthorhombic box lengths, or the (3, 3) reduced triclinic
            cell matrix (rows = lattice vectors) [nm], see ops/pbc.py
      rng:  torch.Generator on the device of x (a tuple of K for a stack)
      step: outer-step counter
      extra: dict of named extended variables (tensors)

    A stacked State (module docstring) has x (K, N, 3).
    """

    x: torch.Tensor
    v: torch.Tensor
    box: torch.Tensor
    rng: torch.Generator
    step: int
    extra: Dict[str, Any]

    @property
    def num_particles(self) -> int:
        return self.x.shape[-2]

    @property
    def rows(self):
        """K for a stacked State, None for a single system."""
        return self.x.shape[0] if self.x.ndim == 3 else None

    def block(self, lo: int, hi: int) -> "State":
        """The rows [lo, hi) of a stacked State, a stacked State that
        shares their tensors (views) and their generators."""
        return State(x=self.x[lo:hi], v=self.v[lo:hi], box=self.box[lo:hi],
                     rng=tuple(self.rng[lo:hi]), step=self.step,
                     extra={key: v[lo:hi] for key, v in self.extra.items()})

    def row(self, k: int) -> "State":
        """Row k of a stacked State, a single-system State that shares its
        tensors (views) and its generator."""
        return State(x=self.x[k], v=self.v[k], box=self.box[k],
                     rng=self.rng[k], step=self.step,
                     extra={key: v[k] for key, v in self.extra.items()})

    def with_extra(self, **kv):
        extra = dict(self.extra)
        extra.update(kv)
        return replace(self, extra=extra)


def make_state(x, v=None, box=None, seed: int = 0, extra=None) -> State:
    """A State on the device of `x`. Positions and velocities are made
    contiguous (a numpy array may arrive in column order, and the CUDA
    kernels take row-major tensors only)."""
    x = torch.as_tensor(x).contiguous()
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    if v is None:
        v = torch.zeros_like(x)
    else:
        v = torch.as_tensor(v, dtype=x.dtype, device=x.device).contiguous()
    if box is None:
        raise ValueError(
            "box is required: (3,) orthorhombic lengths or a (3, 3) "
            "triclinic cell matrix")
    box = torch.as_tensor(box, dtype=x.dtype, device=x.device)
    rng = torch.Generator(device=x.device)
    rng.manual_seed(seed)
    return State(x=x, v=v, box=box, rng=rng, step=0, extra=dict(extra or {}))


def stack_states(states) -> State:
    """One stacked State from K single States of one system: their
    tensors stacked along a new leading axis, their generators as the
    tuple `rng`, the first one's step counter. Raises ValueError unless
    every row holds the same extras."""
    states = list(states)
    keys = list(states[0].extra)
    if any(list(s.extra) != keys for s in states):
        raise ValueError("stack_states: the rows hold different extras")
    return State(x=torch.stack([s.x for s in states]),
                 v=torch.stack([s.v for s in states]),
                 box=torch.stack([s.box for s in states]),
                 rng=tuple(s.rng for s in states), step=states[0].step,
                 extra={key: torch.stack([s.extra[key] for s in states])
                        for key in keys})


def kinetic_energy(masses: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Total kinetic energy [kJ/mol]; masses (N,) [amu], v (N,3) [nm/ps];
    (K,) for a stack of velocities (K, N, 3)."""
    return 0.5 * torch.sum(masses[:, None] * v * v, dim=(-2, -1))


def instantaneous_temperature(masses, v, dof: int) -> torch.Tensor:
    return 2.0 * kinetic_energy(masses, v) / (dof * BOLTZMANN)


def maxwell_boltzmann_velocities(rng: torch.Generator, masses, temperature,
                                 dtype=None):
    """Draw velocities from the MB distribution at `temperature` [K] with
    the generator `rng` (which must live on the device of `masses`)."""
    dtype = dtype or masses.dtype
    safe = torch.where(masses > 0, masses, torch.ones_like(masses))
    sigma = torch.where(
        masses > 0, torch.sqrt(BOLTZMANN * temperature / safe),
        torch.zeros_like(masses)).to(dtype)
    noise = torch.randn((masses.shape[0], 3), generator=rng, dtype=dtype,
                        device=masses.device)
    return sigma[:, None] * noise


def remove_com_motion(masses, v):
    p = torch.sum(masses[:, None] * v, dim=0)
    return v - p / torch.sum(masses)
