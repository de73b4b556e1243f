"""Simulation state (counterpart of atomsmm_tpu/state.py).

One explicit object carries the dynamical state: positions, velocities,
box, a `torch.Generator` for stochastic propagators (where the JAX package
held a key), the outer-step counter and a dict of extended variables
(thermostat chains, force caches, neighbor buckets). Tensors live on the
device of the positions.

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
      rng:  torch.Generator on the device of x
      step: outer-step counter
      extra: dict of named extended variables (tensors)
    """

    x: torch.Tensor
    v: torch.Tensor
    box: torch.Tensor
    rng: torch.Generator
    step: int
    extra: Dict[str, Any]

    @property
    def num_particles(self) -> int:
        return self.x.shape[0]

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


def kinetic_energy(masses: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Total kinetic energy [kJ/mol]; masses (N,) [amu], v (N,3) [nm/ps]."""
    return 0.5 * torch.sum(masses[:, None] * v * v)


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
