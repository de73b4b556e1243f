"""User-facing integrators assembled from propagators (counterpart of
atomsmm_tpu/integrate/integrators.py). `describe()` prints the same
instruction dump as the JAX package.

>>> mts = MultipleTimeScaleIntegrator(0.004, [2, 1], temperature=300.0,
...                                   time_scale=0.1, degrees_of_freedom=93)
>>> print(mts.describe())
MultipleTimeScaleIntegrator(dt=0.004 ps)
RESPA(loops=[2, 1]):
  bath[-1](0.5 dt)
  repeat x1:
    v <- v + F[1]/m * 0.5 dt
    repeat x2:
      v <- v + F[0]/m * 0.25 dt
      x <- x + v * 0.5 dt
      v <- v + F[0]/m * 0.25 dt
    v <- v + F[1]/m * 0.5 dt
  bath[-1](0.5 dt)
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..state import State
from ..utils import replace
from .propagators import (
    NoseHooverChainPropagator,
    Propagator,
    RespaPropagator,
    StepContext,
    VelocityVerletPropagator,
)


class Integrator:
    """Base integrator (atomsmm/integrators.py::_AtomsMM_Integrator).

    Attributes:
      dt: outer step size [ps].
      propagator: the operator-splitting program for one outer step.
    """

    def __init__(self, dt: float):
        self.dt = float(dt)
        self.propagator: Propagator = None

    def initialize(self, system, state: State) -> State:
        """Register this integrator's extended variables in the state."""
        extras = self.propagator.extra_variables(system, state)
        missing = {k: v.clone() for k, v in extras.items()
                   if k not in state.extra}
        return state.with_extra(**missing) if missing else state

    def make_step(self):
        """The step function (system, state, globals) -> state."""

        def step(system, state: State, globals: Optional[Dict] = None) -> State:
            ctx = StepContext(system, globals, self.dt)
            state = self.propagator.apply(ctx, state, 1.0)
            return replace(state, step=state.step + 1)

        return step

    def describe(self) -> str:
        header = f"{type(self).__name__}(dt={self.dt} ps)"
        return "\n".join([header] + self.propagator.describe(1.0))

    def conserved_extra(self, state) -> torch.Tensor:
        """Thermostat contribution to the conserved quantity (0 for NVE)."""
        return torch.zeros((), dtype=state.v.dtype, device=state.v.device)


class VelocityVerletIntegrator(Integrator):
    """Plain velocity Verlet over all force groups."""

    def __init__(self, dt):
        super().__init__(dt)
        self.propagator = VelocityVerletPropagator()


class MultipleTimeScaleIntegrator(Integrator):
    """r-RESPA over force groups 0..L as produced by RESPASystem
    (atomsmm/integrators.py::MultipleTimeScaleIntegrator).

    Args:
      dt: outermost step size [ps].
      loops: substep counts per level, innermost (group 0) first.
      temperature, time_scale: if given, attach a Nosé-Hoover chain bath.
      location: RESPA level of the bath (-1 = outside the outermost level).
      nchain/nsy/nloops: NH chain shape (see NoseHooverChainPropagator).
      degrees_of_freedom: required when a bath is attached.
    """

    def __init__(self, dt, loops, temperature: Optional[float] = None,
                 time_scale: float = 0.1,
                 degrees_of_freedom: Optional[int] = None, location: int = -1,
                 nchain: int = 2, nsy: int = 3, nloops: int = 1):
        super().__init__(dt)
        baths = {}
        self.thermostat = None
        if temperature is not None:
            if degrees_of_freedom is None:
                raise ValueError(
                    "degrees_of_freedom is required when temperature is set")
            self.thermostat = NoseHooverChainPropagator(
                temperature, degrees_of_freedom, time_scale,
                nchain=nchain, nsy=nsy, nloops=nloops)
            baths[location] = self.thermostat
        self.propagator = RespaPropagator(loops, baths=baths)

    def conserved_extra(self, state):
        if self.thermostat is not None:
            return self.thermostat.conserved_extra(state)
        return super().conserved_extra(state)
