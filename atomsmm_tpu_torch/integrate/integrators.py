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

>>> vv = VelocityVerletIntegrator(dt=0.002)
>>> "x <- x + v" in vv.describe()
True
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch

from ..state import State
from ..utils import replace
from .propagators import (
    BoostPropagator,
    NoseHooverChainPropagator,
    OrnsteinUhlenbeckPropagator,
    Propagator,
    RespaPropagator,
    StepContext,
    TranslationPropagator,
    TrotterSuzukiPropagator,
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

    def __str__(self):
        return self.describe()

    def conserved_extra(self, state) -> torch.Tensor:
        """Thermostat contribution to the conserved quantity (0 for NVE)."""
        return torch.zeros((), dtype=state.v.dtype, device=state.v.device)


class PropagatorIntegrator(Integrator):
    """Wrap an arbitrary propagator (atomsmm Propagator.integrator())."""

    def __init__(self, dt, propagator: Propagator):
        super().__init__(dt)
        self.propagator = propagator


class VelocityVerletIntegrator(Integrator):
    """Plain velocity Verlet over all force groups."""

    def __init__(self, dt):
        super().__init__(dt)
        self.propagator = VelocityVerletPropagator()


class GlobalThermostatIntegrator(Integrator):
    """NVE core propagator + a global thermostat applied symmetrically:
    thermostat(t/2) nve(t) thermostat(t/2)
    (atomsmm/integrators.py::GlobalThermostatIntegrator).

    Argument order matches the reference: (stepSize, nve, thermostat). As a
    convenience, a single propagator argument is taken as the thermostat with
    the default velocity-Verlet NVE core: ``GlobalThermostatIntegrator(dt, csvr)``.
    """

    def __init__(self, dt, nve: Optional[Propagator] = None,
                 thermostat: Optional[Propagator] = None):
        super().__init__(dt)
        if thermostat is None:
            nve, thermostat = None, nve
        if thermostat is None:
            raise ValueError("GlobalThermostatIntegrator needs a thermostat")
        if nve is not None and getattr(nve, "is_thermostat", False) and not (
            getattr(thermostat, "is_thermostat", False)
        ):
            # certainly the swapped argument order (dt, thermostat, nve): a
            # bath in the trajectory-core slot integrates a wrong splitting
            # silently, so refuse. The check keys on the positive
            # Propagator.is_thermostat marker; a composite NVE core that
            # merely tracks a conserved quantity is legitimate and only
            # draws a warning below.
            raise ValueError(
                "GlobalThermostatIntegrator(dt, nve, thermostat): the "
                "`nve` argument is a thermostat (is_thermostat=True) while "
                "`thermostat` is not — the argument order is "
                "(stepSize, nve, thermostat), matching the reference"
            )
        if nve is not None and hasattr(nve, "conserved_extra") and not (
            hasattr(thermostat, "conserved_extra")
            or getattr(thermostat, "is_thermostat", False)
        ):
            warnings.warn(
                "GlobalThermostatIntegrator: the `nve` argument tracks a "
                "conserved quantity while `thermostat` does not — check the "
                "argument order (stepSize, nve, thermostat)",
                stacklevel=2,
            )
        self.thermostat = thermostat
        nve = nve or VelocityVerletPropagator()
        self.propagator = TrotterSuzukiPropagator(nve, thermostat)

    def conserved_extra(self, state):
        if hasattr(self.thermostat, "conserved_extra"):
            return self.thermostat.conserved_extra(state)
        return super().conserved_extra(state)


class _LangevinMiddlePropagator(Propagator):
    """BAOAB: B(t/2) A(t/2) O(t) A(t/2) B(t/2) — kicks read/write the force
    cache like VelocityVerletPropagator, so one force evaluation per step."""

    def __init__(self, temperature, friction, groups=None):
        self.pre = BoostPropagator(groups, cache="read")
        self.post = BoostPropagator(groups, cache="write")
        self.move = TranslationPropagator()
        self.ou = OrnsteinUhlenbeckPropagator(temperature, friction)

    def extra_variables(self, system, state):
        out = self.pre.extra_variables(system, state)
        out.update(self.post.extra_variables(system, state))
        return out

    def apply(self, ctx, state, fraction):
        state = self.pre.apply(ctx, state, 0.5 * fraction)
        state = self.move.apply(ctx, state, 0.5 * fraction)
        state = self.ou.apply(ctx, state, fraction)
        state = self.move.apply(ctx, state, 0.5 * fraction)
        state = self.post.apply(ctx, state, 0.5 * fraction)
        return state

    def describe(self, fraction=1.0):
        lines = ["LangevinMiddle (BAOAB):"]
        for p, f in ((self.pre, 0.5 * fraction), (self.move, 0.5 * fraction),
                     (self.ou, fraction), (self.move, 0.5 * fraction),
                     (self.post, 0.5 * fraction)):
            lines += ["  " + l for l in p.describe(f)]
        return lines


class LangevinMiddleIntegrator(Integrator):
    """Leimkuhler-Matthews "middle" (BAOAB) Langevin dynamics
    (openmm.LangevinMiddleIntegrator), for users whose scripts never reach
    the propagator algebra. friction in 1/ps.

    The OU piece is exact (no first-order expansion of the friction) and
    the two kicks share one force evaluation through the force cache.

    >>> integ = LangevinMiddleIntegrator(0.002, 300.0, friction=1.0)
    >>> print(integ.describe())
    LangevinMiddleIntegrator(dt=0.002 ps)
    LangevinMiddle (BAOAB):
      v <- v + F[all]/m * 0.5 dt, read cache
      x <- x + v * 0.5 dt (+SETTLE/SHAKE if constrained)
      v <- OU(T=300.0K, gamma=1.0/ps) over 1 dt
      x <- x + v * 0.5 dt (+SETTLE/SHAKE if constrained)
      v <- v + F[all]/m * 0.5 dt, write cache
    """

    def __init__(self, dt, temperature, friction: float = 1.0):
        super().__init__(dt)
        self.temperature = float(temperature)
        self.friction = float(friction)
        self.propagator = _LangevinMiddlePropagator(temperature, friction)


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
      core: the innermost motion at level 0 (default: a translation).
      baths: level -> Propagator, further baths spliced into the levels.
    """

    def __init__(self, dt, loops, temperature: Optional[float] = None,
                 time_scale: float = 0.1,
                 degrees_of_freedom: Optional[int] = None, location: int = -1,
                 nchain: int = 2, nsy: int = 3, nloops: int = 1,
                 core: Optional[Propagator] = None,
                 baths: Optional[Dict[int, Propagator]] = None):
        super().__init__(dt)
        baths = dict(baths or {})
        self.thermostat = None
        if temperature is not None:
            if degrees_of_freedom is None:
                raise ValueError(
                    "degrees_of_freedom is required when temperature is set")
            self.thermostat = NoseHooverChainPropagator(
                temperature, degrees_of_freedom, time_scale,
                nchain=nchain, nsy=nsy, nloops=nloops)
            baths[location] = self.thermostat
        self.propagator = RespaPropagator(loops, core=core, baths=baths)

    def conserved_extra(self, state):
        if self.thermostat is not None:
            return self.thermostat.conserved_extra(state)
        return super().conserved_extra(state)
