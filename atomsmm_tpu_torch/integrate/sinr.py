"""SIN(R) — stochastic isokinetic Nosé-Hoover RESPA — and Nosé-Hoover-Langevin
(counterpart of atomsmm_tpu/integrate/sinr.py; Leimkuhler, Margul &
Tuckerman, JCTC 9, 5624 (2013)).

SIN(R) with L = 1: every degree of freedom carries auxiliary velocities
(v1, v2) and obeys the isokinetic constraint

    m v^2 + (1/2) Q1 v1^2 = kT        (per DOF, exactly, at all times)

which bounds |v| and is what lets the method sustain very large outer RESPA
steps. Pieces (all closed-form per DOF — no iteration):

  * isokinetic boost (force kick under the constraint): with
    c = sign(F) sqrt(kT/m), b = v/c and z = |F| t / sqrt(m kT),
        v  <- c tanh(z + artanh(b))
        v1 <- v1 cosh(artanh(b)) / cosh(z + artanh(b))
  * isokinetic v1-v2 coupling (exact): v1 decays by exp(-v2 t) and the pair
    (v, v1) is renormalized to the constraint:
        s = (m v^2 + Q1 v1^2 e^{-2 v2 t} / 2) / kT
        v <- v / sqrt(s),  v1 <- v1 e^{-v2 t} / sqrt(s)
  * v2 kick: v2 += t (Q1 v1^2 - kT) / Q2
  * Ornstein-Uhlenbeck noise on v2 (exact), drawn from the state's
    torch.Generator.

Kinetic-energy note: the L = 1 isokinetic ensemble gives <m v^2> = kT/2 per
DOF (half the Maxwell-Boltzmann value) while configurational averages remain
canonical.

>>> IsokineticBoostPropagator({2}, "read", 353.0).describe(0.5)
['(v, v1) <- isokinetic boost F[[2]] * 0.5 dt, read cache']
>>> SINRThermostatPropagator(353.0, 0.05, 10.0).describe(0.125)
['(v, v1, v2) <- SIN thermostat(T=353.0K, tau=0.05ps, gamma=10.0/ps) over 0.125 dt']
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..state import State
from ..units import BOLTZMANN
from ..utils import replace
from .integrators import Integrator
from .propagators import Propagator, RespaPropagator, _normal, force_cache_tag

V1 = "sinr_v1"
V2 = "sinr_v2"


def _sinhc(z):
    """sinh(z)/z, series-expanded for small z."""
    big = z > 1e-4
    safe = torch.where(big, z, torch.ones_like(z))
    return torch.where(big, torch.sinh(safe) / safe, 1.0 + z * z / 6.0)


def _logcosh(x):
    ax = torch.abs(x)
    return ax + torch.log1p(torch.exp(-2.0 * ax)) - math.log(2.0)


class IsokineticBoostPropagator(Propagator):
    """Force kick preserving the per-DOF isokinetic constraint
    (atomsmm/propagators.py::MassiveIsokineticPropagator, forceDependent part).

    Accepts the same (groups, cache) interface as BoostPropagator so
    RespaPropagator can use it as its boost_cls.
    """

    def __init__(self, groups=None, cache: Optional[str] = None,
                 temperature: float = 300.0):
        self.groups = None if groups is None else frozenset(groups)
        self.cache = cache
        self.temperature = float(temperature)

    def extra_variables(self, system, state):
        out = {}
        if self.cache is not None:
            out[force_cache_tag(self.groups)] = torch.zeros_like(state.x)
        return out

    def apply(self, ctx, state, fraction):
        # Stable closed form. With c = sign(F) sqrt(kT/m) (the constraint's
        # speed bound), b = v0/c in [-1, 1], z = |F| t / sqrt(m kT):
        #     v(t)  = c tanh(z + artanh(b))          (tanh addition identity)
        #     v1(t) = v1(0) exp(logcosh(phi) - logcosh(z + phi))
        # — no cosh/sinh overflow or cancellation even for the violent forces
        # of unequilibrated contacts (naive cosh forms NaN there).
        t = fraction * ctx.dt
        kT = BOLTZMANN * self.temperature
        if self.cache == "read":
            f = state.extra[force_cache_tag(self.groups)]
        else:
            f = ctx.forces(state, self.groups)
        m = ctx.masses[:, None]
        v, v1 = state.v, state.extra[V1]

        vmax = torch.sqrt(kT / m)
        c = torch.where(f >= 0, vmax, -vmax)
        # 1 - 1e-7 rounds to 1 - 2^-23 in float32: artanh stays finite
        b = torch.clamp(v / c, -1.0 + 1e-7, 1.0 - 1e-7)
        phi = torch.arctanh(b)
        z = torch.abs(f) * t / torch.sqrt(m * kT)

        v_new = c * torch.tanh(z + phi)
        v1_new = v1 * torch.exp(_logcosh(phi) - _logcosh(z + phi))
        state = replace(state, v=v_new).with_extra(**{V1: v1_new})
        if self.cache == "write":
            state = state.with_extra(**{force_cache_tag(self.groups): f})
        return state

    def describe(self, fraction=1.0):
        g = "all" if self.groups is None else sorted(self.groups)
        c = f", {self.cache} cache" if self.cache else ""
        return [f"(v, v1) <- isokinetic boost F[{g}] * {fraction:g} dt{c}"]


class SINRThermostatPropagator(Propagator):
    """The stochastic iso-NH part: OU(t/2) B2(t/2) scale(t) B2(t/2) OU(t/2),
    all per-DOF and closed-form (atomsmm's massive NH-Langevin piece)."""

    def __init__(self, temperature, time_scale, friction):
        self.temperature = float(temperature)
        self.tau = float(time_scale)
        self.friction = float(friction)

    @property
    def q1(self):
        return BOLTZMANN * self.temperature * self.tau**2

    @property
    def q2(self):
        return BOLTZMANN * self.temperature * self.tau**2

    def extra_variables(self, system, state):
        return {V1: torch.zeros_like(state.x), V2: torch.zeros_like(state.x)}

    def _ou(self, state, t):
        kT = BOLTZMANN * self.temperature
        decay = math.exp(-self.friction * t)
        noise = math.sqrt(max(1.0 - decay * decay, 0.0) * kT / self.q2)
        v2 = state.extra[V2]
        v2 = v2 * decay + noise * _normal(state.rng, v2)
        return state.with_extra(**{V2: v2})

    def _kick2(self, state, t):
        kT = BOLTZMANN * self.temperature
        v1 = state.extra[V1]
        v2 = state.extra[V2] + t * (self.q1 * v1 * v1 - kT) / self.q2
        return state.with_extra(**{V2: v2})

    def _scale(self, ctx, state, t):
        kT = BOLTZMANN * self.temperature
        m = ctx.masses[:, None]
        v, v1, v2 = state.v, state.extra[V1], state.extra[V2]
        decay = torch.exp(-v2 * t)
        s = (m * v * v + 0.5 * self.q1 * (v1 * decay) ** 2) / kT
        root = torch.sqrt(s)
        return replace(state, v=v / root).with_extra(**{V1: v1 * decay / root})

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        state = self._ou(state, 0.5 * t)
        state = self._kick2(state, 0.5 * t)
        state = self._scale(ctx, state, t)
        state = self._kick2(state, 0.5 * t)
        state = self._ou(state, 0.5 * t)
        return state

    def describe(self, fraction=1.0):
        return [
            f"(v, v1, v2) <- SIN thermostat(T={self.temperature}K, "
            f"tau={self.tau}ps, gamma={self.friction}/ps) over {fraction:g} dt"
        ]


def initialize_isokinetic(rng, masses, temperature, tau):
    """Draw (v, v1, v2) from the L = 1 isokinetic distribution with the
    torch.Generator `rng` (on the device of `masses`): the constraint
    ellipse angle phi is uniform (rho(v) ~ (1 - m v^2/kT)^{-1/2}),
    v2 ~ N(0, kT/Q2). The tensors have the dtype of `masses`."""
    kT = BOLTZMANN * temperature
    q1 = kT * tau**2
    q2 = kT * tau**2
    shape = (masses.shape[0], 3)
    kw = dict(generator=rng, dtype=masses.dtype, device=masses.device)
    phi = 2 * math.pi * torch.rand(shape, **kw)
    v = torch.sqrt(kT / masses)[:, None] * torch.sin(phi)
    v1 = math.sqrt(2 * kT / q1) * torch.cos(phi)
    v2 = math.sqrt(kT / q2) * torch.randn(shape, **kw)
    return v, v1, v2


class SIN_R_Integrator(Integrator):
    """Isokinetic multiple-timescale integrator
    (atomsmm/integrators.py::SIN_R_Integrator).

    RESPA over force groups with isokinetic boosts at every level and the
    stochastic iso-NH thermostat spliced at the innermost level (XI-RESPA
    placement). Velocities must be initialized on the constraint — use
    `initialize` (it draws them) or initialize_isokinetic directly.
    """

    def __init__(self, dt, loops, temperature=300.0, time_scale=0.02,
                 friction=10.0, seed: int = 0):
        super().__init__(dt)
        self.temperature = float(temperature)
        self.tau = float(time_scale)
        self.friction = float(friction)
        self.seed = seed
        thermostat = SINRThermostatPropagator(temperature, time_scale, friction)

        def boost_cls(groups=None, cache=None):
            return IsokineticBoostPropagator(groups, cache, temperature)

        self.propagator = RespaPropagator(
            loops, baths={0: thermostat}, boost_cls=boost_cls
        )

    def initialize(self, system, state: State) -> State:
        state = super().initialize(system, state)
        v, v1, v2 = initialize_isokinetic(
            state.rng, system.masses, self.temperature, self.tau
        )
        dtype = state.v.dtype
        state = replace(state, v=v.to(dtype))
        return state.with_extra(**{V1: v1.to(dtype), V2: v2.to(dtype)})


class MassiveNoseHooverLangevinPropagator(Propagator):
    """Per-DOF Nosé-Hoover-Langevin bath: half-kick / exact scale / half-kick
    on the per-DOF thermostat velocity, with OU noise
    (atomsmm/propagators.py::NoseHooverLangevinPropagator [M])."""

    def __init__(self, temperature, time_scale, friction, tag="nhl"):
        self.temperature = float(temperature)
        self.tau = float(time_scale)
        self.friction = float(friction)
        self.tag = tag

    @property
    def q(self):
        return BOLTZMANN * self.temperature * self.tau**2

    def extra_variables(self, system, state):
        return {f"{self.tag}_v": torch.zeros_like(state.x)}

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        kT = BOLTZMANN * self.temperature
        key = f"{self.tag}_v"
        m = ctx.masses[:, None]

        def kick(state, h):
            v_eta = state.extra[key] + h * (m * state.v**2 - kT) / self.q
            return state.with_extra(**{key: v_eta})

        def ou(state, h):
            decay = math.exp(-self.friction * h)
            noise = math.sqrt(max(1.0 - decay**2, 0.0) * kT / self.q)
            z = state.extra[key]
            z = z * decay + noise * _normal(state.rng, z)
            return state.with_extra(**{key: z})

        state = ou(state, 0.5 * t)
        state = kick(state, 0.5 * t)
        state = replace(state, v=state.v * torch.exp(-state.extra[key] * t))
        state = kick(state, 0.5 * t)
        state = ou(state, 0.5 * t)
        return state

    def describe(self, fraction=1.0):
        return [
            f"v <- massive NHL(T={self.temperature}K, tau={self.tau}ps, "
            f"gamma={self.friction}/ps) over {fraction:g} dt"
        ]


class MassiveNoseHooverPropagator(MassiveNoseHooverLangevinPropagator):
    """Deterministic per-DOF Nosé-Hoover thermostat
    (atomsmm/propagators.py::MassiveNoseHooverPropagator): the NHL update with
    the stochastic part switched off."""

    def __init__(self, temperature, time_scale, tag="mnh"):
        super().__init__(temperature, time_scale, friction=0.0, tag=tag)

    def describe(self, fraction=1.0):
        return [
            f"v <- massive NH(T={self.temperature}K, tau={self.tau}ps) "
            f"over {fraction:g} dt"
        ]


class NHL_R_Integrator(Integrator):
    """Nosé-Hoover-Langevin RESPA (atomsmm/integrators.py::NHL_R_Integrator):
    ordinary boosts, massive NHL bath at the innermost level."""

    def __init__(self, dt, loops, temperature=300.0, time_scale=0.1,
                 friction=10.0):
        super().__init__(dt)
        bath = MassiveNoseHooverLangevinPropagator(
            temperature, time_scale, friction
        )
        self.propagator = RespaPropagator(loops, baths={0: bath})
