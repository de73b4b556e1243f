"""Drude-oscillator integrators: extended-Lagrangian dual thermostat and
SCF (counterpart of atomsmm_tpu/integrate/drude.py).

Polarizable simulations handle the Drude degrees of freedom one of two
ways (OpenMM's DrudeLangevinIntegrator / DrudeSCFIntegrator):

  * **Extended Lagrangian** (Lamoureux & Roux, JCP 119, 3025 (2003)): each
    Drude particle has a small mass (~0.4 amu, debited from its core) and
    moves as ordinary dynamics, but the core-Drude pair is thermostatted
    in CENTRE-OF-MASS / RELATIVE coordinates: the COM rides the physical
    bath at T while the relative motion is pinned by a cold bath at
    T_Drude ~ 1 K. `DrudeLangevinIntegrator` composes the exact
    Ornstein-Uhlenbeck updates in those coordinates
    (`DrudeOrnsteinUhlenbeckPropagator`) around a velocity-Verlet core.

  * **SCF** (Born-Oppenheimer): Drude particles are MASSLESS state, not
    dynamics. After every position update their rows are relaxed to the
    energy minimum by the spring-preconditioned fixed point
    (ops/drude.py::drude_scf_minimize, on the forces of every group), and
    they receive neither kicks (safe inverse mass) nor bath noise.
    `DrudeSCFIntegrator` puts the relaxation between the drift and the
    trailing kick of velocity Verlet: n_iter force evaluations a step,
    then the kick's own.

Both compose with RESPA and the other propagators, and `describe()` prints
the JAX package's splitting text.

>>> from atomsmm_tpu_torch.models import swm4_water_system
>>> system, _, _ = swm4_water_system(n_molecules=8, r_cut=0.3, r_switch=0.25,
...                                  drude_mass=0.0, device="cpu")
>>> integ = DrudeSCFIntegrator(0.001, n_iter=12, system=system)
>>> print(integ.describe())
DrudeSCFIntegrator(dt=0.001 ps)
DrudeSCFVerlet:
  v <- v + F[all]/m * 0.5 dt, read cache
  x <- x + v * 1 dt (+SETTLE/SHAKE if constrained)
  x_D <- argmin U (SCF, 12 iterations)
  v <- v + F[all]/m * 0.5 dt, write cache
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..forces import DrudeForce
from ..ops.drude import drude_scf_minimize
from ..units import BOLTZMANN
from ..utils import InputError, replace
from .integrators import Integrator
from .propagators import (
    BoostPropagator,
    OrnsteinUhlenbeckPropagator,
    Propagator,
    TranslationPropagator,
    TrotterSuzukiPropagator,
    VelocityVerletPropagator,
    _normal,
    _project_velocities,
    refuse_stack,
)


def find_drude_set(system):
    """The DrudeSet of the system's DrudeForce (InputError if absent)."""
    for f in system.forces:
        if type(f) is DrudeForce:
            return f.drude
    raise InputError("system contains no DrudeForce")


class DrudeOrnsteinUhlenbeckPropagator(Propagator):
    """Dual Langevin bath in core-Drude pair coordinates.

    Exact OU updates on three disjoint velocity blocks:
      * each pair's centre of mass (total mass M) at `temperature`,
      * each pair's relative velocity (reduced mass mu) at
        `drude_temperature` with the stiff `drude_friction`,
      * every particle outside a pair at `temperature`.
    The normals are three draws from the state's generator, in that order
    of use: free, com, rel. Massless rows (virtual sites, SCF Drudes)
    decay without noise and stay pinned by the velocity projection, which
    restores the constraints' tangency afterwards.
    """

    is_thermostat = True

    def __init__(self, drude, temperature, friction,
                 drude_temperature: float = 1.0,
                 drude_friction: float = 20.0):
        self.drude = drude
        self.temperature = float(temperature)
        self.friction = float(friction)  # 1/ps
        self.drude_temperature = float(drude_temperature)
        self.drude_friction = float(drude_friction)

    def apply(self, ctx, state, fraction):
        refuse_stack(self, state)
        t = fraction * ctx.dt
        kt = BOLTZMANN * self.temperature
        kt_d = BOLTZMANN * self.drude_temperature
        decay = math.exp(-self.friction * t)
        noise = math.sqrt(max(1.0 - decay * decay, 0.0))
        decay_d = math.exp(-self.drude_friction * t)
        noise_d = math.sqrt(max(1.0 - decay_d * decay_d, 0.0))

        m = ctx.masses
        di = self.drude.pairs[:, 0]
        ci = self.drude.pairs[:, 1]
        md, mc = m[di][:, None], m[ci][:, None]
        m_tot = md + mc
        mu = md * mc / m_tot
        v0 = state.v

        # free atoms (pair rows are overwritten below); massless rows get
        # no noise (safe inverse mass) and decay to their pinned zero
        one = torch.ones_like(m)
        inv_m = torch.where(m > 0, 1.0 / torch.where(m > 0, m, one),
                            torch.zeros_like(m))
        sigma = torch.sqrt(kt * inv_m)[:, None]
        v = v0 * decay + sigma * noise * _normal(state.rng, v0)

        v_com = (md * v0[di] + mc * v0[ci]) / m_tot
        v_rel = v0[di] - v0[ci]
        r_com = _normal(state.rng, v_com)
        r_rel = _normal(state.rng, v_rel)
        v_com = v_com * decay + torch.sqrt(kt / m_tot) * noise * r_com
        # massless Drudes (SCF configuration, drude_mass=0): mu = 0 would
        # make the noise amplitude sqrt(kT_d/mu) inf; pin v_rel = 0 exactly
        # there (the satellite rides its core)
        sigma_rel = torch.sqrt(kt_d / torch.where(mu > 0, mu,
                                                  torch.ones_like(mu)))
        v_rel = torch.where(mu > 0,
                            v_rel * decay_d + sigma_rel * noise_d * r_rel,
                            torch.zeros_like(v_rel))

        v = v.index_copy(0, ci, v_com - (md / m_tot) * v_rel)
        v = v.index_copy(0, di, v_com + (mc / m_tot) * v_rel)
        v = _project_velocities(ctx, state.x, v)
        return replace(state, v=v)

    def describe(self, fraction=1.0):
        return [
            f"v_com, v_free <- OU(T={self.temperature}K, "
            f"gamma={self.friction}/ps); "
            f"v_rel <- OU(T={self.drude_temperature}K, "
            f"gamma={self.drude_friction}/ps) over {fraction:g} dt"
        ]


class DrudeLangevinIntegrator(Integrator):
    """Extended-Lagrangian polarizable dynamics: velocity Verlet with the
    dual OU bath applied symmetrically (bath(t/2) vv(t) bath(t/2)), the
    counterpart of OpenMM's DrudeLangevinIntegrator. The system must carry
    a DrudeForce; Drude particles need a small positive mass (the model
    builders debit it from the core). The masses are read on the host once,
    here, and massless Drudes are refused.
    """

    def __init__(self, dt, temperature, friction=5.0,
                 drude_temperature: float = 1.0,
                 drude_friction: float = 20.0, *, system):
        super().__init__(dt)
        drude = find_drude_set(system)
        md = system.masses.detach().cpu()[drude.pairs[:, 0].cpu()]
        if bool((md <= 0).any()):
            raise InputError(
                "DrudeLangevinIntegrator is extended-Lagrangian dynamics "
                "and needs a positive drude_mass on every Drude particle "
                "(the builders debit it from the core); for massless "
                "Drudes use DrudeSCFIntegrator instead")
        self.thermostat = DrudeOrnsteinUhlenbeckPropagator(
            drude, temperature, friction, drude_temperature, drude_friction)
        self.propagator = TrotterSuzukiPropagator(
            VelocityVerletPropagator(), self.thermostat)


class DrudeSCFPlacementPropagator(Propagator):
    """x_Drude <- argmin U: relax the (massless) Drude rows onto the
    Born-Oppenheimer surface with the spring-preconditioned fixed point
    (ops/drude.py::drude_scf_minimize), warm-started from the displacements
    carried in State.x. Each iteration evaluates the forces of every group
    through StepContext.forces, on the state's own neighbor buckets."""

    def __init__(self, drude, n_iter: int = 12):
        self.drude = drude
        self.n_iter = n_iter

    def apply(self, ctx, state, fraction):
        refuse_stack(self, state)

        def forces(xx):
            return ctx.forces(replace(state, x=xx))

        x = drude_scf_minimize(forces, self.drude, state.x, self.n_iter)
        return replace(state, x=x)

    def describe(self, fraction=1.0):
        return [f"x_D <- argmin U (SCF, {self.n_iter} iterations)"]


class DrudeSCFVerletPropagator(Propagator):
    """B(t/2) A(t) SCF B(t/2): velocity Verlet with the Drude relaxation
    between the drift and the trailing (cache-refreshing) kick, so the
    refreshed forces are evaluated at the relaxed dipoles."""

    def __init__(self, drude, n_iter: int = 12):
        self.pre = BoostPropagator(cache="read")
        self.post = BoostPropagator(cache="write")
        self.move = TranslationPropagator()
        self.scf = DrudeSCFPlacementPropagator(drude, n_iter)

    def extra_variables(self, system, state):
        out = self.pre.extra_variables(system, state)
        out.update(self.post.extra_variables(system, state))
        return out

    def apply(self, ctx, state, fraction):
        state = self.pre.apply(ctx, state, 0.5 * fraction)
        state = self.move.apply(ctx, state, fraction)
        state = self.scf.apply(ctx, state, fraction)
        state = self.post.apply(ctx, state, 0.5 * fraction)
        return state

    def describe(self, fraction=1.0):
        return (
            ["DrudeSCFVerlet:"]
            + ["  " + l for l in self.pre.describe(0.5 * fraction)]
            + ["  " + l for l in self.move.describe(fraction)]
            + ["  " + l for l in self.scf.describe(fraction)]
            + ["  " + l for l in self.post.describe(0.5 * fraction)]
        )


class DrudeSCFIntegrator(Integrator):
    """Born-Oppenheimer polarizable dynamics (OpenMM's DrudeSCFIntegrator
    analog): massless Drude particles relaxed to the energy minimum every
    step, real atoms under velocity Verlet with an optional Langevin bath
    (`temperature`).

    Model builders for SCF use give Drude particles mass 0. Their positions
    persist in State.x between steps, so each relaxation warm-starts from
    the previous displacement. utils.count_degrees_of_freedom still counts
    their three rows each, as the JAX package's does.
    """

    def __init__(self, dt, n_iter: int = 12,
                 temperature: Optional[float] = None, friction: float = 5.0,
                 *, system):
        super().__init__(dt)
        core = DrudeSCFVerletPropagator(find_drude_set(system), n_iter)
        if temperature is None:
            self.propagator = core
        else:
            self.propagator = TrotterSuzukiPropagator(
                core, OrnsteinUhlenbeckPropagator(temperature, friction))
