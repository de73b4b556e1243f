"""Propagator algebra (counterpart of atomsmm_tpu/integrate/propagators.py).

Each Propagator's `apply(ctx, state, fraction)` advances time by
fraction*ctx.dt with PyTorch operations on the State; composition follows
the operator-splitting math of the reference, operator order included.
`describe(fraction)` prints the same instruction dump as the JAX package.

The algebra (Chained / Split / TrotterSuzuki / SuzukiYoshida / Respa) is
that of the reference. Translation follows a move of a constrained system
with SETTLE and SHAKE and the matching velocity correction, and places the
virtual sites; Boost and the Ornstein-Uhlenbeck step project the
velocities onto the constraints (SETTLE, RATTLE) and pin the virtual
sites' rows to zero. Boost carries the force-cache registers that hold
per-group forces between a 'write' kick and the next 'read' kick.
Stochastic propagators (OrnsteinUhlenbeck, VelocityRescaling) draw from
the state's torch.Generator, which advances in place: the same seed gives
the same trajectory, and another stream than the JAX package's.

>>> vv = VelocityVerletPropagator()
>>> for line in vv.describe(1.0):
...     print(line)
VelocityVerlet:
  v <- v + F[all]/m * 0.5 dt, read cache
  x <- x + v * 1 dt (+SETTLE/SHAKE if constrained)
  v <- v + F[all]/m * 0.5 dt, write cache

>>> ts = TrotterSuzukiPropagator(TranslationPropagator(),
...                              BoostPropagator(groups={0}))
>>> for line in ts.describe(1.0):
...     print(line)
TrotterSuzuki:
  v <- v + F[[0]]/m * 0.5 dt
  x <- x + v * 1 dt (+SETTLE/SHAKE if constrained)
  v <- v + F[[0]]/m * 0.5 dt

>>> [round(sum(_SY_WEIGHTS[n]), 12) for n in (1, 3, 7, 15)]
[1.0, 1.0, 1.0, 1.0]
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from ..ops.constraints import rattle_velocities, shake_positions
from ..ops.settle import settle_positions, settle_velocities
from ..ops.virtual_sites import place_virtual_sites, zero_virtual_velocities
from ..potential import force_fn
from ..state import State
from ..units import BOLTZMANN
from ..utils import replace


class StepContext:
    """Context threaded through propagator application: the system, the
    global-parameter dict, the step size and cached per-group evaluators."""

    def __init__(self, system, globals, dt):
        self.system = system
        self.globals = dict(globals or {})
        self.dt = dt
        self._force_fns = {}

    def forces(self, state: State, groups=None) -> torch.Tensor:
        """Forces [kJ/mol/nm] for the given force groups (None = all), with
        the neighbor buckets of State.extra as aux."""
        from ..ops.neighbors import make_aux

        key = None if groups is None else frozenset(groups)
        if key not in self._force_fns:
            self._force_fns[key] = force_fn(self.system, key)
        aux = make_aux(self.system, state.extra)
        _, f = self._force_fns[key](state.x, state.box, self.globals, aux)
        return f

    @property
    def masses(self):
        return self.system.masses

    def kT(self, temperature):
        return BOLTZMANN * temperature


class Propagator:
    """Base class (atomsmm/propagators.py::Propagator)."""

    #: positive marker for bath/thermostat propagators, used by
    #: GlobalThermostatIntegrator's swapped-argument guard (a thermostat in
    #: the trajectory-core slot silently integrates the wrong splitting)
    is_thermostat = False

    def extra_variables(self, system, state) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, ctx: StepContext, state: State, fraction: float) -> State:
        raise NotImplementedError

    def describe(self, fraction: float = 1.0):
        return [f"{type(self).__name__}({fraction:g} dt)"]

    def integrator(self, dt):
        """Wrap this propagator as a user-facing integrator
        (atomsmm Propagator.integrator())."""
        from .integrators import PropagatorIntegrator

        return PropagatorIntegrator(dt, self)


class ChainedPropagator(Propagator):
    """Apply propagators in sequence, each over the full fraction:
    exp(t A_n) ... exp(t A_1) — list order [A_1, ..., A_n] is application
    order (atomsmm/propagators.py::ChainedPropagator)."""

    def __init__(self, propagators: Sequence[Propagator]):
        self.propagators = list(propagators)

    def extra_variables(self, system, state):
        out = {}
        for p in self.propagators:
            out.update(p.extra_variables(system, state))
        return out

    def apply(self, ctx, state, fraction):
        for p in self.propagators:
            state = p.apply(ctx, state, fraction)
        return state

    def describe(self, fraction=1.0):
        lines = [f"Chained({fraction:g} dt):"]
        for p in self.propagators:
            lines += ["  " + l for l in p.describe(fraction)]
        return lines


class SplitPropagator(Propagator):
    """exp(t A) = [exp(t/n A)]^n (atomsmm/propagators.py::SplitPropagator)."""

    def __init__(self, propagator: Propagator, n: int):
        self.propagator = propagator
        self.n = int(n)

    def extra_variables(self, system, state):
        return self.propagator.extra_variables(system, state)

    def apply(self, ctx, state, fraction):
        for _ in range(self.n):
            state = self.propagator.apply(ctx, state, fraction / self.n)
        return state

    def describe(self, fraction=1.0):
        lines = [f"Split x{self.n}:"]
        lines += ["  " + l for l in self.propagator.describe(fraction / self.n)]
        return lines


class TrotterSuzukiPropagator(Propagator):
    """Symmetric splitting exp(t/2 B) exp(t A) exp(t/2 B)
    (atomsmm/propagators.py::TrotterSuzukiPropagator): `outer` is B (half step
    on each side), `inner` is A (full step in the middle)."""

    def __init__(self, inner: Propagator, outer: Propagator):
        self.inner = inner
        self.outer = outer

    def extra_variables(self, system, state):
        out = self.inner.extra_variables(system, state)
        out.update(self.outer.extra_variables(system, state))
        return out

    def apply(self, ctx, state, fraction):
        state = self.outer.apply(ctx, state, 0.5 * fraction)
        state = self.inner.apply(ctx, state, fraction)
        state = self.outer.apply(ctx, state, 0.5 * fraction)
        return state

    def describe(self, fraction=1.0):
        lines = ["TrotterSuzuki:"]
        lines += ["  " + l for l in self.outer.describe(0.5 * fraction)]
        lines += ["  " + l for l in self.inner.describe(fraction)]
        lines += ["  " + l for l in self.outer.describe(0.5 * fraction)]
        return lines


#: Suzuki-Yoshida composition weights (atomsmm/propagators.py::SuzukiYoshidaPropagator)
_SY_WEIGHTS = {
    1: [1.0],
    3: [1.3512071919596578, -1.7024143839193155, 1.3512071919596578],
    7: [
        0.784513610477560,
        0.235573213359357,
        -1.17767998417887,
        1.3151863206839063,
        -1.17767998417887,
        0.235573213359357,
        0.784513610477560,
    ],
    15: [
        0.102799849391985,
        -1.96061023297549,
        1.93813913762276,
        -0.158240635368243,
        -1.44485223686048,
        0.253693336566229,
        0.914844246229740,
        1.708453070786998,
        0.914844246229740,
        0.253693336566229,
        -1.44485223686048,
        -0.158240635368243,
        1.93813913762276,
        -1.96061023297549,
        0.102799849391985,
    ],
}


class SuzukiYoshidaPropagator(Propagator):
    """Higher-order composition: apply A with the nsy-point Suzuki-Yoshida
    weights (used to sub-split thermostat propagators)."""

    def __init__(self, propagator: Propagator, nsy: int = 3):
        if nsy not in _SY_WEIGHTS:
            raise ValueError(f"nsy must be one of {sorted(_SY_WEIGHTS)}")
        self.propagator = propagator
        self.nsy = nsy

    def extra_variables(self, system, state):
        return self.propagator.extra_variables(system, state)

    def apply(self, ctx, state, fraction):
        for w in _SY_WEIGHTS[self.nsy]:
            state = self.propagator.apply(ctx, state, w * fraction)
        return state

    def describe(self, fraction=1.0):
        lines = [f"SuzukiYoshida(nsy={self.nsy}):"]
        for w in _SY_WEIGHTS[self.nsy]:
            lines += ["  " + l for l in self.propagator.describe(w * fraction)]
        return lines


class TranslationPropagator(Propagator):
    """x <- x + v * t (atomsmm/propagators.py::TranslationPropagator).

    A constrained system follows the move with the position projection and
    the matching velocity correction v += (x_new - x_unc) / t: closed-form
    SETTLE for the rigid 3-site molecules (ops/settle.py), then Jacobi
    SHAKE for the remaining constraints (ops/constraints.py). Virtual sites
    are placed from their moved parents and their velocities zeroed."""

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        system = ctx.system
        cons = getattr(system, "constraints", None)
        sset = getattr(system, "settle", None)
        vsites = getattr(system, "virtual_sites", None)
        x_unc = state.x + state.v * t
        if cons is None and sset is None:
            if vsites is not None:
                x_unc = place_virtual_sites(vsites, x_unc)
            return replace(state, x=x_unc)
        x_new = x_unc
        if sset is not None:
            x_new = settle_positions(sset, x_new, state.x, ctx.masses)
        if cons is not None:
            x_new = shake_positions(cons, x_new, state.x, 1.0 / ctx.masses)
        v = state.v + (x_new - x_unc) / t
        if vsites is not None:
            # the stored virtual rows follow their parents (the forces
            # place them afresh at every evaluation all the same)
            x_new = place_virtual_sites(vsites, x_new)
            v = zero_virtual_velocities(vsites, v)
        return replace(state, x=x_new, v=v)

    def describe(self, fraction=1.0):
        return [f"x <- x + v * {fraction:g} dt (+SETTLE/SHAKE if constrained)"]


def _project_velocities(ctx, x, v):
    """Project velocities onto the constraint tangent space: closed-form
    SETTLE for the 3-site molecules, iterative RATTLE for the remaining
    constraints; the virtual sites' rows are pinned to zero. A system with
    none of these gets v back as it is, with no device operation."""
    system = ctx.system
    sset = getattr(system, "settle", None)
    if sset is not None:
        v = settle_velocities(sset, x, v, ctx.masses)
    cons = getattr(system, "constraints", None)
    if cons is not None:
        v = rattle_velocities(cons, x, v, 1.0 / ctx.masses)
    vsites = getattr(system, "virtual_sites", None)
    if vsites is not None:
        v = zero_virtual_velocities(vsites, v)
    return v


def force_cache_tag(groups) -> str:
    """State.extra key for the cached forces of a force-group set — the
    analog of the CustomIntegrator's per-group force registers f0/f1/f2."""
    if groups is None:
        return "fcache_all"
    return "fcache_" + "_".join(str(g) for g in sorted(groups))


def parse_force_cache_tag(key: str):
    body = key[len("fcache_"):]
    return None if body == "all" else frozenset(int(g) for g in body.split("_"))


class BoostPropagator(Propagator):
    """v <- v + (F_groups / m) * t
    (atomsmm/propagators.py::VelocityBoostPropagator), followed by the
    velocity projection of a constrained system.

    cache: None  — always evaluate forces fresh;
           'read' — use the cached forces in State.extra (stored by the
             matching 'write' kick at the current positions);
           'write' — evaluate fresh, store into the cache, then boost.
    """

    def __init__(self, groups=None, cache: str | None = None):
        self.groups = None if groups is None else frozenset(groups)
        self.cache = cache

    def extra_variables(self, system, state):
        if self.cache is None:
            return {}
        return {force_cache_tag(self.groups): torch.zeros_like(state.x)}

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        if self.cache == "read":
            f = state.extra[force_cache_tag(self.groups)]
        else:
            f = ctx.forces(state, self.groups)
        m = ctx.masses
        inv_m = torch.where(m > 0, 1.0 / torch.where(m > 0, m, torch.ones_like(m)),
                            torch.zeros_like(m))
        v = _project_velocities(ctx, state.x, state.v + f * inv_m[:, None] * t)
        state = replace(state, v=v)
        if self.cache == "write":
            state = state.with_extra(**{force_cache_tag(self.groups): f})
        return state

    def describe(self, fraction=1.0):
        g = "all" if self.groups is None else sorted(self.groups)
        c = f", {self.cache} cache" if self.cache else ""
        return [f"v <- v + F[{g}]/m * {fraction:g} dt{c}"]


class VelocityVerletPropagator(Propagator):
    """Velocity Verlet: B(t/2) A(t) B(t/2)
    (atomsmm/propagators.py::VelocityVerletPropagator). The leading kick
    reads the force cache and the trailing kick refreshes it; with
    cached=False both evaluate the forces afresh."""

    def __init__(self, groups=None, cached: bool = True):
        self.pre = BoostPropagator(groups, cache="read" if cached else None)
        self.post = BoostPropagator(groups, cache="write" if cached else None)
        self.move = TranslationPropagator()

    def extra_variables(self, system, state):
        out = self.pre.extra_variables(system, state)
        out.update(self.post.extra_variables(system, state))
        return out

    def apply(self, ctx, state, fraction):
        state = self.pre.apply(ctx, state, 0.5 * fraction)
        state = self.move.apply(ctx, state, fraction)
        state = self.post.apply(ctx, state, 0.5 * fraction)
        return state

    def describe(self, fraction=1.0):
        return (
            ["VelocityVerlet:"]
            + ["  " + l for l in self.pre.describe(0.5 * fraction)]
            + ["  " + l for l in self.move.describe(fraction)]
            + ["  " + l for l in self.post.describe(0.5 * fraction)]
        )


class RespaPropagator(Propagator):
    """r-RESPA nested multiple-timescale splitting
    (atomsmm/propagators.py::RespaPropagator).

    loops[k] is the number of substeps at level k (innermost = force group
    0). At level k > 0 one pass over fraction f performs loops[k] iterations
    of  B_k(f'/2) [bath_k(f'/2)] level_{k-1}(f') [bath_k(f'/2)] B_k(f'/2)
    with f' = f / loops[k], where B_k = boost_cls(groups={k}, cache=...)
    kicks with the forces of group k; the innermost motion at level 0 is
    `core` (default: a plain translation). `baths` maps level -> Propagator
    spliced inside that level's kicks; level -1 wraps the outermost level.
    Every kick reads the force cache on its leading half and writes it on
    its trailing half.
    """

    def __init__(
        self,
        loops: Sequence[int],
        core: Optional[Propagator] = None,
        baths: Optional[Dict[int, Propagator]] = None,
        boost_cls=BoostPropagator,
    ):
        self.loops = [int(n) for n in loops]
        self.levels = len(self.loops)
        self.core = core
        self.baths = dict(baths or {})
        self.boost_cls = boost_cls

    def extra_variables(self, system, state):
        out = {}
        if self.core is not None:
            out.update(self.core.extra_variables(system, state))
        for b in self.baths.values():
            out.update(b.extra_variables(system, state))
        for k in range(self.levels):
            out.update(self.boost_cls(groups={k}, cache="write")
                       .extra_variables(system, state))
        return out

    def _level(self, ctx, state, k: int, fraction: float):
        n = self.loops[k]
        sub = fraction / n
        bath = self.baths.get(k)
        boost_pre = self.boost_cls(groups={k}, cache="read")
        boost_post = self.boost_cls(groups={k}, cache="write")
        for _ in range(n):
            state = boost_pre.apply(ctx, state, 0.5 * sub)
            if bath is not None:
                state = bath.apply(ctx, state, 0.5 * sub)
            if k == 0:
                if self.core is not None:
                    state = self.core.apply(ctx, state, sub)
                else:
                    state = TranslationPropagator().apply(ctx, state, sub)
            else:
                state = self._level(ctx, state, k - 1, sub)
            if bath is not None:
                state = bath.apply(ctx, state, 0.5 * sub)
            state = boost_post.apply(ctx, state, 0.5 * sub)
        return state

    def apply(self, ctx, state, fraction):
        outer_bath = self.baths.get(-1)
        if outer_bath is not None:
            state = outer_bath.apply(ctx, state, 0.5 * fraction)
        state = self._level(ctx, state, self.levels - 1, fraction)
        if outer_bath is not None:
            state = outer_bath.apply(ctx, state, 0.5 * fraction)
        return state

    def describe(self, fraction=1.0):
        lines = [f"RESPA(loops={self.loops}):"]

        def level(k, f, indent):
            pad = "  " * indent
            n = self.loops[k]
            sub = f / n
            lines.append(pad + f"repeat x{n}:")
            lines.append(pad + f"  v <- v + F[{k}]/m * {0.5*sub:g} dt")
            if k in self.baths:
                lines.append(pad + f"  bath[{k}]({0.5*sub:g} dt)")
            if k == 0:
                if self.core is not None:
                    for l in self.core.describe(sub):
                        lines.append(pad + "  " + l)
                else:
                    lines.append(pad + f"  x <- x + v * {sub:g} dt")
            else:
                level(k - 1, sub, indent + 1)
            if k in self.baths:
                lines.append(pad + f"  bath[{k}]({0.5*sub:g} dt)")
            lines.append(pad + f"  v <- v + F[{k}]/m * {0.5*sub:g} dt")

        if -1 in self.baths:
            lines.append(f"  bath[-1]({0.5*fraction:g} dt)")
        level(self.levels - 1, fraction, 1)
        if -1 in self.baths:
            lines.append(f"  bath[-1]({0.5*fraction:g} dt)")
        return lines


class NoseHooverChainPropagator(Propagator):
    """Global Nosé-Hoover chain thermostat
    (atomsmm/propagators.py::NoseHooverPropagator), chain length `nchain`,
    Suzuki-Yoshida sub-splitting with `nsy` weights x `nloops` loops
    (Martyna-Tuckerman-Klein).

    Extended variables (State.extra): {tag}_v (nchain,) chain velocities;
    {tag}_eta (nchain,) chain positions. The chain runs as scalar tensor
    operations on the device of the velocities (no host synchronisation).
    """

    is_thermostat = True

    def __init__(self, temperature, degrees_of_freedom, time_scale,
                 nchain: int = 2, nsy: int = 3, nloops: int = 1, tag="nhc"):
        self.temperature = float(temperature)
        self.dof = int(degrees_of_freedom)
        self.tau = float(time_scale)
        self.nchain = int(nchain)
        self.nsy = int(nsy)
        self.nloops = int(nloops)
        self.tag = tag

    def _q(self):
        """Chain masses as host floats."""
        kT = BOLTZMANN * self.temperature
        q = [kT * self.tau**2] * self.nchain
        q[0] *= self.dof
        return q

    def extra_variables(self, system, state):
        z = torch.zeros((self.nchain,), dtype=state.v.dtype,
                        device=state.v.device)
        return {f"{self.tag}_v": z, f"{self.tag}_eta": z.clone()}

    def apply(self, ctx, state, fraction):
        kT = BOLTZMANN * self.temperature
        q = self._q()
        nc = self.nchain
        v_eta = list(state.extra[f"{self.tag}_v"].unbind(0))
        eta = state.extra[f"{self.tag}_eta"]
        v = state.v
        twok = torch.sum(ctx.masses[:, None] * v * v)  # 2 * kinetic energy
        scale = torch.ones((), dtype=v.dtype, device=v.device)

        def update(j, dt_w, h):
            if j == 0:
                g = (twok * scale**2 - self.dof * kT) / q[0]
            else:
                g = (q[j - 1] * v_eta[j - 1] ** 2 - kT) / q[j]
            if j < nc - 1:
                damp = torch.exp(-0.25 * dt_w * v_eta[j + 1])
                v_eta[j] = v_eta[j] * damp**2 + g * h * damp
            else:
                v_eta[j] = v_eta[j] + g * h

        t = fraction * ctx.dt
        weights = [w * t / self.nloops for w in _SY_WEIGHTS[self.nsy]] * self.nloops
        for dt_w in weights:
            h = 0.5 * dt_w
            for j in range(nc - 1, -1, -1):   # chain tail -> head
                update(j, dt_w, h)
            scale = scale * torch.exp(-dt_w * v_eta[0])
            eta = eta + dt_w * torch.stack(v_eta)
            for j in range(nc):               # chain head -> tail
                update(j, dt_w, h)
        state = replace(state, v=v * scale)
        return state.with_extra(**{f"{self.tag}_v": torch.stack(v_eta),
                                   f"{self.tag}_eta": eta})

    def conserved_extra(self, state):
        """Thermostat contribution to the conserved quantity."""
        kT = BOLTZMANN * self.temperature
        v_eta = state.extra[f"{self.tag}_v"]
        eta = state.extra[f"{self.tag}_eta"]
        q = torch.tensor(self._q(), dtype=v_eta.dtype, device=v_eta.device)
        e = torch.sum(0.5 * q * v_eta**2) + self.dof * kT * eta[0]
        if self.nchain > 1:
            e = e + kT * torch.sum(eta[1:])
        return e

    def describe(self, fraction=1.0):
        return [
            f"NoseHooverChain(T={self.temperature}K, tau={self.tau}ps, "
            f"nchain={self.nchain}, nsy={self.nsy}) over {fraction:g} dt"
        ]



def _normal(rng: torch.Generator, like: torch.Tensor, shape=None):
    """Standard normal draws of `like`'s dtype on its device from `rng`
    (which lives on that device and advances in place)."""
    return torch.randn(like.shape if shape is None else shape, generator=rng,
                       dtype=like.dtype, device=like.device)


class OrnsteinUhlenbeckPropagator(Propagator):
    """Exact Ornstein-Uhlenbeck update on particle velocities (the Langevin
    friction+noise half: v <- v e^{-gamma t} + sqrt(kT/m (1 - e^{-2 gamma t})) R)
    (atomsmm/propagators.py::OrnsteinUhlenbeckPropagator). Setting
    `variable` updates a named extra tensor with effective mass `mass`
    instead. With `temperature_global` the bath temperature is read from
    that global parameter at step time (falling back to `temperature`).
    R is drawn from the state's torch.Generator. The particle velocities
    are projected onto the constraints afterwards."""

    is_thermostat = True

    def __init__(self, temperature, friction, variable: Optional[str] = None,
                 mass=None, temperature_global: Optional[str] = None):
        self.temperature = float(temperature)
        self.friction = float(friction)  # 1/ps
        self.variable = variable
        self.mass = mass
        self.temperature_global = temperature_global

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        t_set = self.temperature
        if self.temperature_global is not None:
            t_set = (ctx.globals or {}).get(self.temperature_global, t_set)
        kT = BOLTZMANN * t_set
        decay = math.exp(-self.friction * t)
        noise = math.sqrt(max(1.0 - decay * decay, 0.0))
        if self.variable is None:
            m = ctx.masses[:, None]
            # massless rows carry no momentum: zero noise
            sigma = torch.where(
                m > 0, (kT / torch.where(m > 0, m, torch.ones_like(m))) ** 0.5,
                torch.zeros_like(m))
            r = _normal(state.rng, state.v)
            # additive noise breaks the constraints' tangency: project as
            # the kicks do (uniform rescalings such as NHC or CSVR keep it)
            v = _project_velocities(ctx, state.x,
                                    state.v * decay + sigma * noise * r)
            return replace(state, v=v)
        z = state.extra[self.variable]
        sigma = (kT / self.mass) ** 0.5
        z = z * decay + sigma * noise * _normal(state.rng, z)
        return state.with_extra(**{self.variable: z})

    def describe(self, fraction=1.0):
        target = self.variable or "v"
        return [
            f"{target} <- OU(T={self.temperature}K, gamma={self.friction}/ps) "
            f"over {fraction:g} dt"
        ]


class VelocityRescalingPropagator(Propagator):
    """Bussi-Donadio-Parrinello stochastic velocity rescaling (CSVR)
    (atomsmm/propagators.py::VelocityRescalingPropagator).

    The chi-square variate with dof - 1 degrees of freedom is the sum of
    dof - 1 squared standard normals drawn from the state's
    torch.Generator (torch's gamma sampler takes no generator): exact, no
    rejection loop and so no host synchronisation, at dof - 1 draws per
    application."""

    is_thermostat = True

    def __init__(self, temperature, degrees_of_freedom, time_scale):
        self.temperature = float(temperature)
        self.dof = int(degrees_of_freedom)
        self.tau = float(time_scale)

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        kT = BOLTZMANN * self.temperature
        m = ctx.masses[:, None]
        ke = 0.5 * torch.sum(m * state.v * state.v)
        ke_bar = 0.5 * self.dof * kT
        c = math.exp(-t / self.tau)
        r1 = _normal(state.rng, state.v, ())
        rsum = torch.sum(_normal(state.rng, state.v, (self.dof - 1,)) ** 2)
        ratio = ke_bar / (self.dof * ke)
        alpha2 = (
            c
            + (1.0 - c) * ratio * (r1 * r1 + rsum)
            + 2.0 * r1 * torch.sqrt(c * (1.0 - c) * ratio)
        )
        # Bussi's alpha carries a sign: negative when the r1 noise term
        # dominates (sign of r1 + sqrt(c/((1-c)*ratio))); losing the velocity
        # flip biases the KE distribution at small dof.
        sign = torch.sign(r1 + torch.sqrt(c / ((1.0 - c) * ratio)))
        alpha = torch.where(sign == 0, torch.ones_like(sign), sign) \
            * torch.sqrt(alpha2)
        return replace(state, v=state.v * alpha)

    def describe(self, fraction=1.0):
        return [
            f"v <- CSVR rescale(T={self.temperature}K, tau={self.tau}ps) "
            f"over {fraction:g} dt"
        ]


class GenericBoostPropagator(Propagator):
    """target <- target + rate_fn(ctx, state) * t — building block for
    extended-variable kicks (atomsmm/propagators.py::GenericBoostPropagator).
    target is 'v' or a State.extra key."""

    def __init__(self, rate_fn, target: str = "v"):
        self.rate_fn = rate_fn
        self.target = target

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        rate = self.rate_fn(ctx, state)
        if self.target == "v":
            return replace(state, v=state.v + t * rate)
        z = state.extra[self.target] + t * rate
        return state.with_extra(**{self.target: z})

    def describe(self, fraction=1.0):
        return [f"{self.target} <- {self.target} + rate * {fraction:g} dt"]


class GenericScalingPropagator(Propagator):
    """v <- v * exp(-t * rate_fn(ctx, state)) — building block for
    extended-variable couplings
    (atomsmm/propagators.py::GenericScalingPropagator)."""

    def __init__(self, rate_fn, target: str = "v"):
        self.rate_fn = rate_fn
        self.target = target

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        z = state.v if self.target == "v" else state.extra[self.target]
        # rate_fn may return a tensor or a plain number
        rate = torch.as_tensor(self.rate_fn(ctx, state), dtype=z.dtype,
                               device=z.device)
        z = z * torch.exp(-t * rate)
        if self.target == "v":
            return replace(state, v=z)
        return state.with_extra(**{self.target: z})

    def describe(self, fraction=1.0):
        return [f"{self.target} <- {self.target} * exp(-{fraction:g} dt * rate)"]
