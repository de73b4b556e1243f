"""Propagator algebra (counterpart of atomsmm_tpu/integrate/propagators.py).

Each Propagator's `apply(ctx, state, fraction)` advances time by
fraction*ctx.dt with PyTorch operations on the State; composition follows
the operator-splitting math of the reference, operator order included.
`describe(fraction)` prints the same instruction dump as the JAX package.

Ported: Translation (unconstrained), Boost (with the force-cache registers
that hold per-group forces between a 'write' kick and the next 'read'
kick), VelocityVerlet, Respa and NoseHooverChain.

>>> vv = VelocityVerletPropagator()
>>> for line in vv.describe(1.0):
...     print(line)
VelocityVerlet:
  v <- v + F[all]/m * 0.5 dt, read cache
  x <- x + v * 1 dt (+SETTLE/SHAKE if constrained)
  v <- v + F[all]/m * 0.5 dt, write cache
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

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


class Propagator:
    """Base class (atomsmm/propagators.py::Propagator)."""

    def extra_variables(self, system, state) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, ctx: StepContext, state: State, fraction: float) -> State:
        raise NotImplementedError

    def describe(self, fraction: float = 1.0):
        return [f"{type(self).__name__}({fraction:g} dt)"]


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


class TranslationPropagator(Propagator):
    """x <- x + v * t (atomsmm/propagators.py::TranslationPropagator).
    Unconstrained systems only: constraints are a later slice."""

    def apply(self, ctx, state, fraction):
        if getattr(ctx.system, "num_constraints", 0):
            raise NotImplementedError(
                "constrained systems (SETTLE/SHAKE) are not ported yet")
        return replace(state, x=state.x + state.v * (fraction * ctx.dt))

    def describe(self, fraction=1.0):
        return [f"x <- x + v * {fraction:g} dt (+SETTLE/SHAKE if constrained)"]


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
    (atomsmm/propagators.py::VelocityBoostPropagator).

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
        state = replace(state, v=state.v + f * inv_m[:, None] * t)
        if self.cache == "write":
            state = state.with_extra(**{force_cache_tag(self.groups): f})
        return state

    def describe(self, fraction=1.0):
        g = "all" if self.groups is None else sorted(self.groups)
        c = f", {self.cache} cache" if self.cache else ""
        return [f"v <- v + F[{g}]/m * {fraction:g} dt{c}"]


class VelocityVerletPropagator(Propagator):
    """Velocity Verlet: B(t/2) A(t) B(t/2); the leading kick reads the
    force cache, the trailing kick refreshes it."""

    def __init__(self, groups=None):
        self.pre = BoostPropagator(groups, cache="read")
        self.post = BoostPropagator(groups, cache="write")
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
    with f' = f / loops[k]; level 0 is a plain translation. `baths` maps
    level -> Propagator; level -1 wraps the outermost level. Every kick
    reads the force cache on its leading half and writes it on its trailing
    half.
    """

    def __init__(self, loops: Sequence[int],
                 baths: Optional[Dict[int, Propagator]] = None):
        self.loops = [int(n) for n in loops]
        self.levels = len(self.loops)
        self.baths = dict(baths or {})

    def extra_variables(self, system, state):
        out = {}
        for b in self.baths.values():
            out.update(b.extra_variables(system, state))
        for k in range(self.levels):
            out.update(BoostPropagator(groups={k}, cache="write")
                       .extra_variables(system, state))
        return out

    def _level(self, ctx, state, k: int, fraction: float):
        n = self.loops[k]
        sub = fraction / n
        bath = self.baths.get(k)
        boost_pre = BoostPropagator(groups={k}, cache="read")
        boost_post = BoostPropagator(groups={k}, cache="write")
        for _ in range(n):
            state = boost_pre.apply(ctx, state, 0.5 * sub)
            if bath is not None:
                state = bath.apply(ctx, state, 0.5 * sub)
            if k == 0:
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

    def __init__(self, temperature, degrees_of_freedom, time_scale,
                 nchain: int = 2, nsy: int = 3, nloops: int = 1):
        self.temperature = float(temperature)
        self.dof = int(degrees_of_freedom)
        self.tau = float(time_scale)
        self.nchain = int(nchain)
        self.nsy = int(nsy)
        self.nloops = int(nloops)
        self.tag = "nhc"

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

