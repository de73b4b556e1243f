"""Energy minimization (counterpart of atomsmm_tpu/minimize.py and of
openmm.LocalEnergyMinimizer).

FIRE (Fast Inertial Relaxation Engine, Bitzek et al., PRL 97, 170201
(2006)): a fixed number of iterations, no line search, relaxing the lattice
starts that the model functions produce. The iterations are a Python loop of
tensor operations; the uphill reset and the dt / alpha schedule are
torch.where selects, so nothing is read back to the host inside the loop.

Where the JAX package evaluates the forces on the dense pair path, a system
with neighbor lists here (cell buckets or block lists) rebuilds them at
every iteration and passes them as aux, so that the forces come from the
pair kernels on the card (the dense sum is O(N^2)). The forces
do not depend on which valid list is used. The lists' overflow flags
are read once, after the loop; on an overflow the specs are retuned from
the starting configuration and the iterations run again, as
Context.__init__ retunes a cold start.

>>> import torch
>>> from atomsmm_tpu_torch.models import argon_system
>>> from atomsmm_tpu_torch.potential import potential_energy
>>> system, x, box = argon_system(n=64, jitter=0.1, seed=1, r_cut=0.5,
...                               r_switch=0.4, device="cpu")
>>> x_min = fire_minimize(system, x, box, steps=50)
>>> bool(potential_energy(system, x_min, box) < potential_energy(system, x, box))
True
"""
from __future__ import annotations

import torch

from .ops.neighbors import (
    all_neighbor_extras,
    make_aux,
    retune_neighbor_specs,
    unhealthy_flags,
)
from .potential import force_fn
from .utils import replace


def _fire_pass(system, x, box, globals, steps, dt_start, dt_max, f_inc,
               f_dec, alpha_start, f_alpha, n_min, max_step):
    """One run of the FIRE iterations: (positions, overflow), the overflow
    flag a device bool OR-ed over every rebuild."""
    f = force_fn(system)
    m = system.masses
    # virtual sites are massless and forceless: kick 0, not nan
    inv_m = torch.where(m > 0, 1.0 / torch.where(m > 0, m, torch.ones_like(m)),
                        torch.zeros_like(m))[:, None].to(x.dtype)
    overflow = torch.zeros((), dtype=torch.bool, device=x.device)
    v = torch.zeros_like(x)
    dt = torch.as_tensor(dt_start, dtype=x.dtype, device=x.device)
    alpha = torch.as_tensor(alpha_start, dtype=x.dtype, device=x.device)
    n_pos = torch.zeros((), dtype=torch.int32, device=x.device)
    for _ in range(steps):
        aux = None
        if system.neighbors is not None:
            extras = all_neighbor_extras(system, x, box)
            aux = make_aux(system, extras)
            overflow = overflow | unhealthy_flags(extras, ("overflow",))[0]
        _, F = f(x, box, globals, aux)
        v = v + dt * F * inv_m
        power = torch.sum(F * v)
        fnorm = torch.sqrt(torch.sum(F * F)) + 1e-30
        vnorm = torch.sqrt(torch.sum(v * v))
        v_mixed = (1.0 - alpha) * v + alpha * vnorm * F / fnorm
        uphill = power <= 0.0
        v = torch.where(uphill, torch.zeros_like(v), v_mixed)
        grow = (~uphill) & (n_pos >= n_min)
        dt = torch.where(uphill, dt * f_dec,
                         torch.where(grow, torch.clamp(dt * f_inc, max=dt_max),
                                     dt))
        alpha = torch.where(uphill, torch.full_like(alpha, alpha_start),
                            torch.where(grow, alpha * f_alpha, alpha))
        n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        dx = dt * v
        step_norm = torch.sqrt(torch.sum(dx * dx, dim=1, keepdim=True))
        scale = torch.clamp(max_step / torch.clamp(step_norm, min=1e-30),
                            max=1.0)
        x = x + dx * scale
    return x, overflow


def _fire(system, x, box, globals=None, steps: int = 200,
          dt_start: float = 1e-4, dt_max: float = 2e-3, f_inc: float = 1.1,
          f_dec: float = 0.5, alpha_start: float = 0.1, f_alpha: float = 0.99,
          n_min: int = 5, max_step: float = 0.02):
    """(minimized positions, the system they were minimized with): the
    system's neighbor specs retuned if a cell overflowed."""
    args = (steps, dt_start, dt_max, f_inc, f_dec, alpha_start, f_alpha,
            n_min, max_step)
    globals = globals or {}
    for attempt in range(3):
        out, overflow = _fire_pass(system, x, box, globals, *args)
        if system.neighbors is None or not bool(overflow):
            return out, system
        system = retune_neighbor_specs(system, x, box,
                                       safety=1.15 * (1.2 ** attempt),
                                       grow_only=True)
    raise RuntimeError("cell-list capacity overflow persists in FIRE after "
                       "retuning: increase the cell capacity")


def fire_minimize(system, x, box, globals=None, steps: int = 200,
                  dt_start: float = 1e-4, dt_max: float = 2e-3,
                  f_inc: float = 1.1, f_dec: float = 0.5,
                  alpha_start: float = 0.1, f_alpha: float = 0.99,
                  n_min: int = 5, max_step: float = 0.02):
    """Return minimized positions after `steps` FIRE iterations.

    max_step [nm] caps each atom's displacement per iteration: without it
    the huge forces of overlapping lattice starts make the first kick
    diverge (a trust-region clamp)."""
    return _fire(system, x, box, globals, steps, dt_start, dt_max, f_inc,
                 f_dec, alpha_start, f_alpha, n_min, max_step)[0]


def minimize_energy(context, steps: int = 200, **kwargs):
    """Minimize a Context's positions in place (openmm
    LocalEnergyMinimizer.minimize). A neighbor spec retuned for an overflow
    becomes the Context's; the next step() or get_state() rebuilds the
    buckets and the force caches from the new positions."""
    x, system = _fire(context.system, context.state.x, context.state.box,
                      context.parameters, steps=steps, **kwargs)
    context.system = system
    context.state = replace(context.state, x=x)
    return context
