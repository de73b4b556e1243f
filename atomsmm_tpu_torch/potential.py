"""Potential-energy assembly and decomposition (counterpart of
atomsmm_tpu/potential.py).

`aux` carries evaluation-time structures that are state, not parameters:
the neighbor buckets (ops/neighbors.py). Forces with an explicit
`energy_and_forces` are used directly; the others are differentiated with
autograd. A marker force (`inert`, the MonteCarloBarostat) adds nothing and
is skipped by the evaluators a step runs.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Optional

import torch


def potential_energy(system, x, box, globals=None,
                     groups: Optional[Iterable[int]] = None, aux=None):
    """Total potential energy, optionally restricted to a set of force groups."""
    globals = globals or {}
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for f in system.forces:
        if not f.inert and (groups is None or f.group in groups):
            total = total + f.energy(x, box, globals, aux)
    return total


def _energy_and_forces(force, x, box, globals, aux):
    if hasattr(force, "energy_and_forces"):
        return force.energy_and_forces(x, box, globals, aux)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        e = force.energy(xx, box, globals, aux)
        (g,) = torch.autograd.grad(e, xx)
    return e.detach(), -g


def force_fn(system, groups: Optional[Iterable[int]] = None):
    """Return f(x, box, globals, aux) -> (energy, forces) for the given groups."""
    groups = None if groups is None else frozenset(groups)
    selected = [f for f in system.forces
                if not f.inert and (groups is None or f.group in groups)]

    def f(x, box, globals=None, aux=None):
        globals = globals or {}
        e_total = torch.zeros((), dtype=x.dtype, device=x.device)
        f_total = torch.zeros_like(x)
        for force in selected:
            e, fr = _energy_and_forces(force, x, box, globals, aux)
            e_total = e_total + e
            f_total = f_total + fr
        return e_total, f_total

    return f


def split_potential_energy(system, x, box, globals=None,
                           aux=None) -> "OrderedDict[str, torch.Tensor]":
    """Energy per force object, keyed by class name (with #k suffix on
    duplicates), plus 'Total' — mirrors atomsmm/utils.py::splitPotentialEnergy."""
    globals = globals or {}
    out = OrderedDict()
    counts: Dict[str, int] = {}
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for f in system.forces:
        name = f.name
        counts[name] = counts.get(name, 0) + 1
        if counts[name] > 1:
            name = f"{name}#{counts[name]}"
        e = f.energy(x, box, globals, aux)
        out[name] = e
        total = total + e
    out["Total"] = total
    return out


def group_energies(system, x, box, globals=None, aux=None) -> Dict[int, torch.Tensor]:
    """Energy per force group (the RESPA decomposition)."""
    globals = globals or {}
    out: Dict[int, torch.Tensor] = {}
    for f in system.forces:
        e = f.energy(x, box, globals, aux)
        out[f.group] = out.get(f.group, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)) + e
    return out
