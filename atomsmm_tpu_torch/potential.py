"""Potential-energy assembly and decomposition (counterpart of
atomsmm_tpu/potential.py).

`aux` carries evaluation-time structures that are state, not parameters:
the neighbor buckets (ops/neighbors.py). Forces with an explicit
`energy_and_forces` are used directly; the others are differentiated with
autograd. A marker force (`inert`, the MonteCarloBarostat) adds nothing and
is skipped by the evaluators a step runs. A system with virtual sites is
evaluated at the placed coordinates (ops/virtual_sites.py), and its forces
are pulled back onto the parent atoms.

`potential_energy` and `force_fn` take a stack of K systems as well (x
(K, N, 3), box (K, 3) or (K, 3, 3), globals shared or (K,) per row, aux
with (K, ncells, cap) buckets; any of them may be an expanded tensor whose
rows share one array): they return (K,) energies and (K, N, 3) forces, each
force's rows from its `energy_rows` / `energy_and_forces_rows`
(forces.py), one batched evaluation where the force has one. A system with
virtual sites evaluates a stack row by row.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Optional

import torch

from .ops.virtual_sites import place_virtual_sites, pull_back_forces


def _resolve_x(system, x):
    """Positions as the forces see them: virtual-site rows replaced by
    their construction from parents."""
    vs = getattr(system, "virtual_sites", None)
    return x if vs is None else place_virtual_sites(vs, x)


def potential_energy(system, x, box, globals=None,
                     groups: Optional[Iterable[int]] = None, aux=None):
    """Total potential energy, optionally restricted to a set of force
    groups; (K,) over a stack (x (K, N, 3))."""
    globals = globals or {}
    if x.ndim == 3:
        if getattr(system, "virtual_sites", None) is not None:
            from .forces import _in_turn

            return _in_turn(lambda *a: potential_energy(
                system, *a[:3], groups, a[3]), x, box, globals, aux)[0]
        total = x.new_zeros(x.shape[:1])
        for f in system.forces:
            if not f.inert and (groups is None or f.group in groups):
                total = total + f.energy_rows(x, box, globals, aux)
        return total
    x = _resolve_x(system, x)
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
    """Return f(x, box, globals, aux) -> (energy, forces) for the given groups.

    With virtual sites the forces are evaluated at the placed coordinates
    and pulled back through the placement's vector-Jacobian product: the
    chain-rule redistribution onto the parent atoms, with the virtual rows
    exactly zero. A group set that holds no force gives zero energy and
    zero forces. Over a stack (x (K, N, 3)) it returns (K,) energies and
    (K, N, 3) forces, each force's rows from energy_and_forces_rows.
    """
    groups = None if groups is None else frozenset(groups)
    selected = [f for f in system.forces
                if not f.inert and (groups is None or f.group in groups)]
    vs = getattr(system, "virtual_sites", None)

    def f(x, box, globals=None, aux=None):
        globals = globals or {}
        if x.ndim == 3:
            if vs is not None:
                from .forces import _in_turn

                return _in_turn(f, x, box, globals, aux)
            e_total = x.new_zeros(x.shape[:1])
            f_total = torch.zeros_like(x)
            for force in selected:
                e, fr = force.energy_and_forces_rows(x, box, globals, aux)
                e_total = e_total + e
                f_total = f_total + fr
            return e_total, f_total
        x_eval = _resolve_x(system, x)
        e_total = torch.zeros((), dtype=x.dtype, device=x.device)
        f_total = torch.zeros_like(x)
        for force in selected:
            e, fr = _energy_and_forces(force, x_eval, box, globals, aux)
            e_total = e_total + e
            f_total = f_total + fr
        if vs is not None and selected:
            f_total = pull_back_forces(vs, x, f_total)
        return e_total, f_total

    return f


def split_potential_energy(system, x, box, globals=None,
                           aux=None) -> "OrderedDict[str, torch.Tensor]":
    """Energy per force object, keyed by class name (with #k suffix on
    duplicates), plus 'Total' — mirrors atomsmm/utils.py::splitPotentialEnergy."""
    globals = globals or {}
    x = _resolve_x(system, x)
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
    x = _resolve_x(system, x)
    out: Dict[int, torch.Tensor] = {}
    for f in system.forces:
        e = f.energy(x, box, globals, aux)
        out[f.group] = out.get(f.group, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)) + e
    return out
