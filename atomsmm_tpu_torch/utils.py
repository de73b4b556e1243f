"""Shared helpers (counterpart of atomsmm_tpu/utils.py).

Plain dataclasses take the place of the JAX package's pytree dataclasses:
PyTorch runs eagerly, so nothing needs to tell static fields from traced
ones.

Examples:

>>> from atomsmm_tpu_torch.models import water_system
>>> system, x, box = water_system(n_molecules=8, r_cut=0.3, r_switch=0.25,
...                               device="cpu")
>>> count_degrees_of_freedom(system)   # 3N - 3 (COM motion removed)
69
>>> find_nonbonded_force(system)       # index of the NonbondedForce
0
"""
from __future__ import annotations

import dataclasses


class InputError(Exception):
    """Invalid user input (mirror of atomsmm/utils.py::InputError)."""

    def __init__(self, msg: str):
        super().__init__(msg)


def resolve_device(device=None):
    """The torch.device an entry point builds on: `device` when given, else
    the CUDA card. Without a card and without `device` it raises; the port
    never falls back to the CPU unasked."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available, and atomsmm_tpu_torch builds on the "
            "card unless asked otherwise: pass device=\"cpu\" to run on the "
            "CPU")
    return torch.device("cuda")


def replace(obj, **changes):
    """A copy of the dataclass `obj` with `changes` applied."""
    return dataclasses.replace(obj, **changes)


def count_degrees_of_freedom(system) -> int:
    """Number of kinetic degrees of freedom (atomsmm/utils.py::countDegreesOfFreedom):
    3N, minus the constraints, minus 3 per virtual site (a massless site's
    velocity is pinned to zero), minus 3 if center-of-mass motion is
    removed."""
    dof = 3 * system.num_particles - system.num_constraints
    if system.virtual_sites is not None:
        dof -= 3 * system.virtual_sites.size
    if system.remove_com_motion:
        dof -= 3
    return dof


def find_nonbonded_force(system, position: int = 0):
    """Index of the (position-th) NonbondedForce in the system
    (atomsmm/utils.py::findNonbondedForce)."""
    from .forces import NonbondedForce

    hits = [i for i, f in enumerate(system.forces) if type(f) is NonbondedForce]
    if len(hits) <= position:
        raise InputError("system does not contain the requested NonbondedForce")
    return hits[position]


def hijack_force(system, index: int):
    """Detach and return the force at `index` (atomsmm/utils.py::hijackForce).

    Returns (force, new_system): systems are not edited in place here, so
    unlike the reference this leaves `system` as it was.
    """
    force = system.forces[index]
    new_forces = tuple(f for i, f in enumerate(system.forces) if i != index)
    return force, replace(system, forces=new_forces)
