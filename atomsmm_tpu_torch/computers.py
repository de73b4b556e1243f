"""Observable computers: virials and pressures (counterpart of
atomsmm_tpu/computers.py), values in bar where pressures are read.

    atomic virial     W = -dU(s x, s box)/ds at s = 1
    molecular virial  W_mol = -dU/ds with only the molecules' centres of
                      mass scaled

The JAX package takes both from one jax.grad of the potential. A hand
kernel returns numbers, not a graph, so each force gives its own
(W, forces) (forces.py, `Force.virial`): autograd of energy(s x, s box)
for a force made of torch operations, and on the cell path the pair form's
virial flag, one sweep whose energy column sums the pairs' d . F. Under
molecular scaling only the derivative with respect to x changes, from
x_i to the centre of mass of i's molecule, so

    W_mol = W - sum_i F_i . (x_i - com_m(i))

with F the total forces: no second sweep.

Examples: two LJ particles at the potential minimum have zero virial
(du/dr = 0 there, W = -r u'(r)); at r = sigma, W = 24 eps.

>>> import torch
>>> from atomsmm_tpu_torch.forces import NonbondedForce
>>> from atomsmm_tpu_torch.system import System
>>> f64 = torch.float64
>>> r0 = 2.0 ** (1 / 6) * 0.34
>>> system = System(
...     masses=torch.full((2,), 39.9, dtype=f64),
...     forces=(NonbondedForce(
...         charge=torch.zeros(2, dtype=f64),
...         sigma=torch.full((2,), 0.34, dtype=f64),
...         epsilon=torch.full((2,), 0.65, dtype=f64),
...         exclusions=torch.full((2, 1), -1), r_cut=1.0, r_switch=0.99,
...         use_switch=False),),
...     default_box=torch.full((3,), 5.0, dtype=f64))
>>> box = torch.full((3,), 5.0, dtype=f64)
>>> x = torch.tensor([[1.0, 1.0, 1.0], [1.0 + r0, 1.0, 1.0]], dtype=f64)
>>> bool(abs(atomic_virial(system, x, box)) < 1e-9)
True
>>> x[1, 0] = 1.0 + 0.34
>>> bool(abs(atomic_virial(system, x, box) - 24.0 * 0.65) < 1e-8)
True
"""
from __future__ import annotations

import torch

from .ops.pbc import box_volume
from .potential import potential_energy
from .state import kinetic_energy
from .system import molecule_centres
from .units import PRESSURE_IN_BAR
from .utils import replace


def virial_and_forces(system, x, box, globals=None, aux=None):
    """(W, total forces): the sum of every force's `virial`."""
    globals = globals or {}
    w = torch.zeros((), dtype=x.dtype, device=x.device)
    f = torch.zeros_like(x)
    for force in system.forces:
        if not force.inert:
            wi, fi = force.virial(x, box, globals, aux)
            w, f = w + wi, f + fi
    return w, f


def _molecular(system, x, w, f):
    """W_mol from W and the total forces (see the module docstring)."""
    com = molecule_centres(x, system.molecule, system.num_molecules,
                           system.masses)
    return w - torch.sum(f * (x - com))


def atomic_virial(system, x, box, globals=None, aux=None):
    """W = -dU/ds under isotropic scaling of positions and box at s = 1."""
    return virial_and_forces(system, x, box, globals, aux)[0]


def molecular_virial(system, x, box, globals=None, aux=None):
    """W_mol: only the molecules' centres of mass scale, their geometry
    stays (the virial that pairs with the centre-of-mass kinetic energy in
    the molecular pressure)."""
    w, f = virial_and_forces(system, x, box, globals, aux)
    return _molecular(system, x, w, f)


def molecular_kinetic_energy(system, v):
    """Centre-of-mass kinetic energy of the molecules."""
    mol = system.molecule.long()
    n = system.num_molecules
    mw = system.masses[:, None].to(v.dtype)
    p = v.new_zeros((n, 3)).index_add_(0, mol, mw * v)
    m = v.new_zeros((n, 1)).index_add_(0, mol, mw)
    return 0.5 * torch.sum(p * p / m)


def coulomb_energy(system, x, box, globals=None, aux=None):
    """Electrostatic part of the nonbonded energy (the reference's
    `coulombEnergy` column): the nonbonded forces with every LJ epsilon
    zeroed and no dispersion tail. A force without a charge field (bonded,
    the barostat, a CustomNonbondedForce) and the softcore LJ force are
    left out; a force with charges and no epsilon (PMEReciprocalForce)
    stays as it is."""
    forces = []
    for f in system.forces:
        if hasattr(f, "full"):  # FarNonbondedForce
            f = replace(f, full=replace(
                f.full, epsilon=torch.zeros_like(f.full.epsilon),
                dispersion_coeff=None), minus_near=replace(
                f.minus_near, epsilon=torch.zeros_like(f.minus_near.epsilon)))
        elif f.name == "NonbondedExceptionsForce":
            f = replace(f, epsilon=torch.zeros_like(f.epsilon))
        elif f.name == "SoftcoreLennardJonesForce":
            continue
        elif hasattr(f, "epsilon") and hasattr(f, "charge"):
            f = replace(f, epsilon=torch.zeros_like(f.epsilon))
            if getattr(f, "dispersion_coeff", None) is not None:
                f = replace(f, dispersion_coeff=None)
        elif not hasattr(f, "charge"):
            continue
        forces.append(f)
    return potential_energy(system.replace_forces(forces), x, box, globals,
                            aux=aux)


def _pressure(w, k, box):
    """(2K + W)/(3V) [kJ/mol/nm^3]."""
    return (2.0 * k + w) / (3.0 * box_volume(box))


def atomic_pressure(system, state, globals=None, aux=None):
    """P = (2K + W)/(3V) [kJ/mol/nm^3]; times PRESSURE_IN_BAR for bar."""
    w = atomic_virial(system, state.x, state.box, globals, aux)
    return _pressure(w, kinetic_energy(system.masses, state.v), state.box)


def molecular_pressure(system, state, globals=None, aux=None):
    w = molecular_virial(system, state.x, state.box, globals, aux)
    return _pressure(w, molecular_kinetic_energy(system, state.v), state.box)


def compute_observables(system, state, globals=None, include_pressure=True,
                        include_coulomb=True):
    """The PressureComputer observables in one evaluation, on the neighbor
    buckets of State.extra: one virial pass (every force's `virial`) gives
    both virials and both pressures (in bar)."""
    from .ops.neighbors import make_aux

    aux = make_aux(system, state.extra)
    out = {}
    if include_pressure:
        x, v, box = state.x, state.v, state.box
        w, f = virial_and_forces(system, x, box, globals, aux)
        w_mol = _molecular(system, x, w, f)
        k_mol = molecular_kinetic_energy(system, v)
        out.update({
            "atomic_virial": w,
            "molecular_virial": w_mol,
            "atomic_pressure": _pressure(
                w, kinetic_energy(system.masses, v), box) * PRESSURE_IN_BAR,
            "molecular_pressure": _pressure(w_mol, k_mol, box)
            * PRESSURE_IN_BAR,
            "molecular_kinetic_energy": k_mol,
        })
    if include_coulomb:
        out["coulomb_energy"] = coulomb_energy(system, state.x, state.box,
                                               globals, aux)
    return out


class PressureComputer:
    """Class-shaped facade mirroring atomsmm/computers.py::PressureComputer:
    import a configuration, then read virials and pressures (in bar)."""

    def __init__(self, system, globals=None):
        self.system = system
        self.globals = dict(globals or {})
        self._values = None

    def import_configuration(self, state):
        self._values = compute_observables(self.system, state, self.globals)
        return self

    def get_atomic_virial(self):
        return float(self._values["atomic_virial"])

    def get_molecular_virial(self):
        return float(self._values["molecular_virial"])

    def get_atomic_pressure(self):
        return float(self._values["atomic_pressure"])

    def get_molecular_pressure(self):
        return float(self._values["molecular_pressure"])

    def get_molecular_kinetic_energy(self):
        return float(self._values["molecular_kinetic_energy"])
