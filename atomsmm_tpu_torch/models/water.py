"""q-SPC/Fw flexible water (counterpart of atomsmm_tpu/models/water.py).

Force field (Paesani et al., J. Chem. Phys. 125, 184507 (2006), q-SPC/Fw):
qO = -0.84 e, qH = +0.42 e, LJ on oxygen only, harmonic O-H bonds and
H-O-H angle, no constraints. The initial lattice uses the same numpy
RandomState layout as the JAX package's water_system, so the same seed
gives the same positions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..forces import (
    HarmonicAngleForce,
    HarmonicBondForce,
    NonbondedForce,
    TemplateBondedForce,
    compute_dispersion_coefficient,
)
from ..system import System, make_exclusions_array
from ..utils import InputError, resolve_device

Q_O = -0.84
Q_H = 0.42
SIGMA_O = 0.3165492  # nm
EPSILON_O = 0.1554253 * 4.184  # kJ/mol
MASS_O = 15.9994
MASS_H = 1.008
BOND_R0 = 0.1  # nm
BOND_K = 1059.162 * 4.184 * 100.0  # kJ/mol/nm^2
ANGLE_T0 = 112.0 * np.pi / 180.0  # rad
ANGLE_K = 75.90 * 4.184  # kJ/mol/rad^2
WATER_NUMBER_DENSITY = 33.328  # molecules / nm^3 at ~298 K, 1 atm


def _water_geometry():
    """One molecule at equilibrium geometry: O at origin, H's in the xy plane."""
    r, t = BOND_R0, ANGLE_T0
    h1 = np.array([r * np.sin(t / 2), r * np.cos(t / 2), 0.0])
    h2 = np.array([-r * np.sin(t / 2), r * np.cos(t / 2), 0.0])
    return np.stack([np.zeros(3), h1, h2])


def _random_rotations(n, rs):
    """Uniform random rotation matrices via quaternion sampling."""
    q = rs.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def water_positions(n_molecules: int, box_l: float, seed: int = 0):
    rs = np.random.RandomState(seed)
    n_side = int(np.ceil(n_molecules ** (1.0 / 3.0)))
    spacing = box_l / n_side
    grid = (np.arange(n_side) + 0.5) * spacing
    centers = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), -1)
    centers = centers.reshape(-1, 3)[:n_molecules]
    rot = _random_rotations(n_molecules, rs)
    atoms = centers[:, None, :] + np.einsum("mij,aj->mai", rot, _water_geometry())
    return atoms.reshape(-1, 3)


def water_system(
    n_molecules: int = 216,
    method: str = "cutoff",
    r_cut: float = 0.9,
    r_switch: float = 0.8,
    number_density: float = WATER_NUMBER_DENSITY,
    seed: int = 0,
    dtype=None,
    chunk: int = 256,
    pme_grid=None,
    pme_alpha: float | None = None,
    neighbors: bool = False,
    skin: float = 0.1,
    dispersion_correction: bool = False,
    template_bonded: bool = True,
    device=None,
):
    """Build (System, positions, box) for n_molecules of q-SPC/Fw water on
    `device` (default: the CUDA card; without one pass device="cpu") in
    `dtype` (default: torch's default dtype).

    Atom order: [O, H, H] per molecule; every force in group 0 (use
    systems.RESPASystem to split). Under method 'pme' the Ewald alpha, grid
    and spline order come from ops.pme.choose_pme_parameters unless
    `pme_alpha` / `pme_grid` fix them.
    """
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    m = n_molecules
    n = 3 * m
    box_l = (m / number_density) ** (1.0 / 3.0)
    if r_cut > 0.5 * box_l:
        raise InputError(
            f"r_cut={r_cut} exceeds half the box ({box_l:.3f}/2) — minimum "
            f"image breaks; use >= {int(np.ceil((2*r_cut)**3*number_density))} "
            "molecules or a smaller cutoff")
    x = water_positions(m, box_l, seed)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    o = 3 * np.arange(m)
    excl_pairs = np.concatenate(
        [np.stack([o, o + 1], 1), np.stack([o, o + 2], 1), np.stack([o + 1, o + 2], 1)]
    )
    exclusions = make_exclusions_array(n, excl_pairs, device=device)
    sigma = np.tile([SIGMA_O, 1.0, 1.0], m)  # irrelevant where eps = 0
    epsilon = np.tile([EPSILON_O, 0.0, 0.0], m)
    nb_kwargs = dict(
        group=0,
        charge=t(np.tile([Q_O, Q_H, Q_H], m)),
        sigma=t(sigma),
        epsilon=t(epsilon),
        exclusions=exclusions,
        r_cut=float(r_cut),
        r_switch=float(r_switch),
        eps_rf=1e15,
        method=method,
        use_switch=True,
        chunk=chunk,
    )
    if method == "pme":
        from ..ops.pme import choose_pme_parameters

        alpha, grid, order = choose_pme_parameters(
            r_cut, np.array([box_l] * 3), alpha=pme_alpha, grid=pme_grid)
        nb_kwargs.update(ewald_alpha=alpha, grid_shape=grid,
                         spline_order=order)
    if dispersion_correction:
        nb_kwargs["dispersion_coeff"] = compute_dispersion_coefficient(
            sigma, epsilon, r_switch, r_cut)
    nonbonded = NonbondedForce(**nb_kwargs)
    if template_bonded:
        bonded_forces = (
            TemplateBondedForce(
                group=0,
                bond_r0=t(np.full(2, BOND_R0)),
                bond_k=t(np.full(2, BOND_K)),
                angle_t0=t(np.full(1, ANGLE_T0)),
                angle_k=t(np.full(1, ANGLE_K)),
                n_molecules=m,
                atoms_per_molecule=3,
                bond_idx=((0, 1), (0, 2)),
                angle_idx=((1, 0, 2),),
            ),
        )
    else:
        bonds = np.concatenate([np.stack([o, o + 1], 1), np.stack([o, o + 2], 1)])
        angles = np.stack([o + 1, o, o + 2], 1)
        bonded_forces = (
            HarmonicBondForce(group=0, idx=t(bonds, torch.int32),
                              r0=t(np.full(len(bonds), BOND_R0)),
                              k=t(np.full(len(bonds), BOND_K))),
            HarmonicAngleForce(group=0, idx=t(angles, torch.int32),
                               theta0=t(np.full(m, ANGLE_T0)),
                               k=t(np.full(m, ANGLE_K))),
        )
    box = t(np.full(3, box_l))
    system = System(
        masses=t(np.tile([MASS_O, MASS_H, MASS_H], m)),
        forces=(nonbonded,) + bonded_forces,
        molecule=t(np.repeat(np.arange(m), 3), torch.int32),
        default_box=box,
        num_molecules=m,
    )
    if neighbors:
        from ..ops.neighbors import make_neighbor_spec

        spec = make_neighbor_spec(np.full(3, box_l), n, r_cut, skin=skin,
                                  exclusions=exclusions,
                                  occupancy_floor_from=x, device=device)
        system = system.with_neighbors(spec)
    return system, t(x), box
