"""Water models (counterpart of atomsmm_tpu/models/water.py).

  water_system — q-SPC/Fw flexible water (Paesani et al., J. Chem. Phys.
    125, 184507 (2006)): qO = -0.84 e, qH = +0.42 e, LJ on oxygen only,
    harmonic O-H bonds and H-O-H angle, no constraints.
  rigid_water_system — rigid TIP3P: no intramolecular force, the geometry
    held by SETTLE (or SHAKE/RATTLE with analytic=False).
  tip4p_water_system — rigid TIP4P/Ew: SETTLE on (O, H1, H2) and the
    massless M site as a virtual site.
  swm4_water_system — SWM4-NDP polarizable water: TIP4P's layout plus a
    Drude particle on a spring at the oxygen (ops/drude.py).

The initial lattices use the same numpy RandomState layout as the JAX
package's builders, so the same seed gives the same positions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..forces import (
    DrudeForce,
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


def _lattice(m, box_l, mol, seed):
    """m copies of the molecule `mol` (rows of sites) on a cubic lattice
    in a box of box_l, randomly rotated: (m * len(mol), 3)."""
    rs = np.random.RandomState(seed)
    n_side = int(np.ceil(m ** (1.0 / 3.0)))
    spacing = box_l / n_side
    grid = (np.arange(n_side) + 0.5) * spacing
    centers = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), -1)
    centers = centers.reshape(-1, 3)[:m]
    rot = _random_rotations(m, rs)
    return (centers[:, None, :]
            + np.einsum("mij,aj->mai", rot, mol)).reshape(-1, 3)


def water_positions(n_molecules: int, box_l: float, seed: int = 0):
    return _lattice(n_molecules, box_l, _water_geometry(), seed)


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


# --- rigid TIP3P water --------------------------------------------------------

TIP3P_Q_O = -0.834
TIP3P_Q_H = 0.417
TIP3P_SIGMA_O = 0.31507
TIP3P_EPSILON_O = 0.6364  # kJ/mol
TIP3P_R_OH = 0.09572
TIP3P_THETA = 104.52 * np.pi / 180.0


def _rigid_nonbonded(n, m, excl_pairs, charge, sigma, epsilon, method, r_cut,
                     r_switch, box_l, dtype, device):
    """The NonbondedForce keyword arguments of a rigid water model."""

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    kw = dict(
        group=0,
        charge=t(np.tile(charge, m)),
        sigma=t(np.tile(sigma, m)),
        epsilon=t(np.tile(epsilon, m)),
        exclusions=make_exclusions_array(n, excl_pairs, device=device),
        r_cut=float(r_cut),
        r_switch=float(r_switch),
        eps_rf=1e15,
        method=method,
        use_switch=True,
    )
    if method == "pme":
        from ..ops.pme import choose_pme_parameters

        alpha, grid, order = choose_pme_parameters(r_cut, np.full(3, box_l))
        kw.update(ewald_alpha=alpha, grid_shape=grid, spline_order=order)
    return kw


def rigid_water_system(
    n_molecules: int = 216,
    method: str = "cutoff",
    r_cut: float = 0.9,
    r_switch: float = 0.8,
    seed: int = 0,
    dtype=None,
    neighbors: bool = False,
    skin: float = 0.1,
    analytic: bool = True,
    device=None,
):
    """Rigid TIP3P water on `device` (default: the CUDA card; without one
    pass device="cpu") in `dtype`: no intramolecular forces, the geometry
    held by constraints (two O-H distances and the H-H distance per
    molecule). With analytic=True (the default, OpenMM's behaviour) the
    triangles go to closed-form SETTLE (ops/settle.py); analytic=False
    keeps the iterative SHAKE/RATTLE path (ops/constraints.py). Returns
    (System, positions, box).

    >>> import torch
    >>> system, x, box = rigid_water_system(n_molecules=27, r_cut=0.4,
    ...     r_switch=0.35, dtype=torch.float64, device="cpu")
    >>> system.settle.size, system.constraints, system.num_constraints
    (27, None, 81)
    """
    from ..ops.constraints import ConstraintSet
    from ..ops.settle import partition_constraints

    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    m = n_molecules
    n = 3 * m
    box_l = (m / WATER_NUMBER_DENSITY) ** (1.0 / 3.0)
    if r_cut > 0.5 * box_l:
        raise InputError(f"r_cut {r_cut} > box/2 ({box_l/2:.3f})")
    r, th = TIP3P_R_OH, TIP3P_THETA
    mol = np.stack([
        np.zeros(3),
        [r * np.sin(th / 2), r * np.cos(th / 2), 0.0],
        [-r * np.sin(th / 2), r * np.cos(th / 2), 0.0],
    ])
    x = _lattice(m, box_l, mol, seed)

    o = 3 * np.arange(m)
    pairs = np.concatenate([np.stack([o, o + 1], 1), np.stack([o, o + 2], 1),
                            np.stack([o + 1, o + 2], 1)])
    nb_kwargs = _rigid_nonbonded(
        n, m, pairs, [TIP3P_Q_O, TIP3P_Q_H, TIP3P_Q_H],
        [TIP3P_SIGMA_O, 1.0, 1.0], [TIP3P_EPSILON_O, 0.0, 0.0], method,
        r_cut, r_switch, box_l, dtype, device)
    d_hh = 2.0 * r * np.sin(th / 2.0)
    d0 = np.concatenate([np.full(m, r), np.full(m, r), np.full(m, d_hh)])
    cons = ConstraintSet(
        pairs=torch.as_tensor(pairs, device=device),
        d0=torch.as_tensor(d0, dtype=dtype, device=device))
    masses = torch.as_tensor(np.tile([MASS_O, MASS_H, MASS_H], m),
                             dtype=dtype, device=device)
    sset = None
    if analytic:
        sset, cons = partition_constraints(cons, masses)
    box = torch.full((3,), box_l, dtype=dtype, device=device)
    system = System(
        masses=masses,
        forces=(NonbondedForce(**nb_kwargs),),
        molecule=torch.as_tensor(np.repeat(np.arange(m), 3),
                                 dtype=torch.int32, device=device),
        default_box=box,
        constraints=cons,
        settle=sset,
        num_molecules=m,
        num_constraints=3 * m,
    )
    if neighbors:
        from ..ops.neighbors import make_neighbor_spec

        system = system.with_neighbors(make_neighbor_spec(
            np.full(3, box_l), n, r_cut, skin=skin,
            exclusions=nb_kwargs["exclusions"], occupancy_floor_from=x,
            device=device))
    return system, torch.as_tensor(x, dtype=dtype, device=device), box


# --- rigid TIP4P/Ew water (a virtual site) -----------------------------------

TIP4P_EW_Q_H = 0.52422
TIP4P_EW_Q_M = -1.04844
TIP4P_EW_SIGMA_O = 0.316435
TIP4P_EW_EPSILON_O = 0.680946  # kJ/mol
TIP4P_EW_R_OH = 0.09572
TIP4P_EW_THETA = 104.52 * np.pi / 180.0
TIP4P_EW_D_OM = 0.0125  # nm, O -> M along the HOH bisector


def tip4p_water_system(
    n_molecules: int = 216,
    method: str = "cutoff",
    r_cut: float = 0.9,
    r_switch: float = 0.8,
    seed: int = 0,
    dtype=None,
    neighbors: bool = False,
    skin: float = 0.1,
    device=None,
):
    """Rigid TIP4P/Ew water (Horn et al., JCP 120, 9665 (2004)) on `device`
    (default: the CUDA card) in `dtype`: 4 sites per molecule — O (LJ
    only), two H (charge only) and the massless M site with the negative
    charge, placed on the HOH bisector as a ThreeParticleAverage virtual
    site (ops/virtual_sites.py). SETTLE holds (O, H1, H2); M is rebuilt
    from its parents after every move, and its forces go to O, H1 and H2
    through the placement's vector-Jacobian product. Returns (System,
    positions, box).

    >>> import torch
    >>> system, x, box = tip4p_water_system(n_molecules=27, r_cut=0.4,
    ...     r_switch=0.35, dtype=torch.float64, device="cpu")
    >>> system.num_particles, system.virtual_sites.size, system.settle.size
    (108, 27, 27)
    >>> d_om = torch.linalg.norm(x[3::4] - x[0::4], dim=1)
    >>> bool(torch.allclose(d_om, torch.tensor(TIP4P_EW_D_OM,
    ...                                        dtype=torch.float64)))
    True
    """
    from ..ops.settle import make_settle_set
    from ..ops.virtual_sites import VirtualSiteSet, place_virtual_sites

    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    m = n_molecules
    n = 4 * m
    box_l = (m / WATER_NUMBER_DENSITY) ** (1.0 / 3.0)
    if r_cut > 0.5 * box_l:
        raise InputError(f"r_cut {r_cut} > box/2 ({box_l/2:.3f})")
    r, th = TIP4P_EW_R_OH, TIP4P_EW_THETA
    mol = np.stack([
        np.zeros(3),
        [r * np.sin(th / 2), r * np.cos(th / 2), 0.0],
        [-r * np.sin(th / 2), r * np.cos(th / 2), 0.0],
        np.zeros(3),  # M row: placed by the virtual-site construction
    ])
    x = _lattice(m, box_l, mol, seed)

    o = 4 * np.arange(m)
    # all 6 intramolecular pairs (O, H1, H2, M) are excluded
    excl_pairs = np.concatenate([np.stack([o + a, o + b], 1)
                                 for a in range(4) for b in range(a + 1, 4)])
    nb_kwargs = _rigid_nonbonded(
        n, m, excl_pairs, [0.0, TIP4P_EW_Q_H, TIP4P_EW_Q_H, TIP4P_EW_Q_M],
        [TIP4P_EW_SIGMA_O, 1.0, 1.0, 1.0],
        [TIP4P_EW_EPSILON_O, 0.0, 0.0, 0.0], method, r_cut, r_switch, box_l,
        dtype, device)
    masses = torch.as_tensor(np.tile([MASS_O, MASS_H, MASS_H, 0.0], m),
                             dtype=dtype, device=device)
    d_hh = 2.0 * r * np.sin(th / 2.0)
    sset = make_settle_set(np.stack([o, o + 1, o + 2], 1), r, d_hh, masses)
    c = TIP4P_EW_D_OM / (2.0 * r * np.cos(th / 2.0))
    vsites = VirtualSiteSet(
        sites=torch.as_tensor(o + 3, device=device),
        parents=torch.as_tensor(np.stack([o, o + 1, o + 2], 1), device=device),
        weights=torch.as_tensor(np.tile([1.0 - 2 * c, c, c], (m, 1)),
                                dtype=dtype, device=device),
        oop=torch.zeros((m,), dtype=dtype, device=device),
    )
    x = place_virtual_sites(vsites, torch.as_tensor(x, dtype=dtype,
                                                    device=device))
    box = torch.full((3,), box_l, dtype=dtype, device=device)
    system = System(
        masses=masses,
        forces=(NonbondedForce(**nb_kwargs),),
        molecule=torch.as_tensor(np.repeat(np.arange(m), 4),
                                 dtype=torch.int32, device=device),
        default_box=box,
        settle=sset,
        virtual_sites=vsites,
        num_molecules=m,
        num_constraints=3 * m,
    )
    if neighbors:
        from ..ops.neighbors import make_neighbor_spec

        system = system.with_neighbors(make_neighbor_spec(
            np.full(3, box_l), n, r_cut, skin=skin,
            exclusions=nb_kwargs["exclusions"],
            occupancy_floor_from=x.cpu().numpy(), device=device))
    return system, x, box


# --- SWM4-NDP polarizable 5-site water (a Drude oscillator) ------------------

SWM4_Q_H = 0.557330
SWM4_Q_M = -1.114660
SWM4_Q_D = -1.71636           # negative Drude particle ("NDP")
SWM4_ALPHA_O = 9.7825e-4      # nm^3 (0.97825 A^3)
SWM4_SIGMA_O = 0.318395       # nm  (R_min/2 = 1.78693 A)
SWM4_EPSILON_O = 0.88257      # kJ/mol (0.21094 kcal/mol)
SWM4_R_OH = 0.09572           # nm
SWM4_THETA = 104.52 * np.pi / 180.0
SWM4_D_OM = 0.024034          # nm, O -> M along the HOH bisector
SWM4_DRUDE_MASS = 0.4         # amu, debited from O (extended Lagrangian)


def swm4_water_system(
    n_molecules: int = 64,
    method: str = "cutoff",
    r_cut: float = 0.9,
    r_switch: float = 0.8,
    drude_mass: float = SWM4_DRUDE_MASS,
    seed: int = 0,
    dtype=None,
    neighbors: bool = False,
    skin: float = 0.1,
    device=None,
):
    """SWM4-NDP polarizable water (Lamoureux et al., CPL 418, 245 (2006))
    on `device` (default: the CUDA card) in `dtype`: 5 sites per molecule,
    the O core (+1.71636 e, LJ), its Drude satellite (-1.71636 e on a
    k = ONE_4PI_EPS0 q_D^2 / alpha spring, alpha = 0.97825 A^3), two H,
    and the massless M site on the HOH bisector as a virtual site. SETTLE
    holds (O, H1, H2); every Drude starts exactly on its core.

    drude_mass > 0 (default 0.4 amu, debited from O) suits the
    extended-Lagrangian DrudeLangevinIntegrator; drude_mass = 0 makes the
    Drude rows massless state for DrudeSCFIntegrator. Atom order per
    molecule: [O, D, H1, H2, M]. At production size pass neighbors=True
    (the dense path is O(N^2)). Returns (System, positions, box).

    >>> import torch
    >>> system, x, box = swm4_water_system(n_molecules=8, r_cut=0.3,
    ...     r_switch=0.25, dtype=torch.float64, device="cpu")
    >>> system.num_particles, system.virtual_sites.size, system.settle.size
    (40, 8, 8)
    >>> [f.name for f in system.forces]
    ['NonbondedForce', 'DrudeForce']
    """
    from ..ops.drude import make_drude_set
    from ..ops.settle import make_settle_set
    from ..ops.virtual_sites import VirtualSiteSet, place_virtual_sites

    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    m = n_molecules
    n = 5 * m
    box_l = (m / WATER_NUMBER_DENSITY) ** (1.0 / 3.0)
    if r_cut > 0.5 * box_l:
        raise InputError(f"r_cut {r_cut} > box/2 ({box_l/2:.3f})")
    r, th = SWM4_R_OH, SWM4_THETA
    mol = np.stack([
        np.zeros(3),                                     # O
        np.zeros(3),                                     # D rides on O
        [r * np.sin(th / 2), r * np.cos(th / 2), 0.0],   # H1
        [-r * np.sin(th / 2), r * np.cos(th / 2), 0.0],  # H2
        np.zeros(3),                                     # M: placed below
    ])
    x = _lattice(m, box_l, mol, seed)

    o = 5 * np.arange(m)
    excl_pairs = np.concatenate([np.stack([o + a, o + b], 1)
                                 for a in range(5) for b in range(a + 1, 5)])
    nb_kwargs = _rigid_nonbonded(
        n, m, excl_pairs, [-SWM4_Q_D, SWM4_Q_D, SWM4_Q_H, SWM4_Q_H, SWM4_Q_M],
        [SWM4_SIGMA_O, 1.0, 1.0, 1.0, 1.0],
        [SWM4_EPSILON_O, 0.0, 0.0, 0.0, 0.0], method, r_cut, r_switch, box_l,
        dtype, device)
    masses = torch.as_tensor(
        np.tile([MASS_O - drude_mass, drude_mass, MASS_H, MASS_H, 0.0], m),
        dtype=dtype, device=device)
    d_hh = 2.0 * r * np.sin(th / 2.0)
    sset = make_settle_set(np.stack([o, o + 2, o + 3], 1), r, d_hh, masses)
    c = SWM4_D_OM / (2.0 * r * np.cos(th / 2.0))
    vsites = VirtualSiteSet(
        sites=torch.as_tensor(o + 4, device=device),
        parents=torch.as_tensor(np.stack([o, o + 2, o + 3], 1), device=device),
        weights=torch.as_tensor(np.tile([1.0 - 2 * c, c, c], (m, 1)),
                                dtype=dtype, device=device),
        oop=torch.zeros((m,), dtype=dtype, device=device),
    )
    x = place_virtual_sites(vsites, torch.as_tensor(x, dtype=dtype,
                                                    device=device))
    drude = make_drude_set(np.stack([o + 1, o], 1), np.full(m, SWM4_Q_D),
                           np.full(m, SWM4_ALPHA_O), dtype=dtype,
                           device=device)
    box = torch.full((3,), box_l, dtype=dtype, device=device)
    system = System(
        masses=masses,
        forces=(NonbondedForce(**nb_kwargs), DrudeForce(drude=drude)),
        molecule=torch.as_tensor(np.repeat(np.arange(m), 5),
                                 dtype=torch.int32, device=device),
        default_box=box,
        settle=sset,
        virtual_sites=vsites,
        num_molecules=m,
        num_constraints=3 * m,
    )
    if neighbors:
        from ..ops.neighbors import make_neighbor_spec

        system = system.with_neighbors(make_neighbor_spec(
            np.full(3, box_l), n, r_cut, skin=skin,
            exclusions=nb_kwargs["exclusions"],
            occupancy_floor_from=x.cpu().numpy(), device=device))
    return system, x, box
