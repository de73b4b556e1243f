"""Phenol in water (counterpart of atomsmm_tpu/models/phenol.py) — BASELINE
config 3, the alchemical solvation free energy.

The solute is built programmatically with OPLS-like parameters (C6H5OH, 13
atoms, neutral), as in the JAX package: the alchemy tests check machinery
and self-consistency, not experimental solvation free energies. Every pair
within three bonds is excluded from the nonbonded force; the 1-4 pairs
return as scaled exceptions (0.5/0.5 OPLS fudge factors) in a
NonbondedExceptionsForce, so that they can integrate at the innermost RESPA
level. The waters are q-SPC/Fw (models/water.py), placed with the same
numpy RandomState layout as the JAX package, so one seed gives the same
positions in both packages.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..forces import (
    HarmonicAngleForce,
    HarmonicBondForce,
    NonbondedExceptionsForce,
    NonbondedForce,
    PeriodicTorsionForce,
)
from ..system import System, make_exclusions_array
from ..utils import InputError, resolve_device
from .water import (
    ANGLE_K,
    ANGLE_T0,
    BOND_K,
    BOND_R0,
    EPSILON_O,
    MASS_H,
    MASS_O,
    Q_H,
    Q_O,
    SIGMA_O,
    WATER_NUMBER_DENSITY,
    water_positions,
)

# OPLS-like atom types (sigma nm, epsilon kJ/mol, mass amu)
CA = dict(sigma=0.355, epsilon=0.29288, mass=12.011)
HA = dict(sigma=0.242, epsilon=0.12552, mass=1.008)
OH = dict(sigma=0.312, epsilon=0.71128, mass=15.9994)
HO = dict(sigma=0.1, epsilon=0.0, mass=1.008)

N_SOLUTE = 13


def phenol_geometry():
    """(13, 3) coordinates [nm]: ring C0..C5 (C0 carries the OH), ring H on
    C1..C5, then O, then the hydroxyl H. Planar idealized geometry."""
    ring_r = 0.140  # hexagon circumradius == C-C bond length
    ang = np.arange(6) * np.pi / 3.0
    c = np.stack([ring_r * np.cos(ang), ring_r * np.sin(ang), np.zeros(6)], 1)
    h = np.stack([(ring_r + 0.108) * np.cos(ang),
                  (ring_r + 0.108) * np.sin(ang), np.zeros(6)], 1)[1:]
    o = np.array([[ring_r + 0.1364, 0.0, 0.0]])
    ho = o + np.array([[0.0945 * np.cos(1.9), 0.0945 * np.sin(1.9), 0.0]])
    return np.concatenate([c, h, o, ho])


def phenol_topology():
    """(bonds, angles, torsions, charges, sigma, epsilon, masses) of the 13
    atoms: 0-5 ring C (0 carries the OH), 6-10 ring H on C1..C5, 11 O,
    12 H."""
    charges = np.array([0.15, -0.115, -0.115, -0.115, -0.115, -0.115]
                       + [0.115] * 5 + [-0.585, 0.435])
    types = [CA] * 6 + [HA] * 5 + [OH, HO]
    sigma = np.array([t["sigma"] for t in types])
    epsilon = np.array([t["epsilon"] for t in types])
    masses = np.array([t["mass"] for t in types])

    bonds = [(i, (i + 1) % 6, 0.140, 392459.2) for i in range(6)]  # ring C-C
    bonds += [(c, 6 + k, 0.108, 307105.6) for k, c in enumerate(range(1, 6))]
    bonds.append((0, 11, 0.1364, 376560.0))  # C-O
    bonds.append((11, 12, 0.0945, 462750.4))  # O-H

    # angles from the bond graph: every i-j-k with i < k around a center j
    adj = [[] for _ in range(N_SOLUTE)]
    for i, j, *_ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    angles = []
    for j in range(N_SOLUTE):
        nb = sorted(adj[j])
        for a in range(len(nb)):
            for b in range(a + 1, len(nb)):
                theta0 = np.deg2rad(120.0 if j < 6 else 109.5)
                angles.append((nb[a], j, nb[b], theta0, 527.184))

    # ring torsions keep the ring planar (n = 2, phase pi), and C-C-O-H
    torsions = [((i - 1) % 6, i, (i + 1) % 6, (i + 2) % 6, 2, np.pi, 30.334)
                for i in range(6)]
    torsions.append((1, 0, 11, 12, 2, np.pi, 3.0))
    return bonds, angles, torsions, charges, sigma, epsilon, masses


def _pairs_within(bonds, n, max_dist):
    """{(i, j): graph distance} for every pair i < j of the n atoms that
    lies 1..max_dist bonds apart (breadth-first search per atom); `bonds`
    holds (i, j, ...) tuples."""
    adj = [[] for _ in range(n)]
    for i, j, *_ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    dist = {}
    for s in range(n):
        seen = {s: 0}
        dq = collections.deque([s])
        while dq:
            u = dq.popleft()
            if seen[u] >= max_dist:
                continue
            for v in adj[u]:
                if v not in seen:
                    seen[v] = seen[u] + 1
                    dq.append(v)
        for u, d in seen.items():
            if s < u:
                dist[(s, u)] = d
    return dist


def phenol_in_water(
    n_water: int = 500,
    r_cut: float = 0.75,
    r_switch: float = 0.65,
    method: str = "cutoff",
    seed: int = 0,
    dtype=None,
    neighbors: bool = False,
    skin: float = 0.1,
    device=None,
):
    """(System, positions, box, solute_atoms): one phenol at the center of a
    box of n_water q-SPC/Fw waters, minus the waters whose oxygen lies
    within 0.35 nm of a solute atom, on `device` (default: the CUDA card;
    without one pass device="cpu") in `dtype` (default: torch's default
    dtype). Every force in group 0; neighbors=True attaches a cell-list
    spec for r_cut."""
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    bonds, angles, torsions, q_s, sig_s, eps_s, m_s = phenol_topology()
    n_s = N_SOLUTE

    box_l = ((n_water + 5) / WATER_NUMBER_DENSITY) ** (1.0 / 3.0)
    if r_cut > 0.5 * box_l:
        raise InputError(f"r_cut {r_cut} > box/2 ({box_l / 2:.3f})")
    x_solute = phenol_geometry() + box_l / 2.0  # centered

    xw = water_positions(n_water, box_l, seed).reshape(-1, 3, 3)
    keep = [w for w in range(xw.shape[0])
            if np.linalg.norm(xw[w, 0] - x_solute, axis=1).min() > 0.35]
    xw = xw[keep]
    n_w = xw.shape[0]
    n = n_s + 3 * n_w
    x = np.concatenate([x_solute, xw.reshape(-1, 3)])

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    charge = np.concatenate([q_s, np.tile([Q_O, Q_H, Q_H], n_w)])
    sigma = np.concatenate([sig_s, np.tile([SIGMA_O, 1.0, 1.0], n_w)])
    epsilon = np.concatenate([eps_s, np.tile([EPSILON_O, 0.0, 0.0], n_w)])
    masses = np.concatenate([m_s, np.tile([MASS_O, MASS_H, MASS_H], n_w)])

    # exclusions: the solute's pairs within three bonds (the 1-4 pairs come
    # back as exceptions) and each water's three intramolecular pairs
    dist = _pairs_within(bonds, n_s, 3)
    excl_pairs = [p for p, d in dist.items() if d <= 3]
    o = n_s + 3 * np.arange(n_w)
    excl_pairs += list(zip(o, o + 1)) + list(zip(o, o + 2)) \
        + list(zip(o + 1, o + 2))
    exclusions = make_exclusions_array(n, excl_pairs, device=device)

    nb_kwargs = dict(group=0, charge=t(charge), sigma=t(sigma),
                     epsilon=t(epsilon), exclusions=exclusions,
                     r_cut=float(r_cut), r_switch=float(r_switch),
                     eps_rf=1e15, method=method, use_switch=True)
    if method == "pme":
        from ..ops.pme import choose_pme_parameters

        alpha, grid, order = choose_pme_parameters(r_cut, np.full(3, box_l))
        nb_kwargs.update(ewald_alpha=float(alpha), grid_shape=tuple(grid),
                         spline_order=order)

    b = np.array([(i, j) for i, j, *_ in bonds], np.int32)
    wo = 3 * np.arange(n_w)
    bond_idx = np.concatenate([b, n_s + np.concatenate([
        np.stack([wo, wo + 1], 1), np.stack([wo, wo + 2], 1)])])
    bond_r0 = np.concatenate([[r0 for *_ij, r0, _k in bonds],
                              np.full(2 * n_w, BOND_R0)])
    bond_k = np.concatenate([[k for *_ij, _r0, k in bonds],
                             np.full(2 * n_w, BOND_K)])
    a = np.array([(i, j, k) for i, j, k, *_ in angles], np.int32)
    angle_idx = np.concatenate([a, np.stack([o + 1, o, o + 2], 1)])
    angle_t0 = np.concatenate([[th for *_ijk, th, _k in angles],
                               np.full(n_w, ANGLE_T0)])
    angle_k = np.concatenate([[k for *_ijk, _th, k in angles],
                              np.full(n_w, ANGLE_K)])
    tor = np.array([(i, j, k, l) for i, j, k, l, *_ in torsions], np.int32)
    t_n = np.array([nn for *_ijkl, nn, _p, _k in torsions])
    t_p = np.array([p for *_ijkl, _n, p, _k in torsions])
    t_k = np.array([k for *_ijkl, _n, _p, k in torsions])

    forces = [
        NonbondedForce(**nb_kwargs),
        HarmonicBondForce(group=0, idx=t(bond_idx, torch.int32),
                          r0=t(bond_r0), k=t(bond_k)),
        HarmonicAngleForce(group=0, idx=t(angle_idx, torch.int32),
                           theta0=t(angle_t0), k=t(angle_k)),
        PeriodicTorsionForce(group=0, idx=t(tor, torch.int32),
                             periodicity=t(t_n), phase=t(t_p), k=t(t_k)),
    ]
    pairs14 = [p for p, d in dist.items() if d == 3]
    if pairs14:  # 1-4 exceptions with the OPLS 0.5 fudge
        p14 = np.array(pairs14, np.int32)
        forces.append(NonbondedExceptionsForce(
            group=0, pairs=t(p14, torch.int32),
            chargeprod=t(0.5 * charge[p14[:, 0]] * charge[p14[:, 1]]),
            sigma=t(0.5 * (sigma[p14[:, 0]] + sigma[p14[:, 1]])),
            epsilon=t(0.5 * np.sqrt(epsilon[p14[:, 0]] * epsilon[p14[:, 1]])),
            valid=torch.ones(len(p14), dtype=torch.bool, device=device)))

    molecule = np.concatenate([np.zeros(n_s, np.int32),
                               1 + np.repeat(np.arange(n_w), 3)])
    box = t(np.full(3, box_l))
    system = System(masses=t(masses), forces=tuple(forces),
                    molecule=t(molecule, torch.int32), default_box=box,
                    num_molecules=1 + n_w)
    if neighbors:
        from ..ops.neighbors import make_neighbor_spec

        system = system.with_neighbors(make_neighbor_spec(
            np.full(3, box_l), n, r_cut, skin=skin, exclusions=exclusions,
            occupancy_floor_from=x, device=device))
    solute_atoms = torch.arange(n_s, dtype=torch.int32, device=device)
    return system, t(x), box, solute_atoms
