"""emim/BF4 ionic liquid (counterpart of atomsmm_tpu/models/ionic_liquid.py).

A united-atom emim+ cation (8 sites: imidazolium ring N1-C2-N3-C4-C5,
methyl on N3, ethyl C7-C8 on N1) and a BF4- anion (5 sites) with approximate
OPLS/Canongia-Lopes-scale parameters: a charged multi-species liquid for
PME + SIN(R), not a model of experimental observables. The topology and the
lattice are numpy with the same RandomState draws as the JAX package's
builder, so the same seed gives the same system.
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
from .phenol import _pairs_within

# united-atom types: (sigma nm, epsilon kJ/mol, mass amu)
TYPES = {
    "N": (0.325, 0.711, 14.007),
    "CR": (0.355, 0.293, 13.019),  # ring CH (united)
    "CT": (0.350, 0.276, 15.035),  # alkyl CH3/CH2 (united)
    "B": (0.358, 0.398, 10.811),
    "F": (0.312, 0.255, 18.998),
}

# emim+ sites: N1, C2, N3, C4, C5 (ring), C6 (methyl on N3), C7, C8 (ethyl on N1)
EMIM_TYPES = ["N", "CR", "N", "CR", "CR", "CT", "CT", "CT"]
EMIM_CHARGES = np.array([0.15, 0.21, 0.15, 0.08, 0.08, 0.11, 0.13, 0.09])
# sums to +1.0
EMIM_BONDS = [
    (0, 1, 0.134, 400000.0), (1, 2, 0.134, 400000.0),
    (2, 3, 0.138, 380000.0), (3, 4, 0.136, 430000.0), (4, 0, 0.138, 380000.0),
    (2, 5, 0.147, 280000.0), (0, 6, 0.148, 280000.0), (6, 7, 0.153, 260000.0),
]
BF4_TYPES = ["B", "F", "F", "F", "F"]
BF4_CHARGES = np.array([0.828, -0.457, -0.457, -0.457, -0.457])
# sums to -1.0
BF4_BOND = (0.139, 320000.0)  # B-F


def _emim_geometry():
    ring_r = 0.116  # 5-ring circumradius for ~0.136 bonds
    ang = np.pi / 2 + np.arange(5) * 2 * np.pi / 5
    ring = np.stack([ring_r * np.cos(ang), ring_r * np.sin(ang), np.zeros(5)], 1)
    c6 = ring[2] + (ring[2] / np.linalg.norm(ring[2])) * 0.147
    c7 = ring[0] + (ring[0] / np.linalg.norm(ring[0])) * 0.148
    c8 = c7 + np.array([0.09, 0.12, 0.02])
    return np.concatenate([ring, [c6], [c7], [c8]])


def _bf4_geometry():
    d = 0.139
    t = d / np.sqrt(3.0)
    return np.array(
        [[0, 0, 0], [t, t, t], [t, -t, -t], [-t, t, -t], [-t, -t, t]]
    )


def _random_rotation(rs):
    q = rs.normal(size=4)
    q /= np.linalg.norm(q)
    w, xq, yq, zq = q
    return np.array([
        [1 - 2 * (yq**2 + zq**2), 2 * (xq * yq - w * zq), 2 * (xq * zq + w * yq)],
        [2 * (xq * yq + w * zq), 1 - 2 * (xq**2 + zq**2), 2 * (yq * zq - w * xq)],
        [2 * (xq * zq - w * yq), 2 * (yq * zq + w * xq), 1 - 2 * (xq**2 + yq**2)],
    ])


def ionic_liquid_system(
    n_pairs: int = 50,
    r_cut: float = 0.9,
    r_switch: float = 0.8,
    method: str = "pme",
    number_density_pairs: float = 3.33,  # ion pairs / nm^3 (~emimBF4 density)
    seed: int = 0,
    dtype=None,
    neighbors: bool = False,
    device=None,
):
    """Build (System, positions, box): n_pairs of emim+ / BF4- on an
    interleaved lattice with random orientations, on `device` (default: the
    CUDA card; without one pass device="cpu") in `dtype` (default: torch's
    default dtype).

    Atom order: 8 cation sites then 5 anion sites per ion pair; every force
    in group 0 (use systems.RESPASystem to split). Pairs within three bonds
    are excluded from the nonbonded force; the 1-4 pairs come back through a
    NonbondedExceptionsForce at half strength. Under method 'pme' the Ewald
    alpha, grid and spline order come from ops.pme.choose_pme_parameters.
    """
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    rs = np.random.RandomState(seed)
    box_l = (n_pairs / number_density_pairs) ** (1.0 / 3.0)
    if r_cut > 0.5 * box_l:
        raise InputError(
            f"r_cut {r_cut} > box/2 ({box_l/2:.3f}); need more ion pairs"
        )

    n_cat, n_an = 8, 5
    n_per_pair = n_cat + n_an
    n = n_pairs * n_per_pair

    # lattice of 2*n_pairs sites, alternating cation/anion
    n_side = int(np.ceil((2 * n_pairs) ** (1 / 3)))
    spacing = box_l / n_side
    grid = (np.arange(n_side) + 0.5) * spacing
    centers = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), -1)
    centers = centers.reshape(-1, 3)[: 2 * n_pairs]

    xs = []
    g_cat, g_an = _emim_geometry(), _bf4_geometry()
    for p in range(n_pairs):
        xs.append(centers[2 * p] + g_cat @ _random_rotation(rs).T)
        xs.append(centers[2 * p + 1] + g_an @ _random_rotation(rs).T)
    x = np.concatenate(xs)

    charge = np.concatenate(
        [np.concatenate([EMIM_CHARGES, BF4_CHARGES])] * n_pairs
    )
    types = (EMIM_TYPES + BF4_TYPES) * n_pairs
    sigma = np.array([TYPES[t][0] for t in types])
    epsilon = np.array([TYPES[t][1] for t in types])
    masses = np.array([TYPES[t][2] for t in types])

    bonds, angles, torsions = [], [], []
    for p in range(n_pairs):
        off_c = p * n_per_pair
        off_a = off_c + n_cat
        for i, j, r0, k in EMIM_BONDS:
            bonds.append((off_c + i, off_c + j, r0, k))
        for f in range(1, 5):
            bonds.append((off_a, off_a + f, *BF4_BOND))
        # ring torsions for planarity
        ring = [off_c + i for i in range(5)]
        for i in range(5):
            torsions.append(
                (ring[i - 1], ring[i], ring[(i + 1) % 5], ring[(i + 2) % 5],
                 2, np.pi, 25.0)
            )
        # ethyl rotation barrier: C5(ring)-N1-C7-C8
        torsions.append((off_c + 4, off_c + 0, off_c + 6, off_c + 7, 3, 0.0, 1.0))

    # angles from the bond graph, per molecule
    adj = collections.defaultdict(list)
    for i, j, *_ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    for j in sorted(adj):
        nbrs = sorted(adj[j])
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                mol_site = j % n_per_pair
                if mol_site >= n_cat:  # anion: tetrahedral F-B-F
                    theta0, k = np.deg2rad(109.47), 600.0
                elif mol_site < 5:
                    theta0, k = np.deg2rad(108.0), 500.0
                else:
                    theta0, k = np.deg2rad(112.0), 450.0
                angles.append((nbrs[a], j, nbrs[b], theta0, k))

    # exclusions 1-2/1-3/1-4 per molecule (1-4 via exceptions, 0.5 fudge)
    dist_c = _pairs_within(EMIM_BONDS, n_cat, 3)
    dist_a = _pairs_within([(0, f) for f in range(1, 5)], n_an, 3)
    excl_pairs, pairs14 = [], []
    for p in range(n_pairs):
        off_c = p * n_per_pair
        off_a = off_c + n_cat
        for (i, j), d in dist_c.items():
            excl_pairs.append((off_c + i, off_c + j))
            if d == 3:
                pairs14.append((off_c + i, off_c + j))
        for (i, j), d in dist_a.items():
            excl_pairs.append((off_a + i, off_a + j))
    exclusions = make_exclusions_array(n, excl_pairs, device=device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    nb_kwargs = dict(
        group=0,
        charge=t(charge),
        sigma=t(sigma),
        epsilon=t(epsilon),
        exclusions=exclusions,
        r_cut=float(r_cut),
        r_switch=float(r_switch),
        eps_rf=1e15,
        method=method,
        use_switch=True,
    )
    if method == "pme":
        from ..ops.pme import choose_pme_parameters

        alpha, grid_shape, order = choose_pme_parameters(
            r_cut, np.full(3, box_l))
        nb_kwargs.update(ewald_alpha=float(alpha),
                         grid_shape=tuple(grid_shape), spline_order=order)

    forces = [NonbondedForce(**nb_kwargs)]
    forces.append(HarmonicBondForce(
        group=0, idx=t([(i, j) for i, j, *_ in bonds], torch.int32),
        r0=t([r0 for *_q, r0, _k in bonds]),
        k=t([k for *_q, _r0, k in bonds]),
    ))
    forces.append(HarmonicAngleForce(
        group=0, idx=t([(i, j, k) for i, j, k, *_ in angles], torch.int32),
        theta0=t([th for *_q, th, _k in angles]),
        k=t([k for *_q, _t, k in angles]),
    ))
    forces.append(PeriodicTorsionForce(
        group=0,
        idx=t([(i, j, k, l) for i, j, k, l, *_ in torsions], torch.int32),
        periodicity=t([nn for *_q, nn, _p, _k in torsions]),
        phase=t([p_ for *_q, _n, p_, _k in torsions]),
        k=t([k for *_q, _n, _p, k in torsions]),
    ))
    if pairs14:
        p14 = np.array(pairs14, np.int32)
        forces.append(NonbondedExceptionsForce(
            group=0, pairs=t(p14, torch.int32),
            chargeprod=t(0.5 * charge[p14[:, 0]] * charge[p14[:, 1]]),
            sigma=t(0.5 * (sigma[p14[:, 0]] + sigma[p14[:, 1]])),
            epsilon=t(0.5 * np.sqrt(epsilon[p14[:, 0]] * epsilon[p14[:, 1]])),
            valid=t(np.ones(len(p14), bool), torch.bool),
        ))

    molecule = np.concatenate([
        np.concatenate([np.full(n_cat, 2 * p), np.full(n_an, 2 * p + 1)])
        for p in range(n_pairs)
    ])
    box = t(np.full(3, box_l))
    system = System(
        masses=t(masses),
        forces=tuple(forces),
        molecule=t(molecule, torch.int32),
        default_box=box,
        num_molecules=2 * n_pairs,
    )
    if neighbors:
        from ..ops.neighbors import make_neighbor_spec

        system = system.with_neighbors(
            make_neighbor_spec(np.full(3, box_l), n, r_cut,
                               exclusions=exclusions, occupancy_floor_from=x,
                               device=device)
        )
    return system, t(x), box
