"""LJ argon fluid (counterpart of atomsmm_tpu/models/argon.py).

sigma = 0.3405 nm, epsilon/kB = 119.8 K, m = 39.948 amu; simple-cubic
lattice at reduced density rho* = N sigma^3/V, optionally jittered with the
same numpy RandomState draws as the JAX package's argon_system.
"""
from __future__ import annotations

import numpy as np
import torch

from ..forces import NonbondedForce
from ..system import System
from ..units import BOLTZMANN
from ..utils import InputError

ARGON_SIGMA = 0.3405  # nm
ARGON_EPSILON = 119.8 * BOLTZMANN  # kJ/mol
ARGON_MASS = 39.948  # amu


def argon_system(
    n: int = 4000,
    rho_star: float = 0.8,
    r_cut: float = 2.5 * ARGON_SIGMA,
    r_switch: float = 2.2 * ARGON_SIGMA,
    jitter: float = 0.0,
    seed: int = 0,
    dtype=None,
    chunk: int = 256,
    neighbors: bool = False,
    skin: float = 0.1,
    device=None,
):
    """Build (System, positions, box). No charges, no exclusions;
    neighbors=True attaches a NeighborSpec (the cell-list path)."""
    dtype = dtype or torch.get_default_dtype()
    volume = n * ARGON_SIGMA**3 / rho_star
    box_l = volume ** (1.0 / 3.0)
    if r_cut > 0.5 * box_l:
        raise InputError(
            f"r_cut={r_cut} exceeds half the box ({box_l:.3f}/2) — minimum "
            "image breaks; increase n or reduce the cutoff")
    n_side = int(np.ceil(n ** (1.0 / 3.0)))
    spacing = box_l / n_side
    grid = np.arange(n_side) * spacing
    xyz = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), axis=-1)
    x = xyz.reshape(-1, 3)[:n].astype(np.float64)
    if jitter > 0:
        rs = np.random.RandomState(seed)
        x = x + rs.uniform(-jitter, jitter, x.shape) * spacing

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    force = NonbondedForce(
        group=0,
        charge=t(np.zeros(n)),
        sigma=t(np.full(n, ARGON_SIGMA)),
        epsilon=t(np.full(n, ARGON_EPSILON)),
        exclusions=t(np.full((n, 1), -1), torch.int32),
        r_cut=float(r_cut),
        r_switch=float(r_switch),
        eps_rf=1e15,
        method="cutoff",
        use_switch=True,
        chunk=chunk,
    )
    box = t(np.full(3, box_l))
    system = System(
        masses=t(np.full(n, ARGON_MASS)),
        forces=(force,),
        molecule=t(np.arange(n), torch.int32),
        default_box=box,
        num_molecules=n,
    )
    if neighbors:
        from ..ops.neighbors import make_neighbor_spec

        system = system.with_neighbors(
            make_neighbor_spec(np.full(3, box_l), n, r_cut, skin=skin,
                               occupancy_floor_from=x, device=device))
    return system, t(x), box
