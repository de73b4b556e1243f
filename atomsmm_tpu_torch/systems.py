"""System transformations (counterpart of atomsmm_tpu/systems.py).

  RESPASystem — atomsmm/systems.py::RESPASystem: split the nonbonded force
                into near (group 1) / far (group 2), bonded terms in group 0,
                and under PME optionally the reciprocal sum (group 3), for
                r-RESPA integration.

>>> import torch
>>> from atomsmm_tpu_torch.models import water_system
>>> from atomsmm_tpu_torch.potential import potential_energy
>>> system, x, box = water_system(n_molecules=27, r_cut=0.45, r_switch=0.35,
...                               dtype=torch.float64, device="cpu")
>>> respa = RESPASystem(system, rcut_in=0.3, rswitch_in=0.25)
>>> sorted({f.group for f in respa.forces})      # bonded / near / far
[0, 1, 2]
>>> e_full = potential_energy(system, x, box)
>>> e_split = potential_energy(respa, x, box)    # near + far == full
>>> bool(abs(e_split - e_full) < 1e-9 * abs(e_full))
True
"""
from __future__ import annotations

import numpy as np

from .forces import (
    FarNonbondedForce,
    NearNonbondedForce,
    NonbondedExceptionsForce,
    PMEReciprocalForce,
)
from .system import System
from .utils import find_nonbonded_force, replace


def RESPASystem(
    system: System,
    rcut_in,
    rswitch_in,
    fast_exceptions: bool = True,
    near_grid: bool = True,
    reciprocal_level: bool = False,
) -> System:
    """Split for r-RESPA:

      group 0 — bonded forces (+ 1-4 exceptions when fast_exceptions;
                else they join the near force in group 1)
      group 1 — NearNonbondedForce: shifted-force LJ + Coulomb, switched over
                [rswitch_in, rcut_in], on its own finer cell grid ('near')
                when the system has a neighbor spec and near_grid is set
      group 2 — FarNonbondedForce: the full nonbonded force plus the negated
                near force, fused into one pass (near + far == full).
      group 3 — (reciprocal_level=True, PME only) PMEReciprocalForce: the
                reciprocal sum as its own slowest level; pass a 4-entry
                loops list to MultipleTimeScaleIntegrator.

    The near force's Coulomb damping follows the full force: the Ewald
    alpha under PME, else undamped.
    """
    idx = find_nonbonded_force(system)
    nb = system.forces[idx]
    alpha = float(nb.ewald_alpha) if nb.method == "pme" else 0.0

    new_forces = []
    for i, f in enumerate(system.forces):
        if i == idx:
            continue
        if isinstance(f, NonbondedExceptionsForce):
            new_forces.append(replace(f, group=0 if fast_exceptions else 1))
        else:
            new_forces.append(replace(f, group=0))
    near = NearNonbondedForce(
        group=1,
        charge=nb.charge,
        sigma=nb.sigma,
        epsilon=nb.epsilon,
        exclusions=nb.exclusions,
        r_cut=float(rcut_in),
        r_switch=float(rswitch_in),
        alpha=alpha,
        subtract=False,
        chunk=nb.chunk,
    )
    split_recip = bool(reciprocal_level) and nb.method == "pme"
    far = FarNonbondedForce(
        group=2,
        full=replace(nb, group=2),
        minus_near=replace(near, subtract=True, group=2),
        include_reciprocal=not split_recip,
    )
    new_forces += [near, far]
    if split_recip:
        new_forces.append(PMEReciprocalForce(
            group=3, charge=nb.charge, ewald_alpha=float(nb.ewald_alpha),
            grid_shape=nb.grid_shape, spline_order=nb.spline_order))
    out = system.replace_forces(new_forces)
    if near_grid and system.neighbors is not None:
        # the near force integrates most often: give it its own finer cell
        # grid; min_skin 0.09 keeps ~0.1 nm of skin (atomsmm_tpu/systems.py)
        from .ops.neighbors import make_neighbor_spec

        near_spec = make_neighbor_spec(
            np.asarray(system.default_box.detach().cpu()),
            system.num_particles,
            float(rcut_in),
            min_skin=0.09,
            exclusions=nb.exclusions,
            device=nb.charge.device,
        )
        out = out.with_neighbors(system.neighbors, near=near_spec)
        out = out.replace_forces(
            replace(f, neighbor_key="near")
            if isinstance(f, NearNonbondedForce) and not f.subtract else f
            for f in out.forces
        )
    return out
