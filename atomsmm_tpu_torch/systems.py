"""System transformations (counterpart of atomsmm_tpu/systems.py).

  RESPASystem — atomsmm/systems.py::RESPASystem: split the nonbonded force
                into near (group 1) / far (group 2), bonded terms in group 0,
                and under PME optionally the reciprocal sum (group 3), for
                r-RESPA integration.
  SolvationSystem — atomsmm/systems.py::SolvationSystem: solute-solvent vdW
                becomes softcore scaled by lambda_vdw; solute charges scale
                with lambda_coul (solvation free energies).
  AlchemicalRespaSystem — both transformations combined, the softcore
                force in the near group.

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

>>> solv = SolvationSystem(system, solute_atoms=torch.arange(3))
>>> e_on = potential_energy(solv, x, box,
...                         {"lambda_vdw": 1.0, "lambda_coul": 1.0})
>>> bool(abs(e_on - e_full) < 1e-9 * abs(e_full))  # identity at lambda = 1
True
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .forces import (
    FarNonbondedForce,
    NearNonbondedForce,
    NonbondedExceptionsForce,
    NonbondedForce,
    PMEReciprocalForce,
    SoftcoreLennardJonesForce,
)
from .system import System
from .utils import InputError, find_nonbonded_force, replace


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
                near force, fused into one pass (near + far == full); under
                a charge-scale mask the full force keeps the mask, the near
                force takes the raw charges, and the far force runs in two
                sweeps.
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
            group=3, charge=nb.charge,
            charge_scale_mask=nb.charge_scale_mask,
            ewald_alpha=float(nb.ewald_alpha), grid_shape=nb.grid_shape,
            spline_order=nb.spline_order,
            charge_scale_name=nb.charge_scale_name))
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


def SolvationSystem(
    system: System,
    solute_atoms,
    lambda_vdw_name: str = "lambda_vdw",
    lambda_coul_name: str = "lambda_coul",
) -> System:
    """Alchemical decoupling of a solute (atomsmm/systems.py::SolvationSystem):

      * the solute's epsilon in the original nonbonded force is zeroed
        (removing solute-solvent and solute-solute vdW from it);
      * solute-solvent vdW returns as Beutler softcore scaled by
        `lambda_vdw` (SoftcoreLennardJonesForce, the interaction-group cross
        mask);
      * solute-solute vdW returns unscaled (intramolecular interactions
        must not change along the path) through a second NonbondedForce with
        zero charges and the solute's epsilon alone, so that it runs on the
        pair kernels; the JAX package uses a CustomNonbondedForce there;
      * solute charges in the original force scale with `lambda_coul` (the
        charge-scale mask; solute-solute Coulomb therefore scales as
        lambda_coul², as in the reference).

    At lambda_vdw = lambda_coul = 1 the transformed system reproduces the
    original. NBFIX tables are not ported, so no system here carries one.
    """
    idx = find_nonbonded_force(system)
    nb = system.forces[idx]
    if getattr(nb, "pair_sigma", None) is not None:
        raise InputError(
            "SolvationSystem does not support NBFIX per-pair LJ tables: the "
            "softcore decoupling path combines per-particle (sigma, epsilon) "
            "with Lorentz-Berthelot")
    n = nb.charge.shape[0]
    solute = torch.zeros((n,), dtype=nb.charge.dtype, device=nb.charge.device)
    solute[torch.as_tensor(solute_atoms, device=solute.device).long()] = 1.0

    softcore = SoftcoreLennardJonesForce(
        group=nb.group,
        sigma=nb.sigma,
        epsilon=nb.epsilon,
        solute=solute,
        exclusions=nb.exclusions,
        r_cut=nb.r_cut,
        r_switch=nb.r_switch,
        use_switch=nb.use_switch,
        lambda_name=lambda_vdw_name,
        chunk=nb.chunk,
    )
    # solute-solute LJ as a built-in form on the pair kernels: zero
    # charges and the epsilon column epsilon * solute, whose combined
    # sqrt(eps_i s_i eps_j s_j) is the solute-solute pair's epsilon and zero
    # for every other pair (the JAX package's CustomNonbondedForce)
    solute_solute = NonbondedForce(
        group=nb.group,
        charge=torch.zeros_like(nb.charge),
        sigma=nb.sigma,
        epsilon=nb.epsilon * solute,
        exclusions=nb.exclusions,
        r_cut=nb.r_cut,
        r_switch=nb.r_switch,
        method="cutoff" if math.isfinite(nb.r_cut) else "nocutoff",
        use_switch=nb.use_switch,
        chunk=nb.chunk,
    )
    scaled_nb = replace(
        nb,
        epsilon=nb.epsilon * (1.0 - solute),
        charge_scale_mask=solute,
        charge_scale_name=lambda_coul_name,
    )
    new_forces = [scaled_nb if i == idx else f
                  for i, f in enumerate(system.forces)]
    new_forces += [softcore, solute_solute]
    return system.replace_forces(new_forces)


def AlchemicalRespaSystem(system: System, rcut_in, rswitch_in, solute_atoms,
                          **kwargs) -> System:
    """Softcore alchemy + RESPA split
    (atomsmm/systems.py::AlchemicalRespaSystem): SolvationSystem, then
    RESPASystem, then the softcore force moves to group 1 (it is
    short-ranged), so that lambda sweeps re-use the far force. The near
    force takes the raw charges and the far force's full half the scaled
    ones, so near + far == full at every lambda."""
    solvated = SolvationSystem(system, solute_atoms, **kwargs)
    respa = RESPASystem(solvated, rcut_in, rswitch_in)
    return respa.replace_forces(
        replace(f, group=1) if isinstance(f, SoftcoreLennardJonesForce) else f
        for f in respa.forces)
