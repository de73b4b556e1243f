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
  HydrogenMassRepartitionedSystem — heavier hydrogens, lighter heavy
                partners, the same total mass (OpenMM's hydrogenMass=).
  ComputingSystem — every force in a group of its own, so that each term
                can be evaluated alone (PressureComputer, reporters).

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
    alpha under PME, else undamped; it takes the full force's NBFIX tables
    (not its 10-12 term), so that near + far == full holds on the table
    path too.
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
        lj_type=nb.lj_type,
        pair_sigma=nb.pair_sigma,
        pair_epsilon=nb.pair_epsilon,
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
        # grid (min_skin 0.09 keeps ~0.1 nm of skin) or, on block lists, its
        # own list at the near cutoff (atomsmm_tpu/systems.py)
        from .ops.blocks import BlockNeighborSpec, make_block_spec
        from .ops.neighbors import make_neighbor_spec

        box = np.asarray(system.default_box.detach().cpu())
        if isinstance(system.neighbors, BlockNeighborSpec):
            near_spec = make_block_spec(
                box, system.num_particles, float(rcut_in),
                exclusions=nb.exclusions,
                block_size=system.neighbors.block_size,
                device=nb.charge.device)
        else:
            near_spec = make_neighbor_spec(
                box, system.num_particles, float(rcut_in), min_skin=0.09,
                exclusions=nb.exclusions, device=nb.charge.device)
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
    original. A system with NBFIX tables is refused, as in the JAX
    package: the softcore force combines per-particle (sigma, epsilon).
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


# particles lighter than this (and not massless) are hydrogens [amu]
HMR_HYDROGEN_MASS = 1.5


def ComputingSystem(system: System) -> System:
    """Rewire so that each force can be evaluated on its own (the
    PressureComputer and ExtendedStateDataReporter): every force gets its
    own group, renumbered 0..F-1 in force order.

    >>> import torch
    >>> from atomsmm_tpu_torch.models import water_system
    >>> s, _, _ = water_system(n_molecules=8, r_cut=0.3, r_switch=0.25,
    ...                        device="cpu")
    >>> ComputingSystem(RESPASystem(s, 0.2, 0.15)).force_groups
    [0, 1, 2]
    """
    return system.replace_forces(
        replace(f, group=i) for i, f in enumerate(system.forces))


def HydrogenMassRepartitionedSystem(
    system: System,
    factor: float = 3.0,
    bonds=None,
    target_mass: float | None = None,
) -> System:
    """Hydrogen mass repartitioning (HMR): scale every hydrogen's mass by
    ``factor`` and remove the added mass from its bonded heavy partner
    (atomsmm_tpu/systems.py::HydrogenMassRepartitionedSystem, OpenMM's
    ``createSystem(hydrogenMass=...)``). Configurational averages do not
    depend on the masses, while the fastest H-X motions slow by about
    sqrt(factor): a 4 fs step becomes stable for rigid water.

    Connectivity comes from ``bonds`` ((P, 2)) when given, else from the
    system: the SETTLE triplets (A-B, A-C), the iterative constraint pairs
    and every ``HarmonicBondForce.idx``. (``TemplateBondedForce`` holds
    per-template local indices: pass ``bonds`` for such systems.)

    The SETTLE triangle (ra/rb/rc) is mass-weighted, so the SettleSet is
    rebuilt for the new masses from the target distances recovered from
    the old one (d_BC = 2 rc, d_AB = sqrt(rc^2 + (ra + rb)^2)).

    Hydrogens are particles with 0 < m < ``HMR_HYDROGEN_MASS`` (1.5 amu);
    massless particles (virtual sites) are never touched. Raises InputError when a
    hydrogen has no bonded heavy partner or a heavy atom's mass would go
    non-positive. ``target_mass`` sets every hydrogen to exactly that mass
    instead of multiplying, debiting the difference from its partner.

    >>> from atomsmm_tpu_torch.models import rigid_water_system
    >>> system, x, box = rigid_water_system(n_molecules=64, r_cut=0.55,
    ...     r_switch=0.5, dtype=torch.float64, device="cpu")
    >>> hmr = HydrogenMassRepartitionedSystem(system, factor=3.0)
    >>> bool(torch.allclose(hmr.masses[1::3], 3.0 * system.masses[1::3]))
    True
    >>> bool(abs(hmr.masses.sum() - system.masses.sum()) < 1e-9)
    True
    """
    from .forces import HarmonicBondForce
    from .ops.settle import make_settle_set

    if target_mass is not None:
        if target_mass <= 0:
            raise InputError(
                f"HMR target_mass must be positive, got {target_mass}")
    elif factor <= 0:
        raise InputError(f"HMR factor must be positive, got {factor}")
    masses = system.masses.detach().cpu().numpy().astype(np.float64)
    n = masses.shape[0]

    conn = []
    if bonds is not None:
        conn.append(np.asarray(bonds, np.int64).reshape(-1, 2))
    else:
        if system.settle is not None and system.settle.size:
            t = system.settle.triplets.cpu().numpy()
            conn.append(np.stack([t[:, 0], t[:, 1]], 1))
            conn.append(np.stack([t[:, 0], t[:, 2]], 1))
        if system.constraints is not None and system.constraints.size:
            conn.append(system.constraints.pairs.cpu().numpy())
        for f in system.forces:
            if isinstance(f, HarmonicBondForce) and f.idx is not None:
                conn.append(f.idx.cpu().numpy().astype(np.int64))
    if not conn:
        raise InputError(
            "HMR needs connectivity: no SETTLE/constraints/HarmonicBondForce "
            "found and no explicit bonds given")
    pairs = np.concatenate(conn, 0)

    is_h = (masses > 0) & (masses < HMR_HYDROGEN_MASS)
    heavy_of = np.full(n, -1, np.int64)
    for a, b in np.concatenate([pairs, pairs[:, ::-1]], 0):
        if is_h[a] and not is_h[b] and masses[b] > 0 and heavy_of[a] < 0:
            heavy_of[a] = b
    hs = np.where(is_h)[0]
    orphan = hs[heavy_of[hs] < 0]
    if orphan.size:
        raise InputError(
            f"HMR: hydrogens {orphan[:5].tolist()}... have no bonded heavy "
            "partner (H-H constraint pairs do not count; pass bonds=)")
    new = masses.copy()
    if target_mass is not None:
        delta = target_mass - masses[hs]
    else:
        delta = (factor - 1.0) * masses[hs]
    new[hs] += delta
    np.subtract.at(new, heavy_of[hs], delta)
    bad = np.where((masses > 0) & ~is_h & (new <= 0))[0]
    if bad.size:
        what = (f"target_mass {target_mass}" if target_mass is not None
                else f"factor {factor}")
        raise InputError(
            f"HMR {what} drives heavy atoms {bad[:5].tolist()} to "
            f"non-positive mass (worst: {new[bad].min():.4f} amu)")

    new_masses = torch.as_tensor(new, dtype=system.masses.dtype,
                                 device=system.masses.device)
    settle = system.settle
    if settle is not None and settle.size:
        ra, rb, rc = (a.detach().cpu().numpy().astype(np.float64)
                      for a in (settle.ra, settle.rb, settle.rc))
        d_ab = np.sqrt(rc**2 + (ra + rb) ** 2)
        settle = make_settle_set(settle.triplets, d_ab, 2.0 * rc, new_masses,
                                 dtype=settle.ra.dtype,
                                 device=settle.ra.device)
    return replace(system, masses=new_masses, settle=settle)
