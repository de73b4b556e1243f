"""Rank bodies of tests/test_torch_parallel.py, run by gloo ranks on the CPU
that the test spawns (torch.multiprocessing). This module imports no JAX:
each rank only builds the port's systems, runs the sharded paths over a
1-D DeviceMesh and the same work on one process, and saves what it got
with torch.save; the test holds that against the JAX package.

    spawn(run, args=(world, store, out_dir, cases), nprocs=world)
"""
import os

import numpy as np
import torch

F64 = torch.float64
ARGON = dict(n=512, jitter=0.2, seed=5)
ARGON_STEPS, WATER_STEPS, PME_STEPS = 10, 8, 5
HREX_STATES = 4
SLAB_GRID, SLAB_BAD_GRID, SLAB_ALPHA, SLAB_ORDER = (16, 8, 15), (25, 16, 15), \
    3.0, 6
BOX_O = (2.0, 2.2, 1.9)
BOX_T = (2.2, 2.0, 2.4, 90.0, 105.0, 80.0)


def slab_inputs():
    """(q, x orthorhombic, x triclinic, box_o, box_t) as numpy, the draws
    of tests/test_parallel.py's slab case."""
    from atomsmm_tpu_torch.ops.pbc import triclinic_from_lengths_angles

    rs = np.random.RandomState(2)
    n = 64
    q = rs.uniform(-1, 1, n)
    q = q - q.mean()
    box_o = np.asarray(BOX_O)
    box_t = np.asarray(triclinic_from_lengths_angles(*BOX_T), np.float64)
    x_o = rs.uniform(0, 1, (n, 3)) * box_o
    x_t = rs.uniform(0, 1, (n, 3)) @ box_t
    return q, x_o, x_t, box_o, box_t


def case_sweep(mesh, d, rank):
    """Argon 512: the sharded sweep (form and pair function), its rows
    against the one-process K2 twin, the energy-only and virial forms."""
    from atomsmm_tpu_torch.forces import autograd_virial
    from atomsmm_tpu_torch.models import argon_system
    from atomsmm_tpu_torch.ops.neighbors import build_cell_buckets
    from atomsmm_tpu_torch.ops.pair_kernel import full_pair_rows
    from atomsmm_tpu_torch.parallel import spatial

    system, x, box = argon_system(neighbors=True, dtype=F64, device="cpu",
                                  **ARGON)
    spec = system.neighbors
    bucket, _ = build_cell_buckets(spec, x, box)
    force = system.forces[0]
    form, pp = force._pair_form({}), force._per_particle({})
    args = (x, box, pp, spec, bucket, force.r_cut, mesh)
    e, f = spatial.sharded_cell_pair_energy_forces(form, *args)
    rows = spatial.sharded_cell_pair_rows(form, *args)
    whole = full_pair_rows(form, x, box, pp, spec, bucket, force.r_cut)
    pair_fn = force._pair_fn({})
    e_fn, f_fn = spatial.sharded_cell_pair_energy_forces(pair_fn, *args)
    w, f_w = spatial.sharded_cell_pair_virial(form, *args)
    w_fn, _ = spatial.sharded_cell_pair_virial(pair_fn, *args)
    w_ref, _ = autograd_virial(lambda xx, bb: full_pair_rows(
        form, xx, bb, pp, spec, bucket, force.r_cut)[:, 3].sum(), x, box)
    c0, c1 = spatial.home_cells(bucket.shape[0], mesh)
    return {"e": e, "f": f, "rows_bitwise": bool(torch.equal(rows, whole)),
            "e_only": spatial.sharded_cell_pair_energy(form, *args),
            "e_fn": e_fn, "f_fn": f_fn, "w": w, "f_w": f_w, "w_fn": w_fn,
            "w_ref": w_ref, "range": (c0, c1), "ncells": spec.ncells}


def case_pme(mesh, d, rank):
    """64 waters: the atom-sharded reciprocal sum."""
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.parallel import sharded_pme_reciprocal_energy

    system, x, box = water_system(n_molecules=64, method="pme", r_cut=0.55,
                                  r_switch=0.45, dtype=F64, device="cpu")
    nb = system.forces[0]
    e, f = sharded_pme_reciprocal_energy(
        x, box, nb.charge, nb.ewald_alpha, nb.grid_shape, mesh,
        order=nb.spline_order)
    return {"e": e, "f": f}


def case_slab(mesh, d, rank):
    """The slab FFT on (16, 8, 15), orthorhombic and triclinic; the
    indivisible grid raises."""
    from atomsmm_tpu_torch.parallel import sharded_pme_reciprocal_energy_fft

    q, x_o, x_t, box_o, box_t = (torch.as_tensor(a) for a in slab_inputs())
    out = {}
    for tag, x, box in (("o", x_o, box_o), ("t", x_t, box_t)):
        out[tag] = sharded_pme_reciprocal_energy_fft(
            x, box, q, SLAB_ALPHA, SLAB_GRID, mesh, order=SLAB_ORDER)
    try:
        sharded_pme_reciprocal_energy_fft(
            x_o[:8], box_o, q[:8], SLAB_ALPHA, SLAB_BAD_GRID, mesh)
        out["bad"] = "no error"
    except ValueError as err:
        out["bad"] = str(err)
    return out


def _trajectory(system, integ, x, box, steps, mesh):
    """SpatialContext over the mesh from x at rest: x, v, box and PE after
    `steps`, and the reciprocal path the step took."""
    from atomsmm_tpu_torch import make_state
    from atomsmm_tpu_torch.forces import last_reciprocal_dispatch
    from atomsmm_tpu_torch.parallel import SpatialContext

    ctx = SpatialContext(system, integ, make_state(x, box=box, seed=0),
                         mesh=mesh)
    ctx.step(steps)
    dispatch = last_reciprocal_dispatch()
    return {"x": ctx.state.x, "v": ctx.state.v, "box": ctx.state.box,
            "pe": ctx.get_state().potential_energy, "dispatch": dispatch}


def case_argon_ctx(mesh, d, rank):
    from atomsmm_tpu_torch import VelocityVerletIntegrator
    from atomsmm_tpu_torch.models import argon_system

    system, x, box = argon_system(neighbors=True, dtype=F64, device="cpu",
                                  **ARGON)
    return _trajectory(system, VelocityVerletIntegrator(0.002), x, box,
                       ARGON_STEPS, mesh)


def case_water_ctx(mesh, d, rank):
    from atomsmm_tpu_torch import VelocityVerletIntegrator
    from atomsmm_tpu_torch.models import rigid_water_system
    from atomsmm_tpu_torch.ops.settle import settle_residual

    system, x, box = rigid_water_system(
        n_molecules=64, r_cut=0.5, r_switch=0.42, neighbors=True, seed=3,
        dtype=F64, device="cpu")
    out = _trajectory(system, VelocityVerletIntegrator(0.002), x, box,
                      WATER_STEPS, mesh)
    out["residual"] = float(settle_residual(system.settle, out["x"]))
    return out


def case_pme_ctx(mesh, d, rank):
    from atomsmm_tpu_torch import VelocityVerletIntegrator
    from atomsmm_tpu_torch.models import water_system

    system, x, box = water_system(n_molecules=40, method="pme", r_cut=0.5,
                                  r_switch=0.45, neighbors=True, dtype=F64,
                                  device="cpu")
    out = _trajectory(system, VelocityVerletIntegrator(0.001), x, box,
                      PME_STEPS, mesh)
    out["grid"] = system.forces[0].grid_shape
    return out


def case_npt_ctx(mesh, d, rank):
    """125 waters under the Monte Carlo barostat every 2 steps (the trial
    positions broadcast from the first rank), 10 VV steps from numpy
    velocities: SpatialContext against a one-process Context on the full
    stencil from the same state and seed."""
    import dataclasses

    import atomsmm_tpu_torch as tamm
    from atomsmm_tpu_torch.integrate import barostat as baro
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.parallel import SpatialContext
    from atomsmm_tpu_torch.utils import replace

    system, x, box = water_system(n_molecules=125, r_cut=0.5, r_switch=0.42,
                                  neighbors=True, dtype=F64, device="cpu")
    system = system.add_force(tamm.MonteCarloBarostat(
        pressure=1.0, temperature=300.0, frequency=2))
    m = system.masses.numpy()
    v = np.random.RandomState(9).normal(size=(m.size, 3)) * np.sqrt(
        tamm.units.BOLTZMANN * 300.0 / m)[:, None]
    out = {}
    full = replace(system, neighbors=dataclasses.replace(
        system.neighbors, half_stencil=False))
    vv = tamm.VelocityVerletIntegrator(0.001)
    for name, make in (
            ("mesh", lambda s: SpatialContext(system, vv, s, mesh=mesh)),
            ("one", lambda s: tamm.Context(full, vv, s))):
        ctx = make(tamm.make_state(x, v=torch.as_tensor(v), box=box, seed=4))
        ctx.step(10)
        out[name] = {"x": ctx.state.x, "v": ctx.state.v, "box": ctx.state.box,
                     "accepted": int(ctx.state.extra[baro.BARO_NACC]),
                     "attempted": int(ctx.state.extra[baro.BARO_NATT])}
    out.update(out.pop("mesh"))
    return out


def case_replicas(mesh, d, rank):
    """make_replicated_step over the mesh against the one-process stack:
    2 D argon replicas under an OU bath (each row's own generator)."""
    import atomsmm_tpu_torch as tamm
    from atomsmm_tpu_torch.context import refresh_force_caches
    from atomsmm_tpu_torch.models import argon_system
    from atomsmm_tpu_torch.parallel import (
        make_replicated_step,
        replicate_state,
    )

    system, x, box = argon_system(n=64, jitter=0.05, seed=1, r_cut=0.5,
                                  r_switch=0.4, dtype=F64, device="cpu")
    integ = tamm.GlobalThermostatIntegrator(
        0.002, tamm.OrnsteinUhlenbeckPropagator(120.0, 5.0))
    state = refresh_force_caches(system, integ.initialize(
        system, tamm.make_state(x, box=box, seed=0)), {})
    k = 2 * d
    runs = {}
    for name, m in (("mesh", mesh), ("one", None)):
        states = replicate_state(state, k, seed=3)
        step = make_replicated_step(integ.make_step(), m)
        for _ in range(5):
            states = step(system, states, {})
        runs[name] = states
    try:
        make_replicated_step(integ.make_step(), mesh)(
            system, replicate_state(state, 2 * d + 1), {})
        ragged = "no error"
    except ValueError as err:
        ragged = str(err)
    mesh_run, one = runs["mesh"], runs["one"]
    return {"equal": mesh_run.rows == one.rows == k
            and torch.equal(mesh_run.x, one.x)
            and torch.equal(mesh_run.v, one.v),
            "x": mesh_run.x, "ragged": ragged}


def case_stack_pme(mesh, d, rank):
    """3 rows of 40 PME waters (a dispersion tail, one water's charges
    scaled by a per-row lambda_coul) under spatial_mesh: the stack's
    energies and forces and each row's single-system evaluation, over the
    mesh, and the rows on one process."""
    import dataclasses

    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux
    from atomsmm_tpu_torch.parallel import spatial_mesh
    from atomsmm_tpu_torch.potential import force_fn, potential_energy
    from atomsmm_tpu_torch.utils import replace

    system, x, box = water_system(n_molecules=40, method="pme", r_cut=0.5,
                                  r_switch=0.45, neighbors=True,
                                  dispersion_correction=True, dtype=F64,
                                  device="cpu")
    mask = torch.zeros(x.shape[0], dtype=F64)
    mask[:3] = 1.0
    system = replace(system, forces=[dataclasses.replace(
        system.forces[0], charge_scale_mask=mask)] + list(system.forces[1:]))
    rs = np.random.RandomState(7)
    xs = x[None] + torch.as_tensor(rs.normal(0.0, 0.005, (3,) + x.shape))
    boxes = box.expand(3, 3).contiguous()
    lam = torch.tensor([0.2, 0.6, 1.0], dtype=F64)
    aux = make_aux(system, all_neighbor_extras(system, xs, boxes))
    energy_forces = force_fn(system)

    def rows():
        out = []
        for k in range(3):
            aux_k = make_aux(system, all_neighbor_extras(system, xs[k], box))
            g = {"lambda_coul": float(lam[k])}
            out.append((potential_energy(system, xs[k], box, g, aux=aux_k),
                        energy_forces(xs[k], box, g, aux_k)[1]))
        return (torch.stack([e for e, _ in out]),
                torch.stack([f for _, f in out]))

    with spatial_mesh(mesh):
        e_stack = potential_energy(system, xs, boxes, {"lambda_coul": lam},
                                   aux=aux)
        ef_stack = energy_forces(xs, boxes, {"lambda_coul": lam}, aux)
        e_rows, f_rows = rows()
    e_one, f_one = rows()
    return {"e_stack": e_stack, "ef_stack": ef_stack, "e_rows": e_rows,
            "f_rows": f_rows, "e_one": e_one, "f_one": f_one}


def _solvated():
    import atomsmm_tpu_torch as tamm
    from atomsmm_tpu_torch.models import phenol_in_water

    system, x, box, solute = phenol_in_water(
        n_water=60, r_cut=0.5, r_switch=0.42, seed=5, neighbors=True,
        dtype=F64, device="cpu")
    return tamm.SolvationSystem(system, solute_atoms=solute), x, box


def case_hrex(mesh, d, rank):
    """HREXSampler over the mesh against the one-process sampler at the same
    seeds: 4 replicas, three times a run of 4 steps and a swap attempt
    (both parities, pairs across a rank boundary)."""
    from atomsmm_tpu_torch.alchemy import coupling_path
    from atomsmm_tpu_torch.parallel import HREXSampler

    solv, x, box = _solvated()
    k = HREX_STATES
    lams = coupling_path(torch.linspace(0.0, 1.0, k, dtype=F64))
    out = {}
    for name, m in (("mesh", mesh), ("one", None)):
        sampler = HREXSampler(solv, x, box, lams, 300.0, mesh=m, dt=0.001,
                              seed=4)
        log = []
        for _ in range(3):
            sampler.run(4)
            before = sampler.swap_accepts
            sampler.attempt_swaps()
            log.append(sampler.swap_accepts - before)
        out[name] = {"x": sampler.positions(), "accepts": log,
                     "attempts": sampler.swap_attempts,
                     "rows": [(sampler.states.x[i], sampler.states.v[i],
                               sampler.states.box[i])
                              for i in range(sampler.states.rows)]}
    lo = rank * (k // d)
    mine = out["one"]["rows"][lo:lo + k // d]
    out["rows_equal"] = all(
        all(torch.equal(a, b) for a, b in zip(r_m, r_o))
        for r_m, r_o in zip(out["mesh"]["rows"], mine))
    for name in ("mesh", "one"):
        del out[name]["rows"]
    try:
        HREXSampler(solv, x, box, coupling_path(
            torch.linspace(0.0, 1.0, k + 1, dtype=F64)), 300.0, mesh=mesh)
        out["ragged"] = "no error"
    except ValueError as err:
        out["ragged"] = str(err)
    return out


def case_sfe(mesh, d, rank):
    """solvation_free_energy(hrex=True) over the mesh and on one process."""
    from atomsmm_tpu_torch.alchemy import solvation_free_energy

    solv, x, box = _solvated()
    kw = dict(hrex=True, swap_every=1, n_blocks=2, dt=0.001, n_equil=4,
              n_samples=2, sample_interval=2, seed=1)
    schedule = torch.linspace(0.0, 1.0, HREX_STATES, dtype=F64)
    return {name: solvation_free_energy(solv, x, box, schedule, 300.0,
                                        mesh=m, **kw)
            for name, m in (("mesh", mesh), ("one", None))}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def run(rank, world, store, out_dir, cases):
    """One gloo rank: a DeviceMesh over `world` CPU ranks, each case of
    `cases` in turn, everything saved to out_dir/rank<rank>.pt."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("dp",))
        out = {name: CASES[name](mesh, world, rank) for name in cases}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
