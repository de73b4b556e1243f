"""Spatial decomposition and the replica axis over a device mesh
(atomsmm_tpu_torch/parallel/spatial.py, parallel/mesh.py, and the mesh of
replicas.py, hrex.py and alchemy.py) against the JAX package, float64 on
the CPU.

The port's mesh is a 1-D torch.distributed DeviceMesh over gloo ranks: the
module spawns D = 2, 3 and 4 ranks (torch.multiprocessing, a file store
under the test's temporary directory, one intra-op thread a rank), all at
once, whose bodies live in tests/torch_parallel_ranks.py (no JAX there);
each rank saves what it got, and the cases below hold rank 0's numbers
against the JAX package's single-device functions (and its sharded sweep
on its 8-device CPU mesh, tests/conftest.py), as tests/test_parallel.py
holds its sharded paths, and every rank's final state against rank 0's,
bit for bit. While the ranks run, this process computes the JAX side.
D = 3 splits 512 atoms and a 15^3 PME grid (which it divides: the slab
FFT) raggedly; D = 2 and 4 split the 27 cells of argon 512 raggedly.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks

F64 = torch.float64
ALL = ("sweep", "pme", "slab", "argon_ctx", "water_ctx", "pme_ctx",
       "npt_ctx", "replicas", "hrex", "sfe", "stack_pme")
RUNS = {2: ALL,
        3: ("sweep", "pme", "pme_ctx", "replicas", "stack_pme"),
        4: ("sweep", "pme", "slab", "argon_ctx", "water_ctx", "pme_ctx",
            "hrex")}
JOIN_S = 600


def _runs_with(case):
    return [d for d, cases in RUNS.items() if case in cases]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The rank processes of every D, started before any JAX reference:
    {D: (output directory, process context)}."""
    import torch.multiprocessing as mp

    started = {}
    for d, cases in RUNS.items():
        out = tmp_path_factory.mktemp(f"ranks{d}")
        started[d] = (out, mp.start_processes(
            ranks.run, args=(d, str(out / "store"), str(out), cases),
            nprocs=d, join=False, start_method="spawn"))
    yield started
    for _, ctx in started.values():
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


_RESULTS = {}


def outputs(spawned, d):
    """Every rank's saved results at D ranks (joined on first use)."""
    if d not in _RESULTS:
        out, ctx = spawned[d]
        end = time.monotonic() + JOIN_S
        # join() returns False while a rank is still running, and raises
        # with the rank's traceback when one failed
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                for p in ctx.processes:
                    p.terminate()
                pytest.fail(f"the {d} gloo ranks did not finish in "
                            f"{JOIN_S} s")
        _RESULTS[d] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                       for r in range(d)]
    return _RESULTS[d]


def _close(got, want, rtol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _full_stencil_jax(system):
    from atomsmm_tpu.utils import replace

    return replace(system, neighbors=dataclasses.replace(
        system.neighbors, half_stencil=False, backend="xla"))


@pytest.fixture(scope="module")
def jax_sweep():
    """JAX's sharded sweep of argon 512 on its 8-device mesh."""
    import jax
    from jax.sharding import Mesh

    from atomsmm_tpu.models import argon_system
    from atomsmm_tpu.ops.neighbors import build_cell_buckets
    from atomsmm_tpu.parallel import sharded_cell_pair_energy_forces

    system, x, box = argon_system(neighbors=True, **ranks.ARGON)
    spec = system.neighbors
    bucket, _ = build_cell_buckets(spec, x, box)
    force = system.forces[0]
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    return sharded_cell_pair_energy_forces(
        force._pair_fn({}), x, box, force._per_particle({}), spec, bucket,
        force.r_cut, mesh)


def _jax_trajectory(build, dt, steps):
    from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state

    system, x, box = build()
    ctx = Context(_full_stencil_jax(system), VelocityVerletIntegrator(dt),
                  make_state(x, box=box, seed=0))
    ctx.step(steps)
    return (np.asarray(ctx.state.x), np.asarray(ctx.state.v),
            float(ctx.get_state().potential_energy))


@pytest.fixture(scope="module")
def jax_trajectories():
    """JAX's single-device full-stencil Context on the three systems."""
    from atomsmm_tpu.models import argon_system, rigid_water_system, \
        water_system

    return {
        "argon_ctx": _jax_trajectory(lambda: argon_system(
            neighbors=True, **ranks.ARGON), 0.002, ranks.ARGON_STEPS),
        "water_ctx": _jax_trajectory(lambda: rigid_water_system(
            n_molecules=64, r_cut=0.5, r_switch=0.42, neighbors=True,
            seed=3), 0.002, ranks.WATER_STEPS),
        "pme_ctx": _jax_trajectory(lambda: water_system(
            n_molecules=40, method="pme", r_cut=0.5, r_switch=0.45,
            neighbors=True), 0.001, ranks.PME_STEPS),
    }


def _jax_reciprocal(x, box, q, alpha, grid, order):
    """JAX's single-device reciprocal energy and its gradient."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.ops.pme import pme_reciprocal_energy

    x, box, q = (jnp.asarray(a) for a in (x, box, q))

    def energy(xx):
        return pme_reciprocal_energy(xx, box, q, alpha, grid, order)

    return float(energy(x)), np.asarray(jax.grad(energy)(x))


def _bitwise_across_ranks(outs, case, keys=("x", "v", "box")):
    for r, out in enumerate(outs[1:], 1):
        for k in keys:
            assert torch.equal(out[case][k], outs[0][case][k]), (r, k)


# --------------------------------------------------------------------------
# in one process: the ranged sweep, the K2 block of the influence, the API
# --------------------------------------------------------------------------


def _argon_cells():
    from atomsmm_tpu_torch.models import argon_system
    from atomsmm_tpu_torch.ops.neighbors import build_cell_buckets

    system, x, box = argon_system(neighbors=True, dtype=F64, device="cpu",
                                  **ranks.ARGON)
    bucket, _ = build_cell_buckets(system.neighbors, x, box)
    return system, x, box, bucket


@pytest.mark.parametrize("parts, virial", [(2, False), (3, True),
                                           (5, False)])
def test_twin_ranges_sum_to_the_whole_sweep(parts, virial):
    """K2's plain twin over disjoint home-cell ranges: the rows add up to
    the whole sweep's bit for bit, each atom's row on exactly one range."""
    from atomsmm_tpu_torch.ops.pair_kernel import full_pair_plain
    from atomsmm_tpu_torch.ops.pairfuncs import virial_form

    system, x, box, bucket = _argon_cells()
    force, spec = system.forces[0], system.neighbors
    pp = force._per_particle({})
    form = force._pair_form({})
    for form in ((virial_form(form),) if virial else (form,)):
        whole = full_pair_plain(x, pp, bucket, spec, box, form, force.r_cut)
        edges = np.linspace(0, spec.ncells, parts + 1).astype(int)
        pieces = [full_pair_plain(x, pp, bucket, spec, box, form,
                                  force.r_cut, cells=(a, b))
                  for a, b in zip(edges[:-1], edges[1:])]
        assert torch.equal(sum(pieces), whole)
        nonzero = torch.stack([(p[:-1] != 0).any(1) for p in pieces])
        assert bool((nonzero.sum(0) == 1).all())


def test_twin_range_refusals_and_empty_range():
    from atomsmm_tpu_torch.ops.pair_kernel import full_pair_plain

    system, x, box, bucket = _argon_cells()
    force, spec = system.forces[0], system.neighbors
    args = (x, force._per_particle({}), bucket, spec, box,
            force._pair_form({}), force.r_cut)
    for bad in ((-1, 3), (3, 2), (0, spec.ncells + 1)):
        with pytest.raises(ValueError, match="home-cell range"):
            full_pair_plain(*args, cells=bad)
    assert not bool(full_pair_plain(*args, cells=(4, 4)).any())


def test_influence_k2_block_matches_jax():
    """pme_influence(k2_indices=...) is the K2 block of the whole
    influence, and JAX's block, orthorhombic and triclinic."""
    import jax.numpy as jnp

    from atomsmm_tpu.ops.pme import pme_influence as jinfluence
    from atomsmm_tpu_torch.ops.pme import pme_influence

    _, _, _, box_o, box_t = ranks.slab_inputs()
    grid, alpha, order = ranks.SLAB_GRID, ranks.SLAB_ALPHA, ranks.SLAB_ORDER
    for box in (box_o, box_t):
        tb = torch.as_tensor(box)
        whole = pme_influence(tb, alpha, grid, order)
        for blk in (slice(0, 4), slice(4, 8)):
            part = pme_influence(tb, alpha, grid, order, k2_indices=blk)
            assert torch.equal(part, whole[:, blk])
            want = jinfluence(jnp.asarray(box), alpha, grid, order,
                              jnp.float64,
                              k2_indices=jnp.arange(blk.start, blk.stop))
            _close(part, want, 1e-12, 1e-300)


def test_mesh_arguments_are_checked():
    from atomsmm_tpu_torch.models import argon_system
    from atomsmm_tpu_torch.parallel import SpatialContext, spatial_mesh
    from atomsmm_tpu_torch.parallel.replicas import make_replicated_step
    from atomsmm_tpu_torch import VelocityVerletIntegrator, make_state

    system, x, box = argon_system(n=64, r_cut=0.5, r_switch=0.4, dtype=F64,
                                  device="cpu", neighbors=True)
    integ = VelocityVerletIntegrator(0.002)
    with pytest.raises(ValueError, match="requires a mesh"):
        SpatialContext(system, integ, make_state(x, box=box))
    for call in (
            lambda: SpatialContext(system, integ, make_state(x, box=box),
                                   mesh=object()),
            lambda: spatial_mesh(object()).__enter__(),
            lambda: make_replicated_step(integ.make_step(), mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()


def test_exports():
    import atomsmm_tpu_torch.parallel as par
    from atomsmm_tpu_torch.forces import last_reciprocal_dispatch

    for name in ("SpatialContext", "spatial_mesh",
                 "sharded_cell_pair_energy_forces",
                 "sharded_cell_pair_energy", "sharded_pme_reciprocal_energy",
                 "sharded_pme_reciprocal_energy_fft"):
        assert callable(getattr(par, name)), name
    assert last_reciprocal_dispatch() in (
        None, "single_device", "slab_fft", "atom_sharded_psum")


# --------------------------------------------------------------------------
# over D gloo ranks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", _runs_with("sweep"))
def test_sharded_sweep_matches_jax(spawned, jax_sweep, d):
    """Argon 512, force decomposition over the home cells: energy 1e-12 and
    forces 1e-10 against JAX's sharded sweep; the energy-only path, the
    pair-function path and the virial form (against autograd of the whole
    sweep) agree."""
    e_j, f_j = jax_sweep
    out = outputs(spawned, d)[0]["sweep"]
    _close(out["e"], float(e_j), 1e-12)
    _close(out["f"], f_j, 1e-10, 1e-12)
    _close(out["e_only"], float(e_j), 1e-12)
    _close(out["e_fn"], float(e_j), 1e-12)
    _close(out["f_fn"], f_j, 1e-10, 1e-12)
    _close(out["w"], float(out["w_ref"]), 1e-12)
    _close(out["w_fn"], float(out["w_ref"]), 1e-12)


@pytest.mark.parametrize("d", _runs_with("sweep"))
def test_sharded_rows_are_the_whole_sweep_bitwise(spawned, d):
    """After the all_reduce every rank holds the one-process K2 twin's rows
    bit for bit; the ranks' home-cell ranges tile the grid."""
    outs = outputs(spawned, d)
    assert all(o["sweep"]["rows_bitwise"] for o in outs)
    ranges = [o["sweep"]["range"] for o in outs]
    assert ranges[0][0] == 0 and ranges[-1][1] == outs[0]["sweep"]["ncells"]
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("d", _runs_with("pme"))
def test_atom_sharded_pme_matches_jax(spawned, d):
    """64 waters: energy 1e-11 and forces 1e-9 against JAX's single-device
    reciprocal energy and its gradient."""
    from atomsmm_tpu.models import water_system

    system, x, box = water_system(n_molecules=64, method="pme", r_cut=0.55,
                                  r_switch=0.45)
    nb = system.forces[0]
    e_j, g_j = _jax_reciprocal(x, box, nb.charge, nb.ewald_alpha,
                               nb.grid_shape, nb.spline_order)
    out = outputs(spawned, d)[0]["pme"]
    _close(out["e"], e_j, 1e-11)
    _close(out["f"], -g_j, 1e-9, 1e-11)


@pytest.mark.parametrize("d", _runs_with("slab"))
def test_slab_fft_matches_jax(spawned, d):
    """The slab FFT on (16, 8, 15), orthorhombic and triclinic: energy
    1e-12, forces 1e-9 against JAX's single-device sum and gradient; the
    grid (25, 16, 15) raises."""
    q, x_o, x_t, box_o, box_t = ranks.slab_inputs()
    out = outputs(spawned, d)[0]["slab"]
    for tag, x, box in (("o", x_o, box_o), ("t", x_t, box_t)):
        e_j, g_j = _jax_reciprocal(x, box, q, ranks.SLAB_ALPHA,
                                   ranks.SLAB_GRID, ranks.SLAB_ORDER)
        e, f = out[tag]
        _close(e, e_j, 1e-12)
        _close(f, -g_j, 1e-9, 1e-11)
    assert "divisible" in out["bad"]


@pytest.mark.parametrize("d", _runs_with("argon_ctx"))
def test_spatial_context_argon(spawned, jax_trajectories, d):
    """SpatialContext, argon 512, 10 VV steps: x and v to 1e-13 of JAX's
    single-device full-stencil Context, PE 1e-12, every rank bitwise equal."""
    x_j, v_j, pe_j = jax_trajectories["argon_ctx"]
    outs = outputs(spawned, d)
    out = outs[0]["argon_ctx"]
    _close(out["x"], x_j, 0, 1e-13)
    _close(out["v"], v_j, 0, 1e-13)
    _close(out["pe"], pe_j, 1e-12)
    _bitwise_across_ranks(outs, "argon_ctx")


@pytest.mark.parametrize("d", _runs_with("water_ctx"))
def test_spatial_context_rigid_water(spawned, jax_trajectories, d):
    """64 waters on SETTLE, 8 VV steps: x to 1e-12 of JAX, the SETTLE
    residual < 1e-12, every rank bitwise equal."""
    x_j, _, _ = jax_trajectories["water_ctx"]
    outs = outputs(spawned, d)
    out = outs[0]["water_ctx"]
    _close(out["x"], x_j, 0, 1e-12)
    assert out["residual"] < 1e-12
    _bitwise_across_ranks(outs, "water_ctx")


@pytest.mark.parametrize("d", _runs_with("pme_ctx"))
def test_spatial_context_pme_water(spawned, jax_trajectories, d):
    """40 PME waters, 5 VV steps: x to 1e-12 of JAX, PE 1e-11; the slab FFT
    where D divides K1 and K2 of the 15^3 grid (D = 3), else the
    atom-sharded sum; every rank bitwise equal."""
    x_j, _, pe_j = jax_trajectories["pme_ctx"]
    outs = outputs(spawned, d)
    out = outs[0]["pme_ctx"]
    _close(out["x"], x_j, 0, 1e-12)
    _close(out["pe"], pe_j, 1e-11)
    k1, k2, _ = out["grid"]
    want = "slab_fft" if k1 % d == 0 and k2 % d == 0 else "atom_sharded_psum"
    assert [o["pme_ctx"]["dispatch"] for o in outs] == [want] * d
    _bitwise_across_ranks(outs, "pme_ctx")


@pytest.mark.parametrize("d", _runs_with("npt_ctx"))
def test_spatial_context_under_the_barostat(spawned, d):
    """125 waters, a volume move every 2 steps, 10 VV steps: the
    SpatialContext's trajectory, box and decisions equal a one-process
    full-stencil Context's from the same state and seed, bit for bit (the
    sharded rows are the whole sweep's, the trials the first rank's), at
    least one move accepted and one rejected; every rank bitwise equal."""
    outs = outputs(spawned, d)
    out = outs[0]["npt_ctx"]
    for k in ("x", "v", "box", "accepted", "attempted"):
        assert (torch.equal(out[k], out["one"][k])
                if isinstance(out[k], torch.Tensor) else
                out[k] == out["one"][k]), k
    assert out["attempted"] == 5 and 0 < out["accepted"] < 5
    _bitwise_across_ranks(outs, "npt_ctx")


@pytest.mark.parametrize("d", _runs_with("replicas"))
def test_replicated_step_over_the_mesh(spawned, d):
    """2 D argon replicas under an OU bath, 5 steps of make_replicated_step
    over the mesh: every rank returns the one-process stack bit for bit;
    2 D + 1 replicas raise."""
    outs = outputs(spawned, d)
    assert all(o["replicas"]["equal"] for o in outs)
    for o in outs[1:]:
        assert torch.equal(o["replicas"]["x"], outs[0]["replicas"]["x"])
    assert "do not divide" in outs[0]["replicas"]["ragged"]


@pytest.mark.parametrize("d", _runs_with("hrex"))
def test_hrex_over_the_mesh(spawned, d):
    """4 lambda replicas over the mesh against the one-process sampler at
    the same seeds: each rank's rows bitwise equal to the one-process
    rows, the same accept counts attempt by attempt, the same positions;
    5 states raise."""
    outs = outputs(spawned, d)
    for o in outs:
        h = o["hrex"]
        assert h["rows_equal"]
        assert h["mesh"]["accepts"] == h["one"]["accepts"]
        assert h["mesh"]["attempts"] == h["one"]["attempts"]
        assert torch.equal(h["mesh"]["x"], h["one"]["x"])
        assert "do not divide" in h["ragged"]


@pytest.mark.parametrize("d", _runs_with("stack_pme"))
def test_stacked_pme_rows_over_the_mesh(spawned, d):
    """A stack of 3 PME water rows under spatial_mesh (the pair term
    sharded row by row, the reciprocal sum, its corrections and the
    dispersion tail once a row): the stack's energies and forces equal
    each row's single-system evaluation over the mesh, 1e-12, and the
    one-process rows, 1e-11; every rank equal."""
    outs = outputs(spawned, d)
    out = outs[0]["stack_pme"]
    e_stack, (e_ef, f_ef) = out["e_stack"], out["ef_stack"]
    assert tuple(e_stack.shape) == (3,) and tuple(f_ef.shape)[0] == 3
    for e in (e_stack, e_ef):
        _close(e, out["e_rows"].numpy(), 1e-12)
        _close(e, out["e_one"].numpy(), 1e-11)
    scale = float(out["f_one"].abs().max())
    _close(f_ef, out["f_rows"].numpy(), 0, 1e-12 * scale)
    _close(f_ef, out["f_one"].numpy(), 0, 1e-11 * scale)
    for o in outs[1:]:
        assert torch.equal(o["stack_pme"]["e_stack"], e_stack)
        assert torch.equal(o["stack_pme"]["ef_stack"][1], f_ef)


@pytest.mark.parametrize("d", _runs_with("sfe"))
def test_solvation_free_energy_over_the_mesh(spawned, d):
    """solvation_free_energy(hrex=True, mesh=...) gives the one-process
    dG (MBAR and TI) to 1e-9 and the same swap statistics."""
    for o in outputs(spawned, d):
        s = o["sfe"]
        for key in ("dg_mbar", "dg_ti"):
            _close(s["mesh"][key], s["one"][key], 1e-9)
        assert s["mesh"]["swap_attempts"] == s["one"]["swap_attempts"]
        assert s["mesh"]["n_samples_total"] == s["one"]["n_samples_total"]
        _close(s["mesh"]["f_k"], s["one"]["f_k"], 1e-9, 1e-12)
