"""The block neighbor backend of the port (ops/blocks.py) against the JAX
package's, float64 on the CPU, and K4 (csrc/block_pair.cu) against its
plain twin on the card.

  * make_block_spec gives the same K, chunk and sort grid, and
    build_block_lists the same order, candidate blocks and overflow flag,
    element for element (argon 216 and 500 with jitter; water 64 at 32 and
    64 atoms a block);
  * block_pair_energy_forces (K4's plain twin on the CPU) matches JAX's
    block_pair_energy_forces called directly: energy rtol 1e-10, forces
    atol 1e-9 x max|F|; a CustomNonbondedForce on the callable block
    sweep against JAX's; overflow at K = 1 and retune_block_spec's K;
  * a 50-step velocity-Verlet argon 125 trajectory on blocks under Context
    matches JAX's on blocks to 1e-9 nm; RESPA on blocks (water 64, the
    near force on its own block list from RESPASystem): each group's
    energy and forces against JAX's, near + far == full to 1e-10; a
    10-step NPT RESPA run on blocks against JAX's (its barostat uniforms
    replayed, x and v 1e-9, the box 1e-12); FIRE,
    the MC barostat (its trial and its move rebuild the lists), the
    grouped cadence (K = 2 against K = 1), the replica runner and
    Simulation on blocks; a System file and interop carry the spec;
  * FarNonbondedForce where the halves cannot fuse (a PME full force with
    an undamped near half, and minus_near.subtract=False), on cells and on
    blocks, against JAX's FarNonbondedForce at 1e-10, and near + far ==
    full with the undamped near half;
  * the three refusals raise InputError: a (3, 3) box, a type-pair table
    and a spatial mesh;
  * K4's frame (ops/blocks.py::block_frames): where a home block's frame
    is exact, staging about its centre gives the minimum image's pairs and
    displacements (1e-12), float64;
  * `cuda` cases hold K4 against the plain twin on the card in every
    form and both exclusion forms, at 32 and 128 atoms a block, with more
    work items than its grid holds at once, rows of one candidate, a padded last
    block of one atom and the per-slot image of a small box; the block
    path against K1's cell path on one state, and the unfusable far force
    on the card against the CPU.

The JAX package is imported inside the JAX tests only, so that the card
runs the `cuda` cases with PyTorch alone:
    pytest tests/test_torch_blocks.py -m cuda -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.ops import blocks as tblocks
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pairfuncs as pf
from atomsmm_tpu_torch.ops.pbc import minimum_image
from atomsmm_tpu_torch.potential import force_fn as tforce_fn
from atomsmm_tpu_torch.utils import InputError

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Pin torch to one intra-op thread for this file (several workers
    contend otherwise)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax():
    """The JAX package's modules this file holds the port against."""
    import jax

    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.ops import blocks as jblocks
    from atomsmm_tpu.ops import neighbors as jnb

    return jax, jmodels, jblocks, jnb


def _build(pkg_models, name, **kw):
    if name.startswith("argon"):
        n = int(name[5:])
        return pkg_models.argon_system(n=n, jitter=0.25 if n == 216 else 0.3,
                                       seed=1, **kw)
    return pkg_models.water_system(n_molecules=64, r_cut=0.55, r_switch=0.45,
                                   **kw)


CASES = {"argon216": {}, "argon500": {}, "water64_b32": {"block_size": 32},
         "water64_b64": {"block_size": 64}}


def _pair(name):
    """((JAX force, spec, x, box), (port force, spec, x, box))."""
    _, jmodels, jblocks, _ = _jax()
    js, jx, jb = _build(jmodels, name)
    ts, tx, tb = _build(tmodels, name, dtype=F64, device="cpu")
    jf, tf = js.forces[0], ts.forces[0]
    kw = CASES[name]
    jspec = jblocks.make_block_spec(
        np.asarray(jb), jx.shape[0], float(jf.r_cut),
        exclusions=np.asarray(jf.exclusions), occupancy_from=np.asarray(jx),
        **kw)
    tspec = tblocks.make_block_spec(tb, tx.shape[0], tf.r_cut,
                                    exclusions=tf.exclusions,
                                    occupancy_from=tx, device="cpu", **kw)
    return (jf, jspec, jx, jb), (tf, tspec, tx, tb)


@pytest.fixture(scope="module")
def built():
    return {name: _pair(name) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_build_block_lists_match_jax(built, name):
    _, _, jblocks, _ = _jax()
    (_, jspec, jx, jb), (_, tspec, tx, tb) = built[name]
    for field in ("n_blocks", "max_cand", "block_chunk", "sort_grid",
                  "block_size"):
        assert getattr(tspec, field) == getattr(jspec, field), field
    assert tspec.r_build == pytest.approx(float(jspec.r_build), abs=1e-15)
    jo, jc, jov = jblocks.build_block_lists(jspec, jx, jb)
    to, tc, tov = tblocks.build_block_lists(tspec, tx, tb)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert bool(tov) == bool(jov) is False
    real = to[to < tx.shape[0]]
    assert torch.equal(torch.sort(real).values,
                       torch.arange(tx.shape[0], dtype=torch.int32))


@pytest.mark.parametrize("name", list(CASES))
def test_block_pair_energy_forces_match_jax(built, name):
    _, _, jblocks, _ = _jax()
    (jf, jspec, jx, jb), (tf, tspec, tx, tb) = built[name]
    jo, jc, _ = jblocks.build_block_lists(jspec, jx, jb)
    je, jforces = jblocks.block_pair_energy_forces(
        jf._pair_fn({}), jx, jb, jf._per_particle({}), jspec, jo, jc,
        float(jf.r_cut))
    to, tc, _ = tblocks.build_block_lists(tspec, tx, tb)
    te, tforces = tblocks.block_pair_energy_forces(
        tf._pair_form(), tx, tb, tf._per_particle(), tspec, to, tc, tf.r_cut)
    assert float(te) == pytest.approx(float(je), rel=1e-10)
    jforces = np.asarray(jforces)
    np.testing.assert_allclose(tforces.numpy(), jforces, rtol=0,
                               atol=1e-9 * np.abs(jforces).max())
    # the energy-only sweep sums the same column
    e_only = tblocks.block_pair_energy(tf._pair_form(), tx, tb,
                                       tf._per_particle(), tspec, to, tc,
                                       tf.r_cut)
    assert float(e_only) == pytest.approx(float(te), rel=1e-13)


def test_custom_nonbonded_on_blocks_matches_jax(built):
    """A CustomNonbondedForce (a Python pair function, no kernel) on the
    block list: the callable block sweep, forces by autograd, against the
    JAX package's block sweep of the same function."""
    import jax
    import jax.numpy as jnp

    import atomsmm_tpu as jamm
    from atomsmm_tpu.ops import neighbors as jnb

    (jf, jspec, jx, jb), (tf, tspec, tx, tb) = built["water64_b32"]

    def energy(r, pi, pj, globals):
        s = 0.5 * (pi["s"] + pj["s"])
        return 4.0 * pi["e"] * pj["e"] * ((s / r) ** 12 - (s / r) ** 6) \
            + 0.1 * pi["q"] * pj["q"] / r

    jcus = jamm.CustomNonbondedForce(
        per_particle={"s": jf.sigma, "e": jf.epsilon, "q": jf.charge},
        exclusions=jf.exclusions, energy_function=energy, r_cut=0.55)
    tcus = tamm.CustomNonbondedForce(
        per_particle={"s": tf.sigma, "e": tf.epsilon, "q": tf.charge},
        exclusions=tf.exclusions, energy_function=energy, r_cut=0.55)
    jsys = jamm.System(masses=jnp.ones(jx.shape[0]), forces=(jcus,),
                       default_box=jb).with_neighbors(jspec)
    tsys = tamm.System(masses=torch.ones(tx.shape[0], dtype=F64),
                       forces=(tcus,), default_box=tb).with_neighbors(tspec)
    jaux = jnb.make_aux(jsys, jnb.all_neighbor_extras(jsys, jx, jb))
    taux = tnb.make_aux(tsys, tnb.all_neighbor_extras(tsys, tx, tb))
    je = float(jcus.energy(jx, jb, {}, jaux))
    jg = -np.asarray(jax.grad(lambda xx: jcus.energy(xx, jb, {}, jaux))(jx))
    te, tf_ = tcus.energy_and_forces(tx, tb, {}, taux)
    assert float(te) == pytest.approx(je, rel=1e-10)
    np.testing.assert_allclose(tf_.numpy(), jg, rtol=0,
                               atol=1e-9 * np.abs(jg).max())
    # and the dense sum of the same function
    assert float(tcus.energy(tx, tb, {}, None)) == pytest.approx(je,
                                                                 rel=1e-10)


def test_overflow_and_retune_match_jax(built):
    _, _, jblocks, _ = _jax()
    (_, jspec, jx, jb), (_, tspec, tx, tb) = built["argon500"]
    one_j = dataclasses.replace(jspec, max_cand=1)
    one_t = dataclasses.replace(tspec, max_cand=1)
    assert bool(jblocks.build_block_lists(one_j, jx, jb)[2])
    assert bool(tblocks.build_block_lists(one_t, tx, tb)[2])
    for safety in (1.0, 1.25, 1.5):
        jk = jblocks.retune_block_spec(one_j, np.asarray(jx), np.asarray(jb),
                                       safety)
        tk = tblocks.retune_block_spec(one_t, tx, tb, safety)
        assert (tk.max_cand, tk.block_chunk) == (jk.max_cand,
                                                 jk.block_chunk)
    # the overflow replay grows a block spec through the shared helper
    sys_t = tmodels.argon_system(n=500, jitter=0.3, seed=1, dtype=F64,
                                 device="cpu")[0].with_neighbors(one_t)
    grown = tnb.retune_neighbor_specs(sys_t, tx, tb, safety=1.0,
                                      grow_only=True)
    assert grown.neighbors.max_cand == tblocks.retune_block_spec(
        one_t, tx, tb, 1.15).max_cand


def _vv_argon(pkg, models, n_steps, v0, blocks_mod):
    system, x, box = models.argon_system(
        n=125, jitter=0.05, seed=1,
        **({"dtype": F64, "device": "cpu"} if pkg is tamm else {}))
    nb = system.forces[0]
    kw = {"device": "cpu"} if pkg is tamm else {}
    spec = blocks_mod.make_block_spec(
        np.asarray(box), x.shape[0], float(nb.r_cut),
        exclusions=nb.exclusions if pkg is tamm else np.asarray(
            nb.exclusions),
        occupancy_from=x if pkg is tamm else np.asarray(x), **kw)
    system = system.with_neighbors(spec)
    if pkg is tamm:
        state = tamm.make_state(x, v=torch.as_tensor(v0), box=box)
    else:
        state = pkg.make_state(x, v=v0, box=box)
    ctx = pkg.Context(system, pkg.VelocityVerletIntegrator(dt=0.002), state)
    ctx.step(n_steps)
    return np.asarray(ctx.state.x)


def test_vv_argon_trajectory_on_blocks_matches_jax():
    _, jmodels, jblocks, _ = _jax()
    import atomsmm_tpu as jamm

    v0 = np.random.default_rng(5).normal(0.0, 0.25, (125, 3))
    v0 -= v0.mean(axis=0)
    xj = _vv_argon(jamm, jmodels, 50, v0, jblocks)
    xt = _vv_argon(tamm, tmodels, 50, v0, tblocks)
    assert np.abs(xt - xj).max() < 1e-9


def _respa(pkg, models, blocks=True, method="cutoff"):
    kw = {"dtype": F64, "device": "cpu"} if pkg is tamm else {}
    system, x, box = models.water_system(
        n_molecules=64, r_cut=0.55, r_switch=0.45, method=method,
        neighbors="blocks" if blocks else True, **kw)
    return system, pkg.RESPASystem(system, rcut_in=0.4, rswitch_in=0.3), \
        x, box


def test_respa_on_blocks_matches_jax():
    jax, jmodels, _, jnb = _jax()
    import atomsmm_tpu as jamm
    from atomsmm_tpu.potential import force_fn as jforce_fn

    jfull, jresp, jx, jb = _respa(jamm, jmodels)
    tfull, tresp, tx, tb = _respa(tamm, tmodels)
    near = tresp.extra_neighbor_specs["near"]
    assert isinstance(near, tblocks.BlockNeighborSpec)
    jnear = jresp.extra_neighbor_specs["near"]
    assert (near.max_cand, near.n_blocks, near.block_size) == (
        jnear.max_cand, jnear.n_blocks, jnear.block_size)
    jaux = jnb.make_aux(jresp, jnb.all_neighbor_extras(jresp, jx, jb))
    taux = tnb.make_aux(tresp, tnb.all_neighbor_extras(tresp, tx, tb))
    assert set(taux) == {"default", "near"} and "cand" in taux["near"]
    for groups in ([0], [1], [2], None):
        je, jf_ = jforce_fn(jresp, groups)(jx, jb, {}, jaux)
        te, tf_ = tforce_fn(tresp, groups)(tx, tb, {}, taux)
        assert float(te) == pytest.approx(float(je), rel=1e-10), groups
        jf_ = np.asarray(jf_)
        # group 0 at the lattice start: forces of rounding size only
        np.testing.assert_allclose(tf_.numpy(), jf_, rtol=0,
                                   atol=1e-9 * max(np.abs(jf_).max(), 1.0))
    # near + far == full, the full force on the full system's block list
    e_split, f_split = tforce_fn(tresp)(tx, tb, {}, taux)
    full_aux = tnb.make_aux(tfull, tnb.all_neighbor_extras(tfull, tx, tb))
    e_full, f_full = tforce_fn(tfull)(tx, tb, {}, full_aux)
    assert float(e_split) == pytest.approx(float(e_full), rel=1e-10)
    assert float((f_split - f_full).abs().max()) <= 1e-10 * float(
        f_full.abs().max())


def _far_variants(pkg, models, method, device="cpu"):
    """(system, its near force, near half kinds -> FarNonbondedForce, x,
    box) of water 64 under `method`: 'undamped' (PME with an alpha-0 near
    half) and 'added' (minus_near.subtract=False)."""
    from dataclasses import replace

    kw = {"dtype": F64, "device": device} if pkg is tamm else {}
    system, x, box = models.water_system(
        n_molecules=64, r_cut=0.55, r_switch=0.45, method=method, **kw)
    full = system.forces[0]
    respa = pkg.RESPASystem(system, rcut_in=0.4, rswitch_in=0.3)
    near = next(f for f in respa.forces
                if type(f).__name__ == "NearNonbondedForce")
    far_cls = type(next(f for f in respa.forces
                        if type(f).__name__ == "FarNonbondedForce"))
    out = {"added": far_cls(group=2, full=replace(full, group=2),
                            minus_near=replace(near, subtract=False,
                                               group=2))}
    if method == "pme":
        out["undamped"] = far_cls(
            group=2, full=replace(full, group=2),
            minus_near=replace(near, subtract=True, alpha=0.0, group=2))
    return system, near, out, x, box


@pytest.mark.parametrize("method,kind", [("pme", "undamped"),
                                         ("pme", "added"),
                                         ("cutoff", "added")])
@pytest.mark.parametrize("lists", ["cells", "blocks"])
def test_unfusable_far_force_matches_jax(method, kind, lists):
    jax, jmodels, _, _ = _jax()
    import atomsmm_tpu as jamm

    _, _, jfar, jx, jb = _far_variants(jamm, jmodels, method)
    tsys, tnear, tfar, tx, tb = _far_variants(tamm, tmodels, method)
    jforce, tforce = jfar[kind], tfar[kind]
    assert tforce._fusable() == (kind == "added")
    je = jforce.energy(jx, jb, {}, None)
    jf_ = -np.asarray(jax.grad(lambda xx: jforce.energy(xx, jb, {}, None))(jx))
    spec = (tblocks.make_block_spec(tb, tx.shape[0], 0.55,
                                    exclusions=tsys.forces[0].exclusions,
                                    occupancy_from=tx, device="cpu")
            if lists == "blocks" else
            tnb.make_neighbor_spec(tb, tx.shape[0], 0.55,
                                   exclusions=tsys.forces[0].exclusions,
                                   device="cpu"))
    tsys = tsys.with_neighbors(spec)
    aux = tnb.make_aux(tsys, tnb.all_neighbor_extras(tsys, tx, tb))
    te, tf_ = tforce.energy_and_forces(tx, tb, {}, aux)
    assert float(te) == pytest.approx(float(je), rel=1e-10)
    assert float(tforce.energy(tx, tb, {}, aux)) == pytest.approx(
        float(je), rel=1e-10)
    np.testing.assert_allclose(tf_.numpy(), jf_, rtol=0,
                               atol=1e-10 * np.abs(jf_).max())
    if kind == "undamped":
        # the split identity with the undamped near half: near + far == full
        from dataclasses import replace

        near0 = replace(tnear, alpha=0.0, neighbor_key="default")
        en, fn_ = near0.energy_and_forces(tx, tb, {}, aux)
        ef, ff = tsys.forces[0].energy_and_forces(tx, tb, {}, aux)
        assert float(en + te) == pytest.approx(float(ef), rel=1e-10)
        assert float((fn_ + tf_ - ff).abs().max()) <= 1e-10 * float(
            ff.abs().max())


def test_fire_barostat_cadence_and_replicas_on_blocks(tmp_path):
    """FIRE, the MC barostat, the grouped cadence, the replica runner, a
    System file and interop on a System with block lists."""
    from atomsmm_tpu_torch import checkpoint
    from atomsmm_tpu_torch.minimize import fire_minimize
    from atomsmm_tpu_torch.parallel.replicas import (
        make_replicated_step,
        replicate_state,
    )

    system, respa, x, box = _respa(tamm, tmodels)
    x_min = fire_minimize(respa, x, box, steps=20)
    assert tamm.potential_energy(respa, x_min, box) < \
        tamm.potential_energy(respa, x, box)
    integ = tamm.MultipleTimeScaleIntegrator(0.002, [2, 1, 1])
    # K = 2 between rebuilds against K = 1 (the staleness guard holds)
    runs = []
    for k in (1, 2):
        ctx = tamm.Context(respa, integ, tamm.make_state(x_min, box=box),
                           neighbor_update_every=k)
        ctx.set_velocities_to_temperature(300.0, seed=3)
        ctx.step(6)
        runs.append(ctx.state.x)
    assert float((runs[0] - runs[1]).abs().max()) < 1e-10
    # a cold start whose K overflows is retuned by Context, as cells are
    small = respa.with_neighbors(
        dataclasses.replace(respa.neighbors, max_cand=1),
        near=respa.extra_neighbor_specs["near"])
    ctx = tamm.Context(small, integ, tamm.make_state(x_min, box=box))
    assert ctx.system.neighbors.max_cand > 1
    ctx.step(2)
    assert ctx.last_step_passes == 1
    sim = tamm.Simulation(respa, integ, tamm.make_state(x_min, box=box))
    sim.step(3)
    assert sim.context.state.step == 3
    # the barostat rebuilds the block lists of its trial and of the move
    baro = system.replace_forces(tuple(system.forces) + (
        tamm.MonteCarloBarostat(pressure=1.0, temperature=300.0,
                                frequency=2),))
    ctx = tamm.Context(baro, tamm.VelocityVerletIntegrator(0.001),
                       tamm.make_state(x_min, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=4)
    ctx.step(8)
    assert not torch.equal(ctx.state.box, box)
    assert torch.equal(ctx.state.extra["nbr_boxref"], ctx.state.box)
    # the replica runner: the rows one after another on their own lists
    from atomsmm_tpu_torch.context import refresh_force_caches, \
        with_neighbor_lists

    state = with_neighbor_lists(respa, tamm.make_state(x_min, box=box))
    state = refresh_force_caches(respa, integ.initialize(respa, state), {})
    states = replicate_state(state, 2, seed=1)
    states = make_replicated_step(integ.make_step())(respa, states, {})
    assert states.extra["nbr_order"].shape == (2, respa.neighbors.n_padded)
    assert states.extra["nbr_near_cand"].shape[0] == 2
    assert bool(torch.isfinite(states.x).all())
    # a System file carries the block specs
    path = tmp_path / "blocks.npz"
    checkpoint.save_system(path, respa)
    back = checkpoint.load_system(path, device="cpu")
    for name in ("neighbors",):
        a, b = getattr(back, name), getattr(respa, name)
        assert isinstance(a, tblocks.BlockNeighborSpec)
        assert (a.max_cand, a.sort_grid, a.r_build) == (
            b.max_cand, b.sort_grid, b.r_build)
        assert torch.equal(a.excbits, b.excbits)
    e0 = tamm.potential_energy(respa, x_min, box, aux=tnb.make_aux(
        respa, tnb.all_neighbor_extras(respa, x_min, box)))
    e1 = tamm.potential_energy(back, x_min, box, aux=tnb.make_aux(
        back, tnb.all_neighbor_extras(back, x_min, box)))
    assert float(e1) == float(e0)


def test_npt_on_blocks_matches_jax():
    """125 waters on block lists (the near force on its own), RESPA
    [2, 2, 1] + NHC at 2 fs, the MC barostat every 5 steps, 10 steps with
    JAX's uniforms replayed into the port: the same decisions, x, v
    (1e-9 of their largest entry) and box (1e-12)."""
    import jax
    import jax.numpy as jnp

    import atomsmm_tpu as jamm
    from atomsmm_tpu_torch.integrate import barostat as tbaro

    _, jmodels, _, _ = _jax()
    kw = dict(n_molecules=125, r_cut=0.55, r_switch=0.45, neighbors="blocks")
    baro = dict(pressure=1.0, temperature=300.0, frequency=5)
    js, jx, jb = jmodels.water_system(**kw)
    ts, _, _ = tmodels.water_system(dtype=F64, device="cpu", **kw)
    js = jamm.RESPASystem(js.add_force(jamm.MonteCarloBarostat(**baro)),
                          rcut_in=0.4, rswitch_in=0.3)
    ts = tamm.RESPASystem(ts.add_force(tamm.MonteCarloBarostat(**baro)),
                          rcut_in=0.4, rswitch_in=0.3)
    m = np.asarray(ts.masses)
    v = np.random.RandomState(9).normal(size=(m.size, 3)) * np.sqrt(
        tamm.units.BOLTZMANN * 300.0 / m)[:, None]
    integ = dict(temperature=300.0, time_scale=0.1,
                 degrees_of_freedom=3 * ts.num_particles - 3)
    jctx = jamm.Context(js, jamm.MultipleTimeScaleIntegrator(
        0.002, [2, 2, 1], **integ), jamm.make_state(jx, v=v, box=jb, seed=4))
    tctx = tamm.Context(ts, tamm.MultipleTimeScaleIntegrator(
        0.002, [2, 2, 1], **integ), tamm.make_state(
            torch.as_tensor(np.asarray(jx)), v=torch.as_tensor(v),
            box=torch.as_tensor(np.asarray(jb)), seed=4))
    key, draws = jctx.state.rng, []
    for _ in range(2):
        key, k_dv, k_acc = jax.random.split(key, 3)
        draws.append((float(jax.random.uniform(k_dv, (), jnp.float64, -1.0,
                                               1.0)),
                      float(jax.random.uniform(k_acc, (), jnp.float64))))
    draws = iter(draws)
    tctx._barostat._uniforms = lambda state: tuple(
        torch.tensor(u, dtype=F64) for u in next(draws))
    jctx.step(10)
    tctx.step(10)
    for key in (tbaro.BARO_NATT, tbaro.BARO_NACC):
        assert int(tctx.state.extra[key]) == int(jctx.state.extra[key])
    assert int(tctx.state.extra[tbaro.BARO_NATT]) == 2
    np.testing.assert_allclose(tctx.state.box.numpy(),
                               np.asarray(jctx.state.box), rtol=1e-12)
    for got, want in ((tctx.state.x, jctx.state.x),
                      (tctx.state.v, jctx.state.v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
    assert torch.equal(tctx.state.extra["nbr_near_boxref"], tctx.state.box)


def test_interop_carries_a_jax_block_spec():
    _, jmodels, _, _ = _jax()
    from atomsmm_tpu_torch.interop import describe_reference, \
        system_from_numpy

    js, jx, jb = jmodels.water_system(n_molecules=64, r_cut=0.55,
                                      r_switch=0.45, neighbors="blocks")
    ts = system_from_numpy(describe_reference(js), dtype=F64, device="cpu")
    spec, jspec = ts.neighbors, js.neighbors
    assert isinstance(spec, tblocks.BlockNeighborSpec)
    assert (spec.max_cand, spec.n_blocks, spec.sort_grid) == (
        jspec.max_cand, jspec.n_blocks, jspec.sort_grid)
    assert spec.exclusion_form == "bits"
    tx = torch.as_tensor(np.asarray(jx))
    tb = torch.as_tensor(np.asarray(jb))
    to, tc, _ = tblocks.build_block_lists(spec, tx, tb)
    assert tc.shape == (spec.n_blocks, spec.max_cand)


def test_refusals_raise_input_error(monkeypatch):
    from atomsmm_tpu_torch import forces as tforces

    system, x, box = tmodels.water_system(
        n_molecules=64, r_cut=0.55, r_switch=0.45, neighbors="blocks",
        dtype=F64, device="cpu")
    spec = system.neighbors
    with pytest.raises(InputError, match=r"\(3,\) box"):
        tblocks.make_block_spec(torch.diag(box), x.shape[0], 0.55,
                                device="cpu")
    with pytest.raises(InputError, match=r"\(3,\) box"):
        tblocks.build_block_lists(spec, x, torch.diag(box))
    order, cand, _ = tblocks.build_block_lists(spec, x, box)
    force = system.forces[0]
    with pytest.raises(InputError, match="type-pair table"):
        tblocks.block_pair_energy_forces(
            pf.table_form(force._pair_form()), x, box,
            {**force._per_particle(),
             "lj_type": torch.zeros(x.shape[0], dtype=torch.int32),
             "pair_table": torch.zeros((1, 1, 4), dtype=F64)},
            spec, order, cand, 0.55)
    aux = tnb.make_aux(system, tnb.all_neighbor_extras(system, x, box))
    # under an active spatial mesh (parallel/mesh.py::spatial_mesh)
    monkeypatch.setattr(tforces, "_spatial", lambda: (object(), "dp"))
    for call in (force.energy, force.energy_and_forces, force.virial):
        with pytest.raises(InputError, match="spatial mesh"):
            call(x, box, {}, aux)
    monkeypatch.undo()
    # the tile-pair spec still cannot be attached
    from atomsmm_tpu_torch.ops.tilepair import make_tilepair_spec

    tile = make_tilepair_spec(box, x.shape[0], 0.55, device="cpu")
    with pytest.raises(NotImplementedError, match="TilePairSpec"):
        list(tnb.iter_specs(system.with_neighbors(tile)))


FRAME_CASES = ["argon500", "water64_b32", "water64_b64", "water400",
               "water400_near"]


@pytest.mark.parametrize("name", FRAME_CASES)
def test_block_frame_needs_no_slot_image(name):
    """K4's frame (ops/blocks.py::block_frames; packed_order only permutes
    atoms inside their block): where a home block's frame is exact,
    every atom of the system staged about its centre gives each home atom
    the pairs in range that the minimum image gives, with the same
    displacements, float64. The 64-water box at 32 atoms a block has home
    blocks whose frame is not exact, so that K4's per-slot path runs; 400
    waters at the near form's 0.5 nm have exact ones."""
    if name.startswith("water400"):
        near = name.endswith("near")
        system, x, box = tmodels.water_system(
            n_molecules=400, r_cut=0.5 if near else 0.9,
            r_switch=0.4 if near else 0.8, dtype=F64, device="cpu")
        kw = {}
    else:
        system, x, box = _build(tmodels, name, dtype=F64, device="cpu")
        kw = CASES[name]
    r_cut = system.forces[0].r_cut
    spec = tblocks.make_block_spec(box, x.shape[0], r_cut,
                                   exclusions=system.forces[0].exclusions,
                                   occupancy_from=x, device="cpu", **kw)
    order, _, _ = tblocks.build_block_lists(spec, x, box)
    b, n = spec.block_size, x.shape[0]
    packed = tblocks.packed_order(x, box, order, b).reshape(-1, b)
    assert torch.equal(torch.sort(packed, dim=1).values,
                       torch.sort(order.reshape(-1, b), dim=1).values)
    ids = order.reshape(-1, b)
    ctr, staged, exact = tblocks.block_frames(x, box, ids, r_cut)
    rc2 = r_cut ** 2
    for i in torch.nonzero(exact).reshape(-1).tolist():
        real = ids[i] < n
        hid = ids[i][real].long()
        others = ctr[i] + minimum_image(x - ctr[i], box)
        d_frame = staged[i][real][:, None] - others[None]
        d_ref = minimum_image(x[hid][:, None] - x[None], box)
        in_frame = (d_frame * d_frame).sum(-1) < rc2
        in_ref = (d_ref * d_ref).sum(-1) < rc2
        assert torch.equal(in_frame, in_ref), (name, i)
        assert float((d_frame - d_ref)[in_ref].abs().max()) <= 1e-12
    if name == "water64_b32":
        assert bool((~exact).any())
    if name == "water400_near":
        assert bool(exact.any())


# --------------------------------------------------------------------------
# K4 on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(dev, form_name, exc_form="bits", block_size=64,
               n_molecules=400):
    """(form, x, box, per-particle, spec, order, cand) on the card, float64,
    of water 400 (0.9 nm, or 0.5 nm for the near forms; `n_molecules`
    waters) or, for the softcore forms, phenol in 200 waters; exc_form
    'split' renumbers the waters so that the bitmask cannot hold every
    exclusion."""
    r_cut = 0.5 if form_name.startswith("near") else 0.9
    if form_name.startswith("softcore"):
        system, x, box, solute = tmodels.phenol_in_water(
            n_water=200, dtype=F64, device="cpu")
        sys_ = tamm.SolvationSystem(system, solute)
        force, = (f for f in sys_.forces
                  if isinstance(f, tamm.SoftcoreLennardJonesForce))
        g = {"lambda_vdw": 0.5}
        form = force._pair_form(g, dlambda=form_name.endswith("dlambda"))
        pp = force._per_particle(g)
        exclusions, r_cut = force.exclusions, force.r_cut
    else:
        system, x, box = tmodels.water_system(
            n_molecules=n_molecules, r_cut=0.9, r_switch=0.8,
            method="pme" if "damped" in form_name or form_name == "ewald"
            else "cutoff", dtype=F64, device="cpu")
        full = system.forces[0]
        near = tamm.RESPASystem(system, 0.5, 0.4).forces[1]
        exclusions = full.exclusions
        pp = full._per_particle()
        form = {"rf": lambda: full._pair_form(),
                "ewald": lambda: full._pair_form(),
                "near": lambda: near._pair_form(),
                "near_damped": lambda: near._pair_form(),
                "far": lambda: pf.far_form(
                    full._pair_form(),
                    dataclasses.replace(near, subtract=True)._pair_form()),
                "far_damped": lambda: pf.far_form(
                    full._pair_form(),
                    dataclasses.replace(near, subtract=True)._pair_form()),
                "rf_virial": lambda: pf.virial_form(full._pair_form()),
                "smoothed": lambda: pf.damped_smoothed_form(0.9, 0.8, 3.0),
                }[form_name]()
    if exc_form == "split":
        perm = np.random.default_rng(3).permutation(x.shape[0])
        inv = np.argsort(perm)
        exc = exclusions.numpy()
        exc = np.where(exc >= 0, inv[np.clip(exc, 0, None)], -1)[perm]
        x = x[torch.as_tensor(perm)]
        pp = {k: v[torch.as_tensor(perm)] for k, v in pp.items()}
        exclusions = torch.as_tensor(exc.astype(np.int32))
    spec = tblocks.make_block_spec(box, x.shape[0], r_cut, skin=0.1,
                                   exclusions=exclusions, occupancy_from=x,
                                   block_size=block_size, device="cpu")
    assert spec.exclusion_form == exc_form
    spec = dataclasses.replace(spec, **{
        f.name: getattr(spec, f.name).to(dev)
        for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)})
    x, box = x.to(dev), box.to(dev)
    pp = {k: v.to(dev) for k, v in pp.items()}
    order, cand, overflow = tblocks.build_block_lists(spec, x, box)
    assert not bool(overflow)
    return form, x, box, pp, spec, order, cand


FORMS = ["rf", "ewald", "near", "near_damped", "far", "far_damped",
         "rf_virial", "smoothed", "softcore", "softcore_dlambda"]


def _hold_k4(form, x, box, pp, spec, order, cand, dtype):
    """K4 in `dtype` against the float64 plain twin on the same list: f64
    energy 1e-10 and forces 1e-9 max|F|, f32 1e-4 (the fused far form
    against the unsplit form's max|F|), one launch counted."""
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    ref = tblocks.block_pair_plain(x, pp, order, cand, spec, box, form,
                                   form.r_cut)
    before = pk.LAUNCHES["block_pair"]
    out = tblocks.block_pair_cuda(
        x.to(dtype).contiguous(), {k: v.to(dtype) for k, v in pp.items()},
        order, cand, spec, box.to(dtype), form, form.r_cut)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["block_pair"] == before + 1
    assert out.shape == (x.shape[0] + 1, 4)
    rtol, ftol = (1e-10, 1e-9) if dtype == F64 else (1e-4, 1e-4)
    e, e_ref = float(out[:, 3].double().sum()), float(ref[:, 3].sum())
    # a summed column of both signs (virial, softcore) holds to sum |e_i|
    scale = max(abs(e_ref), float(ref[:, 3].abs().sum())
                if form.virial or form.softcore else abs(e_ref))
    assert abs(e - e_ref) <= rtol * scale
    f_ref = ref[:-1, :3]
    f_scale = float(f_ref.abs().max())
    if dtype == torch.float32 and form.kind == pf.FAR:
        # the fused far form: the scale of the unsplit full force
        full = dataclasses.replace(form, kind=pf.LJ_SW_RF, has_near=False)
        f_scale = float(tblocks.block_pair_plain(
            x, pp, order, cand, spec, box, full, form.r_cut)[:-1, :3]
            .abs().max())
    err = float((out[:-1, :3].double() - f_ref).abs().max())
    assert err <= ftol * max(f_scale, 1e-300), (err, f_scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("exc_form", ["bits", "split"])
@pytest.mark.parametrize("form_name", FORMS)
def test_k4_matches_plain_twin_on_card(cuda, form_name, exc_form, dtype):
    _hold_k4(*_card_case(cuda, form_name, exc_form), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("block_size", [32, 128])
def test_k4_block_sizes_on_card(cuda, block_size, dtype):
    """Blocks of 32 atoms (4 groups a block, 4 lanes a home atom in the
    reach test) and of 128 (16 groups, a lane a home atom, two rounds of
    slots an item; float64's smaller ring, four buffers of 8.3 KB, still
    takes K4 past 48 KB of shared memory), in the damped far form."""
    _hold_k4(*_card_case(cuda, "far_damped", "split", block_size), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_more_items_than_its_grid_on_card(cuda, dtype):
    """3,000 waters at 32 atoms a block: more live items (home block, two
    candidate blocks) than K4's persistent grid can hold at once (its
    thread blocks of 128 threads, at most a full SM's threads each SM), so
    its thread blocks take many items in turn through their rings; and
    K4's count of the (home atom, 8-atom group) pairs it tested is
    positive and below the list's (its groups' boxes cull some)."""
    form, x, box, pp, spec, order, cand = _card_case(
        cuda, "rf", block_size=32, n_molecules=3000)
    props = torch.cuda.get_device_properties(cuda)
    resident = (props.multi_processor_count
                * props.max_threads_per_multi_processor // 128)
    nc = (cand >= 0).sum(dim=1)
    assert int(((nc + 1) // 2).sum()) > resident
    _hold_k4(form, x, box, pp, spec, order, cand, dtype)
    rows = tblocks.block_pair_cuda(x.to(dtype).contiguous(),
                                   {k: v.to(dtype) for k, v in pp.items()},
                                   order, cand, spec, box.to(dtype), form,
                                   form.r_cut)
    pairs = int(nc.sum()) * spec.block_size * (spec.block_size // 8)
    assert 0 < tblocks.k4_tested_pairs(rows) < pairs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_single_candidate_rows_on_card(cuda, dtype):
    """Every row cut to its first candidate, the home block itself: items
    of one candidate, the self block alone."""
    form, x, box, pp, spec, order, cand = _card_case(cuda, "ewald")
    _hold_k4(form, x, box, pp, spec, order, cand[:, :1].contiguous(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_padded_last_block_on_card(cuda, dtype):
    """427 waters, 1,281 atoms: the last of 21 blocks holds one atom and
    63 padding rows."""
    form, x, box, pp, spec, order, cand = _card_case(
        cuda, "near", n_molecules=427)
    assert int((order[-64:] < x.shape[0]).sum()) == 1
    _hold_k4(form, x, box, pp, spec, order, cand, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_per_slot_frames_on_card(cuda, dtype):
    """64 waters at 32 atoms a block (0.55 nm in a 1.24 nm box): home
    blocks whose frame is not exact take the per-slot image."""
    system, x, box = _build(tmodels, "water64_b32", dtype=F64, device="cpu")
    force = system.forces[0]
    spec = tblocks.make_block_spec(box, x.shape[0], force.r_cut,
                                   exclusions=force.exclusions,
                                   occupancy_from=x, device=cuda,
                                   **CASES["water64_b32"])
    x, box = x.to(cuda), box.to(cuda)
    pp = {k: v.to(cuda) for k, v in force._per_particle().items()}
    order, cand, _ = tblocks.build_block_lists(spec, x, box)
    _, _, exact = tblocks.block_frames(x, box, order.reshape(
        -1, spec.block_size), force.r_cut)
    assert bool((~exact).any())
    _hold_k4(force._pair_form(), x, box, pp, spec, order, cand, dtype)


@pytest.mark.cuda
def test_block_path_matches_cell_path_on_card(cuda):
    """The block path (K4) and the cell path (K1) on one state, float64:
    the same pairs inside the cutoff."""
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    outs = []
    for neighbors in ("blocks", True):
        system, x, box = tmodels.water_system(
            n_molecules=1000, neighbors=neighbors, dtype=F64, device=cuda)
        respa = tamm.RESPASystem(system, 0.5, 0.4)
        aux = tnb.make_aux(respa, tnb.all_neighbor_extras(respa, x, box))
        pk.reset_launches()
        outs.append(tforce_fn(respa)(x, box, {}, aux))
        torch.cuda.synchronize()
        key = "block_pair" if neighbors == "blocks" else "half_pair"
        assert pk.LAUNCHES[key] == 2
    (eb, fb), (ec, fc) = outs
    assert float(eb) == pytest.approx(float(ec), rel=1e-10)
    assert float((fb - fc).abs().max()) <= 1e-9 * float(fc.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["undamped", "added"])
@pytest.mark.parametrize("lists", ["cells", "blocks"])
def test_unfusable_far_force_on_card(cuda, kind, lists):
    """The far force whose halves cannot fuse (two sweeps, on K1 or K4)
    on the card against the same force on the CPU, float64."""
    outs = []
    for dev in ("cpu", cuda):
        system, near, far, x, box = _far_variants(tamm, tmodels, "pme",
                                                  device=dev)
        force = far[kind]
        system = system.with_neighbors(
            tblocks.make_block_spec(box, x.shape[0], 0.55,
                                    exclusions=system.forces[0].exclusions,
                                    occupancy_from=x, device=dev)
            if lists == "blocks" else
            tnb.make_neighbor_spec(box, x.shape[0], 0.55,
                                   exclusions=system.forces[0].exclusions,
                                   device=dev))
        aux = tnb.make_aux(system, tnb.all_neighbor_extras(system, x, box))
        outs.append(force.energy_and_forces(x, box, {}, aux))
    (e, f), (eg, fg) = outs
    assert float(eg) == pytest.approx(float(e), rel=1e-10)
    assert float((fg.cpu() - f).abs().max()) <= 1e-10 * float(
        f.abs().max())
