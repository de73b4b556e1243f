"""Constraints and rigid water in the port against the JAX package, float64
on the CPU: SETTLE (ops/settle.py), Jacobi SHAKE/RATTLE
(ops/constraints.py), the constraint partition, the rigid TIP3P and
TIP4P/Ew builders, hydrogen mass repartitioning and the degrees of
freedom, then short trajectories through Context.step.

Inputs are made from seeds with numpy and fed to both packages. The
projections agree to rtol 1e-12 (the same arithmetic in the same order);
the builders' arrays and the partition exactly; HMR's masses and SETTLE
triangle to 1e-12. Trajectories (x and v) agree to 1e-9 relative to their
largest entry: the JAX side runs its dense pair path, the port its cell
lists through the plain twins of K1 and K2. The NPT case replays JAX's
barostat uniforms into the port through `_uniforms`, as
tests/test_torch_barostat.py does, and holds the SETTLE geometry to 1e-10.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu.integrate.propagators import (
    NoseHooverChainPropagator as JaxNHC,
)
from atomsmm_tpu.ops import constraints as jcons
from atomsmm_tpu.ops import settle as jsettle
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.integrate import barostat as tbaro
from atomsmm_tpu_torch.integrate.propagators import NoseHooverChainPropagator
from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy
from atomsmm_tpu_torch.ops import constraints as tcons
from atomsmm_tpu_torch.ops import settle as tsettle
from atomsmm_tpu_torch.utils import InputError

F64 = torch.float64
TRAJ_TOL = 1e-9
OP_TOL = 1e-12
R_OH = tmodels.water.TIP3P_R_OH
THETA = tmodels.water.TIP3P_THETA


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small systems stepped a few times: intra-op threads only contend
    with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _random_waters(m, seed, spread=0.6):
    """(x0 on the manifold, masses, triplets, pairs, d0) for m randomly
    placed rigid TIP3P waters, as numpy arrays."""
    rs = np.random.RandomState(seed)
    mol = np.stack([np.zeros(3),
                    [R_OH * np.sin(THETA / 2), R_OH * np.cos(THETA / 2), 0],
                    [-R_OH * np.sin(THETA / 2), R_OH * np.cos(THETA / 2), 0]])
    rot = tmodels.water._random_rotations(m, rs)
    x = (np.einsum("mij,aj->mai", rot, mol)
         + rs.uniform(0, spread * m ** (1 / 3), (m, 1, 3))).reshape(-1, 3)
    masses = np.tile([tmodels.water.MASS_O, tmodels.water.MASS_H,
                      tmodels.water.MASS_H], m)
    o = 3 * np.arange(m)
    pairs = np.concatenate([np.stack([o, o + 1], 1), np.stack([o, o + 2], 1),
                            np.stack([o + 1, o + 2], 1)])
    d_hh = 2 * R_OH * np.sin(THETA / 2)
    d0 = np.concatenate([np.full(m, R_OH), np.full(m, R_OH), np.full(m, d_hh)])
    return x, masses, np.stack([o, o + 1, o + 2], 1), pairs, d0


def _settle_sets(m, seed):
    x, masses, tri, pairs, d0 = _random_waters(m, seed)
    d_hh = 2 * R_OH * np.sin(THETA / 2)
    js = jsettle.make_settle_set(tri.astype(np.int32), R_OH, d_hh,
                                 jnp.asarray(masses))
    ts = tsettle.make_settle_set(tri, R_OH, d_hh, torch.as_tensor(masses))
    return x, masses, js, ts


@pytest.mark.parametrize("m,seed,step", [(48, 1, 0.01), (16, 7, 0.015)],
                         ids=["2fs", "large_rotation"])
def test_settle_positions_match_jax(m, seed, step):
    x0, masses, js, ts = _settle_sets(m, seed)
    x1 = x0 + np.random.RandomState(seed + 1).normal(0, step, x0.shape)
    want = jsettle.settle_positions(js, jnp.asarray(x1), jnp.asarray(x0),
                                    jnp.asarray(masses))
    got = tsettle.settle_positions(ts, torch.as_tensor(x1),
                                   torch.as_tensor(x0),
                                   torch.as_tensor(masses))
    _close(got, want, OP_TOL)
    assert float(tsettle.settle_residual(ts, got)) < 1e-12
    np.testing.assert_allclose(float(tsettle.settle_residual(
        ts, torch.as_tensor(x1))), float(jsettle.settle_residual(
            js, jnp.asarray(x1))), rtol=OP_TOL)


def test_settle_velocities_match_jax():
    x0, masses, js, ts = _settle_sets(24, 5)
    v = np.random.RandomState(6).normal(0, 1.0, x0.shape)
    want = jsettle.settle_velocities(js, jnp.asarray(x0), jnp.asarray(v),
                                     jnp.asarray(masses))
    got = tsettle.settle_velocities(ts, torch.as_tensor(x0),
                                    torch.as_tensor(v),
                                    torch.as_tensor(masses))
    _close(got, want, OP_TOL)


def test_shake_and_rattle_match_jax():
    x0, masses, _, pairs, d0 = _random_waters(24, 3)
    rs = np.random.RandomState(4)
    x1 = x0 + rs.normal(0, 0.008, x0.shape)
    v = rs.normal(0, 1.0, x0.shape)
    jc = jcons.ConstraintSet(pairs=jnp.asarray(pairs, jnp.int32),
                             d0=jnp.asarray(d0))
    tc = tcons.ConstraintSet(pairs=torch.as_tensor(pairs),
                             d0=torch.as_tensor(d0))
    assert tc.pairs.dtype == torch.int64
    inv_m = 1.0 / masses
    for sweeps in (7, 60):
        want = jcons.shake_positions(jc, jnp.asarray(x1), jnp.asarray(x0),
                                     jnp.asarray(inv_m), sweeps=sweeps)
        got = tcons.shake_positions(tc, torch.as_tensor(x1),
                                    torch.as_tensor(x0),
                                    torch.as_tensor(inv_m), sweeps=sweeps)
        _close(got, want, OP_TOL)
        np.testing.assert_allclose(
            float(tcons.constraint_residual(tc, got)),
            float(jcons.constraint_residual(jc, want)), rtol=1e-6,
            atol=1e-15)
        want = jcons.rattle_velocities(jc, jnp.asarray(x0), jnp.asarray(v),
                                       jnp.asarray(inv_m), sweeps=sweeps)
        got = tcons.rattle_velocities(tc, torch.as_tensor(x0),
                                      torch.as_tensor(v),
                                      torch.as_tensor(inv_m), sweeps=sweeps)
        _close(got, want, OP_TOL)
    # 60 Jacobi sweeps (the default) reach ~1e-8 relative on a water box
    assert float(tcons.constraint_residual(
        tc, tcons.shake_positions(tc, torch.as_tensor(x1),
                                  torch.as_tensor(x0),
                                  torch.as_tensor(inv_m)))) < 1e-7


def _partition_pair(pairs, d0, masses):
    """(JAX result, port result) of partition_constraints as numpy dicts."""

    def as_dict(res, host):
        ss, rest = res
        out = {}
        if ss is not None:
            out.update(triplets=host(ss.triplets).astype(np.int64),
                       ra=host(ss.ra), rb=host(ss.rb), rc=host(ss.rc))
        if rest is not None:
            out.update(pairs=host(rest.pairs).astype(np.int64),
                       d0=host(rest.d0))
        return out

    j = jsettle.partition_constraints(
        jcons.ConstraintSet(pairs=jnp.asarray(pairs, jnp.int32),
                            d0=jnp.asarray(d0, jnp.float64)),
        jnp.asarray(masses, jnp.float64))
    t = tsettle.partition_constraints(
        tcons.ConstraintSet(pairs=torch.as_tensor(np.asarray(pairs)),
                            d0=torch.as_tensor(d0, dtype=F64)),
        torch.as_tensor(masses, dtype=F64))
    return as_dict(j, np.asarray), as_dict(t, lambda a: a.numpy())


_, _MW, _, _PW, _DW = _random_waters(5, 9)
PARTITIONS = {
    "water": (_PW, _DW, _MW),
    "chain": ([[0, 1], [1, 2], [2, 3]], [0.1, 0.1, 0.1], np.ones(4)),
    "scalene": ([[0, 1], [1, 2], [2, 0]], [0.10, 0.11, 0.12], np.ones(3)),
    "mixed": (np.concatenate([_PW, 15 + np.array([[0, 1], [1, 2], [2, 3]])]),
              np.concatenate([_DW, [0.1, 0.1, 0.1]]),
              np.concatenate([_MW, np.ones(4)])),
    "linear": ([[0, 1], [0, 2], [1, 2]], [0.116, 0.116, 0.232],
               [12.0, 16.0, 16.0]),
    "impossible": ([[0, 1], [0, 2], [1, 2]], [0.116, 0.116, 0.30],
                   [12.0, 16.0, 16.0]),
    "duplicated_pair": ([[0, 1], [0, 1], [1, 2]], [0.1, 0.1, 0.1],
                        np.ones(3)),
    "near_equal_masses": ([[0, 1], [0, 2], [1, 2]],
                          [0.09572, 0.09572, 0.15139],
                          [15.999, 100.0, 100.0 + 5e-8]),
    "apex_last": ([[2, 0], [2, 1], [0, 1]], [R_OH, R_OH, 0.15139],
                  [1.008, 1.008, 15.9994]),
}


@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_partition_constraints_matches_jax(name):
    want, got = _partition_pair(*PARTITIONS[name])
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert tsettle.partition_constraints(None, torch.ones(3)) == (None, None)


@pytest.mark.parametrize("d_bc,masses,match", [
    (0.232, [12.0, 16.0, 16.0], "non-degenerate"),
    (0.15, [16.0, 1.0, 2.0], "equal satellite masses"),
], ids=["degenerate", "unequal_satellites"])
def test_make_settle_set_raises_as_jax(d_bc, masses, match):
    tri = np.asarray([[0, 1, 2]])
    with pytest.raises(ValueError, match=match):
        jsettle.make_settle_set(tri.astype(np.int32), 0.116, d_bc,
                                np.asarray(masses))
    with pytest.raises(ValueError, match=match):
        tsettle.make_settle_set(tri, 0.116, d_bc, torch.tensor(masses))


def _host_fields(obj):
    """Field name -> numpy array (None kept) of a builder's set or force."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or hasattr(v, "shape"):
            out[f.name] = None if v is None else np.asarray(
                v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


BUILDERS = {
    "tip3p_settle": ("rigid_water_system", dict(n_molecules=27, r_cut=0.4,
                                                r_switch=0.35, seed=3)),
    "tip3p_shake": ("rigid_water_system", dict(n_molecules=27, r_cut=0.4,
                                               r_switch=0.35, seed=3,
                                               analytic=False)),
    "tip3p_pme": ("rigid_water_system", dict(n_molecules=64, r_cut=0.6,
                                             r_switch=0.5, method="pme")),
    "tip4p_ew": ("tip4p_water_system", dict(n_molecules=27, r_cut=0.4,
                                            r_switch=0.35, seed=5)),
    "tip4p_ew_pme": ("tip4p_water_system", dict(n_molecules=64, r_cut=0.6,
                                                r_switch=0.5, method="pme")),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_rigid_builders_match_jax(name):
    builder, kw = BUILDERS[name]
    js, jx, jb = getattr(jmodels, builder)(**kw)
    ts, tx, tb = getattr(tmodels, builder)(dtype=F64, device="cpu", **kw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.masses.numpy(), np.asarray(js.masses))
    np.testing.assert_array_equal(ts.molecule.numpy(), np.asarray(js.molecule))
    assert (ts.num_molecules, ts.num_constraints) == (js.num_molecules,
                                                      js.num_constraints)
    for field in ("constraints", "settle", "virtual_sites"):
        jset, tset = getattr(js, field), getattr(ts, field)
        assert (jset is None) == (tset is None), field
        if tset is not None:
            want, got = _host_fields(jset), _host_fields(tset)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{field}.{key}")
    jf, tf = js.forces[0], ts.forces[0]
    for key in ("charge", "sigma", "epsilon", "exclusions"):
        np.testing.assert_array_equal(getattr(tf, key).numpy(),
                                      np.asarray(getattr(jf, key)))
    assert tf.method == jf.method
    if tf.method == "pme":
        assert tf.ewald_alpha == pytest.approx(float(jf.ewald_alpha),
                                               rel=1e-15)
        assert tuple(tf.grid_shape) == tuple(jf.grid_shape)
    assert tamm.count_degrees_of_freedom(ts) \
        == jamm.count_degrees_of_freedom(js)


def test_degrees_of_freedom():
    m = 27
    kw = dict(n_molecules=m, r_cut=0.4, r_switch=0.35, dtype=F64,
              device="cpu")
    tip3p, _, _ = tmodels.rigid_water_system(**kw)
    tip4p, _, _ = tmodels.tip4p_water_system(**kw)
    # 9m coordinates - 3m constraints - 3 (COM)
    assert tamm.count_degrees_of_freedom(tip3p) == 6 * m - 3
    # 12m coordinates - 3m constraints - 3m virtual rows - 3 (COM)
    assert tamm.count_degrees_of_freedom(tip4p) == 6 * m - 3
    ctx = tamm.Context(tip3p, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(torch.zeros(3 * m, 3, dtype=F64),
                                       box=tip3p.default_box))
    assert ctx.degrees_of_freedom == 6 * m - 3


def _hmr_pair(builder, factor=3.0, **kw):
    kw = dict(n_molecules=64, r_cut=0.55, r_switch=0.5, **kw)
    js, _, _ = getattr(jmodels, builder)(**kw)
    ts, _, _ = getattr(tmodels, builder)(dtype=F64, device="cpu", **kw)
    return (jamm.HydrogenMassRepartitionedSystem(js, factor=factor),
            tamm.HydrogenMassRepartitionedSystem(ts, factor=factor), ts)


@pytest.mark.parametrize("builder", ["rigid_water_system",
                                     "tip4p_water_system"])
def test_hmr_masses_and_triangle_match_jax(builder):
    jh, th, ts = _hmr_pair(builder)
    _close(th.masses, jh.masses, OP_TOL)
    for key in ("ra", "rb", "rc"):
        _close(getattr(th.settle, key), getattr(jh.settle, key), OP_TOL)
    np.testing.assert_array_equal(th.settle.triplets.numpy(),
                                  np.asarray(jh.settle.triplets))
    # total mass kept, geometry kept, the COM split follows the new masses
    assert abs(float(th.masses.sum() - ts.masses.sum())) < 1e-9
    t = th.settle.triplets
    np.testing.assert_allclose(
        (th.masses[t[:, 0]] * th.settle.ra).numpy(),
        ((th.masses[t[:, 1]] + th.masses[t[:, 2]]) * th.settle.rb).numpy(),
        rtol=1e-12)
    assert th.num_constraints == ts.num_constraints
    if ts.virtual_sites is not None:
        assert th.virtual_sites is ts.virtual_sites
        assert bool((th.masses[ts.virtual_sites.sites] == 0).all())


def test_hmr_connectivity_and_target_mass_match_jax():
    kw = dict(n_molecules=27, r_cut=0.4, r_switch=0.35,
              template_bonded=False)
    js, _, _ = jmodels.water_system(**kw)
    ts, _, _ = tmodels.water_system(dtype=F64, device="cpu", **kw)
    for opts in ({"factor": 2.0}, {"target_mass": 4.0}):
        _close(tamm.HydrogenMassRepartitionedSystem(ts, **opts).masses,
               jamm.HydrogenMassRepartitionedSystem(js, **opts).masses,
               OP_TOL)
    kw["template_bonded"] = True
    js, _, _ = jmodels.water_system(**kw)
    ts, _, _ = tmodels.water_system(dtype=F64, device="cpu", **kw)
    o = 3 * np.arange(27)
    bonds = np.concatenate([np.stack([o, o + 1], 1), np.stack([o, o + 2], 1)])
    _close(tamm.HydrogenMassRepartitionedSystem(ts, bonds=bonds).masses,
           jamm.HydrogenMassRepartitionedSystem(js, bonds=bonds).masses,
           OP_TOL)


@pytest.mark.parametrize("opts,match", [
    ({"factor": -1.0}, "positive"),
    ({"target_mass": 0.0}, "positive"),
    ({"factor": 9.0}, "non-positive"),
    ({"bonds": np.array([[1, 2]])}, "no bonded heavy"),
    ({}, "connectivity"),
], ids=["factor", "target_mass", "heavy_too_light", "orphan", "no_bonds"])
def test_hmr_error_paths_match_jax(opts, match):
    builder = "water_system" if match == "connectivity" \
        else "rigid_water_system"
    kw = dict(n_molecules=27, r_cut=0.4, r_switch=0.35)
    js, _, _ = getattr(jmodels, builder)(**kw)
    ts, _, _ = getattr(tmodels, builder)(dtype=F64, device="cpu", **kw)
    with pytest.raises(jamm.InputError, match=match):
        jamm.HydrogenMassRepartitionedSystem(js, **opts)
    with pytest.raises(InputError, match=match):
        tamm.HydrogenMassRepartitionedSystem(ts, **opts)


# -- trajectories ------------------------------------------------------------


def _velocities(masses, temperature, seed):
    m = np.asarray(masses, np.float64)
    safe = np.where(m > 0, m, 1.0)
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) \
        * np.sqrt(tamm.units.BOLTZMANN * temperature / safe)[:, None]
    return np.where(m[:, None] > 0, v, 0.0)


def _nhc(pkg, nhc_cls, system, dt=0.002):
    dof = pkg.count_degrees_of_freedom(system)
    return pkg.GlobalThermostatIntegrator(dt, nhc_cls(300.0, dof, 0.1))


def _run_pair(js, jx, jb, ts, j_integ, t_integ, seed=9, temperature=300.0):
    """The two Contexts, from the JAX builder's positions and one numpy
    velocity draw."""
    v = _velocities(ts.masses, temperature, seed)
    jctx = jamm.Context(js, j_integ, jamm.make_state(jx, v=v, box=jb))
    tctx = tamm.Context(ts, t_integ, tamm.make_state(
        torch.as_tensor(np.array(jx)), v=torch.as_tensor(v),
        box=torch.as_tensor(np.asarray(jb))))
    return jctx, tctx


def _check_traj(jctx, tctx, steps):
    jctx.step(steps)
    tctx.step(steps)
    _close(tctx.state.x, jctx.state.x, TRAJ_TOL)
    _close(tctx.state.v, jctx.state.v, TRAJ_TOL)


TRAJECTORIES = {
    # (builder kwargs, steps): SETTLE on K2's twin (a 2^3 grid)
    "settle_vv_nhc_64": (dict(n_molecules=64, r_cut=0.55, r_switch=0.5,
                              seed=2), 10),
    # the 60-sweep SHAKE/RATTLE path on K1's twin (a 3^3 grid)
    "shake_vv_nhc_27": (dict(n_molecules=27, r_cut=0.3, r_switch=0.25,
                             seed=4, analytic=False), 5),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_rigid_trajectory_matches_jax(name):
    kw, steps = TRAJECTORIES[name]
    js, jx, jb = jmodels.rigid_water_system(**kw)
    ts, _, _ = tmodels.rigid_water_system(neighbors=True, dtype=F64,
                                          device="cpu", **kw)
    if kw.get("analytic", True):
        assert ts.settle is not None and ts.constraints is None
    else:
        assert ts.settle is None and ts.constraints.size == 3 * 27
    jctx, tctx = _run_pair(js, jx, jb, ts, _nhc(jamm, JaxNHC, js),
                           _nhc(tamm, NoseHooverChainPropagator, ts))
    _check_traj(jctx, tctx, steps)
    _close(tctx.conserved_energy(), jctx.conserved_energy(), TRAJ_TOL)
    if ts.settle is not None:
        assert float(tsettle.settle_residual(ts.settle, tctx.state.x)) < 1e-10
    else:
        assert float(tcons.constraint_residual(ts.constraints,
                                               tctx.state.x)) < 1e-8


def test_hmr_respa_trajectory_matches_jax():
    """HMR x3 + RESPASystem(0.45, 0.4) + RESPA [1, 4, 1] at 16 fs + NHC on
    125 waters: group 0 holds no force, every kick projects by SETTLE."""
    kw = dict(n_molecules=125, r_cut=0.62, r_switch=0.55, seed=1)
    js, jx, jb = jmodels.rigid_water_system(**kw)
    ts, _, _ = tmodels.rigid_water_system(neighbors=True, dtype=F64,
                                          device="cpu", **kw)
    js = jamm.RESPASystem(jamm.HydrogenMassRepartitionedSystem(js, 3.0),
                          rcut_in=0.45, rswitch_in=0.4)
    ts = tamm.RESPASystem(tamm.HydrogenMassRepartitionedSystem(ts, 3.0),
                          rcut_in=0.45, rswitch_in=0.4)
    assert sorted({f.group for f in ts.forces}) == [1, 2]
    integ = dict(temperature=300.0, time_scale=0.1,
                 degrees_of_freedom=tamm.count_degrees_of_freedom(ts))
    jctx, tctx = _run_pair(
        js, jx, jb, ts,
        jamm.MultipleTimeScaleIntegrator(0.016, [1, 4, 1], **integ),
        tamm.MultipleTimeScaleIntegrator(0.016, [1, 4, 1], **integ),
        seed=3, temperature=30.0)  # a cool start off the lattice at 16 fs
    _check_traj(jctx, tctx, 5)
    assert float(tsettle.settle_residual(ts.settle, tctx.state.x)) < 1e-10


def test_langevin_middle_friction_zero_matches_jax():
    """The projection after the Ornstein-Uhlenbeck step: at friction 0 the
    draw is multiplied by 0, so both packages take the same steps."""
    kw = dict(n_molecules=64, r_cut=0.55, r_switch=0.5, seed=6)
    js, jx, jb = jmodels.rigid_water_system(**kw)
    ts, _, _ = tmodels.rigid_water_system(neighbors=True, dtype=F64,
                                          device="cpu", **kw)
    jctx, tctx = _run_pair(
        js, jx, jb, ts, jamm.LangevinMiddleIntegrator(0.002, 300.0, 0.0),
        tamm.LangevinMiddleIntegrator(0.002, 300.0, 0.0))
    _check_traj(jctx, tctx, 5)


def _constraint_pairs(system):
    """Every rigid distance of the system as (P, 2) atom indices."""
    if system.settle is not None:
        t = system.settle.triplets
        return torch.cat([t[:, [0, 1]], t[:, [0, 2]], t[:, [1, 2]]])
    return system.constraints.pairs


@pytest.mark.parametrize("builder,kw,tol", [
    ("rigid_water_system", {}, 1e-12),
    ("rigid_water_system", {"analytic": False}, 1e-6),
    ("tip4p_water_system", {}, 1e-12),
], ids=["settle", "rattle", "tip4p_virtual_sites"])
def test_langevin_noise_is_projected(builder, kw, tol):
    """At friction 1/ps the OU step adds noise that leaves the constraint
    tangent space: right after the OU step and after every step, each rigid
    distance has d|r|^2/dt = 2 r . (v_i - v_j) = 0 relative to
    |r| |v_i - v_j| and every virtual site's velocity row is exactly 0.
    SETTLE is closed-form (1e-12); RATTLE's 60 Jacobi sweeps reach ~1e-7
    here, as the JAX package's do. Without the projection the ratio reads
    ~1e-2 (the noise is ~6% of the thermal velocity at 2 fs)."""
    system, x, box = getattr(tmodels, builder)(
        n_molecules=27, r_cut=0.4, r_switch=0.35, seed=3, dtype=F64,
        device="cpu", **kw)
    pairs = _constraint_pairs(system)
    i, j = pairs[:, 0], pairs[:, 1]
    sites = (system.virtual_sites.sites if system.virtual_sites is not None
             else torch.zeros(0, dtype=torch.long))
    assert (builder == "tip4p_water_system") == (sites.numel() > 0)
    ctx = tamm.Context(system, tamm.LangevinMiddleIntegrator(
        0.002, 300.0, friction=1.0), tamm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=4)
    worst = []

    def check(state):
        r = state.x[i] - state.x[j]
        dv = state.v[i] - state.v[j]
        # relative to |r| |v_i - v_j|: a dropped projection reads O(1)
        rate = (r * dv).sum(1).abs() / (r.norm(dim=1) * dv.norm(dim=1))
        worst.append(float(rate.max()))
        assert bool((state.v[sites] == 0).all())

    ou = ctx.integrator.propagator.ou
    ou_apply = ou.apply

    def apply_and_check(c, state, fraction):
        state = ou_apply(c, state, fraction)
        check(state)
        return state

    ou.apply = apply_and_check
    for _ in range(4):
        ctx.step(1)
        check(ctx.state)
    assert len(worst) == 8
    assert max(worst) < tol, worst


@pytest.mark.slow
def test_stored_tip3p30k_energy_matches_jax():
    """Config 6's stored state (bench_data/eq_tip3p30k.npz: 10,000 rigid
    TIP3P waters, 0.9 nm reaction field, the cell lists retuned at safety
    1.03) has one potential energy in both packages, float64, to 1e-12:
    the port's cell path (K1's plain twin on a 7^3 grid) against the JAX
    package's XLA sweep. About a minute and 2 GB on one CPU thread, so it
    sits in the slow tier."""
    import os

    from atomsmm_tpu.ops.neighbors import (
        retune_neighbor_specs as jax_retune,
    )
    from atomsmm_tpu.potential import potential_energy as jax_energy
    from atomsmm_tpu_torch.ops import neighbors as tnb
    from atomsmm_tpu_torch.potential import potential_energy

    d = np.load(os.path.join(os.path.dirname(__file__), "..", "bench_data",
                             "eq_tip3p30k.npz"))
    x, box = d["x"].astype(np.float64), d["box"].astype(np.float64)
    kw = dict(n_molecules=10000, r_cut=0.9, r_switch=0.8, neighbors=True)
    js, _, _ = jmodels.rigid_water_system(dtype=jnp.float64, **kw)
    js = jax_retune(js, x, box, safety=1.03)
    want = float(jax_energy(js, jnp.asarray(x), jnp.asarray(box)))
    ts, _, _ = tmodels.rigid_water_system(dtype=F64, device="cpu", **kw)
    tx, tb = torch.as_tensor(x), torch.as_tensor(box)
    ts = tnb.retune_neighbor_specs(ts, tx, tb, safety=1.03)
    assert ts.neighbors.half_stencil and ts.neighbors.grid == (7, 7, 7)
    with torch.no_grad():
        aux = tnb.make_aux(ts, tnb.all_neighbor_extras(ts, tx, tb))
        got = float(potential_energy(ts, tx, tb, aux=aux))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the stored state's own energy, the start of paths (g1) and (g2)
    assert -14.32 < got / 30000 < -14.30


def _jax_uniforms(key, count):
    """The (u_dv, u_acc) pairs JAX's barostat draws from `key`, in order."""
    import jax

    out = []
    for _ in range(count):
        key, k_dv, k_acc = jax.random.split(key, 3)
        out.append((float(jax.random.uniform(k_dv, (), jnp.float64, -1.0,
                                             1.0)),
                    float(jax.random.uniform(k_acc, (), jnp.float64))))
    return out


def test_npt_settle_trajectory_matches_jax():
    """64 rigid waters, VV + NHC at 2 fs, the barostat every 4 steps, 20
    steps: the same decisions, the same trajectory, and molecular scaling
    keeps the SETTLE geometry."""
    kw = dict(n_molecules=64, r_cut=0.55, r_switch=0.5, seed=2)
    baro = dict(pressure=1.0, temperature=300.0, frequency=4)
    js, jx, jb = jmodels.rigid_water_system(**kw)
    ts, _, _ = tmodels.rigid_water_system(neighbors=True, dtype=F64,
                                          device="cpu", **kw)
    js = js.add_force(jamm.MonteCarloBarostat(**baro))
    ts = ts.add_force(tamm.MonteCarloBarostat(**baro))
    jctx, tctx = _run_pair(js, jx, jb, ts, _nhc(jamm, JaxNHC, js),
                           _nhc(tamm, NoseHooverChainPropagator, ts))
    draws = iter(_jax_uniforms(jctx.state.rng, 5))
    tctx._barostat._uniforms = lambda state: tuple(
        torch.tensor(u, dtype=F64) for u in next(draws))
    _check_traj(jctx, tctx, 20)
    for key in (tbaro.BARO_NATT, tbaro.BARO_NACC):
        assert int(tctx.state.extra[key]) == int(jctx.state.extra[key])
    assert int(tctx.state.extra[tbaro.BARO_NATT]) == 5
    assert int(tctx.state.extra[tbaro.BARO_NACC]) > 0
    np.testing.assert_allclose(tctx.state.box.numpy(),
                               np.asarray(jctx.state.box), rtol=1e-12)
    assert float(tsettle.settle_residual(ts.settle, tctx.state.x)) < 1e-10


def test_interop_carries_a_rigid_system():
    """A JAX rigid system crosses through describe_reference with its
    SettleSet, ConstraintSet and VirtualSiteSet, and steps in the port."""
    for builder, extra in (("rigid_water_system", {"analytic": False}),
                           ("rigid_water_system", {}),
                           ("tip4p_water_system", {})):
        kw = dict(n_molecules=27, r_cut=0.4, r_switch=0.35, **extra)
        js, jx, jb = getattr(jmodels, builder)(**kw)
        ref, _, _ = getattr(tmodels, builder)(dtype=F64, device="cpu", **kw)
        ts = system_from_numpy(describe_reference(js), dtype=F64,
                               device="cpu")
        for field in ("constraints", "settle", "virtual_sites"):
            got, want = getattr(ts, field), getattr(ref, field)
            assert (got is None) == (want is None), field
            if got is not None:
                for key, a in _host_fields(want).items():
                    b = _host_fields(got)[key]
                    assert b.dtype == a.dtype, (field, key)
                    np.testing.assert_array_equal(b, a)
        ctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.001),
                           tamm.make_state(torch.as_tensor(np.asarray(jx)),
                                           box=torch.as_tensor(
                                               np.asarray(jb))))
        ctx.set_velocities_to_temperature(300.0, seed=1)
        ctx.step(3)
        assert bool(torch.isfinite(ctx.state.x).all())
