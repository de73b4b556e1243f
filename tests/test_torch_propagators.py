"""The propagator algebra, the integrators built on it and the Context
parameter surface of the port against the JAX package, float64 on the CPU.

Deterministic parts: both packages start from the same numpy positions and
velocities, take 5 steps, and must agree on positions, velocities and every
extended variable to rtol 1e-9 (atol 1e-9 x max|value|); `describe()` and
`str(integrator)` must give the JAX package's text. Stochastic parts
(Ornstein-Uhlenbeck, CSVR, Langevin) draw from another stream than JAX's,
so they are held in distribution: the kinetic temperature of argon 216
started at twice the setpoint must come to the setpoint within 10%, and
single applications must give the analytic variance. The dense pair path
carries the forces (216 and 192 atoms), except where the test is about the
neighbor buckets.
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu.integrate import propagators as jprop
from atomsmm_tpu.integrate import sinr as jsinr
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.integrate import propagators as tprop
from atomsmm_tpu_torch.integrate import sinr as tsinr

TOL = 1e-9
F64 = torch.float64
T_SET = 120.0
DOF = 3 * 216 - 3
BOLTZMANN = tamm.units.BOLTZMANN

#: the two packages, as (top-level module, propagators module, sinr module)
JAX = types.SimpleNamespace(amm=jamm, prop=jprop, sinr=jsinr)
TORCH = types.SimpleNamespace(amm=tamm, prop=tprop, sinr=tsinr)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These systems are a few hundred atoms stepped hundreds of times:
    intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _velocities(masses, temperature, seed):
    m = np.asarray(masses, np.float64)
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) \
        * np.sqrt(BOLTZMANN * temperature / m)[:, None]
    return v - (m[:, None] * v).sum(0) / m.sum()


@pytest.fixture(scope="module")
def argon():
    js, jx, jb = jmodels.argon_system(n=216, jitter=0.05, seed=1)
    ts, tx, tb = tmodels.argon_system(n=216, jitter=0.05, seed=1, dtype=F64,
                                      device="cpu")
    return (js, jx, jb), (ts, tx, tb), _velocities(ts.masses, T_SET, 3)


@pytest.fixture(scope="module")
def water():
    kw = dict(n_molecules=64, r_cut=0.55, r_switch=0.45, seed=2)
    js, jx, jb = jmodels.water_system(**kw)
    ts, tx, tb = tmodels.water_system(dtype=F64, device="cpu", **kw)
    js = jamm.RESPASystem(js, rcut_in=0.4, rswitch_in=0.3)
    ts = tamm.RESPASystem(ts, rcut_in=0.4, rswitch_in=0.3)
    return (js, jx, jb), (ts, tx, tb), _velocities(ts.masses, 300.0, 9)


def _contexts(pair, build, extra=None):
    (js, jx, jb), (ts, tx, tb), v = pair
    jctx = jamm.Context(js, build(JAX), jamm.make_state(
        jx, v=v, box=jb, extra=extra))
    textra = {k: torch.as_tensor(np.asarray(a), dtype=F64)
              for k, a in (extra or {}).items()}
    tctx = tamm.Context(ts, build(TORCH), tamm.make_state(
        tx, v=torch.as_tensor(v), box=tb, extra=textra))
    return jctx, tctx


def _same_trajectory(pair, build, steps=5, extra=None):
    jctx, tctx = _contexts(pair, build, extra)
    jctx.step(steps)
    tctx.step(steps)
    js, ts = jctx.state, tctx.state
    _close(ts.x, js.x)
    _close(ts.v, js.v)
    shared = [k for k, a in ts.extra.items()
              if a.is_floating_point() and k in js.extra]
    assert sorted(shared) == sorted(
        k for k in js.extra if np.asarray(js.extra[k]).dtype.kind == "f")
    for k in shared:
        _close(ts.extra[k], js.extra[k])
    assert ts.step == int(js.step) == steps
    return jctx, tctx


def _ke_rate(ctx, s):
    """A state-dependent rate that reads the same in both packages."""
    return 1e-3 * (ctx.masses[:, None] * s.v * s.v).sum()


#: name -> (fixture, builder(package namespace) -> integrator, State.extra)
DETERMINISTIC = {
    "chained_vv_nhc": ("argon", lambda m: m.prop.ChainedPropagator([
        m.prop.VelocityVerletPropagator(),
        m.prop.NoseHooverChainPropagator(T_SET, DOF, 0.1),
    ]).integrator(0.002), None),
    "split_vv_x3": ("argon", lambda m: m.prop.SplitPropagator(
        m.prop.VelocityVerletPropagator(), 3).integrator(0.006), None),
    "trotter_suzuki_uncached": ("argon", lambda m: m.prop.TrotterSuzukiPropagator(
        m.prop.TranslationPropagator(),
        m.prop.BoostPropagator()).integrator(0.002), None),
    "suzuki_yoshida_over_nhc": ("argon", lambda m: m.prop.TrotterSuzukiPropagator(
        m.prop.VelocityVerletPropagator(),
        m.prop.SuzukiYoshidaPropagator(m.prop.NoseHooverChainPropagator(
            T_SET, DOF, 0.1, nsy=1), nsy=7)).integrator(0.002), None),
    "respa_core_vv": ("water", lambda m: m.prop.RespaPropagator(
        [2, 1], core=m.prop.VelocityVerletPropagator({0})).integrator(0.0005),
        None),
    "vv_uncached": ("argon", lambda m: m.prop.VelocityVerletPropagator(
        cached=False).integrator(0.002), None),
    "mts_two_nhc_tags": ("water", lambda m: m.amm.MultipleTimeScaleIntegrator(
        0.001, [2, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=573,
        core=m.prop.VelocityVerletPropagator({2}, cached=False),
        baths={0: m.prop.NoseHooverChainPropagator(
            300.0, 573, 0.05, nchain=3, tag="inner")}), None),
    "generic_boost_and_scaling": ("argon", lambda m: m.prop.ChainedPropagator([
        m.prop.VelocityVerletPropagator(),
        m.prop.GenericScalingPropagator(_ke_rate),
        m.prop.GenericScalingPropagator(lambda ctx, s: 0.25, target="zeta"),
        m.prop.GenericBoostPropagator(lambda ctx, s: -0.5 * s.v),
        m.prop.GenericBoostPropagator(lambda ctx, s: s.v, target="path"),
    ]).integrator(0.002),
        {"zeta": np.full(3, 2.0), "path": np.zeros((216, 3))}),
    "global_thermostat_nhc": ("argon", lambda m: m.amm.GlobalThermostatIntegrator(
        0.002, m.prop.NoseHooverChainPropagator(T_SET, DOF, 0.1)), None),
    "global_thermostat_nve_then_nhc": (
        "argon", lambda m: m.amm.GlobalThermostatIntegrator(
            0.002, m.prop.VelocityVerletPropagator(cached=False),
            m.prop.NoseHooverChainPropagator(T_SET, DOF, 0.1, nchain=4)),
        None),
    "langevin_friction_zero": ("argon", lambda m: m.amm.LangevinMiddleIntegrator(
        0.002, T_SET, friction=0.0), None),
}


@pytest.mark.parametrize("case", sorted(DETERMINISTIC))
def test_trajectory_matches_jax(case, request):
    fixture, build, extra = DETERMINISTIC[case]
    jctx, tctx = _same_trajectory(request.getfixturevalue(fixture), build,
                                  extra=extra)
    _close(tctx.integrator.conserved_extra(tctx.state),
           jctx.integrator.conserved_extra(jctx.state))
    if case == "mts_two_nhc_tags":
        assert {"nhc_v", "nhc_eta", "inner_v", "inner_eta"} <= set(
            tctx.state.extra)
        assert tctx.state.extra["inner_v"].shape == (3,)


def test_propagator_integrator_wraps():
    p = tprop.VelocityVerletPropagator()
    integ = p.integrator(0.002)
    assert isinstance(integ, tamm.PropagatorIntegrator)
    assert integ.propagator is p and integ.dt == 0.002


DESCRIBED = dict(
    {k: v[1] for k, v in DETERMINISTIC.items()},
    langevin=lambda m: m.amm.LangevinMiddleIntegrator(0.002, 300.0, 1.0),
    ou_variable=lambda m: m.prop.OrnsteinUhlenbeckPropagator(
        300.0, 5.0, variable="eta", mass=2.0).integrator(0.001),
    csvr=lambda m: m.amm.GlobalThermostatIntegrator(
        0.002, m.prop.VelocityRescalingPropagator(T_SET, DOF, 0.1)),
    sinr=lambda m: m.amm.SIN_R_Integrator(0.030, [4, 10, 1], temperature=353.0,
                                          time_scale=0.05, friction=10.0),
    nhl_r=lambda m: m.amm.NHL_R_Integrator(0.004, [2, 1], temperature=T_SET,
                                           time_scale=0.05, friction=5.0),
    massive_nh=lambda m: m.sinr.MassiveNoseHooverPropagator(
        300.0, 0.1).integrator(0.001),
    isokinetic_boost=lambda m: m.sinr.IsokineticBoostPropagator(
        {1}, "write", 353.0).integrator(0.001),
    mts_core=lambda m: m.amm.MultipleTimeScaleIntegrator(
        0.004, [4, 2, 1], core=m.prop.VelocityVerletPropagator({0})),
)


@pytest.mark.parametrize("case", sorted(DESCRIBED))
def test_describe_and_str_match_jax(case):
    t_integ, j_integ = DESCRIBED[case](TORCH), DESCRIBED[case](JAX)
    assert t_integ.describe() == j_integ.describe()
    assert str(t_integ) == str(j_integ) == t_integ.describe()


def test_base_describe_and_is_thermostat_markers():
    assert tprop.Propagator().describe(0.5) == jprop.Propagator().describe(0.5)
    for name in ("Propagator", "VelocityVerletPropagator",
                 "NoseHooverChainPropagator", "OrnsteinUhlenbeckPropagator",
                 "VelocityRescalingPropagator", "GenericBoostPropagator",
                 "RespaPropagator"):
        assert getattr(tprop, name).is_thermostat \
            == getattr(jprop, name).is_thermostat, name
    assert tprop.StepContext(None, None, 0.1).kT(300.0) \
        == jprop.StepContext(None, None, 0.1).kT(300.0)
    with pytest.raises(ValueError):
        tprop.SuzukiYoshidaPropagator(tprop.TranslationPropagator(), nsy=5)


def test_global_thermostat_argument_order():
    nhc = tprop.NoseHooverChainPropagator(T_SET, DOF, 0.1)
    vv = tprop.VelocityVerletPropagator()
    with pytest.raises(ValueError, match="stepSize, nve, thermostat"):
        tamm.GlobalThermostatIntegrator(0.002, nhc, vv)
    with pytest.raises(ValueError):
        jamm.GlobalThermostatIntegrator(
            0.002, jprop.NoseHooverChainPropagator(T_SET, DOF, 0.1),
            jprop.VelocityVerletPropagator())
    with pytest.raises(ValueError, match="needs a thermostat"):
        tamm.GlobalThermostatIntegrator(0.002)

    class Tracking(tprop.VelocityVerletPropagator):
        def conserved_extra(self, state):
            return torch.zeros(())

    with pytest.warns(UserWarning, match="argument order"):
        tamm.GlobalThermostatIntegrator(
            0.002, Tracking(), tprop.GenericScalingPropagator(_ke_rate))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        integ = tamm.GlobalThermostatIntegrator(0.002, Tracking(), nhc)
    assert integ.thermostat is nhc


# -- the Context parameter surface ------------------------------------------


@dataclasses.dataclass
class Tether(tamm.forces.Force):
    """E = k sum |x|^2 with k the global parameter `k_tether`."""

    def energy(self, x, box, globals, aux=None):
        return globals["k_tether"] * torch.sum(x * x)


def _tethered(argon, k):
    _, (ts, tx, tb), v = argon
    system = ts.replace_forces(ts.forces + (Tether(group=0),))
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(tx, v=torch.as_tensor(v), box=tb))
    ctx.set_parameter("k_tether", k)
    return ctx


def test_set_parameter_reaches_forces_and_caches(argon):
    ctx = _tethered(argon, 0.0)
    k = ctx.get_parameter("k_tether")
    assert k.shape == () and k.dtype == F64 and k.device.type == "cpu"
    e0 = ctx.get_state().energy_split
    assert float(e0["Tether"]) == 0.0
    ctx.step(2)
    ctx.set_parameter("k_tether", 3.5)
    snap = ctx.get_state()
    want = 3.5 * float((ctx.state.x ** 2).sum())
    assert float(snap.energy_split["Tether"]) == pytest.approx(want, rel=1e-14)
    # the next step must kick with the tether's force: its leading kick
    # reads the cache, which step() refreshes with the parameters of now
    x, v = ctx.state.x.clone(), ctx.state.v.clone()
    ctx.step(1)
    fresh = _tethered(argon, 3.5)
    fresh.set_positions(x)
    fresh.set_velocities(v)
    fresh.step(1)
    assert torch.equal(ctx.state.x, fresh.state.x)
    assert torch.equal(ctx.state.v, fresh.state.v)
    with pytest.raises(KeyError):
        ctx.get_parameter("lambda_vdw")


def test_set_positions_rebuilds_buckets_and_caches():
    kw = dict(n=864, jitter=0.1, neighbors=True, dtype=F64, device="cpu")
    ts, tx, tb = tmodels.argon_system(seed=7, **kw)
    _, x_new, _ = tmodels.argon_system(seed=8, **kw)
    js, jx, jb = jmodels.argon_system(n=864, jitter=0.1, seed=7,
                                      neighbors=True)
    v = _velocities(ts.masses, T_SET, 3)

    def context(x):
        return tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                            tamm.make_state(x, v=torch.as_tensor(v), box=tb))

    ctx, fresh = context(tx), context(x_new)
    ctx.step(2)
    stale = ctx.state.extra["nbr_bucket"].clone()
    ctx.set_positions(x_new.numpy())
    ctx.set_velocities(v)
    assert ctx.state.x.dtype == F64
    # get_state sees buckets of the new positions, not the ones it holds
    snap, want = ctx.get_state(), fresh.get_state()
    assert torch.equal(ctx.state.extra["nbr_bucket"], stale)
    _close(snap.potential_energy, want.potential_energy, 1e-12)
    _close(snap.forces, want.forces, 1e-12)
    # and so does the JAX package after the same call
    jctx = jamm.Context(js, jamm.VelocityVerletIntegrator(0.002),
                        jamm.make_state(jx, v=v, box=jb))
    jctx.step(2)
    jctx.set_positions(x_new.numpy())
    jctx.set_velocities(v)
    _close(snap.potential_energy, jctx.get_state().potential_energy, 1e-10)
    # step() rebuilds the buckets and the force cache before its first kick
    ctx.step(1)
    fresh.step(1)
    jctx.step(1)
    assert torch.equal(ctx.state.x, fresh.state.x)
    assert torch.equal(ctx.state.v, fresh.state.v)
    _close(ctx.state.x, jctx.state.x)
    _close(ctx.state.v, jctx.state.v)


def test_set_periodic_box_checks_coverage():
    # 1,728 atoms: a 4^3 grid, whose reach-1 stencil does not wrap the grid
    ts, tx, tb = tmodels.argon_system(n=1728, jitter=0.1, seed=7,
                                      neighbors=True, dtype=F64, device="cpu")
    assert ts.neighbors.grid == (4, 4, 4)
    ctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(tx, box=tb))
    e0 = float(ctx.get_state(lite=True).potential_energy)
    ctx.set_periodic_box((1.01 * tb).numpy())
    assert torch.equal(ctx.state.box, 1.01 * tb) and ctx.state.box.dtype == F64
    assert float(ctx.get_state(lite=True).potential_energy) != e0
    # a box whose cells are narrower than the cutoff would drop pairs
    grid, r_cut = ts.neighbors.grid, ts.forces[0].r_cut
    small = tb.clone()
    small[0] = 0.98 * r_cut * grid[0]
    with pytest.raises(RuntimeError, match="cover"):
        ctx.set_periodic_box(small)
    with pytest.raises(tamm.InputError, match="minimum-image"):
        ctx.setPeriodicBoxVectors(0.3 * tb)
    assert torch.equal(ctx.state.box, 1.01 * tb)


def test_states_are_row_major_whatever_order_the_arrays_come_in(argon):
    """A numpy array in column order (as bench_data/eq_emim.npz stores its
    positions) must not reach the kernels with its strides."""
    _, (ts, tx, tb), v = argon
    xf, vf = np.asfortranarray(tx.numpy()), np.asfortranarray(v)
    assert not torch.as_tensor(xf).is_contiguous()
    state = tamm.make_state(xf, v=vf, box=tb)
    assert state.x.is_contiguous() and state.v.is_contiguous()
    assert torch.equal(state.x, tx)
    ctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                       tamm.State(x=torch.as_tensor(xf), v=torch.as_tensor(vf),
                                  box=tb, rng=torch.Generator(), step=0,
                                  extra={}))
    assert ctx.state.x.is_contiguous() and ctx.state.v.is_contiguous()
    ctx.set_positions(xf)
    ctx.set_velocities(vf)
    assert ctx.state.x.is_contiguous() and ctx.state.v.is_contiguous()
    assert torch.equal(ctx.state.v, torch.as_tensor(v))


def test_camel_case_aliases(argon):
    ctx = _tethered(argon, 0.0)
    x = ctx.state.x + 0.01
    ctx.setPositions(x)
    assert torch.equal(ctx.state.x, x)
    ctx.setVelocities(np.ones((216, 3)))
    assert float(ctx.state.v.min()) == 1.0
    ctx.setVelocitiesToTemperature(T_SET, 5)
    other = _tethered(argon, 0.0)
    other.set_velocities_to_temperature(T_SET, seed=5)
    assert torch.equal(ctx.state.v, other.state.v)
    ctx.setParameter("k_tether", 2.0)
    assert float(ctx.getParameter("k_tether")) == 2.0
    ctx.setPeriodicBoxVectors(ctx.state.box * 1.5)
    snap = ctx.getState(getEnergy=True, getForces=True)
    assert snap.forces.shape == (216, 3)
    assert float(snap.energy_split["Tether"]) == pytest.approx(
        2.0 * float((x ** 2).sum()))


def test_hijack_force(water):
    (js, _, _), (ts, tx, tb), _ = water
    force, rest = tamm.hijack_force(ts, 1)
    jforce, jrest = jamm.hijack_force(js, 1)
    assert force is ts.forces[1] and len(ts.forces) == len(rest.forces) + 1
    assert [f.name for f in rest.forces] == [f.name for f in jrest.forces]
    assert force.name == jforce.name
    _close(tamm.potential_energy(rest, tx, tb)
           + force.energy(tx, tb, {}), tamm.potential_energy(ts, tx, tb),
           1e-12)


def test_overflow_replay_restores_the_generator():
    """One seed, one trajectory: a run that overflows a tight capacity,
    restores, retunes and replays ends where a run on a roomy spec ends,
    with its generator in the same state."""
    from atomsmm_tpu_torch.ops.neighbors import retune_spec

    ts, tx, tb = tmodels.argon_system(n=864, jitter=0.02, seed=7,
                                      neighbors=True, dtype=F64, device="cpu")
    v = torch.as_tensor(_velocities(ts.masses, 600.0, 3))

    def run(system):
        ctx = tamm.Context(system,
                           tamm.LangevinMiddleIntegrator(0.004, 600.0, 5.0),
                           tamm.make_state(tx, v=v, box=tb, seed=21))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ctx.step(30)
        return ctx, [w for w in caught if "overflow" in str(w.message)]

    roomy, warned = run(ts)
    assert roomy.last_step_passes == 1 and not warned
    # the near-lattice start fills every cell alike: a capacity fitted to it
    # overflows once the fluid melts
    tight_spec = retune_spec(ts.neighbors, tx, tb, safety=1.0)
    assert tight_spec.cell_capacity < ts.neighbors.cell_capacity
    tight, warned = run(ts.with_neighbors(tight_spec))
    assert tight.last_step_passes >= 2 and warned
    assert tight.system.neighbors.cell_capacity > tight_spec.cell_capacity
    assert torch.equal(tight.state.rng.get_state(),
                       roomy.state.rng.get_state())
    _close(tight.state.x, roomy.state.x, 1e-12)
    _close(tight.state.v, roomy.state.v, 1e-12)
    assert tight.state.step == 30


# -- stochastic parts, in distribution --------------------------------------


def test_ou_friction_zero_is_the_identity():
    system = types.SimpleNamespace(masses=torch.rand(50, dtype=F64) + 1.0)
    state = tamm.make_state(torch.zeros(50, 3, dtype=F64),
                            v=torch.randn(50, 3, dtype=F64),
                            box=torch.ones(3, dtype=F64), seed=4)
    state = state.with_extra(eta=torch.randn(7, dtype=F64))
    ctx = tprop.StepContext(system, {}, 0.01)
    out = tprop.OrnsteinUhlenbeckPropagator(300.0, 0.0).apply(ctx, state, 1.0)
    assert torch.equal(out.v, state.v)
    out = tprop.OrnsteinUhlenbeckPropagator(
        300.0, 0.0, variable="eta", mass=3.0).apply(ctx, state, 1.0)
    assert torch.equal(out.extra["eta"], state.extra["eta"])


def test_ou_stationary_variance_and_temperature_global():
    n = 40000
    masses = torch.full((n,), 4.0, dtype=F64)
    system = types.SimpleNamespace(masses=masses)
    state = tamm.make_state(torch.zeros(n, 3, dtype=F64),
                            box=torch.ones(3, dtype=F64), seed=8)
    state = state.with_extra(eta=torch.zeros(n, dtype=F64))
    # friction x t = 50: the old value is forgotten, the new one is a draw
    ctx = tprop.StepContext(system, {"t_bath": torch.tensor(600.0)}, 1.0)
    kT = BOLTZMANN * 300.0
    out = tprop.OrnsteinUhlenbeckPropagator(300.0, 50.0).apply(ctx, state, 1.0)
    assert float(out.v.var()) == pytest.approx(kT / 4.0, rel=0.02)
    out = tprop.OrnsteinUhlenbeckPropagator(
        300.0, 50.0, variable="eta", mass=0.5).apply(ctx, state, 1.0)
    assert float(out.extra["eta"].var()) == pytest.approx(kT / 0.5, rel=0.03)
    assert torch.equal(out.v, state.v)
    out = tprop.OrnsteinUhlenbeckPropagator(
        300.0, 50.0, temperature_global="t_bath").apply(ctx, state, 1.0)
    assert float(out.v.var()) == pytest.approx(2.0 * kT / 4.0, rel=0.02)
    out = tprop.OrnsteinUhlenbeckPropagator(
        300.0, 50.0, temperature_global="absent").apply(ctx, state, 1.0)
    assert float(out.v.var()) == pytest.approx(kT / 4.0, rel=0.02)


def test_csvr_single_application_samples_the_canonical_kinetic_energy():
    """With t >> tau the rescaled kinetic energy is a fresh canonical draw:
    2 KE / kT ~ chi2(dof), mean dof, variance 2 dof."""
    n, dof = 12, 36
    system = types.SimpleNamespace(masses=torch.full((n,), 2.0, dtype=F64))
    v0 = torch.as_tensor(np.random.RandomState(1).normal(size=(n, 3)))
    state = tamm.make_state(torch.zeros(n, 3, dtype=F64), v=v0,
                            box=torch.ones(3, dtype=F64), seed=13)
    ctx = tprop.StepContext(system, {}, 1.0)
    csvr = tprop.VelocityRescalingPropagator(T_SET, dof, 0.01)
    kT = BOLTZMANN * T_SET
    samples = []
    for _ in range(4000):
        out = csvr.apply(ctx, state, 1.0)
        samples.append(float((2.0 * out.v ** 2).sum()) / kT)
    samples = np.asarray(samples)
    assert samples.mean() == pytest.approx(dof, rel=0.02)
    assert samples.var() == pytest.approx(2 * dof, rel=0.12)
    # directions are kept: v is only rescaled
    assert float((out.v / v0).std()) < 1e-12


STOCHASTIC = {
    "langevin_middle": lambda: tamm.LangevinMiddleIntegrator(
        0.004, T_SET, friction=5.0),
    "ou_global": lambda: tamm.GlobalThermostatIntegrator(
        0.004, tprop.OrnsteinUhlenbeckPropagator(T_SET, 5.0)),
    "csvr": lambda: tamm.GlobalThermostatIntegrator(
        0.004, tprop.VelocityRescalingPropagator(T_SET, DOF, 0.05)),
}


@pytest.mark.parametrize("case", sorted(STOCHASTIC))
def test_thermostat_brings_argon_to_the_setpoint(case, argon):
    _, (ts, tx, tb), _ = argon
    ctx = tamm.Context(ts, STOCHASTIC[case](),
                       tamm.make_state(tx, box=tb, seed=11))
    ctx.set_velocities_to_temperature(2 * T_SET, seed=12)
    ctx.step(250)
    temps = []
    for _ in range(30):
        ctx.step(10)
        temps.append(float(ctx.temperature()))
    assert np.isfinite(ctx.state.x.numpy()).all()
    assert np.mean(temps) == pytest.approx(T_SET, rel=0.10), np.mean(temps)
