"""SIN(R) and Nosé-Hoover-Langevin RESPA of the port against the JAX package,
float64 on the CPU.

The two packages draw from different random streams, so nothing here
compares a stream. The deterministic cases set friction to 0 (the
Ornstein-Uhlenbeck step then multiplies its draw by 0) and write `v`,
`sinr_v1` and `sinr_v2` into both states from one numpy draw on the
isokinetic constraint; after 3 steps positions, velocities and the
auxiliary velocities agree to rtol 1e-9 (atol 1e-9 x max|value|). The
stochastic cases are twins of tests/test_sinr.py on the port alone: the
constraint m v^2 + Q1 v1^2 / 2 = kT holds at initialisation (< 1e-5) and
after 200 steps (< 5e-4), <m v^2> = kT/2 within 8%, and NHL-R brings argon
from 240 K to the 120 K setpoint.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu.integrate import propagators as jprop
from atomsmm_tpu.integrate import sinr as jsinr
from atomsmm_tpu.utils import replace as jreplace
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.integrate import propagators as tprop
from atomsmm_tpu_torch.integrate import sinr as tsinr
from atomsmm_tpu_torch.utils import replace as treplace

TOL = 1e-9
F64 = torch.float64
TEMP = 120.0
TAU = 0.05
BOLTZMANN = tamm.units.BOLTZMANN
V1, V2 = tsinr.V1, tsinr.V2


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


def _on_constraint(masses, temperature, tau, seed):
    """(v, v1, v2) drawn with numpy on the isokinetic constraint."""
    rs = np.random.RandomState(seed)
    m = np.asarray(masses, np.float64)[:, None]
    kT = BOLTZMANN * temperature
    q = kT * tau ** 2
    phi = rs.uniform(0.0, 2 * np.pi, size=(m.shape[0], 3))
    return (np.sqrt(kT / m) * np.sin(phi), np.sqrt(2 * kT / q) * np.cos(phi),
            np.sqrt(kT / q) * rs.normal(size=phi.shape))


def _residual(masses, state, temperature, tau):
    kT = BOLTZMANN * temperature
    m = np.asarray(masses)[:, None]
    c = m * np.asarray(state.v) ** 2 \
        + 0.5 * kT * tau ** 2 * np.asarray(state.extra[V1]) ** 2
    return np.abs(c / kT - 1.0).max()


def _set_both(jctx, tctx, v, **extra):
    jctx.state = jreplace(jctx.state, v=jnp.array(v)).with_extra(
        **{k: jnp.array(a) for k, a in extra.items()})
    tctx.state = treplace(tctx.state, v=torch.as_tensor(v)).with_extra(
        **{k: torch.as_tensor(a) for k, a in extra.items()})


@pytest.fixture(scope="module")
def argon():
    """Argon 216 split by RESPASystem(0.6, 0.5), as tests/test_sinr.py."""
    js, jx, jb = jmodels.argon_system(n=216, jitter=0.05, seed=1)
    ts, tx, tb = tmodels.argon_system(n=216, jitter=0.05, seed=1, dtype=F64,
                                      device="cpu")
    return ((jamm.RESPASystem(js, rcut_in=0.6, rswitch_in=0.5), jx, jb),
            (tamm.RESPASystem(ts, rcut_in=0.6, rswitch_in=0.5), tx, tb))


@pytest.fixture(scope="module")
def water():
    kw = dict(n_molecules=64, r_cut=0.55, r_switch=0.45, seed=2)
    js, jx, jb = jmodels.water_system(**kw)
    ts, tx, tb = tmodels.water_system(dtype=F64, device="cpu", **kw)
    return ((jamm.RESPASystem(js, rcut_in=0.4, rswitch_in=0.3), jx, jb),
            (tamm.RESPASystem(ts, rcut_in=0.4, rswitch_in=0.3), tx, tb))


def _states(pair, temperature, tau, seed=5):
    (js, jx, jb), (ts, tx, tb) = pair
    v, v1, v2 = _on_constraint(ts.masses, temperature, tau, seed)
    jstate = jamm.make_state(jx, v=v, box=jb, extra={V1: v1, V2: v2})
    tstate = tamm.make_state(tx, v=torch.as_tensor(v), box=tb, extra={
        V1: torch.as_tensor(v1), V2: torch.as_tensor(v2)})
    return jstate, tstate


@pytest.mark.parametrize("cache", [None, "write", "read"])
def test_isokinetic_boost_matches_jax(argon, cache):
    (js, _, _), (ts, _, _) = argon
    jstate, tstate = _states(argon, TEMP, TAU)
    f = np.random.RandomState(2).normal(size=(216, 3)) * 300.0
    jstate = jstate.with_extra(fcache_1=jnp.array(f))
    tstate = tstate.with_extra(fcache_1=torch.as_tensor(f))
    jout = jsinr.IsokineticBoostPropagator({1}, cache, TEMP).apply(
        jprop.StepContext(js, {}, 0.004), jstate, 0.5)
    tout = tsinr.IsokineticBoostPropagator({1}, cache, TEMP).apply(
        tprop.StepContext(ts, {}, 0.004), tstate, 0.5)
    _close(tout.v, jout.v)
    _close(tout.extra[V1], jout.extra[V1])
    _close(tout.extra["fcache_1"], jout.extra["fcache_1"])
    assert _residual(ts.masses, tout, TEMP, TAU) < 1e-12
    if cache == "read":  # the cached forces kicked, and stayed as they were
        assert torch.equal(tout.extra["fcache_1"], torch.as_tensor(f))
        assert not torch.equal(tout.v, tstate.v)


def test_isokinetic_boost_extra_variables(argon):
    _, (ts, tx, tb) = argon
    state = tamm.make_state(tx, box=tb)
    assert tsinr.IsokineticBoostPropagator({1}).extra_variables(ts, state) == {}
    cached = tsinr.IsokineticBoostPropagator({0, 2}, "write").extra_variables(
        ts, state)
    assert list(cached) == ["fcache_0_2"]
    assert cached["fcache_0_2"].shape == (216, 3)


def test_isokinetic_boost_float32_stays_finite_at_the_speed_bound():
    """v = +-sqrt(kT/m) exactly: the clip to +-(1 - 1e-7) is one float32
    step from 1, and artanh of it is finite."""
    n = 64
    masses = torch.full((n,), 12.0)
    system = types.SimpleNamespace(masses=masses)
    kT = BOLTZMANN * 353.0
    sign = torch.where(torch.arange(n * 3).reshape(n, 3) % 2 == 0, 1.0, -1.0)
    v = sign * torch.sqrt(kT / masses)[:, None]
    state = tamm.make_state(torch.zeros(n, 3), v=v, box=torch.ones(3))
    f = 5000.0 * torch.randn(n, 3, generator=torch.Generator().manual_seed(1))
    state = state.with_extra(**{V1: torch.zeros(n, 3), "fcache_0": f})
    assert state.v.dtype == torch.float32
    out = tsinr.IsokineticBoostPropagator({0}, "read", 353.0).apply(
        tprop.StepContext(system, {}, 0.03), state, 0.5)
    assert bool(torch.isfinite(out.v).all())
    assert bool(torch.isfinite(out.extra[V1]).all())
    assert float((masses[:, None] * out.v ** 2).max()) <= kT * (1 + 1e-6)


def test_thermostat_pieces_match_jax(argon):
    (js, _, _), (ts, _, _) = argon
    jstate, tstate = _states(argon, TEMP, TAU)
    jth = jsinr.SINRThermostatPropagator(TEMP, TAU, 0.0)
    tth = tsinr.SINRThermostatPropagator(TEMP, TAU, 0.0)
    assert tth.q1 == jth.q1 and tth.q2 == jth.q2
    jk, tk = jth._kick2(jstate, 0.003), tth._kick2(tstate, 0.003)
    _close(tk.extra[V2], jk.extra[V2])
    assert torch.equal(tk.v, tstate.v)
    js_, ts_ = (jth._scale(jprop.StepContext(js, {}, 0.004), jk, 0.002),
                tth._scale(tprop.StepContext(ts, {}, 0.004), tk, 0.002))
    _close(ts_.v, js_.v)
    _close(ts_.extra[V1], js_.extra[V1])
    assert _residual(ts.masses, ts_, TEMP, TAU) < 1e-12
    # friction 0: the Ornstein-Uhlenbeck step changes nothing
    assert torch.equal(tth._ou(tstate, 0.002).extra[V2], tstate.extra[V2])
    # the whole bath: OU kick scale kick OU
    jb_ = jth.apply(jprop.StepContext(js, {}, 0.004), jstate, 0.5)
    tb_ = tth.apply(tprop.StepContext(ts, {}, 0.004), tstate, 0.5)
    for key in (V1, V2):
        _close(tb_.extra[key], jb_.extra[key])
    _close(tb_.v, jb_.v)


def test_ou_on_v2_has_the_stationary_variance():
    n = 30000
    state = tamm.make_state(torch.zeros(n, 3, dtype=F64),
                            box=torch.ones(3, dtype=F64), seed=3)
    state = state.with_extra(**{V2: torch.zeros(n, 3, dtype=F64)})
    th = tsinr.SINRThermostatPropagator(TEMP, TAU, 500.0)
    out = th._ou(state, 0.1)  # friction x t = 50: a fresh draw
    assert float(out.extra[V2].var()) == pytest.approx(
        BOLTZMANN * TEMP / th.q2, rel=0.02)


def test_sinhc_matches_jax():
    z = np.concatenate([[0.0, 1e-9, 9.9e-5, 1e-4, 1.1e-4],
                        np.linspace(0.001, 30.0, 40)])
    _close(tsinr._sinhc(torch.as_tensor(z)), jsinr._sinhc(jnp.array(z)), 1e-14)


def test_initialize_isokinetic_draws_on_the_constraint():
    masses = torch.as_tensor(np.random.RandomState(0).uniform(1, 40, 20000))
    rng = torch.Generator().manual_seed(6)
    v, v1, v2 = tsinr.initialize_isokinetic(rng, masses, 353.0, 0.05)
    assert v.dtype == v1.dtype == v2.dtype == F64 and v.shape == (20000, 3)
    kT = BOLTZMANN * 353.0
    q = kT * 0.05 ** 2
    c = masses[:, None] * v ** 2 + 0.5 * q * v1 ** 2
    assert float((c / kT - 1).abs().max()) < 1e-12
    # the ellipse angle is uniform: <m v^2> = kT/2, and v2 ~ N(0, kT/Q2)
    assert float((masses[:, None] * v ** 2).mean()) == pytest.approx(
        0.5 * kT, rel=0.01)
    assert float(v2.var()) == pytest.approx(kT / q, rel=0.02)
    assert abs(float(v.mean())) < 0.01 * float(v.std())


def _sinr(m, dt, loops, temperature, tau):
    return m.SIN_R_Integrator(dt, loops, temperature=temperature,
                              time_scale=tau, friction=0.0)


def _nhl(m, dt, loops, temperature, tau):
    return m.NHL_R_Integrator(dt, loops, temperature=temperature,
                              time_scale=tau, friction=0.0)


def _mnh(m, dt, loops, temperature, tau):
    prop = jprop if m is jamm else tprop
    sinr = jsinr if m is jamm else tsinr
    return prop.RespaPropagator(loops, baths={
        0: sinr.MassiveNoseHooverPropagator(temperature, tau)}).integrator(dt)


WHOLE_STEP = {
    "sinr_argon": ("argon", _sinr, 0.004, [2, 1], TEMP, TAU),
    "sinr_water": ("water", _sinr, 0.002, [4, 2, 1], 300.0, 0.02),
    "nhl_r_argon": ("argon", _nhl, 0.004, [2, 1], TEMP, TAU),
    "nhl_r_water": ("water", _nhl, 0.002, [4, 2, 1], 300.0, 0.05),
    "massive_nh_water": ("water", _mnh, 0.002, [2, 2, 1], 300.0, 0.05),
}


@pytest.mark.parametrize("case", sorted(WHOLE_STEP))
def test_whole_step_matches_jax(case, request):
    fixture, build, dt, loops, temperature, tau = WHOLE_STEP[case]
    pair = request.getfixturevalue(fixture)
    (js, jx, jb), (ts, tx, tb) = pair
    jctx = jamm.Context(js, build(jamm, dt, loops, temperature, tau),
                        jamm.make_state(jx, box=jb))
    tctx = tamm.Context(ts, build(tamm, dt, loops, temperature, tau),
                        tamm.make_state(tx, box=tb))
    v, v1, v2 = _on_constraint(ts.masses, temperature, tau, seed=5)
    if build is _sinr:
        _set_both(jctx, tctx, v, **{V1: v1, V2: v2})
        aux = (V1, V2)
    else:  # ordinary velocities; the bath variable starts from the draw too
        aux = ("nhl_v",) if build is _nhl else ("mnh_v",)
        _set_both(jctx, tctx, 0.7 * v, **{aux[0]: 0.1 * v2})
    jctx.step(3)
    tctx.step(3)
    _close(tctx.state.x, jctx.state.x)
    _close(tctx.state.v, jctx.state.v)
    for key in aux + tuple(f"fcache_{g}" for g in range(len(loops))):
        _close(tctx.state.extra[key], jctx.state.extra[key])
    assert float((tctx.state.x - tx).abs().max()) > 1e-4
    if build is _sinr:
        assert _residual(ts.masses, tctx.state, temperature, tau) < 1e-9


def test_sinr_is_built_on_respa_with_the_isokinetic_boost():
    integ = tamm.SIN_R_Integrator(0.03, [4, 10, 1], temperature=353.0,
                                  time_scale=0.05, friction=10.0)
    prop = integ.propagator
    assert type(prop) is tprop.RespaPropagator and prop.loops == [4, 10, 1]
    boost = prop.boost_cls(groups={2}, cache="write")
    assert isinstance(boost, tsinr.IsokineticBoostPropagator)
    assert boost.temperature == 353.0 and boost.cache == "write"
    assert isinstance(prop.baths[0], tsinr.SINRThermostatPropagator)
    assert (integ.temperature, integ.tau, integ.friction) == (353.0, 0.05, 10.0)


# -- twins of tests/test_sinr.py on the port ---------------------------------


@pytest.fixture(scope="module")
def argon_sinr(argon):
    _, (ts, tx, tb) = argon
    integ = tamm.SIN_R_Integrator(0.004, [2, 1], temperature=TEMP,
                                  time_scale=TAU, friction=10.0)
    return tamm.Context(ts, integ, tamm.make_state(tx, box=tb, seed=3)), integ


def test_initialization_on_constraint(argon_sinr):
    ctx, integ = argon_sinr
    assert set(ctx.state.extra) >= {V1, V2, "fcache_0", "fcache_1"}
    assert _residual(ctx.system.masses, ctx.state, TEMP, integ.tau) < 1e-5


def test_constraint_preserved_during_dynamics(argon_sinr):
    ctx, integ = argon_sinr
    ctx.step(200)
    assert _residual(ctx.system.masses, ctx.state, TEMP, integ.tau) < 5e-4


def test_isokinetic_kinetic_energy(argon_sinr):
    """<m v^2> per DOF = kT/2 for L = 1 (half the Maxwell-Boltzmann value)."""
    ctx, _ = argon_sinr
    m = ctx.system.masses[:, None]
    samples = []
    for _ in range(20):
        ctx.step(25)
        samples.append(float((m * ctx.state.v ** 2).mean()))
    np.testing.assert_allclose(np.mean(samples), 0.5 * BOLTZMANN * TEMP,
                               rtol=0.08)


def test_one_seed_gives_one_sinr_trajectory(argon):
    _, (ts, tx, tb) = argon

    def run(seed):
        integ = tamm.SIN_R_Integrator(0.004, [2, 1], temperature=TEMP,
                                      time_scale=TAU, friction=10.0)
        ctx = tamm.Context(ts, integ, tamm.make_state(tx, box=tb, seed=seed))
        return ctx.step(5).state

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a.x, b.x) and torch.equal(a.extra[V2], b.extra[V2])
    assert not torch.equal(a.x, c.x)


def test_nhl_r_controls_temperature(argon):
    _, (ts, tx, tb) = argon
    integ = tamm.NHL_R_Integrator(0.004, [2, 1], temperature=TEMP,
                                  time_scale=TAU, friction=5.0)
    ctx = tamm.Context(ts, integ, tamm.make_state(tx, box=tb, seed=4))
    ctx.set_velocities_to_temperature(2 * TEMP, seed=9)
    ctx.step(300)
    temps = []
    for _ in range(10):
        ctx.step(10)
        temps.append(float(ctx.temperature()))
    assert 0.75 * TEMP < np.mean(temps) < 1.3 * TEMP, temps
