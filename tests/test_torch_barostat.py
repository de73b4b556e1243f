"""The NPT slice of the port (BASELINE config 5: the MC barostat and a
Context whose box moves) against the JAX package, float64 on the CPU: the
twins of tests/test_barostat.py, plus a deterministic NPT trajectory.

The JAX package draws an attempt's two uniforms from its key stream
(jax.random.split(rng, 3)); the port from the state's torch.Generator,
through MonteCarloBarostatPropagator._uniforms. The trajectory test replays
the JAX stream into the port by replacing `_uniforms` on the Context's
propagator, so that both packages take the same decisions; MTS + NHC draws
nothing else. The JAX side runs its dense path, the port its cell lists
through the plain twins of K1 (a 3^3 far grid with half maps) and K2 (a
2^3 far grid). Tolerances: positions and velocities 1e-9 relative to their
largest entry, the box 1e-12, the attempt and acceptance counts exactly,
molecular scaling 1e-12.
"""
import dataclasses

import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu.integrate import barostat as jbaro
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.integrate import barostat as tbaro
from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pair_kernel as tpk
from atomsmm_tpu_torch.utils import replace as treplace

F64 = torch.float64
TRAJ_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small systems stepped many times: intra-op threads only contend with
    the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _velocities(masses, temperature, seed):
    m = np.asarray(masses)
    return np.random.RandomState(seed).normal(size=(m.size, 3)) * np.sqrt(
        tamm.units.BOLTZMANN * temperature / m)[:, None]


def test_molecular_scale_matches_jax():
    import jax.numpy as jnp

    js, jx, _ = jmodels.water_system(n_molecules=27, r_cut=0.4, r_switch=0.3)
    ts, tx, _ = tmodels.water_system(n_molecules=27, r_cut=0.4, r_switch=0.3,
                                     dtype=F64, device="cpu")
    x = np.asarray(jx) + np.random.RandomState(1).normal(scale=0.01,
                                                         size=jx.shape)
    want = np.asarray(jbaro.molecular_scale(
        jnp.asarray(x), js.molecule, js.num_molecules, js.masses,
        jnp.asarray(1.07)))
    got = tbaro.molecular_scale(torch.as_tensor(x), ts.molecule,
                                ts.num_molecules, ts.masses,
                                torch.tensor(1.07, dtype=F64)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # the geometry of each molecule stays: O-H vectors unchanged
    d0, d1 = x.reshape(-1, 3, 3), got.reshape(-1, 3, 3)
    np.testing.assert_allclose(d1[:, 1] - d1[:, 0], d0[:, 1] - d0[:, 0],
                               atol=1e-12)


def _gas(n, box_l, pressure, temperature, frequency, seed=0):
    rs = np.random.RandomState(3)
    x = torch.as_tensor(rs.uniform(0, box_l, (n, 3)))
    box = torch.full((3,), box_l, dtype=F64)
    system = tamm.System(
        masses=torch.full((n,), 40.0, dtype=F64),
        forces=(tamm.MonteCarloBarostat(pressure=pressure,
                                        temperature=temperature,
                                        frequency=frequency),),
        molecule=torch.arange(n, dtype=torch.int32), default_box=box,
        num_molecules=n)
    return tamm.Context(system, tamm.VelocityVerletIntegrator(0.002),
                        tamm.make_state(x, box=box, seed=seed))


def test_ideal_gas_equation_of_state():
    """<V> = (N + 1) kT / P for ideal-gas MC-NPT (the port alone: its draws
    are not the JAX package's)."""
    n, temp, p_bar = 128, 300.0, 200.0
    kT = tamm.units.BOLTZMANN * temp
    v_expected = (n + 1) * kT / (p_bar / tamm.units.PRESSURE_IN_BAR)
    ctx = _gas(n, v_expected ** (1 / 3), p_bar, temp, 1)
    ctx.set_velocities_to_temperature(temp, seed=1)
    ctx.step(500)  # equilibrate the move size
    vols = []
    for _ in range(60):
        ctx.step(50)
        vols.append(float(torch.prod(ctx.state.box)))
    np.testing.assert_allclose(np.mean(vols), v_expected, rtol=0.1)
    n_att = int(ctx.state.extra[tbaro.BARO_NATT])
    n_acc = int(ctx.state.extra[tbaro.BARO_NACC])
    assert n_att == 3500 and 0 < n_acc <= n_att


def test_attempt_segmentation_matches_jax():
    """Attempts land after every step whose post-increment counter hits
    frequency - 1 (mod frequency), whatever chunks step() is called with,
    as in the JAX package's host segmentation."""
    n, freq = 16, 7
    tctx = _gas(n, 4.0, 1.0, 120.0, freq)
    rs = np.random.RandomState(3)
    jx = rs.uniform(0, 4.0, (n, 3))
    jsys = jamm.System(
        masses=np.full((n,), 40.0),
        forces=(jamm.MonteCarloBarostat(pressure=1.0, temperature=120.0,
                                        frequency=freq),),
        molecule=np.arange(n, dtype=np.int32),
        default_box=np.full((3,), 4.0), num_molecules=n)
    jctx = jamm.Context(jsys, jamm.VelocityVerletIntegrator(0.002),
                        jamm.make_state(jx, box=np.full((3,), 4.0)))
    total = 0
    for chunk in (3, 1, 11, 6, 20, 2, 30):
        tctx.step(chunk)
        jctx.step(chunk)
        total += chunk
        expected = (total + 1) // freq
        assert int(tctx.state.extra[tbaro.BARO_NATT]) == expected \
            == int(jctx.state.extra[jbaro.BARO_NATT]), total
    assert tctx.state.step == total


def _tight_water(capacity_slack):
    """Water 216 at 0.35 nm (a 4^3 grid, so coverage can be lost), jittered
    off its lattice, on its cell list, with the capacity at the measured
    occupancy + slack; the state with buckets, barostat extras and force
    caches."""
    from atomsmm_tpu_torch.context import refresh_force_caches

    s, x, box = tmodels.water_system(n_molecules=216, r_cut=0.35,
                                     r_switch=0.3, neighbors=True, dtype=F64,
                                     device="cpu")
    assert min(s.neighbors.grid) >= 4
    # off the lattice, where scaling moves atoms between cells
    x = x + torch.as_tensor(np.random.RandomState(2).normal(
        scale=0.03, size=tuple(x.shape)))
    occ = tnb._max_cell_occupancy(x, box, s.neighbors.grid)
    s = s.with_neighbors(dataclasses.replace(
        s.neighbors, cell_capacity=occ + capacity_slack))
    baro = tbaro.MonteCarloBarostatPropagator(1.0, 300.0, 1,
                                              initial_dv_fraction=0.75)
    st = tamm.make_state(x, box=box)
    st = st.with_extra(**tnb.all_neighbor_extras(s, st.x, st.box))
    st = st.with_extra(**baro.extra_variables(s, st))
    from atomsmm_tpu_torch.integrate.propagators import StepContext

    return s, baro, refresh_force_caches(s, st, {}), StepContext(s, {}, 0.0)


def _trial_validity(s, st, u_dv):
    """(overflow, undercover) of the trial that u_dv makes, on the host."""
    v0 = float(torch.prod(st.box))
    scale = ((v0 + u_dv * float(st.extra[tbaro.BARO_DV])) / v0) ** (1 / 3)
    x_new = tbaro.molecular_scale(st.x, s.molecule, s.num_molecules,
                                  s.masses, torch.tensor(scale, dtype=F64))
    box_new = st.box * scale
    over = tnb._max_cell_occupancy(x_new, box_new, s.neighbors.grid) \
        > s.neighbors.cell_capacity
    return over, bool(tnb.coverage_deficient(s.neighbors, box_new))


def _attempt_with(baro, ctx, st, u_dv, u_acc=0.0):
    baro._uniforms = lambda state: (torch.tensor(u_dv, dtype=F64),
                                    torch.tensor(u_acc, dtype=F64))
    return baro._attempt(ctx, st)


def test_overflowing_trial_is_rejected_and_flagged():
    """A trial whose bucket overflows is rejected (even with u_acc = 0,
    which accepts any valid move), counted in BARO_NBAD, and marks the
    sticky overflow flag, so that Context.step's replay retunes."""
    s, baro, st, ctx = _tight_water(0)
    u = next(u for u in np.linspace(-0.3, 0.3, 601)
             if _trial_validity(s, st, u) == (True, False))
    out = _attempt_with(baro, ctx, st, float(u))
    assert torch.equal(out.box, st.box) and torch.equal(out.x, st.x)
    assert int(out.extra[tbaro.BARO_NBAD]) == 1
    assert int(out.extra[tbaro.BARO_NACC]) == 0
    assert bool(out.extra[tnb.NBR_OVERFLOW])


def test_undercovering_trial_is_rejected_without_overflow_flag():
    """A trial whose box the stencil no longer covers is rejected and
    counted, and leaves the overflow flags clear (a capacity retune cannot
    fix coverage)."""
    s, baro, st, ctx = _tight_water(40)
    assert _trial_validity(s, st, -1.0) == (False, True)
    out = _attempt_with(baro, ctx, st, -1.0)
    assert torch.equal(out.box, st.box)
    assert int(out.extra[tbaro.BARO_NBAD]) == 1
    assert not any(bool(v) for v in tnb.overflow_flags(out.extra).values())
    # the same move, covered: a valid compression is taken at u_acc = 0
    out = _attempt_with(baro, ctx, st, -0.02)
    assert float(torch.prod(out.box)) < float(torch.prod(st.box))
    assert int(out.extra[tbaro.BARO_NACC]) == 1
    assert int(out.extra[tbaro.BARO_NBAD]) == 0


def _jax_uniforms(key, count):
    """The (u_dv, u_acc) pairs JAX's _attempt draws from `key`, in order."""
    import jax
    import jax.numpy as jnp

    out = []
    for _ in range(count):
        key, k_dv, k_acc = jax.random.split(key, 3)
        out.append((float(jax.random.uniform(k_dv, (), jnp.float64, -1.0,
                                             1.0)),
                    float(jax.random.uniform(k_acc, (), jnp.float64))))
    return out


@pytest.mark.parametrize("r_cut,half", [(0.5, True), (0.6, False)],
                         ids=["K1_twin", "K2_twin"])
def test_npt_trajectory_matches_jax(r_cut, half):
    """216 waters, RESPA [2, 2, 1] + NHC at 2 fs, the barostat every 5
    steps, 20 steps: the same decisions and the same trajectory."""
    kw = dict(n_molecules=216, r_cut=r_cut, r_switch=r_cut - 0.1)
    baro = dict(pressure=1.0, temperature=300.0, frequency=5)
    js, jx, jb = jmodels.water_system(**kw)
    ts, _, _ = tmodels.water_system(neighbors=True, dtype=F64, device="cpu",
                                    **kw)
    js = jamm.RESPASystem(js.add_force(jamm.MonteCarloBarostat(**baro)),
                          rcut_in=0.35, rswitch_in=0.3)
    ts = tamm.RESPASystem(ts.add_force(tamm.MonteCarloBarostat(**baro)),
                          rcut_in=0.35, rswitch_in=0.3)
    # capacities at the measured occupancy: the plain twins test every slot
    ts = tnb.retune_neighbor_specs(ts, torch.as_tensor(np.asarray(jx)),
                                   torch.as_tensor(np.asarray(jb)))
    assert ts.neighbors.half_stencil == half
    v = _velocities(ts.masses, 300.0, seed=9)
    integ = dict(temperature=300.0, time_scale=0.1,
                 degrees_of_freedom=3 * ts.num_particles - 3)
    jctx = jamm.Context(js, jamm.MultipleTimeScaleIntegrator(
        0.002, [2, 2, 1], **integ), jamm.make_state(jx, v=v, box=jb, seed=4))
    tctx = tamm.Context(ts, tamm.MultipleTimeScaleIntegrator(
        0.002, [2, 2, 1], **integ), tamm.make_state(
            torch.as_tensor(np.asarray(jx)), v=torch.as_tensor(v),
            box=torch.as_tensor(np.asarray(jb)), seed=4))
    draws = iter(_jax_uniforms(jctx.state.rng, 4))
    tctx._barostat._uniforms = lambda state: tuple(
        torch.tensor(u, dtype=F64) for u in next(draws))
    jctx.step(20)
    tctx.step(20)
    for key in (tbaro.BARO_NATT, tbaro.BARO_NACC):
        assert int(tctx.state.extra[key]) == int(jctx.state.extra[key])
    n_acc = int(tctx.state.extra[tbaro.BARO_NACC])
    assert int(tctx.state.extra[tbaro.BARO_NATT]) == 4 and 0 < n_acc < 4
    np.testing.assert_allclose(tctx.state.box.numpy(), np.asarray(
        jctx.state.box), rtol=1e-12)
    for got, want in ((tctx.state.x, jctx.state.x),
                      (tctx.state.v, jctx.state.v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL * np.abs(want).max())


def _water_ctx(**kw):
    s, x, box = tmodels.water_system(n_molecules=216, neighbors=True,
                                     dtype=F64, device="cpu", **kw)
    return tamm.Context(s, tamm.VelocityVerletIntegrator(0.001),
                        tamm.make_state(x, box=box))


def test_lost_coverage_raises():
    """A box the stencil no longer covers raises: at set_periodic_box, and
    after step() when the box shrank under the Context (as a barostat
    would move it)."""
    ctx = _water_ctx(r_cut=0.35, r_switch=0.3)
    small = ctx.state.box * 0.7
    with pytest.raises(RuntimeError, match="stencil"):
        ctx.set_periodic_box(small)
    ctx.state = treplace(ctx.state, x=ctx.state.x * 0.7, box=small)
    with pytest.raises(RuntimeError, match="coverage loss"):
        ctx.step(1)


def test_pme_coverage_flag_and_retune_match_jax():
    """A box grown past the PME grid's validity bound raises after step();
    retune_pme gives the JAX package's grid and clears the flag."""
    kw = dict(n_molecules=216, method="pme", r_cut=0.6, r_switch=0.5)
    ctx = _water_ctx(**{k: v for k, v in kw.items() if k != "n_molecules"})
    js, jx, jb = jmodels.water_system(**kw)
    jctx = jamm.Context(js, jamm.VelocityVerletIntegrator(0.001),
                        jamm.make_state(jx, box=jb))
    grown = ctx.state.box * 1.15
    ctx.set_periodic_box(grown)
    ctx.set_positions(ctx.state.x * 1.15)
    with pytest.raises(RuntimeError, match="PME grid coverage loss"):
        ctx.step(1)
    ctx.retune_pme()
    jctx.set_periodic_box(np.asarray(grown))
    jctx.retune_pme()
    assert ctx.system.forces[0].grid_shape == jctx.system.forces[0].grid_shape
    assert ctx.system.forces[0].grid_shape != js.forces[0].grid_shape
    ctx.step(1)  # the flag is clear and stays clear at the new grid


def test_marker_adds_no_kernel_sweep(monkeypatch):
    """A step with the MonteCarloBarostat marker (not yet due) runs exactly
    the sweeps of a step without it."""
    calls = {"n": 0}
    plain = tpk.half_pair_plain

    def counted(*args, **kwargs):
        calls["n"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tpk, "half_pair_plain", counted)
    counts = []
    for marker in (False, True):
        s, x, box = tmodels.water_system(n_molecules=216, r_cut=0.5,
                                         r_switch=0.4, neighbors=True,
                                         dtype=F64, device="cpu")
        if marker:
            s = s.add_force(tamm.MonteCarloBarostat(frequency=25))
        r = tamm.RESPASystem(s, rcut_in=0.35, rswitch_in=0.3)
        ctx = tamm.Context(r, tamm.MultipleTimeScaleIntegrator(
            0.002, [2, 2, 1]), tamm.make_state(x, box=box))
        calls["n"] = 0
        ctx.step(3)
        counts.append(calls["n"])
    assert counts[0] == counts[1] > 0


def test_interop_carries_the_barostat():
    js, _, _ = jmodels.water_system(n_molecules=27, r_cut=0.4, r_switch=0.3)
    js = js.add_force(jamm.MonteCarloBarostat(pressure=2.5, temperature=310.0,
                                              frequency=11))
    ts = system_from_numpy(describe_reference(js), dtype=F64, device="cpu")
    marker = ts.forces[-1]
    assert isinstance(marker, tamm.MonteCarloBarostat)
    assert (marker.pressure, marker.temperature, marker.frequency) == (
        2.5, 310.0, 11)
    assert marker.inert
