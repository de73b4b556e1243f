"""Replicas and Hamiltonian replica exchange in the port
(atomsmm_tpu_torch/parallel): the twins of tests/test_hrex.py and of
tests/test_parallel.py's replica cases, float64 on the CPU against the
JAX package, and a card case (marker ``cuda``).

The system is tests/test_hrex.py's phenol in 60 waters (SolvationSystem,
0.5 nm), on the port's cell lists. The RNG streams differ (JAX threefry,
torch Philox): trajectories are compared with the bath at friction 0 and
velocities from numpy, and the swap's uniforms are pinned to the JAX
package's draws through HREXSwap._uniforms. Tolerances: energies 1e-10
relative, the swap's delta 1e-10 of beta sum |U|, positions and
velocities 1e-9 relative to their largest entry, grouped against per-step
runs 1e-8 absolute; accept masks and counts exactly.

The JAX package is imported inside the tests that compare with it, so that
the ``cuda`` case runs on a machine that has PyTorch alone:
    pytest tests/test_torch_hrex.py -m cuda -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch.alchemy import coupling_path, solvation_free_energy
from atomsmm_tpu_torch.models import argon_system, phenol_in_water
from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras
from atomsmm_tpu_torch.parallel import (
    HREXSampler,
    hrex_sample_lambda_states,
    make_hrex_swap,
    make_replicated_step,
    replicate_state,
)
from atomsmm_tpu_torch.parallel.hrex import _energy_fn
from atomsmm_tpu_torch.units import BOLTZMANN
from atomsmm_tpu_torch.utils import replace

F64 = torch.float64
TOL = 1e-9
PHENOL = dict(n_water=60, r_cut=0.5, r_switch=0.42, seed=5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these cases run on the card")
    return torch.device("cuda")


def _solvated(device="cpu"):
    system, x, box, solute = phenol_in_water(neighbors=True, dtype=F64,
                                             device=device, **PHENOL)
    return tamm.SolvationSystem(system, solute_atoms=solute), x, box


@pytest.fixture(scope="module")
def solvated():
    return _solvated()


@pytest.fixture(scope="module")
def jax_solvated():
    from atomsmm_tpu import SolvationSystem
    from atomsmm_tpu.models.phenol import phenol_in_water as jphenol

    system, x, box, solute = jphenol(neighbors=True, **PHENOL)
    return SolvationSystem(system, solute_atoms=solute), x, box


def _ladder(k):
    return coupling_path(torch.linspace(0.0, 1.0, k, dtype=F64))


def _close(got, want, tol=TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _states(system, x, box, k, jitter=0.0, v=None, seed=0):
    """k replicas of x on the cell lists: x jittered per replica from
    numpy (the same draws as _jax_states), v (k, N, 3) from numpy."""
    base = tamm.make_state(x, box=box, seed=seed)
    states = replicate_state(base, k, seed)
    xs = np.repeat(x.cpu().numpy()[None], k, axis=0)
    if jitter:
        xs = xs + np.random.RandomState(seed + 1).normal(0, jitter, xs.shape)
    out = []
    for i, s in enumerate(states):
        xi = torch.as_tensor(xs[i], device=x.device)
        s = replace(s, x=xi) if v is None else replace(
            s, x=xi, v=torch.as_tensor(v[i], device=x.device))
        out.append(s.with_extra(**all_neighbor_extras(system, xi, box)))
    return out, xs


def _jax_states(x, box, xs, v=None):
    import jax.numpy as jnp

    from atomsmm_tpu.parallel.replicas import replicate_state as jrep
    from atomsmm_tpu.state import make_state as jmake
    from atomsmm_tpu.utils import replace as jreplace

    states = jrep(jmake(x, box=box), xs.shape[0])
    states = jreplace(states, x=jnp.asarray(xs))
    return states if v is None else jreplace(states, v=jnp.asarray(v))


def _pinned(swap, values):
    swap._uniforms = lambda key, k, like: torch.as_tensor(
        np.array(values), dtype=like.dtype, device=like.device)


def test_identical_states_always_swap(solvated):
    """One Hamiltonian, configurations that differ by a jitter: delta = 0
    up to rounding, every eligible pair accepts, and the pairwise exchange
    is exact; odd parity leaves rows 0 and 5 alone."""
    solv, x, box = solvated
    states, xs = _states(solv, x, box, 6, jitter=0.005)
    lams = {"lambda_vdw": [1.0] * 6, "lambda_coul": [1.0] * 6}
    swap = make_hrex_swap(solv, 300.0)
    out, acc, att = swap(states, lams, torch.Generator().manual_seed(0), 0)
    assert (att, acc) == (3, 3)
    for a, b in [(0, 1), (2, 3), (4, 5)]:
        np.testing.assert_array_equal(out[a].x.numpy(), xs[b])
        np.testing.assert_array_equal(out[b].x.numpy(), xs[a])
        # the neighbor lists travel with the configuration, the generator
        # stays with the row
        assert out[a].extra["nbr_xref"] is states[b].extra["nbr_xref"]
        assert out[a].rng is states[a].rng
    out2, acc2, att2 = swap(states, lams, torch.Generator().manual_seed(1), 1)
    assert (att2, acc2) == (2, 2)
    np.testing.assert_array_equal(out2[0].x.numpy(), xs[0])
    np.testing.assert_array_equal(out2[5].x.numpy(), xs[5])


def test_hopeless_swaps_rejected(solvated):
    """The solute pushed onto a water in replica 0 (decoupled) against a
    coupled neighbor: beta delta is astronomically positive, no swap."""
    solv, x, box = solvated
    x0 = x.clone()
    x0[0:3] = x[15:18] + 0.01
    states = [s.with_extra(**all_neighbor_extras(solv, xi, box)) for s, xi
              in zip(replicate_state(tamm.make_state(x, box=box), 2),
                     (x0, x))]
    states[0] = replace(states[0], x=x0)
    lams = {"lambda_vdw": [0.0, 1.0], "lambda_coul": [0.0, 1.0]}
    swap = make_hrex_swap(solv, 300.0)
    accepts = 0
    for s in range(5):
        _, acc, att = swap(states, lams, torch.Generator().manual_seed(s), 0)
        assert att == 1
        accepts += acc
    assert accepts == 0


def test_swap_matches_jax(solvated, jax_solvated):
    """The swap's energies and delta against the JAX package's
    make_hrex_swap on the same numpy configurations, and, with the port's
    uniforms pinned to the JAX draws, the same accept mask and the same
    permuted x, v and box, the neighbor extras following x."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.parallel.hrex import _energy_fn as j_energy_fn
    from atomsmm_tpu.parallel.hrex import make_hrex_swap as j_make_swap

    solv, x, box = solvated
    jsolv, jx, jbox = jax_solvated
    k = 4
    # rows 2 and 3 share a Hamiltonian (delta 0, always accepted); row 0
    # holds the solute on a water, hopeless at row 1's lambda
    lams = {"lambda_vdw": [0.0, 0.5, 1.0, 1.0],
            "lambda_coul": [0.0, 0.0, 1.0, 1.0]}
    rs = np.random.RandomState(3)
    v = rs.normal(size=(k,) + tuple(x.shape))
    states, xs = _states(solv, x, box, k, jitter=0.004, v=v)
    xs[0, 0:3] = xs[0, 15:18] + 0.01
    x0 = torch.as_tensor(xs[0])
    states[0] = replace(states[0], x=x0).with_extra(
        **all_neighbor_extras(solv, x0, box))
    jstates = _jax_states(jx, jbox, xs, v)
    jlams = {n: jnp.asarray(val) for n, val in lams.items()}
    swap = make_hrex_swap(solv, 300.0)
    beta = 1.0 / (BOLTZMANN * 300.0)
    j_energy = j_energy_fn(jsolv)
    seen = set()
    for parity in (0, 1):
        pairs, energies, delta = swap.deltas(states, lams, parity)
        want = np.array([[float(j_energy(jnp.asarray(xs[c]), jbox, {},
                                         {n: jlams[n][r] for n in jlams}))
                          for r, c in ((i, i), (i, j), (j, j), (j, i))]
                         for i, j in pairs])
        _close(energies, want, 1e-10)
        want_delta = beta * (want[:, 1] - want[:, 0] + want[:, 3]
                             - want[:, 2])
        np.testing.assert_allclose(
            delta.numpy(), want_delta, rtol=0,
            atol=1e-10 * beta * np.abs(want).sum(axis=1).max())
        for seed in range(4):
            key = jax.random.PRNGKey(seed)
            jout, jacc, jatt = jax.jit(j_make_swap(jsolv, 300.0))(
                jstates, jlams, key, parity)
            _pinned(swap, jax.random.uniform(key, (k,)))
            out, acc, att = swap(states, lams, None, parity)
            assert (acc, att) == (int(jacc), int(jatt))
            for r in range(k):
                np.testing.assert_array_equal(out[r].x.numpy(),
                                              np.asarray(jout.x[r]))
                np.testing.assert_array_equal(out[r].v.numpy(),
                                              np.asarray(jout.v[r]))
                np.testing.assert_array_equal(out[r].box.numpy(),
                                              np.asarray(jout.box[r]))
                assert torch.equal(out[r].extra["nbr_xref"], out[r].x)
            seen.add(tuple(not np.array_equal(out[i].x.numpy(), xs[i])
                           for i, _ in pairs))
    # the pinned draws took both decisions
    assert any(any(m) for m in seen) and any(not all(m) for m in seen)


def test_tremd_zero_delta_swaps_and_velocity_rescale(solvated):
    """Temperature exchange of identical configurations: delta = 0 at any
    temperature pair, the swap accepts, and the velocities arriving at row
    k are scaled by sqrt(T_k / T_j)."""
    solv, x, box = solvated
    v = np.random.RandomState(1).normal(0, 1.0, (2,) + tuple(x.shape))
    states, _ = _states(solv, x, box, 2, v=v)
    lams = {"lambda_vdw": [1.0, 1.0], "lambda_coul": [1.0, 1.0]}
    swap = make_hrex_swap(solv, torch.tensor([300.0, 450.0]))
    out, acc, att = swap(states, lams, torch.Generator().manual_seed(0), 0)
    assert (att, acc) == (1, 1)
    np.testing.assert_allclose(out[0].v.numpy(), v[1] * np.sqrt(300 / 450),
                               rtol=1e-12)
    np.testing.assert_allclose(out[1].v.numpy(), v[0] * np.sqrt(450 / 300),
                               rtol=1e-12)


def test_replicas_start_with_independent_velocities(solvated):
    solv, x, box = solvated
    sampler = HREXSampler(solv, x, box, {"lambda_vdw": [0.0, 0.5, 1.0]},
                          300.0, dt=0.001, seed=3)
    v = sampler.states
    assert float((v[0].v - v[1].v).abs().max()) > 1e-3
    assert float((v[1].v - v[2].v).abs().max()) > 1e-3
    # distinct generators too
    draws = [torch.rand(3, generator=s.rng, dtype=F64) for s in v]
    assert not torch.equal(draws[0], draws[1])


def test_attempt_swaps_refuses_mid_anneal_globals(solvated):
    solv, x, box = solvated
    lams = {"lambda_vdw": [0.0, 0.5, 1.0]}
    sampler = HREXSampler(solv, x, box, lams, 300.0, dt=0.001, seed=4)
    sampler.run(3, {"lambda_vdw": [0.9, 0.95, 1.0]})
    with pytest.raises(RuntimeError, match="ladder"):
        sampler.attempt_swaps()
    sampler.run(2)
    sampler.attempt_swaps()
    sampler.anneal(4, chunks=2)
    sampler.attempt_swaps()
    assert sampler.swap_attempts == 1 + 1 and sampler._parity == 0


def test_sampler_run_and_swap_match_jax(solvated, jax_solvated):
    """HREXSampler (make_replica_run under it) with grouped updates (K = 4),
    the bath at friction 0 and velocities from numpy: 12 steps of 4
    replicas against the JAX package's sampler, then one attempt with the
    JAX draws pinned: x and v to 1e-9, the same accepts."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.parallel.hrex import HREXSampler as JSampler
    from atomsmm_tpu.utils import replace as jreplace

    solv, x, box = solvated
    jsolv, jx, jbox = jax_solvated
    k = 4
    lams = _ladder(k)
    v = np.random.RandomState(9).normal(size=(k,) + tuple(x.shape)) * \
        np.sqrt(BOLTZMANN * 300.0 / solv.masses.numpy())[None, :, None]
    kw = dict(dt=0.0005, friction=0.0, seed=7, neighbor_update_every=4)
    sampler = HREXSampler(solv, x, box, lams, 300.0, **kw)
    sampler.states = [replace(s, v=torch.as_tensor(v[i]))
                      for i, s in enumerate(sampler.states)]
    jsampler = JSampler(jsolv, jx, jbox,
                        {n: jnp.asarray(val.numpy())
                         for n, val in lams.items()}, 300.0, **kw)
    jsampler.states = jreplace(jsampler.states, v=jnp.asarray(v))
    sampler.run(12)
    jsampler.run(12)
    _close(sampler.positions(), np.asarray(jsampler.states.x))
    _close(torch.stack([s.v for s in sampler.states]),
           np.asarray(jsampler.states.v))
    _, sub = jax.random.split(jsampler._key)
    _pinned(sampler._swap, jax.random.uniform(sub, (k,)))
    sampler.attempt_swaps()
    jsampler.attempt_swaps()
    assert (sampler.swap_attempts, sampler.swap_accepts) == (
        jsampler.swap_attempts, jsampler.swap_accepts)
    _close(sampler.positions(), np.asarray(jsampler.states.x))


def test_grouped_updates_match_every_step(solvated):
    """neighbor_update_every = 4 against 1 over 12 steps: the same pairs,
    the same draws (each row's generator), the same trajectory."""
    solv, x, box = solvated
    runs = {}
    for k_upd in (1, 4):
        s = HREXSampler(solv, x, box, _ladder(4), 300.0, dt=0.0005, seed=7,
                        neighbor_update_every=k_upd)
        s.run(12)
        runs[k_upd] = s.positions().numpy()
    np.testing.assert_allclose(runs[1], runs[4], atol=1e-8)


def test_grouped_updates_staleness_guard_trips(solvated):
    """A skin of ~0 trips the sticky staleness flag inside a grouped run
    and run() raises."""
    solv, x, box = solvated
    tiny = dataclasses.replace(solv, neighbors=dataclasses.replace(
        solv.neighbors, skin=1e-5))
    s = HREXSampler(tiny, x, box, _ladder(4), 300.0, dt=0.001, seed=7,
                    neighbor_update_every=6)
    with pytest.raises(RuntimeError, match="staleness"):
        s.run(12)


def _argon_nve(n=64):
    system, x, box = argon_system(n=n, jitter=0.05, seed=1, r_cut=0.5,
                                  r_switch=0.4, dtype=F64, device="cpu")
    integ = tamm.VelocityVerletIntegrator(0.002)
    state = integ.initialize(system, tamm.make_state(x, box=box, seed=0))
    from atomsmm_tpu_torch.context import refresh_force_caches

    return integ.make_step(), system, refresh_force_caches(system, state, {})


def test_replicated_step_matches_single():
    """NVE replicas equal one single-box run (the port without a mesh, the
    JAX package on its 8-device CPU mesh)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from atomsmm_tpu import VelocityVerletIntegrator as JVV
    from atomsmm_tpu.context import refresh_force_caches as jrefresh
    from atomsmm_tpu.models import argon_system as jargon
    from atomsmm_tpu.parallel import make_replicated_step as jmake
    from atomsmm_tpu.parallel import replicate_state as jrep
    from atomsmm_tpu.state import make_state as jmake_state

    step, system, state = _argon_nve()
    run = make_replicated_step(step)
    states = replicate_state(state, 8)
    single = state
    for _ in range(5):
        states = run(system, states, {})
        single = step(system, single, {})
    for s in states:
        assert torch.equal(s.x, single.x) and torch.equal(s.v, single.v)

    js, jx, jb = jargon(n=64, jitter=0.05, seed=1, r_cut=0.5, r_switch=0.4)
    jinteg = JVV(0.002)
    jstate = jrefresh(js, jinteg.initialize(js, jmake_state(jx, box=jb)), {})
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    sharding = NamedSharding(mesh, P("dp"))
    jstates = jax.tree.map(lambda a: jax.device_put(a, sharding),
                           jrep(jstate, 8))
    jrun = jax.jit(jmake(jinteg.make_step(), mesh))
    for _ in range(5):
        jstates = jrun(js, jstates, {})
    for k in range(8):
        _close(states[k].x, np.asarray(jstates.x[k]), 1e-12)


def test_replicas_diverge_with_stochastic_dynamics():
    """Each replica has its own generator: an OU bath decorrelates them."""
    system, x, box = argon_system(n=64, jitter=0.05, seed=1, r_cut=0.5,
                                  r_switch=0.4, dtype=F64, device="cpu")
    integ = tamm.GlobalThermostatIntegrator(
        0.002, tamm.OrnsteinUhlenbeckPropagator(120.0, 5.0))
    state = integ.initialize(system, tamm.make_state(x, box=box, seed=0))
    from atomsmm_tpu_torch.context import refresh_force_caches

    state = refresh_force_caches(system, state, {})
    states = replicate_state(state, 4)
    run = make_replicated_step(integ.make_step())
    for _ in range(20):
        states = run(system, states, {})
    assert not torch.allclose(states[0].v, states[1].v)
    assert not torch.allclose(states[1].v, states[2].v)


def test_parallel_sampling_without_exchange(solvated):
    """swap_every = 0: the (xs, n_k) contract with no swap statistics."""
    solv, x, box = solvated
    xs, n_k, info = hrex_sample_lambda_states(
        solv, x, box, {"lambda_vdw": [1.0, 0.5], "lambda_coul": [1.0, 0.5]},
        300.0, dt=0.001, n_equil=4, n_samples=3, sample_interval=2,
        swap_every=0, seed=2)
    assert tuple(xs.shape) == (6, x.shape[0], 3)
    assert n_k.tolist() == [3, 3]
    assert info["swap_attempts"] == 0
    assert bool(torch.isfinite(xs).all())


def test_solvation_free_energy_hrex_returns_swap_fields(solvated):
    """solvation_free_energy(hrex=True) samples through the replicas and
    returns the swap statistics beside MBAR and TI."""
    solv, x, box = solvated
    out = solvation_free_energy(solv, x, box, [0.0, 1.0], 300.0, hrex=True,
                                swap_every=1, n_blocks=2, dt=0.001,
                                n_equil=4, n_samples=2, sample_interval=2,
                                seed=1)
    # one attempt after the equilibration and one per sample, parity
    # alternating: (0, 1) is the only pair, eligible at parity 0
    assert out["swap_attempts"] == 2
    assert 0.0 <= out["swap_acceptance"] <= 1.0
    assert np.isfinite(out["dg_mbar"]) and np.isfinite(out["dg_ti"])
    assert out["n_samples_total"] == 4


def test_mesh_raises(solvated):
    solv, x, box = solvated
    step, _, _ = _argon_nve()
    lams = {"lambda_vdw": [0.0, 1.0]}
    for call in (
            lambda: make_replicated_step(step, mesh=object()),
            lambda: HREXSampler(solv, x, box, lams, 300.0, mesh=object()),
            lambda: hrex_sample_lambda_states(solv, x, box, lams, 300.0,
                                              mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP item 14b"):
            call()


@pytest.mark.slow
def test_acceptance_monotone_in_ladder_spacing(solvated):
    """A tight ladder accepts more than a wide one."""
    solv, x, box = solvated
    tight = {"lambda_vdw": [1.0, 0.97, 0.94, 0.91],
             "lambda_coul": [1.0, 0.97, 0.94, 0.91]}
    wide = {"lambda_vdw": [1.0, 0.6, 0.25, 0.0],
            "lambda_coul": [1.0, 0.6, 0.25, 0.0]}

    def rate(lams, seed):
        sampler = HREXSampler(solv, x, box, lams, 300.0, dt=0.001, seed=seed)
        sampler.run(150)
        for _ in range(12):
            sampler.run(25)
            sampler.attempt_swaps()
        return sampler.acceptance_rate

    r_tight, r_wide = rate(tight, 1), rate(wide, 2)
    assert 0.0 <= r_wide <= 1.0 and 0.0 <= r_tight <= 1.0
    assert r_tight > r_wide, (r_tight, r_wide)
    assert r_tight > 0.5


@pytest.mark.slow
def test_combined_hamiltonian_temperature_ladder(solvated):
    solv, x, box = solvated
    lams = {"lambda_vdw": [1.0, 0.95, 0.9, 0.85],
            "lambda_coul": [1.0, 0.95, 0.9, 0.85]}
    sampler = HREXSampler(solv, x, box, lams, 300.0, dt=0.001, friction=10.0,
                          seed=5, temperatures=[300.0, 320.0, 341.0, 364.0])
    sampler.run(100)
    for _ in range(6):
        sampler.run(20)
        sampler.attempt_swaps()
    assert sampler.swap_attempts == 2 + 1 + 2 + 1 + 2 + 1
    assert 0.0 <= sampler.acceptance_rate <= 1.0
    assert bool(torch.isfinite(sampler.positions()).all())


@pytest.mark.slow
def test_tremd_rows_hold_their_setpoints():
    """Pure T-REMD on argon 216 over a 4-rung ladder: each row holds its
    bath's setpoint while configurations migrate, and neighbors exchange."""
    system, x, box = argon_system(n=216, jitter=0.1, seed=4, neighbors=True,
                                  dtype=F64, device="cpu")
    temps = [100.0, 115.0, 132.0, 152.0]
    sampler = HREXSampler(system, x, box, {}, 100.0, dt=0.002, friction=10.0,
                          seed=7, temperatures=temps)
    sampler.run(400)
    t_rows = np.zeros(4)
    n_samp = 30
    for _ in range(n_samp):
        sampler.run(20)
        sampler.attempt_swaps()
        for k in range(4):
            ke = float(tamm.kinetic_energy(system.masses,
                                           sampler.states[k].v))
            t_rows[k] += 2.0 * ke / (3 * 216 * BOLTZMANN)
    t_rows /= n_samp
    assert sampler.swap_accepts > 0
    assert sampler.acceptance_rate < 1.0
    for k in range(4):
        assert abs(t_rows[k] - temps[k]) < 0.12 * temps[k], (k, t_rows)
    assert np.all(np.diff(t_rows) > 0), t_rows


@pytest.mark.slow
def test_parallel_dg_matches_sequential(solvated):
    """dG(MBAR) from the replica sampler (hrex=True, one card: the JAX
    package's case runs it on its 8-device mesh) statistically matches the
    sequential single-Context path."""
    solv, x, box = solvated
    schedule = torch.linspace(0.0, 1.0, 8, dtype=F64)
    kw = dict(dt=0.001, n_equil=150, n_samples=24, sample_interval=20)
    seq = solvation_free_energy(solv, x, box, schedule, 300.0, seed=4, **kw)
    par = solvation_free_energy(solv, x, box, schedule, 300.0, hrex=True,
                                seed=9, **kw)
    dg_s, dg_p = seq["dg_mbar"], par["dg_mbar"]
    assert np.isfinite(dg_p)
    assert 0.0 <= par["swap_acceptance"] <= 1.0
    joint = np.hypot(seq["err_mbar"], par["err_mbar"])
    assert abs(dg_s - dg_p) < 4.0 * joint + 0.2 * abs(dg_s), (dg_s, dg_p)


@pytest.mark.cuda
def test_replica_batch_on_the_card_matches_the_cpu(cuda):
    """2 replicas, float64, friction 0 and velocities from numpy, grouped
    updates (K = 2), 6 steps and one attempt with pinned uniforms: the card
    against the CPU, x and v to 1e-9, the swap energies to 1e-10, the same
    accepts."""
    rows = []
    for device in ("cpu", cuda):
        solv, x, box = _solvated(device)
        v = np.random.RandomState(2).normal(size=(2,) + tuple(x.shape)) * \
            np.sqrt(BOLTZMANN * 300.0 / solv.masses.cpu().numpy())[
                None, :, None]
        sampler = HREXSampler(solv, x, box, _ladder(2), 300.0, dt=0.0005,
                              friction=0.0, seed=3, neighbor_update_every=2)
        sampler.states = [replace(s, v=torch.as_tensor(v[i], device=x.device))
                          for i, s in enumerate(sampler.states)]
        sampler.run(6)
        _, energies, _ = sampler._swap.deltas(
            sampler.states, sampler._globals(sampler.lambdas), 0)
        _pinned(sampler._swap, [0.3, 0.7])
        sampler.attempt_swaps()
        rows.append((sampler.positions().cpu(),
                     torch.stack([s.v for s in sampler.states]).cpu(),
                     energies.cpu(), sampler.swap_accepts))
    (x_c, v_c, e_c, a_c), (x_g, v_g, e_g, a_g) = rows
    _close(x_g, x_c.numpy())
    _close(v_g, v_c.numpy())
    _close(e_g, e_c.numpy(), 1e-10)
    assert a_g == a_c


def test_energy_fn_is_the_potential(solvated):
    """_energy_fn evaluates the potential on the replica's own lists."""
    solv, x, box = solvated
    e = _energy_fn(solv)(x, box, all_neighbor_extras(solv, x, box),
                         {"lambda_vdw": 0.5, "lambda_coul": 0.0})
    want = tamm.potential_energy(solv, x, box, {"lambda_vdw": 0.5,
                                                "lambda_coul": 0.0})
    _close(e, float(want), 1e-10)
