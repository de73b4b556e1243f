"""The neighbor-update cadence of the port: Context(neighbor_update_every=K),
the staleness guard and the rebuild predicates, against the JAX package,
float64 on the CPU (the twins of the grouped-update cases of
tests/test_neighbors.py).

Both packages start from the same numpy velocities (their RNG streams
differ). The predicates (staleness_flags, needs_rebuild, unhealthy_flags,
effective_skin) are held to the JAX package on the same numpy extras:
booleans equal, the skin to 1e-12. Trajectories: K = 2 against K = 1 and
against the JAX package's K = 2 run, positions to 1e-10 (the sums run in
another order on each side).
"""
import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu.ops import neighbors as jnb
from atomsmm_tpu_torch import context as tcontext
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.ops import neighbors as tnb

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _velocities(masses, temperature, seed):
    m = np.asarray(masses, np.float64)
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) * np.sqrt(
        tamm.units.BOLTZMANN * temperature / m)[:, None]
    return v - (m[:, None] * v).sum(0) / m.sum()


def _argon(n, jitter, seed, **kw):
    ts, tx, tb = tmodels.argon_system(n=n, jitter=jitter, seed=seed,
                                      neighbors=True, dtype=F64,
                                      device="cpu", **kw)
    js, jx, jb = jmodels.argon_system(n=n, jitter=jitter, seed=seed,
                                      neighbors=True, **kw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    return ts, js, tx.numpy(), tb.numpy()


def test_grouped_neighbor_updates_match_per_step():
    """K = 2 against K = 1 and against the JAX package's K = 2 trajectory
    over 31 steps (15 groups and a remainder step); the staleness guard
    stays quiet at 120 K."""
    ts, js, x, box = _argon(216, 0.1, 3)
    v = _velocities(ts.masses, 120.0, 5)
    runs = {}
    for k in (1, 2):
        ctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                           tamm.make_state(torch.as_tensor(x),
                                           v=torch.as_tensor(v),
                                           box=torch.as_tensor(box)),
                           neighbor_update_every=k)
        ctx.step(31)
        runs[k] = ctx
    assert runs[2].neighbor_update_every == 2
    assert not any(runs[2]._flags()["stale"].values())
    jctx = jamm.Context(js, jamm.VelocityVerletIntegrator(0.002),
                        jamm.make_state(x, v=v, box=box),
                        neighbor_update_every=2)
    jctx.step(31)
    for want in (runs[1].state.x.numpy(), np.asarray(jctx.state.x)):
        np.testing.assert_allclose(runs[2].state.x.numpy(), want, atol=1e-10)


def test_staleness_flags_single_atom():
    """N = 1 has no two-displacement bound: the 2 max d fallback."""
    ts, js, x, box = _argon(1, 0.0, 0, r_cut=0.15, r_switch=0.1)
    spec = ts.neighbors
    tx, tb = torch.as_tensor(x), torch.as_tensor(box)
    extra = tnb.neighbor_list_extras(spec, tx, tb)
    assert not bool(tnb.staleness_flags(ts, extra, tx, tb)["nbr_stale"])
    moved = tx + 2.0 * spec.skin
    assert bool(tnb.staleness_flags(ts, extra, moved, tb)["nbr_stale"])
    jextra = jnb.neighbor_list_extras(js.neighbors, x, box)
    assert bool(jnb.staleness_flags(js, jextra, moved.numpy(), box)[
        "nbr_stale"])


def test_staleness_guard_raises():
    """An atom crossing the full skin between grouped updates raises."""
    ts, _, x, box = _argon(216, 0.05, 3)
    ctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(torch.as_tensor(x),
                                       box=torch.as_tensor(box)),
                       neighbor_update_every=8)
    ctx.set_velocities(torch.full_like(ctx.state.v, 100.0))
    with pytest.raises(RuntimeError, match="staleness"):
        ctx.step(8)


def test_coverage_wrap_aware_and_effective_skin():
    """Along a dim where the stencil wraps the whole grid coverage is never
    lost and the skin stays; on a constrained grid the effective skin
    shrinks with the box and reaches 0 at the coverage boundary; each
    against the JAX package."""
    ts, _, _ = tmodels.water_system(n_molecules=64, r_cut=0.5, r_switch=0.4,
                                    neighbors=True, dtype=F64, device="cpu")
    js, _, jbox = jmodels.water_system(n_molecules=64, r_cut=0.5,
                                       r_switch=0.4, neighbors=True)
    spec, box = ts.neighbors, torch.as_tensor(np.asarray(jbox))
    assert max(spec.grid) <= 3
    assert not bool(tnb.coverage_deficient(spec, box * 0.7))
    np.testing.assert_allclose(float(tnb.effective_skin(spec, box * 0.7)),
                               spec.skin, rtol=1e-12)

    ts2, js2, _, box2 = _argon(4096, 0.05, 2)
    spec2, box2 = ts2.neighbors, torch.as_tensor(box2)
    assert min(spec2.grid) >= 4
    r_cut = spec2.r_build - spec2.skin
    w_min = float((box2 / torch.tensor(spec2.grid, dtype=F64)).min())
    s_half = (r_cut + 0.5 * spec2.skin) / (w_min * max(spec2.reach))
    s_edge = 0.95 * r_cut / (w_min * max(spec2.reach))
    for scale in (1.0, s_half, s_edge):
        got = float(tnb.effective_skin(spec2, box2 * scale))
        want = float(jnb.effective_skin(js2.neighbors,
                                        box2.numpy() * scale))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert 0.0 < float(tnb.effective_skin(spec2, box2 * s_half)) < spec2.skin
    assert float(tnb.effective_skin(spec2, box2 * s_edge)) == 0.0
    assert bool(tnb.coverage_deficient(spec2, box2 * s_edge))
    assert bool(jnb.coverage_deficient(js2.neighbors, box2.numpy() * s_edge))


# displacement of every atom as a fraction of the skin, and a box change
MOVES = [(0.0, 1.0), (0.2, 1.0), (0.3, 1.0), (0.45, 1.0), (0.6, 1.0),
         (1.2, 1.0), (0.0, 1.001)]


@pytest.mark.parametrize("fraction,box_scale", MOVES)
def test_predicates_match_jax(fraction, box_scale):
    """staleness_flags and needs_rebuild on the same numpy extras and
    moves: the same booleans as the JAX package. The move is random
    per atom (a few atoms carry the largest displacements)."""
    ts, js, x, box = _argon(216, 0.1, 4)
    tspec = ts.neighbors
    rs = np.random.RandomState(11)
    d = rs.normal(size=x.shape)
    d *= fraction * tspec.skin / np.abs(d).max()
    xm, bm = x + d, box * box_scale
    t_ex = tnb.neighbor_list_extras(tspec, torch.as_tensor(x),
                                    torch.as_tensor(box))
    j_ex = jnb.neighbor_list_extras(js.neighbors, x, box)
    t_stale = tnb.staleness_flags(ts, t_ex, torch.as_tensor(xm),
                                  torch.as_tensor(bm))
    j_stale = jnb.staleness_flags(js, j_ex, xm, bm)
    assert set(t_stale) == set(j_stale) == {"nbr_stale"}
    assert bool(t_stale["nbr_stale"]) == bool(j_stale["nbr_stale"])
    t_need = tnb.needs_rebuild(tspec, t_ex, torch.as_tensor(xm),
                               torch.as_tensor(bm))
    j_need = jnb.needs_rebuild(js.neighbors, j_ex, xm, bm)
    assert bool(t_need) == bool(j_need)
    # update_neighbors(force=False) keeps or rebuilds as needs_rebuild says
    out = tnb.update_neighbors(tspec, t_ex, torch.as_tensor(xm),
                               torch.as_tensor(bm))
    ref = xm if bool(t_need) else x
    np.testing.assert_array_equal(out["nbr_xref"].numpy(), ref)
    np.testing.assert_array_equal(out["nbr_boxref"].numpy(),
                                  bm if bool(t_need) else box)
    want_bucket, _ = tnb.build_cell_buckets(
        tspec, torch.as_tensor(ref), torch.as_tensor(bm if bool(t_need)
                                                     else box))
    assert torch.equal(out["nbr_bucket"], want_bucket)
    forced = tnb.update_neighbors(tspec, t_ex, torch.as_tensor(xm),
                                  torch.as_tensor(bm), force=True)
    np.testing.assert_array_equal(forced["nbr_xref"].numpy(), xm)


@pytest.mark.parametrize("case", ["healthy", "overflow", "undercover"])
def test_unhealthy_flags_match_jax(case):
    """unhealthy_flags (overflow, undercover) and assert_neighbor_health on
    extras built at a tight capacity or a compressed box."""
    import dataclasses

    ts, js, x, box = _argon(4096, 0.05, 2)  # a grid the stencil
    tspec, jspec = ts.neighbors, js.neighbors  # does not wrap
    if case == "overflow":
        tspec = dataclasses.replace(tspec, cell_capacity=4)
        jspec = dataclasses.replace(jspec, cell_capacity=4)
    if case == "undercover":
        x, box = x * 0.8, box * 0.8
    t_ex = tnb.neighbor_list_extras(tspec, torch.as_tensor(x),
                                    torch.as_tensor(box))
    j_ex = jnb.neighbor_list_extras(jspec, x, box)
    got = [bool(f) for f in tnb.unhealthy_flags(t_ex)]
    want = [bool(f) for f in jnb.unhealthy_flags(j_ex)]
    assert got == want == [case == "overflow", case == "undercover"]
    if case == "healthy":
        tnb.assert_neighbor_health(t_ex)
    else:
        with pytest.raises(RuntimeError, match="unhealthy"):
            tnb.assert_neighbor_health(t_ex)


def test_barostat_forces_one_step_groups(monkeypatch):
    """Under a MonteCarloBarostat the Context steps with K = 1 whatever it
    was given (a volume move rebuilds the lists itself): the staleness
    flags are never sampled, and they are without one."""
    calls = []
    real = tcontext.staleness_flags

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tcontext, "staleness_flags", counting)
    ts, x, box = tmodels.water_system(n_molecules=64, r_cut=0.45,
                                      r_switch=0.35, seed=2, neighbors=True,
                                      dtype=F64, device="cpu")
    npt = ts.add_force(tamm.MonteCarloBarostat(pressure=1.0,
                                               temperature=300.0,
                                               frequency=2))
    for system, want_calls in ((npt, 0), (ts, 4)):
        calls.clear()
        ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.0005),
                           tamm.make_state(x, box=box),
                           neighbor_update_every=2)
        ctx.step(4)
        assert len(calls) == want_calls


def test_overflow_replay_restores_the_references():
    """A raised overflow flag under K = 2: step(n) restores the state from
    before the call (the reference positions and the staleness flags with
    the rest of State.extra), retunes and replays, and ends where a clean
    run ends, with its references and a quiet guard."""
    import warnings

    ts, _, x, box = _argon(864, 0.1, 7)
    v = torch.as_tensor(_velocities(ts.masses, 120.0, 3))

    def context():
        return tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                            tamm.make_state(torch.as_tensor(x), v=v,
                                            box=torch.as_tensor(box)),
                            neighbor_update_every=2)

    clean, ctx = context(), context()
    clean.step(5)
    ctx.step(2)
    before = {k: t.clone() for k, t in ctx.state.extra.items()}
    ctx.state.extra["nbr_overflow"] = torch.ones((), dtype=torch.bool)
    cap0 = ctx.system.neighbors.cell_capacity
    seen = []
    real = ctx._advance

    def spy(n):
        seen.append({k: ctx.state.extra[k].clone()
                     for k in ("nbr_xref", "nbr_stale")})
        real(n)

    ctx._advance = spy
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ctx.step(3)
    assert any("overflow" in str(w.message) for w in caught)
    assert ctx.last_step_passes == 2
    assert ctx.system.neighbors.cell_capacity >= cap0 + 4
    assert len(seen) == 2  # the replay starts from the restored state
    for key in ("nbr_xref", "nbr_stale"):
        assert torch.equal(seen[1][key], before[key]), key
    for key in ("nbr_xref", "nbr_boxref", "nbr_stale", "nbr_overflow"):
        assert torch.equal(ctx.state.extra[key], clean.state.extra[key]), key
    np.testing.assert_allclose(ctx.state.x.numpy(), clean.state.x.numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(ctx.state.v.numpy(), clean.state.v.numpy(),
                               atol=1e-10)
