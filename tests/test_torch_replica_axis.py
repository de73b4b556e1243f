"""The replica axis of the port: stacked States, the batched plain twins of
K1 and K2, the batched multi-state energies, and the stacked replica
runner and exchange, float64 on the CPU against single-row calls and the
JAX package's vmapped functions, and card cases (marker ``cuda``).

Systems: argon 864 on its 3^3 grid (K1's half stencil) and phenol in 60
waters at 0.5 nm (tests/test_torch_hrex.py's system, K2 on its 2^3 grid).
Tolerances: a batched row against its single-row call 1e-12 relative to
the largest entry (the plain twins' chunks differ with the row count, so
the last bits may); energies against the JAX package 1e-10 relative;
trajectories 1e-9 relative to their largest entry; accept masks and the
row streams exactly. On the card: K2's rows bit for bit against single
launches, K1's within 1e-4 (float32) and 1e-10 (float64) of the energy and
1e-4 and 1e-9 of max |F|, and the batched kernels against the batched
float64 twin at the same bounds.

The JAX package is imported inside the tests that compare with it, so that
the ``cuda`` cases run on a machine that has PyTorch alone:
    pytest tests/test_torch_replica_axis.py -m cuda -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch import interop
from atomsmm_tpu_torch.alchemy import (
    coupling_path,
    multistate_energies,
    reduced_energy_matrix,
)
from atomsmm_tpu_torch.models import argon_system, phenol_in_water
from atomsmm_tpu_torch.ops import neighbors as nb
from atomsmm_tpu_torch.ops import pair_kernel as pk
from atomsmm_tpu_torch.ops.pairfuncs import softcore_form, table_form
from atomsmm_tpu_torch.parallel import (
    HREXSampler,
    make_replicated_step,
    replicate_state,
)
from atomsmm_tpu_torch.state import stack_states
from atomsmm_tpu_torch.units import BOLTZMANN
from atomsmm_tpu_torch.utils import replace

F64 = torch.float64
K_ROWS = 3
PHENOL = dict(n_water=60, r_cut=0.5, r_switch=0.42, seed=5)
CASES = ("charges", "lambda", "triclinic", "table", "shared")


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


def _argon(device="cpu", dtype=F64):
    system, x, box = argon_system(n=864, jitter=0.05, seed=1, neighbors=True,
                                  dtype=dtype, device=device)
    assert system.neighbors.half_stencil
    return system, x, box


def _phenol(device="cpu", dtype=F64):
    system, x, box, solute = phenol_in_water(neighbors=True, dtype=dtype,
                                             device=device, **PHENOL)
    assert not system.neighbors.half_stencil
    return system, x, box, solute


@pytest.fixture(scope="module")
def argon():
    return _argon()


@pytest.fixture(scope="module")
def phenol():
    return _phenol()


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _batch(case, system, x, box, k=K_ROWS, seed=7):
    """(form, per-particle columns, x (K, N, 3), box (K, ...), bucket,
    lamb) of a sweep over k rows of `system`'s first force: each row's x
    jittered from numpy, and the case's per-row columns: per-row charges,
    per-row softcore lambdas (the solute's 12 atoms as 2 solute - 1 in the
    charge column), a (3, 3) box per row, a 3-type NBFIX table, or one x
    and one bucket shared by every row (stride 0) under per-row lambdas."""
    force = system.forces[0]
    n, dev, dtype = x.shape[0], x.device, x.dtype
    rs = np.random.RandomState(seed)
    form, pp = force._pair_form(), force._per_particle({})
    lamb = None
    xs = x[None] + torch.as_tensor(rs.normal(0.0, 0.01, (k, n, 3)),
                                   dtype=dtype, device=dev)
    boxes = box.expand(k, 3).clone()
    if case == "charges":
        pp = {**pp, "charge": torch.as_tensor(rs.normal(0.0, 0.4, (k, n)),
                                              dtype=dtype, device=dev)}
    elif case in ("lambda", "shared"):
        solute = torch.zeros(n, dtype=dtype, device=dev)
        solute[:12] = 1.0
        pp = {**pp, "charge": 2.0 * solute - 1.0}
        form = softcore_form(force.r_cut, force.r_switch, 1.0)
        lamb = torch.linspace(0.15, 0.85, k, dtype=dtype, device=dev)
        if case == "shared":
            xs = x.expand(k, n, 3)
            boxes = box.expand(k, 3)
    elif case == "triclinic":
        boxes = torch.diag_embed(boxes)
    elif case == "table":
        types = torch.arange(n, device=dev) % 3
        sig = torch.tensor([[0.30, 0.33, 0.31], [0.33, 0.36, 0.34],
                            [0.31, 0.34, 0.29]], dtype=dtype, device=dev)
        eps = torch.tensor([[0.50, 0.70, 0.40], [0.70, 0.90, 0.60],
                            [0.40, 0.60, 0.30]], dtype=dtype, device=dev)
        table = torch.stack([sig, eps, torch.zeros_like(sig),
                             torch.zeros_like(sig)], dim=-1).contiguous()
        pp = {**pp, "lj_type": types.to(torch.int32), "pair_table": table}
        form = table_form(form)
    if case == "shared":
        bucket, _ = nb.build_cell_buckets(system.neighbors, x, box)
        bucket = bucket.expand(k, *bucket.shape)
    else:
        bucket, _ = nb.build_cell_buckets(system.neighbors, xs, boxes)
    return form, pp, xs, boxes, bucket, lamb


def _single(form, pp, lamb, k):
    """Row k's form and per-particle columns."""
    if lamb is not None:
        form = dataclasses.replace(form, lamb=float(lamb[k]))
    return form, {key: v[k] if key == "charge" and v.ndim == 2 else v
                  for key, v in pp.items()}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("twin", ["half", "full"])
def test_batched_twin_rows_match_single_calls(argon, phenol, twin, case):
    """K1's twin on argon's half stencil and K2's on phenol's full
    stencil: each row of one batched call equals the single-row call of
    that row, rows 1e-12."""
    system, x, box = argon if twin == "half" else phenol[:3]
    plain = pk.half_pair_plain if twin == "half" else pk.full_pair_plain
    spec = system.neighbors
    form, pp, xs, boxes, bucket, lamb = _batch(case, system, x, box)
    out = plain(xs, pp, bucket, spec, boxes, form, form.r_cut, lamb=lamb)
    assert tuple(out.shape) == (K_ROWS, x.shape[0] + 1, 4)
    energies = []
    for k in range(K_ROWS):
        form_k, pp_k = _single(form, pp, lamb, k)
        one = plain(xs[k], pp_k, bucket[k], spec, boxes[k], form_k,
                    form.r_cut)
        _close(out[k], one, 1e-12)
        energies.append(float(one[:, 3].sum()))
    # the rows differ, so a row offset would show
    assert len({round(e, 9) for e in energies}) == K_ROWS


def test_stacked_buckets_and_flags_are_per_row(argon):
    """build_cell_buckets over a stack equals each row's own build, bit for
    bit, in either box form; a row crowded into one cell overflows alone
    and a retune sizes the shared capacity for it; the staleness flags and
    coverage are (K,), and update_neighbors(force=False) rebuilds only the
    row that moved."""
    system, x, box = argon
    spec = system.neighbors
    xs = torch.stack([x, x + 0.02, x.clone()])
    xs[2, :100] = x[:1] + 0.001 * torch.arange(100, dtype=F64)[:, None]
    boxes = box.expand(3, 3).clone()
    for bx in (boxes, torch.diag_embed(boxes)):
        bucket, overflow = nb.build_cell_buckets(spec, xs, bx)
        for k in range(3):
            b1, o1 = nb.build_cell_buckets(spec, xs[k], bx[k])
            assert torch.equal(bucket[k], b1) and bool(overflow[k]) == bool(o1)
        assert overflow.tolist() == [False, False, True]
    # a retune sizes the shared capacity for the crowded row
    assert nb.retune_spec(spec, xs, boxes).cell_capacity > 100
    xs[2] = x - 0.03
    extras = nb.neighbor_list_extras(spec, xs, boxes)
    assert tuple(extras["nbr_undercover"].shape) == (3,)
    # the rebuild predicate and the conditional update, row by row
    far = xs.clone()
    far[0, 5] += spec.skin
    upd = nb.update_neighbors(spec, extras, far, boxes, force=False)
    assert torch.equal(upd["nbr_xref"][0], far[0])
    for k in (1, 2):
        assert torch.equal(upd["nbr_xref"][k], xs[k])
        assert torch.equal(upd["nbr_bucket"][k], extras["nbr_bucket"][k])
    moved = xs.clone()
    moved[1, 0] += 0.5 * spec.skin + 0.01
    moved[1, 1] -= 0.5 * spec.skin + 0.01
    extras["nbr_stale"] = torch.zeros(3, dtype=torch.bool)
    flags = nb.staleness_flags(system, extras, moved, boxes)
    assert flags["nbr_stale"].tolist() == [False, True, False]


def test_stack_and_row_access():
    """stack_states, State.row and State.block round-trip; replicate_state
    gives each row its own generator."""
    state = tamm.make_state(torch.arange(12.0, dtype=F64).reshape(4, 3),
                            box=torch.full((3,), 5.0, dtype=F64), seed=1)
    stacked = replicate_state(state, 4, seed=2)
    assert stacked.rows == 4 and len(set(map(id, stacked.rng))) == 4
    again = stack_states([stacked.row(k) for k in range(4)])
    assert torch.equal(again.x, stacked.x) and again.rng == stacked.rng
    block = stacked.block(1, 3)
    assert block.rows == 2 and block.rng == stacked.rng[1:3]
    assert torch.equal(block.x, stacked.x[1:3])


@pytest.fixture(scope="module")
def solvated(phenol):
    system, x, box, solute = phenol
    return tamm.SolvationSystem(system, solute_atoms=solute), x, box


@pytest.fixture(scope="module")
def jax_solvated():
    from atomsmm_tpu import SolvationSystem
    from atomsmm_tpu.models.phenol import phenol_in_water as jphenol

    system, x, box, solute = jphenol(neighbors=True, **PHENOL)
    return SolvationSystem(system, solute_atoms=solute), x, box


def test_multistate_and_reduced_matrix_match_jax_vmap(solvated,
                                                      jax_solvated):
    """multistate_energies (one batched K2 sweep per force over 5 states
    sharing x and the bucket) and reduced_energy_matrix (3 samples) against
    the JAX package's vmapped ones, 1e-10."""
    import jax

    from atomsmm_tpu import alchemy as jalch

    solv, x, box = solvated
    jsolv, jx, jbox = jax_solvated
    lams = {"lambda_vdw": [0.0, 0.25, 0.5, 1.0, 1.0],
            "lambda_coul": [0.0, 0.0, 0.0, 0.5, 1.0]}
    jlams = {k: np.asarray(v) for k, v in lams.items()}
    es = multistate_energies(solv, x, box, lams)
    want = jax.jit(lambda xx: jalch.multistate_energies(
        jsolv, xx, jbox, jlams))(jx)
    _close(es, np.asarray(want), 1e-10)
    shifts = (0.0, 0.002, -0.002)
    u = reduced_energy_matrix(solv, torch.stack([x + s for s in shifts]),
                              box, lams, 300.0)
    u_j = jax.jit(lambda xs: jalch.reduced_energy_matrix(
        jsolv, xs, jbox, jlams, 300.0))(
            np.stack([np.asarray(jx) + s for s in shifts]))
    assert tuple(u.shape) == (5, 3)
    _close(u, np.asarray(u_j), 1e-10)


def test_sampler_on_a_carried_jax_stack_matches_jax(solvated, jax_solvated):
    """The JAX package's HREXSampler state (6 stacked replicas, x jittered
    and v from numpy) carried across by interop.state_from_numpy into the
    port's sampler: 8 steps (neighbor_update_every 4, the bath at friction
    0) and one exchange attempt with the JAX draws pinned, x and v 1e-9,
    the same accepts."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.parallel.hrex import HREXSampler as JSampler
    from atomsmm_tpu.utils import replace as jreplace

    solv, x, box = solvated
    jsolv, jx, jbox = jax_solvated
    k = 6
    lams = coupling_path(torch.linspace(0.0, 1.0, k, dtype=F64))
    kw = dict(dt=0.0005, friction=0.0, seed=2, neighbor_update_every=4)
    rs = np.random.RandomState(11)
    xs = np.asarray(jx)[None] + rs.normal(0.0, 0.003, (k,) + x.shape)
    v = rs.normal(size=(k,) + tuple(x.shape)) * np.sqrt(
        BOLTZMANN * 300.0 / solv.masses.numpy())[None, :, None]
    jsampler = JSampler(jsolv, jx, jbox, {n: jnp.asarray(val.numpy())
                                          for n, val in lams.items()},
                        300.0, **kw)
    jsampler.states = jreplace(jsampler.states, x=jnp.asarray(xs),
                               v=jnp.asarray(v))
    carried = interop.state_from_numpy(
        interop.describe_reference(jsampler.states), dtype=F64,
        device="cpu")
    assert carried.rows == k and len(carried.rng) == k
    sampler = HREXSampler(solv, x, box, lams, 300.0, **kw)
    sampler.states = replace(carried, extra={
        **carried.extra, **{key: val for key, val in sampler.states.extra
                            .items() if key not in carried.extra}})
    sampler.run(8)
    jsampler.run(8)
    _close(sampler.positions(), np.asarray(jsampler.states.x), 1e-9)
    _close(sampler.states.v, np.asarray(jsampler.states.v), 1e-9)
    _, sub = jax.random.split(jsampler._key)
    draws = jax.random.uniform(sub, (k,))
    sampler._swap._uniforms = lambda key, n, like: torch.as_tensor(
        np.array(draws), dtype=like.dtype, device=like.device)
    sampler.attempt_swaps()
    jsampler.attempt_swaps()
    assert (sampler.swap_attempts, sampler.swap_accepts) == (
        jsampler.swap_attempts, jsampler.swap_accepts)
    _close(sampler.positions(), np.asarray(jsampler.states.x), 1e-9)


def test_replicated_step_on_the_cells_matches_jax(argon):
    """make_replicated_step on 8 argon rows (one x, velocities per row from
    numpy, K1's twin over the stack) against the JAX package's
    make_replicated_step on its 8-device mesh: 5 steps, x and v 1e-9."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import atomsmm_tpu.ops.neighbors as jnb
    from atomsmm_tpu import VelocityVerletIntegrator as JVV
    from atomsmm_tpu.context import refresh_force_caches as jrefresh
    from atomsmm_tpu.models import argon_system as jargon
    from atomsmm_tpu.parallel import make_replicated_step as jmake
    from atomsmm_tpu.parallel import replicate_state as jrep
    from atomsmm_tpu.state import make_state as jmake_state
    from atomsmm_tpu.utils import replace as jreplace

    from atomsmm_tpu_torch.context import refresh_force_caches

    system, x, box = argon
    v = np.random.RandomState(5).normal(0.0, 0.3, (8,) + tuple(x.shape))
    integ = tamm.VelocityVerletIntegrator(0.002)
    state = tamm.make_state(x, box=box).with_extra(
        **nb.all_neighbor_extras(system, x, box))
    state = refresh_force_caches(system, integ.initialize(system, state), {})
    states = replace(replicate_state(state, 8), v=torch.as_tensor(v))
    run = make_replicated_step(integ.make_step())
    for _ in range(5):
        states = run(system, states, {})

    js, jx, jb = jargon(n=864, jitter=0.05, seed=1, neighbors=True)
    jinteg = JVV(0.002)
    jstate = jmake_state(jx, box=jb)
    jstate = jstate.with_extra(**jnb.all_neighbor_extras(js, jx, jb))
    jstate = jrefresh(js, jinteg.initialize(js, jstate), {})
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    sharding = NamedSharding(mesh, P("dp"))
    jstates = jax.tree.map(lambda a: jax.device_put(a, sharding),
                           jreplace(jrep(jstate, 8), v=np.asarray(v)))
    jrun = jax.jit(jmake(jinteg.make_step(), mesh))
    for _ in range(5):
        jstates = jrun(js, jstates, {})
    _close(states.x, np.asarray(jstates.x), 1e-9)
    _close(states.v, np.asarray(jstates.v), 1e-9)


def _thermostat(kind, pkg, dof):
    if kind == "nhc":
        return pkg.NoseHooverChainPropagator(120.0, dof, 0.05, nchain=3)
    return pkg.VelocityRescalingPropagator(120.0, dof, 0.05)


@pytest.mark.parametrize("kind", ["nhc", "nhc2", "csvr"])
def test_global_thermostat_over_a_stack(kind):
    """make_replicated_step of GlobalThermostatIntegrator over 4 argon rows
    (velocities per row from numpy, the dense path): each row equals the
    single-system steps of that row with the same generator, 1e-12, and
    each Nose-Hoover row keeps its own chain; the Nose-Hoover stack (3
    links, and the default 2) also against the JAX package's
    make_replicated_step on a 4-device mesh, 1e-9."""
    from atomsmm_tpu_torch.context import refresh_force_caches

    k, steps = 4, 6
    system, x, box = argon_system(n=64, jitter=0.05, seed=1, r_cut=0.5,
                                  r_switch=0.4, dtype=F64, device="cpu")
    dof = 3 * x.shape[0] - 3
    prop = _thermostat(kind[:4], tamm, dof)
    if kind == "nhc2":
        prop = tamm.NoseHooverChainPropagator(120.0, dof, 0.05)
    integ = tamm.GlobalThermostatIntegrator(0.002, prop)
    state = refresh_force_caches(system, integ.initialize(
        system, tamm.make_state(x, box=box)), {})
    v = np.random.RandomState(3).normal(0.0, 0.2, (k,) + tuple(x.shape)) \
        * np.array([0.5, 1.0, 1.5, 2.0])[:, None, None]
    states = replace(replicate_state(state, k, seed=4), v=torch.as_tensor(v))
    run = make_replicated_step(integ.make_step())
    for _ in range(steps):
        states = run(system, states, {})
    step = integ.make_step()
    singles = replicate_state(state, k, seed=4)
    for r in range(k):
        one = replace(singles.row(r), v=torch.as_tensor(v[r]))
        one = replace(one, extra={key: val.clone()
                                  for key, val in one.extra.items()})
        for _ in range(steps):
            one = step(system, one, {})
        _close(states.x[r], one.x, 1e-12)
        _close(states.v[r], one.v, 1e-12)
        for key, val in one.extra.items():
            if key.startswith("nhc"):
                _close(states.extra[key][r], val, 1e-12)
    if kind == "csvr":
        return
    # the rows started at different temperatures: their chains differ
    chains = states.extra["nhc_v"]
    assert tuple(chains.shape) == (k, prop.nchain)
    assert len({round(float(c), 12) for c in chains[:, 0]}) == k
    _close(integ.conserved_extra(states)[1],
           integ.conserved_extra(replace(states.row(1), extra={
               key: val[1] for key, val in states.extra.items()})), 1e-12)

    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import atomsmm_tpu as jamm
    from atomsmm_tpu.context import refresh_force_caches as jrefresh
    from atomsmm_tpu.models import argon_system as jargon
    from atomsmm_tpu.parallel import make_replicated_step as jmake
    from atomsmm_tpu.parallel import replicate_state as jrep
    from atomsmm_tpu.utils import replace as jreplace

    js, jx, jb = jargon(n=64, jitter=0.05, seed=1, r_cut=0.5, r_switch=0.4)
    jprop = (jamm.NoseHooverChainPropagator(120.0, dof, 0.05)
             if kind == "nhc2" else _thermostat("nhc", jamm, dof))
    jinteg = jamm.GlobalThermostatIntegrator(0.002, jprop)
    jstate = jrefresh(js, jinteg.initialize(js, jamm.make_state(jx, box=jb)),
                      {})
    mesh = Mesh(np.array(jax.devices()[:k]), ("dp",))
    sharding = NamedSharding(mesh, P("dp"))
    jstates = jax.tree.map(lambda a: jax.device_put(a, sharding),
                           jreplace(jrep(jstate, k), v=np.asarray(v)))
    jrun = jax.jit(jmake(jinteg.make_step(), mesh))
    for _ in range(steps):
        jstates = jrun(js, jstates, {})
    _close(states.x, np.asarray(jstates.x), 1e-9)
    _close(states.v, np.asarray(jstates.v), 1e-9)
    _close(chains, np.asarray(jstates.extra["nhc_v"]), 1e-9)


def test_single_system_propagators_refuse_a_stack():
    """The barostat and the Drude propagators take one system: a stack
    raises InputError naming the propagator."""
    from atomsmm_tpu_torch.integrate.barostat import (
        MonteCarloBarostatPropagator,
    )
    from atomsmm_tpu_torch.integrate.drude import (
        DrudeOrnsteinUhlenbeckPropagator,
        DrudeSCFPlacementPropagator,
    )
    from atomsmm_tpu_torch.integrate.propagators import StepContext
    from atomsmm_tpu_torch.utils import InputError

    system, x, box = argon_system(n=64, jitter=0.05, seed=1, r_cut=0.5,
                                  r_switch=0.4, dtype=F64, device="cpu")
    states = replicate_state(tamm.make_state(x, box=box), 2)
    ctx = StepContext(system, {}, 0.002)
    baro = MonteCarloBarostatPropagator(1.0, 120.0, frequency=1)
    with pytest.raises(InputError, match="MonteCarloBarostatPropagator"):
        baro.extra_variables(system, states)
    with pytest.raises(InputError, match="MonteCarloBarostatPropagator"):
        baro.apply(ctx, states, 1.0)
    drude = object.__new__(DrudeOrnsteinUhlenbeckPropagator)
    with pytest.raises(InputError, match="DrudeOrnstein"):
        drude.apply(ctx, states, 1.0)
    scf = object.__new__(DrudeSCFPlacementPropagator)
    with pytest.raises(InputError, match="DrudeSCFPlacement"):
        scf.apply(ctx, states, 1.0)


def test_row_streams_do_not_depend_on_the_row_count():
    """Row k's generator is seeded from (seed, k): its draws, and an OU
    trajectory from the same start, are the same whether the stack has 2
    rows or 5."""
    system, x, box = argon_system(n=64, jitter=0.05, seed=1, r_cut=0.5,
                                  r_switch=0.4, dtype=F64, device="cpu")
    integ = tamm.GlobalThermostatIntegrator(
        0.002, tamm.OrnsteinUhlenbeckPropagator(120.0, 5.0))
    from atomsmm_tpu_torch.context import refresh_force_caches

    state = refresh_force_caches(system, integ.initialize(
        system, tamm.make_state(x, box=box)), {})
    rows = {}
    for k in (2, 5):
        draws = torch.rand(4, generator=replicate_state(state, k, 9).rng[1],
                           dtype=F64)
        states = replicate_state(state, k, seed=9)
        run = make_replicated_step(integ.make_step())
        for _ in range(6):
            states = run(system, states, {})
        rows[k] = (draws, states.x[1], states.v[1])
    for a, b in zip(rows[2], rows[5]):
        assert torch.equal(a, b)


def _card_batch(twin, case, dtype, device):
    if twin == "half":
        system, x, box = _argon(device, dtype)
    else:
        system, x, box, _ = _phenol(device, dtype)
    return system, _batch(case, system, x, box, k=4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("twin", ["half", "full"])
def test_batched_kernel_rows_on_the_card(cuda, twin, case, dtype):
    """One batched launch of K1 (argon) or K2 (phenol) over 4 rows against
    its batched float64 twin, and each row against the single-row launch
    of that row: K2 bit for bit, K1 within its tolerances."""
    dtype = getattr(torch, dtype)
    system, (form, pp, xs, boxes, bucket, lamb) = _card_batch(
        twin, case, dtype, cuda)
    spec = system.neighbors
    cuda_fn = pk.half_pair_cuda if twin == "half" else pk.full_pair_cuda
    plain = pk.half_pair_plain if twin == "half" else pk.full_pair_plain
    before = pk.LAUNCHES[("half_pair" if twin == "half" else "cell_pair")]
    out = cuda_fn(xs, pp, bucket, spec, boxes, form, form.r_cut, lamb=lamb)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["half_pair" if twin == "half" else "cell_pair"] \
        == before + 1
    pp64 = {key: v.double() if v.is_floating_point() else v
            for key, v in pp.items()}
    ref = plain(xs.double(), pp64, bucket, spec, boxes.double(), form,
                form.r_cut, lamb=None if lamb is None else lamb.double())
    e_tol, f_tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-10, 1e-9)
    for k in range(4):
        form_k, pp_k = _single(form, pp, lamb, k)
        one = cuda_fn(xs[k].contiguous(), pp_k, bucket[k].contiguous(), spec,
                      boxes[k].contiguous(), form_k, form.r_cut)
        for got in (out[k], one):
            e_scale = max(float(ref[k, :, 3].abs().sum()), 1.0)
            assert abs(float(got[:, 3].double().sum() - ref[k, :, 3].sum())) \
                <= e_tol * e_scale
            f_max = float(ref[k, :-1, :3].abs().max())
            assert float((got[:-1, :3].double() - ref[k, :-1, :3]).abs()
                         .max()) <= f_tol * max(f_max, 1.0)
        if twin == "full":
            assert torch.equal(out[k], one)
        else:
            f_max = max(float(one[:-1, :3].abs().max()), 1.0)
            assert abs(float(out[k, :, 3].double().sum()
                             - one[:, 3].double().sum())) <= e_tol * max(
                float(one[:, 3].abs().sum()), 1.0)
            assert float((out[k, :-1, :3] - one[:-1, :3]).abs().max()) \
                <= f_tol * f_max
