"""Integration of the port against the JAX package, float64 on the CPU.

Both packages start from the same numpy positions and velocities (the RNG
streams differ — JAX threefry against torch Philox — so neither draws its
own):

  * 10 outer RESPA [4, 2, 1] steps with a Nosé-Hoover chain bath on water
    400 (RESPASystem 0.45/0.35 on the cell path): positions, velocities,
    chain velocities and positions, and the step counter;
  * 20 velocity-Verlet steps on argon 864.

Tolerance: rtol 1e-9 with atol 1e-9 x max|value|. The sums run in another
order and the port rebuilds its buckets at every outer step where JAX
rebuilds on a displacement trigger (same pairs, other order), so the two
trajectories differ by rounding that grows mildly over the steps.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.interop import describe_reference, state_from_numpy

TOL = 1e-9
F64 = torch.float64


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1e-300))


def _velocities(masses, temperature, seed):
    m = np.asarray(masses, np.float64)
    kt = tamm.units.BOLTZMANN * temperature
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) \
        * np.sqrt(kt / m)[:, None]
    return v - (m[:, None] * v).sum(0) / m.sum()


def _water_pair(loops, dt):
    js, jx, jb = jmodels.water_system(n_molecules=400, r_cut=0.7,
                                      r_switch=0.6, seed=5, neighbors=True)
    ts, tx, tb = tmodels.water_system(n_molecules=400, r_cut=0.7,
                                      r_switch=0.6, seed=5, neighbors=True,
                                      dtype=F64, device="cpu")
    js = jamm.RESPASystem(js, rcut_in=0.45, rswitch_in=0.35)
    ts = tamm.RESPASystem(ts, rcut_in=0.45, rswitch_in=0.35)
    v = _velocities(ts.masses, 300.0, seed=9)
    dof = 3 * ts.num_particles - 3
    kw = dict(temperature=300.0, time_scale=0.1, degrees_of_freedom=dof)
    jctx = jamm.Context(js, jamm.MultipleTimeScaleIntegrator(dt, loops, **kw),
                        jamm.make_state(jx, v=v, box=jb))
    tctx = tamm.Context(ts, tamm.MultipleTimeScaleIntegrator(dt, loops, **kw),
                        tamm.make_state(tx, v=torch.as_tensor(v), box=tb))
    return jctx, tctx


def test_respa_nhc_trajectory_matches_jax():
    jctx, tctx = _water_pair([4, 2, 1], 0.002)
    jctx.step(4)
    jctx.step(6)
    tctx.step(4)
    tctx.step(6)
    js, ts = jctx.state, tctx.state
    _close(ts.x, js.x)
    _close(ts.v, js.v)
    _close(ts.extra["nhc_v"], js.extra["nhc_v"])
    _close(ts.extra["nhc_eta"], js.extra["nhc_eta"])
    assert ts.step == int(js.step) == 10
    for g in (0, 1, 2):
        key = f"fcache_{g}"
        _close(ts.extra[key], js.extra[key])
    _close(tctx.temperature(), jctx.temperature())
    _close(tctx.conserved_energy(), jctx.conserved_energy())


def test_velocity_verlet_argon_matches_jax():
    js, jx, jb = jmodels.argon_system(n=864, jitter=0.1, seed=7,
                                      neighbors=True)
    ts, tx, tb = tmodels.argon_system(n=864, jitter=0.1, seed=7,
                                      neighbors=True, dtype=F64, device="cpu")
    v = _velocities(ts.masses, 120.0, seed=3)
    jctx = jamm.Context(js, jamm.VelocityVerletIntegrator(0.002),
                        jamm.make_state(jx, v=v, box=jb))
    tctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                        tamm.make_state(tx, v=torch.as_tensor(v), box=tb))
    jctx.step(20)
    tctx.step(20)
    _close(tctx.state.x, jctx.state.x)
    _close(tctx.state.v, jctx.state.v)
    snap_t, snap_j = tctx.get_state(), jctx.get_state()
    _close(snap_t.forces, snap_j.forces)
    _close(snap_t.potential_energy, snap_j.potential_energy)
    _close(tctx.conserved_energy(), jctx.conserved_energy())


def _describe_cases():
    return {
        "vv": lambda m: m.VelocityVerletIntegrator(0.002),
        "mts_421_nhc": lambda m: m.MultipleTimeScaleIntegrator(
            0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
            degrees_of_freedom=1197),
        "mts_21": lambda m: m.MultipleTimeScaleIntegrator(0.004, [2, 1]),
        "mts_31_inner_bath": lambda m: m.MultipleTimeScaleIntegrator(
            0.003, [3, 1], temperature=250.0, time_scale=0.2,
            degrees_of_freedom=93, location=0, nchain=3),
    }


@pytest.mark.parametrize("case", sorted(_describe_cases()))
def test_describe_text_matches_jax(case):
    build = _describe_cases()[case]
    assert build(tamm).describe() == build(jamm).describe()


def test_state_interop_matches_make_state():
    js, jx, jb = jmodels.water_system(n_molecules=64, r_cut=0.45,
                                      r_switch=0.35, seed=2)
    jstate = jamm.make_state(jx, box=jb).with_extra(
        nhc_v=np.array([0.5, -0.25]))
    carried = state_from_numpy(describe_reference(jstate), dtype=F64,
                               device="cpu")
    _, tx, tb = tmodels.water_system(n_molecules=64, r_cut=0.45,
                                     r_switch=0.35, seed=2, dtype=F64,
                                         device="cpu")
    assert torch.equal(carried.x, tx) and torch.equal(carried.box, tb)
    assert torch.equal(carried.v, torch.zeros_like(tx))
    assert carried.step == 0
    assert carried.extra["nhc_v"].tolist() == [0.5, -0.25]


def test_cold_start_overflow_retunes():
    import dataclasses

    ts, tx, tb = tmodels.argon_system(n=864, jitter=0.1, seed=7,
                                      neighbors=True, dtype=F64, device="cpu")
    tiny = ts.with_neighbors(dataclasses.replace(ts.neighbors,
                                                 cell_capacity=8))
    ctx = tamm.Context(tiny, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(tx, box=tb))
    assert ctx.system.neighbors.cell_capacity > 8
    ctx.step(2)
    assert ctx.last_step_passes == 1
    assert not any(ctx._flags().values())


def test_set_velocities_to_temperature():
    ts, tx, tb = tmodels.argon_system(n=864, jitter=0.1, seed=7,
                                      neighbors=True, dtype=F64, device="cpu")
    ctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(tx, box=tb))
    ctx.set_velocities_to_temperature(120.0, seed=3)
    p = (ctx.system.masses[:, None] * ctx.state.v).sum(0)
    assert float(p.abs().max()) < 1e-10
    assert 100.0 < float(ctx.temperature()) < 140.0


def test_import_leaves_jax_out():
    code = ("import sys, atomsmm_tpu_torch, atomsmm_tpu_torch.interop, "
            "atomsmm_tpu_torch.models, atomsmm_tpu_torch.ops.pair_kernel, "
            "atomsmm_tpu_torch.ops.tilepair; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_overflow_restores_retunes_and_replays():
    """A raised overflow flag makes step(n) restore the state from before
    the call, grow the capacities and run the n steps again."""
    import warnings

    ts, tx, tb = tmodels.argon_system(n=864, jitter=0.1, seed=7,
                                      neighbors=True, dtype=F64, device="cpu")
    v = torch.as_tensor(_velocities(ts.masses, 120.0, seed=3))
    clean = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                         tamm.make_state(tx, v=v, box=tb))
    clean.step(3)
    ctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(tx, v=v, box=tb))
    cap0 = ctx.system.neighbors.cell_capacity
    ctx.state.extra["nbr_overflow"] = torch.ones((), dtype=torch.bool)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ctx.step(3)
    assert any("overflow" in str(w.message) for w in caught)
    assert ctx.last_step_passes == 2 and ctx.state.step == 3
    assert ctx.system.neighbors.cell_capacity >= cap0 + 4
    _close(ctx.state.x, clean.state.x)
    _close(ctx.state.v, clean.state.v)
