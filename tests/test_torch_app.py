"""The application layer of the port: Simulation, the reporters, checkpoints
and System files, FIRE, profiling and PDB files, float64 on the CPU against
the JAX package (the twins of tests/test_reporters.py, the reporter and
checkpoint round trip of tests/test_smoke.py, the PDB cases of
tests/test_amber.py), and the card cases (marker ``cuda``).

Both packages start from the same numpy positions and velocities (their
random streams differ). Reporter columns are compared as the values the
reporters print, before formatting, at 1e-10; headers as text. A restored
checkpoint equals the saved state bit for bit, the generator included,
and on the CPU the continuation equals the uninterrupted run bit for bit.
FIRE on the port's cell lists matches the JAX package's dense FIRE to
1e-9 nm after 100 iterations.

The JAX package is imported inside the tests that compare with it, so that
the ``cuda`` cases run on a machine that has PyTorch alone:
    pytest tests/test_torch_app.py -m cuda -q --noconftest
"""
import io
import math

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.checkpoint import (
    load_checkpoint,
    load_system,
    save_checkpoint,
    save_system,
)
from atomsmm_tpu_torch.reporters import _read_scalars
from atomsmm_tpu_torch.units import BOLTZMANN

F64 = torch.float64


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


def _velocities(masses, temperature, seed):
    m = np.asarray(masses, np.float64)
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) * np.sqrt(
        BOLTZMANN * temperature / m)[:, None]
    return v - (m[:, None] * v).sum(0) / m.sum()


def _argon_sim(n=125, integrator=None, device="cpu", **kw):
    """The port's argon Simulation (the JAX test's fixture: n = 125,
    jitter 0.05, seed 1), velocities at 120 K from numpy; (sim, x, v,
    box) with x, v, box as numpy."""
    system, x, box = tmodels.argon_system(n=n, jitter=0.05, seed=1,
                                          dtype=F64, device=device, **kw)
    v = _velocities(system.masses.cpu(), 120.0, 3)
    sim = tamm.Simulation(system,
                          integrator or tamm.VelocityVerletIntegrator(0.002),
                          tamm.make_state(x, box=box))
    sim.context.set_velocities(torch.as_tensor(v))
    return sim, x.cpu().numpy(), v, box.cpu().numpy()


def _jax_argon_sim(x, v, box, n=125, **kw):
    import atomsmm_tpu as jamm
    from atomsmm_tpu.models import argon_system

    system, _, _ = argon_system(n=n, jitter=0.05, seed=1, **kw)
    sim = jamm.Simulation(system, jamm.VelocityVerletIntegrator(0.002),
                          jamm.make_state(x, box=box))
    sim.context.set_velocities(v)
    return sim


@pytest.fixture()
def argon_sim():
    return _argon_sim()[0]


def _columns(reporter, sim, lite=None):
    """(names, values) the port's reporter would print at sim's state."""
    lite = (not reporter.needs_full_snapshot) if lite is None else lite
    snap = sim.context.get_state(lite=lite)
    host = _read_scalars(reporter._tensors(sim, snap))
    cols = reporter._columns(sim, snap, host)
    return [n for n, _ in cols], [v for _, v in cols]


def _jax_columns(reporter, sim):
    snap = sim.context.get_state(lite=not reporter.needs_full_snapshot)
    cols = reporter._columns(sim, snap)
    return [n for n, _ in cols], [float(v) for _, v in cols]


def _hold_columns(port, jax_cols):
    (names, values), (jnames, jvalues) = port, jax_cols
    assert names == jnames
    np.testing.assert_allclose(np.asarray(values, np.float64), jvalues,
                               rtol=1e-10, atol=1e-10)


# -- the twins of tests/test_reporters.py ------------------------------------


def test_state_data_reporter():
    import atomsmm_tpu as jamm

    sim, x, v, box = _argon_sim()
    buf = io.StringIO()
    rep = tamm.StateDataReporter(buf, interval=10)
    sim.reporters.append(rep)
    sim.step(35)
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith('"Step"')
    rows = [line.split(",") for line in lines[1:]]
    assert [int(r[0]) for r in rows] == [10, 20, 30]
    for r in rows:
        np.testing.assert_allclose(float(r[4]), float(r[2]) + float(r[3]),
                                   rtol=1e-5)
    jsim = _jax_argon_sim(x, v, box)
    jbuf = io.StringIO()
    jrep = jamm.StateDataReporter(jbuf, interval=10)
    jsim.reporters.append(jrep)
    jsim.step(35)
    assert jbuf.getvalue().splitlines()[0] == lines[0]
    jrows = [line.split(",") for line in jbuf.getvalue().splitlines()[1:]]
    np.testing.assert_allclose(np.asarray(rows, np.float64),
                               np.asarray(jrows, np.float64), rtol=1e-5)
    _hold_columns(_columns(rep, sim), _jax_columns(jrep, jsim))


def test_lite_snapshot_matches_full_and_is_selected(argon_sim):
    ctx = argon_sim.context
    full = ctx.get_state()
    lite = ctx.get_state(lite=True)
    np.testing.assert_allclose(float(lite.potential_energy),
                               float(full.potential_energy), rtol=1e-12)
    np.testing.assert_allclose(float(lite.kinetic_energy),
                               float(full.kinetic_energy), rtol=1e-12)
    assert lite.forces is None and lite.energy_split is None
    assert full.forces is not None

    calls = {"full": 0, "lite": 0}
    orig = ctx.get_state

    def spy(lite=False):
        calls["lite" if lite else "full"] += 1
        return orig(lite=lite)

    ctx.get_state = spy
    argon_sim.reporters.append(tamm.StateDataReporter(io.StringIO(), 5))
    argon_sim.step(10)
    assert calls == {"full": 0, "lite": 2}
    argon_sim.reporters.append(
        tamm.ExtendedStateDataReporter(io.StringIO(), 5))
    argon_sim.step(5)
    assert calls["full"] == 1
    del ctx.get_state


def test_extended_reporter_columns():
    import atomsmm_tpu as jamm

    sim, x, v, box = _argon_sim()
    buf = io.StringIO()
    sim.context.set_parameter("lambda_vdw", 0.7)
    rep = tamm.ExtendedStateDataReporter(buf, interval=10,
                                         global_parameters=["lambda_vdw"])
    sim.reporters.append(rep)
    sim.step(10)
    header, row = buf.getvalue().strip().splitlines()
    assert "NonbondedForce (kJ/mole)" in header
    assert "Atomic Pressure (bar)" in header
    assert "Molecular Pressure (bar)" in header
    assert header.strip().endswith('"lambda_vdw"')
    assert row.strip().endswith("0.7")
    jsim = _jax_argon_sim(x, v, box)
    jsim.context.set_parameter("lambda_vdw", 0.7)
    jbuf = io.StringIO()
    jrep = jamm.ExtendedStateDataReporter(jbuf, interval=10,
                                          global_parameters=["lambda_vdw"])
    jsim.reporters.append(jrep)
    jsim.step(10)
    assert jbuf.getvalue().splitlines()[0] == header
    _hold_columns(_columns(rep, sim), _jax_columns(jrep, jsim))


def test_xyz_and_com_reporters():
    import atomsmm_tpu as jamm

    sim, x, v, box = _argon_sim()
    jsim = _jax_argon_sim(x, v, box)
    out = {}
    for key, s, pkg in (("port", sim, tamm), ("jax", jsim, jamm)):
        xyz, com = io.StringIO(), io.StringIO()
        s.reporters += [pkg.XYZReporter(xyz, interval=20, atoms=range(5)),
                        pkg.CenterOfMassReporter(com, interval=20)]
        s.step(40)
        out[key] = (xyz.getvalue(), com.getvalue())
    frames = out["port"][0].strip().splitlines()
    assert frames[0] == "5" and len(frames) == 2 * 7
    assert out["port"][1].strip().splitlines()[0] == "125"
    for mine, theirs in zip(out["port"], out["jax"]):
        a, b = (text.strip().splitlines() for text in (mine, theirs))
        assert len(a) == len(b)
        for la, lb in zip(a, b):
            fa, fb = la.split(), lb.split()
            assert fa[0] == fb[0]
            if len(fa) == 4:
                np.testing.assert_allclose(np.float64(fa[1:]),
                                           np.float64(fb[1:]), atol=1.1e-6)


def test_custom_integrator_reporter():
    system, x, box = tmodels.argon_system(n=64, jitter=0.05, seed=1,
                                          r_cut=0.5, r_switch=0.4,
                                          dtype=F64, device="cpu")
    nhc = tamm.NoseHooverChainPropagator(120.0, 189, 0.1)
    sim = tamm.Simulation(system, tamm.GlobalThermostatIntegrator(0.002, nhc),
                          tamm.make_state(x, box=box))
    buf = io.StringIO()
    sim.reporters.append(tamm.CustomIntegratorReporter(buf, interval=5))
    sim.step(5)
    out = buf.getvalue()
    assert "# step 5" in out and "nhc_v" in out and "nhc_eta" in out


def test_ideal_gas_pressure():
    """Atomic pressure of a noninteracting system == N kT / V."""
    from atomsmm_tpu_torch.computers import atomic_pressure

    n, temp = 216, 150.0
    box = torch.full((3,), 3.0, dtype=F64)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.uniform(0, 3.0, (n, 3)))
    system = tamm.System(masses=torch.full((n,), 20.0, dtype=F64), forces=(),
                         molecule=torch.arange(n, dtype=torch.int32),
                         default_box=box, num_molecules=n)
    v = torch.as_tensor(_velocities(system.masses, temp, 1))
    state = tamm.make_state(x, v=v, box=box)
    p = float(atomic_pressure(system, state))
    ke = float(0.5 * torch.sum(system.masses[:, None] * v * v))
    np.testing.assert_allclose(p, 2.0 * ke / (3.0 * 27.0), rtol=1e-10)


def test_virial_matches_numerical_dudv():
    from atomsmm_tpu.computers import atomic_virial as jvirial
    from atomsmm_tpu.models import argon_system as jargon
    from atomsmm_tpu_torch.computers import atomic_virial
    from atomsmm_tpu_torch.potential import potential_energy

    system, x, box = tmodels.argon_system(n=125, jitter=0.1, seed=2,
                                          dtype=F64, device="cpu")
    w = float(atomic_virial(system, x, box))
    h = 1e-6
    up = float(potential_energy(system, (1 + h) * x, (1 + h) * box))
    um = float(potential_energy(system, (1 - h) * x, (1 - h) * box))
    np.testing.assert_allclose(w, -(up - um) / (2 * h), rtol=1e-6)
    jsys, jx, jbox = jargon(n=125, jitter=0.1, seed=2)
    np.testing.assert_allclose(w, float(jvirial(jsys, jx, jbox)), rtol=1e-10)


def test_pressure_computer_facade(argon_sim):
    pc = tamm.PressureComputer(argon_sim.system)
    pc.import_configuration(argon_sim.context.state)
    assert math.isfinite(pc.get_atomic_pressure())
    assert math.isfinite(pc.get_molecular_pressure())
    np.testing.assert_allclose(pc.get_molecular_virial(),
                               pc.get_atomic_virial(), rtol=1e-6)


def _snapshot(state):
    """Copies of everything a checkpoint holds (the generator advances in
    place, so a saved State object alone would not keep its state)."""
    return dict(x=state.x.clone(), v=state.v.clone(), box=state.box.clone(),
                step=state.step, rng_device=state.rng.device,
                rng=state.rng.get_state().clone(),
                extra={k: v.clone() for k, v in state.extra.items()})


def _state_equal(state, snap):
    """`state` equals the snapshot `snap` bit for bit."""
    for k in ("x", "v", "box"):
        got = getattr(state, k)
        assert got.dtype == snap[k].dtype and torch.equal(got, snap[k]), k
    assert state.step == snap["step"]
    assert sorted(state.extra) == sorted(snap["extra"])
    for k, want in snap["extra"].items():
        assert state.extra[k].dtype == want.dtype, k
        assert torch.equal(state.extra[k], want), k
    assert state.rng.device == snap["rng_device"]
    assert torch.equal(state.rng.get_state(), snap["rng"])


def test_checkpoint_exact_resume(tmp_path):
    """Under LangevinMiddle (the generator draws every step): the restored
    state equals the saved one bit for bit, and the continuation the
    uninterrupted run."""
    sim = _argon_sim(integrator=tamm.LangevinMiddleIntegrator(
        0.002, 120.0, 5.0))[0]
    sim.step(25)
    path = str(tmp_path / "ckpt.npz")
    sim.save_checkpoint(path)
    saved = _snapshot(sim.context.state)
    sim.step(25)
    x_after = sim.context.state.x.clone()
    sim.load_checkpoint(path)
    _state_equal(sim.context.state, saved)
    sim.step(25)
    assert torch.equal(sim.context.state.x, x_after)


def test_checkpoint_extra_key_compatibility(tmp_path, argon_sim):
    path = str(tmp_path / "ckpt.npz")
    argon_sim.save_checkpoint(path)
    state = argon_sim.context.state
    newer = state.with_extra(new_counter=torch.zeros((), dtype=torch.int32))
    with pytest.warns(UserWarning, match="predates"):
        restored = load_checkpoint(path, like=newer)
    assert int(restored.extra["new_counter"]) == 0
    assert torch.equal(restored.x, state.x)
    stripped = state.with_extra(fake=torch.zeros(()))
    save_checkpoint(path, stripped)
    with pytest.raises(ValueError, match="extended variables"):
        load_checkpoint(path, like=state)
    np.savez(path, __schema__=np.asarray("atomsmm_tpu-state-v1"))
    with pytest.raises(ValueError, match="atomsmm_tpu-state-v1"):
        load_checkpoint(path, like=state)


def test_coulomb_energy_column():
    import atomsmm_tpu as jamm
    from atomsmm_tpu.models import water_system as jwater
    from atomsmm_tpu_torch.computers import coulomb_energy
    from atomsmm_tpu_torch.potential import potential_energy
    from atomsmm_tpu_torch.utils import replace

    system, x, box = tmodels.water_system(n_molecules=64, r_cut=0.55,
                                          r_switch=0.45, dtype=F64,
                                          device="cpu")
    ec = float(coulomb_energy(system, x, box))
    nb = system.forces[0]
    lj_only = system.replace_forces(
        [replace(nb, charge=torch.zeros_like(nb.charge))])
    np.testing.assert_allclose(
        ec, float(nb.energy(x, box, {})) - float(potential_energy(lj_only, x,
                                                                  box)),
        rtol=1e-7, atol=1e-7)
    kw = dict(interval=5, pressure=False, coulomb_energy=True)
    sim = tamm.Simulation(system, tamm.VelocityVerletIntegrator(0.001),
                          tamm.make_state(x, box=box))
    buf = io.StringIO()
    rep = tamm.ExtendedStateDataReporter(buf, **kw)
    sim.reporters.append(rep)
    sim.step(5)
    header = buf.getvalue().splitlines()[0]
    assert "Coulomb Energy (kJ/mole)" in header
    jsys, _, _ = jwater(n_molecules=64, r_cut=0.55, r_switch=0.45)
    jsim = jamm.Simulation(jsys, jamm.VelocityVerletIntegrator(0.001),
                           jamm.make_state(x.numpy(), box=box.numpy()))
    jbuf = io.StringIO()
    jrep = jamm.ExtendedStateDataReporter(jbuf, **kw)
    jsim.reporters.append(jrep)
    jsim.step(5)
    assert jbuf.getvalue().splitlines()[0] == header
    _hold_columns(_columns(rep, sim), _jax_columns(jrep, jsim))


@pytest.mark.slow
def test_coulomb_energy_excludes_custom_nonbonded():
    """On a SolvationSystem the solute-solute LJ term (here a second
    NonbondedForce with zero charges) adds nothing to the Coulomb column:
    at lambda_coul = 1 it equals the plain system's Coulomb energy."""
    from atomsmm_tpu_torch.computers import coulomb_energy
    from atomsmm_tpu_torch.models import phenol_in_water

    system, x, box, solute = phenol_in_water(n_water=40, r_cut=0.5,
                                             r_switch=0.45, dtype=F64,
                                             device="cpu")
    solv = tamm.SolvationSystem(system, solute_atoms=solute)
    g = {"lambda_vdw": 1.0, "lambda_coul": 1.0}
    np.testing.assert_allclose(float(coulomb_energy(solv, x, box, g)),
                               float(coulomb_energy(system, x, box, g)),
                               rtol=1e-6, atol=1e-6)
    sim = tamm.Simulation(solv, tamm.VelocityVerletIntegrator(0.001),
                          tamm.make_state(x, box=box))
    for k, val in g.items():
        sim.context.set_parameter(k, val)
    buf = io.StringIO()
    sim.reporters.append(tamm.ExtendedStateDataReporter(
        buf, interval=2, pressure=False, coulomb_energy=True))
    sim.step(2)
    lines = buf.getvalue().splitlines()
    header = [h.strip('"') for h in lines[0].split('","')]
    val = float(lines[1].split(",")[header.index("Coulomb Energy (kJ/mole)")])
    ec_now = float(coulomb_energy(solv, sim.context.state.x, box, g))
    restore = [f for f in solv.forces if f.name == "NonbondedForce"][-1]
    assert abs(float(restore.energy(sim.context.state.x, box, g))) > 1.0
    np.testing.assert_allclose(val, ec_now, rtol=1e-4, atol=1e-3)


def test_system_serialization_roundtrip(tmp_path):
    """save/load of a System reproduces its energies bit for bit without
    the model functions (forces, parameters, neighbor specs, constraints,
    virtual sites), and 1e-10 against the JAX package's."""
    from atomsmm_tpu import RESPASystem as JRESPA
    from atomsmm_tpu.models import water_system as jwater
    from atomsmm_tpu.potential import split_potential_energy as jsplit
    from atomsmm_tpu_torch.models import rigid_water_system, \
        tip4p_water_system
    from atomsmm_tpu_torch.potential import potential_energy, \
        split_potential_energy

    kw = dict(n_molecules=48, r_cut=0.5, r_switch=0.4, seed=3,
              neighbors=True, dispersion_correction=True)
    system, x, box = tmodels.water_system(**kw, dtype=F64, device="cpu")
    respa = tamm.RESPASystem(system, rcut_in=0.35, rswitch_in=0.3)
    respa = respa.with_neighbors(system.neighbors)
    save_system(str(tmp_path / "system.npz"), respa)
    loaded = load_system(str(tmp_path / "system.npz"), device="cpu")
    e0 = split_potential_energy(respa, x, box)
    e1 = split_potential_energy(loaded, x, box)
    assert set(e0) == set(e1)
    for k in e0:
        assert float(e0[k]) == float(e1[k]), k
    assert loaded.neighbors.grid == respa.neighbors.grid
    assert loaded.neighbors.cell_capacity == respa.neighbors.cell_capacity
    assert loaded.num_molecules == respa.num_molecules
    jsys, _, _ = jwater(**kw)
    je = jsplit(JRESPA(jsys, rcut_in=0.35, rswitch_in=0.3), x.numpy(),
                box.numpy())
    for k in e1:
        np.testing.assert_allclose(float(e1[k]), float(je[k]), rtol=1e-10,
                                   atol=1e-10)

    rigid, xr, boxr = rigid_water_system(n_molecules=27, r_cut=0.45,
                                         dtype=F64, device="cpu")
    save_system(str(tmp_path / "rigid.npz"), rigid)
    loaded2 = load_system(str(tmp_path / "rigid.npz"), device="cpu")
    assert loaded2.num_constraints == rigid.num_constraints
    assert loaded2.constraints is None
    assert torch.equal(loaded2.settle.triplets, rigid.settle.triplets)
    assert torch.equal(loaded2.settle.ra, rigid.settle.ra)
    shake, _, _ = rigid_water_system(n_molecules=27, r_cut=0.45,
                                     analytic=False, dtype=F64, device="cpu")
    save_system(str(tmp_path / "shake.npz"), shake)
    loaded3 = load_system(str(tmp_path / "shake.npz"), device="cpu")
    assert torch.equal(loaded3.constraints.pairs, shake.constraints.pairs)
    t4, x4, box4 = tip4p_water_system(n_molecules=8, r_cut=0.28,
                                      r_switch=0.24, dtype=F64, device="cpu")
    save_system(str(tmp_path / "tip4p.npz"), t4)
    loaded4 = load_system(str(tmp_path / "tip4p.npz"), device="cpu")
    assert torch.equal(loaded4.virtual_sites.sites, t4.virtual_sites.sites)
    assert torch.equal(loaded4.virtual_sites.weights,
                       t4.virtual_sites.weights)
    assert torch.equal(loaded4.settle.triplets, t4.settle.triplets)
    assert float(potential_energy(loaded4, x4, box4)) == float(
        potential_energy(t4, x4, box4))


def test_system_serialization_rejects_callables(tmp_path):
    from atomsmm_tpu_torch.forces import CustomBondForce

    system, _, _ = tmodels.argon_system(n=32, jitter=0.0, seed=0, r_cut=0.5,
                                        r_switch=0.45, dtype=F64,
                                        device="cpu")
    bad = system.add_force(CustomBondForce(
        pairs=torch.tensor([[0, 1]], dtype=torch.int32), per_bond={},
        energy_function=lambda r, p: r * 0.0))
    with pytest.raises(TypeError, match="callable"):
        save_system(str(tmp_path / "bad.npz"), bad)


@pytest.mark.parametrize("module", ["atomsmm_tpu.system", "os",
                                    "atomsmm_tpu_torchx.system"])
def test_load_system_refuses_other_modules(tmp_path, module):
    """A System file names classes by module; only modules under
    atomsmm_tpu_torch. are imported (not the JAX package, whose name the
    port's starts with, nor any other)."""
    import json

    system, _, _ = tmodels.argon_system(n=8, jitter=0.0, seed=0, r_cut=0.3,
                                        r_switch=0.25, dtype=F64,
                                        device="cpu")
    path = str(tmp_path / "system.npz")
    save_system(path, system)
    with np.load(path) as data:
        arrays = dict(data)
    tree = json.loads(str(arrays["__tree__"]))
    tree["__class__"] = f"{module}:System"
    arrays["__tree__"] = np.asarray(json.dumps(tree))
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="refusing to import"):
        load_system(path, device="cpu")


def test_openmm_style_camelcase_aliases(tmp_path):
    system, x, box = tmodels.argon_system(n=64, jitter=0.05, seed=1,
                                          r_cut=0.5, r_switch=0.4,
                                          dtype=F64, device="cpu")
    sim = tamm.Simulation(system, tamm.VelocityVerletIntegrator(dt=0.001),
                          tamm.make_state(x, box=box))
    sim.setPositions(x)
    sim.setVelocitiesToTemperature(120.0, seed=2)
    sim.minimizeEnergy(20)
    ctx = sim.context
    ctx.setParameter("lambda_vdw", 0.5)
    assert float(ctx.getParameter("lambda_vdw")) == 0.5
    assert np.isfinite(float(ctx.getState().potential_energy))
    sim.step(3)
    p = str(tmp_path / "ck.npz")
    sim.saveCheckpoint(p)
    x_after = ctx.state.x.clone()
    sim.step(3)
    sim.loadCheckpoint(p)
    assert torch.equal(ctx.state.x, x_after)
    assert sim.current_step == 3


def test_pdb_reporter(argon_sim):
    buf = io.StringIO()
    argon_sim.reporters.append(
        tamm.PDBReporter(buf, interval=20, atom_name=["AR"] * 125,
                         residue_name=["AR"] * 125))
    argon_sim.step(40)
    text = buf.getvalue()
    assert text.count("MODEL") == 2 and text.count("ENDMDL") == 2
    pdb = tamm.read_pdb(text)
    assert len(pdb.positions) == 125
    assert pdb.atom_name[0] == "AR"
    assert pdb.box is not None


# -- tests/test_smoke.py: the reporter and checkpoint round trip ------------


def test_reporter_and_checkpoint_roundtrip(tmp_path):
    system, x, box = tmodels.water_system(n_molecules=125, r_cut=0.75,
                                          r_switch=0.65, dtype=F64,
                                          device="cpu")
    integ = tamm.VelocityVerletIntegrator(dt=0.001)
    stream = io.StringIO()
    sim = tamm.Simulation(system, integ, tamm.make_state(x, box=box))
    sim.set_positions(x)
    sim.context.set_velocities_to_temperature(300.0, seed=9)
    sim.reporters.append(tamm.StateDataReporter(stream, 5))
    sim.step(10)
    assert len(stream.getvalue().strip().splitlines()) >= 3
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, sim.context.state)
    state2 = load_checkpoint(path, like=sim.context.state)
    _state_equal(state2, _snapshot(sim.context.state))


# -- the PDB cases of tests/test_amber.py ------------------------------------


def test_pdb_roundtrip(tmp_path):
    from atomsmm_tpu.io import read_pdb as jread

    rs = np.random.RandomState(2)
    x = rs.uniform(0, 2.0, (7, 3))
    box = np.array([2.0, 2.5, 3.0])
    p = tmp_path / "out.pdb"
    tamm.write_pdb(p, x, box=box,
                   atom_name=["O", "H1", "H2", "O", "H1", "H2", "NA"],
                   residue_name=["WAT"] * 6 + ["ION"],
                   residue_id=[1, 1, 1, 2, 2, 2, 3])
    pdb = tamm.read_pdb(p)
    np.testing.assert_allclose(pdb.positions, x, atol=6e-5)
    np.testing.assert_allclose(pdb.box, box, atol=1e-4)
    assert pdb.atom_name[:3] == ["O", "H1", "H2"]
    assert pdb.residue_name[-1] == "ION"
    assert list(pdb.residue_id) == [1, 1, 1, 2, 2, 2, 3]
    jpdb = jread(p)
    np.testing.assert_array_equal(pdb.positions, jpdb.positions)
    np.testing.assert_array_equal(pdb.box, jpdb.box)


def test_pdb_columns_wide_and_negative_coords(tmp_path):
    from atomsmm_tpu.io import write_pdb as jwrite

    x = np.array([[12.3456, -10.0123, 100.0], [-0.001, 0.002, -0.003]])
    kw = dict(box=np.array([300.0, 300.0, 300.0]), atom_name=["O", "H1"],
              residue_name=["WAT"] * 2, residue_id=[1, 1], chain=["B", "B"])
    p = tmp_path / "wide.pdb"
    tamm.write_pdb(p, x, **kw)
    lines = [ln for ln in p.read_text().splitlines() if ln.startswith("ATOM")]
    for ln in lines:
        assert ln[21] == "B"
        assert ln[26:30] == "    "
        float(ln[30:38]), float(ln[38:46]), float(ln[46:54])
    pdb = tamm.read_pdb(p)
    np.testing.assert_allclose(pdb.positions, x, atol=6e-5)
    assert pdb.chain == ["B", "B"]
    jbuf = io.StringIO()
    jwrite(jbuf, x, **kw)
    assert p.read_text() == jbuf.getvalue()


def test_pdb_serial_wraps_past_99999():
    from atomsmm_tpu_torch.io.pdb import format_model

    lines = format_model(np.zeros((3, 3)))
    assert f"{(99999 + 1) % 100000:5d}".strip() == "0"
    assert f"{(100000 + 1) % 100000:5d}".strip() == "1"
    assert lines[0][6:11].strip() == "1"


def test_pdb_triclinic_box():
    from atomsmm_tpu.io import read_pdb as jread

    text = (
        "CRYST1   20.000   20.000   20.000  90.00 109.47  90.00 P 1           1\n"
        "ATOM      1  O   WAT     1       0.000   0.000   0.000  1.00  0.00           O\n"
        "END\n"
    )
    pdb = tamm.read_pdb(text)
    assert pdb.box.shape == (3, 3)
    np.testing.assert_allclose(np.linalg.norm(pdb.box, axis=1), 2.0,
                               rtol=1e-6)
    np.testing.assert_array_equal(pdb.box, jread(text).box)


# -- FIRE, profiling and the small surface ----------------------------------


@pytest.mark.parametrize("model,cells", [("argon", False), ("argon", True),
                                         ("water", False), ("water", True)])
def test_fire_minimize_matches_jax(model, cells):
    """100 FIRE iterations: the port (its dense oracle, or its cell lists
    rebuilt every iteration) against the JAX package's dense FIRE, 1e-9
    nm; the energy falls."""
    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.minimize import fire_minimize as jfire
    from atomsmm_tpu_torch.minimize import fire_minimize
    from atomsmm_tpu_torch.potential import potential_energy

    if model == "argon":
        kw, tb, jb = (dict(n=125, jitter=0.05, seed=1),
                      tmodels.argon_system, jmodels.argon_system)
    else:
        kw, tb, jb = (dict(n_molecules=64, r_cut=0.55, r_switch=0.45),
                      tmodels.water_system, jmodels.water_system)
    system, x, box = tb(**kw, neighbors=cells, dtype=F64, device="cpu")
    xm = fire_minimize(system, x, box, steps=100)
    jsys, jx, jbox = jb(**kw)
    np.testing.assert_allclose(xm.numpy(),
                               np.asarray(jfire(jsys, jx, jbox, steps=100)),
                               atol=1e-9)
    assert float(potential_energy(system, xm, box)) < float(
        potential_energy(system, x, box))


def test_minimize_energy_retunes_an_overflowing_spec():
    """A cell capacity the starting configuration overflows is retuned
    from it, and the minimization runs again (one read after the loop)."""
    from atomsmm_tpu_torch.minimize import minimize_energy
    from atomsmm_tpu_torch.utils import replace

    system, x, box = tmodels.argon_system(n=125, jitter=0.05, seed=1,
                                          neighbors=True, dtype=F64,
                                          device="cpu")
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(x, box=box))
    ctx.system = replace(ctx.system, neighbors=replace(
        ctx.system.neighbors, cell_capacity=4))
    minimize_energy(ctx, steps=20)
    assert ctx.system.neighbors.cell_capacity > 4
    ref = tmodels.argon_system(n=125, jitter=0.05, seed=1, dtype=F64,
                               device="cpu")[0]
    from atomsmm_tpu_torch.minimize import fire_minimize

    np.testing.assert_allclose(ctx.state.x.numpy(),
                               fire_minimize(ref, x, box, steps=20).numpy(),
                               atol=1e-12)


def test_profiling_keys_match_jax(tmp_path):
    """profile_forces gives the JAX package's keys (one per force group
    and the loop's overhead), positive milliseconds; profile_step a
    positive time; trace writes a Chrome trace."""
    import atomsmm_tpu as jamm
    from atomsmm_tpu.models import water_system as jwater
    from atomsmm_tpu.profiling import profile_forces as jprofile
    from atomsmm_tpu_torch.profiling import profile_forces, profile_step, \
        trace

    kw = dict(n_molecules=64, r_cut=0.55, r_switch=0.45)
    system, x, box = tmodels.water_system(**kw, neighbors=True, dtype=F64,
                                          device="cpu")
    respa = tamm.RESPASystem(system, rcut_in=0.35, rswitch_in=0.3)
    ctx = tamm.Context(respa, tamm.VelocityVerletIntegrator(0.001),
                       tamm.make_state(x, box=box))
    out = profile_forces(ctx, reps=2)
    jsys, jx, jbox = jwater(**kw)
    jctx = jamm.Context(jamm.RESPASystem(jsys, rcut_in=0.35, rswitch_in=0.3),
                        jamm.VelocityVerletIntegrator(0.001),
                        jamm.make_state(jx, box=jbox))
    assert sorted(out) == sorted(jprofile(jctx, reps=2))
    assert all(v > 0 for v in out.values())
    assert profile_step(ctx, steps=2, tries=1) > 0
    with trace(str(tmp_path / "tb")) as prof:
        ctx.step(1)
    assert prof.trace_file.startswith(str(tmp_path / "tb"))
    with open(prof.trace_file) as fh:
        assert "traceEvents" in fh.read()


def test_small_surface_matches_jax():
    """State.num_particles, System.force_groups, ComputingSystem and the
    shifted-force / shifted-potential transforms against the JAX
    package's."""
    import jax.numpy as jnp

    from atomsmm_tpu import ComputingSystem as JComputing
    from atomsmm_tpu import RESPASystem as JRESPA
    from atomsmm_tpu.models import water_system as jwater
    from atomsmm_tpu.ops import switching as jsw
    from atomsmm_tpu_torch.ops import switching as tsw

    kw = dict(n_molecules=27, r_cut=0.45, r_switch=0.35)
    system, x, box = tmodels.water_system(**kw, dtype=F64, device="cpu")
    jsys = jwater(**kw)[0]
    assert system.force_groups == jsys.force_groups == [0]
    comp = tamm.ComputingSystem(system)
    jcomp = JComputing(jsys)
    assert comp.force_groups == jcomp.force_groups == [0, 1]
    assert [(f.name, f.group) for f in comp.forces] == [
        (f.name, f.group) for f in jcomp.forces]
    respa = tamm.RESPASystem(system, 0.3, 0.25)
    assert respa.force_groups == JRESPA(jsys, 0.3, 0.25).force_groups \
        == [0, 1, 2]
    assert tamm.make_state(x, box=box).num_particles == 81

    def u(r, q):
        return q * (1.0 / r + r * r)

    r = np.linspace(0.2, 0.9, 8)
    for t_form, j_form in ((tsw.shifted_force, jsw.shifted_force),
                           (tsw.shifted_potential, jsw.shifted_potential)):
        ours = [float(t_form(u)(torch.tensor(ri, dtype=F64), 0.9, 1.7))
                for ri in r]
        theirs = [float(j_form(u)(jnp.float64(ri), 0.9, 1.7)) for ri in r]
        np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=1e-12)
    assert float(tsw.shifted_force(u)(torch.tensor(0.9, dtype=F64), 0.9,
                                      1.7)) == 0.0


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_checkpoint_roundtrip_on_the_card(cuda, tmp_path):
    """Save and load on the card: x, v, box, every extended variable and
    the CUDA generator's state restored bit for bit; under LangevinMiddle
    on K2 (a small box: full stencil, no atomics) the continuation equals
    the uninterrupted run bit for bit."""
    sim = _argon_sim(n=216, integrator=tamm.LangevinMiddleIntegrator(
        0.002, 120.0, 5.0), device=cuda, neighbors=True)[0]
    assert not sim.system.neighbors.half_stencil
    sim.step(10)
    path = str(tmp_path / "ck.npz")
    sim.save_checkpoint(path)
    saved = _snapshot(sim.context.state)
    sim.step(10)
    x_after = sim.context.state.x.clone()
    sim.load_checkpoint(path)
    _state_equal(sim.context.state, saved)
    assert sim.context.state.rng.device.type == "cuda"
    sim.step(10)
    assert torch.equal(sim.context.state.x, x_after)
