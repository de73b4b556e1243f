"""Drude oscillators and SWM4-NDP water in the port: the twins of
tests/test_drude.py, float64 on the CPU against the JAX package, and the
card cases (marker ``cuda``).

Oracles: analytic where possible (the spring constant, the induced dipole
alpha E in a uniform field, the bare-Coulomb limit and a hand value of
Thole screening), else the JAX package: Thole energies and forces to
1e-12, the SWM4 builder bit for bit, its energies and forces to 1e-10 on
the dense path and on cells, and 10-step SCF, extended-Lagrangian and
RESPA trajectories to 1e-9 (the baths at friction 0, so that no draw
enters). The stochastic baths are checked in distribution. The PME
excluded-pair correction takes its r -> 0 limit where a Drude sits on its
core, where the JAX package gives NaN.

The JAX package is imported inside the tests that compare with it, so that
the ``cuda`` cases run on a machine that has PyTorch alone:
    pytest tests/test_torch_drude.py -m cuda -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch.integrate.drude import (
    DrudeOrnsteinUhlenbeckPropagator,
    find_drude_set,
)
from atomsmm_tpu_torch.integrate.propagators import StepContext
from atomsmm_tpu_torch.models import swm4_water_system
from atomsmm_tpu_torch.models.water import (
    SWM4_ALPHA_O,
    SWM4_Q_D,
    SWM4_Q_H,
    SWM4_Q_M,
)
from atomsmm_tpu_torch.ops.drude import (
    drude_displacements,
    drude_scf_minimize,
    drude_spring_energy,
    drude_temperatures,
    make_drude_set,
    thole_screening_energy,
)
from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux
from atomsmm_tpu_torch.ops.settle import settle_residual
from atomsmm_tpu_torch.ops.virtual_sites import place_virtual_sites
from atomsmm_tpu_torch.potential import force_fn, potential_energy
from atomsmm_tpu_torch.units import BOLTZMANN, ONE_4PI_EPS0
from atomsmm_tpu_torch.utils import InputError

F64 = torch.float64
SMALL = dict(n_molecules=8, r_cut=0.3, r_switch=0.25)
KW = dict(n_molecules=27, r_cut=0.45, r_switch=0.4, seed=2)


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


def _swm4(device="cpu", **kw):
    return swm4_water_system(dtype=F64, device=device, **{**KW, **kw})


def _velocities(masses, seed=9):
    """One numpy Maxwell draw at 300 K, 0 on massless rows."""
    m = masses.cpu().numpy()
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) * np.sqrt(
        BOLTZMANN * 300.0 / np.where(m > 0, m, 1.0))[:, None]
    v[m == 0] = 0.0
    return v


def _moved(x, seed=0, scale=0.004, drude=0.005):
    """x jittered, and every Drude (row 1 of 5) moved `drude` nm off its
    core in a random direction."""
    rs = np.random.RandomState(seed)
    xx = x.numpy() + rs.normal(0.0, scale, tuple(x.shape))
    d = rs.normal(size=(x.shape[0] // 5, 3))
    xx[1::5] = xx[0::5] + drude * d / np.linalg.norm(d, axis=1)[:, None]
    return torch.as_tensor(xx)


def _one_dipole():
    return make_drude_set([[1, 0]], charge=[SWM4_Q_D],
                          polarizability=[SWM4_ALPHA_O], dtype=F64,
                          device="cpu")


def test_spring_constant_from_polarizability():
    ds = _one_dipole()
    k = ONE_4PI_EPS0 * SWM4_Q_D ** 2 / SWM4_ALPHA_O
    np.testing.assert_allclose(ds.k.numpy(), [k], rtol=1e-14)
    # alpha roundtrip: induced dipole per field is kC q^2 / k = alpha
    np.testing.assert_allclose(
        ONE_4PI_EPS0 * ds.charge.numpy() ** 2 / ds.k.numpy(), [SWM4_ALPHA_O],
        rtol=1e-14)
    assert ds.pairs.dtype == torch.int64


def test_scf_induced_dipole_matches_alpha_e():
    """In a uniform field E the SCF displacement is -qE/k, so the induced
    dipole is q d = -(alpha/kC) E exactly; the port's SCF takes the force
    function of that energy."""
    ds = _one_dipole()
    e_field = torch.tensor([30.0, -10.0, 50.0], dtype=F64)

    def forces(xx):
        xx = xx.detach().requires_grad_(True)
        e = drude_spring_energy(ds, xx) + ds.charge[0] * torch.dot(e_field,
                                                                   xx[1])
        return -torch.autograd.grad(e, xx)[0]

    xs = drude_scf_minimize(forces, ds, torch.zeros((2, 3), dtype=F64),
                            n_iter=6)
    mu = float(ds.charge[0]) * xs[1].numpy()
    np.testing.assert_allclose(
        mu, -float(ds.charge[0]) ** 2 * e_field.numpy() / float(ds.k[0]),
        rtol=1e-12)
    np.testing.assert_allclose(
        mu, -SWM4_ALPHA_O * e_field.numpy() / ONE_4PI_EPS0, rtol=1e-12)
    assert bool((xs[0] == 0).all())


def _two_dipole_set(a_ij):
    # dipole 0: core at origin, drude at +x*0.01; dipole 1: core at (0.4,0,0)
    ds = make_drude_set([[1, 0], [3, 2]], charge=[-1.2, -1.2],
                        polarizability=[1e-3, 1e-3], screened_pairs=[[0, 1]],
                        thole=a_ij, dtype=F64, device="cpu")
    x = torch.tensor([[0.0, 0.0, 0.0], [0.01, 0.0, 0.0], [0.4, 0.0, 0.0],
                      [0.4, 0.012, 0.0]], dtype=F64)
    return ds, x


def _bare_or_screened(x, a_ij=None):
    q = -1.2
    total = 0.0
    for i, si in ((1, +1), (0, -1)):
        for j, sj in ((3, +1), (2, -1)):
            r = float(torch.linalg.norm(x[i] - x[j]))
            f = 1.0
            if a_ij is not None:
                u = a_ij * r * (1e-3 * 1e-3) ** (-1.0 / 6.0)
                f = 1.0 - (1.0 + 0.5 * u) * np.exp(-u)
            total += si * sj * q * q * f / r
    return ONE_4PI_EPS0 * total


def test_thole_bare_coulomb_limit():
    """As a_ij -> inf, f(u) -> 1: the screened pair is the bare Coulomb sum
    of the four site-site dipole-charge terms."""
    ds, x = _two_dipole_set(a_ij=500.0)
    box = torch.full((3,), 10.0, dtype=F64)
    e = float(thole_screening_energy(ds, x, box))
    np.testing.assert_allclose(e, _bare_or_screened(x), rtol=1e-10)


def test_thole_hand_value():
    """One screened pair at a_ij = 2.6, damping evaluated by hand; the
    screening reduces the magnitude against the bare sum."""
    ds, x = _two_dipole_set(a_ij=2.6)
    box = torch.full((3,), 10.0, dtype=F64)
    e = float(thole_screening_energy(ds, x, box))
    np.testing.assert_allclose(e, _bare_or_screened(x, 2.6), rtol=1e-10)
    ds_b, _ = _two_dipole_set(a_ij=500.0)
    assert abs(e) < abs(float(thole_screening_energy(ds_b, x, box)))


@pytest.mark.parametrize("a_ij", [0.5, 2.6, 500.0])
def test_thole_and_spring_match_jax(a_ij):
    """The springs and the Thole term against the JAX package at a
    configuration with the dipoles across the periodic face (minimum
    image): energies to 1e-12, forces by autograd against jax.grad to
    1e-12 x max|F|."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.ops import drude as jd

    ds, x = _two_dipole_set(a_ij)
    x = x + torch.tensor([1.9, 0.1, 0.0], dtype=F64) * torch.tensor(
        [[0.0], [0.0], [1.0], [1.0]], dtype=F64)  # dipole 1 near the face
    box = torch.full((3,), 2.2, dtype=F64)
    jds = jd.make_drude_set([[1, 0], [3, 2]], charge=[-1.2, -1.2],
                            polarizability=[1e-3, 1e-3],
                            screened_pairs=[[0, 1]], thole=a_ij)

    def port(xx):
        return drude_spring_energy(ds, xx) + thole_screening_energy(ds, xx,
                                                                    box)

    def ref(xx):
        return (jd.drude_spring_energy(jds, xx)
                + jd.thole_screening_energy(jds, xx, jnp.asarray(box.numpy())))

    xx = x.clone().requires_grad_(True)
    e = port(xx)
    (g,) = torch.autograd.grad(e, xx)
    xj = jnp.asarray(x.numpy())
    ej, gj = float(ref(xj)), np.asarray(jax.grad(ref)(xj))
    assert float(e.detach()) == pytest.approx(ej, rel=1e-12)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                               atol=1e-12 * np.abs(gj).max())


def test_swm4_builder_matches_jax_exactly():
    """Positions, masses, charges, exclusions and the SETTLE, virtual-site
    and Drude sets equal the JAX builder's bit for bit (EL and SCF
    masses); each molecule is neutral and the masses sum to water's."""
    from atomsmm_tpu.models import swm4_water_system as jax_swm4

    for drude_mass in (0.4, 0.0):
        system, x, box = swm4_water_system(drude_mass=drude_mass,
                                           dtype=F64, device="cpu", **SMALL)
        js, jx, jb = jax_swm4(drude_mass=drude_mass, **SMALL)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(box.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(system.masses.numpy(),
                                      np.asarray(js.masses))
        nb, jnb = system.forces[0], js.forces[0]
        for k in ("charge", "sigma", "epsilon", "exclusions"):
            np.testing.assert_array_equal(getattr(nb, k).numpy(),
                                          np.asarray(getattr(jnb, k)))
        for k in ("triplets", "ra", "rb", "rc"):
            np.testing.assert_array_equal(getattr(system.settle, k).numpy(),
                                          np.asarray(getattr(js.settle, k)))
        for k in ("sites", "parents", "weights", "oop"):
            np.testing.assert_array_equal(
                getattr(system.virtual_sites, k).numpy(),
                np.asarray(getattr(js.virtual_sites, k)))
        ds, jds = find_drude_set(system), js.forces[1].drude
        for k in ("pairs", "charge", "alpha", "k"):
            np.testing.assert_array_equal(getattr(ds, k).numpy(),
                                          np.asarray(getattr(jds, k)))
        assert ds.screened_pairs is None and jds.screened_pairs is None
    q = nb.charge.numpy().reshape(8, 5)
    np.testing.assert_allclose(q.sum(axis=1), 0.0, atol=1e-12)
    np.testing.assert_allclose(q[:, 0], -SWM4_Q_D)
    np.testing.assert_allclose(2 * SWM4_Q_H + SWM4_Q_M, 0.0, atol=1e-12)
    el, _, _ = swm4_water_system(dtype=F64, device="cpu", **SMALL)
    m = el.masses.numpy().reshape(8, 5)
    np.testing.assert_allclose(m[:, 4], 0.0)
    np.testing.assert_allclose(m[:, 1], 0.4)
    np.testing.assert_allclose(m.sum(axis=1), 15.9994 + 2 * 1.008,
                               rtol=1e-12)


@pytest.mark.parametrize("neighbors", [False, True], ids=["dense", "cells"])
def test_swm4_energy_and_forces_match_jax(neighbors):
    """The port's SWM4 (dense oracle or cell lists) against the JAX
    package's dense path: at the builder's positions (every Drude on its
    core) and with the Drudes moved off: energy to 1e-10, forces to 1e-9 x
    max|F|, the M rows exactly zero."""
    import jax.numpy as jnp

    from atomsmm_tpu.models import swm4_water_system as jax_swm4
    from atomsmm_tpu.potential import force_fn as jforce_fn

    system, x, box = _swm4(neighbors=neighbors)
    js, _, jb = jax_swm4(**KW)
    for xx in (x, _moved(x)):
        aux = (make_aux(system, all_neighbor_extras(system, xx, box))
               if neighbors else None)
        e, f = force_fn(system)(xx, box, {}, aux)
        ej, fj = jforce_fn(js)(jnp.asarray(xx.numpy()), jb, {}, None)
        fj = np.asarray(fj)
        assert float(e) == pytest.approx(float(ej), rel=1e-10)
        np.testing.assert_allclose(f.numpy(), fj, rtol=0,
                                   atol=1e-9 * np.abs(fj).max())
        assert bool((f[system.virtual_sites.sites] == 0).all())


def test_drude_temperatures_match_jax():
    import jax.numpy as jnp

    from atomsmm_tpu.ops.drude import drude_temperatures as jtemps

    system, _, _ = _swm4()
    ds = find_drude_set(system)
    v = _velocities(system.masses, seed=3)
    ta, td = drude_temperatures(ds, torch.as_tensor(v), system.masses,
                                n_constraints=system.num_constraints)
    from atomsmm_tpu.models import swm4_water_system as jax_swm4

    js, _, _ = jax_swm4(**KW)
    jta, jtd = jtemps(js.forces[1].drude, jnp.asarray(v), js.masses,
                      n_constraints=js.num_constraints)
    assert float(ta) == pytest.approx(float(jta), rel=1e-12)
    assert float(td) == pytest.approx(float(jtd), rel=1e-12)


def test_degrees_of_freedom_count_massless_drudes_as_jax_does():
    """The JAX package's count_degrees_of_freedom takes 3 off per virtual
    site and per constraint but counts a massless SCF Drude's three rows
    (its DrudeSCFIntegrator docstring says otherwise); the port keeps that
    count, so that temperatures agree."""
    from atomsmm_tpu.models import swm4_water_system as jax_swm4
    from atomsmm_tpu.utils import count_degrees_of_freedom as jdof

    m = SMALL["n_molecules"]
    for drude_mass in (0.4, 0.0):
        system, _, _ = swm4_water_system(drude_mass=drude_mass, dtype=F64,
                                         device="cpu", **SMALL)
        dof = tamm.count_degrees_of_freedom(system)
        # 15m coordinates - 3m SETTLE - 3m virtual rows - 3 (COM)
        assert dof == 9 * m - 3
        assert dof == jdof(jax_swm4(drude_mass=drude_mass, **SMALL)[0])


def test_maxwell_massless_rows():
    """maxwell_boltzmann_velocities hands massless rows zero velocity."""
    masses = torch.tensor([15.6, 0.4, 1.008, 1.008, 0.0], dtype=F64)
    v = tamm.maxwell_boltzmann_velocities(torch.Generator().manual_seed(0),
                                          masses, 300.0)
    assert bool(torch.isfinite(v).all())
    assert bool((v[4] == 0).all())
    assert float(v[:4].abs().max()) > 0.0


def test_langevin_with_massless_drudes_is_rejected():
    """DrudeLangevinIntegrator refuses an SCF-configured system; the OU
    propagator driven directly on massless pairs stays finite and pins
    v_rel = 0 exactly (checked without SETTLE, whose projection moves the
    core rows)."""
    system, x, box = swm4_water_system(drude_mass=0.0, dtype=F64,
                                       device="cpu", **SMALL)
    with pytest.raises(InputError, match="DrudeSCFIntegrator"):
        tamm.DrudeLangevinIntegrator(0.001, 300.0, system=system)
    ds = find_drude_set(system)
    prop = DrudeOrnsteinUhlenbeckPropagator(ds, 300.0, 5.0, 1.0, 20.0)
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.001),
                       tamm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=7)
    free = dataclasses.replace(system, constraints=None, settle=None)
    out = prop.apply(StepContext(free, {}, 0.001), ctx.state, 1.0)
    v = out.v
    assert bool(torch.isfinite(v).all())
    di, ci = ds.pairs[:, 0], ds.pairs[:, 1]
    np.testing.assert_array_equal(v[di].numpy(), v[ci].numpy())


def test_describe_lists_dual_bath():
    system, _, _ = swm4_water_system(dtype=F64, device="cpu", **SMALL)
    text = tamm.DrudeLangevinIntegrator(0.001, 300.0,
                                        system=system).describe()
    assert "v_rel" in text and "T=1.0K" in text and "T=300.0K" in text
    import atomsmm_tpu as jamm
    from atomsmm_tpu.models import swm4_water_system as jax_swm4

    js, _, _ = jax_swm4(**SMALL)
    assert text == jamm.DrudeLangevinIntegrator(0.001, 300.0,
                                                system=js).describe()
    scf, _, _ = swm4_water_system(drude_mass=0.0, dtype=F64, device="cpu",
                                  **SMALL)
    jscf, _, _ = jax_swm4(drude_mass=0.0, **SMALL)
    assert (tamm.DrudeSCFIntegrator(0.001, 12, 300.0, system=scf).describe()
            == jamm.DrudeSCFIntegrator(0.001, 12, 300.0,
                                       system=jscf).describe())


def test_drude_force_stays_in_group_zero_under_respa():
    """RESPASystem leaves DrudeForce in group 0 (bond-like), and the split
    energies sum to the unsplit total, as in the JAX package."""
    import jax.numpy as jnp

    import atomsmm_tpu as jamm
    from atomsmm_tpu.models import swm4_water_system as jax_swm4

    system, x, box = _swm4()
    x = _moved(x, seed=4)
    rsys = tamm.RESPASystem(system, rcut_in=0.3, rswitch_in=0.25)
    assert [f.group for f in rsys.forces if f.name == "DrudeForce"] == [0]
    e_full = float(potential_energy(system, x, box))
    groups = sorted({f.group for f in rsys.forces})
    parts = [float(potential_energy(rsys, x, box, groups=[g]))
             for g in groups]
    assert sum(parts) == pytest.approx(e_full, rel=1e-10)
    js, _, jb = jax_swm4(**KW)
    jr = jamm.RESPASystem(js, rcut_in=0.3, rswitch_in=0.25)
    from atomsmm_tpu.potential import potential_energy as jpe

    for g, part in zip(groups, parts):
        want = float(jpe(jr, jnp.asarray(x.numpy()), jb, {}, groups=[g]))
        assert part == pytest.approx(want, rel=1e-10, abs=1e-10)


def _trajectory_pair(case):
    """(port Context, JAX Context) of 27 SWM4 waters from one numpy
    velocity draw: the port on cell lists, the JAX package dense."""
    import atomsmm_tpu as jamm
    from atomsmm_tpu.integrate.drude import (
        DrudeOrnsteinUhlenbeckPropagator as JaxBath,
    )
    from atomsmm_tpu.integrate.drude import find_drude_set as jax_find
    from atomsmm_tpu.models import swm4_water_system as jax_swm4

    drude_mass = 0.0 if case == "scf" else 0.4
    js, jx, jb = jax_swm4(drude_mass=drude_mass, **KW)
    system, _, box = _swm4(drude_mass=drude_mass, neighbors=True)
    if case == "scf":
        ji = jamm.DrudeSCFIntegrator(0.001, n_iter=8, system=js)
        ti = tamm.DrudeSCFIntegrator(0.001, n_iter=8, system=system)
    elif case == "el":
        ji = jamm.DrudeLangevinIntegrator(0.001, 300.0, friction=0.0,
                                          drude_friction=0.0, system=js)
        ti = tamm.DrudeLangevinIntegrator(0.001, 300.0, friction=0.0,
                                          drude_friction=0.0, system=system)
    else:
        js = jamm.RESPASystem(js, rcut_in=0.3, rswitch_in=0.25)
        system = tamm.RESPASystem(system, rcut_in=0.3, rswitch_in=0.25)
        ji = jamm.MultipleTimeScaleIntegrator(0.002, [2, 1], baths={
            -1: JaxBath(jax_find(js), 300.0, 0.0, 1.0, 0.0)})
        ti = tamm.MultipleTimeScaleIntegrator(0.002, [2, 1], baths={
            -1: DrudeOrnsteinUhlenbeckPropagator(find_drude_set(system),
                                                 300.0, 0.0, 1.0, 0.0)})
    v = _velocities(system.masses)
    jctx = jamm.Context(js, ji, jamm.make_state(jx, v=v, box=jb))
    ctx = tamm.Context(system, ti, tamm.make_state(
        torch.as_tensor(np.array(jx)), v=torch.as_tensor(v), box=box))
    return ctx, jctx


@pytest.mark.parametrize("case", ["scf", "el", "mts"])
def test_trajectory_matches_jax(case):
    """10 outer steps: DrudeSCFIntegrator with no bath, 1 fs;
    DrudeLangevinIntegrator at friction 0 and drude_friction 0 (the draws
    are multiplied by 0), 1 fs; RESPASystem + MTS [2, 1] @ 2 fs with the
    Drude bath at friction 0 outside the outer level. x and v to 1e-9 of
    their largest entry; the geometry exact, the M rows placed and at
    rest, and under SCF the Drude velocity rows exactly zero."""
    ctx, jctx = _trajectory_pair(case)
    jctx.step(10)
    ctx.step(10)
    for got, want in ((ctx.state.x, jctx.state.x),
                      (ctx.state.v, jctx.state.v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
    system, xs, vs = ctx.system, ctx.state.x, ctx.state.v
    sites = system.virtual_sites.sites
    assert bool((vs[sites] == 0).all())
    np.testing.assert_allclose(
        place_virtual_sites(system.virtual_sites, xs)[sites].numpy(),
        xs[sites].numpy(), atol=1e-12)
    assert float(settle_residual(system.settle, xs)) < 1e-10
    if case == "scf":
        assert bool((vs[1::5] == 0).all())


def test_scf_dynamics_stay_on_the_born_oppenheimer_surface():
    """DrudeSCFIntegrator with its Langevin bath, 100 steps of 8 waters:
    the force on every Drude row is negligible against the atomic forces,
    the geometry exact, the Drude rows at rest, nothing NaN, and the
    displacements physical (< 0.05 nm)."""
    system, x, box = swm4_water_system(drude_mass=0.0, dtype=F64,
                                       device="cpu", **SMALL)
    ctx = tamm.Context(system, tamm.DrudeSCFIntegrator(
        0.001, n_iter=8, temperature=300.0, system=system),
        tamm.make_state(x, v=torch.as_tensor(_velocities(system.masses, 3)),
                        box=box))
    ctx.step(100)
    e, f = force_fn(system)(ctx.state.x, ctx.state.box, {})
    assert np.isfinite(float(e))
    ds = find_drude_set(system)
    di = ds.pairs[:, 0]
    assert float(f[di].abs().max()) < 1e-4 * float(f.abs().max())
    assert bool((ctx.state.v[di] == 0).all())
    assert float(settle_residual(system.settle, ctx.state.x)) < 1e-10
    d = drude_displacements(ds, ctx.state.x)
    assert float(torch.linalg.norm(d, dim=1).max()) < 0.05


def test_dual_bath_stationary_distribution():
    """The dual OU bath alone (no forces), 300 applications of 0.1 ps to 32
    SETTLE waters from rest: over the last 200 the atoms and pair centres
    sit at 300 K and the relative Drude motion near 1 K. The SETTLE
    projection after each application moves the core rows, which warms
    the relative motion a little above its bath (1.27 K here; the JAX
    package's stream gives 1.32 K)."""
    system, x, box = swm4_water_system(n_molecules=32, r_cut=0.45,
                                       r_switch=0.4, dtype=F64, device="cpu")
    ds = find_drude_set(system)
    bath = DrudeOrnsteinUhlenbeckPropagator(ds, 300.0, 5.0, 1.0, 20.0)
    state = tamm.make_state(x, box=box, seed=3)
    ctx = StepContext(system, {}, 0.1)
    tas, tds = [], []
    for i in range(300):
        state = bath.apply(ctx, state, 1.0)
        if i >= 100:
            ta, td = drude_temperatures(ds, state.v, system.masses,
                                        n_constraints=system.num_constraints)
            tas.append(float(ta))
            tds.append(float(td))
    assert 280.0 < np.mean(tas) < 320.0, np.mean(tas)
    assert 1.0 < np.mean(tds) < 1.6, np.mean(tds)
    assert bool((state.v[system.virtual_sites.sites] == 0).all())


def test_extended_lagrangian_dynamics_keep_the_dipoles_cold():
    """DrudeLangevinIntegrator at its default baths, 300 steps of 8 waters
    at 1 fs from the lattice, whose relaxation heats the atoms to about
    1,000 K: the 5/ps bath cools them while the 20/ps cold bath keeps the
    relative Drude motion below 15 K over the last 90 steps (JAX's bound);
    geometry exact, dipoles physical."""
    system, x, box = swm4_water_system(dtype=F64, device="cpu", **SMALL)
    integ = tamm.DrudeLangevinIntegrator(0.001, 300.0, system=system)
    ctx = tamm.Context(system, integ, tamm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=1)
    tas, tds = [], []
    for _ in range(10):
        ctx.step(30)
        ta, td = drude_temperatures(integ.thermostat.drude, ctx.state.v,
                                    system.masses,
                                    n_constraints=system.num_constraints)
        tas.append(float(ta))
        tds.append(float(td))
    assert np.mean(tds[-3:]) < 15.0, tds
    assert np.mean(tas[-3:]) < tas[0], tas
    assert float(settle_residual(system.settle, ctx.state.x)) < 1e-10
    d = drude_displacements(integ.thermostat.drude, ctx.state.x)
    assert float(torch.linalg.norm(d, dim=1).max()) < 0.05


def test_pme_exclusion_correction_takes_the_coincident_limit():
    """Under PME every Drude on its core makes an excluded pair at r = 0:
    the port takes the r -> 0 limit (energy -k qq 2 alpha/sqrt(pi), force
    0) and is finite there. The mean of the JAX package's energies and
    forces at the Drudes moved by +-1e-7 nm cancels the first-order term
    and agrees with the port's limit to 1e-9 (energy, relative; forces, of
    max|F|); at 0.005 nm both packages agree to 1e-10."""
    import jax.numpy as jnp

    from atomsmm_tpu.models import swm4_water_system as jax_swm4
    from atomsmm_tpu.potential import force_fn as jforce_fn

    system, x, box = swm4_water_system(method="pme", dtype=F64,
                                       device="cpu", **SMALL)
    js, _, jb = jax_swm4(method="pme", **SMALL)
    e0, f0 = force_fn(system)(x, box, {})
    assert np.isfinite(float(e0)) and bool(torch.isfinite(f0).all())
    rs = np.random.RandomState(0)
    u = rs.normal(size=(SMALL["n_molecules"], 3))
    u /= np.linalg.norm(u, axis=1)[:, None]

    def jax_at(shift):
        xx = x.numpy().copy()
        xx[1::5] += shift * u
        e, f = jforce_fn(js)(jnp.asarray(xx), jb, {}, None)
        return float(e), np.asarray(f), xx

    (ep, fp, _), (em, fm, _) = jax_at(1e-7), jax_at(-1e-7)
    e_mean, f_mean = 0.5 * (ep + em), 0.5 * (fp + fm)
    assert float(e0) == pytest.approx(e_mean, rel=1e-9)
    np.testing.assert_allclose(f0.numpy(), f_mean, rtol=0,
                               atol=1e-9 * np.abs(f_mean).max())
    ej, fj, xx = jax_at(0.005)
    e, f = force_fn(system)(torch.as_tensor(xx), box, {})
    assert float(e) == pytest.approx(ej, rel=1e-10)
    np.testing.assert_allclose(f.numpy(), fj, rtol=0,
                               atol=1e-10 * np.abs(fj).max())


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_drude_ops_on_the_card_match_the_cpu(cuda):
    """Springs, Thole screening, the SCF fixed point and the dual bath at
    friction 0 on the card against the CPU, float64, 1e-12."""
    ds, x = _two_dipole_set(2.6)
    box = torch.full((3,), 10.0, dtype=F64)
    dsg = make_drude_set([[1, 0], [3, 2]], charge=[-1.2, -1.2],
                         polarizability=[1e-3, 1e-3], screened_pairs=[[0, 1]],
                         thole=2.6, dtype=F64, device=cuda)
    out = []
    for s, xx, b in ((ds, x, box), (dsg, x.to(cuda), box.to(cuda))):
        xx = xx.clone().requires_grad_(True)
        e = drude_spring_energy(s, xx) + thole_screening_energy(s, xx, b)
        (g,) = torch.autograd.grad(e, xx)
        out.append((float(e.detach()), g.cpu().numpy()))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-12)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=0,
                               atol=1e-12 * np.abs(out[0][1]).max())
    system, x, box = _swm4(neighbors=True)
    gsys, _, gbox = _swm4(neighbors=True, device=cuda)
    xm = _moved(x)
    results = []
    for s, xx, b in ((system, xm, box), (gsys, xm.to(cuda), gbox)):
        aux = make_aux(s, all_neighbor_extras(s, xx, b))
        xs = drude_scf_minimize(lambda y: force_fn(s)(y, b, {}, aux)[1],
                                find_drude_set(s), xx, n_iter=4)
        ctx = StepContext(s, {}, 0.001)
        st = tamm.make_state(xs, v=torch.as_tensor(
            _velocities(system.masses), device=xs.device), box=b)
        bath = DrudeOrnsteinUhlenbeckPropagator(find_drude_set(s), 300.0,
                                                0.0, 1.0, 0.0)
        results.append((xs.cpu(), bath.apply(ctx, st, 1.0).v.cpu()))
    for got, want in zip(results[1], results[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12 * float(want.abs().max()))


@pytest.mark.cuda
def test_swm4_steps_on_the_card(cuda):
    """Float32 SWM4 on the card, 216 waters on cells: 20 extended-
    Lagrangian steps, then 5 SCF steps from those positions with the
    Drude rows at rest. Finite, geometry to float32 rounding, the M rows
    placed and at rest, the dipoles physical; PME at the builder's
    positions (cell lists) finite and equal to the CPU's in float64."""
    f32 = torch.float32
    kw = dict(n_molecules=216, r_cut=0.6, r_switch=0.5, neighbors=True)
    system, x, box = swm4_water_system(dtype=f32, device=cuda, **kw)
    ctx = tamm.Context(system, tamm.DrudeLangevinIntegrator(
        0.001, 300.0, system=system), tamm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=1)
    ctx.step(20)
    scf, _, _ = swm4_water_system(drude_mass=0.0, dtype=f32, device=cuda,
                                  **kw)
    v = ctx.state.v.clone()
    m = system.masses[:, None]
    v[0::5] = (m[0::5] * v[0::5] + m[1::5] * v[1::5]) / (m[0::5] + m[1::5])
    v[1::5] = 0.0
    sctx = tamm.Context(scf, tamm.DrudeSCFIntegrator(
        0.001, n_iter=8, temperature=300.0, system=scf),
        tamm.make_state(ctx.state.x, v=v, box=box))
    sctx.step(5)
    for c in (ctx, sctx):
        xs, vs, s = c.state.x, c.state.v, c.system
        sites = s.virtual_sites.sites
        assert bool(torch.isfinite(xs).all() and torch.isfinite(vs).all())
        assert bool((vs[sites] == 0).all())
        assert float(settle_residual(s.settle, xs.double())) < 1e-4
        placed = place_virtual_sites(s.virtual_sites, xs)
        assert float((placed[sites] - xs[sites]).abs().max()) < 1e-6
        d = drude_displacements(find_drude_set(s), xs)
        assert float(torch.linalg.norm(d, dim=1).max()) < 0.05
    assert bool((sctx.state.v[1::5] == 0).all())
    out = []
    for dev in (cuda, "cpu"):
        s, xs, b = _swm4(method="pme", neighbors=True, device=dev)
        out.append(force_fn(s)(xs, b, {}, make_aux(
            s, all_neighbor_extras(s, xs, b))))
    (eg, fg), (ec, fc) = out
    assert np.isfinite(float(eg)) and float(eg) == pytest.approx(float(ec),
                                                                 rel=1e-10)
    np.testing.assert_allclose(fg.cpu().numpy(), fc.numpy(), rtol=0,
                               atol=1e-9 * float(fc.abs().max()))
