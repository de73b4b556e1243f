"""Triclinic (3, 3) boxes in the port: the twins of tests/test_triclinic.py,
float64 on the CPU against the JAX package and the JAX tests' own oracles,
and the card cases (marker ``cuda``).

A (3, 3) reduced cell matrix (rows = lattice vectors) runs through the
port's pbc helpers, the dense oracle, the cell lists (the grid sized from
perpendicular widths, fractional binning), the cell sweeps (K1 and K2 on
the card, their plain twins here, rounding each slot in fractional
coordinates) and PME (fractional spreading, the reciprocal metric). Oracles: a brute-force 125-image search, the supercell
identity E(2x2x2 cell) = 8 E(cell), the plane-wave Ewald sum, NVE
conservation, a finite-difference virial, and the JAX package at 1e-10
(energies) and 1e-9 max|F| (forces).

The JAX package is imported inside the tests that compare with it, so that
the ``cuda`` cases run on a machine that has PyTorch alone:
    pytest tests/test_torch_triclinic.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch.models import argon_system, water_system
from atomsmm_tpu_torch.ops.neighbors import (
    all_neighbor_extras,
    assert_neighbor_health,
    make_aux,
    make_neighbor_spec,
)
from atomsmm_tpu_torch.ops.pbc import (
    box_volume,
    max_cutoff,
    minimum_image,
    perp_widths,
    triclinic_from_lengths_angles,
    wrap_positions,
)
from atomsmm_tpu_torch.potential import force_fn, potential_energy
from atomsmm_tpu_torch.utils import InputError, replace

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


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _reduced_cell():
    # monoclinic-ish, genuinely sheared, reduced (tests/test_triclinic.py)
    return triclinic_from_lengths_angles(2.2, 2.0, 2.4, 90.0, 105.0, 80.0)


def _lattice_argon(h, g, jitter, seed, r_cut, r_switch, device="cpu"):
    """Argon on a g^3 fractional lattice of the cell h, jittered, with a
    cell list built for h; (system, x)."""
    rs = np.random.RandomState(seed)
    frac = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) / g
    frac = frac + rs.uniform(-jitter, jitter, frac.shape)
    x = frac @ h
    n = x.shape[0]
    system, _, _ = argon_system(n=n, jitter=0.0, seed=2, r_cut=r_cut,
                                r_switch=r_switch, dtype=F64, device=device)
    system = replace(system, default_box=_t(h).to(device))
    spec = make_neighbor_spec(h, n, r_cut, occupancy_floor_from=x,
                              device=device)
    return system.with_neighbors(spec), _t(x).to(device)


def test_minimum_image_matches_brute_force():
    from atomsmm_tpu.ops.pbc import minimum_image as jmin

    h = _reduced_cell()
    rc = max_cutoff(h)
    rs = np.random.RandomState(0)
    dx = rs.uniform(-4, 4, (256, 3))
    shifts = np.array([(i, j, k) for i in range(-2, 3)
                       for j in range(-2, 3) for k in range(-2, 3)]) @ h
    imgs = dx[:, None, :] - shifts[None, :, :]
    brute = imgs[np.arange(len(dx)),
                 np.argmin(np.linalg.norm(imgs, axis=2), axis=1)]
    ours = minimum_image(_t(dx), _t(h)).numpy()
    sel = np.linalg.norm(brute, axis=1) < rc
    assert sel.sum() > 50
    np.testing.assert_allclose(ours[sel], brute[sel], atol=1e-10)
    np.testing.assert_allclose(ours, np.asarray(jmin(dx, h)), atol=1e-12)


def test_wrap_positions_in_cell():
    from atomsmm_tpu.ops.pbc import wrap_positions as jwrap

    h = _reduced_cell()
    rs = np.random.RandomState(1)
    x = rs.uniform(-5, 5, (32, 3))
    xw = wrap_positions(_t(x), _t(h)).numpy()
    s = xw @ np.linalg.inv(h)
    assert (s >= -1e-12).all() and (s < 1 + 1e-12).all()
    ds = (x - xw) @ np.linalg.inv(h)
    np.testing.assert_allclose(ds, np.round(ds), atol=1e-10)
    np.testing.assert_allclose(xw, np.asarray(jwrap(x, h)), atol=1e-12)


def test_volume_and_max_cutoff():
    from atomsmm_tpu.ops import pbc as jpbc

    h = triclinic_from_lengths_angles(2.0, 2.0, 2.0, 90.0, 109.47, 90.0)
    np.testing.assert_array_equal(
        h, jpbc.triclinic_from_lengths_angles(2.0, 2.0, 2.0, 90.0, 109.47,
                                              90.0))
    np.testing.assert_allclose(float(box_volume(_t(h))),
                               8.0 * np.sin(np.radians(109.47)), rtol=1e-6)
    assert 0.0 < max_cutoff(h) < 1.0
    assert max_cutoff(h) == pytest.approx(jpbc.max_cutoff(h), rel=1e-14)
    np.testing.assert_allclose(max_cutoff([2.0, 3.0, 4.0]), 1.0)
    hr = _reduced_cell()
    np.testing.assert_allclose(perp_widths(_t(hr)).numpy(),
                               np.asarray(jpbc.perp_widths(hr)), rtol=1e-14)


def test_cutoff_beyond_minimum_image_bound_rejected():
    """A Context refuses r_cut > max_cutoff(box): a sheared cell's
    perpendicular widths lie far below its edge lengths."""
    system, x, _ = argon_system(n=216, jitter=0.1, seed=0, r_cut=1.0,
                                r_switch=0.9, dtype=F64, device="cpu")
    h = triclinic_from_lengths_angles(2.2, 2.2, 2.2, 90.0, 120.0, 60.0)
    assert max_cutoff(h) < 1.0
    rs = np.random.RandomState(7)
    xs = _t(rs.uniform(0, 1, (216, 3)) @ h)
    with pytest.raises(InputError, match="minimum-image bound"):
        tamm.Context(system, tamm.VelocityVerletIntegrator(dt=0.002),
                     tamm.make_state(xs, box=_t(h)))
    tamm.Context(system, tamm.VelocityVerletIntegrator(dt=0.002),
                 tamm.make_state(x, box=_t([4.0, 4.0, 4.0])))


def _supercell_argon(system, x, h, reps=2):
    """Tile an argon System into a reps^3 supercell of the (3, 3) cell h."""
    n = x.shape[0]
    shifts = _t([(i, j, k) for i in range(reps) for j in range(reps)
                 for k in range(reps)]) @ h
    xs = (x[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    m = reps ** 3
    nb = system.forces[0]
    nb_s = replace(nb, charge=nb.charge.repeat(m), sigma=nb.sigma.repeat(m),
                   epsilon=nb.epsilon.repeat(m),
                   exclusions=nb.exclusions.repeat(m, 1))
    sys_s = replace(system, masses=system.masses.repeat(m),
                    molecule=torch.arange(n * m, dtype=torch.int32),
                    num_molecules=n * m, forces=(nb_s,))
    return sys_s, xs


def test_supercell_identity_on_sheared_cell():
    """E(2x2x2 supercell) == 8 E(cell) for LJ argon in a sheared reduced
    cell, the forces on the first copy equal the cell's, and both agree
    with the JAX package's dense path."""
    from atomsmm_tpu.models import argon_system as jargon
    from atomsmm_tpu.potential import potential_energy as jpe

    system, _, _ = argon_system(n=48, jitter=0.12, seed=2, r_cut=0.5,
                                r_switch=0.4, dtype=F64, device="cpu")
    h = _t(_reduced_cell() * 0.9)
    rs = np.random.RandomState(4)
    x = _t(rs.uniform(0, 1, (48, 3))) @ h
    e1 = potential_energy(system, x, h)
    sys_s, xs = _supercell_argon(system, x, h)
    e8 = potential_energy(sys_s, xs, 2.0 * h)
    np.testing.assert_allclose(float(e8), 8.0 * float(e1), rtol=1e-10)
    _, f1 = force_fn(system)(x, h)
    _, f8 = force_fn(sys_s)(xs, 2.0 * h)
    np.testing.assert_allclose(f8[:48].numpy(), f1.numpy(), atol=1e-9)
    jsys, _, _ = jargon(n=48, jitter=0.12, seed=2, r_cut=0.5, r_switch=0.4)
    np.testing.assert_allclose(float(e1),
                               float(jpe(jsys, x.numpy(), h.numpy())),
                               rtol=1e-10)


def test_pme_reciprocal_matches_ewald_on_sheared_cell():
    """Mesh PME against the plane-wave Ewald sum on a sheared cell (the
    fractional spreading and the metric G = inv(H)^T inv(H)), both against
    the JAX package, and the explicit reciprocal forces against autograd
    of the energy and against jax.grad."""
    import jax

    from atomsmm_tpu.ops import pme as jpme
    from atomsmm_tpu_torch.ops.pme import (
        ewald_reference_energy,
        pme_reciprocal_energy,
        pme_reciprocal_energy_forces,
    )

    h = _reduced_cell()
    rs = np.random.RandomState(3)
    n = 24
    x = rs.uniform(0, 1, (n, 3)) @ h
    q = rs.uniform(-1, 1, (n,))
    q = q - q.mean()
    alpha, grid = 3.0, (32, 32, 32)
    e_pme = pme_reciprocal_energy(_t(x), _t(h), _t(q), alpha, grid, 6)
    e_ref = ewald_reference_energy(_t(x), _t(h), _t(q), alpha, kmax=14)
    np.testing.assert_allclose(float(e_pme), float(e_ref), rtol=2e-5)
    np.testing.assert_allclose(
        float(e_pme), float(jpme.pme_reciprocal_energy(x, h, q, alpha, grid,
                                                       6)), rtol=1e-10)
    np.testing.assert_allclose(
        float(e_ref), float(jpme.ewald_reference_energy(x, h, q, alpha,
                                                        kmax=14)),
        rtol=1e-10)
    e, f = pme_reciprocal_energy_forces(_t(x), _t(h), _t(q), alpha, grid, 6)
    assert float(e) == pytest.approx(float(e_pme), rel=1e-12)
    xx = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(
        pme_reciprocal_energy(xx, _t(h), _t(q), alpha, grid, 6), xx)
    scale = float(f.abs().max())
    np.testing.assert_allclose(f.numpy(), -g.numpy(), atol=1e-9 * scale)
    jg = jax.grad(lambda xj: jpme.pme_reciprocal_energy(xj, h, q, alpha,
                                                        grid, 6))(x)
    np.testing.assert_allclose(f.numpy(), -np.asarray(jg), atol=1e-9 * scale)


@pytest.mark.slow
def test_md_and_virial_on_triclinic_cell():
    """NVE dynamics after FIRE and the isotropic-scaling virial on a (3, 3)
    box, on the dense path."""
    from atomsmm_tpu_torch.computers import atomic_pressure, atomic_virial
    from atomsmm_tpu_torch.minimize import minimize_energy

    system, _, _ = argon_system(n=64, jitter=0.1, seed=2, r_cut=0.5,
                                r_switch=0.4, dtype=F64, device="cpu")
    h = _t(_reduced_cell())
    rs = np.random.RandomState(5)
    x = _t(rs.uniform(0, 1, (64, 3))) @ h
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(x, box=h))
    minimize_energy(ctx, steps=150)
    ctx.set_velocities_to_temperature(120.0, seed=1)
    e0 = float(ctx.conserved_energy())
    ctx.step(50)
    e1 = float(ctx.conserved_energy())
    assert abs(e1 - e0) / 64 < 1e-3
    xs, box = ctx.state.x, ctx.state.box
    w = float(atomic_virial(system, xs, box))
    eps = 1e-6
    up = float(potential_energy(system, (1 + eps) * xs, (1 + eps) * box))
    um = float(potential_energy(system, (1 - eps) * xs, (1 - eps) * box))
    np.testing.assert_allclose(w, -(up - um) / (2 * eps), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(float(atomic_pressure(system, ctx.state)))


def test_triclinic_cell_list_matches_dense():
    """Cell lists on a sheared (3, 3) cell: the grid and the stencil sized
    from perpendicular widths, fractional binning, the sweep's plain twin
    rounding each slot in fractional coordinates; held against the dense
    path and the JAX package's dense path (energy and forces)."""
    from atomsmm_tpu.models import argon_system as jargon
    from atomsmm_tpu.potential import force_fn as jforce

    h = 3.0 * _reduced_cell()
    system, x = _lattice_argon(h, 12, 0.015, 7, 0.7, 0.6)
    n = x.shape[0]
    spec = system.neighbors
    w_perp = perp_widths(_t(h)).numpy() / np.asarray(spec.grid)
    assert (w_perp * np.asarray(spec.reach) >= spec.r_build - 1e-12).all()
    assert min(spec.grid) >= 3
    extras = all_neighbor_extras(system, x, _t(h))
    assert_neighbor_health(extras)
    aux = make_aux(system, extras)
    e_cell, f_cell = force_fn(system)(x, _t(h), {}, aux)
    dense = replace(system, neighbors=None)
    e_dense, f_dense = force_fn(dense)(x, _t(h))
    np.testing.assert_allclose(float(e_cell), float(e_dense), rtol=1e-10)
    scale = float(f_dense.abs().max())
    np.testing.assert_allclose(f_cell.numpy(), f_dense.numpy(),
                               atol=1e-9 * scale)
    jsys, _, _ = jargon(n=n, jitter=0.0, seed=2, r_cut=0.7, r_switch=0.6)
    je, jf = jforce(jsys)(x.numpy(), h, {})
    np.testing.assert_allclose(float(e_cell), float(je), rtol=1e-10)
    np.testing.assert_allclose(f_cell.numpy(), np.asarray(jf),
                               atol=1e-9 * scale)


@pytest.mark.slow
def test_triclinic_cell_list_nve_runs():
    """Short NVE on the triclinic cell-list path through the Context
    (rebuilds, coverage guards on a matrix box) after FIRE on the cells."""
    from atomsmm_tpu_torch.minimize import minimize_energy

    h = 2.0 * _reduced_cell()
    system, x = _lattice_argon(h, 8, 0.01, 9, 0.6, 0.5)
    n = x.shape[0]
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(x, box=_t(h)))
    minimize_energy(ctx, steps=100)
    ctx.set_velocities_to_temperature(120.0, seed=1)
    e0 = float(ctx.conserved_energy())
    ctx.step(100)
    e1 = float(ctx.conserved_energy())
    assert torch.isfinite(ctx.state.x).all()
    assert abs(e1 - e0) / n < 1e-3
    dense = replace(ctx.system, neighbors=None)
    e_dense = float(potential_energy(dense, ctx.state.x, ctx.state.box))
    aux = make_aux(ctx.system, all_neighbor_extras(ctx.system, ctx.state.x,
                                                   ctx.state.box))
    e2 = float(potential_energy(ctx.system, ctx.state.x, ctx.state.box,
                                aux=aux))
    np.testing.assert_allclose(e2, e_dense, rtol=1e-10)


# -- beyond the JAX file: the Context on the cells, water, PME --------------


def _velocities(masses, temperature, seed):
    m = np.asarray(masses, np.float64)
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) * np.sqrt(
        tamm.units.BOLTZMANN * temperature / m)[:, None]
    return v - (m[:, None] * v).sum(0) / m.sum()


def test_triclinic_cell_list_trajectory_matches_jax():
    """20 velocity Verlet steps of argon in a sheared cell through the
    Context on the triclinic cell lists, against the JAX package's Context
    on its dense path from the same numpy velocities: positions to 1e-9."""
    from atomsmm_tpu import Context as JContext
    from atomsmm_tpu import VelocityVerletIntegrator as JVV
    from atomsmm_tpu import make_state as jmake_state
    from atomsmm_tpu.models import argon_system as jargon

    h = 2.0 * _reduced_cell()
    system, x = _lattice_argon(h, 7, 0.05, 3, 0.6, 0.5)
    n = x.shape[0]
    v = _velocities(system.masses, 120.0, 4)
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(x, v=_t(v), box=_t(h)))
    ctx.step(20)
    jsys, _, _ = jargon(n=n, jitter=0.0, seed=2, r_cut=0.6, r_switch=0.5)
    jctx = JContext(jsys, JVV(0.002), jmake_state(x.numpy(), v=v, box=h))
    jctx.step(20)
    np.testing.assert_allclose(ctx.state.x.numpy(), np.asarray(jctx.state.x),
                               atol=1e-9)
    np.testing.assert_allclose(ctx.state.v.numpy(), np.asarray(jctx.state.v),
                               atol=1e-9)


def _shear(n_molecules, method, device="cpu", shear=(0.2, 0.1, 0.15),
           r_cut=0.5, r_switch=0.4, dtype=F64):
    """Water on a cubic lattice with its molecules' centres mapped affinely
    into the sheared cell b = (sx L, L, 0), c = (cx L, cy L, L), geometry
    kept up to a 0.004 nm jitter (so that the bonded terms are not zero);
    the cell lists and the PME grid built for that cell. (system, x, H) in
    the port; the JAX system comes from the same model function."""
    from atomsmm_tpu_torch.ops.pme import choose_pme_parameters

    system, x, box = water_system(n_molecules=n_molecules, method=method,
                                  r_cut=r_cut, r_switch=r_switch, dtype=dtype,
                                  device=device)
    ll = float(box[0])
    sx, cx, cy = shear
    h = np.array([[ll, 0.0, 0.0], [sx * ll, ll, 0.0], [cx * ll, cy * ll, ll]])
    xn = x.detach().cpu().numpy().astype(np.float64)
    mol = np.repeat(np.arange(n_molecules), 3)
    com = np.stack([np.bincount(mol, xn[:, d]) for d in range(3)], 1) / 3.0
    xs = xn + (com @ (h / ll) - com)[mol]
    xs = xs + np.random.RandomState(5).normal(0.0, 0.004, xs.shape)
    nb = system.forces[0]
    if method == "pme":
        _, grid, _ = choose_pme_parameters(r_cut, h,
                                           alpha=float(nb.ewald_alpha),
                                           order=int(nb.spline_order))
        nb = replace(nb, grid_shape=grid)
    hb = torch.as_tensor(h, dtype=dtype, device=device)
    system = replace(system, default_box=hb,
                     forces=(nb,) + tuple(system.forces[1:]))
    system = system.with_neighbors(make_neighbor_spec(
        h, system.num_particles, r_cut, exclusions=nb.exclusions,
        occupancy_floor_from=xs, device=device))
    return system, torch.as_tensor(xs, dtype=dtype, device=device), hb


@pytest.mark.parametrize("method", ["cutoff", "pme"])
def test_sheared_water_forces_match_jax(method):
    """64 waters in a sheared cell, RESPA split, reaction field and PME:
    every group's energy and forces on the triclinic cell lists against the
    JAX package's dense path at the same cell and grid."""
    from atomsmm_tpu import RESPASystem as JRESPA
    from atomsmm_tpu.models import water_system as jwater
    from atomsmm_tpu.potential import force_fn as jforce
    from atomsmm_tpu.utils import replace as jreplace

    system, x, h = _shear(64, method)
    respa = tamm.RESPASystem(system, rcut_in=0.35, rswitch_in=0.3)
    aux = make_aux(respa, all_neighbor_extras(respa, x, h))
    jsys, _, _ = jwater(n_molecules=64, method=method, r_cut=0.5,
                        r_switch=0.4)
    jnb = jsys.forces[0]
    if method == "pme":
        jnb = jreplace(jnb, grid_shape=respa.forces[-1].full.grid_shape)
    jsys = jreplace(jsys, forces=(jnb,) + tuple(jsys.forces[1:]))
    jrespa = JRESPA(jsys, rcut_in=0.35, rswitch_in=0.3)
    for g in (0, 1, 2):
        e, f = force_fn(respa, {g})(x, h, {}, aux)
        je, jf = jforce(jrespa, {g})(x.numpy(), h.numpy(), {})
        np.testing.assert_allclose(float(e), float(je), rtol=1e-10)
        scale = np.abs(np.asarray(jf)).max()
        np.testing.assert_allclose(f.numpy(), np.asarray(jf),
                                   atol=1e-9 * scale)


def test_triclinic_refusals():
    """What takes (3,) boxes only says so: the tile list and K3. A Context
    on a (3, 3) cell takes a new cell, and the Monte Carlo barostat runs
    in one (tests/test_torch_refusals_lifted.py holds its moves against
    the JAX package's)."""
    from atomsmm_tpu_torch.ops.tilepair import make_tilepair_spec

    h = 2.0 * _reduced_cell()
    with pytest.raises(InputError, match=r"\(3,\) boxes"):
        make_tilepair_spec(h, 64, 0.5, device="cpu")
    system, x = _lattice_argon(h, 5, 0.01, 1, 0.6, 0.5)
    baro = system.add_force(tamm.MonteCarloBarostat(pressure=1.0,
                                                    temperature=120.0))
    tamm.Context(baro, tamm.VelocityVerletIntegrator(0.002),
                 tamm.make_state(x, box=_t(h)))
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(x, box=_t(h)))
    ctx.set_periodic_box(_t(h) * 1.001)


def test_interop_carries_a_triclinic_system():
    """A JAX-package system whose default box is a (3, 3) cell crosses with
    its cell lists; its energy on the cells equals the JAX package's dense
    energy."""
    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.ops.neighbors import make_neighbor_spec as jspec
    from atomsmm_tpu.potential import potential_energy as jpe
    from atomsmm_tpu.utils import replace as jreplace
    from atomsmm_tpu_torch.interop import describe_reference, \
        system_from_numpy

    h = 2.0 * _reduced_cell()
    _, x = _lattice_argon(h, 6, 0.03, 2, 0.6, 0.5)
    jsys, _, _ = jmodels.argon_system(n=216, jitter=0.0, seed=2, r_cut=0.6,
                                      r_switch=0.5)
    jsys = jreplace(jsys, default_box=h).with_neighbors(
        jspec(h, 216, 0.6, occupancy_floor_from=x.numpy()))
    system = system_from_numpy(describe_reference(jsys), dtype=F64,
                               device="cpu")
    assert system.default_box.shape == (3, 3)
    aux = make_aux(system, all_neighbor_extras(system, x, _t(h)))
    np.testing.assert_allclose(
        float(potential_energy(system, x, _t(h), aux=aux)),
        float(jpe(jsys, x.numpy(), h)), rtol=1e-10)


def test_pme_diagonal_cell_matrix_equals_edge_lengths():
    """diag(L) as a (3, 3) cell matrix gives the PME reciprocal energy of
    the (3,) box L (the fractional route through inv(H) and the metric)."""
    from atomsmm_tpu_torch.ops import pme as tpme

    _, x, _ = water_system(n_molecules=64, r_cut=0.45, r_switch=0.35,
                           dtype=F64, device="cpu")
    q = torch.ones(192, dtype=F64)
    e_matrix = tpme.pme_reciprocal_energy(x, torch.eye(3, dtype=F64) * 2.0,
                                          q, 3.0, (8, 8, 8), 4)
    e_vector = tpme.pme_reciprocal_energy(x, torch.full((3,), 2.0,
                                                        dtype=F64),
                                          q, 3.0, (8, 8, 8), 4)
    assert float(e_matrix) == pytest.approx(float(e_vector), rel=1e-12)


def _card_sweep(cuda, dtype, half):
    """Argon in 3 x the reduced cell on the card: (system, x, H, spec,
    bucket, per-particle columns, form) for K1 (half) or K2."""
    from atomsmm_tpu_torch.ops.neighbors import build_cell_buckets

    h = 3.0 * _reduced_cell()
    system, x = _lattice_argon(h, 12, 0.015, 7, 0.7, 0.6, device=cuda)
    spec = system.neighbors
    assert spec.half_stencil
    if not half:
        spec = replace(spec, half_stencil=False)
    hb = _t(h).to(cuda, dtype)
    x = x.to(dtype)
    bucket, overflow = build_cell_buckets(spec, x, hb)
    assert not bool(overflow)
    nb = system.forces[0]
    pp = {"charge": nb.charge.to(dtype), "sigma": nb.sigma.to(dtype),
          "epsilon": nb.epsilon.to(dtype)}
    return x, hb, spec, bucket, pp, nb._pair_form()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("half", [True, False])
def test_kernels_take_a_triclinic_box(cuda, half, dtype):
    """K1 and K2 on a sheared (3, 3) cell, rounding each slot in fractional
    coordinates, against their float64 plain twins on the card: energy
    1e-10 relative and forces 1e-9 max|F| in float64, 1e-4 in float32;
    one launch of the kernel per sweep."""
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    x, hb, spec, bucket, pp, form = _card_sweep(cuda, dtype, half)
    launch, plain, kernel = ((pk.half_pair_cuda, pk.half_pair_plain,
                              "half_pair") if half else
                             (pk.full_pair_cuda, pk.full_pair_plain,
                              "cell_pair"))
    pk.reset_launches()
    out = launch(x, pp, bucket, spec, hb, form, 0.7)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == {"half_pair": int(half), "cell_pair": int(not half),
                           "tile_pair": 0}
    ref = plain(x.double(), {k: v.double() for k, v in pp.items()}, bucket,
                spec, hb.double(), form, 0.7)
    tol_e, tol_f = (1e-10, 1e-9) if dtype == torch.float64 else (1e-4, 1e-4)
    e, e_ref = float(out[:, 3].sum()), float(ref[:, 3].sum())
    assert abs(e - e_ref) <= tol_e * abs(e_ref)
    scale = float(ref[:-1, :3].abs().max())
    assert float((out[:-1, :3].double() - ref[:-1, :3]).abs().max()) \
        <= tol_f * scale


@pytest.mark.cuda
@pytest.mark.parametrize("half", [True, False])
def test_kernels_diagonal_cell_matrix_equals_edge_lengths(cuda, half):
    """K1 and K2 on diag(L) as a (3, 3) matrix against the same kernel on
    the (3,) box L, float64: the fractional route gives the same sums."""
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import build_cell_buckets

    box = torch.full((3,), 3.6, dtype=F64, device=cuda)
    system, x = _lattice_argon(np.eye(3) * 3.6, 10, 0.02, 5, 0.7, 0.6,
                               device=cuda)
    spec = system.neighbors
    if not half:
        spec = replace(spec, half_stencil=False)
    bucket, _ = build_cell_buckets(spec, x, box)
    nb = system.forces[0]
    pp = {"charge": nb.charge, "sigma": nb.sigma, "epsilon": nb.epsilon}
    launch = pk.half_pair_cuda if half else pk.full_pair_cuda
    out_v = launch(x, pp, bucket, spec, box, nb._pair_form(), 0.7)
    out_m = launch(x, pp, bucket, spec, torch.diag(box), nb._pair_form(),
                   0.7)
    e_v, e_m = float(out_v[:, 3].sum()), float(out_m[:, 3].sum())
    assert abs(e_m - e_v) <= 1e-10 * abs(e_v)
    scale = float(out_v[:-1, :3].abs().max())
    assert float((out_m - out_v)[:-1, :3].abs().max()) <= 1e-9 * scale


@pytest.mark.cuda
def test_triclinic_sweep_on_the_card_matches_the_cpu(cuda):
    """The triclinic cell lists' force on the card (K1, one launch) against
    the CPU's (the plain twin) in float64."""
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    h = 3.0 * _reduced_cell()
    out = []
    for dev in ("cpu", cuda):
        system, x = _lattice_argon(h, 12, 0.015, 7, 0.7, 0.6, device=dev)
        hb = _t(h).to(dev)
        aux = make_aux(system, all_neighbor_extras(system, x, hb))
        pk.reset_launches()
        out.append(force_fn(system)(x, hb, {}, aux))
    assert system.neighbors.half_stencil
    assert pk.LAUNCHES == {"half_pair": 1, "cell_pair": 0, "tile_pair": 0}
    (e, f), (eg, fg) = out
    assert float(eg) == pytest.approx(float(e), rel=1e-10)
    np.testing.assert_allclose(fg.cpu().numpy(), f.numpy(),
                               atol=1e-9 * float(f.abs().max()))
