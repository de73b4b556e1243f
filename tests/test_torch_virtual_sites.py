"""Virtual sites and TIP4P/Ew in the port: the twins of
tests/test_virtual_sites.py, float64 on the CPU against the JAX package,
and the card cases (marker ``cuda``).

The port evaluates the forces at the placed coordinates and pulls them
back onto the parents with torch.autograd.grad of the placement
(ops/virtual_sites.py, potential.force_fn); the JAX package takes jax.vjp.
Oracles: the JAX package's forces (1e-10 relative to max|F|), autograd
straight through the placement, central differences on the parents, and
exactly zero rows for the virtual sites. The 10-step TIP4P/Ew trajectory
agrees with the JAX package's dense path to 1e-9.

The JAX package is imported inside the tests that compare with it, so that
the ``cuda`` cases run on a machine that has PyTorch alone:
    pytest tests/test_torch_virtual_sites.py -m cuda -q --noconftest
They hold SETTLE, the placement and the pull-back on the card against the
CPU in float64 (1e-12), and a few float32 TIP4P/Ew steps on the card for
geometry and finiteness.
"""
import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch.models import rigid_water_system, tip4p_water_system
from atomsmm_tpu_torch.models.water import TIP4P_EW_D_OM
from atomsmm_tpu_torch.ops.settle import (
    SettleSet,
    settle_positions,
    settle_residual,
    settle_velocities,
)
from atomsmm_tpu_torch.ops.virtual_sites import (
    VirtualSiteSet,
    place_virtual_sites,
    pull_back_forces,
    validate_virtual_sites,
)
from atomsmm_tpu_torch.potential import force_fn, potential_energy
from atomsmm_tpu_torch.utils import InputError

F64 = torch.float64
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


def _tip4p(neighbors=False, device="cpu", **kw):
    return tip4p_water_system(dtype=F64, device=device, neighbors=neighbors,
                              **{**KW, **kw})


def _jitter(x, scale=0.004, seed=0):
    """x moved off the lattice, the M rows off their placement too."""
    return x + torch.as_tensor(np.random.RandomState(seed).normal(
        0.0, scale, tuple(x.shape)))


def test_m_site_placement():
    system, x, _ = _tip4p()
    xm = x.reshape(-1, 4, 3)
    d_om = torch.linalg.norm(xm[:, 3] - xm[:, 0], dim=1)
    np.testing.assert_allclose(d_om.numpy(), TIP4P_EW_D_OM, atol=1e-12)
    d1 = torch.linalg.norm(xm[:, 3] - xm[:, 1], dim=1)
    d2 = torch.linalg.norm(xm[:, 3] - xm[:, 2], dim=1)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=1e-12)
    # the placement against the JAX package's at a moved configuration
    import jax.numpy as jnp

    from atomsmm_tpu.models import tip4p_water_system as jax_tip4p
    from atomsmm_tpu.ops.virtual_sites import place_virtual_sites as jplace

    js, _, _ = jax_tip4p(**KW)
    xj = _jitter(x, 0.01)
    np.testing.assert_array_equal(
        place_virtual_sites(system.virtual_sites, xj).numpy(),
        np.asarray(jplace(js.virtual_sites, jnp.asarray(xj.numpy()))))


@pytest.mark.parametrize("neighbors", [False, True], ids=["dense", "cells"])
def test_force_pullback_matches_jax_vjp_and_fd(neighbors):
    """force_fn (forces at the placed coordinates, pulled back) against the
    JAX package's vjp, against autograd straight through the placement and
    against central differences on a hydrogen; the M rows exactly zero."""
    import jax.numpy as jnp

    from atomsmm_tpu.models import tip4p_water_system as jax_tip4p
    from atomsmm_tpu.potential import force_fn as jforce_fn

    system, x, box = _tip4p(neighbors=neighbors)
    js, _, jb = jax_tip4p(**KW)
    x = _jitter(x)  # stored M rows off their placement: force_fn re-places
    aux = None
    if neighbors:
        from atomsmm_tpu_torch.ops.neighbors import (
            all_neighbor_extras,
            make_aux,
        )

        aux = make_aux(system, all_neighbor_extras(system, x, box))
    e, f = force_fn(system)(x, box, {}, aux)
    ej, fj = jforce_fn(js)(jnp.asarray(x.numpy()), jb, {}, None)
    fmax = float(np.abs(np.asarray(fj)).max())
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-10,
                               atol=1e-10 * fmax)
    assert float(e) == pytest.approx(float(ej), rel=1e-10)
    sites = system.virtual_sites.sites
    assert bool((f[sites] == 0).all())
    xx = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(potential_energy(system, xx, box), xx)
    np.testing.assert_allclose(f.numpy(), -g.numpy(), atol=1e-9)
    h = 1e-6
    for dim in range(3):
        xp, xm = x.clone(), x.clone()
        xp[1, dim] += h
        xm[1, dim] -= h
        fd = -(potential_energy(system, xp, box)
               - potential_energy(system, xm, box)) / (2 * h)
        assert float(f[1, dim]) == pytest.approx(float(fd), rel=5e-5,
                                                 abs=5e-5)


def _oop_site():
    x = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0],
                      [9.0, 9.0, 9.0]], dtype=F64)
    vs = VirtualSiteSet(sites=torch.tensor([3]),
                        parents=torch.tensor([[0, 1, 2]]),
                        weights=torch.tensor([[0.4, 0.3, 0.3]], dtype=F64),
                        oop=torch.tensor([5.0], dtype=F64))
    return x, vs


def test_out_of_plane_site_pullback_matches_jax_and_fd():
    """A TIP5P-style out-of-plane site: the pull-back equals the JAX vjp
    (1e-10) and central differences of a spring on the site."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.ops import virtual_sites as jvs

    x, vs = _oop_site()
    assert abs(float(place_virtual_sites(vs, x)[3, 2])) > 1e-3
    target = torch.tensor([0.05, 0.02, 0.08], dtype=F64)
    # force of the spring E = |x_v - target|^2 on the placed site
    f_placed = torch.zeros_like(x)
    f_placed[3] = -2.0 * (place_virtual_sites(vs, x)[3] - target)
    got = pull_back_forces(vs, x, f_placed)
    jset = jvs.VirtualSiteSet(sites=jnp.asarray([3]),
                              parents=jnp.asarray([[0, 1, 2]]),
                              weights=jnp.asarray([[0.4, 0.3, 0.3]]),
                              oop=jnp.asarray([5.0]))
    _, vjp = jax.vjp(lambda xx: jvs.place_virtual_sites(jset, xx),
                     jnp.asarray(x.numpy()))
    (want,) = vjp(jnp.asarray(f_placed.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)
    assert bool((got[3] == 0).all())

    def energy(xx):
        return float(((place_virtual_sites(vs, xx)[3] - target) ** 2).sum())

    h = 1e-6
    for atom in range(3):
        for dim in range(3):
            xp, xm = x.clone(), x.clone()
            xp[atom, dim] += h
            xm[atom, dim] -= h
            fd = -(energy(xp) - energy(xm)) / (2 * h)
            assert float(got[atom, dim]) == pytest.approx(fd, rel=1e-6,
                                                          abs=1e-10)


def test_dof_excludes_virtual_sites():
    from atomsmm_tpu.models import tip4p_water_system as jax_tip4p
    from atomsmm_tpu.utils import count_degrees_of_freedom as jdof

    system, _, _ = _tip4p()
    m = KW["n_molecules"]
    # 12m coordinates - 3m SETTLE constraints - 3m virtual rows - 3 (COM)
    assert tamm.count_degrees_of_freedom(system) == 6 * m - 3
    assert tamm.count_degrees_of_freedom(system) == jdof(jax_tip4p(**KW)[0])


def test_chained_virtual_sites_rejected():
    ok = VirtualSiteSet(sites=torch.tensor([3]),
                        parents=torch.tensor([[0, 1, 2]]),
                        weights=torch.tensor([[0.8, 0.1, 0.1]]),
                        oop=torch.zeros(1))
    assert validate_virtual_sites(ok) is ok
    assert validate_virtual_sites(None) is None
    chained = VirtualSiteSet(
        sites=torch.tensor([3, 4]), parents=torch.tensor([[0, 1, 2],
                                                          [3, 1, 2]]),
        weights=torch.tensor([[0.8, 0.1, 0.1], [0.5, 0.25, 0.25]]),
        oop=torch.zeros(2))
    with pytest.raises(InputError, match="chained"):
        validate_virtual_sites(chained)
    dup = VirtualSiteSet(
        sites=torch.tensor([3, 3]), parents=torch.tensor([[0, 1, 2],
                                                          [0, 1, 2]]),
        weights=torch.tensor([[0.8, 0.1, 0.1], [0.5, 0.25, 0.25]]),
        oop=torch.zeros(2))
    with pytest.raises(InputError, match="duplicate"):
        validate_virtual_sites(dup)


def test_cold_start_capacity_covers_lattice_aliasing():
    """750 TIP4P/Ew molecules at the default cutoff: a 3^3 grid whose cells
    alias whole lattice planes. The builder floors the capacity at the
    measured occupancy, so the buckets of a jittered lattice hold every
    atom and the cell energy equals the dense one."""
    from atomsmm_tpu_torch.ops.neighbors import (
        _max_cell_occupancy,
        all_neighbor_extras,
        make_aux,
        overflow_flags,
    )
    from atomsmm_tpu_torch.potential import group_energies

    system, x, box = tip4p_water_system(n_molecules=750, neighbors=True,
                                        dtype=F64, device="cpu")
    spec = system.neighbors
    occ = _max_cell_occupancy(x, box, spec.grid)
    assert spec.cell_capacity >= occ, (spec.cell_capacity, occ)
    xj = _jitter(x)
    extras = all_neighbor_extras(system, xj, box)
    assert not any(bool(v) for v in overflow_flags(extras).values())
    e_cell = float(group_energies(system, xj, box, {},
                                  make_aux(system, extras))[0])
    dense = system.with_neighbors(None)
    e_dense = float(group_energies(dense, xj, box, {}, None)[0])
    assert abs(e_cell - e_dense) < 1e-9 * max(abs(e_dense), 1.0)


def test_tip4p_trajectory_matches_jax():
    """10 steps of VV + NHC at 2 fs on 27 TIP4P/Ew waters (the port on its
    cell lists, the JAX package on its dense path): x and v to 1e-9, the M
    rows placed and at rest, the geometry exact."""
    import atomsmm_tpu as jamm
    from atomsmm_tpu.integrate.propagators import (
        NoseHooverChainPropagator as JaxNHC,
    )
    from atomsmm_tpu.models import tip4p_water_system as jax_tip4p
    from atomsmm_tpu_torch.integrate.propagators import (
        NoseHooverChainPropagator,
    )

    system, _, box = _tip4p(neighbors=True)
    js, jx, jb = jax_tip4p(**KW)
    m = system.masses.numpy()
    v = np.random.RandomState(9).normal(size=(m.size, 3)) * np.sqrt(
        tamm.units.BOLTZMANN * 300.0 / np.where(m > 0, m, 1.0))[:, None]
    v[m == 0] = 0.0
    dof = tamm.count_degrees_of_freedom(system)
    jctx = jamm.Context(js, jamm.GlobalThermostatIntegrator(
        0.002, JaxNHC(300.0, dof, 0.1)), jamm.make_state(jx, v=v, box=jb))
    ctx = tamm.Context(system, tamm.GlobalThermostatIntegrator(
        0.002, NoseHooverChainPropagator(300.0, dof, 0.1)), tamm.make_state(
            torch.as_tensor(np.array(jx)), v=torch.as_tensor(v), box=box))
    jctx.step(10)
    ctx.step(10)
    for got, want in ((ctx.state.x, jctx.state.x),
                      (ctx.state.v, jctx.state.v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())
    sites = system.virtual_sites.sites
    assert bool((ctx.state.v[sites] == 0).all())
    placed = place_virtual_sites(system.virtual_sites, ctx.state.x)
    np.testing.assert_allclose(ctx.state.x[sites].numpy(),
                               placed[sites].numpy(), atol=1e-12)
    assert float(settle_residual(system.settle, ctx.state.x)) < 1e-10


def test_velocities_to_temperature_leave_the_sites_at_rest():
    """The M site's mass is 0: its rows stay 0 through the draw and the
    removal of the centre-of-mass motion, which leaves no momentum."""
    system, x, box = _tip4p()
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.002),
                       tamm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=4)
    v = ctx.state.v
    assert bool(torch.isfinite(v).all())
    assert bool((v[system.virtual_sites.sites] == 0).all())
    p = (system.masses[:, None] * v).sum(0)
    assert float(p.abs().max()) < 1e-10
    # the draw is not projected onto the constraints: its kinetic energy
    # fills the 3 (N - V) - 3 unconstrained degrees of freedom
    n_real = system.num_particles - system.virtual_sites.size
    t_draw = 300.0 * (3 * n_real - 3) / ctx.degrees_of_freedom
    assert 0.7 * t_draw < float(ctx.temperature()) < 1.3 * t_draw


def test_hmr_leaves_virtual_sites_untouched():
    system, _, _ = _tip4p(n_molecules=64, r_cut=0.55, r_switch=0.5)
    hmr = tamm.HydrogenMassRepartitionedSystem(system, factor=3.0)
    sites = system.virtual_sites.sites
    assert hmr.virtual_sites is system.virtual_sites
    assert bool((hmr.masses[sites] == 0).all())
    assert abs(float(hmr.masses.sum() - system.masses.sum())) < 1e-9
    np.testing.assert_allclose(hmr.masses[1::4].numpy(),
                               3.0 * system.masses[1::4].numpy())


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_settle_on_the_card_matches_the_cpu(cuda):
    system, x, _ = rigid_water_system(n_molecules=216, r_cut=0.6,
                                      r_switch=0.5, dtype=F64, device="cpu")
    rs = np.random.RandomState(3)
    x1 = x + torch.as_tensor(rs.normal(0, 0.01, tuple(x.shape)))
    v = torch.as_tensor(rs.normal(0, 1.0, tuple(x.shape)))
    ss, m = system.settle, system.masses

    def on_card(dtype):
        return SettleSet(ss.triplets.to(cuda), *(
            getattr(ss, k).to(cuda, dtype) for k in ("ra", "rb", "rc")))

    ss_d = on_card(F64)
    want_x = settle_positions(ss, x1, x, m)
    got_x = settle_positions(ss_d, x1.to(cuda), x.to(cuda), m.to(cuda))
    want_v = settle_velocities(ss, x, v, m)
    got_v = settle_velocities(ss_d, x.to(cuda), v.to(cuda), m.to(cuda))
    for got, want in ((got_x, want_x), (got_v, want_v)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))
    f32 = torch.float32
    x32 = settle_positions(on_card(f32), x1.to(cuda, f32), x.to(cuda, f32),
                           m.to(cuda, f32))
    assert float(settle_residual(ss_d, x32.double())) < 1e-5


@pytest.mark.cuda
def test_placement_and_pullback_on_the_card_match_the_cpu(cuda):
    system, x, box = _tip4p(neighbors=True)
    gsys, _, gbox = _tip4p(neighbors=True, device=cuda)
    x = _jitter(x)
    from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux

    out = []
    for s, xx, b in ((system, x, box), (gsys, x.to(cuda), gbox)):
        aux = make_aux(s, all_neighbor_extras(s, xx, b))
        out.append(force_fn(s)(xx, b, {}, aux))
    (e, f), (eg, fg) = out
    assert float(eg) == pytest.approx(float(e), rel=1e-10)
    np.testing.assert_allclose(fg.cpu().numpy(), f.numpy(), rtol=1e-9,
                               atol=1e-9 * float(f.abs().max()))
    assert bool((fg[gsys.virtual_sites.sites] == 0).all())
    np.testing.assert_array_equal(
        place_virtual_sites(gsys.virtual_sites, x.to(cuda)).cpu().numpy(),
        place_virtual_sites(system.virtual_sites, x).numpy())


@pytest.mark.cuda
def test_tip4p_steps_on_the_card(cuda):
    """20 float32 VV steps of 216 TIP4P/Ew waters on the card: finite, the
    geometry held to float32 rounding, the M rows placed and at rest."""
    system, x, box = tip4p_water_system(n_molecules=216, neighbors=True,
                                        r_cut=0.6, r_switch=0.5,
                                        dtype=torch.float32, device=cuda)
    ctx = tamm.Context(system, tamm.VelocityVerletIntegrator(0.001),
                       tamm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(50.0, seed=1)
    ctx.step(20)
    xs, vs = ctx.state.x, ctx.state.v
    sites = system.virtual_sites.sites
    assert bool(torch.isfinite(xs).all() and torch.isfinite(vs).all())
    assert bool((vs[sites] == 0).all())
    assert float(settle_residual(system.settle, xs.double())) < 1e-4
    placed = place_virtual_sites(system.virtual_sites, xs)
    assert float((placed[sites] - xs[sites]).abs().max()) < 1e-6
