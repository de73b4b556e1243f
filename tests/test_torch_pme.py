"""PME in the port against the JAX package, float64 on the CPU.

  * B-spline weights (orders 4-8) and their analytic derivative, exact for
    an atom on a grid plane (rows sum to 0 at t == 0);
  * choose_pme_parameters on the 216-, 400-, 700- and 10,000-molecule
    boxes;
  * the reciprocal energy against JAX (rtol 1e-12) and the plane-wave
    Ewald oracle; the explicit reciprocal forces (spread, rfftn,
    convolution, irfftn, gather) against torch autograd of the energy and
    against jax.grad (1e-10 x max|F|); alpha independence of the total
    Ewald energy; the excluded-pair correction and its forces;
  * the water_216_pme golden (tests/test_goldens.py, dense path);
  * near + far == full and the triple split (reciprocal_level=True) on the
    cell path, at 0.7 nm (K1's half maps) and 0.9 nm (K2's full stencil);
    port cell path == JAX cell path for the near, far and reciprocal
    groups (energy rtol 1e-10, forces 1e-9 x max|F|);
  * a 5-step RESPA [4, 2, 1] + NHC trajectory of water 400 with PME
    (positions and velocities to 1e-9 relative);
  * interop of a JAX PME RESPASystem whose spreading layout was retuned;
  * NonbondedForce(method='nocutoff') on the dense path.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import forces as jforces
from atomsmm_tpu import models as jmodels
from atomsmm_tpu import potential as jpot
from atomsmm_tpu.ops import neighbors as jnb
from atomsmm_tpu.ops import pme as jpme
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch import potential as tpot
from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pme as tpme
from atomsmm_tpu_torch.ops.pairs import dense_pair_energy
from atomsmm_tpu_torch.ops.pairfuncs import damped_coulomb
from test_goldens import GOLDENS, RTOL as GOLDEN_RTOL

F64 = torch.float64
RTOL, FTOL, TRAJ_TOL = 1e-10, 1e-9, 1e-9


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _random_neutral(n=32, seed=0, box_l=2.0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, box_l, (n, 3))
    q = rs.uniform(-1, 1, n)
    return x, q - q.mean(), np.full(3, box_l)


def _forces_close(got, want, scale=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * np.abs(want).max())


# --- B-splines ---------------------------------------------------------------


@pytest.mark.parametrize("order", [4, 5, 6, 7, 8])
def test_bspline_weights_match_jax(order):
    t = np.linspace(0.0, 0.999, 37)
    t[5] = 0.0
    got = tpme.bspline_weights(_t(t), order)
    want = jpme.bspline_weights(jnp.asarray(t), order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-15)
    tt = _t(t).requires_grad_(True)
    (g,) = torch.autograd.grad(tpme.bspline_weights(tt, order).sum(), tt)
    np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-14)
    dw = tpme.bspline_derivative(_t(t), order)
    jac = jax.vmap(jax.jacfwd(lambda s: jpme.bspline_weights(s, order)))(
        jnp.asarray(t))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jac), atol=1e-14)


@pytest.mark.parametrize("order", [4, 5, 6, 8])
def test_bspline_derivative_exact_on_grid_plane(order):
    """At t == 0 exactly (an atom on a grid plane) the derivative rows sum
    to 0 (1e-14) and each weight's derivative matches central differences,
    through autograd of bspline_weights as through bspline_derivative."""
    for t0 in (0.0, 0.25, 0.5):
        t = _t([t0]).requires_grad_(True)
        (d,) = torch.autograd.grad(tpme.bspline_weights(t, order).sum(), t)
        assert abs(float(d)) < 1e-14
        rows = tpme.bspline_derivative(_t([t0]), order)
        assert abs(float(rows.sum())) < 1e-14
        h = 1e-6
        fd = (tpme.bspline_weights(_t([t0 + h]), order)
              - tpme.bspline_weights(_t([t0 - h]), order)) / (2 * h)
        np.testing.assert_allclose(rows.numpy(), fd.numpy(), atol=5e-6)


def test_low_spline_orders_rejected():
    t = _t(np.linspace(0.0, 0.999, 8))
    with pytest.raises(ValueError, match="order must be >= 2"):
        tpme.bspline_weights(t, 1)
    with pytest.raises(ValueError, match="requires order >= 3"):
        tpme.bspline_derivative(t, 2)
    with pytest.raises(ValueError, match="spline_order must be >= 3"):
        tpme.spread_charges(torch.zeros((4, 3), dtype=F64),
                            torch.ones(3, dtype=F64),
                            torch.ones(4, dtype=F64), (8, 8, 8), order=2)


@pytest.mark.parametrize("k,order", [(15, 6), (16, 5), (45, 6), (12, 4)])
def test_bspline_moduli_match_jax(k, order):
    got = tpme._bspline_moduli(k, order)
    want = np.asarray(jpme._bspline_moduli(k, order, jnp.float64))
    np.testing.assert_array_equal(got, want)
    if k % 2 == 0:
        assert float(got[k // 2]) == 0.0


def test_force_on_grid_node_matches_jax():
    """One charge at an exact multiple of the grid spacing (K = 15, x =
    0.8 L): the explicit force equals jax.grad and central differences."""
    x, q, box = _random_neutral(n=12, seed=3)
    x[0] = [0.8 * box[0], 0.5 * box[1], 0.0]
    args = (3.0, (15, 15, 15), 6)
    _, f = tpme.pme_reciprocal_energy_forces(_t(x), _t(box), _t(q), *args)
    g = jax.grad(lambda xx: jpme.pme_reciprocal_energy(
        xx, jnp.asarray(box), jnp.asarray(q), *args[:2], order=6))(
            jnp.asarray(x))
    _forces_close(f.numpy(), -np.asarray(g))
    h = 1e-5
    for d in range(3):
        xp, xm = x.copy(), x.copy()
        xp[0, d] += h
        xm[0, d] -= h
        fd = -(float(tpme.pme_reciprocal_energy(_t(xp), _t(box), _t(q),
                                                *args))
               - float(tpme.pme_reciprocal_energy(_t(xm), _t(box), _t(q),
                                                  *args))) / (2 * h)
        np.testing.assert_allclose(float(f[0, d]), fd, rtol=2e-4, atol=2e-4)


# --- parameters --------------------------------------------------------------


@pytest.mark.parametrize("order", [4, 6])
@pytest.mark.parametrize("molecules", [216, 400, 700, 10000])
def test_choose_pme_parameters_match_jax(molecules, order):
    box = np.full(3, (molecules / tmodels.water.WATER_NUMBER_DENSITY)
                  ** (1.0 / 3.0))
    got = tpme.choose_pme_parameters(0.9, box, order=order)
    assert got == jpme.choose_pme_parameters(0.9, box, order=order)
    assert tpme.pme_validity_lengths(*got[:1], got[1], got[2], 0.9) == \
        jpme.pme_validity_lengths(*got[:1], got[1], got[2], 0.9)
    if molecules == 10000 and order == 6:
        assert got[1] == (45, 45, 45) and abs(got[0] - 2.92029) < 1e-5


# --- reciprocal sum ----------------------------------------------------------


def _water_state(m, seed=5, noise=0.02):
    s, x, box = tmodels.water_system(n_molecules=m, method="pme", seed=seed,
                                     dtype=F64)
    xn = x.numpy() + np.random.RandomState(1).normal(scale=noise,
                                                    size=x.shape)
    return s.forces[0], xn, box.numpy()


@pytest.mark.parametrize("m", [216, 400])
def test_reciprocal_energy_and_forces_match_jax(m):
    nb, x, box = _water_state(m)
    args = (float(nb.ewald_alpha), nb.grid_shape)
    q = nb.charge.numpy()

    def jax_e(xx):
        return jpme.pme_reciprocal_energy(xx, jnp.asarray(box),
                                          jnp.asarray(q), *args,
                                          order=nb.spline_order)

    e_j = float(jax_e(jnp.asarray(x)))
    g_j = np.asarray(jax.grad(jax_e)(jnp.asarray(x)))
    e_t = tpme.pme_reciprocal_energy(_t(x), _t(box), nb.charge, *args,
                                     nb.spline_order)
    np.testing.assert_allclose(float(e_t), e_j, rtol=1e-12)
    e_f, f = tpme.pme_reciprocal_energy_forces(_t(x), _t(box), nb.charge,
                                               *args, nb.spline_order)
    np.testing.assert_allclose(float(e_f), e_j, rtol=1e-12)
    _forces_close(f.numpy(), -g_j)
    xx = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(
        tpme.pme_reciprocal_energy(xx, _t(box), nb.charge, *args,
                                   nb.spline_order), xx)
    _forces_close(f.numpy(), -g.numpy())


def test_reciprocal_matches_plane_wave_ewald():
    x, q, box = _random_neutral(n=32)
    e_pme = tpme.pme_reciprocal_energy(_t(x), _t(box), _t(q), 3.0,
                                       (48, 48, 48), 6)
    e_ref = tpme.ewald_reference_energy(_t(x), _t(box), _t(q), 3.0, kmax=14)
    np.testing.assert_allclose(float(e_pme), float(e_ref), rtol=2e-6)
    e_jref = jpme.ewald_reference_energy(jnp.asarray(x), jnp.asarray(box),
                                         jnp.asarray(q), 3.0, kmax=14)
    np.testing.assert_allclose(float(e_ref), float(e_jref), rtol=1e-12)


def test_total_ewald_energy_alpha_independent():
    """direct (erfc) + reciprocal + self does not depend on alpha."""
    x, q, box = _random_neutral(n=24, box_l=2.5)
    exclusions = torch.full((24, 1), -1, dtype=torch.int32)

    def total(alpha):
        def pair(r, pi, pj):
            return damped_coulomb(r, pi["q"] * pj["q"], alpha)

        e_dir = dense_pair_energy(pair, _t(x), _t(box), {"q": _t(q)},
                                  exclusions, 1.2, chunk=8)
        e_rec = tpme.pme_reciprocal_energy(_t(x), _t(box), _t(q), alpha,
                                           (64, 64, 64), 6)
        return float(e_dir + e_rec + tpme.pme_self_energy(_t(q), alpha))

    np.testing.assert_allclose(total(3.2), total(3.8), rtol=2e-5)


def test_exclusion_correction_matches_jax():
    """Energy of the excluded-pair correction against JAX (water 216's
    exclusions, and the two-charge case of tests/test_pme.py), and its
    explicit forces against autograd and jax.grad."""
    x = np.array([[0.5, 0.5, 0.5], [0.72, 0.5, 0.5]])
    exc = np.array([[1], [0]], np.int32)
    e = tpme.pme_exclusion_correction(_t(x), _t([2.0] * 3), _t([0.5, -0.5]),
                                      torch.as_tensor(exc), 4.0)
    np.testing.assert_allclose(
        float(e), 138.935456 * 0.25 * math.erf(4.0 * 0.22) / 0.22, rtol=1e-10)
    nb, xw, box = _water_state(216)
    q, ex = nb.charge.numpy(), nb.exclusions.numpy()
    alpha = float(nb.ewald_alpha)

    def jax_e(xx):
        return jpme.pme_corrections(xx, jnp.asarray(box), jnp.asarray(q),
                                    jnp.asarray(ex), alpha)

    e_t, f_t = tpme.pme_corrections_forces(_t(xw), _t(box), nb.charge,
                                           nb.exclusions, alpha)
    np.testing.assert_allclose(float(e_t), float(jax_e(jnp.asarray(xw))),
                               rtol=1e-12)
    _forces_close(f_t.numpy(), -np.asarray(jax.grad(jax_e)(jnp.asarray(xw))))
    xx = _t(xw).requires_grad_(True)
    (g,) = torch.autograd.grad(
        tpme.pme_corrections(xx, _t(box), nb.charge, nb.exclusions, alpha),
        xx)
    _forces_close(f_t.numpy(), -g.numpy())


def test_golden_water_216_pme():
    s, x, box = tmodels.water_system(n_molecules=216, method="pme", r_cut=0.8,
                                     r_switch=0.7, seed=3,
                                     dispersion_correction=True, dtype=F64)
    split = tpot.split_potential_energy(s, x, box, {})
    expected = GOLDENS["water_216_pme"]
    assert set(split) == set(expected)
    for term, ref in expected.items():
        got = float(split[term])
        if ref == 0.0:
            assert abs(got) < 1e-10, (term, got)
        else:
            assert got == pytest.approx(ref, rel=GOLDEN_RTOL), (term, got, ref)


# --- the split on the cell path ---------------------------------------------


def _pme_pair(r_cut, m=400):
    """((JAX RESPA system, x, box), (port RESPA system, x, box)), both with
    PME and the triple split, from the same numpy positions."""
    kw = dict(n_molecules=m, method="pme", r_cut=r_cut, r_switch=r_cut - 0.1,
              seed=5, neighbors=True)
    js, jx, jb = jmodels.water_system(**kw)
    ts, tx, tb = tmodels.water_system(dtype=F64, **kw)
    noise = np.random.RandomState(1).normal(scale=0.01, size=tx.shape)
    jx, tx = jx + noise, tx + torch.as_tensor(noise)
    split = (0.5, 0.4) if r_cut > 0.8 else (0.45, 0.35)
    jr = jamm.RESPASystem(js, *split, reciprocal_level=True)
    tr = tamm.RESPASystem(ts, *split, reciprocal_level=True)
    return (js, jr, jx, jb), (ts, tr, tx, tb)


@pytest.fixture(scope="module", params=[0.7, 0.9], ids=["K1", "K2"])
def water_pme(request):
    return _pme_pair(request.param)


def _aux(nb, system, x, box):
    return nb.make_aux(system, nb.all_neighbor_extras(system, x, box))


def test_triple_split_sums_to_full_on_cells(water_pme):
    """Groups 0-3 of the triple split and groups 0-2 of the double split
    each sum to the full PME system, on the cell path (1e-10)."""
    _, (ts, tr, tx, tb) = water_pme
    assert tr.neighbors.half_stencil == (tr.forces[2].full.r_cut < 0.8)
    assert sorted({f.group for f in tr.forces}) == [0, 1, 2, 3]
    e_full, f_full = tpot.force_fn(ts)(tx, tb, {}, _aux(tnb, ts, tx, tb))
    e_tri, f_tri = tpot.force_fn(tr)(tx, tb, {}, _aux(tnb, tr, tx, tb))
    td = tamm.RESPASystem(ts, *((0.5, 0.4) if tr.forces[2].full.r_cut > 0.8
                                else (0.45, 0.35)))
    assert sorted({f.group for f in td.forces}) == [0, 1, 2]
    e_dbl, f_dbl = tpot.force_fn(td)(tx, tb, {}, _aux(tnb, td, tx, tb))
    for e, f in ((e_tri, f_tri), (e_dbl, f_dbl)):
        np.testing.assert_allclose(float(e), float(e_full), rtol=RTOL)
        _forces_close(f.numpy(), f_full.numpy(), RTOL)


@pytest.mark.parametrize("group", [1, 2, 3])
def test_group_energy_forces_match_jax(water_pme, group):
    (_, jr, jx, jb), (_, tr, tx, tb) = water_pme
    e_j, f_j = jpot.force_fn(jr, groups={group})(jx, jb, {},
                                                 _aux(jnb, jr, jx, jb))
    e_t, f_t = tpot.force_fn(tr, groups={group})(tx, tb, {},
                                                 _aux(tnb, tr, tx, tb))
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)
    _forces_close(f_t.numpy(), f_j, FTOL)


# --- the slice ---------------------------------------------------------------


def test_respa_pme_trajectory_matches_jax():
    """Water 400 with PME at the default 0.9 nm cutoff (K2's far grid, K1's
    near grid, the reciprocal sum in the far group): 5 outer RESPA
    [4, 2, 1] + NHC steps against the JAX package."""
    kw = dict(n_molecules=400, method="pme", seed=5, neighbors=True)
    js, jx, jb = jmodels.water_system(**kw)
    ts, tx, tb = tmodels.water_system(dtype=F64, **kw)
    js = jamm.RESPASystem(js, rcut_in=0.5, rswitch_in=0.4)
    ts = tamm.RESPASystem(ts, rcut_in=0.5, rswitch_in=0.4)
    m = ts.masses.numpy()
    v = np.random.RandomState(9).normal(size=(m.size, 3)) \
        * np.sqrt(tamm.units.BOLTZMANN * 300.0 / m)[:, None]
    v -= (m[:, None] * v).sum(0) / m.sum()
    kw = dict(temperature=300.0, time_scale=0.1,
              degrees_of_freedom=3 * m.size - 3)
    jctx = jamm.Context(js, jamm.MultipleTimeScaleIntegrator(0.002, [4, 2, 1],
                                                             **kw),
                        jamm.make_state(jx, v=v, box=jb))
    tctx = tamm.Context(ts, tamm.MultipleTimeScaleIntegrator(0.002, [4, 2, 1],
                                                             **kw),
                        tamm.make_state(tx, v=torch.as_tensor(v), box=tb))
    jctx.step(5)
    tctx.step(5)
    for got, want in ((tctx.state.x, jctx.state.x),
                      (tctx.state.v, jctx.state.v),
                      (tctx.state.extra["nhc_v"], jctx.state.extra["nhc_v"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL * np.abs(want).max())


# --- interop and the other methods -------------------------------------------


def test_interop_carries_pme_respa_with_spread_layout():
    """A JAX PME RESPASystem whose spreading was switched to the TPU's
    block-binned layout crosses over: the layout fields are dropped (the
    port scatters at every evaluation) and the group energies agree."""
    js, jx, jb = jmodels.water_system(n_molecules=400, method="pme",
                                      seed=5, pme_grid=(96, 96, 96))
    jr = jamm.RESPASystem(js, 0.5, 0.4, reciprocal_level=True)
    jr = jforces.retune_pme_spread(jr, jx, jb)
    assert any(getattr(f, "spread_block", ()) for f in jr.forces)
    tr = system_from_numpy(describe_reference(jr), dtype=F64)
    assert [type(f).__name__ for f in tr.forces] == \
        [type(f).__name__ for f in jr.forces]
    tx, tb = _t(jx), _t(jb)
    e_j = jpot.group_energies(jr, jx, jb, {})
    e_t = tpot.group_energies(tr, tx, tb, {})
    assert sorted(e_t) == sorted(e_j) == [0, 1, 2, 3]
    scale = max(abs(float(e)) for e in e_j.values())
    for g in e_j:   # group 0: the bonded lattice, zero up to rounding
        np.testing.assert_allclose(float(e_t[g]), float(e_j[g]), rtol=RTOL,
                                   atol=RTOL * scale)


def test_nocutoff_matches_jax():
    """method='nocutoff': plain LJ + Coulomb over all pairs, dense path."""
    rs = np.random.RandomState(2)
    js, jx, jb = jmodels.water_system(n_molecules=27, method="nocutoff",
                                      r_cut=0.45, r_switch=0.35, seed=2)
    ts, tx, tb = tmodels.water_system(n_molecules=27, method="nocutoff",
                                      r_cut=0.45, r_switch=0.35, seed=2,
                                      dtype=F64)
    assert not ts.forces[0].uses_neighbors()
    noise = rs.normal(scale=0.01, size=tx.shape)
    jx, tx = jx + noise, tx + torch.as_tensor(noise)
    e_j, f_j = jpot.force_fn(js, groups={0})(jx, jb, {}, None)
    e_t, f_t = tpot.force_fn(ts, groups={0})(tx, tb, {}, None)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)
    _forces_close(f_t.numpy(), np.asarray(f_j), RTOL)


def test_pme_evaluations_counted():
    nb, x, box = _water_state(216)
    tpme.reset_evaluations()
    nb.energy_and_forces(_t(x), _t(box), {})
    nb.energy(_t(x), _t(box), {})
    assert tpme.EVALUATIONS["reciprocal"] == 2
    tpme.reset_evaluations()
