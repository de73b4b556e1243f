"""The full-stencil sweep (K2's plain twin) and the exclusion-column forms of
the port against the JAX package, float64 on the CPU.

Grids too small for half-stencil maps (a dimension below 2*reach + 1: small
boxes at a 0.9 nm cutoff) take the full-stencil sweep. The port runs K2's
plain twin, which takes K2's inputs and gives its per-atom (N + 1, 4)
output; the JAX package runs its XLA full sweep on an 'xla'-backend spec, which is how its tests hold
the Pallas kernel's math on the CPU (Mosaic's interpret mode cannot run
float64). Cases: water 216 (one cell, capacity 1,112), water 400 at 0.9 nm
(2^3 grid, the full cutoff-RF form and the fused far form of the RESPA
split), argon 256 (2.33 nm box at r_cut 0.851 nm: a 2^3 grid).

Water renumbered by a fixed permutation has excluded pairs far more than
+-14 indices apart, so the JAX spec has no exclusion bitmask (excbits is
None) and the port's takes the split form (the bitmask within the window,
the far ids as id columns); it runs through K1's split form (half stencil,
0.7 nm) and K2's (full stencil, 0.9 nm).

The twin's per-atom output is also held against the JAX sweep in every pair
form (reaction field, near, fused far and their damped PME forms), with the
bitmask and with the id columns, on the one-cell grid and on a 2^3 grid
(forces 1e-10 x max|F|, summed energy rtol 1e-10), with a bucket several
times wider than its cells' occupancy, and across a periodic face crossed
between rebuilds.

Tolerances: energy rtol 1e-12, forces atol 1e-9 x max|F| (the same
arithmetic summed in another order); the 5-step RESPA+NHC trajectory of
water 400 at its default cutoff at rtol 1e-9 with atol 1e-9 x max|value|
(rounding that grows mildly over the steps, as in test_torch_integrate).
"""
import dataclasses

import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu.ops import neighbors as jnb
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pair_kernel as tpk

F64 = torch.float64
E_RTOL, F_TOL, TRAJ_TOL = 1e-12, 1e-9, 1e-9


def _pair(name):
    """((JAX system, x, box), (port system, x, box)) from the same numpy
    configuration; water splits by RESPASystem(0.5, 0.4) for its far form."""
    if name == "argon256":
        return (jmodels.argon_system(n=256, jitter=0.1, seed=4,
                                     neighbors=True),
                tmodels.argon_system(n=256, jitter=0.1, seed=4,
                                     neighbors=True, dtype=F64, device="cpu"))
    m = int(name[5:])
    return (jmodels.water_system(n_molecules=m, seed=5, neighbors=True),
            tmodels.water_system(n_molecules=m, seed=5, neighbors=True,
                                 dtype=F64, device="cpu"))


CASES = {  # case -> (system, force: 'full' or 'far')
    "water216": ("water216", "full"),
    "water400_rf": ("water400", "full"),
    "water400_far": ("water400", "far"),
    "argon256": ("argon256", "full"),
}


def _force(system, kind, pkg):
    if kind == "far":
        return pkg.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4).forces[-1]
    return system.forces[0]


def _r_cut(force):
    return force.full.r_cut if hasattr(force, "full") else force.r_cut


def _assert_ef(want, got):
    e_w, f_w = float(want[0]), np.asarray(want[1])
    np.testing.assert_allclose(float(got[0]), e_w, rtol=E_RTOL)
    np.testing.assert_allclose(got[1].numpy(), f_w, rtol=0,
                               atol=F_TOL * np.abs(f_w).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_stencil_matches_jax(case):
    sys_name, kind = CASES[case]
    (js, jx, jb), (ts, tx, tb) = _pair(sys_name)
    jspec, tspec = js.neighbors, ts.neighbors
    assert jspec.backend == "xla"
    assert not jspec.half_stencil and not tspec.half_stencil
    if case == "water216":
        assert tspec.grid == (1, 1, 1) and tspec.cell_capacity == 1112
    if case == "argon256":
        assert tspec.grid == (2, 2, 2)
    jf, tf = _force(js, kind, jamm), _force(ts, kind, tamm)
    r_cut = _r_cut(tf)
    jbucket, _ = jnb.build_cell_buckets(jspec, jx, jb)
    tbucket, _ = tnb.build_cell_buckets(tspec, tx, tb)
    np.testing.assert_array_equal(np.asarray(jbucket), tbucket.numpy())
    want = jnb.cell_pair_energy_forces(jf._pair_fn({}), jx, jb,
                                       jf._per_particle({}), jspec, jbucket,
                                       r_cut)
    got = tnb.cell_pair_energy_forces(tf._pair_form(), tx, tb,
                                      tf._per_particle(), tspec, tbucket,
                                      r_cut)
    _assert_ef(want, got)
    e_only = tnb.cell_pair_energy(tf._pair_form(), tx, tb, tf._per_particle(),
                                  tspec, tbucket, r_cut)
    np.testing.assert_allclose(float(e_only), float(want[0]), rtol=E_RTOL)


def test_bitmask_and_columns_give_the_same_mask():
    """On the card K2 may test the exclusion bitmask instead of the id
    columns; over every slot of water 400's full stencil both forms exclude
    exactly the same slots (self pairs included)."""
    _, (ts, tx, tb) = _pair("water400")
    spec = ts.neighbors
    bucket, _ = tnb.build_cell_buckets(spec, tx, tb)
    hf, hm, cols = tpk.stage(spec, tx, ts.forces[0]._per_particle(), bucket)
    assert cols is None
    # the whole table staged as the id columns
    _, _, cols = tpk.stage(dataclasses.replace(
        spec, exclusions_far=spec.exclusions), tx,
        ts.forces[0]._per_particle(), bucket)
    ids = torch.cat([hm[..., 0], hm.new_full((1, hm.shape[1]), tx.shape[0])])
    nbr = torch.where(spec.nbr_cells >= 0, spec.nbr_cells,
                      spec.ncells).long()
    hid = hm[..., 0][:, :, None]
    cid = ids[nbr].reshape(spec.ncells, 1, -1)
    by_bits = tpk.excluded(hid, cid, hm[..., 1][:, :, None])
    by_cols = tpk.excluded(hid, cid, cols=cols[:, :, None, :])
    real = (hid < tx.shape[0]) & (cid < tx.shape[0])
    assert torch.equal(by_bits & real, by_cols & real)
    assert int((by_cols & real).sum()) == 3 * tx.shape[0]   # self + 2 partners


def _by_columns(spec):
    """The spec with every exclusion tested by id column: the whole table
    as the split form's far ids, the bitmask holding the self bit alone."""
    return dataclasses.replace(
        spec, excbits=torch.full_like(spec.excbits, 1 << tnb.EXC_OFF),
        exclusions_far=spec.exclusions)


def _permuted(pkg, force, x, box, r_cut, seed=3):
    """The nonbonded force and positions with atoms renumbered by a fixed
    permutation, and a fresh cell spec for them (no bitmask fits)."""
    n = x.shape[0]
    p = np.random.RandomState(seed).permutation(n)
    inv = np.argsort(p)
    exc = np.asarray(force.exclusions)[p]
    exc = np.where(exc >= 0, inv[np.maximum(exc, 0)], -1).astype(np.int32)
    xp = np.asarray(x)[p]
    pp = {k: np.asarray(v)[p] for k, v in force._per_particle({}).items()}
    spec_kw = dict(exclusions=exc, occupancy_floor_from=xp)
    if pkg is jamm:
        import jax.numpy as jnp

        f = dataclasses.replace(force, exclusions=jnp.asarray(exc),
                                **{k: jnp.asarray(v) for k, v in pp.items()})
        spec = jnb.make_neighbor_spec(np.asarray(box), n, r_cut, **spec_kw)
        return f, jnp.asarray(xp), spec
    f = dataclasses.replace(force, exclusions=torch.as_tensor(exc),
                            **{k: torch.as_tensor(v) for k, v in pp.items()})
    spec = tnb.make_neighbor_spec(box, n, r_cut, **spec_kw, device="cpu")
    return f, torch.as_tensor(xp), spec


@pytest.mark.parametrize("r_cut", [0.7, 0.9])
def test_permuted_water_column_form_matches_jax(r_cut):
    """0.7 nm: half maps, K1's column form; 0.9 nm: full stencil, K2's."""
    js, jx, jb = jmodels.water_system(n_molecules=400, r_cut=r_cut,
                                      r_switch=r_cut - 0.1, seed=5)
    ts, tx, tb = tmodels.water_system(n_molecules=400, r_cut=r_cut,
                                      r_switch=r_cut - 0.1, seed=5, dtype=F64,
                                          device="cpu")
    jf, jxp, jspec = _permuted(jamm, js.forces[0], jx, jb, r_cut)
    tf, txp, tspec = _permuted(tamm, ts.forces[0], tx, tb, r_cut)
    assert jspec.excbits is None and tspec.exclusion_form == "split"
    assert tspec.half_stencil == (r_cut == 0.7) == jspec.half_stencil
    jbucket, _ = jnb.build_cell_buckets(jspec, jxp, jb)
    tbucket, _ = tnb.build_cell_buckets(tspec, txp, tb)
    want = jnb.cell_pair_energy_forces(jf._pair_fn({}), jxp, jb,
                                       jf._per_particle({}), jspec, jbucket,
                                       r_cut)
    got = tnb.cell_pair_energy_forces(tf._pair_form(), txp, tb,
                                      tf._per_particle(), tspec, tbucket,
                                      r_cut)
    _assert_ef(want, got)
    # the unpermuted system (bitmask form) gives the same energy
    spec = tnb.make_neighbor_spec(tb, tx.shape[0], r_cut,
                                  exclusions=ts.forces[0].exclusions,
                                  occupancy_floor_from=tx, device="cpu")
    assert spec.excbits is not None
    bucket, _ = tnb.build_cell_buckets(spec, tx, tb)
    e_bits = tnb.cell_pair_energy(ts.forces[0]._pair_form(), tx, tb,
                                  ts.forces[0]._per_particle(), spec, bucket,
                                  r_cut)
    np.testing.assert_allclose(float(got[0]), float(e_bits), rtol=1e-11)


def _velocities(masses, temperature, seed):
    m = np.asarray(masses, np.float64)
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) \
        * np.sqrt(tamm.units.BOLTZMANN * temperature / m)[:, None]
    return v - (m[:, None] * v).sum(0) / m.sum()


def test_respa_small_box_default_cutoff_matches_jax():
    """Water 400 at its default 0.9 nm cutoff: the far force takes the full
    stencil on a 2^3 grid, the near force the half stencil on its own grid;
    5 outer RESPA [4, 2, 1] + NHC steps against the JAX package."""
    (js, jx, jb), (ts, tx, tb) = _pair("water400")
    js = jamm.RESPASystem(js, rcut_in=0.5, rswitch_in=0.4)
    ts = tamm.RESPASystem(ts, rcut_in=0.5, rswitch_in=0.4)
    assert not ts.neighbors.half_stencil
    assert ts.extra_neighbor_specs["near"].half_stencil
    v = _velocities(ts.masses, 300.0, seed=9)
    kw = dict(temperature=300.0, time_scale=0.1,
              degrees_of_freedom=3 * ts.num_particles - 3)
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


# K2's plain twin per atom: (pair form) x (grid) x (exclusion form)
PLAIN_RTOL = 1e-10
FORMS = {  # name -> (method, force: 'full', 'near' or 'far')
    "rf": ("cutoff", "full"), "near": ("cutoff", "near"),
    "far": ("cutoff", "far"), "ewald": ("pme", "full"),
    "near_damped": ("pme", "near"), "far_damped": ("pme", "far"),
}
GRIDS = {"one_cell": 216, "grid_2x2x2": 400}


def _plain_pair(grid, form):
    """((JAX force, x, box, spec), (port force, x, box, spec), r_cut): the
    force of one pair form on the full-stencil grid of a small water box."""
    method, kind = FORMS[form]
    out = []
    for models, pkg, kw in ((jmodels, jamm, {}),
                            (tmodels, tamm, {"dtype": F64, "device": "cpu"})):
        s, x, box = models.water_system(n_molecules=GRIDS[grid], seed=5,
                                        neighbors=True, method=method, **kw)
        force = s.forces[0]
        if kind != "full":
            r = pkg.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
            force = r.forces[1 if kind == "near" else 2]
        out.append((force, x, box, s.neighbors))
    tf = out[1][0]
    return out[0], out[1], (_r_cut(tf) if kind != "near" else tf.r_cut)


def _assert_rows(out, n, e_want, f_want):
    assert out.shape == (n + 1, 4) and float(out[n].abs().max()) == 0.0
    f_want = np.asarray(f_want)
    np.testing.assert_allclose(float(out[:, 3].sum()), float(e_want),
                               rtol=PLAIN_RTOL)
    np.testing.assert_allclose(out[:n, :3].numpy(), f_want, rtol=0,
                               atol=PLAIN_RTOL * np.abs(f_want).max())


@pytest.mark.parametrize("exc", ["bitmask", "columns"])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_full_pair_plain_matches_jax(grid, form, exc):
    """K2's plain twin, per atom, against the JAX package's full-stencil
    sweep: the energy column sums to its energy, the force columns equal
    its forces, the padding row stays zero; with_forces=False leaves the
    force columns zero and the energy as it was."""
    (jf, jx, jb, jspec), (tf, tx, tb, tspec), r_cut = _plain_pair(grid, form)
    assert not jspec.half_stencil and not tspec.half_stencil
    assert tspec.ncells == (1 if grid == "one_cell" else 8)
    jbucket, _ = jnb.build_cell_buckets(jspec, jx, jb)
    tbucket, tov = tnb.build_cell_buckets(tspec, tx, tb)
    assert not bool(tov)
    e_want, f_want = jnb.cell_pair_energy_forces(
        jf._pair_fn({}), jx, jb, jf._per_particle({}), jspec, jbucket, r_cut)
    if exc == "columns":
        tspec = _by_columns(tspec)
    args = (tx, tf._per_particle(), tbucket, tspec, tb, tf._pair_form(),
            r_cut)
    out = tpk.full_pair_plain(*args)
    n = tx.shape[0]
    _assert_rows(out, n, e_want, f_want)
    e_only = tpk.full_pair_plain(*args, with_forces=False)
    assert float(e_only[:, :3].abs().max()) == 0.0
    np.testing.assert_allclose(float(e_only[:, 3].sum()),
                               float(out[:, 3].sum()), rtol=1e-12)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_full_pair_plain_wide_bucket_gives_the_same_rows(grid):
    """A bucket whose capacity is three times what its cells hold gives
    the rows of the tight one: padding contributes nothing."""
    _, (tf, tx, tb, tspec), r_cut = _plain_pair(grid, "far")
    wide = dataclasses.replace(tspec, cell_capacity=3 * tspec.cell_capacity)
    rows = []
    for spec in (tspec, wide):
        bucket, overflow = tnb.build_cell_buckets(spec, tx, tb)
        assert not bool(overflow)
        assert bucket.shape == (spec.ncells, spec.cell_capacity)
        real = bucket < tx.shape[0]    # K2 relies on real ids coming first
        assert bool((real[:, 1:] <= real[:, :-1]).all())
        rows.append(tpk.full_pair_plain(tx, tf._per_particle(), bucket, spec,
                                        tb, tf._pair_form(), r_cut))
    np.testing.assert_allclose(rows[1].numpy(), rows[0].numpy(), rtol=0,
                               atol=1e-12 * float(rows[0].abs().max()))


def test_full_pair_plain_face_crossing_matches_jax():
    """An atom that crosses the periodic face between rebuilds keeps its
    pairs on the full stencil too: the minimum image is per slot."""
    (jf, jx, jb, jspec), (tf, tx, tb, tspec), r_cut = _plain_pair(
        "grid_2x2x2", "rf")
    jx = jx.at[0, 0].set(0.0009)
    tx = tx.clone()
    tx[0, 0] = 0.0009
    jbucket, _ = jnb.build_cell_buckets(jspec, jx, jb)
    tbucket, _ = tnb.build_cell_buckets(tspec, tx, tb)
    np.testing.assert_array_equal(np.asarray(jbucket), tbucket.numpy())
    jx = jx.at[0, 0].add(-0.011)
    tx[0, 0] -= 0.011
    e_want, f_want = jnb.cell_pair_energy_forces(
        jf._pair_fn({}), jx, jb, jf._per_particle({}), jspec, jbucket, r_cut)
    out = tpk.full_pair_plain(tx, tf._per_particle(), tbucket, tspec, tb,
                              tf._pair_form(), r_cut)
    _assert_rows(out, tx.shape[0], e_want, f_want)
