"""Cell lists of the port against the JAX package.

Systems: argon 864 (LJ) and water 400 (rc 0.7/0.6) split by RESPASystem
(0.45/0.35), so both of the water's grids are covered: the default grid of
the full and fused far forces and the finer 'near' grid.

  * spec fields and buckets equal exactly;
  * the port's half-stencil sweep (the kernel's plain twin with its staging
    and write-back) and full-stencil sweep match
    ``atomsmm_tpu.ops.neighbors.cell_pair_energy_forces`` — the XLA sweep,
    which is how the JAX tests run the Pallas kernel's math on the CPU —
    at rtol 1e-10 in float64 (energy), forces at atol 1e-10 x max|F|: the
    sums run in another order, nothing else differs;
  * an atom crossing the periodic face between rebuilds keeps its pairs.

The CUDA kernel itself is tested on the card by tests/test_torch_kernel.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from atomsmm_tpu import models as jmodels
from atomsmm_tpu import systems as jsystems
from atomsmm_tpu.ops import neighbors as jnb
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch import systems as tsystems
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pair_kernel as tpk

RTOL = 1e-10
F64 = torch.float64


def _build(pkg_models, pkg_systems, name, **kw):
    if name == "argon":
        return pkg_models.argon_system(n=864, jitter=0.1, seed=7,
                                       neighbors=True, **kw)
    s, x, box = pkg_models.water_system(n_molecules=400, r_cut=0.7,
                                        r_switch=0.6, seed=5, neighbors=True,
                                        **kw)
    return pkg_systems.RESPASystem(s, rcut_in=0.45, rswitch_in=0.35), x, box


@pytest.fixture(scope="module")
def systems():
    out = {}
    for name in ("argon", "water"):
        out[name] = (_build(jmodels, jsystems, name),
                     _build(tmodels, tsystems, name, dtype=F64, device="cpu"))
    # the full (unsplit) water force on the default grid
    ws, wx, wb = jmodels.water_system(n_molecules=400, r_cut=0.7,
                                      r_switch=0.6, seed=5, neighbors=True)
    ts, tx, tb = tmodels.water_system(n_molecules=400, r_cut=0.7,
                                      r_switch=0.6, seed=5, neighbors=True,
                                      dtype=F64, device="cpu")
    out["water_full"] = ((ws, wx, wb), (ts, tx, tb))
    return out


# (system, spec key, force picker)
SPECS = {"argon": ("argon", "default"), "water_default": ("water", "default"),
         "water_near": ("water", "near")}
FORCES = {
    "argon_lj": ("argon", "default", "NonbondedForce"),
    "water_rf": ("water_full", "default", "NonbondedForce"),
    "water_near": ("water", "near", "NearNonbondedForce"),
    "water_far": ("water", "default", "FarNonbondedForce"),
}


def _spec(system, key):
    return system.neighbors if key == "default" else \
        system.extra_neighbor_specs[key]


def _force(system, cls_name):
    return next(f for f in system.forces if type(f).__name__ == cls_name)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_spec_fields_equal(systems, case):
    sys_name, key = SPECS[case]
    (js, _, _), (ts, _, _) = systems[sys_name]
    a, b = _spec(js, key), _spec(ts, key)
    for field in ("grid", "reach", "cell_capacity", "cell_chunk",
                  "half_stencil"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("nbr_cells", "nbr_cells_half", "inv_cells_half", "excbits",
                  "exclusions"):
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      getattr(b, field).numpy(), field)
    assert float(a.r_build) == b.r_build and float(a.skin) == b.skin
    assert b.half_stencil and b.excbits is not None


@pytest.mark.parametrize("case", sorted(SPECS))
def test_buckets_equal(systems, case):
    sys_name, key = SPECS[case]
    (js, jx, jb), (ts, tx, tb) = systems[sys_name]
    jbucket, jov = jnb.build_cell_buckets(_spec(js, key), jx, jb)
    tbucket, tov = tnb.build_cell_buckets(_spec(ts, key), tx, tb)
    np.testing.assert_array_equal(np.asarray(jbucket), tbucket.numpy())
    assert bool(jov) == bool(tov) is False


def _sweep_pair(systems, case, half: bool):
    sys_name, key, cls_name = FORCES[case]
    (js, jx, jb), (ts, tx, tb) = systems[sys_name]
    jspec, tspec = _spec(js, key), _spec(ts, key)
    if not half:
        jspec = dataclasses.replace(jspec, half_stencil=False)
        tspec = dataclasses.replace(tspec, half_stencil=False)
    jf, tf = _force(js, cls_name), _force(ts, cls_name)
    jbucket, _ = jnb.build_cell_buckets(jspec, jx, jb)
    tbucket, _ = tnb.build_cell_buckets(tspec, tx, tb)
    r_cut = tf.full.r_cut if cls_name == "FarNonbondedForce" else tf.r_cut
    want = jnb.cell_pair_energy_forces(
        jf._pair_fn({}), jx, jb, jf._per_particle({}), jspec, jbucket, r_cut)
    got = tnb.cell_pair_energy_forces(
        tf._pair_form(), tx, tb, tf._per_particle(), tspec, tbucket, r_cut)
    e_only = tnb.cell_pair_energy(
        tf._pair_form(), tx, tb, tf._per_particle(), tspec, tbucket, r_cut)
    return want, got, e_only


def _assert_ef(want, got):
    e_w, f_w = float(want[0]), np.asarray(want[1])
    np.testing.assert_allclose(float(got[0]), e_w, rtol=RTOL)
    np.testing.assert_allclose(got[1].numpy(), f_w, rtol=RTOL,
                               atol=RTOL * np.abs(f_w).max())


@pytest.mark.parametrize("case", sorted(FORCES))
def test_half_sweep_matches_jax(systems, case):
    want, got, e_only = _sweep_pair(systems, case, half=True)
    _assert_ef(want, got)
    np.testing.assert_allclose(float(e_only), float(want[0]), rtol=RTOL)


@pytest.mark.parametrize("case", sorted(FORCES))
def test_full_sweep_matches_jax(systems, case):
    want, got, e_only = _sweep_pair(systems, case, half=False)
    _assert_ef(want, got)
    np.testing.assert_allclose(float(e_only), float(want[0]), rtol=RTOL)


def test_column_exclusions_match_bitmask(systems):
    """Without the bitmask (excluded pairs more than +-14 indices apart) the
    plain sweep masks exclusions by id columns: same result."""
    (js, jx, jb), (ts, tx, tb) = systems["water"]
    spec = _spec(ts, "near")
    f = _force(ts, "NearNonbondedForce")
    bucket, _ = tnb.build_cell_buckets(spec, tx, tb)
    args = (f._pair_form(), tx, tb, f._per_particle())
    e1, f1 = tnb.cell_pair_energy_forces(*args, spec, bucket, f.r_cut)
    cols = dataclasses.replace(spec, excbits=None)
    e2, f2 = tnb.cell_pair_energy_forces(*args, cols, bucket, f.r_cut)
    np.testing.assert_allclose(float(e2), float(e1), rtol=RTOL)
    np.testing.assert_allclose(f2.numpy(), f1.numpy(), rtol=RTOL,
                               atol=RTOL * float(f1.abs().max()))


def test_boundary_crossing_between_rebuilds():
    """An atom crossing the periodic face between rebuilds (well inside the
    skin) keeps its pair interactions: the sweep applies the minimum image
    per slot to current positions (cf. tests/test_pallas.py)."""
    js, jx, jb = jmodels.argon_system(n=1728, jitter=0.1, seed=3,
                                      neighbors=True)
    ts, tx, tb = tmodels.argon_system(n=1728, jitter=0.1, seed=3,
                                      neighbors=True, dtype=F64, device="cpu")
    assert ts.neighbors.half_stencil and ts.neighbors.excbits is not None
    jx = jx.at[7, 0].set(0.0009)
    tx = tx.clone()
    tx[7, 0] = 0.0009
    jbucket, jov = jnb.build_cell_buckets(js.neighbors, jx, jb)
    tbucket, tov = tnb.build_cell_buckets(ts.neighbors, tx, tb)
    np.testing.assert_array_equal(np.asarray(jbucket), tbucket.numpy())
    assert not bool(tov)
    jx1 = jx.at[7, 0].add(-0.011)   # crosses the face; |disp| << skin/2
    tx1 = tx.clone()
    tx1[7, 0] -= 0.011
    jf, tf = js.forces[0], ts.forces[0]
    want = jnb.cell_pair_energy_forces(jf._pair_fn({}), jx1, jb,
                                       jf._per_particle({}), js.neighbors,
                                       jbucket, jf.r_cut)
    got = tnb.cell_pair_energy_forces(tf._pair_form(), tx1, tb,
                                      tf._per_particle(), ts.neighbors,
                                      tbucket, tf.r_cut)
    _assert_ef(want, got)


def test_retune_matches_jax(systems):
    (js, jx, jb), (ts, tx, tb) = systems["water"]
    jr = jnb.retune_neighbor_specs(js, jx, jb, safety=1.03)
    tr = tnb.retune_neighbor_specs(ts, tx, tb, safety=1.03)
    for key in ("default", "near"):
        a, b = _spec(jr, key), _spec(tr, key)
        assert (a.cell_capacity, a.cell_chunk) == (b.cell_capacity,
                                                   b.cell_chunk)
    grown = tnb.retune_neighbor_specs(tr, tx, tb, safety=1.03, grow_only=True)
    assert grown.neighbors.cell_capacity >= tr.neighbors.cell_capacity + 4


def test_overflow_is_flagged_not_dropped(systems):
    (_, _, _), (ts, tx, tb) = systems["argon"]
    tiny = dataclasses.replace(ts.neighbors, cell_capacity=4)
    bucket, overflow = tnb.build_cell_buckets(tiny, tx, tb)
    assert bool(overflow) and bucket.shape == (tiny.ncells, 4)
    counts = torch.bincount(bucket.reshape(-1).long(), minlength=865)
    assert int(counts[:864].max()) == 1   # no atom twice


def test_writeback_routes_reactions(systems):
    """The half-stencil twin's per-atom output routes every reaction to its
    atom: its forces equal the full-stencil twin's (each atom's force as a
    home atom only, no reactions), the total force vanishes (Newton's third
    law), the padding row stays zero and the energy column sums to the
    energy-only sweep."""
    (_, _, _), (ts, tx, tb) = systems["water"]
    spec = _spec(ts, "default")
    f = _force(ts, "FarNonbondedForce")
    bucket, _ = tnb.build_cell_buckets(spec, tx, tb)
    args = (tx, f._per_particle(), bucket, spec, tb, f._pair_form(),
            f.full.r_cut)
    out = tpk.half_pair_plain(*args)
    n = tx.shape[0]
    assert out.shape == (n + 1, 4) and float(out[n].abs().max()) == 0.0
    full = dataclasses.replace(spec, half_stencil=False)
    e_full, f_full = tnb.cell_pair_energy_forces(
        f._pair_form(), tx, tb, f._per_particle(), full, bucket, f.full.r_cut)
    np.testing.assert_allclose(out[:n, :3].numpy(), f_full.numpy(), rtol=RTOL,
                               atol=RTOL * float(f_full.abs().max()))
    np.testing.assert_allclose(float(out[:, 3].sum()), float(e_full),
                               rtol=RTOL)
    np.testing.assert_allclose(out[:n, :3].sum(0).numpy(), 0.0,
                               atol=1e-9 * float(out[:n, :3].abs().max()))
    e_only = tpk.half_pair_plain(*args, with_forces=False)
    assert float(e_only[:, :3].abs().max()) == 0.0
    np.testing.assert_allclose(float(e_only[:, 3].sum()),
                               float(out[:, 3].sum()), rtol=RTOL)


def _renumbered(pkg_models, pkg_nb, **kw):
    """Water 400 at 0.7 nm with the atoms renumbered by a fixed
    permutation: no exclusion bitmask fits, so the sweep takes the
    exclusion id columns. (force, x, box, spec) of the full form."""
    s, x, box = pkg_models.water_system(n_molecules=400, r_cut=0.7,
                                        r_switch=0.6, seed=5, **kw)
    force = s.forces[0]
    n = x.shape[0]
    p = np.random.RandomState(3).permutation(n)
    inv = np.argsort(p)
    exc = np.asarray(force.exclusions)[p]
    exc = np.where(exc >= 0, inv[np.maximum(exc, 0)], -1).astype(np.int32)
    xp = np.asarray(x)[p]
    if pkg_models is jmodels:
        import jax.numpy as jnp

        conv, spec_kw = jnp.asarray, {}
        pp = {k: np.asarray(v)[p]
              for k, v in force._per_particle({}).items()}
    else:
        conv, spec_kw = torch.as_tensor, {"device": "cpu"}
        pp = {k: v.numpy()[p] for k, v in force._per_particle().items()}
    force = dataclasses.replace(force, exclusions=conv(exc),
                                **{k: conv(v) for k, v in pp.items()})
    spec = pkg_nb.make_neighbor_spec(np.asarray(box), n, 0.7, exclusions=exc,
                                     occupancy_floor_from=xp, **spec_kw)
    assert spec.excbits is None and spec.half_stencil
    return force, conv(xp), box, spec


def _face_crossing(pkg_models, **kw):
    """Argon 1728 bucketed with atom 7 just inside the x = 0 face, then
    moved across it (well inside the skin): (force, x, box, spec,
    x at the build)."""
    s, x, box = pkg_models.argon_system(n=1728, jitter=0.1, seed=3,
                                        neighbors=True, **kw)
    if pkg_models is jmodels:
        x0 = x.at[7, 0].set(0.0009)
        x1 = x0.at[7, 0].add(-0.011)
    else:
        x0 = x.clone()
        x0[7, 0] = 0.0009
        x1 = x0.clone()
        x1[7, 0] -= 0.011
    return s.forces[0], x1, box, s.neighbors, x0


def _pme_water(pkg_models, pkg_systems, **kw):
    s, x, box = pkg_models.water_system(n_molecules=400, r_cut=0.7,
                                        r_switch=0.6, seed=5, neighbors=True,
                                        method="pme", **kw)
    return pkg_systems.RESPASystem(s, rcut_in=0.45, rswitch_in=0.35), x, box


# half_pair_plain against the JAX sweep: (JAX case, port case) builders
PLAIN_CASES = {
    "argon_lj": "argon_lj", "water_rf": "water_rf",
    "water_near": "water_near", "water_far": "water_far",
    "pme_near_damped": ("pme", "near", "NearNonbondedForce"),
    "pme_far_fused_damped": ("pme", "default", "FarNonbondedForce"),
    "columns_renumbered": "columns", "face_crossing": "face",
}


def _plain_case(systems, case):
    """((JAX force, x, box, spec, x at the build), the same for the port)
    for one half-stencil case."""
    kind = PLAIN_CASES[case]
    if kind == "columns":
        return tuple(_renumbered(pm, pn, **kw) + (None,) for pm, pn, kw in (
            (jmodels, jnb, {}), (tmodels, tnb, {"dtype": F64,
                                                 "device": "cpu"})))
    if kind == "face":
        return (_face_crossing(jmodels),
                _face_crossing(tmodels, dtype=F64, device="cpu"))
    if isinstance(kind, tuple):
        _, key, cls_name = kind
        pair = (_pme_water(jmodels, jsystems),
                _pme_water(tmodels, tsystems, dtype=F64, device="cpu"))
    else:
        sys_name, key, cls_name = FORCES[kind]
        pair = systems[sys_name]
    return tuple((_force(s, cls_name), x, b, _spec(s, key), None)
                 for s, x, b in pair)


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_half_pair_plain_matches_jax(systems, case):
    """K1's plain twin, per atom, against the JAX package's
    cell_pair_energy_forces (the XLA half-stencil sweep): the energy column
    sums to its energy and the force columns equal its forces (rtol 1e-10),
    in every pair form and both exclusion forms, and across a periodic
    face crossed between rebuilds; the padding row stays zero."""
    (jf, jx, jb, jspec, jx0), (tf, tx, tb, tspec, tx0) = _plain_case(
        systems, case)
    assert tspec.half_stencil and jspec.half_stencil
    jbucket, _ = jnb.build_cell_buckets(jspec, jx if jx0 is None else jx0, jb)
    tbucket, tov = tnb.build_cell_buckets(tspec, tx if tx0 is None else tx0,
                                          tb)
    assert not bool(tov)
    far = type(tf).__name__ == "FarNonbondedForce"
    r_cut = tf.full.r_cut if far else tf.r_cut
    e_want, f_want = jnb.cell_pair_energy_forces(
        jf._pair_fn({}), jx, jb, jf._per_particle({}), jspec, jbucket, r_cut)
    out = tpk.half_pair_plain(tx, tf._per_particle(), tbucket, tspec, tb,
                              tf._pair_form(), r_cut)
    n = tx.shape[0]
    assert out.shape == (n + 1, 4) and float(out[n].abs().max()) == 0.0
    _assert_ef((e_want, f_want), (out[:, 3].sum(), out[:n, :3]))
