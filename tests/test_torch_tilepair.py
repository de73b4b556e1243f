"""The flat tile-pair entry point of the port (ops/tilepair.py, ops/blocks.py)
against the JAX package, float64 on the CPU.

  * make_tilepair_spec gives the same n_blocks, max_entries, sort_grid,
    multi_image and excbits;
  * build_tile_pairs gives the same order, hb, cb, wrap and overflow,
    element for element (the serpentine sort is stable in both), on argon
    216, water 64 at 0.55 nm (multi-image), water 216 with 32-atom blocks,
    and the 30k equilibrated water state (single-image);
  * tile_pair_energy_forces (K3's plain twin on the CPU) matches the JAX
    package's, whose CPU path runs the kernel's math as a lax.scan, at the
    tolerances of tests/test_tilepair.py: energy rtol 1e-12, forces rtol
    1e-9 with atol 1e-9 x max|F|;
  * an atom crossing the periodic face between rebuilds keeps its pairs
    when staged with xref; the overflow flag, the retune and the
    displacement-triggered update; a TilePairSpec attached to a System
    raises.

K3 itself is tested on the card by tests/test_torch_kernel.py.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu.ops import blocks as jblocks
from atomsmm_tpu.ops import tilepair as jtp
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.ops import blocks as tblocks
from atomsmm_tpu_torch.ops import tilepair as ttp

F64 = torch.float64
HERE = os.path.dirname(os.path.abspath(__file__))


def _systems(name):
    """((JAX system, x, box), (port system, x, box), spec kwargs)."""
    if name == "argon216":
        return (jmodels.argon_system(n=216, jitter=0.25, seed=1),
                tmodels.argon_system(n=216, jitter=0.25, seed=1, dtype=F64,
                                     device="cpu"),
                {})
    m = int(name.split("_")[0][5:])
    r = 0.55 if m == 64 else 0.8
    kw = {"block_size": 32} if name.endswith("b32") else {}
    return (jmodels.water_system(n_molecules=m, r_cut=r, r_switch=r - 0.1),
            tmodels.water_system(n_molecules=m, r_cut=r, r_switch=r - 0.1,
                                 dtype=F64, device="cpu"), kw)


CASES = ["argon216", "water64", "water216_b32"]


def _specs_and_lists(name):
    (js, jx, jb), (ts, tx, tb), kw = _systems(name)
    jf, tf = js.forces[0], ts.forces[0]
    jspec = jtp.make_tilepair_spec(
        np.asarray(jb), jx.shape[0], float(jf.r_cut),
        exclusions=np.asarray(jf.exclusions), occupancy_from=np.asarray(jx),
        **kw)
    tspec = ttp.make_tilepair_spec(tb, tx.shape[0], tf.r_cut,
                                   exclusions=tf.exclusions,
                                   occupancy_from=tx, **kw, device="cpu")
    jlist = jtp.build_tile_pairs(jspec, jx, jb)
    tlist = ttp.build_tile_pairs(tspec, tx, tb)
    return (jf, jspec, jx, jb, jlist), (tf, tspec, tx, tb, tlist)


@pytest.fixture(scope="module")
def built():
    return {name: _specs_and_lists(name) for name in CASES}


def _assert_specs_equal(jspec, tspec):
    for field in ("n_blocks", "max_entries", "sort_grid", "multi_image",
                  "block_size"):
        assert getattr(jspec, field) == getattr(tspec, field), field
    np.testing.assert_array_equal(np.asarray(jspec.excbits),
                                  tspec.excbits.numpy())
    assert float(jspec.r_build) == tspec.r_build


def _assert_lists_equal(jlist, tlist):
    for name, a, b in zip(("order", "hb", "cb", "wrap", "overflow"), jlist,
                          tlist):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)


@pytest.mark.parametrize("case", CASES)
def test_spec_and_tile_list_equal_jax(built, case):
    (_, jspec, _, _, jlist), (_, tspec, _, _, tlist) = built[case]
    _assert_specs_equal(jspec, tspec)
    _assert_lists_equal(jlist, tlist)
    assert not bool(tlist[4])
    if case == "water64":
        assert tspec.multi_image


def test_tile_list_equal_jax_single_image_30k():
    """The 30k equilibrated water state: single-image mode (per-pair
    nearest-image wraps), 469 blocks, the entry budget from the block
    volume estimate (the measured retune is tested on argon above)."""
    d = np.load(os.path.join(HERE, "..", "bench_data", "eq_water30k.npz"))
    x, box = d["x"], d["box"]
    n = x.shape[0]
    jspec = jtp.make_tilepair_spec(box, n, 0.5)
    tspec = ttp.make_tilepair_spec(box, n, 0.5, device="cpu")
    assert not tspec.multi_image and tspec.n_blocks == 469
    _assert_specs_equal(jspec, tspec)
    _assert_lists_equal(
        jtp.build_tile_pairs(jspec, jnp.asarray(x), jnp.asarray(box)),
        ttp.build_tile_pairs(tspec, torch.as_tensor(x), torch.as_tensor(box)))


def test_serpentine_blocks_equal_jax():
    (_, jx, jb), (_, tx, tb), _ = _systems("water216_b32")
    want = jblocks.sorted_block_aabbs(jx, jb, (5, 4, 3), 32, 21, 672)
    got = tblocks.sorted_block_aabbs(tx, tb, (5, 4, 3), 32, 21, 672)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _assert_ef(want, got):
    e_w, f_w = float(want[0]), np.asarray(want[1])
    np.testing.assert_allclose(float(got[0]), e_w, rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), f_w, rtol=1e-9,
                               atol=1e-9 * np.abs(f_w).max())


@pytest.mark.parametrize("case", CASES)
def test_tile_pair_energy_forces_match_jax(built, case):
    (jf, jspec, jx, jb, jlist), (tf, tspec, tx, tb, tlist) = built[case]
    want = jtp.tile_pair_energy_forces(jf._pair_fn({}), jx, jb,
                                       jf._per_particle({}), jspec,
                                       *jlist[:4], jf.r_cut)
    got = ttp.tile_pair_energy_forces(tf._pair_form(), tx, tb,
                                      tf._per_particle(), tspec, *tlist[:4],
                                      tf.r_cut)
    _assert_ef(want, got)
    e = ttp.tile_pair_energy(tf._pair_form(), tx, tb, tf._per_particle(),
                             tspec, *tlist[:4], tf.r_cut)
    assert float(e) == float(got[0])
    # Newton's third law over the list: reactions reach their atoms
    np.testing.assert_allclose(got[1].sum(0).numpy(), 0.0,
                               atol=1e-9 * float(got[1].abs().max()))


def test_face_crossing_with_xref():
    """Positions staged continuously relative to the build reference keep
    a face-crossing atom's pairs (cf. test_tilepair.py)."""
    js, jx, jb = jmodels.argon_system(n=500, jitter=0.1, seed=3)
    ts, tx, tb = tmodels.argon_system(n=500, jitter=0.1, seed=3, dtype=F64,
                                      device="cpu")
    jx = jx.at[7, 0].set(0.0009)
    tx = tx.clone()
    tx[7, 0] = 0.0009
    jf, tf = js.forces[0], ts.forces[0]
    jspec = jtp.make_tilepair_spec(np.asarray(jb), 500, float(jf.r_cut),
                                   occupancy_from=np.asarray(jx))
    tspec = ttp.make_tilepair_spec(tb, 500, tf.r_cut, occupancy_from=tx,
                                   device="cpu")
    jlist = jtp.build_tile_pairs(jspec, jx, jb)
    tlist = ttp.build_tile_pairs(tspec, tx, tb)
    _assert_lists_equal(jlist, tlist)
    jx1 = jx.at[7, 0].add(-0.011)   # crosses the face; |disp| << skin/2
    tx1 = tx.clone()
    tx1[7, 0] -= 0.011
    want = jtp.tile_pair_energy_forces(jf._pair_fn({}), jx1, jb,
                                       jf._per_particle({}), jspec,
                                       *jlist[:4], jf.r_cut, xref=jx)
    got = ttp.tile_pair_energy_forces(tf._pair_form(), tx1, tb,
                                      tf._per_particle(), tspec, *tlist[:4],
                                      tf.r_cut, xref=tx)
    _assert_ef(want, got)
    # and against the cell path on fresh buckets (same pairs in range)
    from atomsmm_tpu_torch.ops import neighbors as tnb

    spec = tnb.make_neighbor_spec(tb, 500, tf.r_cut, occupancy_floor_from=tx1,
                                  device="cpu")
    bucket, _ = tnb.build_cell_buckets(spec, tx1, tb)
    e_c, f_c = tnb.cell_pair_energy_forces(tf._pair_form(), tx1, tb,
                                           tf._per_particle(), spec, bucket,
                                           tf.r_cut)
    np.testing.assert_allclose(float(got[0]), float(e_c), rtol=1e-11)
    np.testing.assert_allclose(got[1].numpy(), f_c.numpy(), rtol=0,
                               atol=1e-9 * float(f_c.abs().max()))


def test_overflow_flagged_and_retune_measures_entries():
    _, (ts, tx, tb), _ = _systems("argon216")
    tspec = ttp.make_tilepair_spec(tb, 216, ts.forces[0].r_cut, device="cpu")
    tuned = ttp.retune_tilepair_spec(tspec, tx, tb)
    assert not bool(ttp.build_tile_pairs(tuned, tx, tb)[4])
    tiny = dataclasses.replace(tuned, max_entries=2)
    assert bool(ttp.build_tile_pairs(tiny, tx, tb)[4])
    # the measured budget is tight: 0.6x of it overflows
    tight = dataclasses.replace(tuned,
                                max_entries=int(tuned.max_entries * 0.6))
    assert bool(ttp.build_tile_pairs(tight, tx, tb)[4])
    js, jx, jb = jmodels.argon_system(n=216, jitter=0.25, seed=1)
    jspec = jtp.make_tilepair_spec(np.asarray(jb), 216,
                                   float(js.forces[0].r_cut))
    assert jtp.retune_tilepair_spec(jspec, jx, jb).max_entries \
        == tuned.max_entries


def test_update_rebuilds_only_past_half_skin(built):
    _, (_, tspec, tx, tb, _) = built["argon216"]
    extra = ttp.tilepair_extras(tspec, tx, tb)
    moved = tx.clone()
    moved[3] += 0.4 * tspec.skin / np.sqrt(3.0)      # 0.4 skin: keep
    kept = ttp.update_tile_pairs(tspec, extra, moved, tb)
    assert kept["nbr_xref"] is extra["nbr_xref"]
    moved[3] += 0.2 * tspec.skin / np.sqrt(3.0)      # 0.6 skin: rebuild
    rebuilt = ttp.update_tile_pairs(tspec, extra, moved, tb)
    assert torch.equal(rebuilt["nbr_xref"], moved)
    assert not bool(rebuilt["nbr_overflow"])


def test_tilepair_spec_on_a_system_raises(built):
    _, (_, tspec, tx, tb, _) = built["argon216"]
    system, _, _ = tmodels.argon_system(n=216, jitter=0.25, seed=1, dtype=F64,
                                        device="cpu")
    with pytest.raises(NotImplementedError, match="TilePairSpec"):
        tamm.Context(system.with_neighbors(tspec),
                     tamm.VelocityVerletIntegrator(0.002),
                     tamm.make_state(tx, box=tb))
