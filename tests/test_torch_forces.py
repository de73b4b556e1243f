"""Forces, energies and systems of the port against the JAX package.

  * the golden energies of tests/test_goldens.py (argon_864,
    water_216_cutoff) through the port's split_potential_energy at the
    goldens' RTOL 1e-8 (dense O(N²) path, float64);
  * near + far == full for RESPA water 400 on the cell path and on the
    dense path (rtol 1e-10: the fused far force differs from full - near
    only by rounding);
  * per-group energies and forces of RESPA water 400 against the JAX
    package's force_fn at rtol 1e-10 (forces at atol 1e-10 x max|F|);
  * bonded forces against jax.grad;
  * interop: the JAX system carried across with system_from_numpy equals
    the port's own model function.
"""
import dataclasses

import numpy as np
import pytest
import torch

from atomsmm_tpu import models as jmodels
from atomsmm_tpu import potential as jpot
from atomsmm_tpu import systems as jsystems
from atomsmm_tpu.ops import neighbors as jnb
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch import potential as tpot
from atomsmm_tpu_torch import systems as tsystems
from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy
from atomsmm_tpu_torch.ops import neighbors as tnb
from test_goldens import GOLDENS, RTOL as GOLDEN_RTOL

RTOL = 1e-10
F64 = torch.float64


@pytest.mark.parametrize("label", ["argon_864", "water_216_cutoff"])
def test_golden_split_energies(label):
    if label == "argon_864":
        s, x, box = tmodels.argon_system(n=864, jitter=0.1, seed=7, dtype=F64,
                                         device="cpu")
    else:
        s, x, box = tmodels.water_system(n_molecules=216, r_cut=0.8,
                                         r_switch=0.7, seed=3, dtype=F64,
                                             device="cpu")
    split = tpot.split_potential_energy(s, x, box, {})
    expected = GOLDENS[label]
    assert set(split) == set(expected)
    for term, ref in expected.items():
        got = float(split[term])
        if ref == 0.0:
            assert abs(got) < 1e-10, (term, got)
        else:
            assert got == pytest.approx(ref, rel=GOLDEN_RTOL), (term, got, ref)


@pytest.fixture(scope="module")
def water():
    js, jx, jb = jmodels.water_system(n_molecules=400, r_cut=0.7,
                                      r_switch=0.6, seed=5, neighbors=True)
    ts, tx, tb = tmodels.water_system(n_molecules=400, r_cut=0.7,
                                      r_switch=0.6, seed=5, neighbors=True,
                                      dtype=F64, device="cpu")
    # move off the lattice so bonds and angles carry force
    noise = np.random.RandomState(1).normal(scale=0.01, size=tx.shape)
    jx = jx + noise
    tx = tx + torch.as_tensor(noise)
    jr = jsystems.RESPASystem(js, rcut_in=0.45, rswitch_in=0.35)
    tr = tsystems.RESPASystem(ts, rcut_in=0.45, rswitch_in=0.35)
    return (js, jr, jx, jb), (ts, tr, tx, tb)


def _aux(nb, system, x, box):
    return nb.make_aux(system, nb.all_neighbor_extras(system, x, box))


@pytest.mark.parametrize("path", ["cells", "dense"])
def test_near_plus_far_equals_full(water, path):
    _, (ts, tr, tx, tb) = water
    aux_full = _aux(tnb, ts, tx, tb) if path == "cells" else None
    aux_split = _aux(tnb, tr, tx, tb) if path == "cells" else None
    e_full, f_full = tpot.force_fn(ts, groups={0})(tx, tb, {}, aux_full)
    e_split, f_split = tpot.force_fn(tr)(tx, tb, {}, aux_split)
    np.testing.assert_allclose(float(e_split), float(e_full), rtol=RTOL)
    np.testing.assert_allclose(f_split.numpy(), f_full.numpy(), rtol=RTOL,
                               atol=RTOL * float(f_full.abs().max()))


@pytest.mark.parametrize("group", [0, 1, 2])
def test_group_forces_match_jax(water, group):
    (_, jr, jx, jb), (_, tr, tx, tb) = water
    e_j, f_j = jpot.force_fn(jr, groups={group})(jx, jb, {},
                                                 _aux(jnb, jr, jx, jb))
    e_t, f_t = tpot.force_fn(tr, groups={group})(tx, tb, {},
                                                 _aux(tnb, tr, tx, tb))
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=RTOL,
                               atol=RTOL * np.abs(f_j).max())


def test_split_and_group_energies_match_jax(water):
    (_, jr, jx, jb), (_, tr, tx, tb) = water
    ja, ta = _aux(jnb, jr, jx, jb), _aux(tnb, tr, tx, tb)
    js = jpot.split_potential_energy(jr, jx, jb, {}, ja)
    ts_ = tpot.split_potential_energy(tr, tx, tb, {}, ta)
    assert list(js) == list(ts_)
    for k in js:
        np.testing.assert_allclose(float(ts_[k]), float(js[k]), rtol=RTOL)
    jg = jpot.group_energies(jr, jx, jb, {}, ja)
    tg = tpot.group_energies(tr, tx, tb, {}, ta)
    assert sorted(jg) == sorted(tg)
    for g in jg:
        np.testing.assert_allclose(float(tg[g]), float(jg[g]), rtol=RTOL)


@pytest.mark.parametrize("template", [True, False])
def test_bonded_forces_match_jax(template):
    js, jx, jb = jmodels.water_system(n_molecules=64, r_cut=0.45,
                                      r_switch=0.35, seed=2,
                                      template_bonded=template)
    ts, tx, tb = tmodels.water_system(n_molecules=64, r_cut=0.45,
                                      r_switch=0.35, seed=2,
                                      template_bonded=template, dtype=F64,
                                          device="cpu")
    noise = np.random.RandomState(4).normal(scale=0.01, size=tx.shape)
    jx, tx = jx + noise, tx + torch.as_tensor(noise)
    jsb = js.replace_forces(js.forces[1:])
    tsb = ts.replace_forces(ts.forces[1:])
    e_j, f_j = jpot.force_fn(jsb)(jx, jb, {}, None)
    e_t, f_t = tpot.force_fn(tsb)(tx, tb, {}, None)
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=RTOL,
                               atol=RTOL * np.abs(f_j).max())


def _assert_same(a, b, path="system"):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("model", ["water_respa", "argon"])
def test_interop_system_equals_port_model(model):
    if model == "argon":
        js, _, _ = jmodels.argon_system(n=864, jitter=0.1, seed=7,
                                        neighbors=True)
        ts, _, _ = tmodels.argon_system(n=864, jitter=0.1, seed=7,
                                        neighbors=True, dtype=F64,
                                            device="cpu")
    else:
        js, _, _ = jmodels.water_system(n_molecules=400, r_cut=0.7,
                                        r_switch=0.6, seed=5, neighbors=True)
        ts, _, _ = tmodels.water_system(n_molecules=400, r_cut=0.7,
                                        r_switch=0.6, seed=5, neighbors=True,
                                        dtype=F64, device="cpu")
        js = jsystems.RESPASystem(js, rcut_in=0.45, rswitch_in=0.35)
        ts = tsystems.RESPASystem(ts, rcut_in=0.45, rswitch_in=0.35)
    carried = system_from_numpy(describe_reference(js), dtype=F64,
                                device="cpu")
    _assert_same(carried, ts)


def test_interop_refuses_unported_fields():
    """The dispersion tail (ported with PME), the charge-scale mask of the
    alchemical systems (ported with them) and the NBFIX per-type-pair
    tables with the 10-12 coefficients (ported with the Amber reader)
    cross over, equal."""
    import jax.numpy as jnp

    from atomsmm_tpu.utils import replace as jreplace

    js, _, _ = jmodels.water_system(n_molecules=64, r_cut=0.45,
                                    r_switch=0.35, dispersion_correction=True)
    carried = system_from_numpy(describe_reference(js), dtype=F64,
                                device="cpu")
    assert carried.forces[0].dispersion_coeff == pytest.approx(
        float(js.forces[0].dispersion_coeff), rel=1e-15)
    masked = js.replace_forces(
        (jreplace(js.forces[0], charge_scale_mask=jnp.ones(192),
                  charge_scale_name="lambda_q"),) + tuple(js.forces[1:]))
    carried = system_from_numpy(describe_reference(masked), dtype=F64,
                                device="cpu")
    assert carried.forces[0].charge_scale_name == "lambda_q"
    assert carried.forces[0].charge_scale_mask.tolist() == [1.0] * 192
    lj_type = np.tile([0, 1, 1], 64).astype(np.int32)
    tables = {k: np.random.RandomState(i).uniform(0.1, 0.5, (2, 2))
              for i, k in enumerate(("pair_sigma", "pair_epsilon",
                                     "pair_a1012", "pair_b1012"))}
    nbfix = js.replace_forces(
        (jreplace(js.forces[0], lj_type=jnp.asarray(lj_type),
                  **{k: jnp.asarray(v) for k, v in tables.items()}),)
        + tuple(js.forces[1:]))
    carried = system_from_numpy(describe_reference(nbfix), dtype=F64,
                                device="cpu").forces[0]
    assert carried.lj_type.dtype == torch.int32
    assert carried.lj_type.tolist() == lj_type.tolist()
    for k, v in tables.items():
        assert torch.equal(getattr(carried, k), torch.as_tensor(v)), k
    assert carried._pair_form().table and carried._pair_form().hbond


def test_unported_methods_raise():
    """'nocutoff' has no pair-kernel form (dense path only) and an unknown
    method is refused; the triple split of a system without PME keeps
    three groups, as in JAX."""
    s, _, _ = tmodels.water_system(n_molecules=64, r_cut=0.45, r_switch=0.35,
                                   method="nocutoff", dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match="dense path"):
        s.forces[0]._pair_form()
    with pytest.raises(ValueError, match="method"):
        tmodels.water_system(n_molecules=64, r_cut=0.45, r_switch=0.35,
                             method="ewald", device="cpu")
    s, _, _ = tmodels.water_system(n_molecules=64, r_cut=0.45, r_switch=0.35,
                                   device="cpu")
    r = tsystems.RESPASystem(s, 0.3, 0.25, reciprocal_level=True)
    assert sorted({f.group for f in r.forces}) == [0, 1, 2]
