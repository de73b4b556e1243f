"""The emim/BF4 ionic liquid of the port against the JAX package, float64 on
the CPU: 24 ion pairs (312 atoms, 1.93 nm box), PME.

  * the `emim_bf4_24` golden of tests/test_goldens.py, all six terms, at
    rtol 1e-8 from tests/data/emim_bf4_24_minimized.npz;
  * the builder's arrays equal the JAX builder's; through interop the
    energy split and each force's forces agree term by term (energies rtol
    1e-10, forces 1e-10 x max|F|);
  * dihedral_angle, periodic_torsion_energy and pairlist_energy with their
    autograd forces against JAX on random inputs;
  * the RESPA split: near + far == full at 1e-10, exceptions in group 0 or 1;
  * 3 SIN(R) steps with friction 0 and (v, v1, v2) set from numpy against
    JAX: positions, velocities and auxiliary velocities to rtol 1e-9;
  * the plain twins of the half-stencil (near grid, 3^3) and full-stencil
    (far grid, 2^3) sweeps on the 24-pair buckets against the dense oracle.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import models as jmodels
from atomsmm_tpu.ops import bonded as jbonded
from atomsmm_tpu.ops import pairs as jpairs
from atomsmm_tpu.utils import replace as jreplace
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.integrate.sinr import V1, V2
from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy
from atomsmm_tpu_torch.ops import bonded as tbonded
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pairs as tpairs
from atomsmm_tpu_torch.potential import _energy_and_forces
from atomsmm_tpu_torch.utils import replace as treplace

F64 = torch.float64
BOLTZMANN = tamm.units.BOLTZMANN
KW = dict(n_pairs=24, r_cut=0.65, r_switch=0.55, method="pme")

GOLDEN = {  # tests/test_goldens.py, "emim_bf4_24"
    "NonbondedForce": -10868.66516559261,
    "HarmonicBondForce": 3.5096198630818076,
    "HarmonicAngleForce": 27.410576944825213,
    "PeriodicTorsionForce": 24.586278106899822,
    "NonbondedExceptionsForce": 495.4742154740364,
    "Total": -10317.684475203769,
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These systems are a few hundred atoms stepped hundreds of times:
    intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _minimized():
    path = os.path.join(os.path.dirname(__file__), "data",
                        "emim_bf4_24_minimized.npz")
    return np.load(path)["x"]


def _close(got, want, tol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def il():
    """(JAX system, port system, minimized positions, box) with cell lists."""
    js, _, jb = jmodels.ionic_liquid_system(seed=0, neighbors=True, **KW)
    ts, _, tb = tmodels.ionic_liquid_system(seed=0, neighbors=True, dtype=F64,
                                            device="cpu", **KW)
    return js, ts, _minimized(), jb, tb


@pytest.mark.parametrize("term", sorted(GOLDEN))
def test_golden_emim_bf4_24(term):
    system, _, box = tmodels.ionic_liquid_system(seed=0, dtype=F64,
                                                 device="cpu", **KW)
    x = torch.as_tensor(_minimized(), dtype=F64)
    split = tamm.split_potential_energy(system, x, box, {})
    assert set(split) == set(GOLDEN)
    assert float(split[term]) == pytest.approx(GOLDEN[term], rel=1e-8)


def _fields_equal(tobj, jobj, path=""):
    import dataclasses

    for f in dataclasses.fields(tobj):
        got, want = getattr(tobj, f.name), getattr(jobj, f.name, None)
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            assert got.shape == want.shape, (path, f.name)
            if got.dtype == torch.bool or not got.is_floating_point():
                assert np.array_equal(got.numpy(), want), (path, f.name)
            else:
                assert np.array_equal(got.numpy(), want.astype(np.float64)), \
                    (path, f.name)
        elif isinstance(got, (int, float, str, bool, tuple)) \
                and want is not None:
            want = want.item() if hasattr(want, "item") else want
            assert got == (tuple(want) if isinstance(got, tuple) else want), \
                (path, f.name, got, want)


def test_builder_matches_jax_builder():
    js, jx, jb = jmodels.ionic_liquid_system(seed=1, **KW)
    ts, tx, tb = tmodels.ionic_liquid_system(seed=1, dtype=F64, device="cpu",
                                             **KW)
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(ts.masses.numpy(), np.asarray(js.masses))
    assert np.array_equal(ts.molecule.numpy(), np.asarray(js.molecule))
    assert ts.num_molecules == js.num_molecules == 48
    assert ts.num_particles == 24 * 13
    assert [f.name for f in ts.forces] == [f.name for f in js.forces]
    for tf, jf in zip(ts.forces, js.forces):
        _fields_equal(tf, jf, tf.name)
    nb = ts.forces[0]
    q = nb.charge.numpy()
    np.testing.assert_allclose([q.sum(), q[:8].sum(), q[8:13].sum()],
                               [0.0, 1.0, -1.0], atol=1e-10)
    # every pair within three bonds is excluded: up to 7 partners per atom,
    # all inside the exclusion bitmask's window
    assert nb.exclusions.shape == (312, 7)
    assert ts.forces[4].pairs.shape == (24 * 6, 2)  # 1-4 pairs of emim+
    assert ts.forces[4].valid.dtype == torch.bool
    with pytest.raises(tamm.InputError, match="need more ion pairs"):
        tmodels.ionic_liquid_system(n_pairs=8, device="cpu")


def test_neighbor_spec_matches_jax(il):
    js, ts, _, _, _ = il
    for name in ("grid", "reach", "cell_capacity", "half_stencil"):
        jv = getattr(js.neighbors, name, None)
        if jv is not None:
            assert getattr(ts.neighbors, name) == jv, name
    assert ts.neighbors.grid == (2, 2, 2) and not ts.neighbors.half_stencil
    assert ts.neighbors.excbits is not None


@pytest.mark.parametrize("respa", [False, True], ids=["plain", "respa"])
def test_interop_energy_split_and_forces_match_jax(il, respa):
    js, ts, x, jb, tb = il
    if respa:
        js = jamm.RESPASystem(js, rcut_in=0.5, rswitch_in=0.4)
        ts = tamm.RESPASystem(ts, rcut_in=0.5, rswitch_in=0.4)
    carried = system_from_numpy(describe_reference(js), dtype=F64,
                                device="cpu")
    assert [f.name for f in carried.forces] == [f.name for f in ts.forces]
    assert [f.group for f in carried.forces] == [f.group for f in ts.forces]
    assert carried.forces[-1 if not respa else 3].valid.dtype == torch.bool
    tx = torch.as_tensor(x, dtype=F64)
    want = jamm.split_potential_energy(js, x, jb, {})
    for system in (ts, carried):
        got = tamm.split_potential_energy(system, tx, tb, {})
        assert list(got) == list(want)
        for name in want:
            _close(got[name], want[name])
    # forces, force by force, on the dense path of both packages
    for tf, cf, jf in zip(ts.forces, carried.forces, js.forces):
        f_want = -jax.grad(lambda xx: jf.energy(xx, jb, {}, None))(
            jnp.asarray(x))
        for force in (tf, cf):
            e, f = _energy_and_forces(force, tx, tb, {}, None)
            _close(e, jf.energy(jnp.asarray(x), jb, {}, None))
            _close(f, f_want)


def test_torsion_and_pairlist_ops_match_jax():
    rs = np.random.RandomState(4)
    n, t = 60, 200
    x = rs.uniform(0.0, 2.0, size=(n, 3))
    box = np.array([2.0, 2.2, 1.9])
    idx = np.stack([rs.permutation(n)[:4] for _ in range(t)]).astype(np.int32)
    periodicity = rs.randint(1, 5, size=t).astype(np.float64)
    phase = rs.uniform(-np.pi, np.pi, size=t)
    k = rs.uniform(0.5, 30.0, size=t)
    tx = torch.as_tensor(x, dtype=F64).requires_grad_(True)
    tidx = torch.as_tensor(idx).long()
    _close(tbonded.dihedral_angle(tx, tidx),
           jbonded.dihedral_angle(jnp.asarray(x), idx), 1e-12)
    e = tbonded.periodic_torsion_energy(
        tx, tidx, torch.as_tensor(periodicity), torch.as_tensor(phase),
        torch.as_tensor(k))
    _close(e, jbonded.periodic_torsion_energy(jnp.asarray(x), idx,
                                              periodicity, phase, k))
    (g,) = torch.autograd.grad(e, tx)
    _close(g, jax.grad(lambda xx: jbonded.periodic_torsion_energy(
        xx, idx, periodicity, phase, k))(jnp.asarray(x)))

    # pair list: minimum image, per-pair parameters, a mask over the padding
    p = 150
    pairs = np.stack([rs.permutation(n)[:2] for _ in range(p)]).astype(np.int32)
    pairs[-10:] = 0   # padding: both indices 0, r = 0 without the mask
    valid = np.arange(p) < p - 10
    params = {"a": rs.uniform(0.5, 2.0, size=p), "b": rs.uniform(-1, 1, size=p)}

    def pair(r, prm):
        return prm["a"] / r ** 2 + prm["b"] * r

    tparams = {k_: torch.as_tensor(v) for k_, v in params.items()}
    e = tpairs.pairlist_energy(pair, tx, torch.as_tensor(box),
                               torch.as_tensor(pairs), tparams,
                               torch.as_tensor(valid))
    _close(e, jpairs.pairlist_energy(pair, jnp.asarray(x), jnp.asarray(box),
                                     pairs, params, jnp.asarray(valid)))
    (g,) = torch.autograd.grad(e, tx)
    _close(g, jax.grad(lambda xx: jpairs.pairlist_energy(
        pair, xx, jnp.asarray(box), pairs, params, jnp.asarray(valid)))(
            jnp.asarray(x)))
    assert bool(torch.isfinite(g).all())
    # no mask: every entry counts
    e = tpairs.pairlist_energy(pair, tx, torch.as_tensor(box),
                               torch.as_tensor(pairs[:-10]),
                               {k_: v[:-10] for k_, v in tparams.items()})
    _close(e, jpairs.pairlist_energy(
        pair, jnp.asarray(x), jnp.asarray(box), pairs[:-10],
        {k_: v[:-10] for k_, v in params.items()}))


@pytest.mark.parametrize("fast_exceptions", [True, False])
def test_respa_split_sums_to_full(il, fast_exceptions):
    js, ts, x, jb, tb = il
    tx = torch.as_tensor(x, dtype=F64)
    respa = tamm.RESPASystem(ts, rcut_in=0.45, rswitch_in=0.35,
                             fast_exceptions=fast_exceptions)
    jrespa = jamm.RESPASystem(js, rcut_in=0.45, rswitch_in=0.35,
                              fast_exceptions=fast_exceptions)
    assert [(f.name, f.group) for f in respa.forces] \
        == [(f.name, f.group) for f in jrespa.forces]
    groups = {f.name: f.group for f in respa.forces}
    assert groups["NonbondedExceptionsForce"] == (0 if fast_exceptions else 1)
    assert groups["PeriodicTorsionForce"] == 0
    e_f = tamm.split_potential_energy(ts, tx, tb)
    e_r = tamm.split_potential_energy(respa, tx, tb)
    _close(e_r["NearNonbondedForce"] + e_r["FarNonbondedForce"],
           e_f["NonbondedForce"])
    _close(e_r["Total"], e_f["Total"])
    near = next(f for f in respa.forces if f.name == "NearNonbondedForce")
    assert near.alpha == pytest.approx(ts.forces[0].ewald_alpha)
    # per group, energies and forces, against the JAX package's split
    aux = tnb.make_aux(respa, tnb.all_neighbor_extras(respa, tx, tb))
    want = jamm.group_energies(jrespa, x, jb, {})
    got = tamm.group_energies(respa, tx, tb, {}, aux)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    f_sum = torch.zeros_like(tx)
    for g in (0, 1, 2):
        _close(got[g], want[g])
        _, f = tamm.force_fn(respa, {g})(tx, tb, {}, aux)
        _, f_want = jamm.force_fn(jrespa, {g})(jnp.asarray(x), jb, {}, None)
        _close(f, f_want)
        f_sum = f_sum + f
    _, f_full = tamm.force_fn(ts)(tx, tb, {}, None)
    _close(f_sum, f_full)


def test_plain_twins_on_the_buckets_match_the_dense_oracle(il):
    """K2's twin on the 2^3 far grid (Ewald direct-space full form and the
    fused damped far form) and K1's twin on the 3^3 near grid (damped near
    form), with the ionic liquid's exclusion bitmask, against the dense
    O(N^2) path."""
    _, ts, x, _, tb = il
    tx = torch.as_tensor(x, dtype=F64)
    respa = tamm.RESPASystem(ts, rcut_in=0.5, rswitch_in=0.4)
    near_spec = respa.extra_neighbor_specs["near"]
    assert near_spec.grid == (3, 3, 3) and near_spec.half_stencil
    aux = tnb.make_aux(respa, tnb.all_neighbor_extras(respa, tx, tb))
    assert not any(bool(v) for k, v in tnb.all_neighbor_extras(
        respa, tx, tb).items() if k.endswith("overflow"))
    full = ts.forces[0]
    near, far = respa.forces[4], respa.forces[5]
    assert near.neighbor_key == "near"
    for force in (full, near, far):
        e_c, f_c = force._nb_energy_forces(tx, tb, {}, aux, force._pair_form().r_cut)
        e_d, f_d = force._nb_energy_forces(tx, tb, {}, None, force._pair_form().r_cut)
        _close(e_c, e_d)
        _close(f_c, f_d)
        _close(force._nb_energy(tx, tb, {}, aux, force._pair_form().r_cut), e_d)


def _on_constraint(masses, temperature, tau, seed):
    rs = np.random.RandomState(seed)
    m = np.asarray(masses, np.float64)[:, None]
    kT = BOLTZMANN * temperature
    q = kT * tau ** 2
    phi = rs.uniform(0.0, 2 * np.pi, size=(m.shape[0], 3))
    return (np.sqrt(kT / m) * np.sin(phi), np.sqrt(2 * kT / q) * np.cos(phi),
            np.sqrt(kT / q) * rs.normal(size=phi.shape))


def test_sinr_steps_match_jax(il):
    """3 outer steps of SIN(R) [10, 2, 1] @ 10 fs on the cell path: the
    far force on the 2^3 grid (full stencil) with the reciprocal sum, the
    near force on the 3^3 grid (half stencil), four autograd forces in
    group 0."""
    js, ts, x, jb, tb = il
    jrespa = jamm.RESPASystem(js, rcut_in=0.5, rswitch_in=0.4)
    trespa = tamm.RESPASystem(ts, rcut_in=0.5, rswitch_in=0.4)
    kw = dict(temperature=350.0, time_scale=0.02, friction=0.0)
    jctx = jamm.Context(jrespa, jamm.SIN_R_Integrator(0.010, [10, 2, 1], **kw),
                        jamm.make_state(x, box=jb))
    tctx = tamm.Context(trespa, tamm.SIN_R_Integrator(0.010, [10, 2, 1], **kw),
                        tamm.make_state(torch.as_tensor(x, dtype=F64), box=tb))
    v, v1, v2 = _on_constraint(ts.masses, 350.0, 0.02, seed=8)
    jctx.state = jreplace(jctx.state, v=jnp.array(v)).with_extra(
        **{V1: jnp.array(v1), V2: jnp.array(v2)})
    tctx.state = treplace(tctx.state, v=torch.as_tensor(v)).with_extra(
        **{V1: torch.as_tensor(v1), V2: torch.as_tensor(v2)})
    jctx.step(3)
    tctx.step(3)
    assert tctx.last_step_passes == 1
    for got, want in ((tctx.state.x, jctx.state.x),
                      (tctx.state.v, jctx.state.v),
                      (tctx.state.extra[V1], jctx.state.extra[V1]),
                      (tctx.state.extra[V2], jctx.state.extra[V2]),
                      (tctx.state.extra["fcache_2"],
                       jctx.state.extra["fcache_2"])):
        _close(got, want, 1e-9)
    assert float((tctx.state.x - torch.as_tensor(x)).abs().max()) > 1e-3
    kT = BOLTZMANN * 350.0
    c = ts.masses[:, None] * tctx.state.v ** 2 \
        + 0.5 * kT * 0.02 ** 2 * tctx.state.extra[V1] ** 2
    assert float((c / kT - 1).abs().max()) < 1e-9
