"""What the port once refused and now runs, as the JAX package runs it,
float64 on the CPU against the JAX package, and on the card (marker
``cuda``):

  * exclusion tables wider than 16 columns: the 1-2/1-3/1-4 closure of a
    comb-shaped bond graph (a backbone with k pendant atoms a backbone
    atom, numbered after the backbone, so that excluded pairs lie far
    beyond +-14 indices) over 256 charged LJ atoms, 17, 32 and 64 columns
    wide. The spec splits it (the bitmask within +-14 indices, each atom's
    far ids beside it); K1's and K2's plain twins take the split against
    JAX's XLA sweep of the whole table, energies 1e-10 and forces
    1e-9 x max|F|; a JAX spec of such a table (no bitmask there) crosses
    through interop into the split form;
  * a peptide-like chain prmtop (a backbone, a methyl side group and a
    hydrogen on each backbone atom, hydrogens numbered last: 24 excluded
    partners an atom, 1-4 pairs 20 indices apart) read by both packages'
    amber_system, on the cell lists (the split form), per-force energies
    1e-10 of the largest and forces 1e-9 x max|F|;
  * the capacity dispatch: a half-stencil grid whose cells exceed K1's
    1,024 atoms goes to K2 on the full stencil (its twin on the CPU);
  * the Monte Carlo barostat in a sheared (3, 3) cell: 216 waters at
    0.45 nm, RF and PME, velocity Verlet + NHC at 1 fs, a volume move every
    2 steps for 10 steps, the port on its cell lists (K1's twin on a 3^3
    grid) and JAX on its dense path with JAX's
    uniforms replayed into the port: x, v and the box to 1e-9 of their
    largest entry, equal attempt, acceptance and invalid-trial counts;
  * the 10-12 term without NBFIX tables: A and B by LJ type, sigma and
    epsilon by Lorentz-Berthelot, on the dense path and on the cells (a
    table combined from the types), and, where atoms of one type differ,
    on the dense path, on the CPU and on the card;
  * a CustomNonbondedForce whose function does not lower (torch.sign)
    runs on the callable cell sweep, counted in CALLABLE_SWEEPS with one
    warning, against the JAX package's cell sweep of the same function
    (1e-10); a function of torch.atan now lowers and never takes that
    route.

The JAX package is imported inside the tests that compare with it, so
that the ``cuda`` cases run on a machine that has PyTorch alone:
    pytest tests/test_torch_refusals_lifted.py -m cuda -q --noconftest
They hold K1 and K2 in the split form against their float64 twins (f64
1e-10 and 1e-9 x max|F|, f32 1e-4), a described spec without its bitmask
built on the card by interop, K2 at a capacity above 1,024 through
the dispatch, the dense path (argon 864 and 27 waters without a cutoff)
card against CPU to 1e-9, the 10-12 table forms on K1 and K2, the 10-12
term over atoms of one type that differ on the card's dense path (an Amber
slice: the peptide-like chain in TIP3P water, card against CPU, 1e-10),
and 6 NPT steps in a sheared cell card against CPU with the uniforms
shared.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.integrate import barostat as tbaro
from atomsmm_tpu_torch.models.peptide import (bond_closure, peptide_prmtop,
                                              peptide_topology)
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pair_kernel as tpk
from atomsmm_tpu_torch.utils import InputError
from atomsmm_tpu_torch.utils import replace as treplace

F64 = torch.float64
RTOL, FTOL, TRAJ_TOL = 1e-10, 1e-9, 1e-9
F32_TOL = 1e-4
SHEAR = (0.05, 0.03, 0.03)


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


def _t(a, device="cpu"):
    return torch.as_tensor(np.asarray(a), dtype=F64, device=device)


def _close(got_e, got_f, want_e, want_f, rtol=RTOL, ftol=FTOL):
    want_f = np.asarray(want_f)
    assert abs(float(got_e) - float(want_e)) <= rtol * abs(float(want_e))
    err = float(np.abs(np.asarray(got_f.detach().cpu()) - want_f).max())
    assert err <= ftol * np.abs(want_f).max(), err


# --- exclusion tables wider than 16 columns ---------------------------------

#: table width -> (pendant atoms a backbone atom, extra pendants on the
#: middle one): the widest row holds 6 + 5 k + extra ids
COMB = {17: (2, 1), 32: (5, 1), 64: (11, 3)}


def comb_exclusions(n, width):
    """(n, width) int32: the 1-2/1-3/1-4 closure of a comb over n atoms,
    -1 padded: a backbone 0 ... b - 1 in a chain, each backbone atom with
    k pendant atoms numbered after the backbone (the middle one with
    k + extra), so that pendant-backbone pairs lie far beyond +-14
    indices. Its widest row is exactly `width` ids."""
    k, extra = COMB[width]
    b = (n - extra) // (1 + k)
    bonds = [(i, i + 1) for i in range(b - 1)]
    nxt = b
    for v in range(b):
        for _ in range(k + (extra if v == b // 2 else 0)):
            bonds.append((v, nxt))
            nxt += 1
    table = bond_closure(n, bonds)
    assert table.shape[1] == width, (table.shape, width)
    return table


N_ARGON, R_ARGON = 256, 0.6


def charged_argon(width):
    """Argon 256 (jittered lattice, 2.33 nm box) with charges from a seed
    and the comb table of `width` columns, float64 on the CPU; (force,
    spec, x, box) with the spec built for the table (3^3 grid with half
    maps at 0.6 nm)."""
    n, r_cut = N_ARGON, R_ARGON
    system, x, box = tmodels.argon_system(n=n, jitter=0.1, seed=4,
                                          r_cut=r_cut, r_switch=r_cut - 0.1,
                                          dtype=F64, device="cpu")
    q = np.random.RandomState(6).uniform(-0.6, 0.6, n)
    exc = comb_exclusions(n, width)
    force = dataclasses.replace(
        system.forces[0], charge=torch.as_tensor(q - q.mean()),
        exclusions=torch.as_tensor(exc))
    spec = tnb.make_neighbor_spec(box, n, r_cut, exclusions=exc,
                                  occupancy_floor_from=x, device="cpu")
    return force, spec, x, box


def _jax_charged_argon(width):
    """charged_argon in the JAX package: (system with its force and cell
    spec, x, box)."""
    import jax.numpy as jnp

    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.ops import neighbors as jnb
    from atomsmm_tpu.utils import replace as jreplace

    n, r_cut = N_ARGON, R_ARGON
    js, jx, jb = jmodels.argon_system(n=n, jitter=0.1, seed=4, r_cut=r_cut,
                                      r_switch=r_cut - 0.1)
    q = np.random.RandomState(6).uniform(-0.6, 0.6, n)
    exc = comb_exclusions(n, width)
    jf = jreplace(js.forces[0], charge=jnp.asarray(q - q.mean()),
                  exclusions=jnp.asarray(exc))
    spec = jnb.make_neighbor_spec(jb, n, r_cut, exclusions=exc,
                                  occupancy_floor_from=np.asarray(jx))
    assert spec.backend == "xla" and spec.excbits is None
    return jreplace(js, forces=(jf,), neighbors=spec), jx, jb


@functools.lru_cache(maxsize=None)
def _jax_comb_reference(width):
    """JAX's XLA cell sweep of charged_argon's force and table: (energy,
    forces) as numpy."""
    from atomsmm_tpu.ops import neighbors as jnb

    js, jx, jb = _jax_charged_argon(width)
    jf, spec = js.forces[0], js.neighbors
    bucket, _ = jnb.build_cell_buckets(spec, jx, jb)
    e, f = jnb.cell_pair_energy_forces(jf._pair_fn({}), jx, jb,
                                       jf._per_particle({}), spec, bucket,
                                       jf.r_cut)
    return float(e), np.asarray(f)


@pytest.mark.parametrize("twin", ["K1", "K2"])
@pytest.mark.parametrize("width", sorted(COMB))
def test_wide_exclusion_table_on_the_twins_matches_jax(width, twin):
    force, spec, x, box = charged_argon(width)
    assert spec.exclusion_form == "split" and spec.half_stencil
    far = spec.exclusions_far.numpy()
    assert far.shape[1] >= 1 and (far[far >= 0] >= 0).all()
    ids = np.arange(x.shape[0])[:, None]
    assert (np.abs(np.where(far >= 0, far - ids, 99)) > 14).all()
    if twin == "K2":
        spec = dataclasses.replace(spec, half_stencil=False)
    bucket, overflow = tnb.build_cell_buckets(spec, x, box)
    assert not bool(overflow)
    e, f = tnb.cell_pair_energy_forces(force._pair_form(), x, box,
                                       force._per_particle(), spec, bucket,
                                       force.r_cut)
    _close(e, f, *_jax_comb_reference(width))


def test_wide_table_spec_from_jax_takes_the_split_form():
    """A JAX system whose spec holds a 32-column table (the JAX spec has
    no bitmask then) crosses through interop into a spec in the split
    form, whose sweep (K1's twin) equals JAX's."""
    from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy

    js, jx, jb = _jax_charged_argon(32)
    ts = system_from_numpy(describe_reference(js), dtype=F64, device="cpu")
    spec, force = ts.neighbors, ts.forces[0]
    assert spec.exclusion_form == "split" and spec.half_stencil
    x, box = _t(jx), _t(jb)
    bucket, _ = tnb.build_cell_buckets(spec, x, box)
    e, f = tnb.cell_pair_energy_forces(force._pair_form(), x, box,
                                       force._per_particle(), spec, bucket,
                                       force.r_cut)
    _close(e, f, *_jax_comb_reference(32))


def test_split_and_columns_exclude_the_same_slots():
    """Over every slot of the 3^3 full stencil, the split form (bits and
    far ids) excludes exactly what the whole table's id columns exclude,
    self pairs included; the bitmask alone would miss the far pairs."""
    force, spec, x, box = charged_argon(64)
    bucket, _ = tnb.build_cell_buckets(spec, x, box)
    hf, hm, far = tpk.stage(spec, x, force._per_particle(), bucket)
    # the whole table staged as the id columns
    _, _, cols = tpk.stage(dataclasses.replace(
        spec, exclusions_far=spec.exclusions), x, force._per_particle(),
        bucket)
    nbr = spec.nbr_cells.long()
    hid = hm[..., 0][:, None, :, None]
    cid = hm[..., 0][nbr][:, :, None, :]
    by_split = tpk.excluded(hid, cid, hm[..., 1][:, None, :, None],
                            far[:, None, :, None, :])
    by_cols = tpk.excluded(hid, cid, cols=cols[:, None, :, None, :])
    by_bits = tpk.excluded(hid, cid, hm[..., 1][:, None, :, None])
    real = (hid < x.shape[0]) & (cid < x.shape[0])
    assert torch.equal(by_split & real, by_cols & real)
    assert bool((by_cols & real & ~by_bits).any())


def test_make_neighbor_spec_picks_the_exclusion_form():
    """Bits where every pair lies within +-14 indices; the split where
    some lie farther apart, one column or 17; a spec given a table and no
    bitmask derives the same; make_exclusion_bits still refuses a table it
    cannot hold."""
    n = 256
    _, x, box = tmodels.argon_system(n=n, jitter=0.1, seed=4, r_cut=0.6,
                                     r_switch=0.5, dtype=F64, device="cpu")
    near = np.full((n, 1), -1, np.int32)
    near[0, 0], near[1, 0] = 1, 0
    swap = np.full((n, 1), -1, np.int32)
    swap[0, 0], swap[200, 0] = 200, 0
    specs = {name: tnb.make_neighbor_spec(box, n, 0.6, exclusions=e,
                                          device="cpu")
             for name, e in (("near", near), ("swap", swap),
                             ("wide", comb_exclusions(n, 17)))}
    assert {k: v.exclusion_form for k, v in specs.items()} == {
        "near": "bits", "swap": "split", "wide": "split"}
    for spec in specs.values():
        again = dataclasses.replace(spec, excbits=None, exclusions_far=None)
        assert torch.equal(again.excbits, spec.excbits)
        assert again.exclusion_form == spec.exclusion_form
        if spec.exclusions_far is not None:
            assert torch.equal(again.exclusions_far, spec.exclusions_far)
    with pytest.raises(ValueError, match="bitmask"):
        tnb.make_exclusion_bits(n, comb_exclusions(n, 17))
    bits, far = tnb.split_exclusions(n, swap)
    assert far.tolist()[0] == [200] and far.tolist()[200] == [0]
    assert bits[0] == bits[200] == 1 << tnb.EXC_OFF


# --- a peptide-like chain prmtop ----------------------------------------------


def peptide_positions(n, box_l):
    """Positions of the chain's atoms on a jittered 4^3 lattice of the box
    (no two atoms closer than about 0.4 nm)."""
    g = np.arange(4) * box_l / 4
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rs = np.random.RandomState(3)
    return sites[rs.permutation(len(sites))[:n]] + rs.uniform(
        -0.05, 0.05, (n, 3))


@pytest.mark.parametrize("r_cut,half", [(0.6, True), (0.9, False)],
                         ids=["K1_twin", "K2_twin"])
def test_peptide_prmtop_on_the_split_cells_matches_jax(r_cut, half):
    import test_torch_amber as tta

    text = peptide_prmtop(6)
    bonds, _, _, is_h = peptide_topology(6)
    n = len(is_h)
    box = np.full(3, 2.4)
    js, ts = tta._build_both(text, box=box, method="cutoff", r_cut=r_cut,
                             r_switch=r_cut - 0.1, neighbors=True)
    spec = ts.neighbors
    assert spec.exclusion_form == "split" and spec.half_stencil == half
    closure = bond_closure(n, bonds)
    assert closure.shape[1] == 24
    got = spec.exclusions.numpy()
    assert got.shape[1] >= 24
    np.testing.assert_array_equal(
        np.sort(np.where(got >= 0, got, n + 1), axis=1)[:, :24],
        np.where(closure >= 0, closure, n + 1))
    tta._check_energies(js, ts, peptide_positions(n, 2.4), box, cells=True)


# --- the capacity dispatch ----------------------------------------------------


def test_half_stencil_past_k1_capacity_takes_k2(monkeypatch):
    """A half-stencil grid whose cells exceed K1's capacity takes K2 on
    the full stencil: at the real limit (1,024) by the spec alone, and, at
    a limit lowered below water 216's 4^3 near-grid capacity, through the
    sweep, whose result equals JAX's XLA sweep; K1 keeps every grid it
    takes."""
    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.ops import neighbors as jnb

    force, spec, x, box = charged_argon(17)
    assert tnb.takes_half_stencil(spec)
    assert tnb.takes_half_stencil(dataclasses.replace(
        spec, cell_capacity=tpk.K1_MAX_CAP))
    assert not tnb.takes_half_stencil(dataclasses.replace(
        spec, cell_capacity=tpk.K1_MAX_CAP + 4))

    kw = dict(n_molecules=216, r_cut=0.4, r_switch=0.3, seed=5)
    js, jx, jb = jmodels.water_system(neighbors=True, **kw)
    ts, tx, tb = tmodels.water_system(neighbors=True, dtype=F64,
                                      device="cpu", **kw)
    spec = ts.neighbors
    assert spec.half_stencil and spec.grid == (4, 4, 4)
    calls = []
    full = tpk.full_pair_plain
    monkeypatch.setattr(tpk, "full_pair_plain",
                        lambda *a, **k: calls.append(1) or full(*a, **k))
    monkeypatch.setattr(tpk, "K1_MAX_CAP", spec.cell_capacity - 1)
    assert not tnb.takes_half_stencil(spec)
    bucket, _ = tnb.build_cell_buckets(spec, tx, tb)
    tf, jf = ts.forces[0], js.forces[0]
    e, f = tnb.cell_pair_energy_forces(tf._pair_form(), tx, tb,
                                       tf._per_particle(), spec, bucket,
                                       tf.r_cut)
    assert calls == [1]
    jbucket, _ = jnb.build_cell_buckets(js.neighbors, jx, jb)
    want = jnb.cell_pair_energy_forces(jf._pair_fn({}), jx, jb,
                                       jf._per_particle({}), js.neighbors,
                                       jbucket, jf.r_cut)
    _close(e, f, *want)


# --- the Monte Carlo barostat in a (3, 3) cell --------------------------------


def shear_cell(box_l, shear=SHEAR):
    sx, cx, cy = shear
    return np.array([[box_l, 0.0, 0.0], [sx * box_l, box_l, 0.0],
                     [cx * box_l, cy * box_l, box_l]])


def into_cell(x, molecule, masses, box_l, cell):
    """Each molecule's centre of mass mapped affinely from the cube of
    edge box_l into `cell`, its geometry kept (numpy float64)."""
    x = np.asarray(x, np.float64)
    mol, m = np.asarray(molecule, np.int64), np.asarray(masses, np.float64)
    com = np.stack([np.bincount(mol, m * x[:, d]) for d in range(3)], 1) \
        / np.bincount(mol, m)[:, None]
    return x + (com @ (np.asarray(cell) / box_l) - com)[mol]


R_WATER = 0.45


def sheared_water(method, device="cpu"):
    """The port's 216 waters at R_WATER in the sheared cell (molecules'
    centres mapped into it), the barostat every 2 steps, a cell list built
    for the cell, float64; (system, x, v, cell) as tensors, v from a numpy
    draw at 300 K."""
    from atomsmm_tpu_torch.ops.pme import choose_pme_parameters

    r_cut = R_WATER
    system, x, box = tmodels.water_system(
        n_molecules=216, method=method, r_cut=r_cut, r_switch=r_cut - 0.1,
        seed=5, dtype=F64, device=device)
    box_l = float(box[0])
    cell = shear_cell(box_l)
    xs = into_cell(x.cpu(), system.molecule.cpu(), system.masses.cpu(),
                   box_l, cell)
    nb = system.forces[0]
    if method == "pme":
        _, grid, _ = choose_pme_parameters(r_cut, cell,
                                           alpha=float(nb.ewald_alpha),
                                           order=int(nb.spline_order))
        nb = treplace(nb, grid_shape=grid)
    system = treplace(system, forces=(nb,) + tuple(system.forces[1:]),
                      default_box=_t(cell, device))
    system = system.with_neighbors(tnb.make_neighbor_spec(
        cell, system.num_particles, r_cut, exclusions=nb.exclusions,
        occupancy_floor_from=xs, device=device))
    system = system.add_force(tamm.MonteCarloBarostat(
        pressure=1.0, temperature=300.0, frequency=2))
    m = system.masses.cpu().numpy()
    v = np.random.RandomState(9).normal(size=xs.shape) * np.sqrt(
        tamm.units.BOLTZMANN * 300.0 / m)[:, None]
    return system, _t(xs, device), _t(v, device), _t(cell, device)


def _vv_nhc(pkg, system):
    """Velocity Verlet at 1 fs inside a Nose-Hoover chain at 300 K, of
    either package."""
    return pkg.GlobalThermostatIntegrator(0.001, pkg.NoseHooverChainPropagator(
        300.0, 3 * system.num_particles - 3, 0.1))


@pytest.mark.parametrize("method", ["cutoff", "pme"])
def test_barostat_in_a_sheared_cell_matches_jax(method):
    import jax.numpy as jnp

    import atomsmm_tpu as jamm
    import test_torch_barostat as ttb
    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.ops.pme import choose_pme_parameters as jchoose
    from atomsmm_tpu.utils import replace as jreplace

    ts, tx, tv, cell = sheared_water(method)
    assert ts.neighbors.grid == (3, 3, 3) and ts.neighbors.half_stencil

    js, _, _ = jmodels.water_system(n_molecules=216, method=method,
                                    r_cut=R_WATER, r_switch=R_WATER - 0.1,
                                    seed=5)
    nb = js.forces[0]
    if method == "pme":
        _, grid, _ = jchoose(R_WATER, cell.numpy(),
                             alpha=float(nb.ewald_alpha),
                             order=int(nb.spline_order))
        nb = jreplace(nb, grid_shape=grid)
    assert tuple(nb.grid_shape) == tuple(ts.forces[0].grid_shape)
    js = jreplace(js, forces=(nb,) + tuple(js.forces[1:]),
                  default_box=jnp.asarray(cell.numpy()))
    js = js.add_force(jamm.MonteCarloBarostat(pressure=1.0, temperature=300.0,
                                              frequency=2))
    jctx = jamm.Context(js, _vv_nhc(jamm, ts), jamm.make_state(
        jnp.asarray(tx.numpy()), v=jnp.asarray(tv.numpy()),
        box=jnp.asarray(cell.numpy()), seed=4))
    tctx = tamm.Context(ts, _vv_nhc(tamm, ts), tamm.make_state(
        tx, v=tv, box=cell, seed=4))
    draws = iter(ttb._jax_uniforms(jctx.state.rng, 5))
    tctx._barostat._uniforms = lambda state: tuple(
        torch.tensor(u, dtype=F64) for u in next(draws))
    jctx.step(10)
    tctx.step(10)
    for key in (tbaro.BARO_NATT, tbaro.BARO_NACC, tbaro.BARO_NBAD):
        assert int(tctx.state.extra[key]) == int(jctx.state.extra[key]), key
    assert int(tctx.state.extra[tbaro.BARO_NATT]) == 5
    assert int(tctx.state.extra[tbaro.BARO_NACC]) >= 1
    box = tctx.state.box.numpy()
    assert box.shape == (3, 3)
    for got, want in ((tctx.state.x, jctx.state.x),
                      (tctx.state.v, jctx.state.v),
                      (tctx.state.box, jctx.state.box)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TRAJ_TOL * np.abs(want).max())
    # the cell keeps its shape: H / V^(1/3) unchanged
    np.testing.assert_allclose(
        box / np.cbrt(np.linalg.det(box)),
        cell.numpy() / np.cbrt(np.linalg.det(cell.numpy())), atol=1e-12)


# --- the 10-12 term without NBFIX tables --------------------------------------

A1012 = np.array([[2.0e-6, 1.0e-6], [1.0e-6, 0.0]])
B1012 = np.array([[3.0e-4, 2.0e-4], [2.0e-4, 0.0]])


def hbond_water(mixed=False):
    """27 waters at 0.45 nm with LJ types O = 0, H = 1 and the 10-12 term
    by type (no NBFIX tables); `mixed` gives one hydrogen its own sigma,
    so that atoms of one type differ. (JAX force, port force, x, box)."""
    import jax.numpy as jnp

    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.utils import replace as jreplace

    kw = dict(n_molecules=27, r_cut=0.45, r_switch=0.4, seed=2)
    js, jx, jb = jmodels.water_system(**kw)
    ts, tx, tb = tmodels.water_system(dtype=F64, device="cpu", **kw)
    types = (np.arange(tx.shape[0]) % 3 != 0).astype(np.int32)
    sig = ts.forces[0].sigma.numpy().copy()
    eps = ts.forces[0].epsilon.numpy().copy()
    sig[types == 1], eps[types == 1] = 0.1, 0.02
    if mixed:
        sig[1] = 0.12
    new = dict(lj_type=types, sigma=sig, epsilon=eps, pair_a1012=A1012,
               pair_b1012=B1012)
    jf = jreplace(js.forces[0], **{k: jnp.asarray(v) for k, v in new.items()})
    tf = dataclasses.replace(ts.forces[0], **{
        k: torch.as_tensor(v) for k, v in new.items()})
    x = np.asarray(jx) + np.random.RandomState(1).normal(scale=0.01,
                                                         size=jx.shape)
    return jf, tf, x, np.asarray(jb)


@pytest.mark.parametrize("mixed", [False, True], ids=["by_type", "mixed"])
def test_hbond_1012_without_tables_matches_jax(mixed):
    """Energies 1e-10 and forces 1e-9 x max|F| against JAX's dense path,
    the port on its dense path and on the cells (K1's twin through the
    combined table, or, for atoms of one type that differ, the dense
    path again)."""
    import jax
    import jax.numpy as jnp

    jf, tf, x, box = hbond_water(mixed)
    assert (tf._table is None) == mixed and tf._dense_only == mixed
    e_j, g_j = jax.value_and_grad(lambda xx: jf.energy(
        xx, jnp.asarray(box), {}))(jnp.asarray(x))
    e_t, f_t = tf.energy_and_forces(_t(x), _t(box), {})
    _close(e_t, f_t, e_j, -np.asarray(g_j))
    spec = tnb.make_neighbor_spec(box, x.shape[0], tf.r_cut,
                                  exclusions=tf.exclusions,
                                  occupancy_floor_from=x, device="cpu")
    aux = {"default": {"spec": spec, "bucket": tnb.build_cell_buckets(
        spec, _t(x), _t(box))[0]}}
    e_c, f_c = tf.energy_and_forces(_t(x), _t(box), {}, aux)
    _close(e_c, f_c, e_j, -np.asarray(g_j))
    if mixed:
        with pytest.raises(InputError, match="10-12"):
            tf._pair_form()
    else:
        form = tf._pair_form()
        assert form.table and form.hbond


# --- a user function that does not lower ----------------------------------------


def _route_pair(mod, name):
    """The user functions of the route tests, from torch or jax.numpy:
    'sign' multiplies a Coulomb pair by sign(r) = 1 (no lowered
    operation takes sign), 'atan' screens it by atan(0.5 / r)."""
    if mod == "torch":
        sign, atan = torch.sign, torch.atan
    else:
        import jax.numpy as jnp

        sign, atan = jnp.sign, jnp.arctan
    if name == "sign":
        return lambda r, pi, pj, g: sign(r) * pi["q"] * pj["q"] / r
    return lambda r, pi, pj, g: pi["q"] * pj["q"] * atan(0.5 / r) / r


@pytest.mark.parametrize("name", ["sign", "atan"])
def test_unlowered_function_takes_the_counted_callable_route(name):
    """Water 125 at 0.6 nm (K2's grid): a function that does not lower
    runs on the callable cell sweep, each sweep counted in
    CALLABLE_SWEEPS, one warning naming the lowering error however many
    sweeps; a function of atan lowers and takes the kernels' form, no
    callable sweep and no warning. Both against the JAX package's XLA
    cell sweep of the same function: energy 1e-10, forces 1e-9 x
    max|F|."""
    import warnings

    import jax.numpy as jnp
    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.ops import neighbors as jnb

    from atomsmm_tpu_torch.ops.pairtrace import UserForm

    kw = dict(n_molecules=125, r_cut=0.6, r_switch=0.5, seed=5,
              neighbors=True)
    js, jx, jb = jmodels.water_system(**kw)
    ts, tx, tb = tmodels.water_system(dtype=F64, device="cpu", **kw)
    nb = ts.forces[0]
    force = tamm.CustomNonbondedForce(
        per_particle={"q": nb.charge}, exclusions=nb.exclusions,
        energy_function=_route_pair("torch", name), r_cut=0.6)
    system = tamm.System(masses=ts.masses, forces=(force,),
                         default_box=tb).with_neighbors(ts.neighbors)
    aux = tnb.make_aux(system, tnb.all_neighbor_extras(system, tx, tb))
    tpk.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        e, f = force.energy_and_forces(tx, tb, {}, aux)
        e2 = force.energy(tx, tb, {}, aux)
        form = force._kernel_form({}, tx, aux["default"])
    said = [w for w in caught if "callable cell sweep" in str(w.message)]
    if name == "sign":
        assert form is None and tpk.CALLABLE_SWEEPS["cell"] == 2
        assert len(said) == 1 and "aten.sign" in str(said[0].message)
    else:
        assert isinstance(form, UserForm) and not said
        assert tpk.CALLABLE_SWEEPS["cell"] == 0
    jspec = dataclasses.replace(js.neighbors, backend="xla")
    jbucket = jnb.neighbor_list_extras(jspec, jx, jb)[jnb.NBR_BUCKET]
    jfn = _route_pair("jax", name)
    je, jf = jnb.cell_pair_energy_forces(
        lambda r, pi, pj: jfn(r, pi, pj, {}), jx, jb,
        {"q": jnp.asarray(js.forces[0].charge)}, jspec, jbucket, 0.6)
    _close(e, f, je, jf)
    assert float(e2) == pytest.approx(float(e), rel=1e-12)


# --- on the card ----------------------------------------------------------------


def _card_vs_twin(force, spec, x, box, dev, kernel, form=None):
    """The kernel the dispatch selects (launched once, counted) in float64
    and float32 against the float64 plain twin on the card."""
    spec_d = dataclasses.replace(spec, **{
        f.name: getattr(spec, f.name).to(dev)
        for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)})
    form = force._pair_form() if form is None else form
    pp64 = {k: v.to(dev, F64) if v.is_floating_point() else v.to(dev)
            for k, v in force._per_particle().items()}
    for dtype, (rtol, ftol) in ((F64, (RTOL, FTOL)),
                                (torch.float32, (F32_TOL, F32_TOL))):
        xd, bd = x.to(dev, dtype).contiguous(), box.to(dev, dtype)
        pp = {k: (v.to(dtype) if v.is_floating_point() else v)
              for k, v in pp64.items()}
        bucket, overflow = tnb.build_cell_buckets(spec_d, xd, bd)
        assert not bool(overflow)
        before = dict(tpk.LAUNCHES)
        e_k, f_k = tnb.cell_pair_energy_forces(form, xd, bd, pp, spec_d,
                                               bucket, form.r_cut)
        torch.cuda.synchronize()
        assert tpk.LAUNCHES[kernel] == before[kernel] + 1
        plain = (tpk.half_pair_plain if tnb.takes_half_stencil(spec_d)
                 else tpk.full_pair_plain)
        out = plain(xd.double(), pp64, bucket, spec_d, bd.double(), form,
                    form.r_cut)
        _close(e_k, f_k, float(out[:, 3].sum()), out[:-1, :3].cpu().numpy(),
               rtol, ftol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["half_pair", "cell_pair"])
@pytest.mark.parametrize("width", sorted(COMB))
def test_split_form_kernels_match_plain_on_card(cuda, width, kernel):
    force, spec, x, box = charged_argon(width)
    if kernel == "cell_pair":
        spec = dataclasses.replace(spec, half_stencil=False)
    _card_vs_twin(force, spec, x, box, cuda, kernel)


@pytest.mark.cuda
def test_spec_without_bitmask_through_interop_on_card(cuda):
    """A described system whose spec carries a 32-column table and no
    bitmask (as the JAX package's spec does for such a table) is built on
    the card, interop's default device, in the split form; K1 there
    against its twin."""
    from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy

    force, spec, x, box = charged_argon(32)
    system, _, _ = tmodels.argon_system(n=N_ARGON, jitter=0.1, seed=4,
                                        r_cut=R_ARGON,
                                        r_switch=R_ARGON - 0.1, dtype=F64,
                                        device="cpu")
    desc = describe_reference(dataclasses.replace(
        system, forces=(force,), neighbors=spec))
    desc["neighbors"].update(excbits=None, exclusions_far=None)
    ts = system_from_numpy(desc, dtype=F64)
    assert ts.neighbors.exclusion_form == "split"
    assert ts.neighbors.excbits.is_cuda and ts.neighbors.exclusions_far.is_cuda
    _card_vs_twin(ts.forces[0], ts.neighbors, x, box, cuda, "half_pair")


@pytest.mark.cuda
def test_k1_refuses_and_dispatch_sends_past_1024_to_k2_on_card(cuda):
    """Water 400 at 0.6 nm: a 3^3 grid with half maps; its cells padded
    past 1,024 slots go to K2 through the dispatch, and K1's own wrapper
    refuses them."""
    system, x, box = tmodels.water_system(n_molecules=400, r_cut=0.6,
                                          r_switch=0.5, seed=5, dtype=F64,
                                          device="cpu")
    force = system.forces[0]
    spec = tnb.make_neighbor_spec(box, x.shape[0], 0.6,
                                  exclusions=force.exclusions,
                                  occupancy_floor_from=x, device="cpu")
    wide = dataclasses.replace(spec, cell_capacity=tpk.K1_MAX_CAP + 8)
    assert wide.half_stencil and not tnb.takes_half_stencil(wide)
    _card_vs_twin(force, wide, x, box, cuda, "cell_pair")
    spec_d = dataclasses.replace(wide, nbr_cells_half=wide.nbr_cells_half.to(
        cuda), excbits=wide.excbits.to(cuda))
    xd, bd = x.to(cuda), box.to(cuda)
    bucket, _ = tnb.build_cell_buckets(spec_d, xd, bd)
    with pytest.raises(ValueError, match="capacity"):
        tpk.half_pair_cuda(xd, {k: v.to(cuda) for k, v in
                                force._per_particle().items()}, bucket,
                           spec_d, bd, force._pair_form(), 0.6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["argon864", "water27_nocutoff"])
def test_dense_path_on_card_equals_cpu(cuda, name):
    """A System without a NeighborSpec: energies and forces by autograd of
    the chunked sum, card against CPU in float64."""
    from atomsmm_tpu_torch.potential import force_fn

    out = []
    for device in ("cpu", cuda):
        if name == "argon864":
            s, x, box = tmodels.argon_system(n=864, jitter=0.1, seed=7,
                                             dtype=F64, device=device)
        else:
            s, x, box = tmodels.water_system(
                n_molecules=27, method="nocutoff", r_cut=0.45,
                r_switch=0.35, seed=2, dtype=F64, device=device)
        assert s.neighbors is None
        out.append(force_fn(s)(x, box, {}, None))
    (e_c, f_c), (e_g, f_g) = out
    _close(e_g, f_g, float(e_c), f_c.numpy(), 1e-9, 1e-9)


@pytest.mark.cuda
def test_hbond_1012_table_forms_on_card(cuda):
    """The combined table of hbond_water's types, at 216 waters (a 3^3
    grid with half maps), on K1 and K2 against the twin; atoms of one type
    that differ have no kernel form and run on the card's dense path,
    card against CPU."""
    kw = dict(n_molecules=216, r_cut=0.45, r_switch=0.4, seed=2)
    ts, tx, tb = tmodels.water_system(dtype=F64, device="cpu", **kw)
    types = (np.arange(tx.shape[0]) % 3 != 0).astype(np.int32)
    sig = ts.forces[0].sigma.clone()
    eps = ts.forces[0].epsilon.clone()
    sig[types == 1], eps[types == 1] = 0.1, 0.02
    tf = dataclasses.replace(
        ts.forces[0], lj_type=torch.as_tensor(types), sigma=sig, epsilon=eps,
        pair_a1012=torch.as_tensor(A1012), pair_b1012=torch.as_tensor(B1012))
    spec = tnb.make_neighbor_spec(tb, tx.shape[0], 0.45,
                                  exclusions=tf.exclusions,
                                  occupancy_floor_from=tx, device="cpu")
    assert spec.half_stencil and tf._pair_form().hbond
    _card_vs_twin(tf, spec, tx, tb, cuda, "half_pair")
    _card_vs_twin(tf, dataclasses.replace(spec, half_stencil=False), tx, tb,
                  cuda, "cell_pair")
    mixed_sig = sig.clone()
    mixed_sig[1] = 0.12
    mixed = dataclasses.replace(tf, sigma=mixed_sig)
    with pytest.raises(InputError, match="10-12"):
        mixed._pair_form()
    card = dataclasses.replace(mixed, **{
        k: getattr(mixed, k).to(cuda) for k in (
            "charge", "sigma", "epsilon", "exclusions", "lj_type",
            "pair_a1012", "pair_b1012")})
    e_g, f_g = card.energy_and_forces(tx.to(cuda), tb.to(cuda), {})
    e_c, f_c = mixed.energy_and_forces(tx, tb, {})
    _close(e_g, f_g, float(e_c), f_c.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cutoff", "pme"])
def test_barostat_in_a_sheared_cell_on_card_equals_cpu(cuda, method):
    """6 NPT steps (3 volume moves) card against CPU, float64, the same
    uniforms fed to both: x, v and the box to 1e-9, equal counts."""
    draws = [(-0.6, 0.1), (0.4, 0.2), (-0.2, 0.9)]
    runs = []
    for device in ("cpu", cuda):
        ts, tx, tv, cell = sheared_water(method, device)
        ctx = tamm.Context(ts, _vv_nhc(tamm, ts), tamm.make_state(
            tx, v=tv, box=cell, seed=4))
        it = iter(draws)
        ctx._barostat._uniforms = lambda state, it=it, device=device: tuple(
            torch.tensor(u, dtype=F64, device=device) for u in next(it))
        ctx.step(6)
        runs.append(ctx.state)
    (c, g) = runs
    for key in (tbaro.BARO_NATT, tbaro.BARO_NACC, tbaro.BARO_NBAD):
        assert int(c.extra[key]) == int(g.extra[key]), key
    assert int(g.extra[tbaro.BARO_NATT]) == 3
    for a, b in ((c.x, g.x), (c.v, g.v), (c.box, g.box)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                   atol=TRAJ_TOL * float(a.abs().max()))


def hbond_amber_slice(device, n_res=2):
    """An Amber slice (the peptide-like chain in TIP3P water,
    models.peptide.peptide_in_water, read by amber_system at 0.9 nm,
    reaction field, no NeighborSpec), float64 on `device`, whose
    NonbondedForce gets the LJ types of its (sigma, epsilon) rows, the
    10-12 term between the water oxygen's type and the chain hydrogen's
    (A1012, B1012 of hbond_water's O-H slot) and one chain hydrogen its own
    sigma: atoms of one type differ, no table holds the term."""
    from atomsmm_tpu_torch.models.peptide import peptide_in_water

    prm, crd, _ = peptide_in_water(n_res)
    s, x, box = tamm.amber_system(prm, crd, method="cutoff", r_cut=0.9,
                                  dtype=F64, device=device)
    k = next(i for i, f in enumerate(s.forces)
             if type(f).__name__ == "NonbondedForce")
    nbf = s.forces[k]
    rows = np.stack([nbf.sigma.cpu().numpy(), nbf.epsilon.cpu().numpy()], 1)
    _, types = np.unique(rows, axis=0, return_inverse=True)
    types = types.reshape(-1).astype(np.int32)
    o_type = int(types[int(np.argmax(rows[:, 1]))])
    h_type = int(types[int(np.argmin(np.where(rows[:, 1] > 0, rows[:, 1],
                                              np.inf)))])
    t = int(types.max()) + 1
    a, b = np.zeros((t, t)), np.zeros((t, t))
    for i, j in ((o_type, h_type), (h_type, o_type)):
        a[i, j], b[i, j] = A1012[0, 1], B1012[0, 1]
    sig = nbf.sigma.clone()
    sig[int(np.nonzero(types == h_type)[0][0])] *= 1.1
    nbf = dataclasses.replace(
        nbf, lj_type=torch.as_tensor(types, device=device), sigma=sig,
        pair_a1012=torch.as_tensor(a, device=device),
        pair_b1012=torch.as_tensor(b, device=device))
    return nbf, x, box


@pytest.mark.cuda
def test_hbond_1012_mixed_types_amber_slice_on_card(cuda):
    """The Amber slice's NonbondedForce with the 10-12 term over atoms of
    one type that differ: no kernel form, the dense path on the card,
    card against CPU in float64 (energy 1e-10, forces 1e-9 x max|F|)."""
    out = []
    for device in ("cpu", cuda):
        nbf, x, box = hbond_amber_slice(device)
        assert nbf._dense_only and nbf._table is None
        out.append(nbf.energy_and_forces(x, box, {}))
    (e_c, f_c), (e_g, f_g) = out
    with pytest.raises(InputError, match="10-12"):
        nbf._pair_form()
    _close(e_g, f_g, float(e_c), f_c.numpy())
