"""The alchemical slice of the port (BASELINE config 3, phenol in water)
against the JAX package, float64 on the CPU: the twins of
tests/test_alchemy.py and tests/test_alchemical_respa.py.

The JAX system comes from the JAX phenol_in_water and crosses with
describe_reference -> system_from_numpy; each package then applies its own
SolvationSystem / AlchemicalRespaSystem. The JAX side evaluates on its dense
path, the port on its cell lists through the plain twins of K1 and K2 (the
same code the card's kernels are held to). The JAX solute-solute
CustomNonbondedForce is, in the port, a second NonbondedForce on the pair
kernels (split key NonbondedForce#2). Sizes as in the JAX tests: 150 waters
at 0.65 nm (a 2^3 grid, the full stencil) and 80 waters at 0.55 nm, split
at 0.35 nm (a 2^3 far grid and a 3^3 near grid with half maps).

The JAX references run under jax.jit (one compile per function; the eager
JAX path costs seconds per evaluation at these sizes).

Tolerances: energies, multi-state energies and near + far == full at rtol
1e-10; forces at 1e-10 x max|F|; dU/dlambda at rtol 1e-9 against
jax.grad (the port takes the softcore form's dlambda twin and the exact
quadratic rule in lambda_coul, so only rounding differs); the phenol_200w
golden of tests/test_goldens.py at rtol 1e-8.
"""
import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import alchemy as jalch
from atomsmm_tpu.models import phenol_in_water as jphenol
from atomsmm_tpu_torch import alchemy as talch
from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy
from atomsmm_tpu_torch.models import phenol_in_water as tphenol
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pairfuncs as tpf
from atomsmm_tpu_torch.ops.switching import switch_quintic

F64 = torch.float64
RTOL = 1e-10

GOLDEN = {  # tests/test_goldens.py, "phenol_200w"
    "NonbondedForce": -420.8692995546271,
    "HarmonicBondForce": 0.0,
    "HarmonicAngleForce": 118.16504208779168,
    "PeriodicTorsionForce": 0.0,
    "NonbondedExceptionsForce": -17.514832020821814,
    "Total": -320.21908948765724,
}

# the port's name for each JAX force of a SolvationSystem where they differ
PORT_NAME = {"CustomNonbondedForce": "NonbondedForce#2"}

LAMBDA_GRID = [
    {"lambda_vdw": 1.0, "lambda_coul": 1.0},
    {"lambda_vdw": 0.7, "lambda_coul": 0.4},
    {"lambda_vdw": 0.5, "lambda_coul": 0.0},
    {"lambda_vdw": 0.0, "lambda_coul": 0.0},
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small systems evaluated many times: intra-op threads only contend
    with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _aux(system, x, box):
    return tnb.make_aux(system, tnb.all_neighbor_extras(system, x, box))


def _carry(js):
    return system_from_numpy(describe_reference(js), dtype=F64, device="cpu")


def _jax_refs(system, box):
    """Jitted JAX references for one system: split energies, multi-state
    energies, forces and dU/dlambda (name static), each with the globals
    as a traced dict."""
    import jax

    def ti(name):
        return jax.jit(lambda x, lam, g: jalch.ti_gradient(
            system, x, box, name, lam, g))

    return {
        "split": jax.jit(lambda x, g: dict(jamm.split_potential_energy(
            system, x, box, g))),
        "multistate": jax.jit(lambda x, lams: jalch.multistate_energies(
            system, x, box, lams)),
        "forces": jax.jit(lambda x, g: -jax.grad(
            lambda xx: jamm.potential_energy(system, xx, box, g))(x)),
        "groups": jax.jit(lambda x, g: jamm.group_energies(system, x, box,
                                                           g)),
        "ti": {name: ti(name) for name in ("lambda_vdw", "lambda_coul")},
    }


@pytest.fixture(scope="module")
def solvated():
    """150 waters at 0.65 nm: (the JAX SolvationSystem's jitted
    references, port SolvationSystem on the cell list, JAX x, port x, JAX box, port box, port aux, the carried
    base system)."""
    js, jx, jb, jsol = jphenol(n_water=150, r_cut=0.65, r_switch=0.55,
                               seed=3, neighbors=True)
    ts = _carry(js)
    tx, tb = torch.as_tensor(np.asarray(jx)), torch.as_tensor(np.asarray(jb))
    jsv = jamm.SolvationSystem(js, jsol)
    tsv = tamm.SolvationSystem(ts, torch.as_tensor(np.asarray(jsol)))
    return _jax_refs(jsv, jb), tsv, jx, tx, jb, tb, _aux(tsv, tx, tb), ts


@pytest.fixture(scope="module")
def respa():
    """80 waters at 0.55 nm split at 0.35 nm: (the JAX SolvationSystem's
    jitted references, the JAX AlchemicalRespaSystem's, port
    SolvationSystem, port AlchemicalRespaSystem, JAX x, port x, JAX box,
    port box), and the two JAX systems' force lists."""
    js, jx, jb, jsol = jphenol(n_water=80, r_cut=0.55, r_switch=0.47, seed=3,
                               neighbors=True)
    ts = _carry(js)
    sol = torch.as_tensor(np.asarray(jsol))
    jbase = js.with_neighbors(None)
    jsv = jamm.SolvationSystem(jbase, jsol)
    jars = jamm.AlchemicalRespaSystem(jbase, rcut_in=0.35, rswitch_in=0.3,
                                      solute_atoms=jsol)
    tsv = tamm.SolvationSystem(ts, sol)
    tars = tamm.AlchemicalRespaSystem(ts, rcut_in=0.35, rswitch_in=0.3,
                                      solute_atoms=sol)
    tx, tb = torch.as_tensor(np.asarray(jx)), torch.as_tensor(np.asarray(jb))
    return (_jax_refs(jsv, jb), _jax_refs(jars, jb), tsv, tars, jx, tx, jb,
            tb, [(type(f).__name__, f.group) for f in jars.forces])


def test_builder_matches_jax_builder():
    js, jx, jb, jsol = jphenol(n_water=60, r_cut=0.5, r_switch=0.42, seed=5,
                               method="pme")
    ts, tx, tb, tsol = tphenol(n_water=60, r_cut=0.5, r_switch=0.42, seed=5,
                               method="pme", dtype=F64, device="cpu")
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tsol.numpy(), np.asarray(jsol))
    assert np.array_equal(ts.masses.numpy(), np.asarray(js.masses))
    assert np.array_equal(ts.molecule.numpy(), np.asarray(js.molecule))
    assert ts.num_molecules == js.num_molecules
    assert [f.name for f in ts.forces] == [f.name for f in js.forces]
    for tf, jf in zip(ts.forces, js.forces):
        for name in ("charge", "sigma", "epsilon", "exclusions", "idx", "r0",
                     "k", "theta0", "periodicity", "phase", "pairs",
                     "chargeprod"):
            if getattr(tf, name, None) is not None:
                assert np.array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name))), \
                    (tf.name, name)
    nb = ts.forces[0]
    assert (nb.ewald_alpha, tuple(nb.grid_shape), nb.spline_order) == (
        js.forces[0].ewald_alpha, tuple(js.forces[0].grid_shape),
        js.forces[0].spline_order)
    # the solute's pairs within three bonds lie 12 indices apart at most:
    # the exclusion bitmask of the cell kernels holds them
    spec = tnb.make_neighbor_spec(tb, ts.num_particles, 0.5,
                                  exclusions=nb.exclusions, device="cpu")
    assert spec.excbits is not None


@pytest.mark.parametrize("term", sorted(GOLDEN))
def test_golden_phenol_200w(term):
    system, x, box, _ = tphenol(n_water=200, seed=5, dtype=F64, device="cpu")
    split = tamm.split_potential_energy(system, x, box, {})
    assert set(split) == set(GOLDEN)
    if GOLDEN[term] == 0.0:
        assert abs(float(split[term])) < 1e-10
    else:
        assert float(split[term]) == pytest.approx(GOLDEN[term], rel=1e-8)


@pytest.mark.parametrize("lams", LAMBDA_GRID)
def test_solvation_split_matches_jax(solvated, lams):
    """Every force of the SolvationSystem, the port's cell path against the
    JAX dense path."""
    ref, tsv, jx, tx, jb, tb, aux, _ = solvated
    je = ref["split"](jx, lams)
    te = tamm.split_potential_energy(tsv, tx, tb, lams, aux)
    assert sorted(te) == sorted(PORT_NAME.get(k, k) for k in je)
    scale = max(abs(float(v)) for v in je.values())
    for k in je:
        np.testing.assert_allclose(float(te[PORT_NAME.get(k, k)]),
                                   float(je[k]), rtol=RTOL, atol=RTOL * scale)


def test_lambda_one_reproduces_original(solvated):
    _, tsv, _, tx, _, tb, aux, base = solvated
    e0 = float(tamm.potential_energy(base, tx, tb, {},
                                     aux=_aux(base, tx, tb)))
    e1 = float(tamm.potential_energy(tsv, tx, tb, LAMBDA_GRID[0], aux=aux))
    np.testing.assert_allclose(e1, e0, rtol=RTOL)


def test_lambda_zero_decouples(solvated):
    """At lambda_vdw = lambda_coul = 0 moving the solute rigidly does not
    change the energy (the solute no longer meets the solvent)."""
    _, tsv, _, tx, _, tb, aux, _ = solvated
    lam = LAMBDA_GRID[-1]
    e_a = float(tamm.potential_energy(tsv, tx, tb, lam, aux=aux))
    x_b = tx.clone()
    x_b[:13] += torch.tensor([0.31, 0.17, 0.23], dtype=F64)
    e_b = float(tamm.potential_energy(tsv, x_b, tb, lam,
                                      aux=_aux(tsv, x_b, tb)))
    np.testing.assert_allclose(e_a, e_b, rtol=1e-9)


def test_intramolecular_terms_lambda_independent(solvated):
    _, tsv, _, tx, _, tb, aux, _ = solvated
    names = ("HarmonicBondForce", "HarmonicAngleForce", "PeriodicTorsionForce",
             "NonbondedExceptionsForce", "NonbondedForce#2")
    s1 = tamm.split_potential_energy(tsv, tx, tb, LAMBDA_GRID[0], aux)
    s0 = tamm.split_potential_energy(tsv, tx, tb, {"lambda_vdw": 0.2,
                                                   "lambda_coul": 0.5}, aux)
    for k in names:
        np.testing.assert_allclose(float(s1[k]), float(s0[k]), rtol=1e-12)


def test_multistate_matches_loop_and_jax_vmap(solvated):
    ref, tsv, jx, tx, jb, tb, aux, _ = solvated
    lams = {"lambda_vdw": [0.0, 0.3, 0.7, 1.0],
            "lambda_coul": [0.0, 0.0, 0.5, 1.0]}
    es = talch.multistate_energies(tsv, tx, tb,
                                   {k: torch.tensor(v, dtype=F64)
                                    for k, v in lams.items()})
    loop = [float(tamm.potential_energy(
        tsv, tx, tb, {k: v[i] for k, v in lams.items()}, aux=aux))
        for i in range(4)]
    _close(es, loop)
    jes = ref["multistate"](jx, {k: np.asarray(v) for k, v in lams.items()})
    _close(es, np.asarray(jes))


@pytest.mark.parametrize("name,value,others", [
    ("lambda_vdw", 0.5, {"lambda_coul": 1.0}),
    ("lambda_vdw", 0.05, {"lambda_coul": 0.0}),
    ("lambda_coul", 0.3, {"lambda_vdw": 1.0}),
])
def test_ti_gradient_matches_jax_grad(solvated, name, value, others):
    ref, tsv, jx, tx, jb, tb, aux, _ = solvated
    g_j = float(ref["ti"][name](jx, value, others))
    g_t = float(talch.ti_gradient(tsv, tx, tb, name, value, others, aux))
    np.testing.assert_allclose(g_t, g_j, rtol=1e-9)
    if value == 0.5:  # the dense path (autograd of the pair function) too
        g_d = float(talch.ti_gradient(tsv.with_neighbors(None), tx, tb, name,
                                      value, others))
        np.testing.assert_allclose(g_d, g_j, rtol=1e-9)


def test_mbar_recovers_harmonic_free_energies():
    """K Gaussian states of force constants k: f_k - f_0 = ln(k_k/k_0)/2."""
    rs = np.random.RandomState(7)
    kvals = np.array([1.0, 2.0, 4.0, 8.0])
    n_per = 4000
    xs = np.concatenate([rs.normal(0, 1.0 / np.sqrt(k), n_per) for k in kvals])
    u_kn = 0.5 * kvals[:, None] * xs[None, :] ** 2
    f = talch.mbar_free_energies(torch.as_tensor(u_kn), [n_per] * 4,
                                 n_iter=500)
    np.testing.assert_allclose(f.numpy(), 0.5 * np.log(kvals / kvals[0]),
                               atol=0.03)
    f_j = jalch.mbar_free_energies(u_kn, np.full(4, n_per), n_iter=500)
    _close(f, np.asarray(f_j), 1e-10)
    w = talch.mbar_overlap_weights(torch.as_tensor(u_kn), [n_per] * 4, f)
    w_j = jalch.mbar_overlap_weights(u_kn, np.full(4, n_per), f_j)
    _close(w, np.asarray(w_j), 1e-9)


def test_overflowing_configuration_is_retuned_not_dropped(solvated):
    """A configuration whose cells overflow the system's capacity: the
    alchemy functions retune the specs for it instead of dropping atoms."""
    import dataclasses

    _, tsv, _, tx, _, tb, aux, _ = solvated
    tight = tsv.with_neighbors(dataclasses.replace(tsv.neighbors,
                                                   cell_capacity=16))
    lams = {"lambda_vdw": [0.3, 1.0], "lambda_coul": [0.6, 1.0]}
    _close(talch.multistate_energies(tight, tx, tb, lams),
           talch.multistate_energies(tsv, tx, tb, lams, aux).numpy())
    _close(talch.ti_gradient(tight, tx, tb, "lambda_vdw", 0.3),
           float(talch.ti_gradient(tsv, tx, tb, "lambda_vdw", 0.3, None,
                                   aux)))


def test_reduced_energy_matrix_matches_jax(solvated):
    ref, tsv, jx, tx, jb, tb, _, _ = solvated
    shifts = (0.0, 0.001, -0.001)
    lams = {"lambda_vdw": [0.0, 0.5, 1.0], "lambda_coul": [0.0, 0.5, 1.0]}
    u = talch.reduced_energy_matrix(
        tsv, torch.stack([tx + s for s in shifts]), tb, lams, 300.0)
    beta = 1.0 / (tamm.units.BOLTZMANN * 300.0)
    u_j = np.stack([beta * np.asarray(ref["multistate"](
        np.asarray(jx) + s, {k: np.asarray(v) for k, v in lams.items()}))
        for s in shifts], axis=1)
    assert tuple(u.shape) == (3, 3)
    _close(u, u_j)


def test_coupling_path_matches_jax():
    s = np.linspace(0.0, 1.0, 7)
    got, want = talch.coupling_path(s), jalch.coupling_path(s)
    for k in want:
        _close(got[k], np.asarray(want[k]), 0.0)


def test_softcore_placed_in_near_group(respa):
    tars, jax_groups = respa[3], respa[8]
    soft = [f for f in tars.forces
            if isinstance(f, tamm.SoftcoreLennardJonesForce)]
    assert len(soft) == 1 and soft[0].group == 1
    assert any(isinstance(f, tamm.NearNonbondedForce) and not f.subtract
               for f in tars.forces)
    far, = (f for f in tars.forces if isinstance(f, tamm.FarNonbondedForce))
    # the full half keeps the charge-scale mask; the near halves take the
    # raw charges, so the far force cannot be fused
    assert far.full.charge_scale_mask is not None and not far._fusable()
    assert [(type(f).__name__, f.group) for f in tars.forces] == [
        (PORT_NAME.get(name, name).split("#")[0], grp)
        for name, grp in jax_groups]


@pytest.mark.parametrize("lams", LAMBDA_GRID)
def test_split_identity_under_lambda(respa, lams):
    """near + far + softcore + solute-solute == the SolvationSystem total at
    every coupling, on both packages."""
    _, jars, tsv, tars, jx, tx, jb, tb, _ = respa
    e_solv = float(tamm.potential_energy(tsv, tx, tb, lams,
                                         aux=_aux(tsv, tx, tb)))
    e_ars = float(tamm.potential_energy(tars, tx, tb, lams,
                                        aux=_aux(tars, tx, tb)))
    np.testing.assert_allclose(e_ars, e_solv, rtol=RTOL)
    np.testing.assert_allclose(e_ars, float(jars["split"](jx, lams)["Total"]),
                               rtol=RTOL)


def test_forces_identity_under_lambda(respa):
    jsv, _, tsv, tars, jx, tx, _, tb, _ = respa
    lams = LAMBDA_GRID[1]
    e_s, f_s = tamm.force_fn(tsv)(tx, tb, lams, _aux(tsv, tx, tb))
    e_a, f_a = tamm.force_fn(tars)(tx, tb, lams, _aux(tars, tx, tb))
    np.testing.assert_allclose(float(e_a), float(e_s), rtol=RTOL)
    _close(f_a, f_s.numpy())
    # and against the JAX package's autograd forces of its SolvationSystem
    _close(f_a, np.asarray(jsv["forces"](jx, lams)))


def test_lambda_moves_only_the_groups_it_moves_in_jax(respa):
    _, jars, _, tars, jx, tx, jb, tb, _ = respa
    aux = _aux(tars, tx, tb)
    for lam in ({"lambda_vdw": 0.3, "lambda_coul": 1.0},
                {"lambda_vdw": 1.0, "lambda_coul": 0.3}):
        g_hi = tamm.group_energies(tars, tx, tb, LAMBDA_GRID[0], aux)
        g_lo = tamm.group_energies(tars, tx, tb, lam, aux)
        j_hi = jars["groups"](jx, LAMBDA_GRID[0])
        j_lo = jars["groups"](jx, lam)
        for grp in (0, 1, 2):
            moved_t = abs(float(g_hi[grp] - g_lo[grp]))
            moved_j = abs(float(j_hi[grp] - j_lo[grp]))
            assert (moved_t > 1e-6) == (moved_j > 1e-6), (lam, grp)
            np.testing.assert_allclose(float(g_lo[grp]), float(j_lo[grp]),
                                       rtol=RTOL, atol=1e-9)


def test_pme_charge_scaling_through_the_split():
    """Under PME the charge scaling reaches the corrections and the
    reciprocal sum, in the full force, the unfused far force and the
    separate reciprocal level: near + far + reciprocal == full, energies
    and forces, and dU/dlambda_coul against jax.grad."""
    js, jx, jb, jsol = jphenol(n_water=60, r_cut=0.5, r_switch=0.42, seed=5,
                               method="pme", neighbors=True)
    ts = _carry(js)
    sol = torch.as_tensor(np.asarray(jsol))
    tx, tb = torch.as_tensor(np.asarray(jx)), torch.as_tensor(np.asarray(jb))
    tsv = tamm.SolvationSystem(ts, sol)
    tr = tamm.RESPASystem(tsv, 0.3, 0.25, reciprocal_level=True)
    recip, = (f for f in tr.forces if isinstance(f, tamm.PMEReciprocalForce))
    assert recip.charge_scale_mask is not None
    lams = {"lambda_vdw": 0.6, "lambda_coul": 0.35}
    e_s, f_s = tamm.force_fn(tsv)(tx, tb, lams, _aux(tsv, tx, tb))
    e_r, f_r = tamm.force_fn(tr)(tx, tb, lams, _aux(tr, tx, tb))
    np.testing.assert_allclose(float(e_r), float(e_s), rtol=RTOL)
    _close(f_r, f_s.numpy())
    ref = _jax_refs(jamm.SolvationSystem(js, jsol), jb)
    np.testing.assert_allclose(float(e_s), float(ref["split"](jx, lams)[
        "Total"]), rtol=RTOL)
    g_j = float(ref["ti"]["lambda_coul"](jx, 0.35, {"lambda_vdw": 0.6}))
    for system in (tsv, tr):
        g_t = float(talch.ti_gradient(system, tx, tb, "lambda_coul", 0.35,
                                      {"lambda_vdw": 0.6}))
        np.testing.assert_allclose(g_t, g_j, rtol=1e-9)


def test_solute_solute_term_matches_jax_custom_force():
    """The port's solute-solute term (a NonbondedForce with zero charges and
    the solute's epsilon alone, on the pair kernels' cell path) against the
    JAX package's solute-solute CustomNonbondedForce, energies and forces;
    its dU/dlambda is zero for both names."""
    import jax

    js, jx, jb, jsol = jphenol(n_water=60, r_cut=0.5, r_switch=0.42, seed=5,
                               neighbors=True)
    jf = jamm.SolvationSystem(js, jsol).forces[-1]
    assert isinstance(jf, jamm.CustomNonbondedForce)
    tsv = tamm.SolvationSystem(_carry(js), torch.as_tensor(np.asarray(jsol)))
    tf = tsv.forces[-1]
    assert type(tf) is tamm.NonbondedForce and tf.method == "cutoff"
    assert not bool(tf.charge.any()) and tf.charge_scale_mask is None
    ts = tsv.replace_forces([tf])
    tx, tb = torch.as_tensor(np.asarray(jx)), torch.as_tensor(np.asarray(jb))
    aux = _aux(ts, tx, tb)
    e_t, f_t = tamm.force_fn(ts)(tx, tb, {}, aux)
    e_j, g_j = jax.jit(jax.value_and_grad(
        lambda xx: jf.energy(xx, jb, {})))(jx)
    assert abs(float(e_j)) > 1.0
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)
    _close(f_t, -np.asarray(g_j))
    for name in ("lambda_vdw", "lambda_coul"):
        assert float(tf.denergy_dlambda(tx, tb, {name: 0.4}, name, aux)) == 0.0


def test_softcore_forms_match_autograd():
    """softcore_form's (u, du/dr²) and its dlambda twin against autograd of
    softcore_lj x S(r) x the cross mask, float64, at lambda 0, 0.05, 0.5, 1."""
    g = torch.Generator().manual_seed(4)
    n = 3000
    r = 0.05 + 0.7 * torch.rand(n, generator=g, dtype=F64)
    sig = 0.1 + 0.3 * torch.rand(n, generator=g, dtype=F64)
    eps = torch.rand(n, generator=g, dtype=F64)
    s_i, s_j = (torch.randint(0, 2, (n,), generator=g).to(F64)
                for _ in range(2))
    qq = (2 * s_i - 1) * (2 * s_j - 1)
    cross = s_i + s_j - 2 * s_i * s_j

    def ref(r2, lam):
        rr = torch.sqrt(r2)
        return tpf.softcore_lj(rr, sig, eps, lam) \
            * switch_quintic(rr, 0.65, 0.75) * cross

    r2 = r * r
    for lam in (0.0, 0.05, 0.5, 1.0):
        lt = torch.tensor(lam, dtype=F64)
        u_ref, d_r2 = torch.func.jvp(lambda q: ref(q, lt), (r2,),
                                     (torch.ones_like(r2),))
        _, d_lam = torch.func.jvp(lambda lm: ref(r2, lm), (lt,),
                                  (torch.ones_like(lt),))
        u, du = tpf.form_u_dudr2(tpf.softcore_form(0.75, 0.65, lam),
                                 r2, qq, sig, eps)
        ul, dul = tpf.form_u_dudr2(tpf.softcore_form(0.75, 0.65, lam,
                                                     dlambda=True),
                                   r2, qq, sig, eps)
        _close(u, u_ref.numpy())
        _close(du, d_r2.numpy())
        _close(ul, d_lam.numpy())
        assert float(dul.abs().max()) == 0.0


def test_damped_smoothed_force_matches_jax():
    """DampedSmoothedForce (the damped form smoothed by the switch) on the
    cell list against the JAX dense path, energies and forces."""
    import jax

    js, jx, jb, _ = jphenol(n_water=60, r_cut=0.5, r_switch=0.42, seed=5,
                            neighbors=True)
    nb = js.forces[0]
    jf = jamm.DampedSmoothedForce(charge=nb.charge, sigma=nb.sigma,
                                  epsilon=nb.epsilon,
                                  exclusions=nb.exclusions, r_cut=0.5,
                                  r_switch=0.42, alpha=3.1)
    tf = system_from_numpy(describe_reference(jf), dtype=F64, device="cpu")
    assert isinstance(tf, tamm.DampedSmoothedForce) and tf.alpha == 3.1
    ts = _carry(js)
    ts = ts.replace_forces([tf])
    tx, tb = torch.as_tensor(np.asarray(jx)), torch.as_tensor(np.asarray(jb))
    e_t, f_t = tamm.force_fn(ts)(tx, tb, {}, _aux(ts, tx, tb))
    e_j, g_j = jax.jit(jax.value_and_grad(
        lambda xx: jf.energy(xx, jb, {})))(jx)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)
    _close(f_t, -np.asarray(g_j))


def test_softcore_refuses_a_non_indicator():
    ones = torch.ones(3, dtype=F64)
    with pytest.raises(ValueError, match="only 0 and 1"):
        tamm.SoftcoreLennardJonesForce(sigma=ones, epsilon=ones,
                                       solute=torch.tensor([0.0, 0.5, 1.0],
                                                           dtype=F64))
    f = tamm.SoftcoreLennardJonesForce(sigma=ones, epsilon=ones,
                                       solute=torch.tensor([0.0, 1.0, 1.0],
                                                           dtype=F64))
    assert f._per_particle()["charge"].tolist() == [-1.0, 1.0, 1.0]


def test_interop_carries_the_alchemical_fields():
    """A JAX system whose forces carry a charge-scale mask and a softcore
    force crosses; one holding a Python function (the solute-solute
    CustomNonbondedForce) raises and says what to do instead."""
    import jax

    js, jx, jb, jsol = jphenol(n_water=60, r_cut=0.5, r_switch=0.42, seed=5,
                               neighbors=True)
    jsv = jamm.SolvationSystem(js, jsol)
    keep = jsv.replace_forces([f for f in jsv.forces
                               if not isinstance(f, jamm.CustomNonbondedForce)])
    carried = _carry(keep)
    assert [type(f).__name__ for f in carried.forces] == \
        [type(f).__name__ for f in keep.forces]
    nb = carried.forces[0]
    assert nb.charge_scale_name == "lambda_coul"
    assert np.array_equal(nb.charge_scale_mask.numpy(),
                          np.asarray(jsv.forces[0].charge_scale_mask))
    lams = LAMBDA_GRID[1]
    tx, tb = torch.as_tensor(np.asarray(jx)), torch.as_tensor(np.asarray(jb))
    e_j = jax.jit(lambda x, g: jamm.potential_energy(keep, x, jb, g))(jx, lams)
    _close(tamm.potential_energy(carried, tx, tb, lams,
                                 aux=_aux(carried, tx, tb)), float(e_j))
    with pytest.raises(TypeError, match="own SolvationSystem"):
        describe_reference(jsv)


def test_custom_bond_force_matches_jax():
    """CustomBondForce over an explicit pair list: energies and autograd
    forces against the JAX package."""
    import jax

    rs = np.random.RandomState(1)
    x = rs.uniform(0, 2.0, (12, 3))
    box = np.full(3, 2.0)
    pairs = np.array([[0, 1], [2, 5], [3, 11], [7, 8]], np.int32)
    k = rs.uniform(100, 200, 4)

    def fn(r, p, g):
        return 0.5 * p["k"] * (r - 0.3 * g.get("scale", 1.0)) ** 2

    jf = jamm.CustomBondForce(pairs=pairs, per_bond={"k": k},
                              valid=np.ones(4, bool), energy_function=fn)
    tf = tamm.CustomBondForce(pairs=torch.as_tensor(pairs),
                              per_bond={"k": torch.as_tensor(k)},
                              valid=torch.ones(4, dtype=torch.bool),
                              energy_function=fn)
    e_j, g_j = jax.value_and_grad(
        lambda xx: jf.energy(xx, box, {"scale": 1.2}))(x)
    ts = tamm.System(masses=torch.ones(12, dtype=F64), forces=(tf,))
    e_t, f_t = tamm.force_fn(ts)(torch.as_tensor(x), torch.as_tensor(box),
                                 {"scale": 1.2})
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)
    _close(f_t, -np.asarray(g_j))
    # d/dscale by the default autograd rule
    d = tf.denergy_dlambda(torch.as_tensor(x), torch.as_tensor(box),
                           {"scale": 1.2}, "scale")
    d_j = jax.grad(lambda s: jf.energy(x, box, {"scale": s}))(1.2)
    np.testing.assert_allclose(float(d), float(d_j), rtol=1e-9)


def test_hrex_is_not_ported(solvated):
    """Replica exchange on one card is ported (tests/test_torch_hrex.py);
    its device mesh is not, and raises naming the item."""
    _, tsv, _, tx, _, tb, _, _ = solvated
    with pytest.raises(NotImplementedError, match="ROADMAP item 14b"):
        talch.solvation_free_energy(tsv, tx, tb, [0.0, 1.0], 300.0,
                                    hrex=True, mesh=object())


@pytest.mark.slow
def test_end_to_end_delta_g_mbar_vs_ti():
    """NVT sampling per lambda state, the reduced-energy matrix, MBAR, and
    TI on the same samples (tests/test_alchemy.py's end-to-end case)."""
    system, x, box, solute = tphenol(n_water=60, r_cut=0.5, r_switch=0.42,
                                     seed=5, dtype=F64, device="cpu",
                                     neighbors=True)
    solv = tamm.SolvationSystem(system, solute_atoms=solute)
    out = talch.solvation_free_energy(
        solv, x, box, torch.linspace(0.0, 1.0, 13, dtype=F64),
        temperature=300.0, dt=0.001, n_equil=150, n_samples=32,
        sample_interval=20, seed=4)
    dg_m, dg_t = out["dg_mbar"], out["dg_ti"]
    assert np.isfinite(dg_m) and np.isfinite(dg_t)
    assert -250.0 < dg_m < 0.0
    joint = np.hypot(out["err_mbar"], out["err_ti"])
    assert abs(dg_m - dg_t) < 3.0 * joint + 0.15 * abs(dg_m)


@pytest.mark.slow
def test_mts_integration_stable_at_partial_coupling(respa):
    """A short MTS run of the AlchemicalRespaSystem at lambda_vdw = 0.5,
    lambda_coul = 0.25 stays finite and holds its temperature."""
    tars, tx, tb = respa[3], respa[5], respa[7]
    dof = 3 * tars.num_particles - 3
    integ = tamm.MultipleTimeScaleIntegrator(
        0.002, [2, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=dof)
    ctx = tamm.Context(tars, integ, tamm.make_state(tx, box=tb, seed=2))
    ctx.set_velocities_to_temperature(300.0, seed=3)
    ctx.set_parameter("lambda_vdw", 0.5)
    ctx.set_parameter("lambda_coul", 0.25)
    for _ in range(4):
        ctx.step(50)
        t_now = float(ctx.temperature())
        ctx.set_velocities((300.0 / t_now) ** 0.5 * ctx.state.v)
    ctx.step(100)
    assert np.isfinite(float(ctx.get_state().potential_energy))
    assert 150.0 < float(ctx.temperature()) < 550.0
