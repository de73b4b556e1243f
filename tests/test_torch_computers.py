"""Virials, pressures and the other computers of the port
(atomsmm_tpu_torch/computers.py) against atomsmm_tpu.computers, float64 on
the CPU, and the pair forms' virial flag against autograd.

The JAX package takes W = -dU(s x, s box)/ds from one jax.grad of its
dense potential; the port sums each force's `virial`: on its cell lists
the pair form's virial flag through the plain twins of K1 and K2 (the code
the card's kernels are held to), autograd of energy(s x, s box) for the
torch-op terms (bonded, exceptions, the PME reciprocal sum and its
corrections, the dispersion tail), and W_mol = W - sum F . (x - com).
Systems: water 216 (reaction field and PME with the dispersion tail, whole
and under RESPASystem, i.e. the fused far form), the emim_bf4_24 ionic
liquid (torsions, 1-4 exceptions, PME) at its minimized state, and phenol
in 60 waters under SolvationSystem at lambda_vdw = lambda_coul = 0.5
(softcore, scaled charges), and 64 waters at 0.55 nm held rigid: TIP4P/Ew
(its M site a virtual site, reaction field and PME), TIP3P on SETTLE and
polarizable SWM4-NDP (Drudes, M sites). Positions are jittered from the
models' lattices (the rigid waters keep their builders' geometry, only the
Drudes move off their cores) and velocities drawn from one numpy seed,
the same numbers in both packages.

Tolerances: rtol 1e-10 with atol 1e-8 (kJ/mol, or bar for the pressures);
the virial form of every built-in PairForm against torch autograd of
U(s x, s box) through the same plain sweep at rtol 1e-10 of sum |w_i|.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import atomsmm_tpu as jamm
import atomsmm_tpu_torch as tamm
from atomsmm_tpu import computers as jcomp
from atomsmm_tpu import models as jmodels
from atomsmm_tpu_torch import computers as tcomp
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.forces import autograd_virial
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pair_kernel as tpk
from atomsmm_tpu_torch.ops import pairfuncs as tpf

F64 = torch.float64
RTOL, ATOL = 1e-10, 1e-8
QUANTITIES = ("atomic_virial", "molecular_virial", "atomic_pressure",
              "molecular_pressure", "molecular_kinetic_energy",
              "coulomb_energy")
CASES = ("water216_rf", "water216_pme", "water216_rf_respa",
         "water216_pme_respa", "emim_bf4_24", "phenol60w_lambda_0.5",
         "tip4pew64_rf", "tip4pew64_pme", "tip3p64_settle", "swm4ndp64")
# the rigid, virtual-site and polarizable waters: 64 molecules at 0.55 nm
SMALL_RIGID = dict(n_molecules=64, r_cut=0.55, r_switch=0.45)
HALF = {"lambda_vdw": 0.5, "lambda_coul": 0.5}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small systems evaluated many times: intra-op threads only contend
    with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _build(case):
    """(JAX system, port system, positions, velocities, box, globals)."""
    if case.startswith("water216"):
        method = "pme" if "pme" in case else "cutoff"
        kw = dict(n_molecules=216, method=method,
                  dispersion_correction=method == "pme")
        js, jx, jb = jmodels.water_system(**kw)
        ts, _, _ = tmodels.water_system(neighbors=True, dtype=F64,
                                        device="cpu", **kw)
        if case.endswith("respa"):
            js = jamm.RESPASystem(js, rcut_in=0.5, rswitch_in=0.4)
            ts = tamm.RESPASystem(ts, rcut_in=0.5, rswitch_in=0.4)
        x, globals = np.asarray(jx), {}
    elif case == "emim_bf4_24":
        kw = dict(n_pairs=24, r_cut=0.65, r_switch=0.55, method="pme")
        js, _, jb = jmodels.ionic_liquid_system(seed=0, **kw)
        ts, _, _ = tmodels.ionic_liquid_system(seed=0, neighbors=True,
                                               dtype=F64, device="cpu", **kw)
        x = np.load(os.path.join(os.path.dirname(__file__), "data",
                                 "emim_bf4_24_minimized.npz"))["x"]
        globals = {}
    elif case.startswith(("tip4pew64", "tip3p64", "swm4ndp64")):
        # the builders' own geometry (SETTLE triangles, M on its
        # placement), only the Drudes moved off their cores
        builder, kw = {
            "tip4pew64": ("tip4p_water_system", {}),
            "tip3p64": ("rigid_water_system", {}),
            "swm4ndp64": ("swm4_water_system", {}),
        }[case.split("_")[0]]
        kw.update(SMALL_RIGID, method="pme" if "pme" in case else "cutoff")
        js, jx, jb = getattr(jmodels, builder)(**kw)
        ts, _, _ = getattr(tmodels, builder)(neighbors=True, dtype=F64,
                                             device="cpu", **kw)
        rs = np.random.RandomState(17)
        x = np.array(jx)
        if case == "swm4ndp64":
            x[1::5] += rs.normal(scale=0.004, size=x[1::5].shape)
        m = np.asarray(js.masses)
        safe = np.where(m > 0, m, 1.0)
        v = rs.normal(size=x.shape) * np.where(
            m > 0, np.sqrt(tamm.units.BOLTZMANN * 300.0 / safe), 0.0)[:, None]
        return js, ts, x, v, np.asarray(jb), {}
    else:
        js, jx, jb, jsol = jmodels.phenol_in_water(n_water=60, r_cut=0.5,
                                                   r_switch=0.42, seed=5)
        ts, _, _, tsol = tmodels.phenol_in_water(
            n_water=60, r_cut=0.5, r_switch=0.42, seed=5, neighbors=True,
            dtype=F64, device="cpu")
        js = jamm.SolvationSystem(js, jsol)
        ts = tamm.SolvationSystem(ts, tsol)
        x, globals = np.asarray(jx), HALF
    rs = np.random.RandomState(17)
    x = np.ascontiguousarray(x) + rs.normal(scale=0.004, size=x.shape)
    m = np.asarray(js.masses)
    v = rs.normal(size=x.shape) * np.sqrt(
        tamm.units.BOLTZMANN * 300.0 / m)[:, None]
    return js, ts, x, v, np.asarray(jb), globals


@pytest.fixture(scope="module")
def observables():
    """case -> (JAX observables, port observables), computed once."""
    out = {}
    for case in CASES:
        js, ts, x, v, box, globals = _build(case)
        jstate = jamm.make_state(x, v=v, box=box)
        jv = jcomp.compute_observables_jit(js, jstate, globals)
        tstate = tamm.make_state(torch.as_tensor(x), v=torch.as_tensor(v),
                                 box=torch.as_tensor(box))
        tstate = tstate.with_extra(**tnb.all_neighbor_extras(
            ts, tstate.x, tstate.box))
        tv = tcomp.compute_observables(ts, tstate, globals)
        out[case] = ({k: float(v) for k, v in jv.items()},
                     {k: float(v) for k, v in tv.items()})
    return out


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("case", CASES)
def test_observables_match_jax(observables, case, quantity):
    want, got = (d[quantity] for d in observables[case])
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)


def test_entry_points_and_facade_agree():
    """atomic_virial, molecular_virial, the pressures and PressureComputer
    give compute_observables' numbers."""
    js, ts, x, v, box, globals = _build("water216_rf_respa")
    state = tamm.make_state(torch.as_tensor(x), v=torch.as_tensor(v),
                            box=torch.as_tensor(box))
    state = state.with_extra(**tnb.all_neighbor_extras(ts, state.x,
                                                       state.box))
    aux = tnb.make_aux(ts, state.extra)
    obs = tcomp.compute_observables(ts, state, globals)
    pc = tamm.PressureComputer(ts, globals).import_configuration(state)
    bar = tamm.units.PRESSURE_IN_BAR
    pairs = [
        (tcomp.atomic_virial(ts, state.x, state.box, globals, aux),
         obs["atomic_virial"], pc.get_atomic_virial()),
        (tcomp.molecular_virial(ts, state.x, state.box, globals, aux),
         obs["molecular_virial"], pc.get_molecular_virial()),
        (tcomp.atomic_pressure(ts, state, globals, aux) * bar,
         obs["atomic_pressure"], pc.get_atomic_pressure()),
        (tcomp.molecular_pressure(ts, state, globals, aux) * bar,
         obs["molecular_pressure"], pc.get_molecular_pressure()),
        (tcomp.molecular_kinetic_energy(ts, state.v),
         obs["molecular_kinetic_energy"], pc.get_molecular_kinetic_energy()),
    ]
    for direct, joint, facade in pairs:
        assert float(direct) == pytest.approx(float(joint), rel=1e-12)
        assert facade == pytest.approx(float(joint), rel=1e-12)


def _forms():
    """name -> (force, its pair form, globals) on water 216 at 0.5 nm (a
    3^3 grid) or, for the softcore and damped-smoothed forms, phenol in 200
    waters (also 3^3)."""
    s, x, box = tmodels.water_system(n_molecules=216, r_cut=0.5,
                                     r_switch=0.4, neighbors=True, dtype=F64,
                                     device="cpu")
    sp, _, _ = tmodels.water_system(n_molecules=216, r_cut=0.5, r_switch=0.4,
                                    method="pme", neighbors=True, dtype=F64,
                                    device="cpu")
    r = tamm.RESPASystem(s, rcut_in=0.35, rswitch_in=0.3)
    rp = tamm.RESPASystem(sp, rcut_in=0.35, rswitch_in=0.3)
    ph, xp, bp, sol = tmodels.phenol_in_water(n_water=200, r_cut=0.5,
                                              r_switch=0.42, seed=5,
                                              neighbors=True, dtype=F64,
                                              device="cpu")
    soft, = (f for f in tamm.SolvationSystem(ph, sol).forces
             if isinstance(f, tamm.SoftcoreLennardJonesForce))
    full = ph.forces[0]
    ds = tamm.DampedSmoothedForce(charge=full.charge, sigma=full.sigma,
                                  epsilon=full.epsilon,
                                  exclusions=full.exclusions, r_cut=0.5,
                                  r_switch=0.42, alpha=3.0)
    water = (s.neighbors, x, box)
    phenol = (tnb.retune_spec(ph.neighbors, xp, bp), xp, bp)
    return {
        "lj_sw_rf": (s.forces[0], {}) + water,
        "ewald": (sp.forces[0], {}) + water,
        "near": (r.forces[1], {}) + water,
        "near_damped": (rp.forces[1], {}) + water,
        "far": (r.forces[2], {}) + water,
        "far_pme": (rp.forces[2], {}) + water,
        "softcore": (soft, {"lambda_vdw": 0.5}) + phenol,
        "damped_smoothed": (ds, {}) + phenol,
    }


FORMS = _forms()


@pytest.mark.parametrize("half", [True, False], ids=["K1_twin", "K2_twin"])
@pytest.mark.parametrize("name", sorted(FORMS))
def test_virial_form_matches_autograd(name, half):
    """The virial flag's energy column, summed, against -dU(s x, s box)/ds
    by autograd through the same plain sweep; the forces unchanged."""
    force, globals, spec, x, box = FORMS[name]
    spec = dataclasses.replace(spec, half_stencil=half)
    if half:
        assert spec.nbr_cells_half is not None
    x = x + torch.as_tensor(np.random.RandomState(3).normal(
        scale=0.004, size=tuple(x.shape)))
    bucket, overflow = tnb.build_cell_buckets(spec, x, box)
    assert not bool(overflow)
    form = force._pair_form(globals)
    pp = force._per_particle(globals)
    w, f = tnb.cell_pair_energy_forces(tpf.virial_form(form), x, box, pp,
                                       spec, bucket, form.r_cut)
    _, f_plain = tnb.cell_pair_energy_forces(form, x, box, pp, spec, bucket,
                                             form.r_cut)
    w_ad, f_ad = autograd_virial(lambda xx, bb: tnb.cell_pair_energy(
        form, xx, bb, pp, spec, bucket, form.r_cut), x, box)
    out = (tpk.half_pair_plain if half else tpk.full_pair_plain)(
        x, pp, bucket, spec, box, tpf.virial_form(form), form.r_cut)
    scale = float(out[:, 3].abs().sum())  # sum |w_i| over the atoms
    assert abs(float(w) - float(w_ad)) <= RTOL * scale
    assert torch.equal(f, f_plain)
    assert float((f - f_ad).abs().max()) <= RTOL * float(f_ad.abs().max())


def test_virial_flag_refuses_dlambda():
    with pytest.raises(ValueError, match="virial"):
        tpf.virial_form(tpf.softcore_form(0.5, 0.42, 0.5, dlambda=True))
