"""Hand-derived pair forms of the port's cell-pair kernel against autograd
and against the JAX package.

`atomsmm_tpu_torch.ops.pairfuncs.form_u_dudr2` is the PyTorch twin of the
CUDA kernel's device function: energy u and du/dr² derived by hand for the
built-in forms (switched LJ + reaction field, switched LJ + the Ewald
direct-space Coulomb, the RESPA near form undamped and damped, and the
fused far forms) plus the negated near forms. Each is checked on a grid of
r with random Lorentz-Berthelot parameters against

  * torch autograd (``torch.func.jvp``) of the port's energy function, and
  * ``jax.jvp`` of the JAX package's traced pair function,

all in float64. Tolerance: rtol 1e-10 and atol 1e-10 x max|value| (1e-12
for the damped forms) — both sides evaluate the same closed forms in f64,
so only the operation order differs (a derivation error shows as an O(1)
mismatch).
"""
import numpy as np
import pytest
import torch

from atomsmm_tpu import forces as jforces
from atomsmm_tpu.ops import rv as jrv
from atomsmm_tpu.utils import replace as jreplace
from atomsmm_tpu_torch import forces as tforces
from atomsmm_tpu_torch.ops import pairfuncs as tpf
from atomsmm_tpu_torch.ops import rv as trv
from atomsmm_tpu_torch.utils import replace as treplace

RTOL = 1e-10
DAMPED_RTOL = 1e-12
F64 = torch.float64
ALPHA = 2.92029  # the Ewald alpha of a 0.9 nm cutoff at tolerance 5e-4
UNDAMPED = ["lj_sw_rf", "near", "minus_near", "far"]
DAMPED = ["ewald", "near_damped", "minus_near_damped", "far_pme"]


def _forces(pkg_forces, replace):
    full = pkg_forces.NonbondedForce(r_cut=0.9, r_switch=0.8)
    near = pkg_forces.NearNonbondedForce(r_cut=0.5, r_switch=0.4)
    minus = replace(near, subtract=True)
    ewald = pkg_forces.NonbondedForce(r_cut=0.9, r_switch=0.8, method="pme",
                                      ewald_alpha=ALPHA)
    near_d = replace(near, alpha=ALPHA)
    minus_d = replace(near_d, subtract=True)
    return {
        "lj_sw_rf": full,
        "near": near,
        "minus_near": minus,
        "far": pkg_forces.FarNonbondedForce(full=full, minus_near=minus),
        "ewald": ewald,
        "near_damped": near_d,
        "minus_near_damped": minus_d,
        "far_pme": pkg_forces.FarNonbondedForce(full=ewald,
                                                minus_near=minus_d),
    }


def _samples(seed=11, n=4000):
    rs = np.random.RandomState(seed)
    r = np.linspace(0.2, 0.95, n)
    pi = {"charge": rs.uniform(-1, 1, n), "sigma": rs.uniform(0.25, 0.4, n),
          "epsilon": rs.uniform(0.0, 1.0, n)}
    pj = {"charge": rs.uniform(-1, 1, n), "sigma": rs.uniform(0.25, 0.4, n),
          "epsilon": rs.uniform(0.0, 1.0, n)}
    return r * r, pi, pj


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def _rtol(name):
    return DAMPED_RTOL if name in DAMPED else RTOL


def _hand(form, r2, pi, pj):
    t = {k: torch.as_tensor(v, dtype=F64) for k, v in pi.items()}
    u = {k: torch.as_tensor(v, dtype=F64) for k, v in pj.items()}
    sig, eps = tpf.lorentz_berthelot(t["sigma"], u["sigma"], t["epsilon"],
                                     u["epsilon"])
    return tpf.form_u_dudr2(form, torch.as_tensor(r2, dtype=F64),
                            t["charge"] * u["charge"], sig, eps)


@pytest.mark.parametrize("name", UNDAMPED + DAMPED)
def test_form_matches_torch_autograd(name):
    force = _forces(tforces, treplace)[name]
    r2, pi, pj = _samples()
    u_h, du_h = _hand(force._pair_form(), r2, pi, pj)
    ti = {k: torch.as_tensor(v, dtype=F64) for k, v in pi.items()}
    tj = {k: torch.as_tensor(v, dtype=F64) for k, v in pj.items()}
    u_a, du_a = trv.pair_eval(force._pair_fn(), torch.as_tensor(r2, dtype=F64),
                              ti, tj, True)
    _close(u_h, u_a, _rtol(name))
    _close(du_h, du_a, _rtol(name))


@pytest.mark.parametrize("name", UNDAMPED + DAMPED)
def test_form_matches_jax_jvp(name):
    import jax.numpy as jnp

    tforce = _forces(tforces, treplace)[name]
    jforce = _forces(jforces, jreplace)[name]
    r2, pi, pj = _samples(seed=12)
    u_h, du_h = _hand(tforce._pair_form(), r2, pi, pj)
    ji = {k: jnp.asarray(v) for k, v in pi.items()}
    jj = {k: jnp.asarray(v) for k, v in pj.items()}
    u_j, du_j = jrv.pair_eval(jforce._pair_fn({}), jnp.asarray(r2), ji, jj,
                              True)
    _close(u_h, u_j, _rtol(name))
    _close(du_h, du_j, _rtol(name))


@pytest.mark.parametrize("far,full,near", [("far", "lj_sw_rf", "near"),
                                           ("far_pme", "ewald", "near_damped")])
def test_far_form_is_full_minus_near(far, full, near):
    fs = _forces(tforces, treplace)
    r2, pi, pj = _samples(seed=13)
    u_f, du_f = _hand(fs[far]._pair_form(), r2, pi, pj)
    u_a, du_a = _hand(fs[full]._pair_form(), r2, pi, pj)
    u_n, du_n = _hand(fs[near]._pair_form(), r2, pi, pj)
    _close(u_f, u_a - u_n)
    _close(du_f, du_a - du_n)


@pytest.mark.parametrize("alpha", [0.0, ALPHA])
def test_near_form_vanishes_at_its_cutoff(alpha):
    """The (damped) near force is zero in value and slope at rc_in, from
    inside, for any pair parameters."""
    form = tpf.near_form(0.5, 0.4, alpha=alpha)
    _, pi, pj = _samples(seed=15, n=64)
    for r in (0.5, 0.5 - 1e-9):
        u, du = _hand(form, np.full(64, r * r), pi, pj)
        assert float(u.abs().max()) < 1e-12
        assert float(du.abs().max()) < 1e-10


@pytest.mark.parametrize("fn", ["lj", "coulomb", "reaction_field_coulomb",
                                "near_pair_energy", "switch_quintic",
                                "damped_coulomb", "near_pair_energy_damped"])
def test_energy_functions_match_jax(fn):
    import jax.numpy as jnp

    from atomsmm_tpu.ops import pairfuncs as jpf
    from atomsmm_tpu.ops import switching as jsw
    from atomsmm_tpu_torch.ops import switching as tsw

    r2, pi, pj = _samples(seed=14)
    r = np.sqrt(r2)
    qq = pi["charge"] * pj["charge"]
    args = {
        "lj": (r, pi["sigma"], pi["epsilon"]),
        "coulomb": (r, qq),
        "reaction_field_coulomb": (r, qq, 0.9, 1e15),
        "near_pair_energy": (r, pi["sigma"], pi["epsilon"], qq, 0.0, 0.4, 0.5),
        "switch_quintic": (r, 0.8, 0.9),
        "damped_coulomb": (r, qq, ALPHA),
        "near_pair_energy_damped": (r, pi["sigma"], pi["epsilon"], qq, ALPHA,
                                    0.4, 0.5),
    }[fn]
    fn = fn.replace("_damped", "")

    def conv(a, mod):
        if isinstance(a, np.ndarray):
            return (torch.as_tensor(a, dtype=F64) if mod == "t"
                    else jnp.asarray(a))
        return a

    t_mod = tsw if fn == "switch_quintic" else tpf
    j_mod = jsw if fn == "switch_quintic" else jpf
    got = getattr(t_mod, fn)(*[conv(a, "t") for a in args])
    want = getattr(j_mod, fn)(*[conv(a, "j") for a in args])
    _close(got, want)


def test_damped_near_raises():
    """A damped near force builds; fusing it into a far form whose Ewald
    full force has another alpha raises (the fused form shares one alpha)."""
    near = tforces.NearNonbondedForce(r_cut=0.5, r_switch=0.4, alpha=3.0)
    assert near._pair_form().alpha == 3.0
    ewald = tpf.lj_sw_ewald_form(0.9, 0.8, ALPHA)
    with pytest.raises(ValueError, match="alpha"):
        tpf.far_form(ewald, tpf.near_form(0.5, 0.4, alpha=3.0, subtract=True))
    with pytest.raises(ValueError, match="alpha"):
        tpf.far_form(ewald, tpf.near_form(0.5, 0.4, subtract=True))


def test_kernel_scalar_block_layout():
    """The scalar block handed to the CUDA kernel, in its documented order."""
    fs = _forces(tforces, treplace)
    far = fs["far"]._pair_form()
    k_rf, c_rf = tpf.reaction_field_constants(0.9, 1e15)
    assert far.scalars() == [0.8, 1.0 / (0.9 - 0.8), k_rf, c_rf, 0.4,
                             1.0 / (0.5 - 0.4), 0.5, 1.0 / 0.5, -1.0, 0.0,
                             1.0 / 0.5, -1.0 / 0.5 ** 2, 1.0]
    assert far.flags() == [1, 1, 1, 0, 0, 0, 0, 0]
    assert far.kind == tpf.FAR and far.r_cut == 0.9
    pme = fs["far_pme"]._pair_form()
    ec, dec = tpf.coulomb_kernel_at(0.5, ALPHA)
    assert pme.scalars() == [0.8, 1.0 / (0.9 - 0.8), 0.0, 0.0, 0.4,
                             1.0 / (0.5 - 0.4), 0.5, 1.0 / 0.5, -1.0, ALPHA,
                             ec, dec, 1.0]
    assert pme.flags() == [1, 1, 1, 1, 0, 0, 0, 0]
    assert pme.kind == tpf.FAR and pme.r_cut == 0.9
    # the softcore forms: lambda, no charge kernel; the
    # damped-smoothed form: the full half with the switch on the Coulomb
    soft = tpf.softcore_form(0.75, 0.65, 0.3, dlambda=True)
    assert soft.scalars() == [0.65, 1.0 / (0.75 - 0.65)] + [0.0] * 6 \
        + [1.0, 0.0, 0.0, 0.0, 0.3]
    assert soft.flags() == [0, 1, 0, 0, 1, 1, 0, 0]
    assert soft.kind == tpf.SOFTCORE and soft.alpha == 0.0
    ds = tpf.damped_smoothed_form(0.9, 0.8, ALPHA)
    assert ds.flags() == [1, 1, 0, 1, 0, 0, 1, 0] and ds.alpha == ALPHA
    # the virial flag: the last one, the scalars unchanged
    vir = tpf.virial_form(far)
    assert vir.flags() == far.flags()[:-1] + [1]
    assert vir.scalars() == far.scalars()
