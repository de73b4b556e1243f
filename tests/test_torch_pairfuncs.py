"""Hand-derived pair forms of the port's cell-pair kernel against autograd
and against the JAX package.

`atomsmm_tpu_torch.ops.pairfuncs.form_u_dudr2` is the PyTorch twin of the
CUDA kernel's device function: energy u and du/dr² derived by hand for the
three built-in forms (switched LJ + reaction field, the RESPA near form,
and the fused far form) plus the negated near form. Each is checked on a
grid of r with random Lorentz-Berthelot parameters against

  * torch autograd (``torch.func.jvp``) of the port's energy function, and
  * ``jax.jvp`` of the JAX package's traced pair function,

all in float64. Tolerance: rtol 1e-10 and atol 1e-10 x max|value| — both
sides evaluate the same closed forms in f64, so only the operation order
differs (a derivation error shows as an O(1) mismatch).
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
F64 = torch.float64


def _forces(pkg_forces, replace):
    full = pkg_forces.NonbondedForce(r_cut=0.9, r_switch=0.8)
    near = pkg_forces.NearNonbondedForce(r_cut=0.5, r_switch=0.4)
    minus = replace(near, subtract=True)
    return {
        "lj_sw_rf": full,
        "near": near,
        "minus_near": minus,
        "far": pkg_forces.FarNonbondedForce(full=full, minus_near=minus),
    }


def _samples(seed=11, n=4000):
    rs = np.random.RandomState(seed)
    r = np.linspace(0.2, 0.95, n)
    pi = {"charge": rs.uniform(-1, 1, n), "sigma": rs.uniform(0.25, 0.4, n),
          "epsilon": rs.uniform(0.0, 1.0, n)}
    pj = {"charge": rs.uniform(-1, 1, n), "sigma": rs.uniform(0.25, 0.4, n),
          "epsilon": rs.uniform(0.0, 1.0, n)}
    return r * r, pi, pj


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())


def _hand(form, r2, pi, pj):
    t = {k: torch.as_tensor(v, dtype=F64) for k, v in pi.items()}
    u = {k: torch.as_tensor(v, dtype=F64) for k, v in pj.items()}
    sig, eps = tpf.lorentz_berthelot(t["sigma"], u["sigma"], t["epsilon"],
                                     u["epsilon"])
    return tpf.form_u_dudr2(form, torch.as_tensor(r2, dtype=F64),
                            t["charge"] * u["charge"], sig, eps)


@pytest.mark.parametrize("name", ["lj_sw_rf", "near", "minus_near", "far"])
def test_form_matches_torch_autograd(name):
    force = _forces(tforces, treplace)[name]
    r2, pi, pj = _samples()
    u_h, du_h = _hand(force._pair_form(), r2, pi, pj)
    ti = {k: torch.as_tensor(v, dtype=F64) for k, v in pi.items()}
    tj = {k: torch.as_tensor(v, dtype=F64) for k, v in pj.items()}
    u_a, du_a = trv.pair_eval(force._pair_fn(), torch.as_tensor(r2, dtype=F64),
                              ti, tj, True)
    _close(u_h, u_a)
    _close(du_h, du_a)


@pytest.mark.parametrize("name", ["lj_sw_rf", "near", "minus_near", "far"])
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
    _close(u_h, u_j)
    _close(du_h, du_j)


def test_far_form_is_full_minus_near():
    fs = _forces(tforces, treplace)
    r2, pi, pj = _samples(seed=13)
    u_f, du_f = _hand(fs["far"]._pair_form(), r2, pi, pj)
    u_a, du_a = _hand(fs["lj_sw_rf"]._pair_form(), r2, pi, pj)
    u_n, du_n = _hand(fs["near"]._pair_form(), r2, pi, pj)
    _close(u_f, u_a - u_n)
    _close(du_f, du_a - du_n)


@pytest.mark.parametrize("fn", ["lj", "coulomb", "reaction_field_coulomb",
                                "near_pair_energy", "switch_quintic"])
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
    }[fn]

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
    with pytest.raises(NotImplementedError, match="PME"):
        tforces.NearNonbondedForce(r_cut=0.5, r_switch=0.4, alpha=3.0)
    with pytest.raises(NotImplementedError, match="PME"):
        tpf.near_form(0.5, 0.4, alpha=3.0)


def test_kernel_scalar_block_layout():
    """The scalar block handed to the CUDA kernel, in its documented order."""
    far = _forces(tforces, treplace)["far"]._pair_form()
    k_rf, c_rf = tpf.reaction_field_constants(0.9, 1e15)
    assert far.scalars() == [0.8, 1.0 / (0.9 - 0.8), k_rf, c_rf, 0.4,
                             1.0 / (0.5 - 0.4), 0.5, 1.0 / 0.5, -1.0]
    assert far.flags() == [1, 1, 1]
    assert far.kind == tpf.FAR and far.r_cut == 0.9
