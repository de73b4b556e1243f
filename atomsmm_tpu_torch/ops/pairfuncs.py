"""Pairwise energy expressions (counterpart of atomsmm_tpu/ops/pairfuncs.py).

Two families live here:

* energy functions of r (``lj``, ``coulomb``, ``reaction_field_coulomb``,
  ``near_pair_energy``) with Lorentz-Berthelot combining. The dense O(N²)
  oracle evaluates them and takes forces by autograd.
* the three built-in pair *forms* of the pair kernels, with energy and
  du/dr² derived by hand (``PairForm`` and ``form_u_dudr2``). A hand kernel
  cannot trace a Python pair function the way Pallas did, so the CUDA
  kernels (csrc/pair_forms.cuh) take a form and a few host-computed scalars;
  ``form_u_dudr2`` is its line-for-line PyTorch transcription, so that a
  derivation error shows in the CPU tests against the JAX package.

Forms (Lorentz-Berthelot combining, k = ONE_4PI_EPS0):

* ``LJ_SW_RF``: LJ(r) S(r; rs, rc) + k qq (1/r + k_rf r² - c_rf)
  (NonbondedForce, method 'cutoff');
* ``NEAR``: [base(r) - base(rc) - base'(rc)(r - rc)] S(r; rs_in, rc_in), with
  base(r) = 4 eps [(s/r)^12 - (s/r)^6] + k qq / r (NearNonbondedForce,
  undamped);
* ``FAR``: LJ_SW_RF - NEAR in one pass (the fused FarNonbondedForce).

>>> import torch
>>> round(float(lj(torch.tensor(2.0 ** (1 / 6) * 0.34, dtype=torch.float64), 0.34, 0.65)), 10)
-0.65
"""
from __future__ import annotations

import dataclasses

import torch

from ..units import ONE_4PI_EPS0
from .rv import Rv, make_rv, rv_parts  # noqa: F401  (re-exported)
from .switching import switch_quintic

LJ_SW_RF, NEAR, FAR = 0, 1, 2

_PME_SLICE = ("damped (alpha != 0) Coulomb belongs to the PME slice, which "
              "atomsmm_tpu_torch has not ported yet")


def lorentz_berthelot(sigma_i, sigma_j, eps_i, eps_j):
    sigma = 0.5 * (sigma_i + sigma_j)
    epsilon = torch.sqrt(eps_i * eps_j)
    return sigma, epsilon


def lj(r, sigma, epsilon):
    """Lennard-Jones 4 eps [(s/r)^12 - (s/r)^6]."""
    _, rinv, _ = rv_parts(r)
    t = sigma * rinv
    t2 = t * t
    s6 = t2 * t2 * t2
    return 4.0 * epsilon * s6 * (s6 - 1.0)


def coulomb(r, qq):
    """Plain Coulomb k qq / r; qq = qi*qj [e^2]."""
    _, rinv, _ = rv_parts(r)
    return ONE_4PI_EPS0 * qq * rinv


def reaction_field_constants(r_cut: float, eps_rf: float):
    """(k_rf, c_rf) of the reaction-field Coulomb, in host f64."""
    r_cut, eps_rf = float(r_cut), float(eps_rf)
    k_rf = (eps_rf - 1.0) / ((2.0 * eps_rf + 1.0) * r_cut**3)
    return k_rf, 1.0 / r_cut + k_rf * r_cut**2


def reaction_field_coulomb(r, qq, r_cut, eps_rf):
    """Cutoff Coulomb with reaction-field correction (openmm CutoffPeriodic):
    k qq (1/r + k_rf r^2 - c_rf), with u(rc) = 0."""
    k_rf, c_rf = reaction_field_constants(r_cut, eps_rf)
    _, rinv, r2 = rv_parts(r)
    return ONE_4PI_EPS0 * qq * (rinv + k_rf * r2 - c_rf)


def _near_base(rinv, sigma, epsilon, qq):
    """base(r) and d base/dr from 1/r: the undamped LJ + Coulomb that the
    near force shifts."""
    t = sigma * rinv
    t2 = t * t
    s6 = t2 * t2 * t2
    cq = ONE_4PI_EPS0 * qq
    base = 4.0 * epsilon * s6 * (s6 - 1.0) + cq * rinv
    dbase = -rinv * (24.0 * epsilon * s6 * (2.0 * s6 - 1.0) + cq * rinv)
    return base, dbase


def near_pair_energy(r, sigma, epsilon, qq, alpha, r_switch, r_cut,
                     subtract: bool = False):
    """Inner RESPA pair energy (atomsmm/forces.py::NearNonbondedForce):
    shifted-force LJ + Coulomb, switched to zero over [r_switch, r_cut]; the
    negated form with `subtract`. Undamped only: a nonzero alpha raises."""
    if float(alpha) != 0.0:
        raise NotImplementedError(_PME_SLICE)
    rr, rinv, _ = rv_parts(r)
    base, _ = _near_base(rinv, sigma, epsilon, qq)
    base_c, dbase_c = _near_base(1.0 / float(r_cut), sigma, epsilon, qq)
    u = (base - base_c - dbase_c * (rr - float(r_cut))) * switch_quintic(
        rr, r_switch, r_cut)
    return -u if subtract else u


# --- hand-derived pair forms of the pair kernels -----------------------------


@dataclasses.dataclass(frozen=True)
class PairForm:
    """A built-in pair form and its host-computed scalars (f64), exactly the
    parameter block the CUDA kernels receive."""

    kind: int
    r_cut: float            # mask cutoff
    has_full: bool = False
    use_switch: bool = True
    sw_rs: float = 0.0
    sw_inv_w: float = 0.0
    k_rf: float = 0.0
    c_rf: float = 0.0
    has_near: bool = False
    n_rs: float = 0.0
    n_inv_w: float = 0.0
    n_rc: float = 0.0
    n_rcinv: float = 0.0
    near_sign: float = 1.0

    def scalars(self):
        """The kernels' scalar block, in the order csrc/pair_forms.cuh reads."""
        return [self.sw_rs, self.sw_inv_w, self.k_rf, self.c_rf, self.n_rs,
                self.n_inv_w, self.n_rc, self.n_rcinv, self.near_sign]

    def flags(self):
        return [int(self.has_full), int(self.use_switch), int(self.has_near)]


def lj_sw_rf_form(r_cut, r_switch, eps_rf, use_switch: bool = True) -> PairForm:
    r_cut, r_switch = float(r_cut), float(r_switch)
    k_rf, c_rf = reaction_field_constants(r_cut, eps_rf)
    return PairForm(LJ_SW_RF, r_cut, has_full=True, use_switch=bool(use_switch),
                    sw_rs=r_switch, sw_inv_w=1.0 / (r_cut - r_switch),
                    k_rf=k_rf, c_rf=c_rf)


def near_form(r_cut, r_switch, alpha=0.0, subtract: bool = False) -> PairForm:
    if float(alpha) != 0.0:
        raise NotImplementedError(_PME_SLICE)
    r_cut, r_switch = float(r_cut), float(r_switch)
    return PairForm(NEAR, r_cut, has_near=True, n_rs=r_switch,
                    n_inv_w=1.0 / (r_cut - r_switch), n_rc=r_cut,
                    n_rcinv=1.0 / r_cut, near_sign=-1.0 if subtract else 1.0)


def far_form(full: PairForm, minus_near: PairForm) -> PairForm:
    """The fused far form: the full form plus the (negated) near form, one
    pass bounded by the full cutoff (the near part is zero beyond its own)."""
    return dataclasses.replace(
        full, kind=FAR, has_near=True, n_rs=minus_near.n_rs,
        n_inv_w=minus_near.n_inv_w, n_rc=minus_near.n_rc,
        n_rcinv=minus_near.n_rcinv, near_sign=minus_near.near_sign)


def _switch_and_slope(x):
    """S(x) on x clipped to [0, 1] and dS/dx = -30 x² (1 - x)²."""
    x = torch.clamp(x, 0.0, 1.0)
    s = 1.0 + x * x * x * (-10.0 + x * (15.0 - 6.0 * x))
    om = 1.0 - x
    return s, -30.0 * x * x * om * om


def form_u_dudr2(form: PairForm, r2, qq, sig, eps):
    """(u, du/dr²) of `form` at squared distance r2 (mask invalid slots to
    r2 = 1 first). Line-for-line twin of pair_form in csrc/pair_forms.cuh."""
    rinv = make_rv(r2).rinv
    r = r2 * rinv
    rinv2 = rinv * rinv
    u = torch.zeros_like(r2)
    dudr2 = torch.zeros_like(r2)
    if form.has_full:
        t = sig * rinv
        t2 = t * t
        s6 = t2 * t2 * t2
        ulj = 4.0 * eps * s6 * (s6 - 1.0)
        dulj = -12.0 * eps * s6 * (2.0 * s6 - 1.0) * rinv2
        if form.use_switch:
            sw, ds_dx = _switch_and_slope((r - form.sw_rs) * form.sw_inv_w)
            dsw = ds_dx * form.sw_inv_w * 0.5 * rinv
        else:
            sw, dsw = torch.ones_like(r2), torch.zeros_like(r2)
        uc = ONE_4PI_EPS0 * qq * (rinv + form.k_rf * r2 - form.c_rf)
        duc = ONE_4PI_EPS0 * qq * (form.k_rf - 0.5 * rinv * rinv2)
        u = u + ulj * sw + uc
        dudr2 = dudr2 + dulj * sw + ulj * dsw + duc
    if form.has_near:
        # the kernel skips slots with x >= 1 by a branch; here S = dS = 0
        # there, so they add exactly zero
        sw, ds_dx = _switch_and_slope((r - form.n_rs) * form.n_inv_w)
        dsw_dr = ds_dx * form.n_inv_w
        base, dbase = _near_base(rinv, sig, eps, qq)
        base_c, dbase_c = _near_base(form.n_rcinv, sig, eps, qq)
        sh = base - base_c - dbase_c * (r - form.n_rc)
        un = sh * sw
        dun_dr = (dbase - dbase_c) * sw + sh * dsw_dr
        u = u + form.near_sign * un
        dudr2 = dudr2 + form.near_sign * dun_dr * 0.5 * rinv
    return u, dudr2
