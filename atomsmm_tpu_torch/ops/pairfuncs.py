"""Pairwise energy expressions (counterpart of atomsmm_tpu/ops/pairfuncs.py).

Two families live here:

* energy functions of r (``lj``, ``coulomb``, ``damped_coulomb``,
  ``reaction_field_coulomb``, ``near_pair_energy``) with Lorentz-Berthelot
  combining. The dense O(N²) oracle evaluates them and takes forces by
  autograd.
* the built-in pair *forms* of the pair kernels, with energy and du/dr²
  derived by hand (``PairForm`` and ``form_u_dudr2``). The production
  forces' pair terms are these: the CUDA kernels (csrc/pair_forms.cuh)
  take a form and a few host-computed scalars; ``form_u_dudr2`` is its
  line-for-line PyTorch transcription, so that a derivation error shows in
  the CPU tests against the JAX package. A user's pair function
  (CustomNonbondedForce) reaches K1 and K2 traced instead
  (ops/pairtrace.py).

Forms (Lorentz-Berthelot combining, k = ONE_4PI_EPS0, and the Coulomb
kernel c(r) = erfc(alpha r)/r, which is 1/r when alpha = 0):

* ``LJ_SW_RF``: LJ(r) S(r; rs, rc) + k qq (1/r + k_rf r² - c_rf)
  (NonbondedForce, method 'cutoff');
* ``LJ_SW_EWALD``: LJ(r) S(r; rs, rc) + k qq c(r), the Ewald direct-space
  term, unshifted and truncated at rc (NonbondedForce, method 'pme');
* ``NEAR``: [base(r) - base(rc) - base'(rc)(r - rc)] S(r; rs_in, rc_in), with
  base(r) = 4 eps [(s/r)^12 - (s/r)^6] + k qq c(r) (NearNonbondedForce;
  damped when alpha != 0);
* ``FAR``: a full form minus NEAR in one pass (the fused FarNonbondedForce);
  both halves share alpha, so c(r) is evaluated once per slot;
* ``SOFTCORE``: Beutler softcore LJ 4 eps lambda inv (inv - 1) S(r; rs, rc)
  cross, inv = 1/(ALPHA_SC (1 - lambda) + (r/s)^6), between the solute and
  the rest (SoftcoreLennardJonesForce). The kernels hand a form only the
  charge product, so the force puts 2 solute - 1 (+-1) in the charge column
  and the form takes cross = (1 - qq)/2: 1 for a solute-solvent pair, 0
  otherwise. With ``dlambda`` the form returns the energy's lambda
  derivative 4 eps [inv (inv - 1) + lambda ALPHA_SC inv^2 (2 inv - 1)] S
  cross in place of u, and no force (thermodynamic integration);
* ``DAMPED_SMOOTHED``: (LJ + k qq c(r)) S(r; rs, rc), the damped Coulomb
  smoothed by the switch with no shift (DampedSmoothedForce).

The full forms take two more flags. ``table``: the pair's (sigma, epsilon)
come from a per-type-pair table (NBFIX) instead of Lorentz-Berthelot; the
per-particle dict then carries the type column ``lj_type`` and the
(T, T, 4) table ``pair_table`` [sigma, epsilon, A, B] (forces.py), and the
kernels read the pair's row instead of combining. ``hbond`` (with a
table): the legacy AMBER 10-12 term A/r^12 - B/r^10 (``hbond_10_12``) joins
the LJ term of the full half before the switch, as in
NonbondedForce._pair_fn; the near half never takes it.

Any form but a dlambda one takes the ``virial`` flag (``virial_form``): the
energy column then carries the pair's virial w = -2 r² du/dr² = d . F in
place of u, and the force is unchanged. Summed like the energy, it gives
W = -dU(s x, s box)/ds at s = 1 (computers.py).

>>> import torch
>>> round(float(lj(torch.tensor(2.0 ** (1 / 6) * 0.34, dtype=torch.float64), 0.34, 0.65)), 10)
-0.65
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..units import ONE_4PI_EPS0
from .rv import Rv, make_rv, rv_parts  # noqa: F401  (re-exported)
from .switching import switch_quintic

LJ_SW_RF, NEAR, FAR, LJ_SW_EWALD, SOFTCORE, DAMPED_SMOOTHED = range(6)

TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)
# the softcore alpha of SoftcoreLennardJonesForce, fixed as in the JAX
# package; csrc/pair_forms.cuh holds the same constant
ALPHA_SC = 0.5


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


def hbond_10_12(r, a, b):
    """AMBER legacy 10-12 hydrogen-bond potential A/r^12 - B/r^10
    (HBOND_ACOEF/HBOND_BCOEF slots of the nonbonded parm table). Its
    minimum sits at r* = sqrt(6A/5B); with A = 1e-5 kJ nm^12 and
    B = 1e-3 kJ nm^10:

    >>> import math
    >>> import torch
    >>> r_star = math.sqrt(6e-5 / 5e-3)
    >>> u0, ul, ur = (float(hbond_10_12(torch.tensor(r_star * f,
    ...     dtype=torch.float64), 1e-5, 1e-3)) for f in (1.0, 0.99, 1.01))
    >>> u0 < ul and u0 < ur
    True
    """
    _, rinv, _ = rv_parts(r)
    inv2 = rinv * rinv
    inv10 = inv2 * inv2
    inv10 = inv10 * inv10 * inv2  # (1/r^2)^5
    return (a * inv2 - b) * inv10


def coulomb(r, qq):
    """Plain Coulomb k qq / r; qq = qi*qj [e^2]."""
    _, rinv, _ = rv_parts(r)
    return ONE_4PI_EPS0 * qq * rinv


def erfc(x):
    """Complementary error function, exact (``torch.erfc``) in every dtype.
    The JAX package swaps in a polynomial for float32 on the TPU; the port's
    kernels call CUDA's ``erfcf``/``erfc`` instead."""
    return torch.erfc(x)


def damped_coulomb(r, qq, alpha):
    """Damped Coulomb k qq erfc(alpha r)/r, the PME direct-space term;
    alpha = 0 is plain Coulomb."""
    rr, rinv, _ = rv_parts(r)
    return ONE_4PI_EPS0 * qq * erfc(alpha * rr) * rinv


def coulomb_kernel_at(r_cut: float, alpha: float):
    """(c(rc), c'(rc)) of the Coulomb kernel c(r) = erfc(alpha r)/r in host
    f64: the near form's shift constants (1/rc and -1/rc² when alpha = 0).
    d/dr [erfc(a r)/r] = -erfc(a r)/r² - (2a/sqrt(pi)) exp(-a² r²)/r."""
    r_cut, alpha = float(r_cut), float(alpha)
    ec = math.erfc(alpha * r_cut) / r_cut
    g = TWO_OVER_SQRT_PI * alpha * math.exp(-(alpha * r_cut) ** 2)
    return ec, -(ec + g) / r_cut


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


def _coulomb_kernel(r, rinv, alpha: float):
    """(c(r), dc/dr) of c(r) = erfc(alpha r)/r per slot: one erfc and one
    exp when damped, none when alpha = 0."""
    if alpha == 0.0:
        return rinv, -rinv * rinv
    ar = alpha * r
    ec = erfc(ar) * rinv
    return ec, -(ec + TWO_OVER_SQRT_PI * alpha * torch.exp(-ar * ar)) * rinv


def _near_base(rinv, ec, dec, sigma, epsilon, qq):
    """base(r) and d base/dr of the LJ + Coulomb that the near force shifts,
    from 1/r and the Coulomb kernel c(r) and its slope."""
    t = sigma * rinv
    t2 = t * t
    s6 = t2 * t2 * t2
    cq = ONE_4PI_EPS0 * qq
    base = 4.0 * epsilon * s6 * (s6 - 1.0) + cq * ec
    dbase = -24.0 * epsilon * s6 * (2.0 * s6 - 1.0) * rinv + cq * dec
    return base, dbase


def softcore_lj(r, sigma, epsilon, lamb, alpha=0.5):
    """Beutler-style softcore LJ (atomsmm/forces.py::SoftcoreLennardJonesForce):

    u = 4 eps lambda [(1/x)^2 - 1/x],  x = alpha (1 - lambda) + (r/sigma)^6.

    lambda = 1 recovers plain LJ; lambda = 0 turns the interaction off with a
    bounded core (finite at r = 0):

    >>> import torch
    >>> r = torch.tensor(0.38, dtype=torch.float64)
    >>> abs(float(softcore_lj(r, 0.34, 0.65, 1.0) - lj(r, 0.34, 0.65))) < 1e-14
    True
    >>> float(softcore_lj(torch.tensor(0.0, dtype=torch.float64), 0.34, 0.65, 0.0))
    0.0
    >>> bool(torch.isfinite(softcore_lj(torch.tensor(1e-6, dtype=torch.float64), 0.34, 0.65, 0.5)))
    True
    """
    _, _, r2 = rv_parts(r)
    t = r2 / (sigma * sigma)
    x = alpha * (1.0 - lamb) + t * t * t
    inv = 1.0 / x
    return 4.0 * epsilon * lamb * inv * (inv - 1.0)


def damped_smoothed_energy(r, sigma, epsilon, qq, alpha, r_switch, r_cut):
    """atomsmm/forces.py::DampedSmoothedForce: (LJ + damped Coulomb) S(r),
    the damped-shifted formulation of Fennell & Gezelter (JCP 2006) with a
    smoothing polynomial in place of the force shift."""
    rr, _, _ = rv_parts(r)
    return (lj(r, sigma, epsilon) + damped_coulomb(r, qq, alpha)) \
        * switch_quintic(rr, r_switch, r_cut)


def near_pair_energy(r, sigma, epsilon, qq, alpha, r_switch, r_cut,
                     subtract: bool = False):
    """Inner RESPA pair energy (atomsmm/forces.py::NearNonbondedForce):
    shifted-force LJ + shifted-force Coulomb (damped by erfc(alpha r) when
    alpha != 0), switched to zero over [r_switch, r_cut]; the negated form
    with `subtract`. The shift constants come from the host in f64."""
    alpha, r_cut = float(alpha), float(r_cut)
    rr, rinv, _ = rv_parts(r)
    ec = rinv if alpha == 0.0 else erfc(alpha * rr) * rinv
    base = lj(r, sigma, epsilon) + ONE_4PI_EPS0 * qq * ec
    ec_c, dec_c = coulomb_kernel_at(r_cut, alpha)
    base_c, dbase_c = _near_base(1.0 / r_cut, ec_c, dec_c, sigma, epsilon, qq)
    u = (base - base_c - dbase_c * (rr - r_cut)) * switch_quintic(
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
    ewald: bool = False     # full form's Coulomb: k qq c(r), not reaction field
    alpha: float = 0.0      # damping of c(r) = erfc(alpha r)/r, both halves
    n_ec: float = 0.0       # near form: c(rc_in)
    n_dec: float = 0.0      # near form: c'(rc_in)
    softcore: bool = False  # Beutler softcore LJ, cross = (1 - qq)/2
    dlambda: bool = False   # softcore: d u / d lambda in place of u, no force
    lamb: float = 1.0       # softcore: lambda
    smoothed: bool = False  # full form: the switch multiplies the Coulomb too
    table: bool = False     # (sigma, epsilon) from the type-pair table
    hbond: bool = False     # full half: + A/r^12 - B/r^10 (needs the table)
    virial: bool = False    # -2 r² du/dr² in place of u, force unchanged

    def __post_init__(self):
        if self.virial and self.dlambda:
            raise ValueError("a pair form takes the virial or the dlambda "
                             "flag, not both")
        if self.hbond and not self.table:
            raise ValueError("the 10-12 term reads its A and B from the "
                             "type-pair table: hbond needs table")

    def scalars(self):
        """The kernels' scalar block, in the order csrc/pair_forms.cuh reads."""
        return [self.sw_rs, self.sw_inv_w, self.k_rf, self.c_rf, self.n_rs,
                self.n_inv_w, self.n_rc, self.n_rcinv, self.near_sign,
                self.alpha, self.n_ec, self.n_dec, self.lamb]

    def flags(self):
        """The kernels' flag block. The table flag is not in it: a kernel
        takes the table form when it is given a table."""
        return [int(self.has_full), int(self.use_switch), int(self.has_near),
                int(self.ewald), int(self.softcore), int(self.dlambda),
                int(self.smoothed), int(self.hbond), int(self.virial)]


def lj_sw_rf_form(r_cut, r_switch, eps_rf, use_switch: bool = True) -> PairForm:
    r_cut, r_switch = float(r_cut), float(r_switch)
    k_rf, c_rf = reaction_field_constants(r_cut, eps_rf)
    return PairForm(LJ_SW_RF, r_cut, has_full=True, use_switch=bool(use_switch),
                    sw_rs=r_switch, sw_inv_w=1.0 / (r_cut - r_switch),
                    k_rf=k_rf, c_rf=c_rf)


def lj_sw_ewald_form(r_cut, r_switch, alpha,
                     use_switch: bool = True) -> PairForm:
    """Switched LJ + the Ewald direct-space Coulomb k qq erfc(alpha r)/r,
    truncated at r_cut (NonbondedForce, method 'pme')."""
    r_cut, r_switch = float(r_cut), float(r_switch)
    return PairForm(LJ_SW_EWALD, r_cut, has_full=True,
                    use_switch=bool(use_switch), sw_rs=r_switch,
                    sw_inv_w=1.0 / (r_cut - r_switch), ewald=True,
                    alpha=float(alpha))


def near_form(r_cut, r_switch, alpha=0.0, subtract: bool = False) -> PairForm:
    r_cut, r_switch = float(r_cut), float(r_switch)
    n_ec, n_dec = coulomb_kernel_at(r_cut, alpha)
    return PairForm(NEAR, r_cut, has_near=True, n_rs=r_switch,
                    n_inv_w=1.0 / (r_cut - r_switch), n_rc=r_cut,
                    n_rcinv=1.0 / r_cut, near_sign=-1.0 if subtract else 1.0,
                    alpha=float(alpha), n_ec=n_ec, n_dec=n_dec)


def softcore_form(r_cut, r_switch, lamb, use_switch: bool = True,
                  dlambda: bool = False) -> PairForm:
    """Beutler softcore LJ at `lamb`, switched over [r_switch, r_cut], with
    the solute indicator in the charge column as 2 solute - 1; `dlambda`
    gives d u / d lambda in place of u, and no force."""
    r_cut, r_switch = float(r_cut), float(r_switch)
    return PairForm(SOFTCORE, r_cut, use_switch=bool(use_switch),
                    sw_rs=r_switch, sw_inv_w=1.0 / (r_cut - r_switch),
                    softcore=True, dlambda=bool(dlambda), lamb=float(lamb))


def damped_smoothed_form(r_cut, r_switch, alpha) -> PairForm:
    """(LJ + k qq erfc(alpha r)/r) S(r; r_switch, r_cut), no shift
    (DampedSmoothedForce)."""
    r_cut, r_switch = float(r_cut), float(r_switch)
    return PairForm(DAMPED_SMOOTHED, r_cut, has_full=True, sw_rs=r_switch,
                    sw_inv_w=1.0 / (r_cut - r_switch), ewald=True,
                    alpha=float(alpha), smoothed=True)


def table_form(form: PairForm, hbond: bool = False) -> PairForm:
    """`form` reading its (sigma, epsilon) from the type-pair table, with
    the 10-12 term in its full half when `hbond`."""
    return dataclasses.replace(form, table=True, hbond=bool(hbond))


def virial_form(form: PairForm) -> PairForm:
    """`form` with the virial flag: each pair's -2 r² du/dr² (its d . F)
    in the energy column, the force unchanged."""
    return dataclasses.replace(form, virial=True)


def far_form(full: PairForm, minus_near: PairForm) -> PairForm:
    """The fused far form: the full form plus the (negated) near form, one
    pass bounded by the full cutoff (the near part is zero beyond its own).
    Both halves share one alpha: an Ewald full form takes only a near form
    damped by its own alpha."""
    if full.table != minus_near.table:
        raise ValueError("fused far form: both halves read the same "
                         "parameters, the type-pair table or none")
    if full.ewald and minus_near.alpha != full.alpha:
        raise ValueError(
            f"fused far form: the near half's alpha {minus_near.alpha} differs "
            f"from the Ewald alpha {full.alpha} of the full force")
    return dataclasses.replace(
        full, kind=FAR, has_near=True, n_rs=minus_near.n_rs,
        n_inv_w=minus_near.n_inv_w, n_rc=minus_near.n_rc,
        n_rcinv=minus_near.n_rcinv, near_sign=minus_near.near_sign,
        alpha=minus_near.alpha, n_ec=minus_near.n_ec, n_dec=minus_near.n_dec)


def _switch_and_slope(x):
    """S(x) on x clipped to [0, 1] and dS/dx = -30 x² (1 - x)²."""
    x = torch.clamp(x, 0.0, 1.0)
    s = 1.0 + x * x * x * (-10.0 + x * (15.0 - 6.0 * x))
    om = 1.0 - x
    return s, -30.0 * x * x * om * om


def form_u_dudr2(form: PairForm, r2, qq, sig, eps, a1012=None, b1012=None):
    """(u, du/dr²) of `form` at squared distance r2 (mask invalid slots to
    r2 = 1 first); under the virial flag -2 r² du/dr² in place of u.
    (sig, eps) are the pair's, combined or read from the table; a1012 and
    b1012 the pair's 10-12 coefficients, which the hbond flag requires.
    Line-for-line twin of pair_form in csrc/pair_forms.cuh."""
    if form.hbond and (a1012 is None or b1012 is None):
        raise ValueError("the hbond form needs the pair's a1012 and b1012")
    u, dudr2 = _form_energy(form, r2, qq, sig, eps, a1012, b1012)
    if form.virial:
        u = -2.0 * r2 * dudr2
    return u, dudr2


def _form_energy(form: PairForm, r2, qq, sig, eps, a1012=None, b1012=None):
    """(u, du/dr²) of `form`: the twin of pair_form_energy."""
    rinv = make_rv(r2).rinv
    r = r2 * rinv
    rinv2 = rinv * rinv
    u = torch.zeros_like(r2)
    dudr2 = torch.zeros_like(r2)
    if form.softcore:
        # Beutler softcore LJ; qq is the product of the 2 solute - 1 columns
        cross = 0.5 * (1.0 - qq)
        if form.use_switch:
            sw, ds_dx = _switch_and_slope((r - form.sw_rs) * form.sw_inv_w)
            dsw = ds_dx * form.sw_inv_w * 0.5 * rinv
        else:
            sw, dsw = torch.ones_like(r2), torch.zeros_like(r2)
        isig2 = 1.0 / (sig * sig)
        t = r2 * isig2
        inv = 1.0 / (ALPHA_SC * (1.0 - form.lamb) + t * t * t)
        c4 = 4.0 * eps * cross
        if form.dlambda:
            u = c4 * (inv * (inv - 1.0) + form.lamb * ALPHA_SC * inv * inv
                      * (2.0 * inv - 1.0)) * sw
            return u, dudr2
        usc = c4 * form.lamb * inv * (inv - 1.0)
        dusc = c4 * form.lamb * inv * inv * (1.0 - 2.0 * inv) * 3.0 * t * t \
            * isig2
        return usc * sw, dusc * sw + usc * dsw
    # Coulomb kernel c(r) = erfc(alpha r)/r and dc/dr, shared by both halves
    ec, dec = _coulomb_kernel(r, rinv, form.alpha)
    cq = ONE_4PI_EPS0 * qq
    if form.has_full:
        t = sig * rinv
        t2 = t * t
        s6 = t2 * t2 * t2
        ulj = 4.0 * eps * s6 * (s6 - 1.0)
        dulj = -12.0 * eps * s6 * (2.0 * s6 - 1.0) * rinv2
        if form.hbond:
            # A/r^12 - B/r^10 and its -6A/r^14 + 5B/r^12, inside the switch
            inv10 = rinv2 * rinv2
            inv10 = inv10 * inv10 * rinv2
            ulj = ulj + (a1012 * rinv2 - b1012) * inv10
            dulj = dulj + (5.0 * b1012 - 6.0 * a1012 * rinv2) * inv10 * rinv2
        if form.use_switch:
            sw, ds_dx = _switch_and_slope((r - form.sw_rs) * form.sw_inv_w)
            dsw = ds_dx * form.sw_inv_w * 0.5 * rinv
        else:
            sw, dsw = torch.ones_like(r2), torch.zeros_like(r2)
        if form.smoothed:
            uc = cq * ec
            duc = cq * dec * 0.5 * rinv
            u = u + (ulj + uc) * sw
            dudr2 = dudr2 + (dulj + duc) * sw + (ulj + uc) * dsw
        elif form.ewald:
            uc = cq * ec
            duc = cq * dec * 0.5 * rinv
            u = u + ulj * sw + uc
            dudr2 = dudr2 + dulj * sw + ulj * dsw + duc
        else:
            uc = ONE_4PI_EPS0 * qq * (rinv + form.k_rf * r2 - form.c_rf)
            duc = ONE_4PI_EPS0 * qq * (form.k_rf - 0.5 * rinv * rinv2)
            u = u + ulj * sw + uc
            dudr2 = dudr2 + dulj * sw + ulj * dsw + duc
    if form.has_near:
        # the kernel skips slots with x >= 1 by a branch; here S = dS = 0
        # there, so they add exactly zero
        sw, ds_dx = _switch_and_slope((r - form.n_rs) * form.n_inv_w)
        dsw_dr = ds_dx * form.n_inv_w
        base, dbase = _near_base(rinv, ec, dec, sig, eps, qq)
        base_c, dbase_c = _near_base(form.n_rcinv, form.n_ec, form.n_dec, sig,
                                     eps, qq)
        sh = base - base_c - dbase_c * (r - form.n_rc)
        un = sh * sw
        dun_dr = (dbase - dbase_c) * sw + sh * dsw_dr
        u = u + form.near_sign * un
        dudr2 = dudr2 + form.near_sign * dun_dr * 0.5 * rinv
    return u, dudr2
