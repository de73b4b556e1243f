"""Force objects (counterpart of atomsmm_tpu/forces.py).

Each force is a dataclass whose `energy(x, box, globals, aux)` method is a
PyTorch function of the positions; the `group` integer drives the RESPA
split exactly as in the JAX package. Nonbonded forces have two paths:

  * dense — the chunked O(N²) oracle (ops/pairs.py), CPU only, forces by
    autograd; used for goldens and when no neighbor list is attached;
  * cell list — the half- or full-stencil sweep (ops/neighbors.py), with
    explicit forces from `energy_and_forces`; on the card it runs a CUDA
    kernel, which takes a built-in pair form (`_pair_form`) instead of a
    traced Python pair function.

PME (method 'pme') splits each Coulomb pair into the damped direct-space
term, which the pair kernels evaluate (ops/pairfuncs.py, LJ_SW_EWALD), and
the reciprocal sum with its self and excluded-pair corrections
(ops/pme.py), whose forces are explicit on both paths.

Ported: NonbondedForce (methods 'cutoff', 'pme', and 'nocutoff' on the
dense path), NearNonbondedForce (damped or not), the fused
FarNonbondedForce, PMEReciprocalForce, NonbondedExceptionsForce,
TemplateBondedForce, HarmonicBondForce, HarmonicAngleForce and
PeriodicTorsionForce.

>>> import torch
>>> f64 = torch.float64
>>> box = torch.tensor([5.0, 5.0, 5.0], dtype=f64)
>>> no_excl = -torch.ones((2, 1), dtype=torch.int32)
>>> x = torch.tensor([[0.0, 0.0, 0.0], [2.0**(1 / 6) * 0.3, 0.0, 0.0]], dtype=f64)
>>> nb = NonbondedForce(charge=torch.zeros(2, dtype=f64),
...                     sigma=torch.full((2,), 0.3, dtype=f64),
...                     epsilon=torch.full((2,), 1.0, dtype=f64),
...                     exclusions=no_excl, r_cut=1.0, r_switch=0.9)
>>> round(float(nb.energy(x, box, {})), 6)
-1.0
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .ops import pairfuncs, pme
from .ops.bonded import (
    harmonic_angle_energy,
    harmonic_bond_energy,
    periodic_torsion_energy,
)
from .ops.neighbors import cell_pair_energy, cell_pair_energy_forces
from .ops.pairs import dense_pair_energy, pairlist_energy
from .ops.pbc import box_volume
from .ops.switching import switch_quintic
from .units import ONE_4PI_EPS0

_METHODS = ("cutoff", "pme", "nocutoff")


def _resolve_neighbors(aux, key: str):
    """Aux entry ({'spec', 'bucket'}) for this force's neighbor structure,
    falling back to the default one; None -> dense path."""
    if not aux:
        return None
    return aux.get(key) or aux.get("default")


def _combine(pi, pj):
    return pairfuncs.lorentz_berthelot(pi["sigma"], pj["sigma"],
                                       pi["epsilon"], pj["epsilon"])


@dataclasses.dataclass
class Force:
    """Base force: subclasses define energy(x, box, globals, aux) -> scalar.

    Subclasses with an explicit force formula also define
    energy_and_forces(x, box, globals, aux) -> (scalar, (N, 3)); the others
    are differentiated by potential.force_fn."""

    group: int = 0

    @property
    def name(self) -> str:
        return type(self).__name__

    def energy(self, x, box, globals, aux=None):  # pragma: no cover - abstract
        raise NotImplementedError


class _PairForceMixin:
    """Shared dense/cell dispatch for pair forces. Subclasses provide
    _pair_fn(globals) -> (r, pi, pj) -> energy (dense path),
    _pair_form(globals) -> PairForm (cell path) and _per_particle()."""

    neighbor_key = "default"

    def _nb_energy(self, x, box, globals, aux, r_cut):
        pp = self._per_particle(globals)
        nbr = _resolve_neighbors(aux, self.neighbor_key)
        if nbr is not None and math.isfinite(r_cut):
            return cell_pair_energy(self._pair_form(globals), x, box, pp,
                                    nbr["spec"], nbr["bucket"], r_cut)
        return dense_pair_energy(self._pair_fn(globals), x, box, pp,
                                 self.exclusions, r_cut, chunk=self.chunk)

    def _nb_energy_forces(self, x, box, globals, aux, r_cut):
        pp = self._per_particle(globals)
        nbr = _resolve_neighbors(aux, self.neighbor_key)
        if nbr is not None and math.isfinite(r_cut):
            return cell_pair_energy_forces(self._pair_form(globals), x, box,
                                           pp, nbr["spec"], nbr["bucket"],
                                           r_cut)
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            e = dense_pair_energy(self._pair_fn(globals), xx, box, pp,
                                  self.exclusions, r_cut, chunk=self.chunk)
            (g,) = torch.autograd.grad(e, xx)
        return e.detach(), -g


@dataclasses.dataclass
class NonbondedForce(_PairForceMixin, Force):
    """Full LJ + Coulomb nonbonded force with per-particle (charge, sigma,
    epsilon), Lorentz-Berthelot combining and exclusions. Cutoff scalars
    are host floats.

    method:
      'nocutoff' - plain LJ + Coulomb over all pairs (dense path only)
      'cutoff'   - switched LJ + reaction-field Coulomb within r_cut
      'pme'      - switched LJ + PME Coulomb: the damped direct-space pair
                   term (the pair kernels), the reciprocal sum and the
                   self/exclusion corrections (ops/pme.py)

    dispersion_coeff adds the long-range LJ tail coeff / V (no force at
    fixed volume; compute_dispersion_coefficient)."""

    charge: torch.Tensor = None
    sigma: torch.Tensor = None
    epsilon: torch.Tensor = None
    exclusions: torch.Tensor = None  # (N, M) int32, padded with -1
    r_cut: float = 1.0
    r_switch: float = 0.9
    eps_rf: float = 1e15
    dispersion_coeff: float = None
    ewald_alpha: float = 0.0
    method: str = "cutoff"
    use_switch: bool = True
    grid_shape: Tuple[int, int, int] = (0, 0, 0)
    spline_order: int = 4
    chunk: int = 256

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(f"NonbondedForce(method={self.method!r}): "
                             f"expected one of {_METHODS}")

    def _per_particle(self, globals=None):
        return {"charge": self.charge, "sigma": self.sigma,
                "epsilon": self.epsilon}

    def _pair_fn(self, globals=None):
        method, use_switch = self.method, self.use_switch
        r_cut, r_switch, eps_rf = self.r_cut, self.r_switch, self.eps_rf
        alpha = float(self.ewald_alpha)

        def pair(r, pi, pj):
            sigma, epsilon = _combine(pi, pj)
            qq = pi["charge"] * pj["charge"]
            u_lj = pairfuncs.lj(r, sigma, epsilon)
            if method == "nocutoff":
                return u_lj + pairfuncs.coulomb(r, qq)
            if use_switch:
                rr = r.r if isinstance(r, pairfuncs.Rv) else r
                u_lj = u_lj * switch_quintic(rr, r_switch, r_cut)
            if method == "cutoff":
                return u_lj + pairfuncs.reaction_field_coulomb(r, qq, r_cut,
                                                               eps_rf)
            return u_lj + pairfuncs.damped_coulomb(r, qq, alpha)

        pair.takes_rv = True
        return pair

    def _pair_form(self, globals=None):
        if self.method == "pme":
            return pairfuncs.lj_sw_ewald_form(self.r_cut, self.r_switch,
                                              self.ewald_alpha,
                                              self.use_switch)
        if self.method == "nocutoff":
            raise NotImplementedError(
                "NonbondedForce(method='nocutoff') runs on the dense path "
                "only: it has no pair-kernel form")
        return pairfuncs.lj_sw_rf_form(self.r_cut, self.r_switch, self.eps_rf,
                                       self.use_switch)

    @property
    def _pair_cutoff(self):
        return math.inf if self.method == "nocutoff" else self.r_cut

    def _recip_energy_forces(self, x, box, include_reciprocal=True):
        """(E, forces) of the PME terms outside the pair sweep: the
        self/exclusion corrections and, unless a PMEReciprocalForce carries
        it, the reciprocal sum."""
        alpha = float(self.ewald_alpha)
        e, f = pme.pme_corrections_forces(x, box, self.charge,
                                          self.exclusions, alpha)
        if include_reciprocal:
            er, fr = pme.pme_reciprocal_energy_forces(
                x, box, self.charge, alpha, self.grid_shape,
                self.spline_order)
            e, f = e + er, f + fr
        return e, f

    def _recip_energy(self, x, box, include_reciprocal=True):
        alpha = float(self.ewald_alpha)
        e = pme.pme_corrections(x, box, self.charge, self.exclusions, alpha)
        if include_reciprocal:
            e = e + pme.pme_reciprocal_energy(x, box, self.charge, alpha,
                                              self.grid_shape,
                                              self.spline_order)
        return e

    def _dispersion(self, box):
        if self.dispersion_coeff is None:
            return 0.0
        return self.dispersion_coeff / box_volume(box)

    def energy(self, x, box, globals, aux=None):
        e = self._nb_energy(x, box, globals, aux, self._pair_cutoff)
        if self.method == "pme":
            e = e + self._recip_energy(x, box)
        return e + self._dispersion(box)

    def energy_and_forces(self, x, box, globals, aux=None):
        e, f = self._nb_energy_forces(x, box, globals, aux, self._pair_cutoff)
        if self.method == "pme":
            e2, f2 = self._recip_energy_forces(x, box)
            e, f = e + e2, f + f2
        return e + self._dispersion(box), f

    def uses_neighbors(self) -> bool:
        return self.method != "nocutoff"


def compute_dispersion_coefficient(sigma, epsilon, r_switch, r_cut,
                                   use_switch=True, n_quad=512):
    """Long-range LJ tail coefficient (openmm's dispersion correction),
    E_tail = coeff / V with coeff = 2 pi sum over pairs of the integral of
    r² (u - u_kept) dr: the full tail beyond r_cut plus what the switch
    removes on [r_switch, r_cut] (trapezoid quadrature), over the unique
    (sigma, epsilon) types. Host numpy, float64."""
    sig = np.asarray(torch.as_tensor(sigma).detach().cpu(), np.float64)
    eps = np.asarray(torch.as_tensor(epsilon).detach().cpu(), np.float64)
    types, counts = np.unique(np.stack([sig, eps], 1), axis=0,
                              return_counts=True)
    rc, rs = float(r_cut), float(r_switch)
    total = 0.0
    for a in range(len(counts)):
        for b in range(len(counts)):
            s_ab = 0.5 * (types[a, 0] + types[b, 0])
            e_ab = np.sqrt(types[a, 1] * types[b, 1])
            if e_ab == 0.0:
                continue
            npairs = counts[a] * counts[b]  # ordered pairs; x1/2 below
            missed = 4.0 * e_ab * (s_ab**12 / (9.0 * rc**9)
                                   - s_ab**6 / (3.0 * rc**3))
            if use_switch and rs < rc:
                r = np.linspace(rs, rc, n_quad)
                u = 4.0 * e_ab * ((s_ab / r) ** 12 - (s_ab / r) ** 6)
                t = np.clip((r - rs) / (rc - rs), 0, 1)
                s_of_r = 1 + t**3 * (-10 + t * (15 - 6 * t))
                missed += np.trapezoid(r * r * u * (1.0 - s_of_r), r)
            total += 0.5 * npairs * missed
    return float(4.0 * np.pi * total)


@dataclasses.dataclass
class NonbondedExceptionsForce(Force):
    """1-4 exception pairs as a bond-like force, so they can live in the
    innermost RESPA group (atomsmm/forces.py::NonbondedExceptionsForce).

    E = 4 eps [(s/r)^12 - (s/r)^6] + k qq / r per listed pair, no cutoff
    and no damping. Forces by autograd (potential.force_fn).
    """

    pairs: torch.Tensor = None       # (P, 2) int32
    chargeprod: torch.Tensor = None  # (P,) [e^2]
    sigma: torch.Tensor = None       # (P,)
    epsilon: torch.Tensor = None     # (P,)
    valid: torch.Tensor = None       # (P,) bool mask for padding

    def energy(self, x, box, globals, aux=None):
        def pair(r, p):
            return (pairfuncs.lj(r, p["sigma"], p["epsilon"])
                    + ONE_4PI_EPS0 * p["chargeprod"] / r)

        params = {"chargeprod": self.chargeprod, "sigma": self.sigma,
                  "epsilon": self.epsilon}
        return pairlist_energy(pair, x, box, self.pairs, params, self.valid)


@dataclasses.dataclass
class NearNonbondedForce(_PairForceMixin, Force):
    """Short-range RESPA force (atomsmm/forces.py::NearNonbondedForce):
    shifted-force LJ + shifted-force Coulomb, damped by erfc(alpha r) when
    alpha != 0 (the PME split), switched to zero over [r_switch, r_cut];
    negated with subtract=True (the "minus near" half of the far force)."""

    charge: torch.Tensor = None
    sigma: torch.Tensor = None
    epsilon: torch.Tensor = None
    exclusions: torch.Tensor = None
    r_cut: float = 0.8
    r_switch: float = 0.7
    alpha: float = 0.0
    subtract: bool = False
    neighbor_key: str = "default"
    chunk: int = 256

    def _per_particle(self, globals=None):
        return {"charge": self.charge, "sigma": self.sigma,
                "epsilon": self.epsilon}

    def _pair_fn(self, globals=None):
        r_cut, r_switch, subtract = self.r_cut, self.r_switch, self.subtract
        alpha = float(self.alpha)

        def pair(r, pi, pj):
            sigma, epsilon = _combine(pi, pj)
            return pairfuncs.near_pair_energy(
                r, sigma, epsilon, pi["charge"] * pj["charge"], alpha,
                r_switch, r_cut, subtract=subtract)

        pair.takes_rv = True
        return pair

    def _pair_form(self, globals=None):
        return pairfuncs.near_form(self.r_cut, self.r_switch, self.alpha,
                                   self.subtract)

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)


@dataclasses.dataclass
class FarNonbondedForce(_PairForceMixin, Force):
    """Complement force for RESPA (atomsmm/forces.py::FarNonbondedForce):
    the full nonbonded force plus the negated near force, fused into one
    pass over the full cutoff, so near + far == full. The PME terms outside
    the pair sweep (corrections, and the reciprocal sum unless
    include_reciprocal is False because a PMEReciprocalForce carries it at
    its own level) and the dispersion tail are added here."""

    full: NonbondedForce = None
    minus_near: NearNonbondedForce = None
    include_reciprocal: bool = True

    def __post_init__(self):
        if self.full is None or self.minus_near is None:
            raise ValueError("FarNonbondedForce needs `full` and `minus_near`")
        if not self.minus_near.subtract:
            raise NotImplementedError(
                "FarNonbondedForce fuses full + negated near; an unfusable "
                "pair (minus_near.subtract=False) is not ported")

    @property
    def chunk(self):
        return self.full.chunk

    @property
    def exclusions(self):
        return self.full.exclusions

    def _per_particle(self, globals=None):
        return self.full._per_particle(globals)

    def _pair_fn(self, globals=None):
        pf = self.full._pair_fn(globals)
        pn = self.minus_near._pair_fn(globals)

        def pair(r, pi, pj):
            return pf(r, pi, pj) + pn(r, pi, pj)

        pair.takes_rv = True
        return pair

    def _pair_form(self, globals=None):
        return pairfuncs.far_form(self.full._pair_form(globals),
                                  self.minus_near._pair_form(globals))

    def energy(self, x, box, globals, aux=None):
        e = self._nb_energy(x, box, globals, aux, self.full._pair_cutoff)
        if self.full.method == "pme":
            e = e + self.full._recip_energy(x, box, self.include_reciprocal)
        return e + self.full._dispersion(box)

    def energy_and_forces(self, x, box, globals, aux=None):
        e, f = self._nb_energy_forces(x, box, globals, aux,
                                      self.full._pair_cutoff)
        if self.full.method == "pme":
            e2, f2 = self.full._recip_energy_forces(x, box,
                                                    self.include_reciprocal)
            e, f = e + e2, f + f2
        return e + self.full._dispersion(box), f


@dataclasses.dataclass
class PMEReciprocalForce(Force):
    """The PME reciprocal (FFT) sum as its own force group, for a third
    RESPA level (RESPASystem(..., reciprocal_level=True), beside
    FarNonbondedForce(include_reciprocal=False), which keeps the fast
    self/exclusion corrections). Forces are explicit (ops/pme.py)."""

    charge: torch.Tensor = None
    ewald_alpha: float = 3.0
    grid_shape: Tuple[int, int, int] = (0, 0, 0)
    spline_order: int = 4

    def energy(self, x, box, globals, aux=None):
        return pme.pme_reciprocal_energy(x, box, self.charge,
                                         float(self.ewald_alpha),
                                         self.grid_shape, self.spline_order)

    def energy_and_forces(self, x, box, globals, aux=None):
        return pme.pme_reciprocal_energy_forces(
            x, box, self.charge, float(self.ewald_alpha), self.grid_shape,
            self.spline_order)


@dataclasses.dataclass
class TemplateBondedForce(Force):
    """Bonds + angles for systems of identical, contiguously indexed
    molecules (e.g. a water box): positions reshape to (M, A, 3) and every
    template term indexes with fixed local atom indices. Forces by
    autograd (potential.force_fn)."""

    bond_r0: torch.Tensor = None    # (B,) template bond lengths
    bond_k: torch.Tensor = None     # (B,)
    angle_t0: torch.Tensor = None   # (A,)
    angle_k: torch.Tensor = None    # (A,)
    first_atom: int = 0
    n_molecules: int = 0
    atoms_per_molecule: int = 3
    bond_idx: Tuple = ()            # ((a, b), ...) local indices
    angle_idx: Tuple = ()           # ((i, j, k), ...) j central

    def energy(self, x, box, globals, aux=None):
        m, a_pm = self.n_molecules, self.atoms_per_molecule
        lo = self.first_atom
        xm = x[lo: lo + m * a_pm].reshape(m, a_pm, 3)
        e = torch.zeros((), dtype=x.dtype, device=x.device)
        for t, (i, j) in enumerate(self.bond_idx):
            d = xm[:, i] - xm[:, j]
            r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-32)
            e = e + torch.sum(0.5 * self.bond_k[t] * (r - self.bond_r0[t]) ** 2)
        for t, (i, j, k) in enumerate(self.angle_idx):
            va = xm[:, i] - xm[:, j]
            vb = xm[:, k] - xm[:, j]
            na = torch.sqrt(torch.sum(va * va, dim=-1) + 1e-32)
            nb = torch.sqrt(torch.sum(vb * vb, dim=-1) + 1e-32)
            ct = torch.clamp(torch.sum(va * vb, dim=-1) / (na * nb),
                             -1.0 + 1e-7, 1.0 - 1e-7)
            theta = torch.arccos(ct)
            e = e + torch.sum(0.5 * self.angle_k[t]
                              * (theta - self.angle_t0[t]) ** 2)
        return e


@dataclasses.dataclass
class HarmonicBondForce(Force):
    """E = sum 0.5 k (r - r0)^2 (openmm.HarmonicBondForce; pad with k = 0)."""

    idx: torch.Tensor = None  # (B, 2)
    r0: torch.Tensor = None
    k: torch.Tensor = None

    def energy(self, x, box, globals, aux=None):
        return harmonic_bond_energy(x, self.idx.long(), self.r0, self.k)


@dataclasses.dataclass
class HarmonicAngleForce(Force):
    """E = sum 0.5 k (theta - theta0)^2 (openmm.HarmonicAngleForce)."""

    idx: torch.Tensor = None  # (A, 3)
    theta0: torch.Tensor = None
    k: torch.Tensor = None

    def energy(self, x, box, globals, aux=None):
        return harmonic_angle_energy(x, self.idx.long(), self.theta0, self.k)


@dataclasses.dataclass
class PeriodicTorsionForce(Force):
    """E = sum k (1 + cos(n phi - phase)) (openmm.PeriodicTorsionForce)."""

    idx: torch.Tensor = None  # (T, 4)
    periodicity: torch.Tensor = None
    phase: torch.Tensor = None
    k: torch.Tensor = None

    def energy(self, x, box, globals, aux=None):
        return periodic_torsion_energy(x, self.idx.long(), self.periodicity,
                                       self.phase, self.k)
