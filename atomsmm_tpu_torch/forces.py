"""Force objects (counterpart of atomsmm_tpu/forces.py).

Each force is a dataclass whose `energy(x, box, globals, aux)` method is a
PyTorch function of the positions; the `group` integer drives the RESPA
split exactly as in the JAX package. Nonbonded forces have two paths:

  * dense — the chunked O(N²) oracle (ops/pairs.py), CPU only, forces by
    autograd; used for goldens and when no neighbor list is attached;
  * cell list — the half-stencil sweep (ops/neighbors.py), with explicit
    forces from `energy_and_forces`; on the card it runs the CUDA kernel,
    which takes a built-in pair form (`_pair_form`) instead of a traced
    Python pair function.

Ported: NonbondedForce (method 'cutoff'), NearNonbondedForce, the fused
FarNonbondedForce, TemplateBondedForce, HarmonicBondForce and
HarmonicAngleForce.

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
from typing import Tuple

import torch

from .ops import pairfuncs
from .ops.bonded import harmonic_angle_energy, harmonic_bond_energy
from .ops.neighbors import cell_pair_energy, cell_pair_energy_forces
from .ops.pairs import dense_pair_energy
from .ops.switching import switch_quintic


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
        if nbr is not None:
            return cell_pair_energy(self._pair_form(globals), x, box, pp,
                                    nbr["spec"], nbr["bucket"], r_cut)
        return dense_pair_energy(self._pair_fn(globals), x, box, pp,
                                 self.exclusions, r_cut, chunk=self.chunk)

    def _nb_energy_forces(self, x, box, globals, aux, r_cut):
        pp = self._per_particle(globals)
        nbr = _resolve_neighbors(aux, self.neighbor_key)
        if nbr is not None:
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
    """Switched LJ + reaction-field Coulomb within r_cut (method 'cutoff'),
    per-particle (charge, sigma, epsilon), Lorentz-Berthelot combining and
    exclusions. Cutoff scalars are host floats."""

    charge: torch.Tensor = None
    sigma: torch.Tensor = None
    epsilon: torch.Tensor = None
    exclusions: torch.Tensor = None  # (N, M) int32, padded with -1
    r_cut: float = 1.0
    r_switch: float = 0.9
    eps_rf: float = 1e15
    method: str = "cutoff"
    use_switch: bool = True
    chunk: int = 256

    def __post_init__(self):
        if self.method != "cutoff":
            raise NotImplementedError(
                f"NonbondedForce(method={self.method!r}): atomsmm_tpu_torch "
                "ports method 'cutoff' only ('pme' and 'nocutoff' are later "
                "slices)")

    def _per_particle(self, globals=None):
        return {"charge": self.charge, "sigma": self.sigma,
                "epsilon": self.epsilon}

    def _pair_fn(self, globals=None):
        r_cut, r_switch, eps_rf = self.r_cut, self.r_switch, self.eps_rf
        use_switch = self.use_switch

        def pair(r, pi, pj):
            sigma, epsilon = _combine(pi, pj)
            u_lj = pairfuncs.lj(r, sigma, epsilon)
            if use_switch:
                rr = r.r if isinstance(r, pairfuncs.Rv) else r
                u_lj = u_lj * switch_quintic(rr, r_switch, r_cut)
            qq = pi["charge"] * pj["charge"]
            return u_lj + pairfuncs.reaction_field_coulomb(r, qq, r_cut, eps_rf)

        pair.takes_rv = True
        return pair

    def _pair_form(self, globals=None):
        return pairfuncs.lj_sw_rf_form(self.r_cut, self.r_switch, self.eps_rf,
                                       self.use_switch)

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)


@dataclasses.dataclass
class NearNonbondedForce(_PairForceMixin, Force):
    """Short-range RESPA force (atomsmm/forces.py::NearNonbondedForce):
    shifted-force LJ + Coulomb switched to zero over [r_switch, r_cut];
    negated with subtract=True (the "minus near" half of the far force).
    Undamped only (alpha = 0): damping belongs to the PME slice."""

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

    def __post_init__(self):
        if float(self.alpha) != 0.0:
            raise NotImplementedError(pairfuncs._PME_SLICE)

    def _per_particle(self, globals=None):
        return {"charge": self.charge, "sigma": self.sigma,
                "epsilon": self.epsilon}

    def _pair_fn(self, globals=None):
        r_cut, r_switch, subtract = self.r_cut, self.r_switch, self.subtract

        def pair(r, pi, pj):
            sigma, epsilon = _combine(pi, pj)
            return pairfuncs.near_pair_energy(
                r, sigma, epsilon, pi["charge"] * pj["charge"], 0.0,
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
    pass over the full cutoff, so near + far == full."""

    full: NonbondedForce = None
    minus_near: NearNonbondedForce = None

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
        return self._nb_energy(x, box, globals, aux, self.full.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.full.r_cut)


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
