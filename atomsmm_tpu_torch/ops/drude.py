"""Drude-oscillator polarizability: charge-on-spring induced dipoles
(counterpart of atomsmm_tpu/ops/drude.py).

A Drude oscillator attaches a light charged satellite particle to a
polarizable core with a harmonic spring; the satellite's displacement in
the local electric field produces the induced dipole,

    U_spring = 1/2 k |x_D - x_C|^2,    mu = q_D * d,    alpha = kC q_D^2 / k,

with kC = ONE_4PI_EPS0, so the spring constant comes from the atomic
polarizability alpha [nm^3] and the Drude charge q_D [e]. The Drude
particle is an ordinary charged particle in every nonbonded force; this
module adds the two terms that are specific to polarizability:

  * the core-Drude restoring springs (isotropic), and
  * Thole dipole-dipole screening between bonded-neighbor dipoles whose
    bare Coulomb interaction is excluded: each screened pair contributes
    the four core/Drude site-site terms with the dipole charges
    (+-q_D, +-q_D'), damped by

        f(u) = 1 - (1 + u/2) exp(-u),   u = a_ij * r / (alpha_i alpha_j)^(1/6).

The energies are PyTorch operations, differentiated by autograd.
`drude_scf_minimize` relaxes the Drude rows to the energy minimum with a
FORCE function: the pair kernels return forces, not a graph, so the port
has no gradient of the total energy to take (the JAX package passes an
energy function to jax.grad instead).

Examples: the spring constant reproduces the SWM4-NDP oxygen
polarizability, and the SCF fixed point in a uniform field is the analytic
induced dipole:

>>> import torch
>>> ds = make_drude_set([[1, 0]], charge=[-1.71636],
...                     polarizability=[9.7825e-4], dtype=torch.float64,
...                     device="cpu")  # nm^3 (0.97825 A^3)
>>> round(float(ds.k[0]))  # kJ/mol/nm^2 ~ 1000 kcal/mol/A^2
418389
>>> x = torch.zeros((2, 3), dtype=torch.float64)
>>> e_field = torch.tensor([0.0, 0.0, 50.0], dtype=torch.float64)
>>> def forces(xx):  # -dU/dx of the springs in the field, by autograd
...     xx = xx.detach().requires_grad_(True)
...     e = (drude_spring_energy(ds, xx)
...          + ds.charge[0] * torch.dot(e_field, xx[1]))
...     return -torch.autograd.grad(e, xx)[0]
>>> xs = drude_scf_minimize(forces, ds, x, n_iter=8)
>>> d_analytic = -float(ds.charge[0]) * 50.0 / float(ds.k[0])
>>> abs(float(xs[1, 2]) - d_analytic) <= 1e-12 * abs(d_analytic)
True
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..units import BOLTZMANN, ONE_4PI_EPS0
from ..utils import resolve_device
from .pbc import minimum_image


@dataclasses.dataclass
class DrudeSet:
    """pairs (D, 2) (drude, core) atom indices; charge (D,) Drude charge
    q_D [e]; alpha (D,) isotropic polarizability [nm^3]; k (D,) spring
    constant [kJ/mol/nm^2] = ONE_4PI_EPS0 q_D^2 / alpha; screened_pairs
    (S, 2) rows into the DIPOLE list (not atom indices) whose dipoles
    interact through Thole screening; thole (S,) combined screening factor
    a_ij. The index tensors are held as int64."""

    pairs: torch.Tensor = None
    charge: torch.Tensor = None
    alpha: torch.Tensor = None
    k: torch.Tensor = None
    screened_pairs: torch.Tensor = None
    thole: torch.Tensor = None

    def __post_init__(self):
        if self.pairs is not None:
            self.pairs = torch.as_tensor(self.pairs).long()
        if self.screened_pairs is not None:
            self.screened_pairs = torch.as_tensor(self.screened_pairs).long()

    @property
    def size(self) -> int:
        return 0 if self.pairs is None else self.pairs.shape[0]

    @property
    def num_screened(self) -> int:
        return (0 if self.screened_pairs is None
                else self.screened_pairs.shape[0])


def make_drude_set(pairs, charge, polarizability, screened_pairs=None,
                   thole=None, dtype=None, device=None) -> DrudeSet:
    """Build a DrudeSet on the host, then on `device` (default: the CUDA
    card; without one pass device="cpu") in `dtype`.

    pairs: (D, 2) (drude_index, core_index); charge: (D,) q_D [e];
    polarizability: (D,) alpha [nm^3]: the spring constant comes out as
    ONE_4PI_EPS0 q_D^2 / alpha in float64 (OpenMM's DrudeForce
    parametrization). screened_pairs: optional (S, 2) dipole-row pairs;
    thole: (S,) combined a_ij (a scalar broadcasts), required with
    screened_pairs.
    """
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    q = np.asarray(charge, np.float64).reshape(-1)
    a = np.asarray(polarizability, np.float64).reshape(-1)
    if q.shape[0] != pairs.shape[0] or a.shape[0] != pairs.shape[0]:
        raise ValueError("charge/polarizability must match pairs length")
    if np.any(a <= 0.0):
        raise ValueError("polarizability must be positive")
    k = ONE_4PI_EPS0 * q * q / a
    sp = th = None
    if screened_pairs is not None:
        sp = np.asarray(screened_pairs, np.int64).reshape(-1, 2)
        if thole is None:
            raise ValueError("screened_pairs requires thole factors")
        th = np.broadcast_to(
            np.asarray(thole, np.float64), (sp.shape[0],)).copy()

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return DrudeSet(
        pairs=torch.as_tensor(pairs, device=device),
        charge=t(q),
        alpha=t(a),
        k=t(k),
        screened_pairs=None if sp is None else torch.as_tensor(sp,
                                                               device=device),
        thole=None if th is None else t(th),
    )


def drude_displacements(ds: DrudeSet, x):
    """(D, 3) core->Drude displacement vectors (never minimum-imaged: a
    Drude particle stays within ~0.02 nm of its core)."""
    return (torch.index_select(x, 0, ds.pairs[:, 0])
            - torch.index_select(x, 0, ds.pairs[:, 1]))


def drude_spring_energy(ds: DrudeSet, x):
    """Sum of 1/2 k |x_D - x_C|^2 over all oscillators [kJ/mol]."""
    d = drude_displacements(ds, x)
    return 0.5 * torch.sum(ds.k * torch.sum(d * d, dim=-1))


def thole_screening_energy(ds: DrudeSet, x, box):
    """Thole-damped dipole-dipole energy over the screened pairs [kJ/mol].

    Per screened dipole pair (i, j): the four site-site Coulomb terms with
    the DIPOLE charges (+q_i on Drude_i, -q_i on core_i against +q_j on
    Drude_j, -q_j on core_j), each damped by f(u) = 1 - (1 + u/2) e^{-u},
    u = a_ij r / (alpha_i alpha_j)^{1/6}, over minimum-image distances."""
    if ds.num_screened == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    si = ds.screened_pairs[:, 0]
    sj = ds.screened_pairs[:, 1]
    qq = ds.charge[si] * ds.charge[sj]
    inv_screen = 1.0 / (ds.alpha[si] * ds.alpha[sj]) ** (1.0 / 6.0)
    a_ij = ds.thole

    di, ci = ds.pairs[si, 0], ds.pairs[si, 1]
    dj, cj = ds.pairs[sj, 0], ds.pairs[sj, 1]

    def term(ai, aj, sign):
        dx = minimum_image(torch.index_select(x, 0, ai)
                           - torch.index_select(x, 0, aj), box)
        r = torch.sqrt(torch.sum(dx * dx, dim=-1))
        u = a_ij * r * inv_screen
        f = 1.0 - (1.0 + 0.5 * u) * torch.exp(-u)
        return torch.sum(sign * qq * f / r)

    e = (term(di, dj, 1.0) + term(ci, cj, 1.0)
         + term(di, cj, -1.0) + term(ci, dj, -1.0))
    return ONE_4PI_EPS0 * e


def drude_scf_minimize(forces_fn, ds: DrudeSet, x, n_iter: int = 12):
    """Self-consistent Drude positions: relax the Drude rows of x to the
    energy minimum (Born-Oppenheimer induced dipoles; OpenMM's
    DrudeSCFIntegrator analog).

    Unlike the JAX package's version, which takes an ENERGY function and
    differentiates it with jax.grad, this one takes a FORCE function
    forces_fn(x) -> (N, 3) [kJ/mol/nm] (the pair kernels give forces, not
    a graph). The update is the spring-preconditioned fixed point

        x_D <- x_D + F_D / k,

    exact in one step for the isolated oscillator and contracting with
    ratio |field gradient| / k << 1 in condensed phase. It runs exactly
    n_iter iterations: no convergence test, so no host synchronisation.
    """
    idx = ds.pairs[:, 0]
    scale = (1.0 / ds.k)[:, None]
    for _ in range(n_iter):
        f = torch.index_select(forces_fn(x), 0, idx)
        x = x.index_add(0, idx, scale * f)
    return x


def drude_temperatures(ds: DrudeSet, v, masses, n_constraints: int = 0):
    """(T_atoms, T_drude) [K]: the dual-thermostat diagnostic.

    T_drude is the kinetic temperature of the core-Drude RELATIVE motion
    (reduced mass, 3 DoF per oscillator), the one the cold bath pins near
    1 K. T_atoms is the kinetic temperature of everything else: massive
    non-Drude particles plus each oscillator's centre-of-mass motion
    (total mass), with 3 DoF per entity minus `n_constraints` (SETTLE
    triples contribute 3 each; massless rows count no DoF). No -3 for COM
    removal: the Langevin baths do not conserve total momentum.
    """
    di, ci = ds.pairs[:, 0], ds.pairs[:, 1]
    md, mc = masses[di], masses[ci]
    m_tot = md + mc
    mu = md * mc / m_tot
    v_com = (md[:, None] * v[di] + mc[:, None] * v[ci]) / m_tot[:, None]
    v_rel = v[di] - v[ci]
    ke_rel = 0.5 * torch.sum(mu * torch.sum(v_rel * v_rel, dim=-1))
    t_drude = 2.0 * ke_rel / (3.0 * ds.size * BOLTZMANN)

    n = masses.shape[0]
    is_pair = torch.zeros((n,), dtype=torch.bool, device=masses.device)
    is_pair = is_pair.index_fill(0, di, True).index_fill(0, ci, True)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    w = torch.where(is_pair, zero, masses)
    ke_free = 0.5 * torch.sum(w * torch.sum(v * v, dim=-1))
    ke_com = 0.5 * torch.sum(m_tot * torch.sum(v_com * v_com, dim=-1))
    counts = torch.where(is_pair | (masses <= 0), zero, zero + 1.0)
    n_free = torch.sum(counts)
    dof = 3.0 * (n_free + ds.size) - n_constraints
    t_atoms = 2.0 * (ke_free + ke_com) / (dof * BOLTZMANN)
    return t_atoms, t_drude
