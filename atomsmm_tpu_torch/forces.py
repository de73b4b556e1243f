"""Force objects (counterpart of atomsmm_tpu/forces.py).

Each force is a dataclass whose `energy(x, box, globals, aux)` method is a
PyTorch function of the positions; the `group` integer drives the RESPA
split exactly as in the JAX package. Nonbonded forces have three paths:

  * dense — the chunked O(N²) sum (ops/pairs.py), on any device, forces
    by autograd; used for goldens, for 'nocutoff' and when no neighbor
    list is attached;
  * cell list — the half- or full-stencil sweep (ops/neighbors.py), with
    explicit forces from `energy_and_forces`; on the card it runs a CUDA
    kernel, which takes a built-in pair form (`_pair_form`) instead of a
    traced Python pair function. A force with no built-in form (the user
    pair function of CustomNonbondedForce) runs through the callable cell
    sweep instead: the same slots as torch operations, forces by autograd;
  * block list — an aux entry with candidate blocks ("cand", a System
    with a BlockNeighborSpec) sends the sweep to ops/blocks.py: K4 on the
    card for a built-in form, the callable block sweep for a pair
    function; a spatial mesh takes no block list (InputError).

PME (method 'pme') splits each Coulomb pair into the damped direct-space
term, which the pair kernels evaluate (ops/pairfuncs.py, LJ_SW_EWALD), and
the reciprocal sum with its self and excluded-pair corrections
(ops/pme.py), whose forces are explicit on both paths.

Alchemical parameters (lambda_vdw, lambda_coul and the like) arrive in
`globals`. Each force gives its own energy's lambda derivative,
`denergy_dlambda` (alchemy.ti_gradient): by autograd where the energy is
torch operations, by the softcore form's dlambda twin on the kernels, and
by an exact quadratic rule for the charge-scaled forces.

Each force also gives its virial, `virial` -> (W, forces) with
W = -dU(s x, s box)/ds at s = 1 (computers.py): by one autograd pass where
the energy is torch operations, as the JAX package takes it with jax.grad,
and by the pair form's virial flag on the kernels, which return numbers,
not a graph (a pair's -dU/ds is its d . F).

A stack of K systems (replicas or lambda states: x (K, N, 3), box (K, 3)
or (K, 3, 3), each global either shared or a (K,) tensor of per-row
values, the neighbor buckets (K, ncells, cap)) is evaluated by
`energy_rows` -> (K,) and `energy_and_forces_rows` -> ((K,), (K, N, 3)).
The forces that config 3b and the multistate rows build do it in one
batched evaluation: the pair forces with a built-in form (NonbondedForce,
with per-row scaled charges, NearNonbondedForce, DampedSmoothedForce,
SoftcoreLennardJonesForce, with per-row lambdas) in one launch of their
kernel over every row, the bonded terms (HarmonicBondForce,
HarmonicAngleForce, PeriodicTorsionForce, HarmonicImproperForce,
NonbondedExceptionsForce) as torch operations over the stack, forces by
autograd of the rows' sum (the rows are independent, so each row's
gradient is its own force). Every other force evaluates the rows one
after another (the base class's `energy_rows`): the PME reciprocal sum
and corrections, FarNonbondedForce, CustomNonbondedForce,
CustomBondForce, TemplateBondedForce, CMAPTorsionForce, DrudeForce;
those rows still run on the kernels, one launch each.

Force fields whose LJ matrix is not Lorentz-Berthelot (NBFIX ion-pair
rows, read from an Amber prmtop by io/amber.py) give NonbondedForce and
NearNonbondedForce per-type-pair tables: the atoms' LJ types `lj_type` and
(T, T) `pair_sigma` / `pair_epsilon`, and NonbondedForce the legacy 10-12
coefficients `pair_a1012` / `pair_b1012`. Each such force builds one
contiguous (T, T, 4) table [sigma, epsilon, A, B] on its device, in the
dtype of its sigma, which the kernels read a pair's row from (the table
forms of ops/pairfuncs.py); the dense path gathers from the same tables.

Ported: NonbondedForce (methods 'cutoff', 'pme', and 'nocutoff' on the
dense path, with the charge-scale mask of SolvationSystem, NBFIX tables and
the 10-12 term),
NearNonbondedForce (damped or not), FarNonbondedForce (fused, or in two
sweeps where its halves cannot fuse), PMEReciprocalForce,
NonbondedExceptionsForce, DampedSmoothedForce, SoftcoreLennardJonesForce,
CustomNonbondedForce, CustomBondForce, TemplateBondedForce,
HarmonicBondForce, HarmonicAngleForce, PeriodicTorsionForce,
HarmonicImproperForce, CMAPTorsionForce, DrudeForce and the
MonteCarloBarostat marker.

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
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .ops import pairfuncs, pme
from .ops.bonded import (
    harmonic_angle_energy,
    harmonic_bond_energy,
    harmonic_improper_energy,
    periodic_torsion_energy,
)
from .ops.cmap import cmap_energy
from .ops.drude import drude_spring_energy, thole_screening_energy
from .ops.neighbors import (
    cell_pair_energy,
    cell_pair_energy_fn,
    cell_pair_energy_forces,
)
from .ops.pairs import dense_pair_energy, pairlist_energy
from .ops.pbc import box_volume
from .ops.switching import switch_quintic
from .units import ONE_4PI_EPS0
from .utils import InputError

_METHODS = ("cutoff", "pme", "nocutoff")


def globals_row(globals, k: int):
    """Row k's globals from a stack's: each (K,) tensor at row k, every
    other value (a float, a 0-d tensor) shared as it is."""
    return {name: v[k] if isinstance(v, torch.Tensor) and v.ndim == 1
            else v for name, v in (globals or {}).items()}


def aux_row(aux, k: int):
    """Row k's aux from a stack's: each entry's (K, ncells, cap) bucket
    at row k (a block list's (K, NB B) order and (K, NB, K_c) candidate
    blocks)."""
    if not aux:
        return aux
    return {name: {key: v[k] if key in _ROW_KEYS else v
                   for key, v in a.items()} for name, a in aux.items()}


def aux_rows(aux, k: int):
    """A single system's aux for a stack of k rows that share its lists:
    each entry's lists expanded to a leading row axis (stride 0)."""
    if not aux:
        return aux
    return {name: {key: v.expand(k, *v.shape) if key in _ROW_KEYS else v
                   for key, v in a.items()} for name, a in aux.items()}


#: the per-row entries of an aux entry (the rest, the spec, is shared)
_ROW_KEYS = ("bucket", "cand")


def _in_turn(fn, x, box, globals, aux, *args):
    """fn(x, box, globals, aux, *args) -> energy or (energy, forces) of one
    system, over the rows of a stack one after another: ((K,) energies,
    (K, N, 3) forces or None). A stack on block lists (ops/blocks.py) takes
    this path for its pair forces: K4 sweeps one row a launch."""
    outs = [fn(x[k], box[k], globals_row(globals, k), aux_row(aux, k), *args)
            for k in range(x.shape[0])]
    if isinstance(outs[0], tuple):
        return torch.stack([o[0] for o in outs]), torch.stack(
            [o[1] for o in outs])
    return torch.stack(outs), None


def _row_by_row(force, x, box, globals, aux, with_forces):
    """(energies (K,), forces (K, N, 3) or None) of a stack, one row after
    another through the force's single-system evaluators."""
    from .potential import _energy_and_forces

    fn = (lambda *a: _energy_and_forces(force, *a)) if with_forces \
        else force.energy
    return _in_turn(fn, x, box, globals, aux)


def _rows_by_autograd(energy_rows, x):
    """((K,) energies, (K, N, 3) forces) of a stack whose energies are
    torch operations of x: one backward pass of the rows' sum."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        e = energy_rows(xx)
        if not e.requires_grad:
            return e.detach(), torch.zeros_like(x)
        (g,) = torch.autograd.grad(e.sum(), xx)
    return e.detach(), -g


def _resolve_neighbors(aux, key: str):
    """Aux entry ({'spec', 'bucket'}) for this force's neighbor structure,
    falling back to the default one; None -> dense path."""
    if not aux:
        return None
    return aux.get(key) or aux.get("default")


# the reciprocal path the most recent PME evaluation took (_pme_reciprocal)
_RECIPROCAL_DISPATCH = {"path": None}


def last_reciprocal_dispatch():
    """'slab_fft' | 'atom_sharded_psum' | 'single_device' | None: the
    reciprocal-space path the most recent PME evaluation took."""
    return _RECIPROCAL_DISPATCH["path"]


def _pme_reciprocal(x, box, q, alpha, grid_shape, order, with_forces=True):
    """(E, forces or None) of the reciprocal PME sum, sharded over the
    active spatial mesh when one is set (parallel/spatial.py), else on
    this device (ops/pme.py). On a mesh the slab FFT runs whenever the
    rank count divides K1 and K2, else the atom-sharded sum with one grid
    all_reduce (atomsmm_tpu/forces.py::_pme_reciprocal)."""
    active = _spatial()
    if active is not None:
        from .parallel import spatial
        from .parallel.mesh import mesh_group

        d = mesh_group(*active)[1]
        slab = grid_shape[0] % d == 0 and grid_shape[1] % d == 0
        _RECIPROCAL_DISPATCH["path"] = "slab_fft" if slab \
            else "atom_sharded_psum"
        fn = (spatial.sharded_pme_reciprocal_energy_fft if slab
              else spatial.sharded_pme_reciprocal_energy)
        return fn(x, box, q, alpha, grid_shape, *active, order=order,
                  with_forces=with_forces)
    _RECIPROCAL_DISPATCH["path"] = "single_device"
    if with_forces:
        return pme.pme_reciprocal_energy_forces(x, box, q, alpha, grid_shape,
                                                order)
    return pme.pme_reciprocal_energy(x, box, q, alpha, grid_shape, order), None


def _lj_combiner(pair_sigma, pair_epsilon):
    """The LJ combination rule of a pair function: Lorentz-Berthelot from
    the per-particle (sigma, epsilon), or, with per-type-pair NBFIX
    tables, a gather on (lj_type_i, lj_type_j)
    (atomsmm_tpu/forces.py::_lj_combiner)."""
    if pair_sigma is None:
        def combine(pi, pj):
            return pairfuncs.lorentz_berthelot(pi["sigma"], pj["sigma"],
                                               pi["epsilon"], pj["epsilon"])
        return combine

    n_types = pair_sigma.shape[0]
    tab_s = pair_sigma.reshape(-1)
    tab_e = pair_epsilon.reshape(-1)

    def combine(pi, pj):
        idx = pi["lj_type"].long() * n_types + pj["lj_type"].long()
        return tab_s[idx], tab_e[idx]

    return combine


_combine = _lj_combiner(None, None)


def _type_lorentz_berthelot(force, n_types):
    """(T, T) sigma and epsilon tables combined by Lorentz-Berthelot from
    the per-atom (sigma, epsilon) of each LJ type, in the dtype of sigma,
    as the kernels combine a pair: 0.5 (s_i + s_j) and sqrt(e_i e_j).
    None where two atoms of one type differ in sigma or epsilon (no
    per-type table holds them). One host read of the columns."""
    t = torch.as_tensor(force.lj_type).long().cpu()
    sig = torch.as_tensor(force.sigma).cpu()
    eps = torch.as_tensor(force.epsilon).cpu().to(sig.dtype)
    sig_t = sig.new_zeros(n_types).index_copy_(0, t, sig)
    eps_t = sig.new_zeros(n_types).index_copy_(0, t, eps)
    if not (torch.equal(sig_t[t], sig) and torch.equal(eps_t[t], eps)):
        return None
    return (0.5 * (sig_t[:, None] + sig_t[None, :]),
            torch.sqrt(eps_t[:, None] * eps_t[None, :]))


def _pair_table(force, a1012=None, b1012=None):
    """The (T, T, 4) [sigma, epsilon, A, B] table of a force with NBFIX
    tables, contiguous, on the device and in the dtype of its sigma; None
    without tables. The 10-12 coefficients without NBFIX tables (the JAX
    package combines sigma and epsilon by Lorentz-Berthelot and reads A
    and B by type) take a table whose sigma and epsilon are combined from
    each type's atoms where every atom of a type shares them; else None,
    and the force runs on the dense path of the CPU only
    (NonbondedForce._dense_only)."""
    if force.pair_sigma is None:
        if a1012 is None:
            return None
        if force.lj_type is None:
            raise InputError(
                f"{type(force).__name__}: pair_a1012/pair_b1012 need the "
                "LJ types lj_type (A and B are per type pair)")
        combined = _type_lorentz_berthelot(force, a1012.shape[0])
        if combined is None:
            return None
        pair_sigma, pair_epsilon = combined
    else:
        if force.lj_type is None or force.pair_epsilon is None:
            raise InputError(f"{type(force).__name__}: pair_sigma needs "
                             "pair_epsilon and lj_type")
        pair_sigma, pair_epsilon = force.pair_sigma, force.pair_epsilon
    ref = torch.as_tensor(pair_sigma if force.sigma is None
                          else force.sigma)
    cols = [pair_sigma, pair_epsilon]
    cols += [torch.zeros_like(torch.as_tensor(pair_sigma))] * 2 \
        if a1012 is None else [a1012, b1012]
    return torch.stack([torch.as_tensor(c, device=ref.device).to(ref.dtype)
                        for c in cols], -1).contiguous()


def _with_table(pp, force):
    """The per-particle dict `pp` with the LJ types and the type-pair table
    of `force` (a force with NBFIX tables)."""
    if force._table is not None:
        pp["lj_type"] = force.lj_type
        pp["pair_table"] = force._table
    return pp


def _form_with_table(form, force, hbond=False):
    """`form` reading the type-pair table, when `force` has one."""
    if force._table is None:
        return form
    return pairfuncs.table_form(form, hbond=hbond)


def autograd_virial(energy, x, box):
    """(W, forces) of energy(x, box) by one backward pass: the virial
    W = -dU(s x, s box)/ds at s = 1 and the forces -dU/dx."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    with torch.enable_grad():
        s = torch.ones((), dtype=x.dtype, device=x.device, requires_grad=True)
        xx = x.detach().requires_grad_(True)
        e = energy(s * xx, s * box)
        if not (isinstance(e, torch.Tensor) and e.requires_grad):
            return zero, torch.zeros_like(x)
        ds, gx = torch.autograd.grad(e, (s, xx), allow_unused=True)
    return (zero if ds is None else -ds,
            torch.zeros_like(x) if gx is None else -gx)


@dataclasses.dataclass
class Force:
    """Base force: subclasses define energy(x, box, globals, aux) -> scalar.

    Subclasses with an explicit force formula also define
    energy_and_forces(x, box, globals, aux) -> (scalar, (N, 3)); the others
    are differentiated by potential.force_fn."""

    group: int = 0
    #: a marker that adds no energy and no force (MonteCarloBarostat): the
    #: evaluators of a step skip it
    inert = False

    @property
    def name(self) -> str:
        return type(self).__name__

    def energy(self, x, box, globals, aux=None):  # pragma: no cover - abstract
        raise NotImplementedError

    def uses_neighbors(self) -> bool:
        """Whether the force reads a neighbor list from aux."""
        return False

    def denergy_dlambda(self, x, box, globals, name, aux=None):
        """d energy / d globals[name] at this configuration (a missing
        parameter reads as 1.0). The default differentiates energy() by
        torch autograd with lambda as a 0-d tensor, which is exact for a
        force made of torch operations; a force that hands lambda to a
        kernel as a host scalar overrides it."""
        g = dict(globals or {})
        lam = torch.as_tensor(g.get(name, 1.0), dtype=x.dtype,
                              device=x.device).detach().clone()
        g[name] = lam.requires_grad_(True)
        with torch.enable_grad():
            e = self.energy(x.detach(), box, g, aux)
            if not e.requires_grad:
                return torch.zeros((), dtype=x.dtype, device=x.device)
            (d,) = torch.autograd.grad(e, lam, allow_unused=True)
        return torch.zeros((), dtype=x.dtype, device=x.device) \
            if d is None else d


    def virial(self, x, box, globals, aux=None):
        """(W, forces): W = -dU(s x, s box)/ds at s = 1, the isotropic
        virial, and the forces. The default takes both by autograd of
        energy(), which is exact for a force made of torch operations; a
        force whose energy comes from a kernel overrides it."""
        return autograd_virial(
            lambda xx, bb: self.energy(xx, bb, globals, aux), x, box)

    def energy_rows(self, x, box, globals, aux=None):
        """(K,) energies of a stack (module docstring). The default runs
        the rows one after another through energy()."""
        return _row_by_row(self, x, box, globals, aux, False)[0]

    def energy_and_forces_rows(self, x, box, globals, aux=None):
        """((K,) energies, (K, N, 3) forces) of a stack. The default runs
        the rows one after another."""
        return _row_by_row(self, x, box, globals, aux, True)


class _StackedTerms:
    """A force whose energy() is torch operations that take a stack as
    they take one system (gathers along the atom axis, sums over the
    last): the rows in one evaluation, forces by autograd of their sum."""

    def energy_rows(self, x, box, globals, aux=None):
        return self.energy(x, box, globals, aux)

    def energy_and_forces_rows(self, x, box, globals, aux=None):
        return _rows_by_autograd(
            lambda xx: self.energy(xx, box, globals, aux), x)


def _charge_scaled_dlambda(force, scaled, x, box, globals, name, aux):
    """dU/dlambda of a charge-scaled force (`scaled` holds its mask and the
    mask's parameter name): zero unless `name` scales the charges; else
    from U(0), U(1/2) and U(1), exactly, since the charges enter only as
    products of q_i (1 - m_i (1 - lambda)) and U = a + b lambda + c
    lambda²."""
    if scaled.charge_scale_mask is None or name != scaled.charge_scale_name:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    g = dict(globals or {})
    lam = g.get(name, 1.0)
    u0, uh, u1 = (force.energy(x, box, {**g, name: v}, aux)
                  for v in (0.0, 0.5, 1.0))
    b = 4.0 * uh - 3.0 * u0 - u1
    c = 2.0 * (u1 + u0 - 2.0 * uh)
    return b + 2.0 * c * torch.as_tensor(lam, dtype=x.dtype, device=x.device)


def _spatial():
    """The active spatial mesh (parallel/mesh.py) as (mesh, axis), or
    None."""
    from .parallel.mesh import active_spatial_mesh

    return active_spatial_mesh()


def _blocks(nbr) -> bool:
    """Whether an aux entry is a block list (ops/blocks.py), which no
    spatial mesh takes."""
    if "cand" not in nbr:
        return False
    if _spatial() is not None:
        raise InputError(
            "a block list (BlockNeighborSpec) cannot run under a spatial "
            "mesh: the sharded sweep takes cell buckets (the JAX package "
            "sends the block order to its cell-sharded sweep); attach a "
            "NeighborSpec for SpatialContext")
    return True


def _cell_energy(pair, x, box, pp, nbr, r_cut):
    """The energy of `pair` (a built-in PairForm, or a pair function) over
    the neighbor list: the block sweep (K4, or the callable block sweep)
    for a block list, sharded over the active spatial mesh when one is set
    (parallel/spatial.py), else K1 or K2 as the spec selects, or the
    callable sweep."""
    if _blocks(nbr):
        from .ops import blocks

        sweep = (blocks.block_pair_energy
                 if isinstance(pair, pairfuncs.PairForm)
                 else blocks.block_pair_energy_fn)
        return sweep(pair, x, box, pp, nbr["spec"], nbr["bucket"],
                     nbr["cand"], r_cut)
    mesh = _spatial()
    if mesh is not None:
        from .parallel.spatial import sharded_cell_pair_energy

        return sharded_cell_pair_energy(pair, x, box, pp, nbr["spec"],
                                        nbr["bucket"], r_cut, *mesh)
    sweep = (cell_pair_energy if isinstance(pair, pairfuncs.PairForm)
             else cell_pair_energy_fn)
    return sweep(pair, x, box, pp, nbr["spec"], nbr["bucket"], r_cut)


class _PairForceMixin:
    """Shared dense/cell dispatch for pair forces. Subclasses provide
    _pair_fn(globals) -> (r, pi, pj) -> energy (dense path, and the
    callable cell sweep), _per_particle() and, for a built-in form of the
    kernels, _pair_form(globals) -> PairForm (cell path). A force without
    _pair_form evaluates its pair function over the cell list as torch
    operations (ops/neighbors.py::cell_pair_energy_fn), forces by
    autograd. Under an active spatial mesh (parallel/mesh.py) every cell
    path runs sharded over the mesh's ranks, on the full stencil
    (parallel/spatial.py)."""

    neighbor_key = "default"

    #: no built-in form and no cell path: the dense path, on the CPU only
    #: (NonbondedForce's 10-12 term without a per-type table)
    _dense_only = False

    def _cell(self, aux, r_cut):
        """The neighbor entry the cell path takes, or None (dense)."""
        nbr = _resolve_neighbors(aux, self.neighbor_key)
        return nbr if nbr is not None and math.isfinite(r_cut) \
            and not self._dense_only else None

    def _cell_pair(self, globals):
        """(the pair the cell path sweeps: the built-in form or the pair
        function, its per-particle columns)."""
        pp = self._per_particle(globals)
        if hasattr(self, "_pair_form"):
            return self._pair_form(globals), pp
        # a pair function gathers (N,) columns per pair: the type-pair
        # table rides its closure (_lj_combiner), not the dict
        return (self._pair_fn(globals),
                {k: v for k, v in pp.items() if k != "pair_table"})

    def _nb_energy(self, x, box, globals, aux, r_cut):
        nbr = self._cell(aux, r_cut)
        if nbr is None:
            if self._dense_only and x.is_cuda:
                raise InputError(
                    f"{type(self).__name__}: the 10-12 term with atoms of "
                    "one LJ type that differ in sigma or epsilon has no "
                    "type-pair table for the kernels; it runs on the dense "
                    "path of the CPU only (give every atom of a type the "
                    "same sigma and epsilon, or pass NBFIX tables)")
            pp = {k: v for k, v in self._per_particle(globals).items()
                  if k != "pair_table"}
            return dense_pair_energy(self._pair_fn(globals), x, box, pp,
                                     self.exclusions, r_cut, chunk=self.chunk)
        pair, pp = self._cell_pair(globals)
        return _cell_energy(pair, x, box, pp, nbr, r_cut)

    def _nb_energy_forces(self, x, box, globals, aux, r_cut):
        nbr = self._cell(aux, r_cut)
        blocks = nbr is not None and _blocks(nbr)
        if blocks and hasattr(self, "_pair_form"):
            from .ops.blocks import block_pair_energy_forces

            return block_pair_energy_forces(
                self._pair_form(globals), x, box, self._per_particle(globals),
                nbr["spec"], nbr["bucket"], nbr["cand"], r_cut)
        mesh = _spatial() if nbr is not None and not blocks else None
        if mesh is not None:
            from .parallel.spatial import sharded_cell_pair_energy_forces

            pair, pp = self._cell_pair(globals)
            return sharded_cell_pair_energy_forces(
                pair, x, box, pp, nbr["spec"], nbr["bucket"], r_cut, *mesh)
        if nbr is not None and hasattr(self, "_pair_form"):
            return cell_pair_energy_forces(
                self._pair_form(globals), x, box, self._per_particle(globals),
                nbr["spec"], nbr["bucket"], r_cut)
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            e = self._nb_energy(xx, box, globals, aux, r_cut)
            (g,) = torch.autograd.grad(e, xx)
        return e.detach(), -g

    def _nb_virial(self, x, box, globals, aux, r_cut):
        """(W, forces) of the pair term: on the cell path with a built-in
        form one sweep of its virial form (the energy column carries each
        pair's d . F), else by autograd."""
        nbr = self._cell(aux, r_cut)
        blocks = nbr is not None and _blocks(nbr)
        if blocks and hasattr(self, "_pair_form"):
            from .ops.blocks import block_pair_energy_forces

            return block_pair_energy_forces(
                pairfuncs.virial_form(self._pair_form(globals)), x, box,
                self._per_particle(globals), nbr["spec"], nbr["bucket"],
                nbr["cand"], r_cut)
        mesh = _spatial() if nbr is not None and not blocks else None
        if mesh is not None:
            from .parallel.spatial import sharded_cell_pair_virial

            pair, pp = self._cell_pair(globals)
            return sharded_cell_pair_virial(
                pair, x, box, pp, nbr["spec"], nbr["bucket"], r_cut, *mesh)
        if nbr is not None and hasattr(self, "_pair_form"):
            return cell_pair_energy_forces(
                pairfuncs.virial_form(self._pair_form(globals)), x, box,
                self._per_particle(globals), nbr["spec"], nbr["bucket"],
                r_cut)
        return autograd_virial(
            lambda xx, bb: self._nb_energy(xx, bb, globals, aux, r_cut), x,
            box)

    def virial(self, x, box, globals, aux=None):
        return self._nb_virial(x, box, globals, aux, self.r_cut)

    def _rows_form(self, globals):
        """(the built-in form of a sweep over a stack, the rows' softcore
        lambdas (K,) or None)."""
        return self._pair_form(globals), None

    def _nb_rows(self, x, box, globals, aux, r_cut, with_forces):
        """(energies (K,), forces (K, N, 3) or None) of the pair term of a
        stack from one sweep over every row (per-particle columns (N,) or,
        where a global scales them per row, (K, N)); the pair term of one
        row after another where no kernel takes the stack (the dense path,
        a pair function, a spatial mesh, a block list: K4 has no row
        axis)."""
        nbr = self._cell(aux, r_cut)
        if nbr is None or not hasattr(self, "_pair_form") \
                or _spatial() is not None or "cand" in nbr:
            return _in_turn(self._nb_energy_forces if with_forces
                            else self._nb_energy, x, box, globals, aux, r_cut)
        form, lamb = self._rows_form(globals)
        if lamb is not None:  # the kernels read it in the dtype of x
            lamb = lamb.to(device=x.device, dtype=x.dtype)
        args = (form, x, box, self._per_particle(globals), nbr["spec"],
                nbr["bucket"], r_cut)
        if with_forces:
            return cell_pair_energy_forces(*args, lamb=lamb)
        return cell_pair_energy(*args, lamb=lamb), None

    def energy_rows(self, x, box, globals, aux=None):
        return self._nb_rows(x, box, globals, aux, self.r_cut, False)[0]

    def energy_and_forces_rows(self, x, box, globals, aux=None):
        return self._nb_rows(x, box, globals, aux, self.r_cut, True)

    def uses_neighbors(self) -> bool:
        return True


@dataclasses.dataclass
class NonbondedForce(_PairForceMixin, Force):
    """Full LJ + Coulomb nonbonded force with per-particle (charge, sigma,
    epsilon), Lorentz-Berthelot combining (or NBFIX type-pair tables) and
    exclusions. Cutoff scalars are host floats.

    method:
      'nocutoff' - plain LJ + Coulomb over all pairs (dense path only)
      'cutoff'   - switched LJ + reaction-field Coulomb within r_cut
      'pme'      - switched LJ + PME Coulomb: the damped direct-space pair
                   term (the pair kernels), the reciprocal sum and the
                   self/exclusion corrections (ops/pme.py)

    dispersion_coeff adds the long-range LJ tail coeff / V (no force at
    fixed volume; compute_dispersion_coefficient). charge_scale_mask (N,)
    {0, 1} scales the masked (solute) charges by globals[charge_scale_name]
    (SolvationSystem); every place the charges reach takes the scaled ones:
    the pair sweep, the PME corrections and the reciprocal sum.

    With NBFIX tables (lj_type, pair_sigma, pair_epsilon) each pair takes
    its (sigma, epsilon) from the tables; pair_a1012 / pair_b1012 add the
    legacy 10-12 term A/r^12 - B/r^10 to the LJ term before the switch.
    Without NBFIX tables the 10-12 term reads A and B by lj_type and
    combines sigma and epsilon by Lorentz-Berthelot, through a table built
    from the types where every atom of a type shares them; otherwise
    through the dense path on the CPU, and it raises on the card."""

    charge: torch.Tensor = None
    sigma: torch.Tensor = None
    epsilon: torch.Tensor = None
    exclusions: torch.Tensor = None  # (N, M) int32, padded with -1
    r_cut: float = 1.0
    r_switch: float = 0.9
    eps_rf: float = 1e15
    charge_scale_mask: torch.Tensor = None  # (N,) {0, 1}: scaled charges
    charge_scale_name: str = "lambda_coul"
    dispersion_coeff: float = None
    ewald_alpha: float = 0.0
    method: str = "cutoff"
    use_switch: bool = True
    grid_shape: Tuple[int, int, int] = (0, 0, 0)
    spline_order: int = 4
    chunk: int = 256
    lj_type: torch.Tensor = None       # (N,) int32, set with the tables
    pair_sigma: torch.Tensor = None    # (T, T) per-type-pair sigma [nm]
    pair_epsilon: torch.Tensor = None  # (T, T) [kJ/mol]
    pair_a1012: torch.Tensor = None    # (T, T) 10-12 A [kJ/mol nm^12]
    pair_b1012: torch.Tensor = None    # (T, T) 10-12 B [kJ/mol nm^10]

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(f"NonbondedForce(method={self.method!r}): "
                             f"expected one of {_METHODS}")
        self._table = _pair_table(self, self.pair_a1012, self.pair_b1012)
        self._dense_only = self.pair_a1012 is not None and self._table is None

    def _effective_charge(self, globals=None):
        """Per-particle charge, the masked (solute) charges scaled by
        globals[charge_scale_name] (1.0 when missing)."""
        return _scaled_charge(self.charge, self.charge_scale_mask,
                              self.charge_scale_name, globals)

    def _per_particle(self, globals=None):
        pp = _with_table({"charge": self._effective_charge(globals),
                          "sigma": self.sigma, "epsilon": self.epsilon}, self)
        if self._dense_only:  # the pair function reads A and B by type
            pp["lj_type"] = self.lj_type
        return pp

    def _pair_fn(self, globals=None):
        method, use_switch = self.method, self.use_switch
        r_cut, r_switch, eps_rf = self.r_cut, self.r_switch, self.eps_rf
        alpha = float(self.ewald_alpha)
        combine = _lj_combiner(self.pair_sigma, self.pair_epsilon)
        hb_a, hb_b = self.pair_a1012, self.pair_b1012
        if hb_a is not None:
            n_types_hb = hb_a.shape[0]
            hb_a_flat, hb_b_flat = hb_a.reshape(-1), hb_b.reshape(-1)

        def pair(r, pi, pj):
            sigma, epsilon = combine(pi, pj)
            qq = pi["charge"] * pj["charge"]
            u_lj = pairfuncs.lj(r, sigma, epsilon)
            if hb_a is not None:
                # the legacy 10-12 term, inside the LJ switch
                idx = pi["lj_type"].long() * n_types_hb + pj["lj_type"].long()
                u_lj = u_lj + pairfuncs.hbond_10_12(r, hb_a_flat[idx],
                                                    hb_b_flat[idx])
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
        if self._dense_only:
            raise InputError(
                "NonbondedForce: the 10-12 term with atoms of one LJ type "
                "that differ in sigma or epsilon has no kernel form (no "
                "type-pair table holds it)")
        if self.method == "pme":
            form = pairfuncs.lj_sw_ewald_form(self.r_cut, self.r_switch,
                                              self.ewald_alpha,
                                              self.use_switch)
        elif self.method == "nocutoff":
            raise NotImplementedError(
                "NonbondedForce(method='nocutoff') runs on the dense path "
                "only: it has no pair-kernel form")
        else:
            form = pairfuncs.lj_sw_rf_form(self.r_cut, self.r_switch,
                                           self.eps_rf, self.use_switch)
        return _form_with_table(form, self, self.pair_a1012 is not None)

    @property
    def _pair_cutoff(self):
        return math.inf if self.method == "nocutoff" else self.r_cut

    def _recip_energy_forces(self, x, box, globals=None,
                             include_reciprocal=True):
        """(E, forces) of the PME terms outside the pair sweep at the
        scaled charges: the self/exclusion corrections and, unless a
        PMEReciprocalForce carries it, the reciprocal sum."""
        alpha = float(self.ewald_alpha)
        q = self._effective_charge(globals)
        e, f = pme.pme_corrections_forces(x, box, q, self.exclusions, alpha)
        if include_reciprocal:
            er, fr = _pme_reciprocal(x, box, q, alpha, self.grid_shape,
                                     self.spline_order)
            e, f = e + er, f + fr
        return e, f

    def _recip_energy(self, x, box, globals=None, include_reciprocal=True,
                      differentiable=False):
        """The PME terms' energy; `differentiable` keeps the reciprocal sum
        on this rank as one autograd graph (the virial's), never sharded."""
        alpha = float(self.ewald_alpha)
        q = self._effective_charge(globals)
        e = pme.pme_corrections(x, box, q, self.exclusions, alpha)
        if include_reciprocal:
            if differentiable:
                er = pme.pme_reciprocal_energy(x, box, q, alpha,
                                               self.grid_shape,
                                               self.spline_order)
            else:
                er, _ = _pme_reciprocal(x, box, q, alpha, self.grid_shape,
                                        self.spline_order, with_forces=False)
            e = e + er
        return e

    def _dispersion(self, box):
        if self.dispersion_coeff is None:
            return 0.0
        return self.dispersion_coeff / box_volume(box)

    def _outside_sweep_virial(self, x, box, globals, include_reciprocal=True):
        """(W, forces) of the terms outside the pair sweep, torch operations
        all: the PME reciprocal sum and corrections, the dispersion tail."""
        def energy(xx, bb):
            e = self._dispersion(bb)
            if self.method == "pme":
                e = e + self._recip_energy(xx, bb, globals, include_reciprocal,
                                           differentiable=True)
            return e

        return autograd_virial(energy, x, box)

    def energy(self, x, box, globals, aux=None):
        e = self._nb_energy(x, box, globals, aux, self._pair_cutoff)
        if self.method == "pme":
            e = e + self._recip_energy(x, box, globals)
        return e + self._dispersion(box)

    def virial(self, x, box, globals, aux=None):
        w, f = self._nb_virial(x, box, globals, aux, self._pair_cutoff)
        w2, f2 = self._outside_sweep_virial(x, box, globals)
        return w + w2, f + f2

    def energy_and_forces(self, x, box, globals, aux=None):
        e, f = self._nb_energy_forces(x, box, globals, aux, self._pair_cutoff)
        if self.method == "pme":
            e2, f2 = self._recip_energy_forces(x, box, globals)
            e, f = e + e2, f + f2
        return e + self._dispersion(box), f

    def denergy_dlambda(self, x, box, globals, name, aux=None):
        return _charge_scaled_dlambda(self, self, x, box, globals, name, aux)

    def _rows(self, x, box, globals, aux, with_forces):
        if self._cell(aux, self._pair_cutoff) is None:
            return _row_by_row(self, x, box, globals, aux, with_forces)
        e, f = self._nb_rows(x, box, globals, aux, self._pair_cutoff,
                             with_forces)
        if self.method == "pme":  # the reciprocal terms, row by row
            rows = [(self._recip_energy_forces if with_forces
                     else self._recip_energy)(x[k], box[k],
                                              globals_row(globals, k))
                    for k in range(x.shape[0])]
            if with_forces:
                e = e + torch.stack([r[0] for r in rows])
                f = f + torch.stack([r[1] for r in rows])
            else:
                e = e + torch.stack(rows)
        if self.dispersion_coeff is not None:
            e = e + self.dispersion_coeff / box_volume(box, rows=True)
        return e, f

    def energy_rows(self, x, box, globals, aux=None):
        return self._rows(x, box, globals, aux, False)[0]

    def energy_and_forces_rows(self, x, box, globals, aux=None):
        return self._rows(x, box, globals, aux, True)

    def uses_neighbors(self) -> bool:
        return self.method != "nocutoff"


def _scaled_charge(charge, mask, name, globals):
    """q (1 - m (1 - lambda)) with lambda = globals[name] (1.0 when
    missing): the charge scaling of SolvationSystem. A (K,) lambda, one per
    row of a stack, gives (K, N) charges, computed on the device from the
    tensor (no host read)."""
    if mask is None:
        return charge
    lam = (globals or {}).get(name, 1.0)
    if isinstance(lam, torch.Tensor) and lam.ndim == 1:
        lam = lam.to(charge.dtype)[:, None]
    return charge * (1.0 - mask * (1.0 - lam))


def _host64(a):
    return np.asarray(torch.as_tensor(a).detach().cpu(), np.float64)


def compute_dispersion_coefficient(sigma, epsilon, r_switch, r_cut,
                                   use_switch=True, n_quad=512, lj_type=None,
                                   pair_sigma=None, pair_epsilon=None):
    """Long-range LJ tail coefficient (openmm's dispersion correction),
    E_tail = coeff / V with coeff = 2 pi sum over pairs of the integral of
    r² (u - u_kept) dr: the full tail beyond r_cut plus what the switch
    removes on [r_switch, r_cut] (trapezoid quadrature), over the unique
    (sigma, epsilon) types, or, with NBFIX tables (lj_type, pair_sigma,
    pair_epsilon), over the LJ types with the tables' pair parameters.
    Host numpy, float64."""
    if pair_sigma is not None:
        t_idx = np.asarray(torch.as_tensor(lj_type).cpu(), np.int64)
        tab_s, tab_e = _host64(pair_sigma), _host64(pair_epsilon)
        counts = np.bincount(t_idx, minlength=tab_s.shape[0])
        types = None
    else:
        sig, eps = _host64(sigma), _host64(epsilon)
        types, counts = np.unique(np.stack([sig, eps], 1), axis=0,
                                  return_counts=True)
    rc, rs = float(r_cut), float(r_switch)
    total = 0.0
    for a in range(len(counts)):
        for b in range(len(counts)):
            if types is None:
                s_ab, e_ab = float(tab_s[a, b]), float(tab_e[a, b])
            else:
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
class NonbondedExceptionsForce(_StackedTerms, Force):
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
        return pairlist_energy(pair, x, box, self.pairs, params, self.valid,
                               rows=x.ndim == 3)


@dataclasses.dataclass
class NearNonbondedForce(_PairForceMixin, Force):
    """Short-range RESPA force (atomsmm/forces.py::NearNonbondedForce):
    shifted-force LJ + shifted-force Coulomb, damped by erfc(alpha r) when
    alpha != 0 (the PME split), switched to zero over [r_switch, r_cut];
    negated with subtract=True (the "minus near" half of the far force).
    With NBFIX tables (lj_type, pair_sigma, pair_epsilon) its pairs take
    their (sigma, epsilon) from them; it never takes the 10-12 term, as in
    the JAX package."""

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
    lj_type: torch.Tensor = None       # (N,) int32, set with the tables
    pair_sigma: torch.Tensor = None    # (T, T) per-type-pair sigma [nm]
    pair_epsilon: torch.Tensor = None  # (T, T) [kJ/mol]

    def __post_init__(self):
        self._table = _pair_table(self)

    def _per_particle(self, globals=None):
        return _with_table({"charge": self.charge, "sigma": self.sigma,
                            "epsilon": self.epsilon}, self)

    def _pair_fn(self, globals=None):
        r_cut, r_switch, subtract = self.r_cut, self.r_switch, self.subtract
        alpha = float(self.alpha)
        combine = _lj_combiner(self.pair_sigma, self.pair_epsilon)

        def pair(r, pi, pj):
            sigma, epsilon = combine(pi, pj)
            return pairfuncs.near_pair_energy(
                r, sigma, epsilon, pi["charge"] * pj["charge"], alpha,
                r_switch, r_cut, subtract=subtract)

        pair.takes_rv = True
        return pair

    def _pair_form(self, globals=None):
        return _form_with_table(pairfuncs.near_form(
            self.r_cut, self.r_switch, self.alpha, self.subtract), self)

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
    its own level) and the dispersion tail are added here.

    Where the halves cannot share one pair form the far force is the full
    force plus the near force in two sweeps (`_fusable`): under a
    charge-scale mask (AlchemicalRespaSystem: the full force takes the
    scaled charges, the near force the raw ones), with a PME full force
    whose near half is damped by another alpha (or not at all), and where
    the halves read different type-pair tables. near + far == full holds
    either way. `minus_near.subtract=False` adds the near force instead of
    subtracting it, as in the JAX package (the form's near sign)."""

    full: NonbondedForce = None
    minus_near: NearNonbondedForce = None
    include_reciprocal: bool = True

    def __post_init__(self):
        if self.full is None or self.minus_near is None:
            raise ValueError("FarNonbondedForce needs `full` and `minus_near`")
        # one host read here, none per evaluation
        ft, nt = self.full._table, self.minus_near._table
        self._same_tables = (ft is None and nt is None) or (
            ft is not None and nt is not None
            and torch.equal(ft[..., :2], nt[..., :2].to(ft))
            and torch.equal(self.full.lj_type,
                            self.minus_near.lj_type.to(self.full.lj_type)))

    @property
    def chunk(self):
        return self.full.chunk

    @property
    def exclusions(self):
        return self.full.exclusions

    def _fusable(self) -> bool:
        """Whether one sweep of the fused far form (pairfuncs.far_form)
        computes full + near: the halves share their charges, a PME full
        force's near half is damped by its alpha, and both read the same
        (sigma, epsilon), from one type-pair table or from none."""
        full = self.full
        return (full.charge_scale_mask is None and self._same_tables
                and (full.method != "pme"
                     or float(self.minus_near.alpha)
                     == float(full.ewald_alpha)))

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
        full = self.full
        if self._fusable():
            e = self._nb_energy(x, box, globals, aux, full._pair_cutoff)
        else:
            e = full._nb_energy(x, box, globals, aux, full._pair_cutoff) \
                + self.minus_near.energy(x, box, globals, aux)
        if full.method == "pme":
            e = e + full._recip_energy(x, box, globals,
                                       self.include_reciprocal)
        return e + full._dispersion(box)

    def energy_and_forces(self, x, box, globals, aux=None):
        full = self.full
        if self._fusable():
            e, f = self._nb_energy_forces(x, box, globals, aux,
                                          full._pair_cutoff)
        else:
            e, f = full._nb_energy_forces(x, box, globals, aux,
                                          full._pair_cutoff)
            e2, f2 = self.minus_near.energy_and_forces(x, box, globals, aux)
            e, f = e + e2, f + f2
        if full.method == "pme":
            e2, f2 = full._recip_energy_forces(x, box, globals,
                                               self.include_reciprocal)
            e, f = e + e2, f + f2
        return e + full._dispersion(box), f

    def virial(self, x, box, globals, aux=None):
        full = self.full
        if self._fusable():
            w, f = self._nb_virial(x, box, globals, aux, full._pair_cutoff)
        else:
            w, f = full._nb_virial(x, box, globals, aux, full._pair_cutoff)
            w2, f2 = self.minus_near.virial(x, box, globals, aux)
            w, f = w + w2, f + f2
        w2, f2 = full._outside_sweep_virial(x, box, globals,
                                            self.include_reciprocal)
        return w + w2, f + f2

    def denergy_dlambda(self, x, box, globals, name, aux=None):
        return _charge_scaled_dlambda(self, self.full, x, box, globals, name,
                                      aux)

    def uses_neighbors(self) -> bool:
        return True

    # no batched form yet: the rows one after another (Force's)
    energy_rows = Force.energy_rows
    energy_and_forces_rows = Force.energy_and_forces_rows


@dataclasses.dataclass
class PMEReciprocalForce(Force):
    """The PME reciprocal (FFT) sum as its own force group, for a third
    RESPA level (RESPASystem(..., reciprocal_level=True), beside
    FarNonbondedForce(include_reciprocal=False), which keeps the fast
    self/exclusion corrections). Forces are explicit (ops/pme.py)."""

    charge: torch.Tensor = None
    charge_scale_mask: torch.Tensor = None
    ewald_alpha: float = 3.0
    grid_shape: Tuple[int, int, int] = (0, 0, 0)
    spline_order: int = 4
    charge_scale_name: str = "lambda_coul"

    def _effective_charge(self, globals=None):
        return _scaled_charge(self.charge, self.charge_scale_mask,
                              self.charge_scale_name, globals)

    def energy(self, x, box, globals, aux=None):
        return _pme_reciprocal(x, box, self._effective_charge(globals),
                               float(self.ewald_alpha), self.grid_shape,
                               self.spline_order, with_forces=False)[0]

    def energy_and_forces(self, x, box, globals, aux=None):
        return _pme_reciprocal(
            x, box, self._effective_charge(globals), float(self.ewald_alpha),
            self.grid_shape, self.spline_order)

    def denergy_dlambda(self, x, box, globals, name, aux=None):
        return _charge_scaled_dlambda(self, self, x, box, globals, name, aux)


@dataclasses.dataclass
class DampedSmoothedForce(_PairForceMixin, Force):
    """Damped Coulomb + LJ, smoothed over [r_switch, r_cut]
    (atomsmm/forces.py::DampedSmoothedForce; Fennell & Gezelter JCP 2006,
    with the switch in place of the force shift)."""

    charge: torch.Tensor = None
    sigma: torch.Tensor = None
    epsilon: torch.Tensor = None
    exclusions: torch.Tensor = None
    r_cut: float = 1.0
    r_switch: float = 0.9
    alpha: float = 2.0
    chunk: int = 256

    def _per_particle(self, globals=None):
        return {"charge": self.charge, "sigma": self.sigma,
                "epsilon": self.epsilon}

    def _pair_fn(self, globals=None):
        r_cut, r_switch, alpha = self.r_cut, self.r_switch, float(self.alpha)

        def pair(r, pi, pj):
            sigma, epsilon = _combine(pi, pj)
            return pairfuncs.damped_smoothed_energy(
                r, sigma, epsilon, pi["charge"] * pj["charge"], alpha,
                r_switch, r_cut)

        pair.takes_rv = True
        return pair

    def _pair_form(self, globals=None):
        return pairfuncs.damped_smoothed_form(self.r_cut, self.r_switch,
                                              self.alpha)

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)


@dataclasses.dataclass
class SoftcoreLennardJonesForce(_PairForceMixin, Force):
    """Beutler softcore LJ between an interaction group (solute <->
    solvent), scaled by the global parameter `lambda_name`
    (atomsmm/forces.py::SoftcoreLennardJonesForce); a missing lambda reads
    as 1.0. `solute` is the (N,) {0, 1} indicator, and the constructor
    refuses any other value: on the cell path the kernels read it as
    2 solute - 1 in the charge column (ops/pairfuncs.py::softcore_form).
    denergy_dlambda runs the form's dlambda twin, one more sweep."""

    sigma: torch.Tensor = None
    epsilon: torch.Tensor = None
    solute: torch.Tensor = None  # (N,) {0, 1} indicator
    exclusions: torch.Tensor = None
    r_cut: float = 1.0
    r_switch: float = 0.9
    use_switch: bool = True
    lambda_name: str = "lambda_vdw"
    chunk: int = 256

    def __post_init__(self):
        if self.solute is not None and not bool(
                ((self.solute == 0) | (self.solute == 1)).all()):
            raise ValueError(
                "SoftcoreLennardJonesForce.solute must hold only 0 and 1: "
                "the pair kernels read the solute-solvent cross mask from "
                "the product of the 2 solute - 1 columns")

    def _per_particle(self, globals=None):
        return {"charge": 2.0 * self.solute - 1.0, "sigma": self.sigma,
                "epsilon": self.epsilon, "solute": self.solute}

    def _pair_fn(self, globals=None):
        lamb = (globals or {}).get(self.lambda_name, 1.0)
        r_cut, r_switch, use_switch = self.r_cut, self.r_switch, self.use_switch

        def pair(r, pi, pj):
            sigma, epsilon = _combine(pi, pj)
            u = pairfuncs.softcore_lj(r, sigma, epsilon, lamb)
            if use_switch:
                rr = r.r if isinstance(r, pairfuncs.Rv) else r
                u = u * switch_quintic(rr, r_switch, r_cut)
            # interaction group: exactly one of (i, j) in the solute set
            cross = pi["solute"] + pj["solute"] \
                - 2.0 * pi["solute"] * pj["solute"]
            return u * cross

        pair.takes_rv = True
        return pair

    def _pair_form(self, globals=None, dlambda: bool = False):
        # lambda enters the kernels' parameter block as a host float: one
        # device read when the Context holds it as a tensor on the card
        lamb = float((globals or {}).get(self.lambda_name, 1.0))
        return pairfuncs.softcore_form(self.r_cut, self.r_switch, lamb,
                                       self.use_switch, dlambda=dlambda)

    def _rows_form(self, globals):
        lamb = (globals or {}).get(self.lambda_name, 1.0)
        if isinstance(lamb, torch.Tensor) and lamb.ndim == 1:
            # each row's lambda goes to the kernel's device table of the
            # rows' lambdas, cast from the tensor on the device
            return pairfuncs.softcore_form(self.r_cut, self.r_switch, 1.0,
                                           self.use_switch), lamb
        return self._pair_form(globals), None

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)

    def denergy_dlambda(self, x, box, globals, name, aux=None):
        if name != self.lambda_name:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        nbr = self._cell(aux, self.r_cut)
        if nbr is None:  # dense path: autograd through the pair function
            return super().denergy_dlambda(x, box, globals, name, aux)
        return _cell_energy(self._pair_form(globals, dlambda=True), x, box,
                            self._per_particle(globals), nbr, self.r_cut)


@dataclasses.dataclass
class CustomNonbondedForce(_PairForceMixin, Force):
    """Arbitrary pair potential: `energy_function(r, pi, pj, globals)` plays
    the role of an openmm.CustomNonbondedForce Lepton string
    (atomsmm_tpu/forces.py::CustomNonbondedForce). per_particle maps
    parameter name to an (N,) tensor, gathered into pi/pj per pair.

    A hand-written kernel cannot take a Python function, so this is the
    port's path for user expressions, not a fallback: on a cell list the
    function runs as torch operations over the full stencil's slots
    (ops/neighbors.py::cell_pair_energy_fn), on a block list over the
    list's slots (ops/blocks.py::block_pair_energy_fn), on whatever device
    the tensors lie on, with forces and lambda derivatives by autograd. It
    walks every slot of the list, so it suits solute-sized work (a few
    dozen pairs in a few thousand atoms), not a solvent-wide force."""

    per_particle: Dict[str, torch.Tensor] = None
    exclusions: torch.Tensor = None
    r_cut: float = 1.0
    energy_function: Callable = None
    chunk: int = 256

    def _per_particle(self, globals=None):
        return self.per_particle

    def _pair_fn(self, globals=None):
        fn, g = self.energy_function, globals or {}

        def pair(r, pi, pj):
            return fn(r, pi, pj, g)

        return pair

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)

    # a pair function takes no kernel: the rows one after another (Force's)
    energy_rows = Force.energy_rows
    energy_and_forces_rows = Force.energy_and_forces_rows


@dataclasses.dataclass
class CustomBondForce(Force):
    """Arbitrary bond-pair potential `energy_function(r, params, globals)`
    over an explicit pair list (ops/pairs.py::pairlist_energy), torch
    operations on any device; forces by autograd."""

    pairs: torch.Tensor = None
    per_bond: Dict[str, torch.Tensor] = None
    valid: torch.Tensor = None
    energy_function: Callable = None

    def energy(self, x, box, globals, aux=None):
        fn, g = self.energy_function, globals or {}

        def pair(r, params):
            return fn(r, params, g)

        return pairlist_energy(pair, x, box, self.pairs, self.per_bond,
                               self.valid)


@dataclasses.dataclass
class MonteCarloBarostat(Force):
    """Marker force mirroring openmm.MonteCarloBarostat: no energy, no
    force, no work in a step (`inert`). A Context that finds it attempts an
    MC volume move every `frequency` steps
    (integrate/barostat.py::MonteCarloBarostatPropagator)."""

    pressure: float = 1.0      # bar
    temperature: float = 300.0
    frequency: int = 25
    inert = True

    def energy(self, x, box, globals, aux=None):
        return torch.zeros((), dtype=x.dtype, device=x.device)


def _pme_carrier(force):
    """The force (possibly nested under .full) that owns a PME cutoff and
    a static grid, or None."""
    g = force
    while (getattr(g, "method", None) != "pme"
           and getattr(g, "full", None) is not None):
        g = g.full
    if getattr(g, "method", None) != "pme" or not any(g.grid_shape):
        return None
    return g


def pme_coverage_flags(system, extra, box):
    """Sticky per-force flags pme_<i>_undercover (device bools): the box
    has grown past the validity bound of a PME force's static (alpha,
    grid), ops/pme.py::pme_validity_lengths, with a 5% grace (the grid rule
    inverts to tol_eff = tol (L / L_max)^5, so tripping at 1.05 L_max
    means tol_eff <= 1.28 tol). The reciprocal counterpart of the cell
    lists' coverage check; Context.step raises on it."""
    out = {}
    # a (3, 3) cell's grid was sized by its lattice vectors' lengths
    lengths = box if box.ndim == 1 else torch.linalg.norm(box, dim=1)
    for i, f in enumerate(system.forces):
        g = _pme_carrier(f)
        if g is None:
            continue
        bounds = torch.as_tensor(pme.pme_validity_lengths(
            g.ewald_alpha, g.grid_shape, g.spline_order, g.r_cut),
            dtype=box.dtype, device=box.device)
        key = f"pme_{i}_undercover"
        prev = extra.get(key)
        flag = torch.any(lengths > 1.05 * bounds)
        out[key] = flag if prev is None else prev | flag
    return out


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
class HarmonicBondForce(_StackedTerms, Force):
    """E = sum 0.5 k (r - r0)^2 (openmm.HarmonicBondForce; pad with k = 0)."""

    idx: torch.Tensor = None  # (B, 2)
    r0: torch.Tensor = None
    k: torch.Tensor = None

    def energy(self, x, box, globals, aux=None):
        return harmonic_bond_energy(x, self.idx.long(), self.r0, self.k)


@dataclasses.dataclass
class HarmonicAngleForce(_StackedTerms, Force):
    """E = sum 0.5 k (theta - theta0)^2 (openmm.HarmonicAngleForce)."""

    idx: torch.Tensor = None  # (A, 3)
    theta0: torch.Tensor = None
    k: torch.Tensor = None

    def energy(self, x, box, globals, aux=None):
        return harmonic_angle_energy(x, self.idx.long(), self.theta0, self.k)


@dataclasses.dataclass
class PeriodicTorsionForce(_StackedTerms, Force):
    """E = sum k (1 + cos(n phi - phase)) (openmm.PeriodicTorsionForce)."""

    idx: torch.Tensor = None  # (T, 4)
    periodicity: torch.Tensor = None
    phase: torch.Tensor = None
    k: torch.Tensor = None

    def energy(self, x, box, globals, aux=None):
        return periodic_torsion_energy(x, self.idx.long(), self.periodicity,
                                       self.phase, self.k)


@dataclasses.dataclass
class CMAPTorsionForce(Force):
    """CHARMM CMAP cross-term: a periodic bicubic correction surface over
    the (phi, psi) dihedral pair of 5 consecutive atoms (ops/cmap.py).
    `table` is the (T, n, n, 4) value+derivative tensor from
    `ops.cmap.build_cmap_table` [kJ/mol], in the dtype of the state. A
    numpy table or type index is made a tensor on idx's device once, here,
    and the type index is held as int64."""

    idx: torch.Tensor = None         # (C, 5) atoms i,j,k,l,m
    type_index: torch.Tensor = None  # (C,) into table
    table: torch.Tensor = None       # (T, n, n, 4)

    def __post_init__(self):
        device = torch.as_tensor(self.idx).device
        self.table = torch.as_tensor(self.table, device=device)
        self.type_index = torch.as_tensor(self.type_index,
                                          device=device).long()

    def energy(self, x, box, globals, aux=None):
        return cmap_energy(x, self.idx.long(), self.type_index, self.table)


@dataclasses.dataclass
class HarmonicImproperForce(_StackedTerms, Force):
    """CHARMM-style harmonic improper torsion E = k (phi - phi0)^2 with the
    difference wrapped to (-pi, pi]: the CHAMBER prmtop improper term (k
    carries no 1/2, the CHARMM convention)."""

    idx: torch.Tensor = None   # (I, 4)
    phi0: torch.Tensor = None  # (I,) [rad]
    k: torch.Tensor = None     # (I,) [kJ/mol/rad^2]

    def energy(self, x, box, globals, aux=None):
        return harmonic_improper_energy(x, self.idx.long(), self.phi0, self.k)


@dataclasses.dataclass
class DrudeForce(Force):
    """Drude-oscillator polarizability terms (ops/drude.py): core-Drude
    restoring springs plus Thole-screened dipole-dipole interactions
    between bonded-neighbor dipoles (OpenMM's ``DrudeForce``). The Drude
    particles' Coulomb interactions with everything else ride the regular
    NonbondedForce (they are ordinary charged particles there); this force
    adds only the polarizability-specific terms, forces by autograd.
    Bond-like range: it belongs in the innermost RESPA group."""

    drude: object = None  # ops.drude.DrudeSet

    def energy(self, x, box, globals, aux=None):
        e = drude_spring_energy(self.drude, x)
        if self.drude.num_screened:
            e = e + thole_screening_energy(self.drude, x, box)
        return e
