"""Context — binds (System, Integrator, State) (counterpart of
atomsmm_tpu/context.py).

`step(n)` runs the step function n times in a Python loop of eager PyTorch
operations (the JAX package runs one jitted device loop). The neighbor
buckets are rebuilt after every outer step, or with
neighbor_update_every=K after every K-th with the staleness guard sampled
after each step between (`advance`, which the replica runner shares). The
flags stay on the device; step(n) reads them once, at its end, raises on
a stale list, and on overflow restores
the state from before the call (the generator's included, so one seed gives
one trajectory whether or not a capacity overflowed), grows the cell
capacities and runs the n steps again. `set_parameter` holds the global
context parameters (lambda_vdw and the like) that every force evaluation and
propagator receives as `globals`.

The box moves when the system holds a MonteCarloBarostat: a volume move is
attempted right after every step whose post-increment counter satisfies
step % frequency == frequency - 1 (the JAX package's host segmentation; the
counter is a host int, so the test costs no sync). The same single read at
the end of step(n) then also checks that every cell grid's stencil still
covers its cutoff at the final box, that no PME grid has fallen behind a
grown box (sticky flags, `retune_pme` re-derives the grids), and how many
volume trials were vetoed for an invalid pair list.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import torch

from .forces import MonteCarloBarostat, pme_coverage_flags
from .integrate.barostat import (
    BARO_NATT,
    BARO_NBAD,
    MonteCarloBarostatPropagator,
)
from .integrate.propagators import StepContext
from .ops.neighbors import (
    all_neighbor_extras,
    coverage_deficient,
    iter_specs,
    make_aux,
    overflow_flags,
    retune_neighbor_specs,
    stale_key,
    staleness_flags,
    update_all_neighbors,
)
from .ops.virtual_sites import place_virtual_sites, zero_virtual_velocities
from .potential import (
    force_fn,
    group_energies,
    potential_energy,
    split_potential_energy,
)
from .state import State, kinetic_energy, make_state, \
    maxwell_boltzmann_velocities, remove_com_motion
from .utils import count_degrees_of_freedom, replace


def refresh_force_caches(system, state, globals):
    """Recompute every force cache present in State.extra at the current
    positions (run at the start of each step(n), so a change made between
    calls can never leave a stale cache)."""
    from .integrate.propagators import parse_force_cache_tag

    aux = make_aux(system, state.extra)
    updates = {}
    for key in state.extra:
        if key.startswith("fcache_"):
            _, f = force_fn(system, parse_force_cache_tag(key))(
                state.x, state.box, globals, aux)
            updates[key] = f
    return state.with_extra(**updates) if updates else state


def update_neighbor_lists(system, state):
    """`state` with every cell list of `system` rebuilt
    (ops.neighbors.update_all_neighbors, forced). Under a spatial mesh of
    more than one rank the state is first broadcast from the first rank
    (parallel/mesh.py::synchronize_state), so that every rank bins the
    same positions and the ranks' states stay bitwise equal."""
    from .parallel.mesh import synchronize_state

    state = synchronize_state(state)
    if system.neighbors is None:
        return state
    return state.with_extra(**update_all_neighbors(
        system, state.extra, state.x, state.box, force=True))


def with_neighbor_lists(system, state, k_update: int = 1):
    """`state` with a fresh build of every cell list of `system` and, for
    grouped updates (k_update > 1), its sticky staleness flags cleared:
    the extras that `advance` expects. Context and HREXSampler both set
    up their states here."""
    if system.neighbors is None:
        return state
    extras = all_neighbor_extras(system, state.x, state.box)
    if k_update > 1:
        extras.update({
            stale_key(name): torch.zeros(state.x.shape[:-2],
                                         dtype=torch.bool,
                                         device=state.x.device)
            for name, _ in iter_specs(system)})
    return state.with_extra(**extras)


def stale_flags(extra) -> Dict[str, torch.Tensor]:
    """The sticky staleness flags held in `extra` (device bools)."""
    return {k: v for k, v in extra.items()
            if k.startswith("nbr") and k.endswith("stale")}


def raise_on_stale(flags, where: str = ""):
    """Raise on the first set flag of `flags` ({key: host bool}, the
    values of stale_flags read in the caller's one sync); `where` names
    the replica, if any."""
    for key, bad in flags.items():
        if bad:
            raise RuntimeError(
                f"neighbor staleness{where} ({key}): an atom pair may have "
                "closed past the skin between grouped neighbor updates, so "
                "pairs may have been missed; reduce neighbor_update_every "
                "or enlarge the skin")


def advance(system, step_fn, state, globals, n: int, k_update: int = 1,
            after_step=None):
    """Run n outer steps of step_fn from `state` under `globals`, and
    return the state they end in.

    First the cell lists are rebuilt and the force caches recomputed at the
    starting positions. With k_update = 1 (or no cell list) the lists are
    rebuilt after every step and `after_step(state)`, when given, runs
    after each (Context's barostat). With k_update = K > 1 the steps run
    in groups of K: the sticky staleness flags are sampled after every
    step and the lists rebuilt, forced, at the end of each group (a
    conditional skin/2 rebuild would race the two-displacement staleness
    bound and trip the guard on thermal motion); the n % K remainder steps
    run singly, each followed by a rebuild. Context.step and the replica
    runner (parallel/hrex.py) both step through here.

    A stacked State (state.py) advances as one batch: every step evaluates
    the forces of all K rows together (potential.force_fn), each rebuild
    bins every row in one sort, and the staleness flags are (K,), one per
    row, each row grouped as it would be alone; `globals` may hold (K,)
    tensors, one value per row. The caller reads the flags of all rows in
    one sync (HREXSampler.run)."""
    s = refresh_force_caches(system, update_neighbor_lists(system, state),
                             globals)
    if k_update == 1 or system.neighbors is None:
        for _ in range(n):
            s = update_neighbor_lists(system, step_fn(system, s, globals))
            if after_step is not None:
                s = after_step(s)
        return s
    groups, rest = divmod(n, k_update)
    for _ in range(groups):
        for _ in range(k_update):
            s = step_fn(system, s, globals)
            s = s.with_extra(**staleness_flags(system, s.extra, s.x, s.box))
        s = update_neighbor_lists(system, s)
    for _ in range(rest):
        s = update_neighbor_lists(system, step_fn(system, s, globals))
    return s


@dataclasses.dataclass
class StateSnapshot:
    """Positions, velocities, forces and energies, with the per-group and
    per-force decomposition."""

    positions: torch.Tensor = None
    velocities: torch.Tensor = None
    box: torch.Tensor = None
    forces: torch.Tensor = None
    potential_energy: torch.Tensor = None
    kinetic_energy: torch.Tensor = None
    group_energies: Dict[int, torch.Tensor] = None
    energy_split: Dict[str, torch.Tensor] = None
    step: int = None


def _clone_state(state: State) -> State:
    row_major = torch.contiguous_format
    return replace(state, x=state.x.clone(memory_format=row_major),
                   v=state.v.clone(memory_format=row_major),
                   box=state.box.clone(),
                   extra={k: v.clone() for k, v in state.extra.items()})


class Context:
    def __init__(self, system, integrator, state: Optional[State] = None,
                 seed: int = 0, neighbor_update_every: int = 1):
        """neighbor_update_every=K rebuilds the cell lists after every K-th
        outer step instead of every step, under the staleness guard
        (`advance`); step(n) raises if an atom pair may have closed past
        the skin in between. K is 1 under a MonteCarloBarostat, whose
        volume moves rebuild the lists themselves."""
        self.system = system
        self.integrator = integrator
        self.neighbor_update_every = max(int(neighbor_update_every), 1)
        #: global context parameters, name -> 0-d tensor (set_parameter)
        self.parameters: Dict[str, torch.Tensor] = {}
        #: how many times the last step(n) ran its n steps (2+ after an
        #: overflow recovery)
        self.last_step_passes = 0
        if state is None:
            x = torch.zeros((system.num_particles, 3),
                            dtype=system.masses.dtype,
                            device=system.masses.device)
            state = make_state(x, box=system.default_box, seed=seed)
        state = _clone_state(state)
        self._check_box(state.box)
        vs = system.virtual_sites
        if vs is not None:
            # place the virtual rows once, so that the buckets and the
            # reporters see them where the forces do (a builder's rows may
            # hold anything)
            state = replace(state, x=place_virtual_sites(vs, state.x),
                            v=zero_virtual_velocities(vs, state.v))
        built = with_neighbor_lists(system, state, self.neighbor_update_every)
        if any(bool(v) for v in overflow_flags(built.extra).values()):
            # cold-start capacity estimate busted: retune every spec to the
            # measured configuration instead of raising
            self.system = system = retune_neighbor_specs(
                system, state.x, state.box)
            built = with_neighbor_lists(system, state,
                                        self.neighbor_update_every)
        state = built
        self.state = integrator.initialize(system, state)
        # openmm semantics: a MonteCarloBarostat force drives MC volume
        # moves after the steps it is due at (integrate/barostat.py)
        self._barostat = None
        for f in system.forces:
            if isinstance(f, MonteCarloBarostat):
                self._barostat = MonteCarloBarostatPropagator(
                    float(f.pressure), float(f.temperature), f.frequency)
                missing = {k: v.clone() for k, v in
                           self._barostat.extra_variables(system,
                                                          self.state).items()
                           if k not in self.state.extra}
                self.state = self.state.with_extra(**missing)
        # sticky PME coverage flags, checked against the live box at the
        # start of every step(n) and after every volume move
        self._pme_flags = tuple(pme_coverage_flags(system, {}, state.box))
        self.state = self.state.with_extra(**{
            k: torch.zeros((), dtype=torch.bool, device=state.x.device)
            for k in self._pme_flags})
        self._step_fn = integrator.make_step()
        self.check_overflow = system.neighbors is not None
        self._warned_baro_nbad = False

    def _check_box(self, box):
        """Raise unless every cutoff fits the minimum image at `box` and
        every cell grid's stencil still covers its cutoff there."""
        from .ops.pbc import validate_cutoffs

        validate_cutoffs(self.system, box)
        for name, spec in iter_specs(self.system):
            if coverage_deficient(spec, box):
                raise RuntimeError(
                    f"cell-list spec {name!r}: the stencil reach does not "
                    "cover the cutoff at this box — pairs would be silently "
                    "dropped; build the NeighborSpec for this box")

    # -- stepping ----------------------------------------------------------

    def _flag_pme(self, s: State) -> State:
        return s.with_extra(**pme_coverage_flags(self.system, s.extra, s.box))

    def _advance(self, n: int):
        system, baro = self.system, self._barostat
        after_step = None
        if baro is not None:
            def after_step(s):
                if s.step % baro.frequency != baro.frequency - 1:
                    return s
                return self._flag_pme(baro._attempt(
                    StepContext(system, self.parameters, 0.0), s))
        self.state = advance(
            system, self._step_fn, self._flag_pme(self.state),
            self.parameters, n,
            1 if baro is not None else self.neighbor_update_every, after_step)

    def _flags(self):
        """Host copies, in one device sync, of five groups of flags by name:
        "overflow" (the sticky bucket-overflow flags), "stale" (the sticky
        staleness flags of grouped updates), "pme" (the sticky PME
        coverage flags), "undercover" (whether each cell grid's stencil
        fails to cover its cutoff at the current box, by spec name) and
        "baro" (the barostat's attempt and invalid-trial counts)."""
        extra = self.state.extra
        groups = {
            "overflow": overflow_flags(extra),
            "stale": stale_flags(extra),
            "pme": {k: extra[k] for k in self._pme_flags},
            "undercover": {name: coverage_deficient(spec, self.state.box)
                           for name, spec in iter_specs(self.system)},
            "baro": ({k: extra[k] for k in (BARO_NATT, BARO_NBAD)}
                     if self._barostat is not None else {}),
        }
        flat = [v.reshape(()).to(torch.int64)
                for g in groups.values() for v in g.values()]
        values = iter(torch.stack(flat).tolist() if flat else [])
        return {name: {k: next(values) for k in g}
                for name, g in groups.items()}

    def step(self, n: int):
        """Advance n outer steps.

        Capacity overflow auto-recovers: the state from before the call is
        restored, capacities grow to the measured occupancy, and the n steps
        run again."""
        self.last_step_passes = 0
        for attempt in range(3):
            backup = rng_state = None
            if self.check_overflow:
                backup = _clone_state(self.state)
                rng_state = self.state.rng.get_state()
            self._advance(n)
            self.last_step_passes += 1
            flags = self._flags()
            overflowed = [k for k, v in flags["overflow"].items() if v]
            if not overflowed:
                break
            if attempt == 2:
                raise RuntimeError(
                    f"cell-list capacity overflow persists after retuning "
                    f"({overflowed}): increase the cell capacity")
            warnings.warn(
                f"cell-list overflow ({overflowed}): restoring the state from "
                "before step(), retuning capacities and running again",
                stacklevel=2)
            self.state = backup
            # State.rng is one generator advanced in place: wind it back so
            # that the replay draws what the first pass drew
            backup.rng.set_state(rng_state)
            self.retune_neighbors(safety=1.15 * (1.2 ** attempt),
                                  grow_only=True)
        self._check_flags(flags)
        return self

    def _check_flags(self, flags):
        """Raise on a stencil that no longer covers its cutoff at the final
        box, on a stale list between grouped updates or on a PME grid the
        box outgrew; warn once when more than 10% of at least 20 volume
        trials were vetoed for an invalid pair list."""
        for name, bad in flags["undercover"].items():
            if bad:
                raise RuntimeError(
                    f"cell-list coverage loss (spec {name!r}): the box "
                    "shrank until the stencil reach no longer covers the "
                    "cutoff, so pairs would be dropped. Rebuild the "
                    "NeighborSpec at the current box, or pass a larger "
                    "min_skin to make_neighbor_spec for NPT runs")
        raise_on_stale(flags["stale"])
        for key, bad in flags["pme"].items():
            if bad:
                raise RuntimeError(
                    f"PME grid coverage loss ({key}): the box grew past the "
                    "validity bound of the static (alpha, grid), so the "
                    "reciprocal-space error exceeds its design tolerance. "
                    "Call retune_pme() to re-derive the grid for the current "
                    "box")
        natt, nbad = (flags["baro"].get(k, 0) for k in (BARO_NATT, BARO_NBAD))
        if natt >= 20 and nbad > 0.1 * natt and not self._warned_baro_nbad:
            # a rejected undercovering trial is never priced on a truncated
            # pair list, but a compression vetoed again and again is a
            # reflecting wall that biases <V>
            self._warned_baro_nbad = True
            warnings.warn(
                f"MC barostat: {nbad}/{natt} volume-move trials were "
                "rejected because the trial pair list was invalid (bucket "
                "overflow or coverage loss at the trial box). If this "
                "persists the volume distribution is biased at the coverage "
                "boundary: rebuild the NeighborSpec with a larger min_skin "
                "for NPT headroom", stacklevel=3)

    # -- observation -------------------------------------------------------

    def get_state(self, lite: bool = False) -> StateSnapshot:
        """Snapshot with the per-force split, per-group energies and forces,
        or with lite=True positions, velocities and energies only (one
        total-energy pass)."""
        system, globals = self.system, self.parameters
        s = update_neighbor_lists(system, self.state)
        aux = make_aux(system, s.extra)
        ke = kinetic_energy(system.masses, s.v)
        if lite:
            return StateSnapshot(
                positions=s.x, velocities=s.v, box=s.box,
                potential_energy=potential_energy(system, s.x, s.box,
                                                  globals, aux=aux),
                kinetic_energy=ke, step=s.step)
        e_split = split_potential_energy(system, s.x, s.box, globals, aux)
        _, forces = force_fn(system)(s.x, s.box, globals, aux)
        return StateSnapshot(
            positions=s.x, velocities=s.v, box=s.box, forces=forces,
            potential_energy=e_split["Total"], kinetic_energy=ke,
            group_energies=group_energies(system, s.x, s.box, globals, aux),
            energy_split=e_split, step=s.step)

    # -- openmm.Context-like surface ---------------------------------------

    def set_positions(self, x):
        """Replace the positions; the next step() or get_state() rebuilds
        the neighbor buckets and the force caches from them."""
        x = torch.as_tensor(
            x, dtype=self.state.x.dtype, device=self.state.x.device).clone(
                memory_format=torch.contiguous_format)
        self.state = replace(self.state, x=x)

    def set_velocities(self, v):
        v = torch.as_tensor(
            v, dtype=self.state.v.dtype, device=self.state.v.device).clone(
                memory_format=torch.contiguous_format)
        self.state = replace(self.state, v=v)

    def set_velocities_to_temperature(self, temperature, seed: int = 0):
        rng = torch.Generator(device=self.state.x.device)
        rng.manual_seed(seed)
        v = maxwell_boltzmann_velocities(rng, self.system.masses, temperature,
                                         self.state.x.dtype)
        vs = self.system.virtual_sites
        if vs is not None:
            # a massless row carries no momentum: zero it before the COM
            # projection spreads anything over it, and again after
            v = zero_virtual_velocities(vs, v)
        if self.system.remove_com_motion:
            v = remove_com_motion(self.system.masses, v)
        if vs is not None:
            v = zero_virtual_velocities(vs, v)
        self.set_velocities(v)

    def set_periodic_box(self, box):
        """Replace the box: (3,) lengths or a (3, 3) cell matrix (rows =
        lattice vectors). A box that a cutoff or a cell grid no longer
        fits raises here, before any step can drop pairs."""
        box = torch.as_tensor(box, dtype=self.state.x.dtype,
                              device=self.state.x.device).clone()
        self._check_box(box)
        self.state = replace(self.state, box=box)

    def set_parameter(self, name: str, value):
        """Set a global context parameter (a 0-d tensor of the state's
        dtype on its device); it reaches the forces at the next call. A
        Python float goes straight to that dtype, not through torch's
        float32 default."""
        self.parameters[name] = torch.as_tensor(
            value, dtype=self.state.x.dtype, device=self.state.x.device)

    def get_parameter(self, name: str):
        return self.parameters[name]

    def retune_pme(self):
        """Re-derive every PME force's grid for the current box, keeping
        the larger grid per dimension and alpha (which depends only on the
        cutoff and the error tolerance, not on the volume); a
        PMEReciprocalForce of the same alpha takes its companion's grid.
        Clears the sticky PME coverage flags."""
        import math

        import numpy as np

        from .forces import PMEReciprocalForce, _pme_carrier
        from .ops.pme import choose_pme_parameters

        box = np.asarray(self.state.box.detach().cpu(), np.float64)
        new_forces, regrids = [], {}
        for f in self.system.forces:
            g = _pme_carrier(f)
            if g is None:
                new_forces.append(f)
                continue
            alpha = float(g.ewald_alpha)
            # the design tolerance, recovered from openmm's alpha rule
            tol = 0.5 * math.exp(-((alpha * float(g.r_cut)) ** 2))
            _, grid, _ = choose_pme_parameters(float(g.r_cut), box, tol=tol,
                                               alpha=alpha,
                                               order=int(g.spline_order))
            grid = tuple(max(a, b) for a, b in zip(grid, g.grid_shape))
            regrids[alpha] = grid
            new_forces.append(replace(f, grid_shape=grid) if g is f else
                              replace(f, full=replace(f.full,
                                                      grid_shape=grid)))
        new_forces = [
            replace(f, grid_shape=regrids[float(f.ewald_alpha)])
            if isinstance(f, PMEReciprocalForce)
            and float(f.ewald_alpha) in regrids else f
            for f in new_forces]
        self.system = self.system.replace_forces(new_forces)
        self.state = self.state.with_extra(**{
            k: torch.zeros_like(self.state.extra[k]) for k in self._pme_flags})
        return self

    def retune_neighbors(self, safety: float = 1.15, grow_only: bool = False):
        """Resize every neighbor spec to the current configuration: a cell
        list's capacity to the measured max occupancy
        (ops.neighbors.retune_spec), a block list's K to the measured max
        candidate count (ops.blocks.retune_block_spec, safety at least
        1.15); grow_only floors each capacity at its current value + 4."""
        if self.system.neighbors is None:
            return self
        self.system = retune_neighbor_specs(
            self.system, self.state.x, self.state.box, safety,
            grow_only=grow_only)
        # the staleness flags stay: they record what earlier steps missed
        kept = {k: v for k, v in self.state.extra.items()
                if not k.startswith("nbr") or k.endswith("stale")}
        state = replace(self.state, extra=kept)
        self.state = state.with_extra(
            **all_neighbor_extras(self.system, state.x, state.box))
        return self

    # -- openmm-style camelCase aliases ------------------------------------

    def setPositions(self, x):
        return self.set_positions(x)

    def setVelocities(self, v):
        return self.set_velocities(v)

    def setVelocitiesToTemperature(self, temperature, seed: int = 0):
        return self.set_velocities_to_temperature(temperature, seed)

    def setParameter(self, name, value):
        return self.set_parameter(name, value)

    def getParameter(self, name):
        return self.get_parameter(name)

    def setPeriodicBoxVectors(self, box):
        return self.set_periodic_box(box)

    def getState(self, **_ignored) -> StateSnapshot:
        return self.get_state()

    # -- convenience -------------------------------------------------------

    @property
    def degrees_of_freedom(self) -> int:
        return count_degrees_of_freedom(self.system)

    def temperature(self):
        from .units import BOLTZMANN

        ke = kinetic_energy(self.system.masses, self.state.v)
        return 2.0 * ke / (self.degrees_of_freedom * BOLTZMANN)

    def conserved_energy(self):
        """Potential + kinetic + thermostat contributions — the quantity
        whose drift validates an integrator."""
        snap = self.get_state(lite=True)
        return (snap.potential_energy + snap.kinetic_energy
                + self.integrator.conserved_extra(self.state))
