"""Monte Carlo barostat (counterpart of atomsmm_tpu/integrate/barostat.py,
openmm.MonteCarloBarostat): isotropic MC volume moves with molecular (COM)
scaling, Metropolis acceptance on dU + P dV - N_mol kT ln(V'/V) and an
adaptive move size. A (3, 3) cell scales as the JAX propagator scales it:
H and the molecules' centres by one factor, so the cell keeps its shape;
the trial buckets bin fractionally on the cell's own grid.

Context runs an attempt after every step whose post-increment counter
satisfies step % frequency == frequency - 1 (the JAX package's host
segmentation), as a call of `_attempt`. The trial energy is taken on cell
buckets built afresh at the trial box; a trial whose bucket overflowed or
whose box the stencil no longer covers (on the perpendicular widths of a
(3, 3) cell) is rejected and counted (BARO_NBAD), never priced on a
truncated pair list. The decision stays on the device (`torch.where`): an
attempt reads nothing back to the host. On the way out the buckets are
rebuilt and the force caches refreshed, so the next RESPA kick never sees
forces from before the move.

>>> import torch
>>> x = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [1.0, 1.0, 1.0]],
...                  dtype=torch.float64)
>>> xs = molecular_scale(x, torch.tensor([0, 0, 1]), 2,
...                      torch.tensor([1.0, 1.0, 4.0], dtype=torch.float64),
...                      torch.tensor(2.0, dtype=torch.float64))
>>> [round(v, 6) for v in xs[:, 0].tolist()]   # the COM moves, 0-1 stays
[0.05, 0.15, 2.0]
"""
from __future__ import annotations

import torch

from ..ops.pbc import box_volume
from ..potential import potential_energy
from ..system import molecular_scale
from ..units import BOLTZMANN, PRESSURE_IN_BAR
from ..utils import replace
from .propagators import Propagator, refuse_stack

BARO_DV = "baro_dv"             # current volume-move size [nm^3]
BARO_NACC = "baro_naccepted"
BARO_NATT = "baro_nattempted"
BARO_NBAD = "baro_nbadtrials"   # trials rejected for an invalid pair list


class MonteCarloBarostatPropagator(Propagator):
    """Attempts a volume move every `frequency` outer steps
    (openmm.MonteCarloBarostat semantics); pressure in bar."""

    def __init__(self, pressure_bar, temperature, frequency: int = 25,
                 initial_dv_fraction: float = 0.01):
        self.pressure = float(pressure_bar) / PRESSURE_IN_BAR  # kJ/mol/nm^3
        self.temperature = float(temperature)
        self.frequency = int(frequency)
        self.dv0 = float(initial_dv_fraction)

    def extra_variables(self, system, state):
        refuse_stack(self, state)
        dev = state.x.device
        return {
            BARO_DV: (self.dv0 * box_volume(state.box)).to(state.x.dtype),
            BARO_NACC: torch.zeros((), dtype=torch.int32, device=dev),
            BARO_NATT: torch.zeros((), dtype=torch.int32, device=dev),
            BARO_NBAD: torch.zeros((), dtype=torch.int32, device=dev),
        }

    def _uniforms(self, state):
        """(u_dv uniform in [-1, 1), u_acc uniform in [0, 1)): the attempt's
        two draws, from the state's generator on its device. The attempt
        draws nowhere else."""
        u = torch.rand(2, generator=state.rng, dtype=state.x.dtype,
                       device=state.x.device)
        return 2.0 * u[0] - 1.0, u[1]

    def _trial(self, system, x, box, globals):
        """(energy, overflow, undercover) at a trial configuration, on
        buckets built for it; the two flags are device bools."""
        from ..ops.neighbors import (
            all_neighbor_extras,
            make_aux,
            unhealthy_flags,
        )

        no = torch.zeros((), dtype=torch.bool, device=x.device)
        if system.neighbors is None:
            return potential_energy(system, x, box, globals), no, no
        extras = all_neighbor_extras(system, x, box)
        overflow, undercover = unhealthy_flags(extras)
        return (potential_energy(system, x, box, globals,
                                 aux=make_aux(system, extras)),
                overflow, undercover)

    def _attempt(self, ctx, state):
        from ..context import refresh_force_caches
        from ..ops.neighbors import make_aux, update_all_neighbors
        from ..parallel.mesh import broadcast_from_first

        refuse_stack(self, state)
        system = ctx.system
        kT = BOLTZMANN * self.temperature
        u_dv, u_acc = self._uniforms(state)
        dv_max = state.extra[BARO_DV]
        v_old = box_volume(state.box)
        dv = u_dv * dv_max
        v_new = v_old + dv
        s = (v_new / v_old) ** (1.0 / 3.0)
        # the centres of mass sum with atomics on the card: under a spatial
        # mesh every rank takes the first rank's trial, so that all bin
        # and price the same positions (parallel/mesh.py)
        x_new, = broadcast_from_first([molecular_scale(
            state.x, system.molecule, system.num_molecules, system.masses, s)])
        box_new = state.box * s

        # the step loop keeps the buckets of State.extra valid for the
        # current x and box: no rebuild for e_old
        aux = (make_aux(system, state.extra)
               if system.neighbors is not None else None)
        e_old = potential_energy(system, state.x, state.box, ctx.globals,
                                 aux=aux)
        e_new, trial_overflow, trial_undercover = self._trial(
            system, x_new, box_new, ctx.globals)
        trial_bad = trial_overflow | trial_undercover
        w = (e_new - e_old + self.pressure * dv
             - system.num_molecules * kT * torch.log(v_new / v_old))
        accept = (u_acc < torch.exp(torch.clamp(-w / kT, max=0.0))) \
            & ~trial_bad
        x = torch.where(accept, x_new, state.x)
        box = torch.where(accept, box_new, state.box)

        # adaptive move size (openmm's heuristic), every 10 attempts
        n_acc = state.extra[BARO_NACC] + accept.to(torch.int32)
        n_att = state.extra[BARO_NATT] + 1
        window = n_att % 10 == 0
        rate = n_acc.to(state.x.dtype) / torch.clamp(n_att, min=1)
        dv_max = torch.where(window & (rate > 0.5), dv_max * 1.1, dv_max)
        dv_max = torch.where(window & (rate < 0.25), dv_max * 0.9, dv_max)
        dv_max = torch.minimum(dv_max, 0.3 * v_old)

        state = replace(state, x=x, box=box).with_extra(**{
            BARO_DV: dv_max, BARO_NACC: n_acc, BARO_NATT: n_att,
            BARO_NBAD: state.extra[BARO_NBAD] + trial_bad.to(torch.int32)})
        if system.neighbors is not None:
            updated = update_all_neighbors(system, state.extra, state.x,
                                           state.box, force=True)
            # a trial rejected for bucket overflow marks the sticky overflow
            # flags, so that Context.step's restore -> retune -> replay
            # gives the move a fair retry; a trial rejected only because
            # the stencil no longer covers its box leaves them alone (a
            # larger capacity cannot fix coverage)
            for k in updated:
                if k.endswith("overflow"):
                    updated[k] = updated[k] | trial_overflow
            state = state.with_extra(**updated)
        return refresh_force_caches(system, state, ctx.globals)

    def apply(self, ctx, state, fraction):
        """Propagator-algebra hook: attempt when the (host) step counter is
        due. Context does not compose it; it calls _attempt itself at the
        same steps."""
        if state.step % self.frequency == self.frequency - 1:
            return self._attempt(ctx, state)
        return state

    def describe(self, fraction=1.0):
        return [
            f"MC volume move every {self.frequency} steps "
            f"(P={self.pressure * PRESSURE_IN_BAR:.1f} bar, "
            f"T={self.temperature}K, molecular scaling)"
        ]
