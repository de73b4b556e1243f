"""Simulation, the loop that runs a Context under reporters (counterpart
of atomsmm_tpu/app.py and of openmm.app.Simulation).

Owns a Context and a list of reporters. `step(n)` advances the Context in
chunks that end at the next reporter boundary and observes only there.
Context.step reads its flags back once per call, so each chunk costs one
host synchronization, and each reporting boundary one snapshot: a full
one (the per-force split and the forces) when a due reporter needs it,
else a lite one (one total-energy pass).

>>> import io, torch
>>> from atomsmm_tpu_torch import VelocityVerletIntegrator, make_state
>>> from atomsmm_tpu_torch.models import argon_system
>>> from atomsmm_tpu_torch.reporters import StateDataReporter
>>> system, x, box = argon_system(n=64, jitter=0.05, seed=1, r_cut=0.5,
...                               r_switch=0.4, device="cpu")
>>> sim = Simulation(system, VelocityVerletIntegrator(0.002),
...                  make_state(x, box=box))
>>> out = io.StringIO()
>>> sim.reporters.append(StateDataReporter(out, interval=5))
>>> sim.step(12).current_step
12
>>> [line.split(",")[0] for line in out.getvalue().splitlines()][1:]
['5', '10']
"""
from __future__ import annotations

from .context import Context


class Simulation:
    def __init__(self, system, integrator, state=None, seed: int = 0):
        self.integrator = integrator
        self.context = Context(system, integrator, state, seed=seed)
        self.reporters = []

    @property
    def system(self):
        """The Context's system (its neighbor specs as last retuned)."""
        return self.context.system

    # -- conveniences mirroring openmm.app.Simulation ----------------------

    def minimize_energy(self, steps: int = 200, **kwargs):
        from .minimize import minimize_energy

        minimize_energy(self.context, steps=steps, **kwargs)
        return self

    def set_positions(self, x):
        self.context.set_positions(x)

    def set_velocities_to_temperature(self, temperature, seed: int = 0):
        self.context.set_velocities_to_temperature(temperature, seed)

    def save_checkpoint(self, path):
        from .checkpoint import save_checkpoint

        save_checkpoint(path, self.context.state)
        return self

    def load_checkpoint(self, path):
        from .checkpoint import load_checkpoint

        self.context.state = load_checkpoint(path, like=self.context.state)
        return self

    # openmm-style camelCase aliases
    def minimizeEnergy(self, steps: int = 200, **kwargs):
        return self.minimize_energy(steps, **kwargs)

    def setPositions(self, x):
        return self.set_positions(x)

    def setVelocitiesToTemperature(self, temperature, seed: int = 0):
        return self.set_velocities_to_temperature(temperature, seed)

    def saveCheckpoint(self, path):
        return self.save_checkpoint(path)

    def loadCheckpoint(self, path):
        return self.load_checkpoint(path)

    @property
    def current_step(self) -> int:
        return int(self.context.state.step)

    def step(self, n: int):
        """Advance n steps, firing reporters at their intervals."""
        remaining = n
        while remaining > 0:
            if self.reporters:
                until = min(
                    r.describe_next(self.current_step) for r in self.reporters
                )
                chunk = min(remaining, until)
            else:
                chunk = remaining
            self.context.step(chunk)
            remaining -= chunk
            if self.reporters:
                step_now = self.current_step
                due = [
                    r for r in self.reporters if step_now % r.interval == 0
                ]
                if due:
                    full = any(
                        getattr(r, "needs_full_snapshot", True) for r in due
                    )
                    snap = self.context.get_state(lite=not full)
                    for r in due:
                        r.report(self, snap)
        return self
