"""Reporters (counterpart of atomsmm_tpu/reporters.py).

Reporting runs on the host at chunk boundaries: app.Simulation steps the
Context in report-interval chunks and hands each due reporter a
StateSnapshot, so no step is interrupted. A row reads the values it prints
back from the device in one go (one synchronization), and nothing else.

  StateDataReporter          — openmm.app.StateDataReporter equivalent
  ExtendedStateDataReporter  — adds per-force energies, atomic and
      molecular virials and pressures, the molecular kinetic energy, the
      Coulomb energy and global context parameters
  XYZReporter                — plain-XYZ trajectories of selected atoms
  PDBReporter                — multi-MODEL PDB trajectories (io/pdb.py)
  CenterOfMassReporter       — per-molecule centre-of-mass trajectories
  CustomIntegratorReporter   — integrator variables (State.extra), the
      runtime debugging hook
"""
from __future__ import annotations

import sys
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from .units import BOLTZMANN


def _fetch(*tensors):
    """Host numpy copies of `tensors`, read in one device synchronization:
    every copy is queued without blocking, then the card is waited for
    once."""
    out = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    cards = {t.device for t in tensors if t.is_cuda}
    for dev in cards:
        torch.cuda.synchronize(dev)
    return [o.numpy() for o in out]


def _read_scalars(values: dict) -> dict:
    """{name: host float} of 0-d tensors, in one read."""
    keys = list(values)
    host = _fetch(*(values[k] for k in keys))
    return {k: float(h) for k, h in zip(keys, host)}


class _Reporter:
    # True when report() reads the full snapshot (energy split, per-group
    # energies, forces); a lite row costs one total-energy pass instead
    needs_full_snapshot = False

    def __init__(self, file, interval: int):
        self.interval = int(interval)
        self._own = isinstance(file, str)
        self.out = open(file, "w") if self._own else (file or sys.stdout)
        self._header_done = False

    def describe_next(self, current_step: int) -> int:
        """Steps until this reporter next fires."""
        return self.interval - current_step % self.interval

    def report(self, simulation, snapshot):  # pragma: no cover - abstract
        raise NotImplementedError

    def close(self):
        if self._own:
            self.out.close()


class StateDataReporter(_Reporter):
    """CSV columns: step, time, PE, KE, total energy, temperature [K]."""

    def __init__(self, file, interval, separator: str = ","):
        super().__init__(file, interval)
        self.sep = separator

    def _tensors(self, simulation, snap) -> dict:
        """The device values a row prints, by name (read in one go)."""
        return {"ke": snap.kinetic_energy, "pe": snap.potential_energy}

    def _columns(self, simulation, snap, host):
        dof = simulation.context.degrees_of_freedom
        ke, pe = host["ke"], host["pe"]
        step = int(snap.step)
        return [
            ("Step", step),
            ("Time (ps)", step * simulation.integrator.dt),
            ("Potential Energy (kJ/mole)", pe),
            ("Kinetic Energy (kJ/mole)", ke),
            ("Total Energy (kJ/mole)", pe + ke),
            ("Temperature (K)", 2.0 * ke / (dof * BOLTZMANN)),
        ]

    def report(self, simulation, snap):
        host = _read_scalars(self._tensors(simulation, snap))
        cols = self._columns(simulation, snap, host)
        if not self._header_done:
            self.out.write(self.sep.join(f'"{n}"' for n, _ in cols) + "\n")
            self._header_done = True
        self.out.write(
            self.sep.join(
                str(v) if isinstance(v, int) else f"{v:.6g}" for _, v in cols
            )
            + "\n"
        )
        self.out.flush()


class ExtendedStateDataReporter(StateDataReporter):
    """StateDataReporter's columns, then per-force energies, virials and
    pressures (atomic and molecular), the molecular kinetic energy, the
    Coulomb energy and any global context parameters requested by name.
    The extended observables come from one evaluation
    (computers.compute_observables) on the neighbor buckets of the
    Context's state."""

    needs_full_snapshot = True
    _OBS = (
        ("atomic_virial", "Atomic Virial (kJ/mole)"),
        ("molecular_virial", "Molecular Virial (kJ/mole)"),
        ("atomic_pressure", "Atomic Pressure (bar)"),
        ("molecular_pressure", "Molecular Pressure (bar)"),
        ("molecular_kinetic_energy", "Molecular Kinetic Energy (kJ/mole)"),
    )

    def __init__(self, file, interval, separator: str = ",",
                 energy_split: bool = True,
                 pressure: bool = True,
                 coulomb_energy: bool = False,
                 global_parameters: Optional[Sequence[str]] = None):
        super().__init__(file, interval, separator)
        self.energy_split = energy_split
        self.pressure = pressure
        self.coulomb_energy = coulomb_energy
        self.global_parameters = list(global_parameters or [])

    def _tensors(self, simulation, snap):
        out = super()._tensors(simulation, snap)
        if self.energy_split:
            out.update({("split", name): value
                        for name, value in snap.energy_split.items()
                        if name != "Total"})
        if self.pressure or self.coulomb_energy:
            from .computers import compute_observables

            obs = compute_observables(simulation.system,
                                      simulation.context.state,
                                      simulation.context.parameters,
                                      self.pressure, self.coulomb_energy)
            out.update({("obs", k): v for k, v in obs.items()})
        params = simulation.context.parameters
        out.update({("param", p): torch.as_tensor(params[p])
                    for p in self.global_parameters})
        return out

    def _columns(self, simulation, snap, host):
        cols = super()._columns(simulation, snap, host)
        if self.energy_split:
            cols += [(f"{name} (kJ/mole)", host[("split", name)])
                     for name in snap.energy_split if name != "Total"]
        if self.coulomb_energy:
            cols.append(("Coulomb Energy (kJ/mole)",
                         host[("obs", "coulomb_energy")]))
        if self.pressure:
            cols += [(label, host[("obs", key)]) for key, label in self._OBS]
        cols += [(p, host[("param", p)]) for p in self.global_parameters]
        return cols


class XYZReporter(_Reporter):
    """Plain-XYZ trajectory of selected atoms. Coordinates in nm."""

    def __init__(self, file, interval, atoms: Optional[Iterable[int]] = None,
                 symbols: Optional[Sequence[str]] = None):
        super().__init__(file, interval)
        self.atoms = None if atoms is None else np.asarray(list(atoms))
        self.symbols = symbols

    def report(self, simulation, snap):
        x = snap.positions
        if self.atoms is not None:
            x = x[torch.as_tensor(self.atoms, device=x.device)]
        (x,) = _fetch(x)
        syms = self.symbols or ["X"] * len(x)
        self.out.write(f"{len(x)}\n")
        self.out.write(f"step {int(snap.step)}\n")
        for s, (a, b, c) in zip(syms, x):
            self.out.write(f"{s} {a:.6f} {b:.6f} {c:.6f}\n")
        self.out.flush()


class PDBReporter(_Reporter):
    """Multi-MODEL PDB trajectory (openmm.app.PDBReporter; io/pdb.py).
    Per-atom labels default to those parsed from a PDB when provided."""

    def __init__(self, file, interval, atom_name=None, residue_name=None,
                 residue_id=None, element=None):
        super().__init__(file, interval)
        self.labels = dict(
            atom_name=atom_name, residue_name=residue_name,
            residue_id=residue_id, element=element,
        )
        self._model = 0

    def report(self, simulation, snap):
        from .io.pdb import format_cryst1, format_model

        x, box = _fetch(snap.positions, snap.box)
        if not self._header_done:
            self.out.write(format_cryst1(box) + "\n")
            self._header_done = True
        self._model += 1
        self.out.write(f"MODEL     {self._model:4d}\n")
        for line in format_model(x, **self.labels):
            self.out.write(line + "\n")
        self.out.write("ENDMDL\n")
        self.out.flush()

    def close(self):
        if not self.out.closed:
            self.out.write("END\n")
        super().close()


class CenterOfMassReporter(_Reporter):
    """Per-molecule centre-of-mass trajectory, summed on the device by
    index_add_ over the molecule ids."""

    def report(self, simulation, snap):
        system = simulation.system
        x = snap.positions
        nm = system.num_molecules
        mol = system.molecule.long()
        m = system.masses.to(x.dtype)
        num = x.new_zeros((nm, 3)).index_add_(0, mol, m[:, None] * x)
        den = x.new_zeros((nm,)).index_add_(0, mol, m)
        (com,) = _fetch(num / den[:, None])
        self.out.write(f"{nm}\n")
        self.out.write(f"step {int(snap.step)}\n")
        for a, b, c in com:
            self.out.write(f"M {a:.6f} {b:.6f} {c:.6f}\n")
        self.out.flush()


class CustomIntegratorReporter(_Reporter):
    """Dump integrator and extended variables (State.extra), the runtime
    debugging hook."""

    def __init__(self, file, interval, keys: Optional[Sequence[str]] = None,
                 summary: bool = True):
        super().__init__(file, interval)
        self.keys = keys
        self.summary = summary

    def report(self, simulation, snap):
        extra = simulation.context.state.extra
        keys = self.keys or sorted(extra)
        values = _fetch(*(torch.as_tensor(extra[k]) for k in keys))
        self.out.write(f"# step {int(snap.step)}\n")
        for k, v in zip(keys, values):
            if self.summary and v.size > 8:
                self.out.write(
                    f"{k}: shape={v.shape} mean={v.mean():.6g} "
                    f"min={v.min():.6g} max={v.max():.6g}\n"
                )
            else:
                self.out.write(f"{k}: {np.array2string(v, precision=6)}\n")
        self.out.flush()
