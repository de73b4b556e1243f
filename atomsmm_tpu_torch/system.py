"""System container (counterpart of atomsmm_tpu/system.py).

A `System` owns particle masses, molecule assignment and a tuple of Force
objects, each carrying its RESPA force group. Transformations build new
systems (`replace`) instead of editing one in place. `molecule_centres` and
`molecular_scale` work on its molecule assignment (the barostat's molecular
scaling, the molecular virial).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .utils import replace, resolve_device


@dataclasses.dataclass
class System:
    """Simulation system.

    Attributes:
      masses: (N,) particle masses [amu].
      forces: tuple of Force objects.
      molecule: (N,) molecule id per atom.
      default_box: (3,) box lengths used when building the initial State.
      neighbors: the default NeighborSpec, or None (dense pair path).
      extra_neighbor_specs: name -> NeighborSpec (e.g. 'near').
      num_molecules, num_constraints, remove_com_motion: counts and flags
        for degree-of-freedom bookkeeping.
    """

    masses: torch.Tensor = None
    forces: Tuple = ()
    molecule: torch.Tensor = None
    default_box: torch.Tensor = None
    neighbors: object = None
    extra_neighbor_specs: dict = None
    num_molecules: int = 0
    num_constraints: int = 0
    remove_com_motion: bool = True

    def with_neighbors(self, spec, **named) -> "System":
        """Attach the default NeighborSpec (and optionally named ones, e.g.
        near=<finer spec>): Contexts built from this system use the cell-list
        path for nonbonded forces."""
        extra = dict(self.extra_neighbor_specs or {})
        extra.update(named)
        return replace(self, neighbors=spec, extra_neighbor_specs=extra or None)

    @property
    def num_particles(self) -> int:
        return self.masses.shape[0]

    def add_force(self, force) -> "System":
        """A new system with `force` appended (this one is left as it was).

        >>> import torch
        >>> from atomsmm_tpu_torch.forces import MonteCarloBarostat
        >>> s = System(masses=torch.ones(2), default_box=torch.full((3,), 2.0))
        >>> npt = s.add_force(MonteCarloBarostat(pressure=1.0, frequency=25))
        >>> [f.name for f in npt.forces], len(s.forces)
        (['MonteCarloBarostat'], 0)
        """
        return replace(self, forces=tuple(self.forces) + (force,))

    def replace_forces(self, forces) -> "System":
        return replace(self, forces=tuple(forces))


def molecule_centres(x, molecule, num_molecules, masses):
    """(N, 3): the centre of mass of each atom's molecule, by index_add_
    over the molecule ids."""
    mol = molecule.long()
    mw = masses[:, None].to(x.dtype)
    com = (x.new_zeros((num_molecules, 3)).index_add_(0, mol, mw * x)
           / x.new_zeros((num_molecules, 1)).index_add_(0, mol, mw))
    return com[mol]


def molecular_scale(x, molecule, num_molecules, masses, s):
    """Scale the molecules' centres of mass by s, keeping each molecule's
    geometry."""
    return x + (s - 1.0) * molecule_centres(x, molecule, num_molecules,
                                            masses)


def make_exclusions_array(n: int, pairs, device=None):
    """Build the (N, M) padded exclusion table from a list of (i, j) pairs.

    Symmetric: each pair is recorded on both rows. Padded with -1. On
    `device` (default: the CUDA card; without one pass device="cpu").
    """
    lists = [[] for _ in range(n)]
    for i, j in pairs:
        i, j = int(i), int(j)
        lists[i].append(j)
        lists[j].append(i)
    m = max(max((len(l) for l in lists), default=0), 1)
    out = np.full((n, m), -1, dtype=np.int32)
    for i, l in enumerate(lists):
        out[i, : len(l)] = sorted(l)
    return torch.as_tensor(out, device=resolve_device(device))
