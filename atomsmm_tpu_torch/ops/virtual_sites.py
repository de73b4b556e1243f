"""Virtual sites: massless interaction sites such as TIP4P's M (counterpart
of atomsmm_tpu/ops/virtual_sites.py).

The placement is a coordinate transformation: the potential is evaluated
at `place_virtual_sites(x)`, whose virtual rows are rebuilt from their
parents, and the forces on the placed coordinates are pulled back onto the
parent atoms by the vector-Jacobian product of the placement
(potential.force_fn, through torch.autograd.grad). That is the chain-rule
redistribution for every site type, and it leaves the virtual rows exactly
zero: the placed value does not depend on them.

One parametrization covers the three OpenMM site types:

    x_v = w1 p1 + w2 p2 + w3 p3 + oop * ((p2 - p1) x (p3 - p1))

  TwoParticleAverage:   w3 = 0, oop = 0
  ThreeParticleAverage: oop = 0            (TIP4P's M site)
  OutOfPlane:           any w, oop != 0    (TIP5P's lone pairs)

A virtual site carries no kinetic degrees of freedom
(utils.count_degrees_of_freedom); its velocity is pinned to zero after
every move and kick (propagators._project_velocities).

Examples — a TIP4P-like M site 0.015 nm from O along the HOH bisector:

>>> import math
>>> import torch
>>> f64 = torch.float64
>>> r_oh, theta, d_om = 0.09572, 1.82421813, 0.015
>>> s, c_ = math.sin(theta / 2), math.cos(theta / 2)
>>> x = torch.tensor([[0.0, 0.0, 0.0], [r_oh * s, r_oh * c_, 0.0],
...                   [-r_oh * s, r_oh * c_, 0.0],
...                   [99.0, 99.0, 99.0]], dtype=f64)  # M row: replaced
>>> c = d_om / (2 * r_oh * c_)
>>> vs = VirtualSiteSet(sites=torch.tensor([3]),
...                     parents=torch.tensor([[0, 1, 2]]),
...                     weights=torch.tensor([[1.0 - 2 * c, c, c]], dtype=f64),
...                     oop=torch.zeros(1, dtype=f64))
>>> xp = place_virtual_sites(vs, x)
>>> abs(float(torch.linalg.norm(xp[3] - xp[0])) - d_om) < 1e-12
True
>>> abs(float(xp[3, 0])) < 1e-12                  # on the bisector
True
>>> bool(torch.equal(xp[:3], x[:3]))              # parents untouched
True
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import InputError


@dataclasses.dataclass
class VirtualSiteSet:
    """sites (V,) virtual atom indices; parents (V, 3) (both held as
    int64); weights (V, 3) linear coefficients; oop (V,) out-of-plane
    coefficient [1/nm] multiplying (p2 - p1) x (p3 - p1)."""

    sites: torch.Tensor = None
    parents: torch.Tensor = None
    weights: torch.Tensor = None
    oop: torch.Tensor = None

    def __post_init__(self):
        if self.sites is not None:
            self.sites = torch.as_tensor(self.sites).long()
        if self.parents is not None:
            self.parents = torch.as_tensor(self.parents).long()

    @property
    def size(self) -> int:
        return 0 if self.sites is None else self.sites.shape[0]


def validate_virtual_sites(vs: VirtualSiteSet):
    """Host-side construction check: placement is a single gather-and-set
    pass over the original coordinates, so a virtual site whose parent is
    itself a virtual site would read the stale stored row. Reject chained
    sites and duplicate site rows. Returns vs unchanged."""
    if vs is None or vs.size == 0:
        return vs
    sites = vs.sites.cpu().numpy()
    if len(np.unique(sites)) != len(sites):
        raise InputError("duplicate virtual-site indices")
    chained = np.intersect1d(sites, vs.parents.cpu().numpy().ravel())
    if chained.size:
        raise InputError(
            f"virtual sites {chained.tolist()} are parents of other virtual "
            "sites; chained (dependent) virtual sites are not supported by "
            "the single-pass placement — express the dependent site "
            "directly in terms of real atoms")
    return vs


def place_virtual_sites(vs: VirtualSiteSet, x):
    """x with every virtual-site row replaced by its construction."""
    p1, p2, p3 = x[vs.parents].unbind(1)
    w = vs.weights
    pos = w[:, 0:1] * p1 + w[:, 1:2] * p2 + w[:, 2:3] * p3
    pos = pos + vs.oop[:, None] * torch.linalg.cross(p2 - p1, p3 - p1, dim=-1)
    return x.index_copy(0, vs.sites, pos)


def pull_back_forces(vs: VirtualSiteSet, x, f):
    """The forces f on the placed coordinates, pulled back onto the parents:
    the vector-Jacobian product of place_virtual_sites at x. The virtual
    rows of the result are zero."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(place_virtual_sites(vs, xx), xx,
                                   grad_outputs=f)
    return g


def zero_virtual_velocities(vs: VirtualSiteSet, v):
    """Pin the virtual-site velocity rows to zero (they receive no kicks,
    and a stochastic bath must not give them noise)."""
    return v.index_fill(0, vs.sites, 0.0)
