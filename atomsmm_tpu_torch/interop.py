"""Carry systems and states across from the JAX package.

The exchange format is a plain dict of numpy arrays and Python scalars:

  * ``describe_reference(obj)`` builds it from a JAX-package ``System`` or
    ``State`` (or any of their dataclass members). It is duck-typed —
    ``dataclasses.fields`` and ``np.asarray`` only — so it works without
    importing JAX. Each dataclass becomes ``{"__class__": name, field: ...}``.
  * ``system_from_numpy(desc)`` and ``state_from_numpy(desc)`` turn such a
    dict into this package's objects, on the requested device (default:
    the CUDA card; without one pass device="cpu") and dtype.
    A field this package does not port raises NotImplementedError unless its
    value is the inert default (None, no NBFIX table...).

The constraint sets of a rigid system (ConstraintSet, SettleSet,
VirtualSiteSet) and the DrudeSet of a DrudeForce cross with their index
arrays as integers (the sets hold them as int64); CMAPTorsionForce's table
crosses as a float array in the requested dtype.

A force that holds a Python function (CustomNonbondedForce,
CustomBondForce) does not cross: a JAX function is not a torch one. To
carry an alchemical system, describe the JAX base system and apply this
package's own SolvationSystem / AlchemicalRespaSystem to the result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .forces import (
    CMAPTorsionForce,
    DampedSmoothedForce,
    DrudeForce,
    FarNonbondedForce,
    HarmonicAngleForce,
    HarmonicBondForce,
    HarmonicImproperForce,
    MonteCarloBarostat,
    NearNonbondedForce,
    NonbondedExceptionsForce,
    NonbondedForce,
    PeriodicTorsionForce,
    PMEReciprocalForce,
    SoftcoreLennardJonesForce,
    TemplateBondedForce,
)
from .ops.constraints import ConstraintSet
from .ops.drude import DrudeSet
from .ops.neighbors import NeighborSpec
from .ops.settle import SettleSet
from .ops.virtual_sites import VirtualSiteSet
from .state import State
from .system import System
from .utils import resolve_device

_CLASSES = {c.__name__: c for c in (
    System, NonbondedForce, NearNonbondedForce, FarNonbondedForce,
    PMEReciprocalForce, NonbondedExceptionsForce, TemplateBondedForce,
    HarmonicBondForce, HarmonicAngleForce, PeriodicTorsionForce,
    DampedSmoothedForce, SoftcoreLennardJonesForce, MonteCarloBarostat,
    NeighborSpec, ConstraintSet, SettleSet, VirtualSiteSet, DrudeSet,
    DrudeForce, CMAPTorsionForce, HarmonicImproperForce)}

# JAX-package fields with no counterpart here, and the values at which they
# change nothing on the ported path
_INERT = {
    "backend": lambda v: True,             # the tensors' device decides
    # the TPU's block-binned PME spreading layouts: they change how the JAX
    # package spreads, not the grid it gets, and the port scatters every
    # atom afresh at each evaluation, so any value carries over as no change
    "spread_block": lambda v: True,
    "spread_cap": lambda v: True,
    "spread_pad": lambda v: True,
}


def describe_reference(obj):
    """Plain-dict description of a JAX-package object (see module doc)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__class__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = describe_reference(getattr(obj, f.name))
        return out
    if isinstance(obj, (tuple, list)):
        return [describe_reference(o) for o in obj]
    if isinstance(obj, dict):
        return {k: describe_reference(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if callable(obj):
        raise TypeError(
            f"cannot describe a callable ({obj!r}): a force that holds a "
            "Python function (CustomNonbondedForce, CustomBondForce, such as "
            "the solute-solute force of a SolvationSystem) does not cross; "
            "describe the base system instead and apply atomsmm_tpu_torch's "
            "own SolvationSystem / AlchemicalRespaSystem to the system it "
            "gives")
    return np.asarray(obj)


def _tupled(v):
    return tuple(_tupled(e) for e in v) if isinstance(v, list) else v


def _tensor(a: np.ndarray, dtype, device):
    """Float arrays in `dtype`, integer arrays as int32, the rest as is."""
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=dtype, device=device)
    if a.dtype.kind in "iu":
        return torch.tensor(a.astype(np.int32), device=device)
    return torch.tensor(a, device=device)


def _value(v, dtype, device):
    if isinstance(v, dict) and "__class__" in v:
        return _build(v, dtype, device)
    if isinstance(v, dict):
        return {k: _value(e, dtype, device) for k, e in v.items()}
    if isinstance(v, list):
        if v and isinstance(v[0], dict):
            return tuple(_value(e, dtype, device) for e in v)
        return _tupled(v)
    if isinstance(v, np.ndarray):
        return v.item() if v.ndim == 0 else _tensor(v, dtype, device)
    return v


def _build(desc, dtype, device):
    name = desc["__class__"]
    cls = _CLASSES.get(name)
    if cls is None:
        raise NotImplementedError(f"{name} is not ported to atomsmm_tpu_torch")
    own = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in desc.items():
        if k == "__class__":
            continue
        if k not in own:
            if v is None or (k in _INERT and _INERT[k](v)):
                continue
            raise NotImplementedError(
                f"{name}.{k} = {v!r} has no counterpart in atomsmm_tpu_torch")
        kwargs[k] = _value(v, dtype, device)
    return cls(**kwargs)


def system_from_numpy(desc, dtype=None, device=None) -> System:
    """This package's System from a `describe_reference` dict, on `device`
    (default: the CUDA card)."""
    return _build(desc, dtype or torch.get_default_dtype(),
                  resolve_device(device))


def state_from_numpy(desc, dtype=None, device=None, seed: int = 0) -> State:
    """This package's State from a `describe_reference` dict (or a plain
    dict with x, v, box and optionally step and extra). The JAX key is not
    carried over: the state gets a torch.Generator seeded with `seed`. On
    `device` (default: the CUDA card).

    A JAX stacked state (replicate_state's, x (K, N, 3) and a leading K on
    every array) gives the stacked State, its K generators seeded from
    (seed, k) as parallel.replicas.replicate_state seeds them."""
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    x = _tensor(np.asarray(desc["x"]), dtype, device)
    if x.ndim == 3:
        from .parallel.replicas import replica_generators

        rng = replica_generators(x.shape[0], seed, x.device)
    else:
        rng = torch.Generator(device=x.device)
        rng.manual_seed(seed)
    extra = {k: _tensor(np.asarray(v), dtype, device)
             for k, v in (desc.get("extra") or {}).items()}
    return State(
        x=x,
        v=_tensor(np.asarray(desc["v"]), dtype, device),
        box=_tensor(np.asarray(desc["box"]), dtype, device),
        rng=rng,
        step=int(np.asarray(desc.get("step", 0)).reshape(-1)[0]),
        extra=extra,
    )
