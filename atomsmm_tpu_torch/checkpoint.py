"""Checkpoint / resume and System files (counterpart of
atomsmm_tpu/checkpoint.py).

The port's State is a plain dataclass holding a torch.Generator, not a
pytree, so a checkpoint stores named fields under a schema of the port's
own (``atomsmm_tpu_torch-state-v1``): x, v, box, the outer-step counter,
every extended variable as ``extra/<key>`` and the generator's
``get_state()`` bytes. ``load_checkpoint(path, like)`` restores onto the
devices and dtypes of ``like``, the generator by ``set_state`` on a new
generator of ``like.rng``'s device: a restored state equals the saved one
bit for bit, and on the CPU continues bit for bit.

``save_system`` / ``load_system`` take the place of OpenMM's
XmlSerializer: every System, Force and spec of the port is a dataclass, so
the file records each class by its import path with its fields, tensors in
the npz payload and structure in a JSON header, a float by its ``repr``.
Loading imports classes only from modules under ``atomsmm_tpu_torch.``. A
force that holds a Python callable (CustomNonbondedForce, CustomBondForce)
cannot be saved.

>>> import io, torch
>>> from atomsmm_tpu_torch.state import make_state
>>> s = make_state(torch.zeros(2, 3), box=torch.full((3,), 2.0), seed=4)
>>> buf = io.BytesIO()
>>> save_checkpoint(buf, s.with_extra(nhc_v=torch.ones(2)))
>>> _ = buf.seek(0)
>>> r = load_checkpoint(buf, like=s.with_extra(nhc_v=torch.zeros(2)))
>>> r.extra["nhc_v"].tolist(), r.step
([1.0, 1.0], 0)
>>> bool(torch.equal(r.rng.get_state(), s.rng.get_state()))
True
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import warnings

import numpy as np
import torch

from .state import State
from .utils import replace, resolve_device

_SCHEMA = "atomsmm_tpu_torch-state-v1"
_SYS_SCHEMA = "atomsmm_tpu_torch-system-v1"
_PACKAGE = "atomsmm_tpu_torch."


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_checkpoint(path, state: State) -> None:
    """Write `state` (positions, velocities, box, step, every extended
    variable and the generator's state) to one npz file."""
    np.savez(
        path,
        __schema__=np.asarray(_SCHEMA),
        __extra_keys__=np.asarray(sorted(state.extra), dtype=str),
        x=_host(state.x), v=_host(state.v), box=_host(state.box),
        step=np.asarray(int(state.step), np.int64),
        rng=_host(state.rng.get_state()),
        **{f"extra/{k}": _host(v) for k, v in state.extra.items()},
    )


def _like(a: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """The saved array on t's device in t's dtype, row-major."""
    return torch.as_tensor(a).to(device=t.device, dtype=t.dtype).contiguous()


def load_checkpoint(path, like: State) -> State:
    """Restore a state saved by save_checkpoint onto the devices and dtypes
    of `like` (the system and integrator decide which extended variables a
    state carries). Extended variables added since the save (a new
    zero-initialized counter, say) are taken fresh from `like` with a
    warning; a saved variable that `like` lacks raises, since dropping
    saved dynamics would not be an exact resume."""
    with np.load(path, allow_pickle=False) as data:
        schema = str(data["__schema__"])
        if schema != _SCHEMA:
            raise ValueError(f"unknown checkpoint schema {schema!r}")
        saved_keys = [str(k) for k in data["__extra_keys__"]]
        cur_keys = sorted(like.extra)
        missing = [k for k in cur_keys if k not in saved_keys]
        unknown = [k for k in saved_keys if k not in cur_keys]
        if unknown:
            raise ValueError(
                "checkpoint extended variables do not match the current "
                f"integrator: saved {saved_keys}, expected {cur_keys}")
        if missing:
            warnings.warn(
                f"checkpoint predates extended variables {missing}; "
                "initializing them fresh (everything else resumes exactly)",
                stacklevel=2)
        extra = {k: (like.extra[k] if k in missing
                     else _like(data[f"extra/{k}"], like.extra[k]))
                 for k in cur_keys}
        rng = torch.Generator(device=like.rng.device)
        rng.set_state(torch.as_tensor(data["rng"]))
        return replace(like, x=_like(data["x"], like.x),
                       v=_like(data["v"], like.v),
                       box=_like(data["box"], like.box), rng=rng,
                       step=int(data["step"]), extra=extra)


# ---------------------------------------------------------------------------
# System files
# ---------------------------------------------------------------------------


def _serialize(obj, arrays: dict):
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return {"__float__": repr(obj)}  # exact round trip
    if isinstance(obj, (torch.Tensor, np.ndarray)) or np.isscalar(obj):
        key = f"a{len(arrays)}"
        arrays[key] = _host(obj)
        return {"__array__": key}
    if isinstance(obj, tuple):
        return {"__tuple__": [_serialize(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return {"__list__": [_serialize(v, arrays) for v in obj]}
    if isinstance(obj, dict):
        return {"__dict__": {k: _serialize(v, arrays) for k, v in obj.items()}}
    if dataclasses.is_dataclass(obj):
        cls = type(obj)
        if not cls.__module__.startswith(_PACKAGE):
            raise TypeError(f"cannot serialize foreign dataclass {cls}")
        fields = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if callable(v) and not isinstance(v, torch.Tensor):
                raise TypeError(
                    f"{cls.__name__}.{f.name} is a Python callable and cannot "
                    "be serialized (OpenMM stores Lepton strings; rebuild "
                    "Custom*Force objects in code after loading)")
            fields[f.name] = _serialize(v, arrays)
        return {"__class__": f"{cls.__module__}:{cls.__qualname__}",
                "fields": fields}
    raise TypeError(f"cannot serialize {type(obj)!r}")


def _deserialize(node, data, device):
    if node is None or isinstance(node, (bool, int, str)):
        return node
    if isinstance(node, dict):
        if "__float__" in node:
            return float(node["__float__"])
        if "__array__" in node:
            return torch.as_tensor(data[node["__array__"]], device=device)
        if "__tuple__" in node:
            return tuple(_deserialize(v, data, device)
                         for v in node["__tuple__"])
        if "__list__" in node:
            return [_deserialize(v, data, device) for v in node["__list__"]]
        if "__dict__" in node:
            return {k: _deserialize(v, data, device)
                    for k, v in node["__dict__"].items()}
        if "__class__" in node:
            mod_name, qual = node["__class__"].split(":")
            # only this package's modules: a name of another package (the
            # JAX package's included) is never imported
            if not mod_name.startswith(_PACKAGE):
                raise ValueError(f"refusing to import {mod_name!r}")
            cls = importlib.import_module(mod_name)
            for part in qual.split("."):
                cls = getattr(cls, part)
            return cls(**{k: _deserialize(v, data, device)
                          for k, v in node["fields"].items()})
    raise ValueError(f"cannot deserialize node {node!r}")


def save_system(path, system) -> None:
    """Serialize a System (forces, parameters, neighbor specs, constraints,
    virtual sites) so that a run can resume without the code that made
    it."""
    arrays: dict = {}
    tree = _serialize(system, arrays)
    np.savez(path, __schema__=np.asarray(_SYS_SCHEMA),
             __tree__=np.asarray(json.dumps(tree)), **arrays)


def load_system(path, device=None):
    """The System saved by save_system, its tensors on `device` (default:
    the CUDA card; without one pass device="cpu") in their saved dtypes."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        schema = str(data["__schema__"])
        if schema != _SYS_SCHEMA:
            raise ValueError(f"unknown system schema {schema!r}")
        tree = json.loads(str(data["__tree__"]))
        return _deserialize(tree, data, device)
