"""Profiling and tracing (counterpart of atomsmm_tpu/profiling.py).

`profile_forces` times each force group's evaluation and `profile_step`
the whole outer step, with the JAX package's keys and units
(milliseconds). The JAX package iterates the measured function inside one
jitted loop, so its times leave the dispatch out; eager PyTorch launches
every operation from the host, so the port's times include the launches:
on the card each group's time is the larger of its device work and its
launch rate. `trace` writes a torch.profiler Chrome trace.

>>> import torch
>>> from atomsmm_tpu_torch import Context, VelocityVerletIntegrator, make_state
>>> from atomsmm_tpu_torch.models import argon_system
>>> system, x, box = argon_system(n=64, jitter=0.05, seed=1, r_cut=0.5,
...                               r_switch=0.4, device="cpu")
>>> ctx = Context(system, VelocityVerletIntegrator(0.002), make_state(x, box=box))
>>> sorted(profile_forces(ctx, reps=2))
['group 0', 'overhead']
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from .ops.neighbors import make_aux
from .potential import force_fn


def _timed(run, device) -> float:
    """Seconds taken by run(): CUDA events on the card (the stream is
    synchronized at the end), the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _inloop_time(fn, x, reps: int = 30, tries: int = 3) -> float:
    """Best-of-`tries` time per call of fn(x) -> (N, 3), over `reps`
    chained calls (each call's input depends on the last call's output,
    acc + fn(x + 1e-30 acc), so that none can overlap the next). Returns
    milliseconds. The launches are inside the time (module docstring)."""

    def loop():
        acc = torch.zeros_like(x)
        for _ in range(reps):
            acc = acc + fn(x + 1e-30 * acc)
        return acc

    loop()  # warm-up (kernel builds, allocator)
    best = min(_timed(loop, x.device) for _ in range(tries))
    return best / reps * 1e3


def profile_forces(context, reps: int = 30) -> Dict[str, float]:
    """ms per evaluation for every force group of a Context's system, on
    the buckets of its state, plus the measurement floor ("overhead": the
    chained loop around an identity)."""
    system = context.system
    state = context.state
    aux = make_aux(system, state.extra)
    out = {"overhead": _inloop_time(lambda xx: xx * 1.0, state.x, reps)}
    for g in system.force_groups:
        out[f"group {g}"] = _inloop_time(
            lambda xx, g=g: force_fn(system, {g})(
                xx, state.box, context.parameters, aux
            )[1],
            state.x,
            reps,
        )
    return out


def profile_step(context, steps: int = 100, tries: int = 3) -> float:
    """ms per outer step, end to end (neighbor rebuilds, thermostats,
    barostat attempts and step(n)'s one read of its flags included), best
    of `tries` calls of step(steps) after a warm step(1)."""
    context.step(1)
    best = min(_timed(lambda: context.step(steps), context.state.x.device)
               for _ in range(tries))
    return best / steps * 1e3


@contextlib.contextmanager
def trace(path: str):
    """Context manager that profiles its body with torch.profiler (CPU
    activity, and CUDA activity when a card is present) and writes a
    Chrome trace into the directory `path` (open it in Perfetto or
    chrome://tracing): ``with trace("traces"): ctx.step(100)``. Yields the
    profiler; its ``trace_file`` names the file once the block exits."""
    os.makedirs(path, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.trace_file = os.path.join(
        path, f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(prof.trace_file)
