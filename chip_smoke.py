#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atomsmm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, one line each; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles csrc/half_pair.cu with nvcc (sm_90a) from the checkout;
3. kernel: the half-stencil cell-pair kernel against its plain PyTorch twin
   on the card — argon 864, water 400 (full cutoff-RF, RESPA near and fused
   far), the 30k equilibrated state's near and far grids, and an atom
   crossing the periodic face between rebuilds. float64 kernel vs float64
   plain: energy rtol 1e-10, forces atol 1e-9 x max|F| (the logic).
   float32 kernel vs float64 plain on the same f32 inputs: energy rtol 1e-4,
   forces atol 1e-4 x max|F| (f32 cancellation in full - near at short
   range, rsqrt rounding, summation order);
4. slice: 5 outer RESPA steps of water 400 in float64 on the card against
   the same run on the CPU (plain twin): positions and velocities to
   1e-9 relative;
5. main path: the 30k-atom q-SPC/Fw water RESPA [4, 2, 1] @ 4 fs NVT
   headline from bench_data/eq_water30k.npz in float32: step(1), then a
   timed step(200); checks finiteness, the kernel's launch count (3 per
   outer step + 2 for the force-cache refresh, per pass of step()),
   temperature, potential energy per atom and conserved-energy drift;
6. timings: the kernel and its plain twin at the headline's near and far
   shapes, with CUDA events.

Then one JSON line of kernel results, the nvidia-smi line again, and last
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel-vs-plain tolerances (see the module docstring)
F64_RTOL, F64_FTOL = 1e-10, 1e-9
F32_RTOL, F32_FTOL = 1e-4, 1e-4


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def to_device(spec, dev):
    import dataclasses

    fields = ("nbr_cells", "exclusions", "nbr_cells_half", "inv_cells_half",
              "excbits")
    return dataclasses.replace(spec, **{
        k: getattr(spec, k).to(dev) for k in fields
        if getattr(spec, k) is not None})


def compare(label, force, spec, x, box, dev, results):
    """Kernel (f64 and f32) against the f64 plain twin on the card."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    spec = to_device(spec, dev)
    form = force._pair_form()
    r_cut = form.r_cut
    pp64 = {k: v.to(dev, torch.float64) for k, v in force._per_particle().items()}
    for dtype, rtol, ftol in ((torch.float64, F64_RTOL, F64_FTOL),
                              (torch.float32, F32_RTOL, F32_FTOL)):
        xd, bd = x.to(dev, dtype), box.to(dev, dtype)
        pp = {k: v.to(dtype) for k, v in pp64.items()}
        bucket, overflow = nb.build_cell_buckets(spec, xd, bd)
        if bool(overflow):
            raise RuntimeError(f"{label}: bucket overflow in the comparison")
        before = pk.LAUNCHES
        e_k, f_k = nb.cell_pair_energy_forces(form, xd, bd, pp, spec, bucket,
                                              r_cut)
        torch.cuda.synchronize()
        if pk.LAUNCHES != before + 1:
            raise RuntimeError(f"{label}: the wrapper did not launch the kernel")
        e_p, fb_p = nb._cell_pair_sums_half(
            spec, form, xd.double(), bd.double(),
            {k: v.double() for k, v in pp.items()}, bucket, r_cut, True)
        f_p = nb._scatter_forces(fb_p, bucket, xd.shape[0])
        e_err = abs(float(e_k) - float(e_p)) / max(abs(float(e_p)), 1e-300)
        f_err = float((f_k.double() - f_p).abs().max())
        f_max = float(f_p.abs().max())
        ok = (torch.isfinite(f_k).all().item() and e_err <= rtol
              and f_err <= ftol * f_max)
        log(f"kernel {label} {str(dtype)[6:]}: E {float(e_k):.10g} vs "
            f"{float(e_p):.10g} rel {e_err:.2e} (tol {rtol:g}); "
            f"max|dF| {f_err:.3e} of max|F| {f_max:.4g} (tol {ftol:g}x)")
        if not ok:
            raise RuntimeError(f"kernel disagrees with its plain twin: {label}")
        results.append((label, str(dtype)[6:], e_err, f_err, f_max))


def phase_kernels(dev, eq):
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import argon_system, water_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    f64 = torch.float64
    results = []
    s, x, box = argon_system(n=864, jitter=0.1, seed=7, neighbors=True,
                             dtype=f64)
    compare("argon864 LJ", s.forces[0], s.neighbors, x, box, dev, results)
    s, x, box = water_system(n_molecules=400, r_cut=0.7, r_switch=0.6, seed=5,
                             neighbors=True, dtype=f64)
    compare("water400 cutoff-RF", s.forces[0], s.neighbors, x, box, dev,
            results)
    r = amm.RESPASystem(s, rcut_in=0.45, rswitch_in=0.35)
    compare("water400 near", r.forces[1], r.extra_neighbor_specs["near"], x,
            box, dev, results)
    compare("water400 far", r.forces[2], r.neighbors, x, box, dev, results)
    ex, ev, ebox = eq
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f64)
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    r = retune_neighbor_specs(r, ex, ebox, safety=1.03)
    xe, be = torch.as_tensor(ex, dtype=f64), torch.as_tensor(ebox, dtype=f64)
    compare("water30k near", r.forces[1], r.extra_neighbor_specs["near"], xe,
            be, dev, results)
    compare("water30k far", r.forces[2], r.neighbors, xe, be, dev, results)
    # an atom crossing the periodic face between rebuilds
    s, x, box = argon_system(n=1728, jitter=0.1, seed=3, neighbors=True,
                             dtype=f64)
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    x = x.clone()
    x[7, 0] = 0.0009
    spec = to_device(s.neighbors, dev)
    bucket, _ = nb.build_cell_buckets(spec, x.to(dev), box.to(dev))
    x[7, 0] -= 0.011
    form, pp = s.forces[0]._pair_form(), s.forces[0]._per_particle()
    e_k, f_k = nb.cell_pair_energy_forces(
        form, x.to(dev), box.to(dev), {k: v.to(dev) for k, v in pp.items()},
        spec, bucket, form.r_cut)
    e_p, f_p = pk.half_pair_energy_forces(form, x, box, pp, s.neighbors,
                                          bucket.cpu(), form.r_cut)
    f_err = float((f_k.cpu() - f_p).abs().max())
    e_err = abs(float(e_k) - float(e_p)) / abs(float(e_p))
    log(f"kernel argon1728 face-crossing float64: E rel {e_err:.2e}, "
        f"max|dF| {f_err:.3e} of {float(f_p.abs().max()):.4g}")
    if e_err > F64_RTOL or f_err > F64_FTOL * float(f_p.abs().max()):
        raise RuntimeError("kernel loses pairs of an atom crossing the face")
    return results


def phase_slice(dev):
    """The whole slice on the card against the CPU, float64, 5 outer steps."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system

    f64 = torch.float64
    runs = []
    for device in ("cpu", dev):
        s, x, box = water_system(n_molecules=400, r_cut=0.7, r_switch=0.6,
                                 seed=5, neighbors=True, dtype=f64,
                                 device=device)
        r = amm.RESPASystem(s, rcut_in=0.45, rswitch_in=0.35)
        m = r.masses.cpu().numpy()
        v = np.random.RandomState(9).normal(size=(m.size, 3)) \
            * np.sqrt(amm.units.BOLTZMANN * 300.0 / m)[:, None]
        integ = amm.MultipleTimeScaleIntegrator(
            0.002, [4, 2, 1], temperature=300.0, time_scale=0.1,
            degrees_of_freedom=3 * m.size - 3)
        ctx = amm.Context(r, integ, amm.make_state(
            x, v=torch.as_tensor(v, dtype=f64, device=device), box=box))
        ctx.step(5)
        runs.append(ctx.state)
    cpu, gpu = runs
    worst = 0.0
    for a, b in ((cpu.x, gpu.x), (cpu.v, gpu.v)):
        err = float((a - b.cpu()).abs().max()) / float(a.abs().max())
        worst = max(worst, err)
    log(f"slice water400 RESPA+NHC 5 steps float64, card vs CPU: "
        f"max rel diff {worst:.2e}")
    if not worst < 1e-9:
        raise RuntimeError("the slice on the card departs from the CPU run")


def phase_main(dev, eq, steps=200):
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    f32 = torch.float32
    dt, loops = 0.004, [4, 2, 1]
    system, _, _ = water_system(n_molecules=10000, method="cutoff",
                                neighbors=True, dtype=f32, device=dev)
    respa = amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    n = system.num_particles
    integ = amm.MultipleTimeScaleIntegrator(
        dt, loops, temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * n - 3)
    ex, ev, ebox = eq
    respa = retune_neighbor_specs(respa, ex, ebox, safety=1.03)
    caps = (respa.neighbors.cell_capacity,
            respa.extra_neighbor_specs["near"].cell_capacity)
    state = amm.make_state(torch.as_tensor(ex, dtype=f32, device=dev),
                           v=torch.as_tensor(ev, dtype=f32, device=dev),
                           box=torch.as_tensor(ebox, dtype=f32, device=dev))
    ctx = amm.Context(respa, integ, state)
    ctx.step(1)
    torch.cuda.synchronize()
    e0 = float(ctx.conserved_energy())
    before = pk.LAUNCHES
    t0 = time.perf_counter()
    ctx.step(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pk.LAUNCHES - before
    e1 = float(ctx.conserved_energy())
    x, v = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(x).all() and torch.isfinite(v).all())
    temp = float(ctx.temperature())
    pe = float(ctx.get_state(lite=True).potential_energy) / n
    drift = (e1 - e0) / (n * steps * dt)
    expected = ctx.last_step_passes * (3 * steps + 2)
    ms = wall / steps * 1e3
    ns_day = dt * 1e-3 * steps / wall * 86400.0
    log(f"main water30k RESPA{loops}@{dt*1e3:.0f}fs NVT float32: caps "
        f"far/near {caps[0]}/{caps[1]} -> "
        f"{ctx.system.neighbors.cell_capacity}/"
        f"{ctx.system.extra_neighbor_specs['near'].cell_capacity}; "
        f"{ms:.3f} ms/step, {ns_day:.3f} ns/day; launches {launches} "
        f"(expected {expected}, passes {ctx.last_step_passes}); T {temp:.2f} K; "
        f"PE/atom {pe:.4f} kJ/mol; drift {drift:.5f} kJ/mol/atom/ps; "
        f"finite {finite}")
    checks = {
        "finite": finite,
        "launches": launches == expected,
        "temperature": 280.0 <= temp <= 320.0,
        "pe_per_atom": -14.6 <= pe <= -13.8,
        "drift": abs(drift) <= 0.1,
        "shape": tuple(x.shape) == (n, 3) and tuple(v.shape) == (n, 3),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"main path checks failed: {failed}")
    return {"launches": launches, "ms_per_step": ms, "ns_day": ns_day,
            "temperature": temp, "pe_per_atom": pe, "drift": drift,
            "caps": caps, "respa": respa, "state": (ex, ebox)}


def time_cuda(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timings(dev, main):
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    respa = main["respa"]
    ex, ebox = main["state"]
    f32 = torch.float32
    x = torch.as_tensor(ex, dtype=f32, device=dev)
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    out = {}
    for label, force, spec in (
            ("far", respa.forces[2], respa.neighbors),
            ("near", respa.forces[1], respa.extra_neighbor_specs["near"])):
        form = force._pair_form()
        pp = force._per_particle()
        bucket, _ = nb.build_cell_buckets(spec, x, box)
        hf, hm, _ = pk.stage(spec, x, pp, bucket)
        n = x.shape[0]
        k_ms = time_cuda(lambda: pk.half_pair_cuda(
            hf, hm, spec.nbr_cells_half, box, form, form.r_cut, n), 20)
        sweep_ms = time_cuda(lambda: nb.cell_pair_energy_forces(
            form, x, box, pp, spec, bucket, form.r_cut), 20)
        p_ms = time_cuda(lambda: pk.half_pair_plain(
            hf, hm, spec.nbr_cells_half, box, form, form.r_cut, n,
            spec.cell_chunk), 3)
        slots = spec.ncells * spec.nbr_cells_half.shape[1] \
            * spec.cell_capacity ** 2
        log(f"timing {label} grid {spec.grid} cap {spec.cell_capacity}: "
            f"kernel {k_ms:.4f} ms ({slots / k_ms / 1e6:.2f} Gslot/s), "
            f"wrapper with staging and write-back {sweep_ms:.4f} ms, "
            f"plain float32 {p_ms:.4f} ms")
        out[label] = {"ms": k_ms, "plain_ms": p_ms, "sweep_ms": sweep_ms,
                      "slots": slots}
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    import numpy as np

    from atomsmm_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s ({os.path.basename(lib_path)})")
    d = np.load(os.path.join(HERE, "bench_data", "eq_water30k.npz"))
    eq = (d["x"], d["v"], d["box"])
    results = phase_kernels(dev, eq)
    phase_slice(dev)
    main_run = phase_main(dev, eq)
    timings = phase_timings(dev, main_run)
    f32_err = max(r[3] for r in results
                  if r[1] == "float32" and r[0].startswith("water30k"))
    kernels = {"kernels": [{
        "name": "half_pair",
        "route": "cuda",
        "source": "atomsmm_tpu_torch/csrc/half_pair.cu",
        "replaces": "atomsmm_tpu/ops/pallas_pair.py:240",
        "launches": main_run["launches"],
        "max_abs_err": f32_err,
        "ms": timings["far"]["ms"],
        "plain_ms": timings["far"]["plain_ms"],
        "shape": "far grid of the 30k headline (float32)",
        "near": {"ms": timings["near"]["ms"],
                 "plain_ms": timings["near"]["plain_ms"]},
    }]}
    print(json.dumps(kernels), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
