#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atomsmm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, one line each or more; any failure raises and the script exits
non-zero:

1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles csrc/half_pair.cu (K1), csrc/cell_pair.cu (K2) and
   csrc/tile_pair.cu (K3) with nvcc (sm_90a) from the checkout, one nvcc
   per source, all at once;
3. kernels against their plain PyTorch twins on the card. float64 kernel
   vs float64 plain: energy rtol 1e-10, forces atol 1e-9 x max|F| (the
   logic). float32 kernel vs float64 plain on the same f32 inputs: energy
   rtol 1e-4, forces atol 1e-4 x max|F| (f32 cancellation in full - near at
   short range, rsqrt rounding, summation order);
   - K1: argon 864, water 400 (full cutoff-RF, RESPA near and fused far),
     the 30k equilibrated state's near and far grids, an atom crossing the
     periodic face between rebuilds, and water 400 renumbered so that no
     exclusion bitmask fits (the exclusion-column form);
   - K2: water 216 (one cell of 1,112 slots), the water 400 and water 700
     far grids at 0.9 nm (full cutoff-RF and fused far forms), the
     renumbered water 400, and a face crossing. Water 216's lattice energy
     is a near-cancellation (-69 kJ/mol of terms summing to thousands), so
     its float32 energy is held to 1e-4 of the sum of the per-atom energy
     magnitudes instead of the total;
   - K3: the 30k state's tile lists (0.9 nm fused far, 0.5 nm near) against
     the plain twin, then against K1 in float64 at the same tolerances (the
     same pairs inside the cutoff), then after moving every atom by at most
     skin/4, staged with xref, against K1 on fresh buckets;
4. slices: 5 outer RESPA+NHC steps of water 400 in float64 on the card
   against the same run on the CPU (plain twins), at 0.7 nm (K1 on both
   grids) and at the default 0.9 nm (K2 far, K1 near): positions and
   velocities to 1e-9 relative;
5. main path: the 30k-atom q-SPC/Fw water RESPA [4, 2, 1] @ 4 fs NVT
   headline from bench_data/eq_water30k.npz in float32: step(1), then a
   timed step(200); checks finiteness, K1's launch count (3 per outer
   step + 2 for the force-cache refresh, per pass of step()), temperature,
   potential energy per atom and conserved-energy drift;
6. path (a): small-box water (700 molecules, 2.759 nm box, default 0.9 nm
   cutoff) RESPA [4, 2, 1] @ 4 fs NVT in float32 from the lattice, melted by
   chunked velocity rescaling, then step(1) and a timed step(200); checks
   finiteness, the K2 (far: 1 per outer step + 1) and K1 (near: 2 per
   outer step + 1) launch counts, temperature and drift;
7. path (b): the tile-list entry point at the 30k state: build_tile_pairs
   and tile_pair_energy_forces for the fused far form and the near form in
   float32 and float64 (4 K3 launches), finite and Newton-balanced;
8. timings with CUDA events: K1 and its plain twin at the headline's near
   and far shapes; K2 and its plain twin on the water 700 far grid; K3, its
   wrapper and its plain twin at the 30k near and far lists; the two list
   builds at 30k.

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


def plain_sweep(spec, form, x, box, pp, bucket):
    """The plain twin of the sweep the spec selects, float64, on the
    device of x: (energy, forces, sum of |per-atom energy|)."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f64 = torch.float64
    x, box = x.to(f64), box.to(f64)
    pp = {k: v.to(f64) for k, v in pp.items()}
    hf, hm, cols = pk.stage(spec, x, pp, bucket)
    n = x.shape[0]
    if spec.half_stencil:
        oh, oc = pk.half_pair_plain(hf, hm, spec.nbr_cells_half, box, form,
                                    form.r_cut, n, spec.cell_chunk, cols)
        e_i = oh[..., 3].sum(dim=1)
        f_bucket = pk.half_writeback(oh, oc, spec.inv_cells_half)
    else:
        out = pk.full_pair_plain(hf, hm, spec.nbr_cells, box, form,
                                 form.r_cut, n, spec.cell_chunk, cols)
        e_i, f_bucket = out[..., 3], out[..., :3]
    return (e_i.sum(), nb._scatter_forces(f_bucket, bucket, n),
            float(e_i.abs().sum()))


def judge(label, dtype, e_k, f_k, e_p, f_p, e_scale=None):
    """Hold (e_k, f_k) against the float64 reference (e_p, f_p) at the
    tolerances of `dtype`; e_scale replaces |e_p| as the energy scale."""
    import torch

    rtol, ftol = ((F64_RTOL, F64_FTOL) if dtype == torch.float64
                  else (F32_RTOL, F32_FTOL))
    scale = abs(float(e_p)) if e_scale is None else e_scale
    e_err = abs(float(e_k) - float(e_p)) / max(scale, 1e-300)
    f_err = float((f_k.double() - f_p.double()).abs().max())
    f_max = float(f_p.abs().max())
    ok = (bool(torch.isfinite(f_k).all()) and e_err <= rtol
          and f_err <= ftol * f_max)
    log(f"kernel {label} {str(dtype)[6:]}: E {float(e_k):.10g} vs "
        f"{float(e_p):.10g} rel {e_err:.2e} (tol {rtol:g}"
        f"{'' if e_scale is None else ' of sum|e_i|'}); "
        f"max|dF| {f_err:.3e} of max|F| {f_max:.4g} (tol {ftol:g}x)")
    if not ok:
        raise RuntimeError(f"kernel disagrees with its reference: {label}")
    return (label, str(dtype)[6:], e_err, f_err, f_max)


def compare(label, force, spec, x, box, dev, results, terms_scale=False):
    """The wrapper's kernel (f64 and f32) against the f64 plain twin on the
    card; the spec picks K1 (half maps) or K2."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    spec = to_device(spec, dev)
    kernel = "half_pair" if spec.half_stencil else "cell_pair"
    form = force._pair_form()
    pp64 = {k: v.to(dev, torch.float64)
            for k, v in force._per_particle().items()}
    for dtype in (torch.float64, torch.float32):
        xd, bd = x.to(dev, dtype), box.to(dev, dtype)
        pp = {k: v.to(dtype) for k, v in pp64.items()}
        bucket, overflow = nb.build_cell_buckets(spec, xd, bd)
        if bool(overflow):
            raise RuntimeError(f"{label}: bucket overflow in the comparison")
        before = dict(pk.LAUNCHES)
        e_k, f_k = nb.cell_pair_energy_forces(form, xd, bd, pp, spec, bucket,
                                              form.r_cut)
        torch.cuda.synchronize()
        if pk.LAUNCHES != {**before, kernel: before[kernel] + 1}:
            raise RuntimeError(f"{label}: the wrapper did not launch {kernel}")
        e_p, f_p, terms = plain_sweep(spec, form, xd, bd, pp, bucket)
        scale = terms if terms_scale and dtype == torch.float32 else None
        results.append((kernel,) + judge(f"{kernel} {label}", dtype, e_k,
                                         f_k, e_p, f_p, scale))


def permuted(force, x, box, r_cut):
    """The nonbonded force, its spec and positions with the atoms renumbered
    by a fixed permutation: excluded pairs lie far more than +-14 indices
    apart, so no exclusion bitmask fits and the sweeps take the id
    columns."""
    import dataclasses

    import numpy as np
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb

    n = x.shape[0]
    p = np.random.RandomState(3).permutation(n)
    inv = np.argsort(p)
    exc = force.exclusions.cpu().numpy()[p]
    exc = np.where(exc >= 0, inv[np.maximum(exc, 0)], -1).astype(np.int32)
    pt = torch.as_tensor(p)
    force = dataclasses.replace(
        force, exclusions=torch.as_tensor(exc),
        **{k: v[pt] for k, v in force._per_particle().items()})
    spec = nb.make_neighbor_spec(box, n, r_cut, exclusions=exc,
                                 occupancy_floor_from=x[pt])
    if spec.excbits is not None:
        raise RuntimeError("the renumbered water still fits the bitmask")
    return force, spec, x[pt]


def face_crossing(label, system, x, box, dev):
    """Bucket at x with atom 0 just inside the x = 0 face, move it 0.011 nm
    across the face and evaluate on the card against the CPU plain twin."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb

    x = x.clone()
    x[0, 0] = 0.0009
    spec = to_device(system.neighbors, dev)
    bucket, _ = nb.build_cell_buckets(spec, x.to(dev), box.to(dev))
    x[0, 0] -= 0.011
    force = system.forces[0]
    form, pp = force._pair_form(), force._per_particle()
    e_k, f_k = nb.cell_pair_energy_forces(
        form, x.to(dev), box.to(dev), {k: v.to(dev) for k, v in pp.items()},
        spec, bucket, form.r_cut)
    e_p, f_p = nb.cell_pair_energy_forces(form, x, box, pp, system.neighbors,
                                          bucket.cpu(), form.r_cut)
    judge(f"{label} face-crossing", torch.float64, e_k, f_k.cpu(), e_p, f_p)


def phase_kernels(dev, eq):
    """K1 and K2 against their plain twins."""
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
    pf, pspec, px = permuted(s.forces[0], x, box, 0.7)
    compare("water400 renumbered (exclusion columns)", pf, pspec, px, box,
            dev, results)
    ex, ev, ebox = eq
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f64)
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    r = retune_neighbor_specs(r, ex, ebox, safety=1.03)
    xe, be = torch.as_tensor(ex, dtype=f64), torch.as_tensor(ebox, dtype=f64)
    compare("water30k near", r.forces[1], r.extra_neighbor_specs["near"], xe,
            be, dev, results)
    compare("water30k far", r.forces[2], r.neighbors, xe, be, dev, results)
    s, x, box = argon_system(n=1728, jitter=0.1, seed=3, neighbors=True,
                             dtype=f64)
    face_crossing("half_pair argon1728", s, x, box, dev)

    # K2: grids too small for half maps at the default 0.9 nm cutoff
    s, x, box = water_system(n_molecules=216, seed=5, neighbors=True,
                             dtype=f64)
    if s.neighbors.cell_capacity <= 1024 or s.neighbors.ncells != 1:
        raise RuntimeError("water 216 should fill one cell above 1,024 slots")
    compare("water216 one cell cap 1112", s.forces[0], s.neighbors, x, box,
            dev, results, terms_scale=True)
    for m in (400, 700):
        s, x, box = water_system(n_molecules=m, seed=5, neighbors=True,
                                 dtype=f64)
        r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
        tag = f"water{m} grid {s.neighbors.grid[0]}^3 cap " \
              f"{s.neighbors.cell_capacity}"
        compare(f"{tag} cutoff-RF", s.forces[0], s.neighbors, x, box, dev,
                results)
        compare(f"{tag} far", r.forces[2], r.neighbors, x, box, dev, results)
        if m == 400:
            pf, pspec, px = permuted(s.forces[0], x, box, 0.9)
            compare("water400 renumbered (exclusion columns)", pf, pspec, px,
                    box, dev, results)
            face_crossing("cell_pair water400", s, x, box, dev)
    return results


def tile_lists(dev, eq, dtype):
    """{'far'/'near': (force, tile spec, list, cell spec)} at the 30k state
    on the card, with the cell specs of the headline retuned as phase 5."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import tilepair as tp
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    ex, _, ebox = eq
    s, _, _ = water_system(n_molecules=10000, neighbors=True,
                           dtype=torch.float64)
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    r = retune_neighbor_specs(r, ex, ebox, safety=1.03)
    x = torch.as_tensor(ex, dtype=dtype, device=dev)
    box = torch.as_tensor(ebox, dtype=dtype, device=dev)
    out = {}
    for label, force, cspec in (
            ("far", r.forces[2], r.neighbors),
            ("near", r.forces[1], r.extra_neighbor_specs["near"])):
        spec = tp.make_tilepair_spec(ebox, x.shape[0], force._pair_form().r_cut,
                                     exclusions=force.exclusions,
                                     occupancy_from=ex, device=dev)
        lst = tp.build_tile_pairs(spec, x, box)
        if bool(lst[4]):
            raise RuntimeError(f"tile list {label}: overflow at the 30k state")
        out[label] = (force, spec, lst, to_device(cspec, dev))
    return x, box, out


def tile_plain(spec, form, x, box, pp, lst, xref=None):
    """K3's plain twin in float64 on the device of x: (energy, forces)."""
    import torch

    from atomsmm_tpu_torch.ops import tilepair as tp

    f64 = torch.float64
    order, hb, cb, wrap, _ = lst
    fs, ms = tp._stage(spec, x.to(f64), box.to(f64),
                       {k: v.to(f64) for k, v in pp.items()}, spec.excbits,
                       order, None if xref is None else xref.to(f64))
    acc = tp.tile_pair_plain(fs, ms, hb, cb, wrap, box.to(f64), form,
                             form.r_cut)
    nb = spec.n_blocks
    f = torch.zeros((x.shape[0] + 1, 3), dtype=f64, device=x.device)
    f.index_add_(0, order.long(), acc[:nb, :, :3].reshape(-1, 3))
    return acc[:nb, :, 3].sum(), f[:-1]


def phase_tile_kernel(dev, eq):
    """K3 against its plain twin, then against K1 at the 30k state."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import tilepair as tp

    results = []
    for dtype in (torch.float64, torch.float32):
        x, box, lists = tile_lists(dev, eq, dtype)
        for label, (force, spec, lst, cspec) in lists.items():
            form = force._pair_form()
            pp = {k: v.to(dev, dtype)
                  for k, v in force._per_particle().items()}
            e_k, f_k = tp.tile_pair_energy_forces(form, x, box, pp, spec,
                                                  *lst[:4], form.r_cut)
            e_p, f_p = tile_plain(spec, form, x, box, pp, lst)
            results.append(("tile_pair",) + judge(
                f"tile_pair water30k {label} (E {spec.max_entries})", dtype,
                e_k, f_k, e_p, f_p))
            if dtype != torch.float64:
                continue
            bucket, _ = nb.build_cell_buckets(cspec, x, box)
            e_c, f_c = nb.cell_pair_energy_forces(form, x, box, pp, cspec,
                                                  bucket, form.r_cut)
            judge(f"tile_pair vs half_pair water30k {label}", dtype, e_k,
                  f_k, e_c, f_c)
            # move every atom by at most skin/4, stage with xref, and hold
            # the stale list against K1 on fresh buckets
            g = torch.Generator(device="cpu").manual_seed(11)
            step = (torch.rand(x.shape, generator=g, dtype=dtype) * 2 - 1) \
                * (spec.skin / 4 / 3 ** 0.5)
            x1 = x + step.to(dev)
            e_k, f_k = tp.tile_pair_energy_forces(form, x1, box, pp, spec,
                                                  *lst[:4], form.r_cut,
                                                  xref=x)
            bucket, _ = nb.build_cell_buckets(cspec, x1, box)
            e_c, f_c = nb.cell_pair_energy_forces(form, x1, box, pp, cspec,
                                                  bucket, form.r_cut)
            judge(f"tile_pair (moved <= skin/4, xref) vs half_pair water30k "
                  f"{label}", dtype, e_k, f_k, e_c, f_c)
    return results


def phase_slice(dev, **water_kw):
    """The whole slice on the card against the CPU, float64, 5 outer steps."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system

    f64 = torch.float64
    split = water_kw.pop("split")
    runs = []
    for device in ("cpu", dev):
        s, x, box = water_system(n_molecules=400, seed=5, neighbors=True,
                                 dtype=f64, device=device, **water_kw)
        r = amm.RESPASystem(s, rcut_in=split[0], rswitch_in=split[1])
        m = r.masses.cpu().numpy()
        v = np.random.RandomState(9).normal(size=(m.size, 3)) \
            * np.sqrt(amm.units.BOLTZMANN * 300.0 / m)[:, None]
        integ = amm.MultipleTimeScaleIntegrator(
            0.002, [4, 2, 1], temperature=300.0, time_scale=0.1,
            degrees_of_freedom=3 * m.size - 3)
        ctx = amm.Context(r, integ, amm.make_state(
            x, v=torch.as_tensor(v, dtype=f64, device=device), box=box))
        ctx.step(5)
        runs.append((ctx.state, r))
    (cpu, r), (gpu, _) = runs
    worst = 0.0
    for a, b in ((cpu.x, gpu.x), (cpu.v, gpu.v)):
        err = float((a - b.cpu()).abs().max()) / float(a.abs().max())
        worst = max(worst, err)
    grids = "far {} ({}), near {}".format(
        r.neighbors.grid, "half" if r.neighbors.half_stencil else "full",
        r.extra_neighbor_specs["near"].grid)
    log(f"slice water400 rc {r.forces[2].full.r_cut} RESPA+NHC 5 steps "
        f"float64, {grids}, card vs CPU: max rel diff {worst:.2e}")
    if not worst < 1e-9:
        raise RuntimeError("the slice on the card departs from the CPU run")


def phase_main(dev, eq, steps=200):
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
    pk.reset_launches()
    t0 = time.perf_counter()
    ctx.step(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    e1 = float(ctx.conserved_energy())
    x, v = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(x).all() and torch.isfinite(v).all())
    temp = float(ctx.temperature())
    pe = float(ctx.get_state(lite=True).potential_energy) / n
    drift = (e1 - e0) / (n * steps * dt)
    expected = {"half_pair": ctx.last_step_passes * (3 * steps + 2),
                "cell_pair": 0, "tile_pair": 0}
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
    return {"launches": launches["half_pair"], "ms_per_step": ms,
            "ns_day": ns_day, "respa": respa, "state": (ex, ebox)}


def phase_small_box(dev, steps=200, melt_steps=200):
    """Path (a): 700 q-SPC/Fw waters at the default cutoff through
    Context.step; the far force runs K2, the near force K1."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f32 = torch.float32
    dt, loops, temp0 = 0.004, [4, 2, 1], 300.0
    system, x, box = water_system(n_molecules=700, neighbors=True, dtype=f32,
                                  device=dev)
    respa = amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    far, near = respa.neighbors, respa.extra_neighbor_specs["near"]
    if far.half_stencil or not near.half_stencil:
        raise RuntimeError("water 700: expected a full-stencil far grid and "
                           "a half-stencil near grid")
    n = system.num_particles
    integ = amm.MultipleTimeScaleIntegrator(
        dt, loops, temperature=temp0, time_scale=0.1,
        degrees_of_freedom=3 * n - 3)
    ctx = amm.Context(respa, integ, amm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(temp0, seed=1)
    # melt off the lattice: the lattice releases potential energy faster
    # than the tau = 0.1 ps bath removes it (bench.py::_melt_equilibrate)
    for _ in range(8):
        ctx.step(melt_steps // 8)
        t_now = float(ctx.temperature())
        if not t_now == t_now or t_now > 5000.0:
            raise RuntimeError(f"small-box melt diverged (T {t_now} K)")
        ctx.set_velocities((temp0 / t_now) ** 0.5 * ctx.state.v)
    ctx.step(1)
    torch.cuda.synchronize()
    e0 = float(ctx.conserved_energy())
    pk.reset_launches()
    t0 = time.perf_counter()
    ctx.step(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    e1 = float(ctx.conserved_energy())
    passes = ctx.last_step_passes
    # per pass: the far force once per outer step, the near force twice
    # (loops [4, 2, 1]), each once more for the force-cache refresh
    expected = {"half_pair": passes * (2 * steps + 1),
                "cell_pair": passes * (steps + 1), "tile_pair": 0}
    xs, vs = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(vs).all())
    temp = float(ctx.temperature())
    drift = (e1 - e0) / (n * steps * dt)
    ms = wall / steps * 1e3
    ns_day = dt * 1e-3 * steps / wall * 86400.0
    log(f"path (a) water700 box {float(box[0]):.3f} nm RESPA{loops}"
        f"@{dt*1e3:.0f}fs NVT float32 after a {melt_steps}-step melt: far "
        f"grid {far.grid} cap {ctx.system.neighbors.cell_capacity} (K2), "
        f"near grid {near.grid} cap "
        f"{ctx.system.extra_neighbor_specs['near'].cell_capacity} (K1); "
        f"{ms:.3f} ms/step, {ns_day:.3f} ns/day; launches {launches} "
        f"(expected {expected}, passes {passes}); T {temp:.2f} K; drift "
        f"{drift:.5f} kJ/mol/atom/ps; finite {finite}")
    checks = {
        "finite": finite,
        "launches": launches == expected,
        # 2,100 atoms: the instantaneous T spreads by ~2% (5 K) about the
        # bath's 300 K; 30 K leaves room for the melt's last relaxation
        "temperature": 270.0 <= temp <= 330.0,
        # the headline's bound: the f32 RESPA+NHC integrator conserves its
        # extended energy to far better than this
        "drift": abs(drift) <= 0.1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"path (a) checks failed: {failed}")
    return {"launches": launches, "ms_per_step": ms, "ns_day": ns_day,
            "respa": ctx.system, "state": ctx.state}


def phase_tile_path(dev, eq):
    """Path (b): the tile-list entry point at 30k, far and near forms, in
    float32 and float64, through the calls a user makes."""
    import torch

    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import tilepair as tp

    pk.reset_launches()
    runs = 0
    for dtype in (torch.float32, torch.float64):
        x, box, lists = tile_lists(dev, eq, dtype)
        for label, (force, spec, lst, _) in lists.items():
            pp = {k: v.to(dev, dtype)
                  for k, v in force._per_particle().items()}
            e, f = tp.tile_pair_energy_forces(force._pair_form(), x, box, pp,
                                              spec, *lst[:4],
                                              force._pair_form().r_cut)
            runs += 1
            net = float(f.sum(0).abs().max()) / float(f.abs().max())
            live = int((lst[1] < spec.n_blocks).sum())
            log(f"path (b) tile list water30k {label} {str(dtype)[6:]}: "
                f"{live} entries of {spec.max_entries} "
                f"({live * spec.block_size * 2 * spec.block_size / 1e6:.1f} M "
                f"slots), E {float(e):.8g}, |sum F|/max|F| {net:.1e}")
            if not (bool(torch.isfinite(f).all()) and net < 1e-3):
                raise RuntimeError(f"path (b) {label}: bad forces")
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    if launches != {"half_pair": 0, "cell_pair": 0, "tile_pair": runs}:
        raise RuntimeError(f"path (b) launches {launches}, expected {runs} K3")
    return launches["tile_pair"]


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


def phase_timings(dev, main, small, eq):
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import tilepair as tp

    respa = main["respa"]
    ex, ebox = main["state"]
    f32 = torch.float32
    x = torch.as_tensor(ex, dtype=f32, device=dev)
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    n = x.shape[0]
    out = {}
    for label, force, spec in (
            ("far", respa.forces[2], respa.neighbors),
            ("near", respa.forces[1], respa.extra_neighbor_specs["near"])):
        form = force._pair_form()
        pp = force._per_particle()
        bucket, _ = nb.build_cell_buckets(spec, x, box)
        hf, hm, _ = pk.stage(spec, x, pp, bucket)
        k_ms = time_cuda(lambda: pk.half_pair_cuda(
            hf, hm, spec.nbr_cells_half, box, form, form.r_cut, n), 20)
        sweep_ms = time_cuda(lambda: nb.cell_pair_energy_forces(
            form, x, box, pp, spec, bucket, form.r_cut), 20)
        p_ms = time_cuda(lambda: pk.half_pair_plain(
            hf, hm, spec.nbr_cells_half, box, form, form.r_cut, n,
            spec.cell_chunk), 3)
        slots = spec.ncells * spec.nbr_cells_half.shape[1] \
            * spec.cell_capacity ** 2
        log(f"timing half_pair {label} grid {spec.grid} cap "
            f"{spec.cell_capacity}: kernel {k_ms:.4f} ms "
            f"({slots / k_ms / 1e6:.2f} Gslot/s, {slots / 1e6:.1f} M slots), "
            f"wrapper with staging and write-back {sweep_ms:.4f} ms, "
            f"plain float32 {p_ms:.4f} ms")
        out[("half_pair", label)] = {"ms": k_ms, "plain_ms": p_ms,
                                     "sweep_ms": sweep_ms, "slots": slots}

    # K2 on the path (a) far grid, at its state after the run
    s_sys, s_state = small["respa"], small["state"]
    spec, force = s_sys.neighbors, s_sys.forces[-1]
    form, pp = force._pair_form(), force._per_particle()
    xs, bs = s_state.x, s_state.box
    bucket, _ = nb.build_cell_buckets(spec, xs, bs)
    hf, hm, _ = pk.stage(spec, xs, pp, bucket)
    k_ms = time_cuda(lambda: pk.full_pair_cuda(
        hf, hm, spec.nbr_cells, bs, form, form.r_cut, xs.shape[0]), 20)
    sweep_ms = time_cuda(lambda: nb.cell_pair_energy_forces(
        form, xs, bs, pp, spec, bucket, form.r_cut), 20)
    p_ms = time_cuda(lambda: pk.full_pair_plain(
        hf, hm, spec.nbr_cells, bs, form, form.r_cut, xs.shape[0],
        spec.cell_chunk), 3)
    slots = spec.ncells * spec.nbr_cells.shape[1] * spec.cell_capacity ** 2
    log(f"timing cell_pair water700 far grid {spec.grid} cap "
        f"{spec.cell_capacity}: kernel {k_ms:.4f} ms "
        f"({slots / k_ms / 1e6:.2f} Gslot/s, {slots / 1e6:.1f} M slots), "
        f"wrapper {sweep_ms:.4f} ms, plain float32 {p_ms:.4f} ms")
    out[("cell_pair", "far")] = {"ms": k_ms, "plain_ms": p_ms,
                                 "sweep_ms": sweep_ms, "slots": slots}

    # K3 at the 30k lists, beside K1 above
    x, box, lists = tile_lists(dev, eq, f32)
    for label, (force, spec, lst, cspec) in lists.items():
        form = force._pair_form()
        pp = {k: v.to(dev) for k, v in force._per_particle().items()}
        order, hb, cb, wrap, _ = lst
        fs, ms = tp._stage(spec, x, box, pp, spec.excbits, order)
        k_ms = time_cuda(lambda: tp.tile_pair_cuda(
            fs, ms, hb, cb, wrap, box, form, form.r_cut), 20)
        w_ms = time_cuda(lambda: tp.tile_pair_energy_forces(
            form, x, box, pp, spec, order, hb, cb, wrap, form.r_cut), 20)
        p_ms = time_cuda(lambda: tp.tile_pair_plain(
            fs, ms, hb, cb, wrap, box, form, form.r_cut), 3)
        live = int((hb < spec.n_blocks).sum())
        slots = live * spec.block_size * 2 * spec.block_size
        k1 = out[("half_pair", label)]
        log(f"timing tile_pair {label} {live} entries: kernel {k_ms:.4f} ms "
            f"({slots / k_ms / 1e6:.2f} Gslot/s, {slots / 1e6:.1f} M slots) "
            f"vs half_pair {k1['ms']:.4f} ms ({k1['slots'] / 1e6:.1f} M "
            f"slots); wrapper {w_ms:.4f} ms vs {k1['sweep_ms']:.4f} ms; "
            f"plain float32 {p_ms:.4f} ms")
        out[("tile_pair", label)] = {"ms": k_ms, "plain_ms": p_ms,
                                     "sweep_ms": w_ms, "slots": slots}
    spec = lists["far"][1]
    cspec = lists["far"][3]
    t_ms = time_cuda(lambda: tp.build_tile_pairs(spec, x, box), 10)
    c_ms = time_cuda(lambda: nb.build_cell_buckets(cspec, x, box), 10)
    log(f"timing list builds water30k far: build_tile_pairs {t_ms:.4f} ms, "
        f"build_cell_buckets {c_ms:.4f} ms")
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
    libs = _build.build()
    for name in libs:
        _build.load(name)
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in libs.values())})")
    d = np.load(os.path.join(HERE, "bench_data", "eq_water30k.npz"))
    eq = (d["x"], d["v"], d["box"])
    results = phase_kernels(dev, eq) + phase_tile_kernel(dev, eq)
    phase_slice(dev, r_cut=0.7, r_switch=0.6, split=(0.45, 0.35))
    phase_slice(dev, split=(0.5, 0.4))
    main_run = phase_main(dev, eq)
    small = phase_small_box(dev)
    tile_launches = phase_tile_path(dev, eq)
    timings = phase_timings(dev, main_run, small, eq)

    def f32_err(kernel, prefix):
        return max(r[4] for r in results if r[0] == kernel
                   and r[2] == "float32" and prefix in r[1])

    def entry(kernel, source, replaces, launches, err, key, shape):
        t = timings[key]
        return {"name": kernel, "route": "cuda",
                "source": f"atomsmm_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "shape": shape}

    kernels = {"kernels": [
        entry("half_pair", "half_pair.cu", "atomsmm_tpu/ops/pallas_pair.py:240",
              main_run["launches"], f32_err("half_pair", "water30k"),
              ("half_pair", "far"), "30k water far grid 7^3 cap 112, f32"),
        entry("cell_pair", "cell_pair.cu", "atomsmm_tpu/ops/pallas_pair.py:87",
              small["launches"]["cell_pair"],
              f32_err("cell_pair", "water700"), ("cell_pair", "far"),
              "water 700 far grid 2^3 cap 456, f32"),
        entry("tile_pair", "tile_pair.cu", "atomsmm_tpu/ops/tilepair.py:369",
              tile_launches, f32_err("tile_pair", "far"),
              ("tile_pair", "far"), "30k water 0.9 nm tile list, f32"),
    ]}
    print(json.dumps(kernels), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
