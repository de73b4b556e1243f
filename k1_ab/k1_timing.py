#!/usr/bin/env python3
"""Time the three pair kernels and their whole sweeps on one NVIDIA GPU, in
the reaction-field and the damped PME forms, float32: K1
(csrc/half_pair.cu) at the 30k-water RESPA headline's far and near grids, K2
(csrc/cell_pair.cu) on the far grid of 700 waters at the state
``chip_smoke.py::phase_small_box`` reaches, and K3 (csrc/tile_pair.cu) at
the 30k far and near tile lists.

    python3 k1_ab/k1_timing.py [TREE]

TREE (default: the checkout holding this file) is a directory holding an
``atomsmm_tpu_torch`` package, which is imported in place of this
checkout's. The sweeps are ``cell_pair_energy_forces`` and
``tile_pair_energy_forces``, the same calls in every version of the
package: each is timed with ``chip_smoke.py``'s CUDA-event loop, and the
kernel inside it by the device time of its events in torch.profiler
(``half_pair_kernel``, ``cell_pair_kernel``, ``tile_pair_kernel``), so
versions with different kernel interfaces are timed alike. To compare
versions, run each tree in turns (A, B, B, A) in one sitting on one card.
Each tree melts its own 700 waters, so K2's states are equivalent, not
equal. A tree can also be this package with a source edited (K1's
earlier per-direction body, ``half_pair_per_direction.cu`` beside this
file, no longer matches the present entry points and header). Prints one JSON line: the
card, the tree, and for each shape the kernel's and the sweep's milliseconds
per call and the sweep's device operations, and the device operations of
one outer step of the 700-water RESPA path
(``chip_smoke.py::step_device_ops``).
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPS = 50


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_timing.py needs a CUDA card")
    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import tilepair as tp

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
    eq = (d["x"], d["v"], d["box"])
    x = torch.as_tensor(d["x"], dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(d["box"], dtype=f32, device=dev)
    result = {}

    def measure(key, kernel, sweep, **shape):
        ops = cs.device_kernels(sweep, REPS)
        result[key] = {
            **shape,
            "kernel_ms": sum(us for name, us in ops
                             if f"{kernel}_kernel" in name) / REPS / 1e3,
            "sweep_ms": cs.time_cuda(sweep, REPS),
            "ops_per_sweep": len(ops) / REPS}

    def measure_cells(key, kernel, force, spec, xs, bs):
        form, pp = force._pair_form(), force._per_particle()
        bucket, _ = nb.build_cell_buckets(spec, xs, bs)
        measure(key, kernel,
                lambda: nb.cell_pair_energy_forces(form, xs, bs, pp, spec,
                                                   bucket, form.r_cut),
                grid=list(spec.grid), cap=spec.cell_capacity)

    small = cs.phase_small_box(dev)
    path_a_ops = cs.step_device_ops(small)
    for method in ("cutoff", "pme"):
        s, _, _ = water_system(n_molecules=10000, method=method,
                               neighbors=True, dtype=f32, device=dev)
        r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
        r = nb.retune_neighbor_specs(r, d["x"], d["box"], safety=1.03)
        for label, force, spec in (
                ("far", r.forces[2], r.neighbors),
                ("near", r.forces[1], r.extra_neighbor_specs["near"])):
            measure_cells(f"{method} {label}", "half_pair", force, spec, x,
                          box)
        s, _, _ = water_system(n_molecules=700, method=method, neighbors=True,
                               dtype=f32, device=dev)
        r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
        measure_cells(f"K2 {method} far water700", "cell_pair", r.forces[2],
                      small["respa"].neighbors, small["state"].x,
                      small["state"].box)
        xt, bt, lists = cs.tile_lists(dev, eq, f32, method)
        for label in ("far", "near"):
            force, spec, lst, _ = lists[label]
            form = force._pair_form()
            pp = {k: v.to(dev) for k, v in force._per_particle().items()}
            measure(f"K3 {method} {label}", "tile_pair",
                    lambda: tp.tile_pair_energy_forces(
                        form, xt, bt, pp, spec, *lst[:4], form.r_cut),
                    entries=int((lst[1] < spec.n_blocks).sum()),
                    block=spec.block_size)
    print(json.dumps({"card": cs.smi_line(), "tree": tree, "reps": REPS,
                      "path_a_device_ops_per_step": path_a_ops,
                      "times": result}), flush=True)


if __name__ == "__main__":
    main()
