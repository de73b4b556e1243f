#!/usr/bin/env python3
"""Time K1 (csrc/half_pair.cu) and its whole cell sweep on one NVIDIA GPU at
the 30k-water RESPA headline's two shapes, in the reaction-field and the
damped PME forms, float32.

    python3 k1_ab/k1_timing.py [TREE]

TREE (default: the checkout holding this file) is a directory holding an
``atomsmm_tpu_torch`` package, which is imported in place of this
checkout's. The sweep is ``cell_pair_energy_forces``, the same call in every
version of the package: it is timed with ``chip_smoke.py``'s CUDA-event
loop, and K1 inside it by the device time of the ``half_pair_kernel``
events in torch.profiler, so versions with different kernel interfaces are
timed alike. To compare versions, run each tree in turns (A, B, B, A) in
one sitting on one card. A tree can also be this package with
``csrc/half_pair.cu`` replaced, for instance by
``half_pair_per_direction.cu`` beside this file (K1's earlier body behind
its present interface). Prints one JSON line: the card, the tree, and for
each shape the kernel's and the sweep's milliseconds per call and the
sweep's device operations.
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

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
    x = torch.as_tensor(d["x"], dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(d["box"], dtype=f32, device=dev)
    result = {}
    for method in ("cutoff", "pme"):
        s, _, _ = water_system(n_molecules=10000, method=method,
                               neighbors=True, dtype=f32, device=dev)
        r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
        r = nb.retune_neighbor_specs(r, d["x"], d["box"], safety=1.03)
        for label, force, spec in (
                ("far", r.forces[2], r.neighbors),
                ("near", r.forces[1], r.extra_neighbor_specs["near"])):
            form, pp = force._pair_form(), force._per_particle()
            bucket, _ = nb.build_cell_buckets(spec, x, box)

            def sweep():
                return nb.cell_pair_energy_forces(form, x, box, pp, spec,
                                                  bucket, form.r_cut)

            ops = cs.device_kernels(sweep, REPS)
            result[f"{method} {label}"] = {
                "grid": list(spec.grid), "cap": spec.cell_capacity,
                "kernel_ms": sum(us for name, us in ops
                                 if "half_pair_kernel" in name) / REPS / 1e3,
                "sweep_ms": cs.time_cuda(sweep, REPS),
                "ops_per_sweep": len(ops) / REPS}
    print(json.dumps({"card": cs.smi_line(), "tree": tree, "reps": REPS,
                      "times": result}), flush=True)


if __name__ == "__main__":
    main()
