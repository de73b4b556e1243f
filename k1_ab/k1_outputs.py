#!/usr/bin/env python3
"""K1's and K2's float32 output in two versions of the package, beside each
one's own run-to-run spread (K1 adds by atomics, so its float32 last bits
vary between launches of one build; K2 stores each row once, so its rows
should not vary at all).

    python3 k1_ab/k1_outputs.py save TREE OUT.pt    # one tree
    python3 k1_ab/k1_outputs.py compare A.pt B.pt   # two saved trees

`save` imports the ``atomsmm_tpu_torch`` package under TREE, builds its
kernels, and stores K1's per-atom (N + 1, 4) output (half_pair_cuda) three
times at each of the 30k-water headline's far and near grids, and K2's
(full_pair_cuda) on the far grid's full stencil ("cell_far"), from
bench_data/eq_water30k.npz. `compare` prints one JSON line per shape: the
largest |A - B| between the two trees' first launches and the largest
difference between launches of one tree, each over the largest |value|
of its column group (forces, energies).
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def save(tree, out):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    if not torch.cuda.is_available():
        raise SystemExit("k1_outputs.py save needs a CUDA card")
    dev, f32 = torch.device("cuda", 0), torch.float32
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
    x = torch.as_tensor(d["x"], dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(d["box"], dtype=f32, device=dev)
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f32,
                           device=dev)
    r = nb.retune_neighbor_specs(amm.RESPASystem(s, 0.5, 0.4), d["x"],
                                 d["box"], safety=1.03)
    result = {}
    for label, force, spec in (("far", r.forces[2], r.neighbors),
                               ("near", r.forces[1],
                                r.extra_neighbor_specs["near"])):
        form = force._pair_form()
        bucket, _ = nb.build_cell_buckets(spec, x, box)
        result[label] = [pk.half_pair_cuda(x, force._per_particle(), bucket,
                                           spec, box, form, form.r_cut).cpu()
                         for _ in range(3)]
        if label == "far":
            result["cell_far"] = [pk.full_pair_cuda(
                x, force._per_particle(), bucket, spec, box, form,
                form.r_cut).cpu() for _ in range(3)]
    torch.save(result, out)


def compare(a, b):
    import torch

    ra, rb = torch.load(a), torch.load(b)
    for label in ra:
        row = {"shape": label}
        for part, cols in (("forces", slice(0, 3)), ("energies", slice(3, 4))):
            scale = float(ra[label][0][:, cols].abs().max())

            def rel(u, v):
                return float((u[:, cols] - v[:, cols]).abs().max()) / scale

            row[part] = {
                "a_vs_b": rel(ra[label][0], rb[label][0]),
                "within_a": max(rel(ra[label][0], t) for t in ra[label][1:]),
                "within_b": max(rel(rb[label][0], t) for t in rb[label][1:]),
                "bit_equal_a_vs_b": bool(torch.equal(ra[label][0],
                                                      rb[label][0]))}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    {"save": save, "compare": compare}[sys.argv[1]](*sys.argv[2:4])
