#!/usr/bin/env python3
"""Time K1 (csrc/half_pair.cu) and K2 (csrc/cell_pair.cu) in the id-column
and the split exclusion forms on one table that both take, float32, on one
NVIDIA GPU.

    python3 k1_ab/exc_forms.py [TREE]

TREE (default: the checkout holding this file) is a directory holding an
``atomsmm_tpu_torch`` package, imported in place of this checkout's. It
must be a version whose K1 and K2 take both forms: a spec holding the
table and no bitmask there kept the id-column form (``exclusion_form ==
"cols"``). The split form replaced that form after this measurement, so
the present package refuses to run here; PERF.md names the tree measured.
The table is a system's own exclusions plus one bond from each molecule's
first atom to the nearest other molecule's first atom (minimum image), 1-2
only: at most 16 columns, some pairs more than 14 indices apart, so the
spec builder gives it the id-column form, and its split (the bitmask for
the pairs within +-14 indices, the few far ids beside it) is the form that
would replace it. Two systems at their ``chip_smoke.py`` grids: the
30k-water headline's far and near grids (reaction field) and path (d)'s
emim/BF4 400 ion pairs (the fused damped far form and the damped near
form). K1 sweeps each half stencil, K2 the full stencil of each far grid.
Each kernel is timed by its device time in torch.profiler
(``chip_smoke.kernel_device_ms``), in turns split, columns, columns,
split, beside the bitmask form of the system's own table on the same
bucket; the split form's forces are held against the column form's.
Prints one JSON line: the card, and for each shape the times in turn and
the largest force difference over the largest force.
"""
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPS = 50


def linked_table(table, anchors, x, box):
    """`table` (N, M) with a 1-2 exclusion between each anchor atom and the
    nearest other anchor (cubic minimum image), both ways; -1 padded."""
    import numpy as np

    n = len(table)
    rows = [set(int(j) for j in r if j >= 0) for r in table]
    a = np.asarray(anchors)
    xa = np.asarray(x, dtype=np.float64)[a]
    b = np.asarray(box, dtype=np.float64)
    for lo in range(0, len(a), 1000):
        d = xa[lo:lo + 1000, None] - xa[None]
        d -= b * np.round(d / b)
        r2 = (d * d).sum(-1)
        r2[np.arange(len(r2)), np.arange(lo, lo + len(r2))] = np.inf
        for i, j in zip(a[lo:lo + 1000], a[r2.argmin(1)]):
            rows[i].add(int(j))
            rows[int(j)].add(int(i))
    out = np.full((n, max(len(r) for r in rows)), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = sorted(r)
    return out


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs

    sys.path.insert(0, tree)

    if not torch.cuda.is_available():
        raise SystemExit("exc_forms.py needs a CUDA card")
    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f32,
                           device=dev)
    r = nb.retune_neighbor_specs(
        amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4), d["x"], d["box"],
        safety=1.03)
    systems = {"water30k": (r, d["x"], d["box"], r.forces[2], r.forces[1])}
    _, ri, xi, _, bi = cs.ionic_liquid(400, f32, dev)
    near_i, far_i = cs.pair_forces(ri)
    systems["emim400"] = (ri, xi, bi, far_i, near_i)

    result = {"card": cs.smi_line(), "reps": REPS, "shapes": {}}
    for name, (respa, x_np, box_np, far, near) in systems.items():
        mol = respa.molecule.cpu().numpy()
        first = np.flatnonzero(np.r_[True, mol[1:] != mol[:-1]])
        own = respa.neighbors.exclusions.cpu().numpy()
        table = linked_table(own, first, x_np, box_np)
        bits, ids = nb.split_exclusions(len(table), table)
        x = torch.as_tensor(x_np, dtype=f32, device=dev).contiguous()
        box = torch.as_tensor(box_np, dtype=f32, device=dev)
        for g, force, spec, halves in (
                ("far", far, respa.neighbors, (True, False)),
                ("near", near, respa.extra_neighbor_specs["near"], (True,))):
            tab = torch.as_tensor(table, device=dev)
            forms = {
                "bits": spec,
                "cols": dataclasses.replace(spec, exclusions=tab,
                                            excbits=None,
                                            exclusions_far=None),
                "split": dataclasses.replace(
                    spec, exclusions=tab,
                    excbits=torch.as_tensor(bits, device=dev),
                    exclusions_far=torch.as_tensor(ids, device=dev))}
            form, pp = force._pair_form(), force._per_particle()
            bucket, _ = nb.build_cell_buckets(spec, x, box)
            for half in halves:
                kernel = "half_pair" if half else "cell_pair"
                sp = {k: dataclasses.replace(v, half_stencil=half)
                      for k, v in forms.items()}
                if {k: v.exclusion_form for k, v in sp.items()} != {
                        "bits": "bits", "cols": "cols", "split": "split"}:
                    raise SystemExit(f"{tree}: its specs do not keep the "
                                     "id-column form")

                def sweep(v):
                    return lambda: nb.cell_pair_energy_forces(
                        form, x, box, pp, v, bucket, form.r_cut)

                times = {"bits": [], "cols": [], "split": []}
                for k in ("split", "cols", "cols", "split", "bits"):
                    times[k].append(cs.kernel_device_ms(sweep(sp[k]), kernel,
                                                        REPS))
                f_c = sweep(sp["cols"])()[1]
                f_s = sweep(sp["split"])()[1]
                scale = float(f_c.abs().max())
                result["shapes"][f"{name} {g} {kernel}"] = {
                    "grid": list(spec.grid), "cap": spec.cell_capacity,
                    "columns": int(table.shape[1]),
                    "far_ids": int((ids >= 0).sum()),
                    "far_width": int(ids.shape[1]),
                    "ms": times,
                    "split_over_cols": (sum(times["split"])
                                        / sum(times["cols"])),
                    "force_diff_over_max": float(
                        (f_s - f_c).abs().max()) / scale}
                print(name, g, kernel, result["shapes"][
                    f"{name} {g} {kernel}"], flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
