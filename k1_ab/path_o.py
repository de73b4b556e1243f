#!/usr/bin/env python3
"""Run path (o) of ``chip_smoke.py`` (the 30k-water headline on block
lists, K4) beside the headline on cell lists (K1), RF and PME, on one
NVIDIA GPU, without the rest of the script:

    python3 k1_ab/path_o.py [REPEATS]

It runs the headline (RF, then PME) and path (o) once, then K1's timings
at the headline's far and near grids (which count the distinct pairs K4's
bound needs), K3's at the 30k tile lists, and K4's at path (o)'s lists,
all at the stored 30k state; then REPEATS (default 0) more runs of path
(o) and of the RF headline in turns (o, headline, headline, o, ...), each
a fresh Context's step(100). Every check of those phases holds as in
``chip_smoke.py``; the log goes to standard error, and the last line of
standard output is one JSON object with the card, the step times and the
kernel times.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main():
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from atomsmm_tpu_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("path_o.py needs a CUDA card")
    cs.log = lambda msg: print(msg, file=sys.stderr, flush=True)
    dev = torch.device("cuda", 0)
    for name in _build.build():
        _build.load(name)
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
    eq = (d["x"], d["v"], d["box"])
    main_run = cs.phase_main(dev, eq)
    pme_run = cs.phase_main(dev, eq, method="pme")
    blocks = cs.phase_blocks(dev, eq, main_run, pme_run)

    # K1 at the headline's grids (with the pair counts), K3 at the tile
    # lists, as phase_timings takes them, and K4 at (o)'s lists
    f32 = torch.float32
    ex, ebox = main_run["state"]
    x = torch.as_tensor(ex, dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    respa, prespa = main_run["respa"], pme_run["respa"]
    timings = {}
    for key, force, spec in (
            ("far", respa.forces[2], respa.neighbors),
            ("near", respa.forces[1], respa.extra_neighbor_specs["near"]),
            ("pme far", prespa.forces[2], prespa.neighbors)):
        timings[("half_pair", key)] = cs.time_cells(key, force, spec, x, box)
    from atomsmm_tpu_torch.ops import tilepair as tp

    _, _, lists = cs.tile_lists(dev, eq, f32)
    for key, (force, spec, lst, _) in lists.items():
        form = force._pair_form()
        pp = {k: v.to(dev) for k, v in force._per_particle().items()}
        order, hb, cb, wrap, _ = lst
        fs, ms = tp._stage(spec, x, box, pp, spec.excbits, order)
        timings[("tile_pair", key)] = {"ms": cs.kernel_device_ms(
            lambda: tp.tile_pair_cuda(fs, ms, hb, cb, wrap, box, form,
                                      form.r_cut), "tile_pair")}
    timings.update(cs.phase_block_timings(dev, blocks, timings, eq,
                                          pme_run))
    steps = {"o": [blocks["ms_per_step"]], "headline": [
        main_run["ms_per_step"]]}
    for _ in range(repeats):
        for name in ("o", "headline", "headline", "o"):
            run = (cs.phase_blocks(dev, eq, main_run, pme_run)
                   if name == "o" else cs.phase_main(dev, eq))
            steps[name].append(run["ms_per_step"])
    print(json.dumps({
        "card": cs.smi_line(), "step_ms": steps,
        "build_ms": blocks["build_ms"], "cell_build_ms":
            blocks["cell_build_ms"],
        "kernel_ms": {f"{k} {g}": t["ms"] for (k, g), t in timings.items()},
        "plain_ms": {f"{k} {g}": t["plain_ms"] for (k, g), t in
                     timings.items() if "plain_ms" in t},
        "bound_ms": {f"{k} {g}": t["bound"]["ms"] for (k, g), t in
                     timings.items() if "bound" in t}}), flush=True)


if __name__ == "__main__":
    main()
