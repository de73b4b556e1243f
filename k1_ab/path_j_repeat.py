#!/usr/bin/env python3
"""Run path (j) of ``chip_smoke.py`` (the 30k-water headline under
``Simulation``) several times on one NVIDIA GPU and record each run's
continuation check: the largest max|dx| of the uninterrupted run against
each of the three continuations restored from its checkpoint, beside 3 x
their spread, the bound that ``phase_simulation`` holds it to.

    python3 k1_ab/path_j_repeat.py [TREE] [RUNS]

TREE (default: the checkout holding this file) is a directory holding
``chip_smoke.py``, ``bench_data/`` and an ``atomsmm_tpu_torch`` package,
which are imported in place of this checkout's; the kernels are built from
its sources. RUNS (default 3) is the number of runs. A run whose checks
fail is recorded with the names of the failed checks, and the next run
starts. To compare two trees, run them in turns (A, B, B, A) in one sitting
on one card. Prints one JSON line: the card, the tree and the runs.
"""
import json
import math
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LINE = re.compile(r"max\|x - x_uninterrupted\| ([0-9.e+-]+) nm, "
                  r"spread of \d+ continuations ([0-9.e+-]+) nm")


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from atomsmm_tpu_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("path_j_repeat.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    for name in _build.build():
        _build.load(name)
    d = np.load(os.path.join(tree, "bench_data", "eq_water30k.npz"))
    eq = (d["x"], d["v"], d["box"])
    lines = []
    cs.log = lines.append
    out = []
    for _ in range(runs):
        del lines[:]
        try:
            cs.phase_simulation(dev, eq, math.nan)
            failed = []
        except RuntimeError as err:
            failed = str(err)
        found = [LINE.search(s) for s in lines]
        found = [m for m in found if m]
        diff, spread = ((float(found[0][1]), float(found[0][2])) if found
                        else (None, None))
        out.append({"diff_nm": diff, "spread_nm": spread,
                    "ratio_to_bound": (diff / (3.0 * spread)
                                       if diff is not None and spread
                                       else None),
                    "failed": failed})
    print(json.dumps({"card": cs.smi_line(), "tree": tree, "runs": out}))


if __name__ == "__main__":
    main()
