#!/usr/bin/env python3
"""Measure how two runs of the 30k-water headline from one state come
apart on one NVIDIA GPU, float32, and where the run-to-run variation
enters: the sweep kernels' atomics, the bonded group's autograd, or both.

    python3 k1_ab/divergence.py [TREE] [STEPS]

TREE (default: the checkout holding this file) is a directory holding
``chip_smoke.py``, ``bench_data/`` and an ``atomsmm_tpu_torch`` package,
which are imported in place of this checkout's; the kernels are built from
its sources. The system is ``chip_smoke.py::headline`` (MTS [4, 2, 1] at
4 fs with a Nose-Hoover chain, K1 on the far and near grids). Measured:

- for each force group, 20 evaluations of its forces at the stored state:
  how many differ from the first, and the largest difference;
- two Contexts from one state, STEPS (default 100) outer steps each in
  chunks of 10: the largest max|dx| between them after each chunk.

To compare two trees, run them in turns (A, B, B, A) in one sitting on
one card. Prints one JSON line: the card, the tree, the groups and the
divergence.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPS = 20
CHUNK = 10


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import _build
    from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux
    from atomsmm_tpu_torch.potential import force_fn

    if not torch.cuda.is_available():
        raise SystemExit("divergence.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    for name in _build.build():
        _build.load(name)
    d = np.load(os.path.join(tree, "bench_data", "eq_water30k.npz"))
    system, integ, state = cs.headline(dev, (d["x"], d["v"], d["box"]),
                                       torch.float32)
    aux = make_aux(system, all_neighbor_extras(system, state.x, state.box))
    groups = {}
    for g in sorted({f.group for f in system.forces}):
        fn = force_fn(system, {g})
        first = fn(state.x, state.box, {}, aux)[1]
        diffs = [float((fn(state.x, state.box, {}, aux)[1] - first)
                       .abs().max()) for _ in range(REPS - 1)]
        groups[str(g)] = {"differ": sum(x > 0 for x in diffs),
                          "max_diff": max(diffs),
                          "max_force": float(first.abs().max())}

    def context():
        s = amm.make_state(state.x.clone(), v=state.v.clone(),
                           box=state.box.clone())
        return amm.Context(system, integ, s)

    a, b = context(), context()
    apart = []
    for _ in range(steps // CHUNK):
        a.step(CHUNK)
        b.step(CHUNK)
        apart.append(float((a.state.x - b.state.x).abs().max()))
    print(json.dumps({"card": cs.smi_line(), "tree": tree, "groups": groups,
                      "chunk": CHUNK, "max_dx_nm": apart}))


if __name__ == "__main__":
    main()
