#!/usr/bin/env python3
"""Group 0 of the 400-pair emim/BF4 ionic liquid (bonds, angles, torsions
and 1-4 exceptions, forces by autograd), with the atoms gathered by
`torch.index_select` as ops/bonded.py and ops/pairs.py gather them, against
the same forces gathered by advanced indexing (x[idx]), whose backward pass
is a sort-based index_put_:

    python3 k1_ab/group0_gathers.py

On the CUDA card, float32, from bench_data/eq_emim.npz. The two variants
take turns (select, advanced, select, advanced) in one process. For each
turn: milliseconds per evaluation of the whole group and of each force on
the host clock with a synchronise after every call (launch overhead
counts), and the device operations and device microseconds of one
evaluation of the group by torch.profiler. The forces of the two variants
must agree to 1e-5 of max|F|. Prints one JSON line.
"""
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PAIRS = 400  # ion pairs: path (d)'s size


@contextlib.contextmanager
def advanced_indexing():
    """Make torch.index_select(x, 0, idx) gather as x[idx] does."""
    import torch

    keep = torch.index_select
    torch.index_select = lambda x, dim, index: x[index]
    try:
        yield
    finally:
        torch.index_select = keep


def main():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.potential import force_fn
    from atomsmm_tpu_torch.utils import replace

    dev = "cuda:0"
    _, respa, ex, _, ebox = cs.ionic_liquid(PAIRS, torch.float32, dev)
    x = torch.as_tensor(ex, dtype=torch.float32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=torch.float32, device=dev)
    aux = nb.make_aux(respa, nb.all_neighbor_extras(respa, x, box))
    group0 = [f for f in respa.forces if f.group == 0]
    fns = {"group 0": force_fn(respa, {0})}
    for f in group0:
        fns[f.name] = force_fn(replace(respa, forces=(f,)), {0})

    def wall(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    turns, forces = [], {}
    for variant in ("index_select", "advanced", "index_select", "advanced"):
        ctx = (advanced_indexing() if variant == "advanced"
               else contextlib.nullcontext())
        with ctx:
            ms = {name: wall(lambda fn=fn: fn(x, box, {}, aux))
                  for name, fn in fns.items()}
            ops = cs.device_kernels(lambda: fns["group 0"](x, box, {}, aux))
            forces[variant] = fns["group 0"](x, box, {}, aux)[1]
        turns.append({"variant": variant, "ms": ms, "device_ops": len(ops),
                      "device_us": sum(us for _, us in ops)})
    diff = float((forces["index_select"] - forces["advanced"]).abs().max()) \
        / float(forces["index_select"].abs().max())
    if not diff < 1e-5:
        raise RuntimeError(f"the two gathers disagree: {diff:.3e} of max|F|")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "smi": cs.smi_line(), "atoms": respa.num_particles,
                      "forces": [f.name for f in group0],
                      "max_rel_force_diff": diff, "turns": turns}),
          flush=True)


if __name__ == "__main__":
    main()
