#!/usr/bin/env python3
"""How many of a sweep's device events torch.profiler keeps, read after
read, on one NVIDIA GPU: K1's float32 sweep at the 30k-water headline's
far grid (7^3, the fused far form; a zero fill, the kernel and the energy
sum, 3 device operations a sweep), 32 sweeps a read, so that a whole read
holds 96 device events and 32 launches of ``half_pair_kernel``.

    python3 k1_ab/profiler_reads.py [READS]

Three ways of reading, READS reads each (default 20), in turns:
  * ``cold``: a profile that records from its first call (a plain
    ``profile()`` block around the 32 sweeps);
  * ``warm``: a profile with a warm-up cycle of the same 32 sweeps before
    the recorded one (``schedule(wait=0, warmup=1, active=1)``), as
    ``device_kernels`` reads now;
  * ``cold`` again after a profile exported as a Chrome trace
    (``atomsmm_tpu_torch.profiling.trace`` around 8 sweeps), as path (j)
    of ``chip_smoke.py`` traces before its later reads.
Prints one JSON line: the card, and for each way the kernel launches and
device events each read kept.
"""
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SWEEPS = 32


def read(fn, warm):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if warm:
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(SWEEPS):
                    fn()
                torch.cuda.synchronize()
                prof.step()
    else:
        with profile(activities=acts) as prof:
            for _ in range(SWEEPS):
                fn()
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum("half_pair_kernel" in n for n in names), len(names)


def main():
    reads = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    import chip_smoke as cs
    from atomsmm_tpu_torch import _build, profiling
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb

    if not torch.cuda.is_available():
        raise SystemExit("profiler_reads.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    for name in _build.build():
        _build.load(name)
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
    f32 = torch.float32
    x = torch.as_tensor(d["x"], dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(d["box"], dtype=f32, device=dev)
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f32,
                           device=dev)
    r = nb.retune_neighbor_specs(amm.RESPASystem(s, 0.5, 0.4), d["x"],
                                 d["box"], safety=1.03)
    force, spec = r.forces[2], r.neighbors
    form, pp = force._pair_form(), force._per_particle()
    bucket, _ = nb.build_cell_buckets(spec, x, box)

    def sweep():
        return nb.cell_pair_energy_forces(form, x, box, pp, spec, bucket,
                                          form.r_cut)

    sweep()
    torch.cuda.synchronize()
    out = {"cold": [], "warm": [], "cold_after_trace": []}
    for _ in range(reads):
        out["cold"].append(read(sweep, False))
        out["warm"].append(read(sweep, True))
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for _ in range(8):
                sweep()
            torch.cuda.synchronize()
    for _ in range(reads):
        out["cold_after_trace"].append(read(sweep, False))
    print(json.dumps({"card": cs.smi_line(), "sweeps_a_read": SWEEPS,
                      "events_a_sweep": 3, "reads": out}), flush=True)


if __name__ == "__main__":
    main()
