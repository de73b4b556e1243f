#!/usr/bin/env python3
"""The 30k headline's energy after a fresh start, float32 against float64,
on the card: what path (j)'s rows read, at both precisions.

    python3 k1_ab/headline_drift.py [--steps 1000]

For float32 and float64 (chip_smoke.py's headline: 10,000 q-SPC/Fw waters
from bench_data/eq_water30k.npz, RESPASystem(0.5, 0.4), MTS [4, 2, 1] @ 4
fs + NHC 300 K):
1. the stored state with velocities at 300 K (seed 7), `--steps` steps
   read every 100: T, PE per atom and the conserved energy per atom;
2. 50 FIRE iterations from the stored state, then the same velocities,
   8 x step(25) and then step(100) until `--steps`, read after each: T
   and PE per atom (path (j)'s rows, and what comes after them).

tests/quench_witness.py runs the same two starts at 216 waters in the JAX
package and this port, float64 on the CPU. About 4 minutes on the card.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import atomsmm_tpu_torch as amm  # noqa: E402
from atomsmm_tpu_torch import _build  # noqa: E402


def read(ctx, n):
    snap = ctx.get_state(lite=True)
    return (round(float(ctx.temperature()), 3),
            round(float(snap.potential_energy) / n, 5),
            round(float(ctx.conserved_energy()) / n, 5))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("headline_drift.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    cs.log(f"{torch.cuda.get_device_name(0)}; {cs.smi_line()}")
    for name in _build.build():
        _build.load(name)
    d = np.load(os.path.join(HERE, "bench_data", "eq_water30k.npz"))
    eq = (d["x"], d["v"], d["box"])
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        respa, integ, state = cs.headline(dev, eq, dtype)
        n = respa.num_particles
        ctx = amm.Context(respa, integ, state)
        ctx.set_velocities_to_temperature(300.0, seed=7)
        rows = [(0,) + read(ctx, n)]
        t0 = time.perf_counter()
        for k in range(100, args.steps + 1, 100):
            ctx.step(100)
            rows.append((k,) + read(ctx, n))
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        cs.log(f"{tag} fresh velocities from the stored state, (step, T, "
               f"PE/atom, conserved/atom): {rows}; {ms:.3f} ms/step with "
               f"the reads")
        respa, integ, state = cs.headline(dev, eq, dtype)
        sim = amm.Simulation(respa, integ, state)
        pe0 = read(sim.context, n)[1]
        sim.minimize_energy(steps=50)
        pe_min = read(sim.context, n)[1]
        sim.set_velocities_to_temperature(300.0, seed=7)
        rows, k = [], 0
        while k < args.steps:
            chunk = 25 if k < 200 else 100
            sim.step(chunk)
            k += chunk
            rows.append((k,) + read(sim.context, n)[:2])
        cs.log(f"{tag} quenched start: PE/atom {pe0} -> {pe_min} after 50 "
               f"FIRE iterations; (step, T, PE/atom): {rows}")
        del ctx, sim, respa, state
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
