#!/usr/bin/env python3
"""How far path (g)'s rigid-water runs are from equilibrium, on the card.

    python3 k1_ab/rigid_water_relaxation.py

1. Config 6 from its stored state (bench_data/eq_tip3p30k.npz: 10,000
   rigid TIP3P waters, 0.9 nm reaction field, VV @ 2 fs + NHC, float32)
   through the sequence `bench.py::bench_rigid_water` runs before it
   reads: step(1), step(250), 3 x step(200), then 8 x step(250), with T,
   PE per atom and the conserved-energy drift read after each of the
   eight. The mean PE of the eight reads is what the JAX package's
   `tip3p30k_settle_nvt_PE_per_atom` averages over the same steps.
2. 2,000 TIP4P/Ew waters melted off the lattice as chip_smoke.py's path
   (g3) melts them (1,600 steps of VV @ 2 fs + NHC in 8 chunks, the
   velocities rescaled to 300 K after each), then 3,000 steps read every
   100: T, PE per atom with mass, the conserved-energy drift since the
   melt and the thermostat's energy (the heat it has taken up), float32;
   the same for 2,000 rigid TIP3P waters; TIP4P/Ew again in float64 for
   1,000 steps.

A rising thermostat energy with a flat conserved energy is heat leaving a
structure that is still relaxing; heat made by the integrator would move
the conserved energy instead.
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import atomsmm_tpu_torch as amm  # noqa: E402
from atomsmm_tpu_torch import _build, models  # noqa: E402
from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs  # noqa: E402

DT, TEMP = 0.002, 300.0


def nhc(system):
    return amm.GlobalThermostatIntegrator(DT, amm.NoseHooverChainPropagator(
        TEMP, amm.count_degrees_of_freedom(system), 0.1))


def config6(dev):
    d = np.load(os.path.join(HERE, "bench_data", "eq_tip3p30k.npz"))
    x, v, box = (torch.as_tensor(d[k], device=dev) for k in ("x", "v", "box"))
    system, _, _ = models.rigid_water_system(
        n_molecules=len(x) // 3, r_cut=0.9, r_switch=0.8, neighbors=True,
        dtype=torch.float32, device=dev)
    system = retune_neighbor_specs(system, x, box, safety=1.03)
    ctx = amm.Context(system, nhc(system), amm.make_state(x, v=v, box=box))
    n = system.num_particles
    pe0 = float(ctx.get_state(lite=True).potential_energy) / n
    ctx.step(1)
    ctx.step(250)
    for _ in range(3):
        ctx.step(200)
    e0 = float(ctx.conserved_energy())
    pes = []
    for k in range(8):
        ctx.step(250)
        pes.append(float(ctx.get_state(lite=True).potential_energy) / n)
        drift = (float(ctx.conserved_energy()) - e0) / (n * 250 * (k + 1)
                                                         * DT)
        print(f"config 6 float32: stored state PE/atom {pe0:.4f}; after "
              f"{851 + 250 * (k + 1)} steps T {float(ctx.temperature()):.2f}"
              f" K PE/atom {pes[-1]:.4f} drift {drift:.5f} kJ/mol/atom/ps",
              flush=True)
    print(f"config 6 float32: mean PE/atom of the 8 reads "
          f"{sum(pes) / 8:.4f}", flush=True)


def melt_and_read(builder, dtype, dev, melt=1600, after=3000, every=100):
    system, x, box = getattr(models, builder)(
        n_molecules=2000, neighbors=True, dtype=dtype, device=dev)
    atoms = int((system.masses > 0).sum())
    ctx = amm.Context(system, nhc(system), amm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(TEMP, seed=1)
    tag = f"{builder} {str(dtype).split('.')[-1]}"

    def pe():
        return float(ctx.get_state(lite=True).potential_energy) / atoms

    for c in range(8):
        ctx.step(melt // 8)
        t = float(ctx.temperature())
        print(f"{tag} melt {(c + 1) * melt // 8} T before the rescale "
              f"{t:.2f} K PE/atom {pe():.4f}", flush=True)
        ctx.set_velocities((TEMP / t) ** 0.5 * ctx.state.v)
    ctx.step(1)
    e0 = float(ctx.conserved_energy())
    b0 = float(ctx.integrator.conserved_extra(ctx.state))
    temps = []
    for k in range(after // every):
        ctx.step(every)
        temps.append(float(ctx.temperature()))
        span = atoms * DT * every * (k + 1)
        drift = (float(ctx.conserved_energy()) - e0) / span
        uptake = (float(ctx.integrator.conserved_extra(ctx.state)) - b0) / span
        print(f"{tag} after {every * (k + 1)} T {temps[-1]:.2f} K PE/atom "
              f"{pe():.4f} drift {drift:.5f} thermostat uptake {uptake:.5f} "
              "kJ/mol/atom/ps", flush=True)
    thirds = np.array_split(np.array(temps), 3)
    print(f"{tag} mean T by thirds of the reads: "
          + ", ".join(f"{t.mean():.2f}" for t in thirds), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    for name in _build.build():
        _build.load(name)
    dev = torch.device("cuda", 0)
    config6(dev)
    melt_and_read("tip4p_water_system", torch.float32, dev)
    melt_and_read("rigid_water_system", torch.float32, dev)
    melt_and_read("tip4p_water_system", torch.float64, dev, after=1000)


if __name__ == "__main__":
    main()
