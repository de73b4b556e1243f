#!/usr/bin/env python3
"""Atomic against molecular pressure of flexible q-SPC/Fw water, float64 on
the CPU, over two trajectories of 125 waters at 0.5 nm from one melted
state: Langevin (BAOAB) at 0.5 fs, and RESPA [4, 2, 1] @ 4 fs + NHC (the
integrator of the water paths, bonds at 0.5 fs, the far force at 4 fs).

    python3 k1_ab/pressure_consistency.py

For a stationary trajectory of exact dynamics the two estimators agree on
average (the virial theorem of each molecule's internal motion,
<sum F . (x - com)> = -2 <K_intra>); the script prints the mean of each
and its standard error over `SAMPLES` configurations, and the kinetic
temperatures of all atoms and of the molecules' centres.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import atomsmm_tpu_torch as amm  # noqa: E402
from atomsmm_tpu_torch import computers  # noqa: E402
from atomsmm_tpu_torch.models import water_system  # noqa: E402

SAMPLES, EVERY = 150, 20


def sample(ctx, system, every):
    pa, pm, ka, km = [], [], [], []
    for _ in range(SAMPLES):
        ctx.step(every)
        o = computers.compute_observables(ctx.system, ctx.state,
                                          include_coulomb=False)
        pa.append(float(o["atomic_pressure"]))
        pm.append(float(o["molecular_pressure"]))
        km.append(float(o["molecular_kinetic_energy"]))
        ka.append(float(amm.kinetic_energy(system.masses, ctx.state.v)))
    k = amm.units.BOLTZMANN
    n, nm = system.num_particles, system.num_molecules
    return {"atomic_bar": (np.mean(pa), np.std(pa) / SAMPLES ** 0.5),
            "molecular_bar": (np.mean(pm), np.std(pm) / SAMPLES ** 0.5),
            "T_atoms_K": 2 * np.mean(ka) / (3 * n * k),
            "T_centres_K": 2 * np.mean(km) / (3 * nm * k)}


def main():
    torch.set_num_threads(4)
    f64 = torch.float64
    s, x, box = water_system(n_molecules=125, r_cut=0.5, r_switch=0.4,
                             neighbors=True, dtype=f64, device="cpu")
    melt = amm.Context(s, amm.LangevinMiddleIntegrator(0.0005, 300.0, 5.0),
                       amm.make_state(x, box=box, seed=1))
    melt.set_velocities_to_temperature(300.0, seed=2)
    melt.step(2000)
    x0, v0 = melt.state.x.clone(), melt.state.v.clone()
    ctx = amm.Context(s, amm.LangevinMiddleIntegrator(0.0005, 300.0, 5.0),
                      amm.make_state(x0, v=v0, box=box, seed=3))
    print("Langevin 0.5 fs:", sample(ctx, s, EVERY))
    respa = amm.RESPASystem(s, rcut_in=0.35, rswitch_in=0.3)
    ctx = amm.Context(respa, amm.MultipleTimeScaleIntegrator(
        0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * s.num_particles - 3),
        amm.make_state(x0, v=v0, box=box))
    ctx.step(250)
    print("RESPA [4, 2, 1] @ 4 fs + NHC:", sample(ctx, respa, EVERY // 8))


if __name__ == "__main__":
    main()
