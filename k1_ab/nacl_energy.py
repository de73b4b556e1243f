#!/usr/bin/env python3
"""Where path (l)'s potential energy per atom settles, on one NVIDIA GPU:
config 6's state (bench_data/eq_tip3p30k.npz, 10,000 TIP3P waters) run by
path (l)'s protocol (chip_smoke.py::phase_amber: 600 LangevinMiddle steps
at 1 fs, 10/ps, 300 K, then VV @ 2 fs + NHC 300 K) for READS x 100 steps
after the settle-in, in float32, as

  * water_native: models.rigid_water_system (no prmtop), PME, the switch
    at 0.81 nm as amber_system sets it;
  * water_amber: the same waters written as prmtop/inpcrd text by
    chip_smoke.py's writer and read by io.amber_system, PME (the reader
    against the native builder: the two should read alike);
  * nacl_amber: path (l)'s system (54 waters replaced by 27 Na+ and 27
    Cl-, seed 7), PME, and the same with reaction field (nacl_amber_rf);
  * water_native_rf: the native waters with reaction field (path (g1)'s
    force field, the switch at 0.81 nm), and without the settle-in
    (water_native_rf_nhc, water_native_nhc: VV + NHC from the stored
    state and velocities, as path (g1) runs): whether the settle-in or
    the Coulomb method moves the level; water_native_langevin reads under
    the settle-in's LangevinMiddle throughout (READS x 100 steps at 1 fs).

Each read also gives the waters' translational and rotational kinetic
temperatures (3 degrees of freedom a molecule each, from the centre-of-mass
and the remaining kinetic energy), which equipartition makes equal.

    python3 k1_ab/nacl_energy.py [READS]

Prints one line per read (T, T_trans, T_rot, PE/atom) and a JSON summary:
for each case the mean and standard deviation of PE/atom, T_trans and
T_rot over the reads after the first five, and the card's name and power
limit.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def water_temperatures(system, v):
    """(T_trans, T_rot) of the 3-atom molecules at velocities v."""
    import torch

    import atomsmm_tpu_torch as amm

    m = system.masses.to(v.dtype)
    mol = system.molecule.long()
    nmol = system.num_molecules
    p = v.new_zeros((nmol, 3)).index_add_(0, mol, m[:, None] * v)
    mass = v.new_zeros(nmol).index_add_(0, mol, m)
    ke = v.new_zeros(nmol).index_add_(0, mol, 0.5 * m * (v * v).sum(1))
    ke_com = 0.5 * (p * p).sum(1) / mass
    water = torch.bincount(mol, minlength=nmol) == 3
    k3 = 1.5 * amm.units.BOLTZMANN * float(water.sum())
    return (float(ke_com[water].sum()) / k3,
            float((ke - ke_com)[water].sum()) / k3)


def stats(values):
    tail = values[5:]
    mean = sum(tail) / len(tail)
    return mean, (sum((p - mean) ** 2 for p in tail) / len(tail)) ** 0.5


def run(name, system, x, v, box, reads, log, settle=600, langevin=False):
    import torch

    import atomsmm_tpu_torch as amm

    n = system.num_particles
    dof = amm.count_degrees_of_freedom(system)
    ctx = amm.Context(system, amm.LangevinMiddleIntegrator(
        0.001, 300.0, friction=10.0), amm.make_state(x, v=v, box=box))
    if settle:
        ctx.step(settle)
    if not langevin:
        st = ctx.state
        ctx = amm.Context(system, amm.GlobalThermostatIntegrator(
            0.002, amm.NoseHooverChainPropagator(300.0, dof, 0.1)),
            amm.make_state(st.x, v=st.v, box=st.box))
    pes, trans, rots = [], [], []
    t0 = time.perf_counter()
    for k in range(reads):
        ctx.step(100)
        temp = float(ctx.temperature())
        pes.append(float(ctx.get_state(lite=True).potential_energy) / n)
        t_tr, t_rot = water_temperatures(system, ctx.state.v)
        trans.append(t_tr)
        rots.append(t_rot)
        log(f"{name} read {k} (step {100 * (k + 1)}): T {temp:.2f} K, "
            f"T_trans {t_tr:.2f} K, T_rot {t_rot:.2f} K, PE/atom "
            f"{pes[-1]:.4f}")
    torch.cuda.synchronize()
    (pe, pe_sd), (tt, _), (tr, _) = stats(pes), stats(trans), stats(rots)
    return {"atoms": n, "pe_mean": pe, "pe_sd": pe_sd, "t_trans": tt,
            "t_rot": tr, "s": time.perf_counter() - t0}


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from atomsmm_tpu_torch.models import rigid_water_system

    if not torch.cuda.is_available():
        raise SystemExit("nacl_energy.py needs a CUDA card")
    reads = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    dev, f32 = torch.device("cuda", 0), torch.float32
    d = np.load(os.path.join(ROOT, "bench_data", "eq_tip3p30k.npz"))
    ex, ev, ebox = d["x"], d["v"], d["box"]
    out = {"card": cs.smi_line(), "reads_of_100_steps": reads}

    def t(a):
        return torch.as_tensor(a, dtype=f32, device=dev)

    for method, tag in (("pme", ""), ("cutoff", "_rf")):
        native, _, _ = rigid_water_system(
            n_molecules=len(ex) // 3, method=method, r_cut=0.9,
            r_switch=0.81, neighbors=True, dtype=f32, device=dev)
        for settle, tail in ((600, ""), (0, "_nhc")):
            name = f"water_native{tag}{tail}"
            out[name] = run(name, native, t(ex), t(ev), t(ebox), reads,
                            cs.log, settle)
        if method == "pme":
            out["water_native_langevin"] = run(
                "water_native_langevin", native, t(ex), t(ev), t(ebox),
                reads, cs.log, langevin=True)
    text = cs.nacl_prmtop(len(ex) // 3, 0, 0)
    system, x, box = cs.nacl_system(text, cs.nacl_inpcrd(ex, ebox), f32, dev)
    out["water_amber"] = run("water_amber", system, x, t(ev), box, reads,
                             cs.log)
    xs, vs, nw = cs.nacl_state(ex, ev, float(ebox[0]), cs.N_IONS,
                               cs.ION_SEPARATION, 7)
    text = cs.nacl_prmtop(nw, cs.N_IONS, cs.N_IONS)
    crd = cs.nacl_inpcrd(xs, ebox)
    for name, method in (("nacl_amber", "pme"), ("nacl_amber_rf", "cutoff")):
        system, x, box = cs.nacl_system(text, crd, f32, dev, method=method)
        out[name] = run(name, system, x, t(vs), box, reads, cs.log)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
