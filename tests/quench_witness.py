"""A witness for path (j)'s bands that does not use the port's integrator:
the JAX package and this port side by side, float64 on the CPU, at 216
q-SPC/Fw waters on the dense pair path, under the 30k headline's
integrator (RESPASystem(0.5, 0.4), MultipleTimeScaleIntegrator [4, 2, 1]
@ 4 fs with a Nose-Hoover chain at 300 K, time scale 0.1 ps).

    python tests/quench_witness.py [--waters 216] [--equilibrate 2500]
                                   [--steps 200] [--long 1000] [--jax-only]

1. The JAX package melts and equilibrates the lattice (velocities at 300
   K from numpy, seed 11, `--equilibrate` steps): "the stored state".
2. Fresh velocities: from the stored state, velocities at 300 K drawn
   with numpy (seed 7), `--steps` steps in both packages; T and PE/atom
   every 25 steps.
3. A quenched start: 50 FIRE iterations from the stored state in both
   packages, then the same velocities, `--steps` steps; PE/atom at the
   minimum, then T and PE/atom every 25 steps (the chain's heating).
4. `--long` more steps of (2) in both packages: the mean T and PE/atom
   over them, each with its standard error from 10 blocks.

With --jax-only the port's runs are left out (and part 4 with them), for
sizes where the port's dense CPU path is too slow: the chain's heating
of a quenched start depends on the number of degrees of freedom (its
first link's force is (2 KE - g kT) / (kT tau^2)), which --waters varies.
Prints one JSON line per part (the rows of both packages) and takes about
20 minutes on two CPU threads at 216 waters. It imports both packages, as
the tests do.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

KB = 0.0083144626  # kJ/mol/K, units.BOLTZMANN of both packages
CHUNK = 25


def velocities(masses, temperature, seed):
    m = np.asarray(masses, np.float64)
    v = np.random.RandomState(seed).normal(size=(m.size, 3)) * np.sqrt(
        KB * temperature / m)[:, None]
    return v - (m[:, None] * v).sum(0) / m.sum()


def temperature(masses, v):
    m = np.asarray(masses, np.float64)
    dof = 3 * m.size - 3
    return float((m[:, None] * v * v).sum() / (dof * KB))


class Jax:
    """The JAX package's headline system and integrator."""

    def __init__(self, n_molecules):
        import jax

        jax.config.update("jax_enable_x64", True)
        import atomsmm_tpu as jamm
        from atomsmm_tpu.minimize import fire_minimize
        from atomsmm_tpu.models import water_system
        from atomsmm_tpu.potential import potential_energy

        self.amm, self.fire, self.pe = jamm, fire_minimize, potential_energy
        system, self.x0, self.box = water_system(n_molecules=n_molecules)
        self.system = jamm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
        self.masses = np.asarray(system.masses, np.float64)
        self.n = self.masses.size

    def context(self, x, v):
        integ = self.amm.MultipleTimeScaleIntegrator(
            0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
            degrees_of_freedom=3 * self.n - 3)
        return self.amm.Context(self.system, integ, self.amm.make_state(
            np.asarray(x), v=np.asarray(v), box=np.asarray(self.box)))

    def read(self, ctx):
        x, v = np.asarray(ctx.state.x), np.asarray(ctx.state.v)
        return x, v, float(self.pe(self.system, x, np.asarray(self.box)))

    def minimize(self, x, steps):
        return np.asarray(self.fire(self.system, np.asarray(x),
                                    np.asarray(self.box), {}, steps=steps))


class Port:
    """This package's headline system and integrator on the CPU."""

    def __init__(self, n_molecules):
        import torch

        import atomsmm_tpu_torch as tamm
        from atomsmm_tpu_torch.minimize import fire_minimize
        from atomsmm_tpu_torch.models import water_system
        from atomsmm_tpu_torch.potential import potential_energy

        torch.set_num_threads(2)
        self.torch, self.amm = torch, tamm
        self.fire, self.pe = fire_minimize, potential_energy
        system, _, box = water_system(n_molecules=n_molecules,
                                      dtype=torch.float64, device="cpu")
        self.box = box
        self.system = tamm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
        self.n = system.num_particles

    def _t(self, a):
        return self.torch.as_tensor(np.array(a), dtype=self.torch.float64)

    def context(self, x, v):
        integ = self.amm.MultipleTimeScaleIntegrator(
            0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
            degrees_of_freedom=3 * self.n - 3)
        return self.amm.Context(self.system, integ, self.amm.make_state(
            self._t(x), v=self._t(v), box=self.box))

    def read(self, ctx):
        x, v = ctx.state.x, ctx.state.v
        return (x.numpy().copy(), v.numpy().copy(),
                float(self.pe(self.system, x, self.box)))

    def minimize(self, x, steps):
        return self.fire(self.system, self._t(x), self.box, {},
                         steps=steps).numpy()


def rows(pkg, masses, x, v, steps):
    """T and PE/atom after every CHUNK steps from (x, v); the final x, v."""
    ctx = pkg.context(x, v)
    out = []
    for k in range(CHUNK, steps + 1, CHUNK):
        ctx.step(CHUNK)
        x, v, pe = pkg.read(ctx)
        out.append((k, temperature(masses, v), pe / masses.size))
    return out, x, v


def blocks(values, n=10):
    """Mean and its standard error from n block means."""
    b = np.array([np.mean(c) for c in np.array_split(np.asarray(values), n)])
    return float(b.mean()), float(b.std(ddof=1) / np.sqrt(n))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--waters", type=int, default=216)
    ap.add_argument("--equilibrate", type=int, default=2500)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--long", type=int, default=1000)
    ap.add_argument("--jax-only", action="store_true")
    args = ap.parse_args()
    jx = Jax(args.waters)
    pkgs = [("jax", jx)]
    if not args.jax_only:
        pkgs.append(("port", Port(args.waters)))
    m = jx.masses
    eq, xs, vs = rows(jx, m, jx.x0, velocities(m, 300.0, 11),
                      args.equilibrate)
    print(json.dumps({"part": "equilibrate (JAX)", "steps": args.equilibrate,
                      "last_rows": eq[-8:]}), flush=True)
    v7 = velocities(m, 300.0, 7)
    fresh = {}
    for name, pkg in pkgs:
        fresh[name] = rows(pkg, m, xs, v7, args.steps)
    print(json.dumps({"part": "fresh velocities from the stored state",
                      **{k: r[0] for k, r in fresh.items()}}), flush=True)
    quench = {}
    for name, pkg in pkgs:
        xm = pkg.minimize(xs, 50)
        ctx = pkg.context(xm, v7)
        pe_min = pkg.read(ctx)[2] / m.size
        quench[name] = (pe_min, rows(pkg, m, xm, v7, args.steps)[0])
    pe0 = jx.read(jx.context(xs, v7))[2] / m.size
    print(json.dumps({"part": "quenched start: 50 FIRE iterations, then the "
                      "same velocities", "pe_per_atom_stored": pe0,
                      **{f"{k}_pe_min": q[0] for k, q in quench.items()},
                      **{k: q[1] for k, q in quench.items()}}), flush=True)
    if args.long and not args.jax_only:
        out = {}
        for name, pkg in pkgs:
            _, x, v = fresh[name]
            r, _, _ = rows(pkg, m, x, v, args.long)
            t, pe = [row[1] for row in r], [row[2] for row in r]
            out[name] = {"T": blocks(t), "pe_per_atom": blocks(pe)}
        print(json.dumps({"part": f"{args.long} more steps after part 2, "
                          "mean and standard error", **out}), flush=True)


if __name__ == "__main__":
    main()
