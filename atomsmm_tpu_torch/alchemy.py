"""Alchemical free energies (counterpart of atomsmm_tpu/alchemy.py): the
potential at many lambda states, the reduced-energy matrix, MBAR, TI and
the end-to-end solvation free energy (BASELINE config 3).

The workflow (atomsmm's, SURVEY.md §3.4): run MD at each lambda state,
evaluate every sample at every state to build the K x N reduced-energy
matrix, then solve MBAR; TI integrates the mean dU/dlambda on the same
samples.

As in the JAX package, which evaluates the K states in one vmap over the
globals dict, the K states are one batched evaluation: the configuration
becomes a stack of K rows that share x, the box and the cell buckets
(expanded tensors, stride 0 along the rows), the globals (K,) tensors on
the device, and every cell-list force sweeps all K states in one launch of
its pair kernel (forces.py, potential.py). dU/dlambda comes from each force's own
`denergy_dlambda` (forces.py), not from differentiating through a kernel.
Without an explicit `aux`, each configuration gets fresh cell buckets when
the system has a NeighborSpec (the JAX package falls back to its dense
path there); a configuration that overflows a cell capacity gets its specs
retuned first, as Context.step does, so that no pair is dropped.

Examples:

>>> import torch
>>> from atomsmm_tpu_torch import SolvationSystem
>>> from atomsmm_tpu_torch.models import water_system
>>> from atomsmm_tpu_torch.potential import potential_energy
>>> system, x, box = water_system(n_molecules=27, r_cut=0.45, r_switch=0.35,
...                               dtype=torch.float64, device="cpu")
>>> solv = SolvationSystem(system, solute_atoms=torch.arange(3))
>>> lams = torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
>>> es = multistate_energies(solv, x, box,
...                          {"lambda_vdw": lams, "lambda_coul": lams})
>>> tuple(es.shape)
(3,)
>>> e_mid = potential_energy(solv, x, box,
...                          {"lambda_vdw": 0.5, "lambda_coul": 0.5})
>>> bool(abs(es[1] - e_mid) < 1e-10)             # batch == scalar evaluation
True

MBAR on an analytically solvable case: two identical states have zero
free energy difference.

>>> u_kn = torch.stack([torch.tensor([1.0, 2.0, 3.0, 4.0],
...                                  dtype=torch.float64)] * 2)
>>> f = mbar_free_energies(u_kn, [2, 2])
>>> bool(abs(f[1] - f[0]) < 1e-10)
True
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.neighbors import (
    all_neighbor_extras,
    make_aux,
    overflow_flags,
    retune_neighbor_specs,
)
from .potential import potential_energy
from .units import BOLTZMANN


def _aux_for(system, x, box, aux):
    """`aux` when given, else fresh cell buckets at x when the system has a
    NeighborSpec (its specs retuned to x where a capacity overflows: one
    read of the flags from the device), else None (the dense path)."""
    if aux is not None or system.neighbors is None:
        return aux
    extras = all_neighbor_extras(system, x, box)
    if any(bool(v) for v in overflow_flags(extras).values()):
        system = retune_neighbor_specs(system, x, box)
        extras = all_neighbor_extras(system, x, box)
    return make_aux(system, extras)


def _host_lambdas(lambdas) -> Dict[str, list]:
    """name -> the K per-state values as host floats (one read each)."""
    return {name: torch.as_tensor(values).reshape(-1).tolist()
            for name, values in lambdas.items()}


def device_globals(globalss, like):
    """{name: (K,) tensor of the dtype and on the device of `like`} from
    {name: K values} (lists, arrays or tensors): the per-row globals of a
    stack."""
    def rows(values):
        if isinstance(values, torch.Tensor):
            return values.to(like.device, like.dtype).reshape(-1)
        return torch.as_tensor(np.asarray(values, np.float64).reshape(-1),
                               dtype=like.dtype, device=like.device)

    return {name: rows(values) for name, values in globalss.items()}


def multistate_energies(system, x, box, lambdas, aux=None):
    """Potential energy of configuration x at every lambda state: `lambdas`
    maps parameter name -> (K,) values; returns (K,) energies from one
    batched evaluation of K rows that share x, the box and the buckets
    (stride 0), each row with its own lambdas."""
    aux = _aux_for(system, x, box, aux)
    g = device_globals(lambdas, x)
    k = next(iter(g.values())).shape[0]
    if aux is not None:
        aux = {name: {**a, "bucket": a["bucket"].expand(k, *a["bucket"].shape)}
               for name, a in aux.items()}
    return potential_energy(system, x.expand(k, *x.shape),
                            box.expand(k, *box.shape), g, aux=aux)


def reduced_energy_matrix(system, xs, box, lambdas, temperature, aux=None):
    """u[k, n] = beta U(x_n; lambda_k) for configurations xs (N, n_atoms, 3):
    the MBAR input, (K, N); each sample's K states in one batched
    evaluation (multistate_energies)."""
    beta = 1.0 / (BOLTZMANN * temperature)
    return torch.stack([beta * multistate_energies(system, x, box, lambdas,
                                                   aux) for x in xs], dim=1)


def mbar_free_energies(u_kn, n_k, n_iter: int = 200, damping: float = 1.0):
    """Solve the MBAR equations by damped self-consistent iteration, a fixed
    number of times:

        f_k = -log sum_n exp(-u_kn) / sum_l N_l exp(f_l - u_ln)

    u_kn (K, Ntot): reduced energies of every sample (concatenated across
    states) in every state k; n_k (K,): samples drawn from each state.
    Returns (K,) dimensionless free energies with f_0 = 0."""
    u_kn = torch.as_tensor(u_kn)
    if not u_kn.is_floating_point():
        u_kn = u_kn.to(torch.float64)
    log_nk = torch.log(torch.as_tensor(n_k, dtype=u_kn.dtype,
                                       device=u_kn.device))
    f = torch.zeros(u_kn.shape[0], dtype=u_kn.dtype, device=u_kn.device)
    for _ in range(n_iter):
        # log denominator per sample: logsumexp_l [log N_l + f_l - u_ln]
        log_denom = torch.logsumexp(log_nk[:, None] + f[:, None] - u_kn,
                                    dim=0)
        new_f = -torch.logsumexp(-u_kn - log_denom[None, :], dim=1)
        new_f = new_f - new_f[0]
        f = f + damping * (new_f - f)
    return f


def mbar_overlap_weights(u_kn, n_k, f_k):
    """W[k, n]: the weight of each sample in each state (for reweighted
    observables)."""
    u_kn = torch.as_tensor(u_kn)
    log_nk = torch.log(torch.as_tensor(n_k, dtype=u_kn.dtype,
                                       device=u_kn.device))
    log_denom = torch.logsumexp(log_nk[:, None] + f_k[:, None] - u_kn, dim=0)
    return torch.exp(f_k[:, None] - u_kn - log_denom[None, :])


def ti_gradient(system, x, box, lambda_name: str, lambda_value,
                globals=None, aux=None):
    """dU/dlambda at a configuration, the thermodynamic-integration
    integrand: the sum of every force's `denergy_dlambda` (autograd for
    forces made of torch operations, the softcore form's dlambda sweep, the
    exact quadratic rule for the charge-scaled forces)."""
    g = dict(globals or {})
    g[lambda_name] = lambda_value
    aux = _aux_for(system, x, box, aux)
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for f in system.forces:
        total = total + f.denergy_dlambda(x, box, g, lambda_name, aux)
    return total


# ---------------------------------------------------------------------------
# End-to-end solvation free energy (BASELINE config 3)
# ---------------------------------------------------------------------------


def coupling_path(s):
    """The two-stage coupling path: vdW grows over s in [0, 1/2] (softcore
    handles the overlap), the charges only after the repulsive core is in
    place (s in [1/2, 1]); switching Coulomb on while vdW is still soft is
    the classic charge collapse. Returns per-name (K,) schedules for a
    master grid s."""
    s = torch.as_tensor(s)
    if not s.is_floating_point():
        s = s.to(torch.float64)
    return {"lambda_vdw": torch.clamp(2.0 * s, 0.0, 1.0),
            "lambda_coul": torch.clamp(2.0 * s - 1.0, 0.0, 1.0)}


def sample_lambda_states(system, x0, box, lambdas, temperature, dt=0.001,
                         friction=5.0, n_equil=200, n_samples=20,
                         sample_interval=25, seed=0, reporter=None):
    """Sequential NVT sampling at each lambda state, in one Context: velocity
    Verlet with an exact Ornstein-Uhlenbeck bath, the draws from the
    state's torch.Generator (seeded with `seed`; the velocities with
    seed + 1). The states are visited from the coupled end (the last state
    first), each starting from the previous state's configuration, after
    3 n_equil steps that melt the builder lattice at the coupled state.
    `reporter(k, ctx)`, when given, is called after each sample is taken.

    Returns (xs, n_k): xs (K n_samples, N, 3) ordered by state index
    (matching the lambdas), n_k (K,) samples per state."""
    from .context import Context
    from .integrate.integrators import GlobalThermostatIntegrator
    from .integrate.propagators import (
        OrnsteinUhlenbeckPropagator,
        VelocityVerletPropagator,
    )
    from .state import make_state

    integ = GlobalThermostatIntegrator(
        dt, VelocityVerletPropagator(),
        OrnsteinUhlenbeckPropagator(temperature, friction))
    ctx = Context(system, integ, make_state(x0, box=box, seed=seed))
    ctx.set_velocities_to_temperature(temperature, seed=seed + 1)
    values = _host_lambdas(lambdas)
    k_states = len(next(iter(values.values())))
    for name, v in values.items():
        ctx.set_parameter(name, v[k_states - 1])
    ctx.step(3 * n_equil)  # melt the builder lattice at the coupled state
    xs = [None] * k_states
    for k in reversed(range(k_states)):
        for name, v in values.items():
            ctx.set_parameter(name, v[k])
        ctx.step(n_equil)
        samples = []
        for _ in range(n_samples):
            ctx.step(sample_interval)
            samples.append(ctx.state.x.clone())
            if reporter is not None:
                reporter(k, ctx)
        xs[k] = torch.stack(samples)
    return (torch.cat(xs),
            torch.full((k_states,), n_samples, dtype=torch.int32))


def solvation_free_energy(system, x0, box, schedule, temperature,
                          lambdas=None, n_blocks=4, aux=None,
                          mbar_iter=1000, mesh=None, hrex=False,
                          swap_every=1, **sample_kwargs):
    """Coupling free energy dG(s: schedule[0] -> schedule[-1]) by MBAR and
    TI on the same trajectories, with block-wise error estimates.

    `schedule` is the master path parameter s (K,); `lambdas` maps name ->
    (K,) values along the path (default: coupling_path(schedule), vdW
    first, then charges). TI integrates each mean dU/dlambda_name profile
    against its own lambda grid (trapezoid) and sums them. The statistics
    run in float64 on the host, whatever the dtype of the energies.

    Returns a dict: dg_mbar, dg_ti [kJ/mol]; err_mbar, err_ti (block
    standard errors over n_blocks blocks); f_k (K,) dimensionless MBAR
    free energies; ti_profile {name: (K,) mean dU/dlambda}; and
    n_samples_total. With hrex=True the K states run as replicas with
    neighbor-swap exchange every `swap_every` sampling chunks
    (parallel.hrex.hrex_sample_lambda_states), and the dict also holds
    swap_acceptance and swap_attempts. A `mesh` (a 1-D DeviceMesh, as the
    JAX package takes it, implying hrex) runs the replicas over its ranks;
    each rank then evaluates the reduced energies and dU/dlambda of its own
    states' samples, and the rows are gathered (one all_reduce each)
    before MBAR and TI, so every rank returns the same dict."""
    schedule = torch.as_tensor(schedule, dtype=torch.float64)
    k_states = schedule.shape[0]
    lambdas = dict(lambdas) if lambdas is not None else coupling_path(schedule)
    values = _host_lambdas(lambdas)
    swap_info = None
    if hrex or mesh is not None:
        from .parallel.hrex import hrex_sample_lambda_states

        xs, n_k, swap_info = hrex_sample_lambda_states(
            system, x0, box, lambdas, temperature, mesh=mesh,
            swap_every=swap_every, **sample_kwargs)
    else:
        xs, n_k = sample_lambda_states(system, x0, box, lambdas, temperature,
                                       **sample_kwargs)
    kT = BOLTZMANN * temperature
    n_samples = int(n_k[0])
    # the states whose samples this rank evaluates: all, or its block
    lo, hi = 0, k_states
    if mesh is not None:
        from .parallel.replicas import gather_rows, replica_block

        lo, hi = replica_block(k_states, mesh)
    mine = xs[lo * n_samples:hi * n_samples]
    u_kn = reduced_energy_matrix(system, mine, box, lambdas, temperature,
                                 aux=aux)

    # per-name dU/dlambda over each state's own samples, (K, n_samples)
    dudl = {}
    for name in values:
        rows = []
        for k in range(lo, hi):
            g = {nm: v[k] for nm, v in values.items()}
            own = xs[k * n_samples:(k + 1) * n_samples]
            rows.append(torch.stack([
                ti_gradient(system, x, box, name, values[name][k], g, aux)
                for x in own]))
        dudl[name] = torch.stack(rows)
    if mesh is not None:
        # (K, K n) from each rank's (K, n) column blocks, state-major
        u_kn = gather_rows(u_kn.reshape(k_states, hi - lo, n_samples)
                           .transpose(0, 1).contiguous(), k_states, mesh
                           ).transpose(0, 1).reshape(k_states, -1)
        dudl = {name: gather_rows(d, k_states, mesh)
                for name, d in dudl.items()}
    u_kn = u_kn.to("cpu", torch.float64)
    dudl = {name: d.to("cpu", torch.float64) for name, d in dudl.items()}
    grids = {name: torch.tensor(v, dtype=torch.float64)
             for name, v in values.items()}

    def mbar_dg(u):
        f = mbar_free_energies(u, n_k, n_iter=mbar_iter)
        return float((f[-1] - f[0]) * kT)

    def ti_dg(sample_slice):
        return float(sum(
            torch.trapezoid(torch.mean(dudl[name][:, sample_slice], dim=1),
                            grids[name])
            for name in values))

    blocks_mbar, blocks_ti = [], []
    bs = n_samples // n_blocks
    if bs >= 1:
        for b in range(n_blocks):
            sel = np.concatenate([
                np.arange(k * n_samples + b * bs, k * n_samples + (b + 1) * bs)
                for k in range(k_states)])
            blocks_mbar.append(mbar_dg(u_kn[:, torch.as_tensor(sel)]))
            blocks_ti.append(ti_dg(slice(b * bs, (b + 1) * bs)))

    def err(v):
        return (float(np.std(v, ddof=1) / np.sqrt(len(v))) if len(v) > 1
                else float("nan"))

    out = {
        "dg_mbar": mbar_dg(u_kn),
        "dg_ti": ti_dg(slice(None)),
        "err_mbar": err(blocks_mbar),
        "err_ti": err(blocks_ti),
        "f_k": mbar_free_energies(u_kn, n_k, n_iter=mbar_iter),
        "ti_profile": {k: torch.mean(v, dim=1) for k, v in dudl.items()},
        "n_samples_total": int(xs.shape[0]),
    }
    if swap_info is not None:
        out["swap_acceptance"] = swap_info["acceptance"]
        out["swap_attempts"] = swap_info["swap_attempts"]
    return out
