"""Replica-parallel lambda-state sampling and Hamiltonian replica exchange
(HREX) (counterpart of atomsmm_tpu/parallel/hrex.py).

The sequential workflow (alchemy.sample_lambda_states) visits K lambda
states one after another in one Context. Here the K states run as one
stacked State (state.py), each row with its own globals (lambda_k, a (K,)
tensor on the device per name) and its own torch.Generator. As in the JAX
package, where all K step in one vmapped call, a step of the stack is one
batched step: each pair kernel sweeps every row in one launch over a
(cells, K) grid (ops/pair_kernel.py). Over a device mesh (a 1-D
torch.distributed DeviceMesh, one process per rank) rank r owns the
contiguous block of K / D rows (replicas.replica_block) and steps that
block in one batched call; every rank holds the shared exchange generator
and the ladder.

Between sampling chunks, neighbor-swap exchange over alternating even/odd
pairs (k, k+1):

    P_acc = min(1, exp(-[b_k (U_k(x_{k+1}) - U_k(x_k))
                         + b_{k+1} (U_{k+1}(x_k) - U_{k+1}(x_{k+1}))])).

As in the JAX package the criterion takes three batched energy
evaluations of K rows each, at the stack and at the stack rolled up and
down by one row (each row's own globals: U_k(x_k), U_k(x_{k+1}),
U_k(x_{k-1})); the Metropolis test runs on the device, the accept mask is
read to the host once per attempt (the counters need it), and an accepted
pair exchanges its configurations (x, v, box and the `nbr*` / `fcache*`
extras) by one gather of the stack along a permutation. Only the eligible
pairs of the attempt's parity can accept. Over a mesh the attempt is the
same move: the block is gathered (replicas.gather_replicas), each rank
evaluates the three energies of its own rows, one all_reduce shares the
(3, K) energies, every rank draws the same uniforms from the shared
generator and so reads the same accept mask, and each rank takes its own
rows of the permuted stack, across a rank boundary too. lambda stays with
its row and so does the generator, so row k always samples state k and the
MBAR bookkeeping is unchanged: the swaps only decorrelate the chain.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..alchemy import _host_lambdas, device_globals
from ..context import advance, raise_on_stale, stale_flags, \
    with_neighbor_lists
from ..ops.neighbors import make_aux, overflow_flags
from ..potential import potential_energy
from ..state import make_state, maxwell_boltzmann_velocities
from ..units import BOLTZMANN
from ..utils import replace
from .replicas import (
    gather_replicas,
    gather_rows,
    globals_block,
    replica_block,
    replicate_state,
)

# State.extra keys that travel with the configuration on an accepted swap:
# the neighbor lists describe x; the force caches depend on x and the row's
# lambda, and every run() recomputes them before the first step
_CONFIG_PREFIXES = ("nbr", "fcache")


def _energy_fn(system):
    def energy_one(x, box, extra, globals):
        return potential_energy(system, x, box, globals,
                                aux=make_aux(system, extra))

    return energy_one


def _take(state, idx):
    """The stacked State's rows in the order `idx` (a (K,) index tensor):
    x, v, box and the configuration extras; the other extras stay with
    their rows."""
    def take(t):
        return t.index_select(0, idx)

    extra = {key: take(v) if key.startswith(_CONFIG_PREFIXES) else v
             for key, v in state.extra.items()}
    return replace(state, x=take(state.x), v=take(state.v),
                   box=take(state.box), extra=extra)


class HREXSwap:
    """One exchange attempt (make_hrex_swap): call it as
    swap(states, globalss, key, parity) -> (states, n_accept, n_eligible),
    `states` a stacked State of K rows, `globalss` {name: K values}, `key`
    a torch.Generator on the states' device and parity 0 for the pairs (0,
    1), (2, 3), ..., 1 for (1, 2), (3, 4), ...

    `temperature` is a scalar (Hamiltonian exchange at one T) or a K-long
    ladder (temperature or combined REMD): each row's beta enters the
    criterion, and velocities arriving at row k from row j are scaled by
    sqrt(T_k / T_j), so that the exchanged configuration lands with a
    kinetic energy canonical at its new temperature."""

    def __init__(self, system, temperature, mesh=None, axis: str = "dp"):
        t = torch.as_tensor(temperature, dtype=torch.float64)
        self.ladder = t.reshape(-1).tolist() if t.ndim else None
        self.temperature = None if t.ndim else float(t)
        self._energy = _energy_fn(system)
        self.mesh, self.axis = mesh, axis

    def _betas(self, k, like):
        """(K,) beta of every row, of like's dtype on its device."""
        t = ([self.temperature] * k if self.ladder is None
             else self.ladder)
        return like.new_tensor([1.0 / (BOLTZMANN * tk) for tk in t])

    def _uniforms(self, key, k, like):
        """The attempt's K uniforms in [0, 1), from the generator `key`, of
        the dtype and on the device of `like`. The attempt draws nowhere
        else (tests replace this method to replay another stream)."""
        return torch.rand(k, generator=key, dtype=like.dtype,
                          device=like.device)

    def energies(self, states, globalss, lo=0, hi=None):
        """(3, K) energies of the stacked State `states` under each row's
        globals: [U_k(x_k), U_k(x_{k+1}), U_k(x_{k-1})] (row indices
        periodic), three batched evaluations of the rows [lo, hi) (zero
        outside them) and, over a mesh, summed over the ranks in one
        all_reduce."""
        k_states = states.rows
        hi = k_states if hi is None else hi
        g = globals_block(device_globals(globalss, states.x), lo, hi)
        out = states.x.new_zeros((3, k_states))
        rows = torch.arange(lo, hi, device=states.x.device)
        for i, shift in enumerate((0, 1, -1)):
            moved = _take(states, (rows + shift) % k_states)
            out[i, lo:hi] = self._energy(moved.x, moved.box, moved.extra, g)
        if self.mesh is not None:
            import torch.distributed as dist

            from .mesh import mesh_group

            dist.all_reduce(out, group=mesh_group(self.mesh, self.axis)[0])
        return out

    def _delta(self, energies):
        """(K,) delta_k = b_k (U_k(x_{k+1}) - U_k(x_k))
        + b_{k+1} (U_{k+1}(x_k) - U_{k+1}(x_{k+1})) (the last row's wraps
        and is never eligible)."""
        e_own, e_up, e_dn = energies
        beta = self._betas(e_own.shape[0], e_own)
        return beta * (e_up - e_own) + torch.roll(beta * (e_dn - e_own), -1)

    def deltas(self, states, globalss, parity):
        """(pairs, energies, delta) of the eligible pairs (i, i + 1) of this
        parity: energies (P, 4) rows [U_i(x_i), U_i(x_{i+1}),
        U_{i+1}(x_{i+1}), U_{i+1}(x_i)] and delta (P,), on the device, from
        the three batched evaluations of `energies`."""
        pairs = [(i, i + 1) for i in range(parity, states.rows - 1, 2)]
        if not pairs:
            return pairs, None, None
        e = self.energies(states, globalss)
        lead = torch.tensor([i for i, _ in pairs], device=e.device)
        energies = torch.stack([e[0, lead], e[1, lead], e[0, lead + 1],
                                e[2, lead + 1]], dim=1)
        return pairs, energies, self._delta(e)[lead]

    def __call__(self, states, globalss, key, parity):
        """Over a mesh `states` are this rank's rows (replica_block) and so
        are the states returned."""
        if self.mesh is None:
            full, lo, hi = states, 0, states.rows
        else:
            from .mesh import mesh_group

            k_all = states.rows * mesh_group(self.mesh, self.axis)[1]
            lo, hi = replica_block(k_all, self.mesh, self.axis)
            full = gather_replicas(states, k_all, self.mesh, self.axis)
        k_states = full.rows
        eligible = [i for i in range(parity, k_states - 1, 2)]
        r = self._uniforms(key, k_states, full.x)
        if not eligible:
            return states, 0, 0
        delta = self._delta(self.energies(full, globalss, lo, hi))
        mask = torch.zeros(k_states, dtype=torch.bool, device=r.device)
        mask[eligible] = True
        accepted = (mask & (torch.log(r) < -delta)).tolist()  # one host read
        perm = list(range(k_states))
        for i in eligible:
            if accepted[i]:
                perm[i], perm[i + 1] = i + 1, i
        out = _take(full, torch.tensor(perm, device=r.device))
        if self.ladder is not None:
            scale = full.v.new_tensor([math.sqrt(self.ladder[k]
                                                 / self.ladder[perm[k]])
                                       for k in range(k_states)])
            out = replace(out, v=out.v * scale[:, None, None])
        if self.mesh is not None:
            out = out.block(lo, hi)
        return (replace(out, rng=states.rng), sum(accepted),
                len(eligible))


def make_hrex_swap(system, temperature, mesh=None, axis: str = "dp"):
    """swap(states, globalss, key, parity) -> (states, n_accept,
    n_eligible): see HREXSwap."""
    return HREXSwap(system, temperature, mesh, axis)


def make_replica_run(system_template, integrator, update_every: int = 1):
    """run(system, states, globalss, n) -> states: the stacked State
    advances n steps, each row under its own globals ({name: (K,) tensor}),
    in one batched context.advance (a rebuild of every row's lists and a
    refresh of the force caches under the rows' globals, then the steps).
    update_every = K > 1 groups the rebuilds as
    Context(neighbor_update_every=K) does, with the sticky per-row
    staleness flags sampled after every step; HREXSampler.run raises on a
    tripped flag."""
    step_fn = integrator.make_step()
    k_update = max(int(update_every), 1)

    def run(system, states, globalss, n):
        return advance(system, step_fn, states, globalss, n, k_update)

    return run


class HREXSampler:
    """K lambda states stepping as one stacked State with periodic exchange
    moves.

    lambdas: {name: K values}. Velocity Verlet with an Ornstein-Uhlenbeck
    bath (temperature, friction). mesh: a 1-D DeviceMesh whose D ranks
    split the K rows in blocks of K / D (ValueError unless D divides K,
    TypeError for another mesh); every rank constructs the sampler with
    the same arguments, `states` holds its own rows and positions() all
    K."""

    def __init__(self, system, x0, box, lambdas, temperature, mesh=None,
                 axis: str = "dp", dt=0.001, friction=5.0, seed: int = 0,
                 temperatures=None, neighbor_update_every: int = 1):
        """temperatures: an optional K-long ladder for temperature REMD:
        each replica's bath reads its own setpoint from its globals row
        ("bath_T"), and swaps use each row's beta with the sqrt(T_new /
        T_old) velocity scaling. lambdas may be {} for pure T-REMD.

        neighbor_update_every: rebuild the cell lists every K steps under
        the staleness guard, as Context(neighbor_update_every=K)."""
        from ..integrate.integrators import GlobalThermostatIntegrator
        from ..integrate.propagators import (
            OrnsteinUhlenbeckPropagator,
            VelocityVerletPropagator,
        )

        self.system = system
        self.temperature = float(temperature)
        self.lambdas = _host_lambdas(lambdas)
        self.temperatures = (None if temperatures is None else torch.as_tensor(
            temperatures, dtype=torch.float64).reshape(-1).tolist())
        self.k_states = (len(next(iter(self.lambdas.values())))
                         if self.lambdas else len(self.temperatures))
        self.mesh, self.axis = mesh, axis
        self._block = ((0, self.k_states) if mesh is None else
                       replica_block(self.k_states, mesh, axis))
        integ = GlobalThermostatIntegrator(
            dt, VelocityVerletPropagator(),
            OrnsteinUhlenbeckPropagator(
                self.temperature, friction,
                temperature_global=("bath_T" if temperatures is not None
                                    else None)))
        self.neighbor_update_every = max(int(neighbor_update_every), 1)
        state = make_state(x0, box=box, seed=seed)
        # an independent Maxwell-Boltzmann draw per replica: one draw tiled
        # over the rows would start the ladder perfectly correlated
        rng = torch.Generator(device=state.x.device)
        rng.manual_seed(seed + 1)
        vs = system.virtual_sites
        v = []
        for k in range(self.k_states):
            vk = maxwell_boltzmann_velocities(rng, system.masses,
                                              self.temperature, state.x.dtype)
            if self.temperatures is not None:  # the row's own temperature
                vk = vk * math.sqrt(self.temperatures[k] / self.temperature)
            if vs is not None:
                from ..ops.virtual_sites import zero_virtual_velocities

                vk = zero_virtual_velocities(vs, vk)
            v.append(vk)
        states = replace(replicate_state(state, self.k_states, seed),
                         v=torch.stack(v))
        states = with_neighbor_lists(system, states,
                                     self.neighbor_update_every)
        self.states = integ.initialize(system, states).block(*self._block)
        self._run = make_replica_run(
            system, integ, update_every=self.neighbor_update_every)
        self._swap = make_hrex_swap(
            system, self.temperature if temperatures is None
            else self.temperatures, mesh, axis)
        self._rng = torch.Generator(device=state.x.device)
        self._rng.manual_seed(seed + 2)
        self._device = {}
        self._last_globalss = None
        self._parity = 0
        self.swap_attempts = 0
        self.swap_accepts = 0

    def _globals(self, values: Dict[str, list]):
        """{name: K host values} of the rows, bath_T included on a
        temperature ladder."""
        g = _host_lambdas(values)
        if self.temperatures is not None:
            g.setdefault("bath_T", self.temperatures)
        return g

    def _on_device(self, g):
        """The (K,) device tensors of the host globals `g` in the states'
        dtype, made once per set of values: a run under the ladder copies
        nothing to the card, and the kernels read a lambda tensor as their
        table of the rows' lambdas as it is."""
        key = tuple((name, tuple(v)) for name, v in sorted(g.items()))
        if key not in self._device:
            if len(self._device) > 16:
                self._device.clear()
            self._device[key] = device_globals(g, self.states.x)
        return self._device[key]

    def run(self, n_steps: int, globalss=None):
        """n_steps of every replica under its row of `globalss` (default:
        the ladder), the stack in one batched advance. Raises on any
        replica's bucket overflow or staleness flag, all read in one sync:
        replicas have no overflow replay."""
        g = self._globals(globalss if globalss is not None else self.lambdas)
        self._last_globalss = g
        self.states = self._run(self.system, self.states, globals_block(
            self._on_device(g), *self._block), n_steps)
        keys = list({**overflow_flags(self.states.extra),
                     **stale_flags(self.states.extra)})
        if not keys:
            return
        values = torch.stack([self.states.extra[key].to(torch.int32)
                              for key in keys], dim=1)   # (rows, keys)
        if self.mesh is not None:  # every rank raises on every rank's flag
            values = gather_rows(values, self.k_states, self.mesh, self.axis)
        bad = [(k, key) for k, row in enumerate(values.tolist())
               for key, v in zip(keys, row) if v]
        for k, key in bad:
            if key.endswith("overflow"):
                raise RuntimeError(
                    f"cell-list capacity overflow in replica {k} ({key}): "
                    "retune the NeighborSpec capacities (retune_neighbor_"
                    "specs on an equilibrated configuration) before HREX "
                    "sampling")
        for k, key in bad:
            raise_on_stale({key: True}, where=f" in replica {k}")

    def anneal(self, n_steps: int, chunks: int = 8):
        """Gentle decoupling: every replica starts at the coupled lambda
        (the ladder's last row) and moves linearly to its own over
        `chunks` chunks of n_steps // chunks steps."""
        target = self.lambdas
        per = max(n_steps // chunks, 1)
        for c in range(chunks):
            t = (c + 1) / chunks
            self.run(per, {name: [(1.0 - t) * v[-1] + t * vk for vk in v]
                           for name, v in target.items()})

    def attempt_swaps(self):
        """One exchange attempt at the current parity, then flip it. Refused
        while the replicas were last propagated under other globals than
        the ladder (mid-anneal): the criterion evaluates U at the ladder,
        and the acceptance test would bias the ensemble."""
        ladder = self._globals(self.lambdas)
        if self._last_globalss is not None:
            for k, v in ladder.items():
                last = self._last_globalss.get(k)
                if last is None or not np.allclose(last, v):
                    raise RuntimeError(
                        f"attempt_swaps: replicas were last propagated under "
                        f"globals[{k!r}] != the ladder values; finish the "
                        "anneal (or run at the ladder) before exchanging, or "
                        "the acceptance test biases the sampled ensemble")
        self.states, acc, att = self._swap(
            self.states, self._on_device(ladder), self._rng, self._parity)
        self._parity ^= 1
        self.swap_attempts += att
        self.swap_accepts += acc

    @property
    def acceptance_rate(self):
        return (self.swap_accepts / self.swap_attempts
                if self.swap_attempts else float("nan"))

    def positions(self):
        """(K, N, 3) positions of the replicas, row k at state k (over a
        mesh gathered from every rank's rows)."""
        if self.mesh is None:
            return self.states.x
        return gather_rows(self.states.x, self.k_states, self.mesh,
                           self.axis)


def hrex_sample_lambda_states(system, x0, box, lambdas, temperature,
                              mesh=None, dt=0.001, friction=5.0,
                              n_equil=200, n_samples=20, sample_interval=25,
                              swap_every=1, seed=0,
                              neighbor_update_every: int = 1):
    """The replica counterpart of alchemy.sample_lambda_states: the same
    (xs, n_k) contract (samples ordered by state index), K-fold fewer
    sequential MD steps per state, plus exchange mixing. Melts 2 n_equil
    steps at the coupled state, anneals over n_equil, runs n_equil at the
    ladder, then takes n_samples samples sample_interval steps apart.

    swap_every: attempt swaps every `swap_every` sampling chunks (0: none).
    mesh: a 1-D DeviceMesh over whose ranks the replicas run (HREXSampler);
    every rank returns all samples. Returns (xs, n_k, info), info holding
    swap_attempts, swap_accepts and acceptance."""
    sampler = HREXSampler(system, x0, box, lambdas, temperature, mesh=mesh,
                          dt=dt, friction=friction, seed=seed,
                          neighbor_update_every=neighbor_update_every)
    sampler.run(2 * n_equil, {name: [v[-1]] * sampler.k_states
                              for name, v in sampler.lambdas.items()})
    sampler.anneal(n_equil)
    sampler.run(n_equil)
    if swap_every:
        sampler.attempt_swaps()
    samples = []
    for s in range(n_samples):
        sampler.run(sample_interval)
        if swap_every and (s + 1) % swap_every == 0:
            sampler.attempt_swaps()
        samples.append(sampler.positions())
    stacked = torch.stack(samples)  # (S, K, N, 3)
    xs = torch.cat([stacked[:, k] for k in range(sampler.k_states)])
    n_k = torch.full((sampler.k_states,), n_samples, dtype=torch.int32)
    info = {"swap_attempts": sampler.swap_attempts,
            "swap_accepts": sampler.swap_accepts,
            "acceptance": sampler.acceptance_rate}
    return xs, n_k, info
