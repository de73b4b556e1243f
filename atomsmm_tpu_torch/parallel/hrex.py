"""Replica-parallel lambda-state sampling and Hamiltonian replica exchange
(HREX) (counterpart of atomsmm_tpu/parallel/hrex.py).

The sequential workflow (alchemy.sample_lambda_states) visits K lambda
states one after another in one Context. Here the K states run as replicas,
each with its own globals row (lambda_k) and its own torch.Generator. The
JAX package steps them as one vmapped batch, sharded over a device mesh
when one is given; the port steps them one after another (K1 takes one
system per launch: a replica axis in the kernels waits for ROADMAP item
4d). Over a device mesh (a 1-D torch.distributed DeviceMesh, one process
per rank) rank r owns the contiguous block of K / D rows
(replicas.replica_block) and steps those only; every rank holds the
shared exchange generator and the ladder.

Between sampling chunks, neighbor-swap exchange over alternating even/odd
pairs (k, k+1):

    P_acc = min(1, exp(-[b_k (U_k(x_{k+1}) - U_k(x_k))
                         + b_{k+1} (U_{k+1}(x_k) - U_{k+1}(x_{k+1}))])).

The energies and the Metropolis test run on the device; the accept mask is
read to the host once per attempt (the counters need it), and an accepted
swap exchanges the configurations (x, v, box and the `nbr*` / `fcache*`
extras) between the two rows of the Python list. Over a mesh the attempt
is the same move: the rows are gathered (replicas.gather_replicas), the
owner of row k evaluates U_k at both configurations of its pair, one
all_reduce shares the (P, 4) energies, every rank draws the same uniforms
from the shared generator and so reads the same accept mask, and each
rank takes its own rows' new configurations, across a rank boundary too.
lambda stays with its row and so does the generator, so row k always
samples state k and the MBAR bookkeeping is unchanged: the swaps only
decorrelate the chain.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..alchemy import _host_lambdas
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


def _row(globalss, k):
    """Replica k's globals: {name: its value} from {name: K values}."""
    return {name: values[k] for name, values in globalss.items()}


class HREXSwap:
    """One exchange attempt (make_hrex_swap): call it as
    swap(states, globalss, key, parity) -> (states, n_accept, n_eligible),
    `states` a list of K States, `globalss` {name: K host values}, `key` a
    torch.Generator on the states' device and parity 0 for the pairs (0,
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

    def _beta(self, k):
        t = self.temperature if self.ladder is None else self.ladder[k]
        return 1.0 / (BOLTZMANN * t)

    def _uniforms(self, key, k, like):
        """The attempt's K uniforms in [0, 1), from the generator `key`, of
        the dtype and on the device of `like`. The attempt draws nowhere
        else (tests replace this method to replay another stream)."""
        return torch.rand(k, generator=key, dtype=like.dtype,
                          device=like.device)

    def deltas(self, states, globalss, parity):
        """(pairs, energies, delta) of the eligible pairs (i, i + 1) of this
        parity: energies (P, 4) rows [U_i(x_i), U_i(x_{i+1}),
        U_{i+1}(x_{i+1}), U_{i+1}(x_i)], four energy evaluations a pair,
        and delta (P,) = b_i (U_i(x_{i+1}) - U_i(x_i))
        + b_{i+1} (U_{i+1}(x_i) - U_{i+1}(x_{i+1})), on the device."""
        return self._deltas(states, globalss, parity, 0, len(states))

    def _deltas(self, states, globalss, parity, lo, hi):
        """deltas, the energies U_k evaluated only for the rows k in
        [lo, hi) (zero for the others) and, over a mesh, summed over the
        ranks in one all_reduce."""
        pairs = [(i, i + 1) for i in range(parity, len(states) - 1, 2)]
        if not pairs:
            return pairs, None, None
        zero = states[0].x.new_zeros(())

        def u(row, k):  # U_row(x_k): row's globals at replica k's state
            if not lo <= row < hi:
                return zero
            s = states[k]
            return self._energy(s.x, s.box, s.extra, _row(globalss, row))

        energies = torch.stack([torch.stack([u(i, i), u(i, j), u(j, j),
                                             u(j, i)]) for i, j in pairs])
        if self.mesh is not None:
            import torch.distributed as dist

            from .mesh import mesh_group

            dist.all_reduce(energies,
                            group=mesh_group(self.mesh, self.axis)[0])
        b_lo = energies.new_tensor([self._beta(i) for i, _ in pairs])
        b_hi = energies.new_tensor([self._beta(j) for _, j in pairs])
        delta = (b_lo * (energies[:, 1] - energies[:, 0])
                 + b_hi * (energies[:, 3] - energies[:, 2]))
        return pairs, energies, delta

    def _take(self, states, k, j):
        """Row k (its lambda, generator and other extras) with replica j's
        configuration."""
        dst, src = states[k], states[j]
        if j == k:
            return dst
        v = src.v
        if self.ladder is not None:
            v = v * math.sqrt(self.ladder[k] / self.ladder[j])
        extra = {key: src.extra[key] if key.startswith(_CONFIG_PREFIXES)
                 else value for key, value in dst.extra.items()}
        return replace(dst, x=src.x, v=v, box=src.box, extra=extra)

    def __call__(self, states, globalss, key, parity):
        """Over a mesh `states` are this rank's rows (replica_block) and so
        is the list returned."""
        if self.mesh is None:
            lo, hi = 0, len(states)
        else:
            from .mesh import mesh_group

            k_all = len(states) * mesh_group(self.mesh, self.axis)[1]
            lo, hi = replica_block(k_all, self.mesh, self.axis)
            states = gather_replicas(
                [states[k - lo] if lo <= k < hi else states[0]
                 for k in range(k_all)], self.mesh, self.axis)
        k_states = len(states)
        pairs, _, delta = self._deltas(states, globalss, parity, lo, hi)
        r = self._uniforms(key, k_states, states[0].x)
        if not pairs:
            return list(states[lo:hi]), 0, 0
        lead = torch.tensor([i for i, _ in pairs], device=r.device)
        accepted = (torch.log(r[lead]) < -delta).tolist()  # one host read
        perm = list(range(k_states))
        for (i, j), ok in zip(pairs, accepted):
            if ok:
                perm[i], perm[j] = j, i
        return ([self._take(states, k, perm[k]) for k in range(lo, hi)],
                sum(accepted), len(pairs))


def make_hrex_swap(system, temperature, mesh=None, axis: str = "dp"):
    """swap(states, globalss, key, parity) -> (states, n_accept,
    n_eligible): see HREXSwap."""
    return HREXSwap(system, temperature, mesh, axis)


def make_replica_run(system_template, integrator, update_every: int = 1):
    """run(system, states, globalss, n) -> states: every replica advances n
    steps under its own globals row, one after another, each through
    context.advance (a rebuild and a refresh of its force caches under its
    row, then the steps). update_every = K > 1 groups the rebuilds as
    Context(neighbor_update_every=K) does, with the sticky staleness flags
    sampled after every step; HREXSampler.run raises on a tripped flag."""
    step_fn = integrator.make_step()
    k_update = max(int(update_every), 1)

    def run(system, states, globalss, n, first: int = 0):
        """`first`: the row of states[0] (a rank's block over a mesh)."""
        return [advance(system, step_fn, s, _row(globalss, first + k), n,
                        k_update)
                for k, s in enumerate(states)]

    return run


class HREXSampler:
    """K lambda states stepping as replicas with periodic exchange moves.

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
        state = with_neighbor_lists(system, make_state(x0, box=box, seed=seed),
                                    self.neighbor_update_every)
        state = integ.initialize(system, state)
        states = replicate_state(state, self.k_states, seed)
        # an independent Maxwell-Boltzmann draw per replica: one draw tiled
        # over the rows would start the ladder perfectly correlated
        rng = torch.Generator(device=state.x.device)
        rng.manual_seed(seed + 1)
        vs = system.virtual_sites
        for k in range(self.k_states):
            v = maxwell_boltzmann_velocities(rng, system.masses,
                                             self.temperature, state.x.dtype)
            if self.temperatures is not None:  # the row's own temperature
                v = v * math.sqrt(self.temperatures[k] / self.temperature)
            if vs is not None:
                from ..ops.virtual_sites import zero_virtual_velocities

                v = zero_virtual_velocities(vs, v)
            states[k] = replace(states[k], v=v)
        self.states = states[slice(*self._block)]
        self._run = make_replica_run(
            system, integ, update_every=self.neighbor_update_every)
        self._swap = make_hrex_swap(
            system, self.temperature if temperatures is None
            else self.temperatures, mesh, axis)
        self._rng = torch.Generator(device=state.x.device)
        self._rng.manual_seed(seed + 2)
        self._last_globalss = None
        self._parity = 0
        self.swap_attempts = 0
        self.swap_accepts = 0

    def _globals(self, values: Dict[str, list]):
        g = _host_lambdas(values)
        if self.temperatures is not None:
            g.setdefault("bath_T", self.temperatures)
        return g

    def run(self, n_steps: int, globalss=None):
        """n_steps for every replica under its row of `globalss` (default:
        the ladder). Raises on any replica's bucket overflow or staleness
        flag, all read in one sync: replicas have no overflow replay."""
        g = self._globals(globalss if globalss is not None else self.lambdas)
        self._last_globalss = g
        self.states = self._run(self.system, self.states, g, n_steps,
                                self._block[0])
        keys = list({**overflow_flags(self.states[0].extra),
                     **stale_flags(self.states[0].extra)})
        if not keys:
            return
        values = torch.stack([torch.stack([
            s.extra[key].reshape(()).to(torch.int32) for key in keys])
            for s in self.states])
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
        if self._last_globalss is not None:
            for k, v in self._globals(self.lambdas).items():
                last = self._last_globalss.get(k)
                if last is None or not np.allclose(last, v):
                    raise RuntimeError(
                        f"attempt_swaps: replicas were last propagated under "
                        f"globals[{k!r}] != the ladder values; finish the "
                        "anneal (or run at the ladder) before exchanging, or "
                        "the acceptance test biases the sampled ensemble")
        self.states, acc, att = self._swap(
            self.states, self._globals(self.lambdas), self._rng, self._parity)
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
        x = torch.stack([s.x for s in self.states])
        if self.mesh is None:
            return x
        return gather_rows(x, self.k_states, self.mesh, self.axis)


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
