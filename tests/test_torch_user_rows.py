"""A user pair function over a stack of rows (CustomNonbondedForce's
energy_rows, energy_and_forces_rows and denergy_dlambda on x (K, N, 3)):
one sweep of K1 or K2 over every row, the rows' globals a (K, C) table of
the lowered form's runtime constants, as the JAX package vmaps its
energies over the lambda rows with the traced pair function inside its
Pallas call.

  * the batched twin against the JAX package's vmapped sweep of the same
    function (its XLA cell sweep over 4 lambda rows, jax.vmap and
    jax.grad in lambda), float64: energies 1e-10, forces 1e-9 x max|F|,
    dU/dlambda 1e-10; on K1's grid (water 216 at 0.5 nm) and K2's (water
    125 at 0.6 nm);
  * each batched row against the single-row twin at 1e-12, replicas of
    distinct positions and the lambda states of one configuration
    (stride 0) alike, and the rows take no callable sweep;
  * multistate_energies of a system whose nonbonded term is the user
    function against the JAX package's (its vmap over the globals);
  * the softcore force of a SolvationSystem written as a user function
    whose lambda is the row's global: its rows, forces and dU/dlambda
    against the built-in softcore force's, 1e-10;
  * on the card (marker ``cuda``, skipped here): one launch of K1 or K2 on
    the user form over 4 rows against the batched float64 twin (float64
    1e-10, float32 1e-4), each row against its single-row launch (K2 bit
    for bit, K1 at the float32 tolerance). They import no JAX:
        pytest tests/test_torch_user_rows.py -m cuda -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
import test_torch_user_forms as uf
from atomsmm_tpu_torch.forces import aux_rows
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pair_kernel as tpk
from atomsmm_tpu_torch.ops.pairtrace import UserForm

F64 = torch.float64
LAMS = (0.0, 0.35, 0.65, 1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(grid, device="cpu"):
    """(Buckingham user force, system, aux, x, box) of the port on `grid`
    (uf.GRIDS: K1's or K2's), float64 on `device`."""
    n, rc = uf.GRIDS[grid]
    ts, tx, tb = uf._water("torch", n, rc)
    force = uf._custom("torch", ts, "buck", rc)
    if device != "cpu":
        force = dataclasses.replace(force, per_particle={
            k: v.to(device) for k, v in force.per_particle.items()},
            exclusions=force.exclusions.to(device))
        tx, tb = tx.to(device), tb.to(device)
        spec = tnb.make_neighbor_spec(tb, tx.shape[0], rc,
                                      exclusions=force.exclusions,
                                      occupancy_floor_from=tx.cpu(),
                                      device=device)
        ts = dataclasses.replace(ts, neighbors=spec)
    system = tamm.System(masses=ts.masses.to(device), forces=(force,),
                         default_box=tb).with_neighbors(ts.neighbors)
    aux = tnb.make_aux(system, tnb.all_neighbor_extras(system, tx, tb))
    assert tnb.takes_half_stencil(ts.neighbors) == (grid == "k1")
    return force, system, aux, tx, tb


def _lams(device="cpu", dtype=F64):
    return torch.tensor(LAMS, dtype=dtype, device=device)


@pytest.mark.parametrize("grid", sorted(uf.GRIDS))
def test_batched_twin_matches_jax_vmap(grid):
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.ops import neighbors as jnb

    force, _, aux, tx, tb = _port(grid)
    n, rc = uf.GRIDS[grid]
    js, jx, jb = uf._water("jax", n, rc)
    jf = uf._custom("jax", js, "buck", rc)
    jspec = dataclasses.replace(js.neighbors, backend="xla")
    jbucket = jnb.neighbor_list_extras(jspec, jx, jb)[jnb.NBR_BUCKET]

    def e_f(lam):
        return jnb.cell_pair_energy_forces(
            jf._pair_fn({"lam": lam}), jx, jb, jf._per_particle({}), jspec,
            jbucket, rc)

    je, jfor = jax.vmap(e_f)(jnp.asarray(LAMS))
    jdl = jax.vmap(jax.grad(lambda lam: e_f(lam)[0]))(jnp.asarray(LAMS))
    k = len(LAMS)
    xs, bs = tx.expand(k, *tx.shape), tb.expand(k, *tb.shape)
    g = {"lam": _lams()}
    tpk.reset_launches()
    te, tfor = force.energy_and_forces_rows(xs, bs, g, aux_rows(aux, k))
    ten = force.energy_rows(xs, bs, g, aux_rows(aux, k))
    tdl = force.denergy_dlambda(xs, bs, g, "lam", aux_rows(aux, k))
    assert tpk.CALLABLE_SWEEPS["cell"] == 0
    jfor = np.asarray(jfor)
    for r in range(k):
        assert float(te[r]) == pytest.approx(float(je[r]), rel=1e-10)
        assert float(ten[r]) == pytest.approx(float(je[r]), rel=1e-10)
        assert float(tdl[r]) == pytest.approx(float(jdl[r]), rel=1e-10)
        np.testing.assert_allclose(tfor[r].numpy(), jfor[r], rtol=0,
                                   atol=1e-9 * np.abs(jfor[r]).max())


@pytest.mark.parametrize("stack", ["states", "replicas"])
@pytest.mark.parametrize("grid", sorted(uf.GRIDS))
def test_batched_rows_equal_single_rows(grid, stack):
    """Each row of the batched twin against the force's single-row call
    with that row's lambda (and positions): the lambda states of one
    configuration (x and the bucket shared, stride 0) and replicas whose
    positions differ (their own buckets)."""
    force, system, aux, tx, tb = _port(grid)
    k = len(LAMS)
    if stack == "states":
        xs, bs, ar = tx.expand(k, *tx.shape), tb.expand(k, 3), \
            aux_rows(aux, k)
    else:
        rng = np.random.default_rng(6)
        xs = tx + torch.as_tensor(rng.normal(scale=0.01, size=(k,)
                                             + tuple(tx.shape)))
        bs = tb.expand(k, 3).contiguous()
        auxes = [tnb.make_aux(system, tnb.all_neighbor_extras(system, xs[r],
                                                              tb))
                 for r in range(k)]
        ar = {"default": {**auxes[0]["default"], "bucket": torch.stack(
            [a["default"]["bucket"] for a in auxes])}}
    g = {"lam": _lams()}
    e, f = force.energy_and_forces_rows(xs, bs, g, ar)
    dl = force.denergy_dlambda(xs, bs, g, "lam", ar)
    for r in range(k):
        gr = {"lam": g["lam"][r]}
        ar_r = {"default": {**ar["default"],
                            "bucket": ar["default"]["bucket"][r]}}
        e1, f1 = force.energy_and_forces(xs[r], bs[r], gr, ar_r)
        assert float(e[r]) == pytest.approx(float(e1), rel=1e-12)
        np.testing.assert_allclose(f[r].numpy(), f1.numpy(), rtol=0,
                                   atol=1e-12 * float(f1.abs().max()))
        d1 = force.denergy_dlambda(xs[r], bs[r], gr, "lam", ar_r)
        assert float(dl[r]) == pytest.approx(float(d1), rel=1e-12)


def test_multistate_energies_match_jax():
    """multistate_energies of a system whose nonbonded term is the user
    function (the bonded terms as built): the port's one batched
    evaluation of the 4 states against the JAX package's vmap over the
    globals."""
    import jax.numpy as jnp

    from atomsmm_tpu import alchemy as jalch
    from atomsmm_tpu_torch import alchemy as talch

    n, rc = uf.GRIDS["k1"]
    (js, jx, jb), (ts, tx, tb) = uf._water("jax", n, rc), uf._water(
        "torch", n, rc)
    js = dataclasses.replace(js, forces=(uf._custom("jax", js, "buck", rc),)
                             + tuple(js.forces[1:]))
    ts = dataclasses.replace(ts, forces=(uf._custom("torch", ts, "buck",
                                                    rc),)
                             + tuple(ts.forces[1:]))
    want = jalch.multistate_energies(js, jx, jb,
                                     {"lam": jnp.asarray(LAMS)})
    tpk.reset_launches()
    got = talch.multistate_energies(ts, tx, tb, {"lam": _lams()})
    assert tpk.CALLABLE_SWEEPS["cell"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=0)


def softcore_user_fn(r_cut, r_switch, name="lambda_vdw"):
    """SoftcoreLennardJonesForce's pair energy as a user function of the
    row's lambda (as chip_smoke.py's path (p3) writes it)."""
    from atomsmm_tpu_torch.ops import pairfuncs as pf
    from atomsmm_tpu_torch.ops.switching import switch_quintic

    def softcore_pair(r, pi, pj, g):
        sig = 0.5 * (pi["sigma"] + pj["sigma"])
        eps = torch.sqrt(pi["epsilon"] * pj["epsilon"])
        u = pf.softcore_lj(r, sig, eps, g[name]) \
            * switch_quintic(r.r, r_switch, r_cut)
        cross = pi["solute"] + pj["solute"] \
            - 2.0 * pi["solute"] * pj["solute"]
        return u * cross

    softcore_pair.takes_rv = True
    return softcore_pair


def test_softcore_as_user_function_matches_builtin_rows():
    """Phenol in 60 waters (SolvationSystem): the softcore force written
    as a user function over sigma, epsilon and solute, its lambda the
    row's global, against the built-in softcore force over 4 lambda rows:
    energies, forces and dU/dlambda_vdw, 1e-10."""
    from atomsmm_tpu_torch.models import phenol_in_water

    base, x, box, solute = phenol_in_water(n_water=60, r_cut=0.5,
                                           r_switch=0.4, neighbors=True,
                                           dtype=F64, device="cpu")
    solv = tamm.SolvationSystem(base, solute)
    soft = next(f for f in solv.forces
                if type(f).__name__ == "SoftcoreLennardJonesForce")
    user = tamm.CustomNonbondedForce(
        per_particle={"sigma": soft.sigma, "epsilon": soft.epsilon,
                      "solute": soft.solute.to(F64)},
        exclusions=soft.exclusions, r_cut=float(soft.r_cut),
        energy_function=softcore_user_fn(float(soft.r_cut),
                                         float(soft.r_switch)))
    k = len(LAMS)
    aux = aux_rows(tnb.make_aux(solv, tnb.all_neighbor_extras(solv, x, box)),
                   k)
    xs, bs = x.expand(k, *x.shape), box.expand(k, 3)
    g = {"lambda_vdw": _lams(), "lambda_coul": _lams()}
    e_u, f_u = user.energy_and_forces_rows(xs, bs, g, aux)
    e_s, f_s = soft.energy_and_forces_rows(xs, bs, g, aux)
    np.testing.assert_allclose(e_u.numpy(), e_s.numpy(), rtol=1e-10,
                               atol=1e-10 * float(e_s.abs().max()))
    np.testing.assert_allclose(f_u.numpy(), f_s.numpy(), rtol=0,
                               atol=1e-9 * float(f_s.abs().max()))
    d_u = user.denergy_dlambda(xs, bs, g, "lambda_vdw", aux)
    single = {"default": {**aux["default"],
                          "bucket": aux["default"]["bucket"][0]}}
    d_s = torch.stack([soft.denergy_dlambda(
        x, box, {"lambda_vdw": g["lambda_vdw"][r]}, "lambda_vdw", single)
        for r in range(k)])
    np.testing.assert_allclose(d_u.numpy(), d_s.numpy(), rtol=1e-10,
                               atol=1e-10 * float(d_s.abs().max()))


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("grid", sorted(uf.GRIDS))
def test_user_rows_one_launch_on_card(cuda, grid, dtype):
    """K1 (grid k1) or K2 (grid k2) on the Buckingham user form over 4
    lambda rows in one launch against the batched float64 twin (float64
    1e-10 and 1e-9 max|F|, float32 1e-4), and each row against its
    single-row launch: K2 bit for bit, K1 at the float32 tolerance (its
    atomics)."""
    dt = getattr(torch, dtype)
    force, system, aux, tx, tb = _port(grid, cuda)
    k = len(LAMS)
    kernel = "half_pair" if grid == "k1" else "cell_pair"
    xs, bs = tx.to(dt).expand(k, *tx.shape), tb.to(dt).expand(k, 3)
    pp = {key: v.to(dt) for key, v in force.per_particle.items()}
    spec, bucket = aux["default"]["spec"], aux["default"]["bucket"]
    buckets = bucket.expand(k, *bucket.shape)
    g = {"lam": _lams(cuda)}
    low = force.lowered(dt, {"lam": 1.0}, cuda)
    form = UserForm(low, low.consts_rows(g, k, cuda), force.r_cut)
    cuda_fn = tpk.half_pair_cuda if kernel == "half_pair" \
        else tpk.full_pair_cuda
    plain = tpk.half_pair_plain if kernel == "half_pair" \
        else tpk.full_pair_plain
    tpk.reset_launches()
    out = cuda_fn(xs, pp, buckets, spec, bs, form, force.r_cut)
    torch.cuda.synchronize()
    assert tpk.USER_LAUNCHES[kernel] == 1
    low64 = force.lowered(F64, {"lam": 1.0}, cuda)
    ref = plain(xs.double(), {key: v.double() for key, v in pp.items()},
                buckets, spec, bs.double(),
                UserForm(low64, low64.consts_rows(g, k, cuda), force.r_cut),
                force.r_cut)
    rtol, ftol = (1e-10, 1e-9) if dt == F64 else (1e-4, 1e-4)
    for r in range(k):
        e, e_p = float(out[r, :, 3].double().sum()), float(ref[r, :, 3].sum())
        assert abs(e - e_p) <= rtol * float(ref[r, :, 3].abs().sum())
        f_p = ref[r, :-1, :3]
        assert float((out[r, :-1, :3].double() - f_p).abs().max()) \
            <= ftol * float(f_p.abs().max())
        one = cuda_fn(xs[r].contiguous(), pp, bucket, spec,
                      bs[r].contiguous(),
                      UserForm(low, form.consts[r], force.r_cut),
                      force.r_cut)
        if kernel == "cell_pair":
            assert torch.equal(one, out[r])
        else:
            f1 = one[:-1, :3].double()
            assert float((out[r, :-1, :3].double() - f1).abs().max()) \
                <= 1e-4 * float(f1.abs().max())
    assert tpk.USER_LAUNCHES[kernel] == 1 + k
