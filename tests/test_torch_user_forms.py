"""User pair functions on K1 and K2 (CustomNonbondedForce): the tracer and
its lowered form (atomsmm_tpu_torch/ops/pairtrace.py), the kernels' plain
twins on a user form, and the force's dispatch, against torch.func.jvp and
the JAX package.

  * the tracer: the lowered (u, du/dr²) of an LJ, the headline's switched
    LJ + reaction field, a Buckingham exp-6 + erfc Coulomb with a global
    lambda, a Mie n-m and a function of the Rv carrier against
    torch.func.jvp of the function itself: float64 at 1e-12 of max|u| and
    max|du|, float32 at 1e-5 (rounding); the tangent seeded on the global
    against jvp in lambda;
  * the refusals: an operation outside the whitelist, a non-scalar
    capture, six per-particle columns and control flow on a value raise
    InputError naming the cause; on the CPU such a function keeps the
    callable sweep;
  * K1's and K2's plain twins on the user form against the JAX package's
    XLA cell sweep of the same function in float64 (energy 1e-10, forces
    1e-9 max|F|), the virial flag against autograd, dU/dλ against jax.grad
    in lambda (1e-10), and one case each against the Pallas kernels
    (stage_and_run_half, stage_and_run) in interpret mode;
  * a 4-step velocity-Verlet trajectory of 64 waters whose nonbonded term
    is the user function, the port's Context against the JAX package's,
    to 1e-9;
  * the generated C++ text compiled by the host's C++ compiler against
    the plain twin (skips where there is none); the operation count that
    chip_smoke.py's bound reads, counted from that text; two builds of
    one new library at once reading whole sources;
  * on the card (marker ``cuda``, skipped here): K1 and K2 on the user
    form against their plain twins in float64 and float32, both exclusion
    forms and both box forms, with the virial flag and dU/dλ; the refusal
    on a CUDA tensor. The card cases import no JAX:
        pytest tests/test_torch_user_forms.py -m cuda -q --noconftest
"""
import dataclasses
import math
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pair_kernel as tpk
from atomsmm_tpu_torch.ops import pairtrace
from atomsmm_tpu_torch.utils import InputError

F64 = torch.float64
KC = 138.935456
RC, RS = 0.7, 0.6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while the file runs: a few hundred atoms stepped
    by several workers at once contend otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ns(mod):
    """The functions a pair function takes, from torch or from jax.numpy,
    so that one definition serves both packages."""
    if mod == "torch":
        return types.SimpleNamespace(
            exp=torch.exp, erfc=torch.erfc, sqrt=torch.sqrt,
            where=torch.where, pow=torch.pow,
            clampmin=lambda v, lo: torch.clamp(v, min=lo))
    import jax.numpy as jnp
    from jax.scipy.special import erfc

    return types.SimpleNamespace(
        exp=jnp.exp, erfc=erfc, sqrt=jnp.sqrt, where=jnp.where,
        pow=jnp.power, clampmin=lambda v, lo: jnp.maximum(v, lo))


def _switch(r, rs, rc, m):
    x = m.clampmin((r - rs) / (rc - rs), 0.0)
    x = -m.clampmin(-x, -1.0)
    return 1.0 + x * x * x * (-10.0 + x * (15.0 - 6.0 * x))


def lj_fn(mod):
    def lj(r, pi, pj, g):
        s = 0.5 * (pi["sigma"] + pj["sigma"])
        e = (pi["epsilon"] * pj["epsilon"]) ** 0.5
        t6 = (s / r) ** 6
        return 4.0 * e * t6 * (t6 - 1.0)
    return lj


def headline_fn(mod, rc=RC, rs=RS, eps_rf=1e15):
    """The headline's switched LJ + reaction-field pair energy
    (NonbondedForce, method 'cutoff') in plain operations."""
    m = _ns(mod)
    k_rf = (eps_rf - 1.0) / ((2.0 * eps_rf + 1.0) * rc ** 3)
    c_rf = 1.0 / rc + k_rf * rc ** 2

    def headline(r, pi, pj, g):
        s = 0.5 * (pi["sigma"] + pj["sigma"])
        e = m.sqrt(pi["epsilon"] * pj["epsilon"])
        t = s / r
        t2 = t * t
        s6 = t2 * t2 * t2
        ulj = 4.0 * e * s6 * (s6 - 1.0) * _switch(r, rs, rc, m)
        qq = pi["charge"] * pj["charge"]
        return ulj + KC * qq * (1.0 / r + k_rf * r * r - c_rf)
    return headline


def buck_fn(mod, alpha=3.1):
    """Buckingham exp-6 scaled by the global lam, + erfc-damped Coulomb:
    exp, erfc, pow, where and clamp; no built-in form has it."""
    m = _ns(mod)

    def buck(r, pi, pj, g):
        a = m.sqrt(pi["A"] * pj["A"])
        b = 0.5 * (pi["B"] + pj["B"])
        c = m.sqrt(pi["C"] * pj["C"])
        rr = m.clampmin(r, 0.08)
        u6 = a * m.exp(-b * rr) - c / m.pow(rr, 6.0)
        core = m.where(r < 0.08, 0.0 * u6 + 50.0, u6)
        return g["lam"] * core + KC * pi["q"] * pj["q"] * m.erfc(
            alpha * r) / r
    return buck


def mie_fn(mod, n=9.0, mexp=6.0):
    cn = n / (n - mexp) * (n / mexp) ** (mexp / (n - mexp))
    m = _ns(mod)

    def mie(r, pi, pj, g):
        s = 0.5 * (pi["sigma"] + pj["sigma"])
        e = m.sqrt(pi["epsilon"] * pj["epsilon"])
        return cn * e * (m.pow(s / r, n) - m.pow(s / r, mexp))
    return mie


def rv_fn(mod):
    """A function of the Rv carrier (r², 1/r, r): the charge product over
    r plus a soft r² well."""
    def f(r, pi, pj, g):
        return KC * pi["charge"] * pj["charge"] * r.rinv \
            + 0.5 * pi["sigma"] * pj["sigma"] * r.r2 - 0.1 * r.r
    f.takes_rv = True
    return f


# --- the tracer --------------------------------------------------------------

FUNCS = {
    "lj": (lj_fn, ("sigma", "epsilon")),
    "headline": (headline_fn, ("charge", "sigma", "epsilon")),
    "buck": (buck_fn, ("A", "B", "C", "q")),
    "mie": (mie_fn, ("sigma", "epsilon")),
    "rv": (rv_fn, ("charge", "sigma")),
}


def _columns(names, n, seed):
    rng = np.random.default_rng(seed)
    base = {"sigma": (0.25, 0.35), "epsilon": (0.3, 0.9),
            "charge": (-0.8, 0.8), "A": (2e4, 5e4), "B": (25.0, 35.0),
            "C": (1e-3, 3e-3), "q": (-1.0, 1.0)}
    return {k: rng.uniform(*base[k], size=n) for k in names}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_lowered_form_matches_jvp(name, dtype):
    dt = getattr(torch, dtype)
    make, names = FUNCS[name]
    fn = make("torch")
    g = {"lam": torch.tensor(0.7, dtype=dt)}
    low = pairtrace.lower_pair_function(fn, names, dt, g)
    n = 2000
    rng = np.random.default_rng(3)
    r2 = torch.tensor(rng.uniform(0.05, 0.7, size=n) ** 2, dtype=dt)
    ci = {k: torch.tensor(v, dtype=dt) for k, v in _columns(names, n, 1).items()}
    cj = {k: torch.tensor(v, dtype=dt) for k, v in _columns(names, n, 2).items()}
    u, du = low.evaluate(r2, [ci[k] for k in names], [cj[k] for k in names],
                         low.consts_of(g))

    def f(s):
        rv = pairtrace.make_rv(s)
        return fn(rv if getattr(fn, "takes_rv", False) else rv.r, ci, cj, g)

    ur, dur = torch.func.jvp(f, (r2,), (torch.ones_like(r2),))
    tol = 1e-12 if dt == F64 else 1e-5
    assert float((u - ur).abs().max()) <= tol * float(ur.abs().max())
    assert float((du - dur).abs().max()) <= tol * float(dur.abs().max())
    if "lam" in low.globals:
        _, dl = low.evaluate(r2, [ci[k] for k in names],
                             [cj[k] for k in names], low.consts_of(g),
                             dconst=low.constant_index("lam"))
        lam = g["lam"]
        _, dlr = torch.func.jvp(
            lambda lv: fn(pairtrace.make_rv(r2).r, ci, cj, {"lam": lv}),
            (lam,), (torch.ones_like(lam),))
        assert float((dl - dlr).abs().max()) <= tol * float(dlr.abs().max())


#: the elementwise operations lowered since the callable cell sweep took
#: the functions that miss the list, each at arguments inside its domain
UNARY_NEW = {"atan": (-3.0, 3.0), "asin": (-0.9, 0.9), "acos": (-0.9, 0.9),
             "sinh": (-3.0, 3.0), "cosh": (-3.0, 3.0), "expm1": (-3.0, 2.0),
             "log1p": (-0.5, 4.0)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("op", sorted(UNARY_NEW))
def test_new_unary_operations_match_jvp(op, dtype):
    """atan, asin, acos, sinh, cosh, expm1 and log1p lower (one special
    result each in the count), and their values and tangents in r² and in
    a global match torch.func.jvp: float64 at 1e-12, float32 at 1e-5."""
    dt = getattr(torch, dtype)
    fun = getattr(torch, op)
    lo, hi = UNARY_NEW[op]

    def fn(r, pi, pj, g):   # the argument spans the domain over r in (0, 1)
        return pi["q"] * pj["q"] * g["lam"] * fun(lo + (hi - lo) * r * r)

    g = {"lam": torch.tensor(0.7, dtype=dt)}
    low = pairtrace.lower_pair_function(fn, ["q"], dt, g)
    assert f"u_{op}(" in low.cuda_source()
    n = 1000
    rng = np.random.default_rng(4)
    r2 = torch.tensor(rng.uniform(0.0025, 0.9025, n), dtype=dt)
    q = [torch.tensor(rng.uniform(0.5, 1.5, n), dtype=dt) for _ in range(2)]
    u, du = low.evaluate(r2, q[:1], q[1:], low.consts_of(g))
    ci, cj = {"q": q[0]}, {"q": q[1]}
    ur, dur = torch.func.jvp(
        lambda s: fn(pairtrace.make_rv(s).r, ci, cj, g), (r2,),
        (torch.ones_like(r2),))
    tol = 1e-12 if dt == F64 else 1e-5
    assert float((u - ur).abs().max()) <= tol * float(ur.abs().max())
    assert float((du - dur).abs().max()) <= tol * float(dur.abs().max())
    _, dl = low.evaluate(r2, q[:1], q[1:], low.consts_of(g),
                         dconst=low.constant_index("lam"))
    _, dlr = torch.func.jvp(
        lambda lv: fn(pairtrace.make_rv(r2).r, ci, cj, {"lam": lv}),
        (g["lam"],), (torch.ones_like(g["lam"]),))
    assert float((dl - dlr).abs().max()) <= tol * float(dlr.abs().max())


def test_runtime_constants_and_literals():
    """A global and a captured 0-d tensor become runtime constants (a new
    value changes the result without a new trace); a float literal is
    baked into the source as an exact hex literal of the working type."""
    scale = torch.tensor(2.0, dtype=F64)

    def fn(r, pi, pj, g):
        return scale * g["k"] * pi["q"] * pj["q"] / r + 0.1

    low = pairtrace.lower_pair_function(fn, ["q"], F64,
                                        {"k": 1.0, "unused": 3.0})
    assert low.globals == ("k",) and len(low.captures) == 1
    assert low.n_consts == 2
    src = low.cuda_source()
    assert float.hex(0.1) in src and "NCONSTS = 2" in src
    r2 = torch.tensor([0.25], dtype=F64)
    q = [torch.tensor([1.0], dtype=F64)]
    u1, _ = low.evaluate(r2, q, q, low.consts_of({"k": 1.0}))
    u2, _ = low.evaluate(r2, q, q, low.consts_of({"k": 3.0}))
    assert float(u1) == pytest.approx(2.0 / 0.5 + 0.1, rel=1e-15)
    assert float(u2) == pytest.approx(6.0 / 0.5 + 0.1, rel=1e-15)
    f32 = pairtrace.lower_pair_function(fn, ["q"], torch.float32, {"k": 1.0})
    assert float.hex(float(np.float32(0.1))) in f32.cuda_source()
    assert "using T = float;" in f32.cuda_source()


def _capture_table():
    table = torch.ones(3, dtype=F64)

    def fn(r, pi, pj, g):
        return table[0] * pi["q"] / r
    return fn


REFUSALS = {
    "operation": (lambda r, pi, pj, g: torch.sign(r) * pi["q"],
                  ("q",), "aten.sign"),
    "capture": (_capture_table(), ("q",), "shape (3,)"),
    "columns": (lambda r, pi, pj, g: r * 0.0,
                ("a", "b", "c", "d", "e", "f"), "6 per-particle columns"),
    "control_flow": (lambda r, pi, pj, g: r if float(r.sum()) > 1 else -r,
                     ("q",), "cannot be traced"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_their_cause(case):
    fn, names, cause = REFUSALS[case]
    with pytest.raises(InputError, match=cause.replace("(", r"\(")
                       .replace(")", r"\)")):
        pairtrace.lower_pair_function(fn, names, F64, {})


def test_whitelist_covers_the_pair_functions():
    """The pair functions of ops/pairfuncs.py, as the forces combine them,
    all lower."""
    from atomsmm_tpu_torch.ops import pairfuncs as pf
    from atomsmm_tpu_torch.ops.switching import switch_quintic

    def every(r, pi, pj, g):
        s, e = pf.lorentz_berthelot(pi["s"], pj["s"], pi["e"], pj["e"])
        qq = pi["q"] * pj["q"]
        return (pf.lj(r, s, e) * switch_quintic(r.r, 0.8, 0.9)
                + pf.coulomb(r, qq) + pf.damped_coulomb(r, qq, 3.1)
                + pf.reaction_field_coulomb(r, qq, 0.9, 78.0)
                + pf.near_pair_energy(r, s, e, qq, 3.1, 0.4, 0.5)
                + pf.softcore_lj(r, s, e, g["lam"])
                + pf.damped_smoothed_energy(r, s, e, qq, 3.1, 0.8, 0.9)
                + pf.hbond_10_12(r, 1e-5 * pi["s"], 1e-3 * pj["s"]))
    every.takes_rv = True
    for dt in (F64, torch.float32):
        low = pairtrace.lower_pair_function(every, ("s", "e", "q"), dt,
                                            {"lam": 0.5})
        assert low.globals == ("lam",)
        assert low.counts()["special"] > 0


def test_counts_follow_the_emitted_code():
    """LoweredPair.counts (chip_smoke.py's bound) counts what the
    generated eval emits: a tangent's operations only where they are
    emitted, no product by the literal 1 or by r²'s unit tangent."""
    def fn(r, pi, pj, g):
        return pi["a"] * pj["a"] * torch.exp(r)

    low = pairtrace.lower_pair_function(fn, ["a"], F64)
    # r = r² (1 / sqrt(r²)) * 1 in float64 (ops/rv.py::make_rv): sqrt (one
    # special), its tangent d / (2 s) (2); 1 / s (1), its tangent
    # -(v v) d (2); the product by 1 (none); r² r⁻¹ (1), its tangent
    # r⁻¹ + r² d (2); a_i a_j (1, no tangent); exp (one special), its
    # tangent (1); the product (1), its tangent of one factor (1)
    assert low.counts() == {"flops": 12, "special": 2}
    src = low.cuda_source()
    body = src[src.index("eval("):src.index("eval_dconst(")]
    assert body.count("u_sqrt(") + body.count("u_exp(") == 2


def test_concurrent_builds_read_whole_sources(tmp_path, monkeypatch):
    """Two builds of one new user-form library at once (two ranks of a
    spatial mesh on one node, or two test workers): each compiler reads
    the generated header and wrapper whole, never a part-written file."""
    import threading

    from atomsmm_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    header = "// a generated user form\n" + "// padding\n" * 200000
    job = ("half_pair", header, 0, 0)
    torn = []

    def compile_(todo):
        for so, src in todo.items():
            for _ in range(20):
                wrapper = src.read_text()
                head = (tmp_path / f"{so.stem[3:]}.cuh").read_text()
                if head != header or not wrapper.endswith('.cu"\n'):
                    torn.append(src.name)
            so.write_bytes(b"")

    monkeypatch.setattr(_build, "_compile", compile_)
    so = _build.user_library_path(*job)

    def builds(barrier):
        for _ in range(10):
            barrier.wait()
            _build.build_user([job])
            barrier.wait()
            so.unlink(missing_ok=True)

    barrier = threading.Barrier(2)
    threads = [threading.Thread(target=builds, args=(barrier,))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not torn
    assert not list(tmp_path.glob("*.tmp"))


# --- K1's and K2's twins against the JAX package -----------------------------


def _water(pkg, n, rc, seed=5):
    if pkg == "jax":
        from atomsmm_tpu import models as jmodels

        return jmodels.water_system(n_molecules=n, r_cut=rc,
                                    r_switch=rc - 0.1, seed=seed,
                                    neighbors=True)
    return tmodels.water_system(n_molecules=n, r_cut=rc, r_switch=rc - 0.1,
                                seed=seed, neighbors=True, dtype=F64,
                                device="cpu")


def _buck_columns(charge, n):
    cols = _columns(("A", "B", "C"), n, 11)
    return {**cols, "q": np.asarray(charge)}


def _custom(pkg, system, name, rc):
    """(CustomNonbondedForce of function `name` on `system`'s atoms, its
    per-particle columns)."""
    mod = "jax" if pkg == "jax" else "torch"
    nb = system.forces[0]
    if name == "headline":
        fn = headline_fn(mod, rc, rc - 0.1)
        pp = {"charge": nb.charge, "sigma": nb.sigma, "epsilon": nb.epsilon}
    else:
        fn = buck_fn(mod)
        cols = _buck_columns(np.asarray(nb.charge), nb.charge.shape[0])
        if pkg == "jax":
            import jax.numpy as jnp

            pp = {k: jnp.asarray(v) for k, v in cols.items()}
        else:
            pp = {k: torch.tensor(v, dtype=F64) for k, v in cols.items()}
    if pkg == "jax":
        import atomsmm_tpu as jamm

        cls = jamm.CustomNonbondedForce
    else:
        cls = tamm.CustomNonbondedForce
    return cls(per_particle=pp, exclusions=nb.exclusions, energy_function=fn,
               r_cut=rc)


# (waters, cutoff): 216 at 0.5 nm takes K1 (a 3^3 grid with half maps),
# 125 at 0.6 nm K2 (a 2^3 grid)
GRIDS = {"k1": (216, 0.5), "k2": (125, 0.6)}


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for grid, (n, rc) in GRIDS.items():
        js, jx, jb = _water("jax", n, rc)
        ts, tx, tb = _water("torch", n, rc)
        out[grid] = ((js, jx, jb), (ts, tx, tb), rc)
    return out


@pytest.mark.parametrize("name", ["headline", "buck"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_twin_on_user_form_matches_jax_sweep(pairs, grid, name):
    import jax

    from atomsmm_tpu.ops import neighbors as jnb

    (js, jx, jb), (ts, tx, tb), rc = pairs[grid]
    assert tnb.takes_half_stencil(ts.neighbors) == (grid == "k1")
    jf, tf = _custom("jax", js, name, rc), _custom("torch", ts, name, rc)
    lam = 0.65
    jg, tg = {"lam": lam}, {"lam": torch.tensor(lam, dtype=F64)}
    jspec = dataclasses.replace(js.neighbors, backend="xla")
    jbucket = jnb.neighbor_list_extras(jspec, jx, jb)[jnb.NBR_BUCKET]
    je, jfor = jnb.cell_pair_energy_forces(jf._pair_fn(jg), jx, jb,
                                           jf._per_particle(jg), jspec,
                                           jbucket, rc)
    tsys = tamm.System(masses=ts.masses, forces=(tf,),
                       default_box=tb).with_neighbors(ts.neighbors)
    aux = tnb.make_aux(tsys, tnb.all_neighbor_extras(tsys, tx, tb))
    form = tf._kernel_form(tg, tx, aux["default"])
    assert isinstance(form, pairtrace.UserForm)
    te, tfor = tf.energy_and_forces(tx, tb, tg, aux)
    jfor = np.asarray(jfor)
    assert float(te) == pytest.approx(float(je), rel=1e-10)
    np.testing.assert_allclose(tfor.numpy(), jfor, rtol=0,
                               atol=1e-9 * np.abs(jfor).max())
    # the energy alone, the virial flag against autograd of the twin, and
    # dU/dlambda against jax.grad in lambda
    assert float(tf.energy(tx, tb, tg, aux)) == pytest.approx(float(te),
                                                              rel=1e-12)
    w, fw = tf.virial(tx, tb, tg, aux)
    pair = tf._pair_fn(tg)
    wr, _ = tamm.forces.autograd_virial(
        lambda xx, bb: tnb.cell_pair_energy_fn(
            pair, xx, bb, tf.per_particle, ts.neighbors,
            aux["default"]["bucket"], rc), tx, tb)
    assert float(w) == pytest.approx(float(wr), rel=1e-10)
    np.testing.assert_allclose(fw.numpy(), tfor.numpy(), rtol=0,
                               atol=1e-12 * np.abs(jfor).max())
    dl = tf.denergy_dlambda(tx, tb, tg, "lam", aux)
    if name == "headline":   # the function reads no lambda
        assert float(dl) == 0.0
        return
    jdl = jax.grad(lambda lv: jnb.cell_pair_energy_forces(
        jf._pair_fn({"lam": lv}), jx, jb, jf._per_particle(jg), jspec,
        jbucket, rc)[0])(lam)
    assert float(dl) == pytest.approx(float(jdl), rel=1e-10)


@pytest.mark.parametrize("half", [True, False])
def test_twin_matches_pallas_interpret(half):
    """One case each against the JAX package's Pallas kernels in interpret
    mode (the headline function: no erfc, which the Pallas trace swaps for
    a polynomial)."""
    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.ops.neighbors import NBR_BUCKET, neighbor_list_extras
    from atomsmm_tpu.ops.pallas_pair import stage_and_run, stage_and_run_half

    jsys, jx, jb = jmodels.argon_system(n=500, jitter=0.25, seed=3,
                                        neighbors=True)
    tsys, tx, tb = tmodels.argon_system(n=500, jitter=0.25, seed=3,
                                        neighbors=True, dtype=F64,
                                        device="cpu")
    rc = float(tsys.forces[0].r_cut)
    jspec, tspec = jsys.neighbors, tsys.neighbors
    if not half:
        jspec = dataclasses.replace(jspec, half_stencil=False)
        tspec = dataclasses.replace(tspec, half_stencil=False)
    assert tnb.takes_half_stencil(tspec) == half
    fn_j, fn_t = lj_fn("jax"), lj_fn("torch")
    jnbf, tnbf = jsys.forces[0], tsys.forces[0]
    jpp = {"sigma": jnbf.sigma, "epsilon": jnbf.epsilon}
    tpp = {"sigma": tnbf.sigma, "epsilon": tnbf.epsilon}
    bucket = neighbor_list_extras(jspec, jx, jb)[NBR_BUCKET]
    run = stage_and_run_half if half else stage_and_run
    je, jf = run(jspec, lambda r, pi, pj: fn_j(r, pi, pj, {}), jx, jb, jpp,
                 bucket, rc, interpret=True)
    tforce = tamm.CustomNonbondedForce(per_particle=tpp,
                                       exclusions=tnbf.exclusions,
                                       energy_function=fn_t, r_cut=rc)
    s = tamm.System(masses=tsys.masses, forces=(tforce,),
                    default_box=tb).with_neighbors(tspec)
    aux = tnb.make_aux(s, tnb.all_neighbor_extras(s, tx, tb))
    te, tf = tforce.energy_and_forces(tx, tb, {}, aux)
    jf = np.asarray(jf)
    assert float(te) == pytest.approx(float(je), rel=1e-10)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0,
                               atol=1e-9 * np.abs(jf).max())


def test_unlowerable_function_keeps_callable_sweep_on_cpu(pairs):
    """On the CPU a function outside the whitelist runs through the
    callable sweep, as before, and agrees with the lowered twin of the
    same physics."""
    (_, _, _), (ts, tx, tb), rc = pairs["k2"]
    base = headline_fn("torch", rc, rc - 0.1)

    def odd(r, pi, pj, g):   # sign(r) = 1: the same energy, not lowerable
        return torch.sign(r) * base(r, pi, pj, g)

    nb = ts.forces[0]
    pp = {"charge": nb.charge, "sigma": nb.sigma, "epsilon": nb.epsilon}
    forces = [tamm.CustomNonbondedForce(per_particle=pp,
                                        exclusions=nb.exclusions,
                                        energy_function=f, r_cut=rc)
              for f in (odd, base)]
    s = tamm.System(masses=ts.masses, forces=(forces[0],),
                    default_box=tb).with_neighbors(ts.neighbors)
    aux = tnb.make_aux(s, tnb.all_neighbor_extras(s, tx, tb))
    with pytest.warns(RuntimeWarning, match="aten.sign"):
        assert forces[0]._kernel_form({}, tx, aux["default"]) is None
    e0, f0 = forces[0].energy_and_forces(tx, tb, {}, aux)
    e1, f1 = forces[1].energy_and_forces(tx, tb, {}, aux)
    assert float(e0) == pytest.approx(float(e1), rel=1e-10)
    np.testing.assert_allclose(f0.numpy(), f1.numpy(), rtol=0,
                               atol=1e-9 * float(f1.abs().max()))


def test_home_cell_ranges_sum_to_the_sweep(pairs):
    """K2's twin on a user form over disjoint home-cell ranges (the spatial
    mesh's force decomposition, parallel/spatial.py) sums to the whole
    sweep bit for bit."""
    (_, _, _), (ts, tx, tb), rc = pairs["k2"]
    tf = _custom("torch", ts, "buck", rc)
    spec = ts.neighbors
    bucket, _ = tnb.build_cell_buckets(spec, tx, tb)
    g = {"lam": 0.65}
    form = pairtrace.user_form(tf.lowered(F64, g), g, rc)
    whole = tpk.full_pair_rows(form, tx, tb, tf.per_particle, spec, bucket,
                               rc)
    cut = spec.ncells // 3
    parts = sum(tpk.full_pair_rows(form, tx, tb, tf.per_particle, spec,
                                   bucket, rc, cells=c)
                for c in ((0, cut), (cut, spec.ncells)))
    assert torch.equal(parts, whole)


# --- through the API ---------------------------------------------------------


def test_velocity_verlet_trajectory_matches_jax():
    """64 waters, the nonbonded term as the headline user function on the
    cells (K2's twin), the bonded terms as built: 4 velocity-Verlet steps
    of the port's Context against the JAX package's."""
    import atomsmm_tpu as jamm

    rc = 0.6
    (js, jx, jb), (ts, tx, tb) = _water("jax", 64, rc), _water("torch", 64,
                                                               rc)
    js = dataclasses.replace(js, forces=(_custom("jax", js, "headline", rc),)
                             + tuple(js.forces[1:]))
    ts = dataclasses.replace(ts, forces=(_custom("torch", ts, "headline",
                                                 rc),) + tuple(ts.forces[1:]))
    m = np.asarray(ts.masses, np.float64)
    v = np.random.RandomState(9).normal(size=(m.size, 3)) \
        * np.sqrt(tamm.units.BOLTZMANN * 300.0 / m)[:, None]
    jctx = jamm.Context(js, jamm.VelocityVerletIntegrator(0.001),
                        jamm.make_state(jx, v=v, box=jb))
    tctx = tamm.Context(ts, tamm.VelocityVerletIntegrator(0.001),
                        tamm.make_state(tx, v=torch.as_tensor(v), box=tb))
    jctx.step(4)
    tctx.step(4)
    for got, want in ((tctx.state.x, jctx.state.x),
                      (tctx.state.v, jctx.state.v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


# --- the generated text on the host ------------------------------------------

_HOST_MAIN = r"""
#include "user_pair.cuh"
#include <cstdio>
int main() {
  using T = UserPair::T;
  int n;
  if (std::scanf("%d", &n) != 1) return 1;
  T c[UserPair::NCONSTS > 0 ? UserPair::NCONSTS : 1];
  for (int k = 0; k < UserPair::NCONSTS; ++k) {
    double v; if (std::scanf("%lf", &v) != 1) return 1; c[k] = (T)v;
  }
  for (int i = 0; i < n; ++i) {
    double r2; T pi[UserPair::NCOLS], pj[UserPair::NCOLS];
    if (std::scanf("%lf", &r2) != 1) return 1;
    for (int k = 0; k < UserPair::NCOLS; ++k) {
      double v; if (std::scanf("%lf", &v) != 1) return 1; pi[k] = (T)v;
    }
    for (int k = 0; k < UserPair::NCOLS; ++k) {
      double v; if (std::scanf("%lf", &v) != 1) return 1; pj[k] = (T)v;
    }
    T u, du, ul, dl;
    UserPair::eval((T)r2, pi, pj, c, u, du);
    UserPair::eval_dconst((T)r2, pi, pj, c, 0, ul, dl);
    std::printf("%.17g %.17g %.17g\n", (double)u, (double)du, (double)dl);
  }
  return 0;
}
"""


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_generated_text_compiles_on_host(tmp_path, dtype):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the generated text")
    from atomsmm_tpu_torch import _build

    dt = getattr(torch, dtype)
    names = FUNCS["buck"][1]
    g = {"lam": 0.8}
    low = pairtrace.lower_pair_function(buck_fn("torch"), names, dt, g)
    (tmp_path / "user_pair.cuh").write_text(low.cuda_source())
    (tmp_path / "main.cpp").write_text(_HOST_MAIN)
    exe = tmp_path / "main"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-I", str(_build.CSRC), "-I", str(tmp_path),
                    str(tmp_path / "main.cpp"), "-o", str(exe)], check=True)
    n = 300
    rng = np.random.default_rng(5)
    r2 = rng.uniform(0.06, 0.7, size=n) ** 2
    ci, cj = _columns(names, n, 1), _columns(names, n, 2)
    consts = low.consts_of(g)
    text = [str(n)] + [repr(float(v)) for v in consts.tolist()]
    for i in range(n):
        text.append(repr(float(r2[i])))
        text += [repr(float(ci[k][i])) for k in names]
        text += [repr(float(cj[k][i])) for k in names]
    got = np.loadtxt(subprocess.run(
        [str(exe)], input=" ".join(text), capture_output=True, text=True,
        check=True).stdout.splitlines()).reshape(n, 3)
    t = lambda a: torch.tensor(a, dtype=F64).to(dt)  # noqa: E731
    pi = [t(ci[k]) for k in names]
    pj = [t(cj[k]) for k in names]
    u, du = low.evaluate(t(r2), pi, pj, consts)
    _, dl = low.evaluate(t(r2), pi, pj, consts, dconst=0)
    tol = 1e-12 if dt == F64 else 1e-5
    for col, want in enumerate((u, du, dl)):
        want = want.double().numpy()
        np.testing.assert_allclose(got[:, col], want, rtol=0,
                                   atol=tol * np.abs(want).max())


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(kernel, exc, tri):
    """(port force of the Buckingham function, spec, x, box) on the CPU in
    float64: water 216 at 0.5 nm for K1, 125 at 0.6 nm for K2; the split
    exclusion form adds far exclusions between the first atoms of
    molecules 0..9 and 100..109; a (3, 3) box shears the cube by 0.1 L."""
    n, rc = GRIDS[kernel]
    s, x, box = _water("torch", n, rc)
    nb = s.forces[0]
    exclusions = nb.exclusions
    if exc == "split":
        extra = torch.full((exclusions.shape[0], 1), -1, dtype=torch.int32)
        for k in range(10):
            a, b = 3 * k, 3 * (100 + k)
            extra[a, 0], extra[b, 0] = b, a
        exclusions = torch.cat([exclusions, extra], dim=1)
    if tri == "tri":
        length = float(box[0])
        box = torch.tensor([[length, 0.0, 0.0], [0.1 * length, length, 0.0],
                            [0.0, 0.0, length]], dtype=F64)
    spec = tnb.make_neighbor_spec(box, x.shape[0], rc, exclusions=exclusions,
                                  occupancy_floor_from=x, device="cpu")
    assert spec.exclusion_form == ("split" if exc == "split" else "bits")
    force = dataclasses.replace(_custom("torch", s, "buck", rc),
                                exclusions=exclusions)
    return force, spec, x, box


@pytest.mark.cuda
@pytest.mark.parametrize("tri", ["ortho", "tri"])
@pytest.mark.parametrize("exc", ["bits", "split"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_user_form_kernel_matches_twin_on_card(cuda, kernel, dtype, exc,
                                               tri):
    """K1 / K2 on the Buckingham user form against the float64 plain twin
    on the same inputs: energy, forces, the virial flag and dU/dlambda.
    Float64 at 1e-10 (energy) and 1e-9 max|F|; float32 at 1e-4."""
    dt = getattr(torch, dtype)
    force, spec, x, box = _card_case(kernel, exc, tri)
    half = tnb.takes_half_stencil(spec)
    assert half == (kernel == "k1")
    g = {"lam": 0.65}
    xd, boxd = x.to(cuda, dt), box.to(cuda, dt)
    dspec = tnb.make_neighbor_spec(boxd, x.shape[0], force.r_cut,
                                   exclusions=force.exclusions,
                                   occupancy_floor_from=x, device=cuda)
    bucket, _ = tnb.build_cell_buckets(dspec, xd, boxd)
    pp = {k: v.to(cuda, dt) for k, v in force.per_particle.items()}
    dforce = dataclasses.replace(force, per_particle=pp)
    # the plain twin in float64 on the card's float32-rounded inputs
    x64, box64 = xd.double().cpu(), boxd.double().cpu()
    pp64 = {k: v.double().cpu() for k, v in pp.items()}
    low64 = pairtrace.lower_pair_function(force.energy_function,
                                          list(pp64), F64, g)
    low = dforce.lowered(dt, g, cuda)
    sweep = tpk.half_pair_energy_forces if half else \
        tpk.full_pair_energy_forces
    rtol, ftol = (1e-10, 1e-9) if dt == F64 else (1e-4, 1e-4)
    tpk.reset_launches()
    for flags in ({}, {"virial": True}, {"dconst": 0}):
        form = dataclasses.replace(pairtrace.user_form(low, g, force.r_cut,
                                                       cuda), **flags)
        plain = dataclasses.replace(pairtrace.user_form(low64, g,
                                                        force.r_cut), **flags)
        e, f = sweep(form, xd, boxd, pp, dspec, bucket, force.r_cut)
        ep, fp = sweep(plain, x64, box64, pp64, spec_cpu(dspec),
                       bucket.cpu(), force.r_cut)
        assert abs(float(e) - float(ep)) <= rtol * max(abs(float(ep)), 1.0)
        if "dconst" not in flags:
            np.testing.assert_allclose(f.double().cpu().numpy(), fp.numpy(),
                                       rtol=0,
                                       atol=ftol * float(fp.abs().max()))
    assert tpk.USER_LAUNCHES == {"half_pair": 3 * half,
                                 "cell_pair": 3 * (not half),
                                 "tile_pair": 0}
    assert tpk.LAUNCHES == {k: 0 for k in tpk.LAUNCHES}


def spec_cpu(spec):
    """A spec's tensors moved to the CPU (the plain twin's copy)."""
    return dataclasses.replace(spec, **{
        f.name: getattr(spec, f.name).cpu()
        for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)})


@pytest.mark.cuda
def test_unlowerable_function_raises_on_card(cuda):
    """A function that does not lower runs on a CUDA cell list through the
    callable cell sweep, counted in CALLABLE_SWEEPS with one warning naming
    the lowering error, and agrees with the same sweep on the CPU; no user
    launch."""
    s, x, box = _water("torch", 216, 0.6)
    nb = s.forces[0]

    def odd(r, pi, pj, g):
        return torch.sign(r) * pi["q"] * pj["q"] / r

    out = []
    for dev in ("cpu", cuda):
        force = tamm.CustomNonbondedForce(
            per_particle={"q": nb.charge.to(dev)},
            exclusions=nb.exclusions.to(dev), energy_function=odd,
            r_cut=0.6)
        xd, boxd = x.to(dev), box.to(dev)
        spec = tnb.make_neighbor_spec(boxd, x.shape[0], 0.6,
                                      exclusions=nb.exclusions, device=dev)
        sysd = tamm.System(masses=s.masses.to(dev), forces=(force,),
                           default_box=boxd).with_neighbors(spec)
        aux = tnb.make_aux(sysd, tnb.all_neighbor_extras(sysd, xd, boxd))
        tpk.reset_launches()
        with pytest.warns(RuntimeWarning, match="aten.sign"):
            out.append(force.energy_and_forces(xd, boxd, {}, aux))
        force.energy(xd, boxd, {}, aux)
        assert tpk.CALLABLE_SWEEPS["cell"] == 2
        assert tpk.USER_LAUNCHES == {k: 0 for k in tpk.USER_LAUNCHES}
        assert math.isfinite(float(force.energy(xd, boxd, {}, None)))
    (e_c, f_c), (e_g, f_g) = out
    assert float(e_g) == pytest.approx(float(e_c), rel=1e-10)
    np.testing.assert_allclose(f_g.cpu().numpy(), f_c.numpy(), rtol=0,
                               atol=1e-9 * float(f_c.abs().max()))
