"""K3 on a user pair function: the tile-list sweep (ops/tilepair.py) with a
CustomNonbondedForce's function lowered by ops/pairtrace.py, as the JAX
package's tile_pair_energy_forces(pair_fn, ...) traces any pair function
into its tile kernel.

  * K3's plain twin on the user form against the JAX package's
    tile_pair_energy_forces(pair_fn, ...) on the CPU (its XLA evaluation,
    which the JAX package's own tests run there), float64: energy 1e-10,
    forces 1e-9 x max|F|, on water 216 with 32-atom blocks and argon 216,
    for the headline's switched LJ + reaction field and a Buckingham
    exp-6 + erfc Coulomb with a global lambda; dU/dlambda (the tangent
    seeded on the global) against jax.grad in lambda;
  * the virial flag (each pair's -2 r^2 du/dr^2 in the energy column)
    against autograd of the twin's energy under a scaling of x and the
    box, 1e-10;
  * on the card (marker ``cuda``, skipped here): K3 compiled with the user
    form against the float64 twin in every flag, float64 at 1e-10 and
    1e-9 x max|F|, float32 at 1e-4, one user launch each. They import no
    JAX:
        pytest tests/test_torch_tile_user.py -m cuda -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as tamm
import test_torch_user_forms as uf
from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.ops import pair_kernel as tpk
from atomsmm_tpu_torch.ops import pairtrace
from atomsmm_tpu_torch.ops import tilepair as ttp

F64 = torch.float64
LAM = 0.65


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(pkg, name):
    """(system, x, box) of water 216 at 0.8 nm (32-atom blocks) or argon
    216, in the JAX package or the port (float64 on the CPU)."""
    if pkg == "jax":
        from atomsmm_tpu import models as jmodels

        mod = jmodels
        kw = {}
    else:
        mod = tmodels
        kw = {"dtype": F64, "device": "cpu"}
    if name == "argon":
        return mod.argon_system(n=216, jitter=0.25, seed=1, **kw)
    return mod.water_system(n_molecules=216, r_cut=0.8, r_switch=0.7, **kw)


def _columns(pkg, force, fn_name):
    """The function's per-particle columns, as numpy arrays, in the order
    the lowered form stages them."""
    if fn_name == "headline":
        return {"charge": np.asarray(force.charge),
                "sigma": np.asarray(force.sigma),
                "epsilon": np.asarray(force.epsilon)}
    return uf._buck_columns(np.asarray(force.charge), force.charge.shape[0])


def _fn(pkg, fn_name, rc):
    mod = "jax" if pkg == "jax" else "torch"
    return (uf.headline_fn(mod, rc, rc - 0.1) if fn_name == "headline"
            else uf.buck_fn(mod))


def _port_case(name, fn_name, device="cpu"):
    """(port force of the function, tile spec, list, x, box, r_cut) in
    float64 on `device`."""
    s, x, box = _system("torch", name)
    nb = s.forces[0]
    rc = float(nb.r_cut)
    cols = {k: torch.as_tensor(v, dtype=F64, device=device)
            for k, v in _columns("torch", nb, fn_name).items()}
    force = tamm.CustomNonbondedForce(
        per_particle=cols, exclusions=nb.exclusions.to(device),
        energy_function=_fn("torch", fn_name, rc), r_cut=rc)
    x, box = x.to(device), box.to(device)
    kw = {"block_size": 32} if name == "water" else {}
    spec = ttp.make_tilepair_spec(box, x.shape[0], rc,
                                  exclusions=nb.exclusions,
                                  occupancy_from=x, device=device, **kw)
    lst = ttp.build_tile_pairs(spec, x, box)
    assert not bool(lst[4])
    return force, spec, lst, x, box, rc


def _form(force, dtype, device, **flags):
    g = {"lam": torch.tensor(LAM, dtype=dtype, device=device)}
    low = force.lowered(dtype, g, device)
    return dataclasses.replace(pairtrace.user_form(low, g, force.r_cut,
                                                   device), **flags)


def _sweep(form, force, spec, lst, x, box, dtype=F64):
    pp = {k: v.to(dtype) for k, v in force.per_particle.items()}
    return ttp.tile_pair_energy_forces(form, x.to(dtype), box.to(dtype), pp,
                                       spec, *lst[:4], force.r_cut)


@pytest.mark.parametrize("fn_name", ["headline", "buck"])
@pytest.mark.parametrize("name", ["water", "argon"])
def test_twin_on_user_form_matches_jax_tile_sweep(name, fn_name):
    import jax

    from atomsmm_tpu.ops import tilepair as jtp

    force, spec, lst, x, box, rc = _port_case(name, fn_name)
    js, jx, jb = _system("jax", name)
    jnb = js.forces[0]
    np.testing.assert_allclose(np.asarray(jx), x.numpy(), rtol=0, atol=0)
    kw = {"block_size": 32} if name == "water" else {}
    jspec = jtp.make_tilepair_spec(np.asarray(jb), jx.shape[0], rc,
                                   exclusions=np.asarray(jnb.exclusions),
                                   occupancy_from=np.asarray(jx), **kw)
    jlist = jtp.build_tile_pairs(jspec, jx, jb)
    for a, b in zip(jlist[:4], lst[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jfn = _fn("jax", fn_name, rc)
    import jax.numpy as jnp

    jpp = {k: jnp.asarray(v) for k, v in _columns("jax", jnb,
                                                   fn_name).items()}

    def jax_energy_forces(lam):
        return jtp.tile_pair_energy_forces(
            lambda r, pi, pj: jfn(r, pi, pj, {"lam": lam}), jx, jb, jpp,
            jspec, *jlist[:4], rc)

    je, jf = jax_energy_forces(LAM)
    te, tf = _sweep(_form(force, F64, "cpu"), force, spec, lst, x, box)
    jf = np.asarray(jf)
    assert float(te) == pytest.approx(float(je), rel=1e-10)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0,
                               atol=1e-9 * np.abs(jf).max())
    dl, _ = _sweep(_form(force, F64, "cpu", dconst=0), force, spec, lst, x,
                   box)
    if fn_name == "headline":   # the function reads no lambda
        assert force.lowered(F64, {"lam": LAM}).globals == ()
        return
    jdl = jax.grad(lambda lv: jax_energy_forces(lv)[0])(LAM)
    assert float(dl) == pytest.approx(float(jdl), rel=1e-10)


@pytest.mark.parametrize("fn_name", ["headline", "buck"])
def test_virial_flag_matches_autograd(fn_name):
    force, spec, lst, x, box, rc = _port_case("water", fn_name)
    w, fw = _sweep(_form(force, F64, "cpu", virial=True), force, spec, lst,
                   x, box)
    e, f = _sweep(_form(force, F64, "cpu"), force, spec, lst, x, box)
    form = _form(force, F64, "cpu")
    wr, _ = tamm.forces.autograd_virial(
        lambda xx, bb: ttp.tile_pair_energy_forces(
            form, xx, bb, force.per_particle, spec, *lst[:4], rc)[0], x, box)
    assert float(w) == pytest.approx(float(wr), rel=1e-10)
    np.testing.assert_allclose(fw.numpy(), f.numpy(), rtol=0,
                               atol=1e-12 * float(f.abs().max()))


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["energy", "virial", "dlambda"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fn_name", ["headline", "buck"])
def test_user_form_k3_matches_twin_on_card(cuda, fn_name, dtype, flags):
    """K3 on the user form against the float64 twin on the card's inputs
    (float32-rounded where the kernel runs float32): energy (or the
    virial, or dU/dlambda) and forces, float64 at 1e-10 and 1e-9 max|F|,
    float32 at 1e-4 (the virial and dU/dlambda of sum |e_i|)."""
    dt = getattr(torch, dtype)
    force, spec, lst, x, box, rc = _port_case("water", fn_name, cuda)
    kw = {"energy": {}, "virial": {"virial": True},
          "dlambda": {"dconst": 0}}[flags]
    if flags == "dlambda" and fn_name == "headline":
        pytest.skip("the headline function reads no global")
    xd, bd = x.to(dt), box.to(dt)
    tpk.reset_launches()
    e, f = _sweep(_form(force, dt, cuda, **kw), force, spec, lst, xd, bd,
                  dt)
    torch.cuda.synchronize()
    assert tpk.USER_LAUNCHES == {"half_pair": 0, "cell_pair": 0,
                                 "tile_pair": 1}
    assert tpk.LAUNCHES == {k: 0 for k in tpk.LAUNCHES}
    plain = _form(force, F64, cuda, **kw)
    pp = {k: v.to(dt).double() for k, v in force.per_particle.items()}
    fs, ms = ttp._stage(spec, xd.double(), bd.double(), pp, spec.excbits,
                        lst[0], names=plain.lowered.names)
    acc = ttp.tile_pair_plain(fs, ms, *lst[1:4], bd.double(), plain, rc)
    nb = spec.n_blocks
    ep = acc[:nb, :, 3].sum()
    fp = torch.zeros((x.shape[0] + 1, 3), dtype=F64, device=cuda)
    fp.index_add_(0, lst[0].long(), acc[:nb, :, :3].reshape(-1, 3))
    fp = fp[:-1]
    rtol, ftol = (1e-10, 1e-9) if dt == F64 else (1e-4, 1e-4)
    scale = (float(acc[:nb, :, 3].abs().sum()) if flags != "energy"
             else abs(float(ep)))
    assert abs(float(e) - float(ep)) <= rtol * scale
    if flags != "dlambda":
        np.testing.assert_allclose(f.double().cpu().numpy(),
                                   fp.cpu().numpy(), rtol=0,
                                   atol=ftol * float(fp.abs().max()))
