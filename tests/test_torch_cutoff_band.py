"""The float32 kernels decide the cutoff as the float64 reference does.

A float32 sweep computes r^2 with the rounding of the coordinates'
difference, of the image shift and of a staged frame, so a pair within
that rounding of the cutoff could fall on the other side of it than the
float64 plain twin, given the same float32 coordinates, puts it. Under
PME the truncated Ewald force jumps there by more than 1e-4 of the
largest force (one O-O pair of TIP3P at 0.9 nm: 0.38 kJ/mol/nm). K1, K2,
K3 and K4 decide the slots within pair_forms.cuh::CUT_BAND of the cutoff
again in float64, from the stored coordinates (K3: the staged unshifted
coordinates, the entry's wrap x box added in float64).

These cases take O-O pairs of water at their float64 distance d and
set the mask cutoff to d (1 + 1e-12), the pair in range, or d (1 - 1e-12),
out of range. Both cutoffs round to one float32 value, so a test made in
float32 alone gives one answer for both and misses in one of the two; the
CPU case shows that of the float32 plain twin. The pair form is reaction
field with its own 0.9 nm cutoff, so the pair's force at the mask cutoff
is about 10 kJ/mol/nm, far above the tolerance. The tile list (K3) takes
the same water with its coordinates wrapped into the box before they are
rounded to float32, so that its staging moves no coordinate; its float64
twin is held to the JAX package's tile sweep with the pair within 5e-8 nm
of the cutoff on either side.

    pytest tests/test_torch_cutoff_band.py -q
    pytest tests/test_torch_cutoff_band.py -m cuda -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from atomsmm_tpu_torch import models as tmodels
from atomsmm_tpu_torch.ops import blocks as tblocks
from atomsmm_tpu_torch.ops import neighbors as nb
from atomsmm_tpu_torch.ops import pair_kernel as pk
from atomsmm_tpu_torch.ops import tilepair as ttp
from atomsmm_tpu_torch.ops.pbc import minimum_image

F32, F64 = torch.float32, torch.float64
N_PAIRS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _water(n_molecules=400):
    """Water (0.9 nm, reaction field; 400 molecules, whose cell grid takes
    K2, or 800, whose grid takes K1's half stencil), each molecule moved
    off its lattice site by a draw of numpy.random.default_rng(7) of up to
    0.03 nm a component (so that no two pairs share a distance), with its
    coordinates rounded to float32 and held in float64; its force, and
    N_PAIRS O-O pairs of other molecules at float64 distances between 0.85
    and 0.89 nm."""
    m = n_molecules
    system, x, box = tmodels.water_system(
        n_molecules=m, r_cut=0.9, r_switch=0.8, method="cutoff", seed=5,
        dtype=F64, device="cpu")
    shift = np.random.default_rng(7).uniform(-0.03, 0.03, (m, 1, 3))
    x = (x.reshape(m, 3, 3) + torch.as_tensor(shift)).reshape(-1, 3)
    x, box = x.to(F32).to(F64), box.to(F32).to(F64)
    o = torch.arange(0, x.shape[0], 3)
    d = minimum_image(x[o][:, None] - x[o][None], box).norm(dim=-1)
    i, j = torch.nonzero(torch.triu((d > 0.85) & (d < 0.89), 1),
                         as_tuple=True)
    pairs = [(int(o[a]), int(o[b]), float(d[a, b]))
             for a, b in zip(i[:N_PAIRS], j[:N_PAIRS])]
    assert len(pairs) == N_PAIRS
    return system.forces[0], x, box, pairs


def _mask_cut(dist, side):
    return dist * (1 + 1e-12) if side == "in" else dist * (1 - 1e-12)


def _sweep(force, x, box, r_cut, dev, dtype, half):
    """The cell-list sweep of `force` at the mask cutoff r_cut, through the
    wrapper on `dev` in `dtype` (K1 with the half stencil, K2 without on
    the card; the plain twins on the CPU): (energy, forces) in float64 on
    the CPU."""
    spec = nb.make_neighbor_spec(box, x.shape[0], 0.9,
                                 exclusions=force.exclusions,
                                 occupancy_floor_from=x, device="cpu")
    spec = dataclasses.replace(spec, half_stencil=half) if not half else spec
    spec = dataclasses.replace(spec, **{
        f.name: getattr(spec, f.name).to(dev)
        for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)})
    pp = {k: v.to(dev, dtype) for k, v in force._per_particle().items()}
    xd, bd = x.to(dev, dtype), box.to(dev, dtype)
    bucket, overflow = nb.build_cell_buckets(spec, xd, bd)
    assert not bool(overflow)
    e, f = nb.cell_pair_energy_forces(force._pair_form(), xd, bd, pp, spec,
                                      bucket, r_cut)
    return float(e), f.cpu().double()


def _held(e, f, e_ref, f_ref):
    return (abs(e - e_ref) <= 1e-4 * abs(e_ref)
            and float((f - f_ref).abs().max())
            <= 1e-4 * float(f_ref.abs().max()))


def test_float32_plain_twin_misses_one_side():
    """The float32 plain twin, deciding by float32 r^2 alone, disagrees with
    the float64 twin on one of the two sides of every pair: the cases the
    card holds the kernels to are ones a float32 test cannot pass."""
    force, x, box, pairs = _water()
    for _, _, dist in pairs:
        held = []
        for side in ("in", "out"):
            r_cut = _mask_cut(dist, side)
            ref = _sweep(force, x, box, r_cut, "cpu", F64, True)
            held.append(_held(*_sweep(force, x, box, r_cut, "cpu", F32,
                                      True), *ref))
        assert sorted(held) == [False, True], (dist, held)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_host_block_ends_with_the_float64_cutoff(dtype):
    """pair_forms.cuh::make_params reads r_cut^2 in float64 from the host
    block's 15th value, after the working type's rc2 and the form's 13."""
    force, _, _, _ = _water()
    form = force._pair_form()
    scal, _ = pk._form_block(form, 0.87, dtype)
    assert len(scal) == len(form.scalars()) + 2 == 15
    assert scal[0] == pk._rc2(0.87, dtype)
    assert scal[-1] == 0.87 * 0.87


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["in", "out"])
@pytest.mark.parametrize("kernel", ["half_pair", "cell_pair"])
def test_k1_k2_cutoff_as_float64_on_card(cuda, kernel, side):
    force, x, box, pairs = _water(800 if kernel == "half_pair" else 400)
    for _, _, dist in pairs:
        r_cut = _mask_cut(dist, side)
        before = dict(pk.LAUNCHES)
        got = _sweep(force, x, box, r_cut, cuda, F32, kernel == "half_pair")
        assert pk.LAUNCHES == {**before, kernel: before[kernel] + 1}
        ref = _sweep(force, x, box, r_cut, "cpu", F64, True)
        assert _held(*got, *ref), (dist, side)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["in", "out"])
def test_k4_cutoff_as_float64_on_card(cuda, side):
    force, x, box, pairs = _water()
    spec = tblocks.make_block_spec(box, x.shape[0], 0.9, skin=0.1,
                                   exclusions=force.exclusions,
                                   occupancy_from=x, device="cpu")
    spec = dataclasses.replace(spec, **{
        f.name: getattr(spec, f.name).to(cuda)
        for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)})
    xd, bd = x.to(cuda), box.to(cuda)
    pp = {k: v.to(cuda) for k, v in force._per_particle().items()}
    order, cand, overflow = tblocks.build_block_lists(spec, xd, bd)
    assert not bool(overflow)
    form = force._pair_form()
    for _, _, dist in pairs:
        r_cut = _mask_cut(dist, side)
        before = pk.LAUNCHES["block_pair"]
        out = tblocks.block_pair_cuda(
            xd.to(F32), {k: v.to(F32) for k, v in pp.items()}, order, cand,
            spec, bd.to(F32), form, r_cut)
        torch.cuda.synchronize()
        assert pk.LAUNCHES["block_pair"] == before + 1
        ref = tblocks.block_pair_plain(xd, pp, order, cand, spec, bd, form,
                                       r_cut)
        assert _held(float(out[:, 3].double().sum()),
                     out[:-1, :3].double().cpu(), float(ref[:, 3].sum()),
                     ref[:-1, :3].cpu()), (dist, side)


# --- the tile list (K3) -----------------------------------------------------


def _water_in_box():
    """_water's system with its coordinates wrapped into [0, L) in float64
    and then rounded to float32 (held in float64), and its pairs' float64
    distances at those coordinates."""
    force, x, box, pairs = _water()
    x = (x - box * torch.floor(x / box)).to(F32).to(F64)
    assert bool(((x >= 0) & (x < box)).all())
    pairs = [(i, j, float(minimum_image(x[i] - x[j], box).norm()))
             for i, j, _ in pairs]
    return force, x, box, pairs


def _tile_sweep(force, x, box, r_cut, dev, dtype, lists={}):
    """K3 (its plain twin on the CPU) over the tile list of `force` at the
    mask cutoff r_cut, on `dev` in `dtype`: (energy, forces) in float64 on
    the CPU. The list is built once a (device, dtype) and kept in
    `lists`."""
    xd, bd = x.to(dev, dtype), box.to(dev, dtype)
    key = (str(dev), dtype)
    if key not in lists:
        spec = ttp.make_tilepair_spec(bd, x.shape[0], 0.9,
                                      exclusions=force.exclusions,
                                      occupancy_from=x, device=dev)
        lists[key] = (spec, ttp.build_tile_pairs(spec, xd, bd))
    spec, lst = lists[key]
    assert not bool(lst[4])
    pp = {k: v.to(dev, dtype) for k, v in force._per_particle().items()}
    e, f = ttp.tile_pair_energy_forces(force._pair_form(), xd, bd, pp, spec,
                                       *lst[:4], r_cut)
    return float(e), f.cpu().double()


def test_k3_twin_at_the_cutoff_matches_jax_tile_sweep():
    """A pair 5e-8 nm inside and outside the cutoff: K3's float64 twin
    against the JAX package's tile sweep, energy 1e-10 and forces
    1e-9 x max|F|; the pair's own force parts the two sides by more than
    1e-4 x max|F|."""
    import jax.numpy as jnp

    from atomsmm_tpu import models as jmodels
    from atomsmm_tpu.ops import tilepair as jtp

    force, x, box, pairs = _water_in_box()
    js, _, _ = jmodels.water_system(n_molecules=400, r_cut=0.9,
                                    r_switch=0.8, method="cutoff", seed=5)
    jf = js.forces[0]
    jx, jb = jnp.asarray(x.numpy()), jnp.asarray(box.numpy())
    jspec = jtp.make_tilepair_spec(box.numpy(), x.shape[0], 0.9,
                                   exclusions=np.asarray(jf.exclusions),
                                   occupancy_from=x.numpy())
    jlist = jtp.build_tile_pairs(jspec, jx, jb)
    for _, _, dist in pairs[:2]:
        got = {}
        for side, r_cut in (("in", dist + 5e-8), ("out", dist - 5e-8)):
            je, jfor = jtp.tile_pair_energy_forces(
                jf._pair_fn({}), jx, jb, jf._per_particle({}), jspec,
                *jlist[:4], r_cut)
            te, tfor = _tile_sweep(force, x, box, r_cut, "cpu", F64)
            jfor = np.asarray(jfor)
            assert te == pytest.approx(float(je), rel=1e-10)
            np.testing.assert_allclose(tfor.numpy(), jfor, rtol=0,
                                       atol=1e-9 * np.abs(jfor).max())
            got[side] = (te, tfor)
        assert not _held(*got["in"], *got["out"])


def test_float32_k3_twin_misses_one_side():
    """K3's float32 plain twin, deciding by float32 r^2 alone, disagrees
    with its float64 twin on one side of every pair."""
    force, x, box, pairs = _water_in_box()
    for _, _, dist in pairs:
        held = []
        for side in ("in", "out"):
            r_cut = _mask_cut(dist, side)
            ref = _tile_sweep(force, x, box, r_cut, "cpu", F64)
            held.append(_held(*_tile_sweep(force, x, box, r_cut, "cpu",
                                           F32), *ref))
        assert sorted(held) == [False, True], (dist, held)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["in", "out"])
def test_k3_cutoff_as_float64_on_card(cuda, side):
    force, x, box, pairs = _water_in_box()
    for _, _, dist in pairs:
        r_cut = _mask_cut(dist, side)
        before = pk.LAUNCHES["tile_pair"]
        got = _tile_sweep(force, x, box, r_cut, cuda, F32)
        assert pk.LAUNCHES["tile_pair"] == before + 1
        ref = _tile_sweep(force, x, box, r_cut, "cpu", F64)
        assert _held(*got, *ref), (dist, side)
