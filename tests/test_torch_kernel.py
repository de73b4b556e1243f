"""The port's CUDA kernels against their plain PyTorch twins, on the card:
K1 (csrc/half_pair.cu, both exclusion forms, cells above 256 atoms,
through the sweep and per atom through its own interface), K2
(csrc/cell_pair.cu, the same two ways, including a capacity above 1,024, a
bucket far wider than its cells, bit-equal rows from run to run and the
bucket layout it relies on) and K3
(csrc/tile_pair.cu, at 32, 64 and 128 atoms a block, and on a shuffled list
with dead entries and half-empty entries), each in the reaction-field forms
and in the damped PME forms (Ewald direct space, damped near, fused damped
far), on the emim/BF4 ionic liquid (exclusions up to three bonds, 7
partners an atom: K1 at 400 ion pairs on both grids, K2 at 24), and on
phenol in water (BASELINE config 3) in the softcore form and its lambda
derivative at lambda 0, 0.5 and 1 (K1 at 1,000 waters, K2 at 200, also
with the solute pushed into the solvent as at small lambda) and in the
damped-smoothed form; and the virial flag (each pair's -2 r^2 du/dr^2 in
the energy column) in every form on K1, K2 and K3, its summed column held
to the tolerance of sum |w_i|; and K1's and K2's float32 energies at
BASELINE config 5's near and far grids equal to the float32 twin's (the
kernels are built without FMA contraction). Every test
here needs an NVIDIA GPU (marker ``cuda``) and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch:
    pytest tests/test_torch_kernel.py -m cuda -q

Tolerances: float64 kernel vs float64 plain at energy rtol 1e-10 and force
atol 1e-9 x max|F| (same arithmetic, other summation order); float32 kernel
vs the float64 plain sweep on the same f32 inputs at energy rtol 1e-4 and
force atol 1e-4 x max|F| (f32 cancellation in full - near at short range,
rsqrt rounding, summation order).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import atomsmm_tpu_torch as amm
from atomsmm_tpu_torch.models import (
    argon_system,
    ionic_liquid_system,
    phenol_in_water,
    water_system,
)
from atomsmm_tpu_torch.ops import neighbors as nb
from atomsmm_tpu_torch.ops import pair_kernel as pk
from atomsmm_tpu_torch.ops import pairfuncs as pf
from atomsmm_tpu_torch.ops import tilepair as tp

F64 = torch.float64
TOLS = {"float64": (1e-10, 1e-9), "float32": (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(name):
    """(force, spec, x, box) on the CPU in float64; a 'pme_' prefix builds
    the same system with PME (the damped forms)."""
    method = "cutoff"
    if name.startswith("pme_"):
        method, name = "pme", name[4:]
    if name.startswith("small_"):   # full stencil (K2): water at 0.9 nm
        m = int(name.split("_")[1])
        s, x, box = water_system(n_molecules=m, seed=5, neighbors=True,
                                 dtype=F64, method=method, device="cpu")
        if name.endswith("far"):
            r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
            return r.forces[2], r.neighbors, x, box
        return s.forces[0], s.neighbors, x, box
    if name == "water_large":
        # cells of 243-345 atoms at capacity 400: K1's blocks exceed 256
        # threads and a candidate partition takes several 128-slot chunks
        s, x, box = water_system(n_molecules=2744, r_cut=1.4, r_switch=1.3,
                                 seed=5, neighbors=True, dtype=F64,
                                 device="cpu")
        spec = nb.retune_spec(s.neighbors, x, box)
        assert spec.half_stencil and 256 < spec.cell_capacity <= 512
        assert nb._max_cell_occupancy(x.numpy(), box.numpy(), spec.grid) > 256
        return s.forces[0], spec, x, box
    if name == "argon_lj":
        s, x, box = argon_system(n=864, jitter=0.1, seed=7, neighbors=True,
                                 dtype=F64, device="cpu")
        return s.forces[0], s.neighbors, x, box
    s, x, box = water_system(n_molecules=400, r_cut=0.7, r_switch=0.6, seed=5,
                             neighbors=True, dtype=F64, method=method,
                                 device="cpu")
    if name == "water_rf":
        return s.forces[0], s.neighbors, x, box
    r = amm.RESPASystem(s, rcut_in=0.45, rswitch_in=0.35)
    if name == "water_near":
        return r.forces[1], r.extra_neighbor_specs["near"], x, box
    return r.forces[2], r.neighbors, x, box


def _to(spec, dev):
    return dataclasses.replace(spec, **{
        k: getattr(spec, k).to(dev) for k in (
            "nbr_cells", "exclusions", "nbr_cells_half", "inv_cells_half",
            "excbits") if getattr(spec, k) is not None})


def _permuted(force, x, box, r_cut):
    """Atoms renumbered by a fixed permutation: no exclusion bitmask fits,
    so the sweeps take the exclusion id columns."""
    n = x.shape[0]
    p = np.random.RandomState(3).permutation(n)
    inv = np.argsort(p)
    exc = force.exclusions.numpy()[p]
    exc = np.where(exc >= 0, inv[np.maximum(exc, 0)], -1).astype(np.int32)
    pt = torch.as_tensor(p)
    force = dataclasses.replace(
        force, exclusions=torch.as_tensor(exc),
        **{k: v[pt] for k, v in force._per_particle().items()})
    spec = nb.make_neighbor_spec(box, n, r_cut, exclusions=exc,
                                 occupancy_floor_from=x[pt], device="cpu")
    assert spec.excbits is None
    return force, spec, x[pt]


def _check_sweep(force, spec, x, box, dev, dtype, kernel, unsplit=None,
                 form=None, terms_scale=False):
    """One sweep through the wrapper on the card, launching `kernel` once,
    against the same wrapper on the CPU (the plain twin) in float64 on the
    same inputs. With `unsplit` (the full force a fused far force was split
    from) the float32 force tolerance scales with the unsplit force's
    max|F|: the far force is the difference of two forces of that size,
    and the truncated Ewald term jumps at the float32-rounded cutoff.
    `form` replaces the force's own pair form (a lambda, the dlambda
    twin, the virial flag). Under the virial flag the summed energy column
    is held to the tolerance of sum |e_i| over the atoms (the virial, a sum
    of terms of both signs), of the unsplit form's in float32 with
    `unsplit`; so is a float32 energy with `terms_scale` (a total that
    nearly cancels)."""
    dt = getattr(torch, dtype)
    spec = _to(spec, dev)
    form = force._pair_form() if form is None else form
    pp = {k: v.to(dev, dt) for k, v in force._per_particle().items()}
    x, box = x.to(dev, dt), box.to(dev, dt)
    bucket, overflow = nb.build_cell_buckets(spec, x, box)
    assert not bool(overflow)
    before = dict(pk.LAUNCHES)
    e_k, f_k = nb.cell_pair_energy_forces(form, x, box, pp, spec, bucket,
                                          form.r_cut)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == {**before, kernel: before[kernel] + 1}
    args = (x.cpu().double(), box.cpu().double(),
            {k: v.cpu().double() for k, v in pp.items()}, _to(spec, "cpu"),
            bucket.cpu(), form.r_cut)
    e_p, f_p = nb.cell_pair_energy_forces(form, *args)
    fmax = float(f_p.abs().max())
    e_scale = abs(float(e_p))
    plain_sweep = {"half_pair": pk.half_pair_plain,
                   "cell_pair": pk.full_pair_plain}[kernel]
    xc, bc, ppc, spec_c, bucket_c, _ = args
    if form.virial or (terms_scale and dtype == "float32"):
        e_scale = float(plain_sweep(xc, ppc, bucket_c, spec_c, bc, form,
                                    form.r_cut)[:, 3].abs().sum())
    if unsplit is not None and dtype == "float32":
        uform = unsplit._pair_form()
        if form.virial:
            uform = pf.virial_form(uform)
        fmax = float(nb.cell_pair_energy_forces(uform, *args)[1].abs().max())
        if form.virial:
            e_scale = float(plain_sweep(xc, ppc, bucket_c, spec_c, bc, uform,
                                        form.r_cut)[:, 3].abs().sum())
    rtol, ftol = TOLS[dtype]
    assert abs(float(e_k) - float(e_p)) <= rtol * e_scale
    assert float((f_k.cpu().double() - f_p).abs().max()) <= ftol * fmax
    # the kernel's own interface: per-atom [fx fy fz e] against the twin's,
    # each atom's energy to the tolerance of the largest
    cuda_fn, plain_fn = {
        "half_pair": (pk.half_pair_cuda, pk.half_pair_plain),
        "cell_pair": (pk.full_pair_cuda, pk.full_pair_plain)}[kernel]
    out_k = cuda_fn(x, pp, bucket, spec, box, form, form.r_cut)
    out_p = plain_fn(xc, ppc, bucket_c, spec_c, bc, form, form.r_cut)
    assert out_k.shape == out_p.shape == (x.shape[0] + 1, 4)
    assert float(out_k[-1].abs().max()) == 0.0
    e_max = float(out_p[:, 3].abs().max())
    assert float((out_k[:, 3].cpu().double() - out_p[:, 3]).abs().max()) \
        <= ftol * e_max
    assert float((out_k[:, :3].cpu().double() - out_p[:, :3]).abs()
                 .max()) <= ftol * fmax


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case", ["argon_lj", "water_far", "water_near",
                                  "water_rf", "water_large"])
def test_kernel_matches_plain_on_card(cuda, case, dtype):
    force, spec, x, box = _case(case)
    _check_sweep(force, spec, x, box, cuda, dtype, "half_pair")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case", ["small_400", "small_400_far", "small_700"])
def test_full_stencil_kernel_matches_plain_on_card(cuda, case, dtype):
    force, spec, x, box = _case(case)
    assert not spec.half_stencil
    _check_sweep(force, spec, x, box, cuda, dtype, "cell_pair")


@pytest.mark.cuda
def test_full_stencil_kernel_capacity_above_1024(cuda):
    """Water 216 at 0.9 nm: one cell of 1,112 slots (float64; the float32
    total of this lattice is a near-cancellation, so only float64 is held
    to an energy rtol)."""
    force, spec, x, box = _case("small_216")
    assert spec.grid == (1, 1, 1) and spec.cell_capacity > 1024
    _check_sweep(force, spec, x, box, cuda, "float64", "cell_pair")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
def test_full_stencil_kernel_bucket_far_wider_than_its_cells(cuda, dtype):
    """Three times the capacity the cells need: K2 walks the real atoms
    only, and its rows match the twin's."""
    force, spec, x, box = _case("small_400_far")
    wide = dataclasses.replace(spec, cell_capacity=3 * spec.cell_capacity)
    _check_sweep(force, wide, x, box, cuda, dtype, "cell_pair")


@pytest.mark.cuda
def test_full_stencil_kernel_needs_real_ids_first_in_each_bucket_row(cuda):
    """K2's layout contract: a bucket row holds its real ids first, in any
    order, and the sentinel after them. Rows whose real ids are shuffled
    among themselves give the twin's rows; a row turned round (sentinels
    first) does not, because K2 stops at a row's first sentinel, while the
    twin takes any layout."""
    force, spec, x, box = _case("small_400_far")
    n = x.shape[0]
    form, pp = force._pair_form(), force._per_particle()
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    real = bucket < n
    assert bool(real.any(dim=1).all()) and not bool(real.all(dim=1).any())
    assert bool((real[:, 1:] <= real[:, :-1]).all())   # real ids first
    rng = np.random.RandomState(11)
    shuffled = bucket.clone()
    for c in range(bucket.shape[0]):
        k = int(real[c].sum())
        shuffled[c, :k] = bucket[c, torch.as_tensor(rng.permutation(k))]
    turned = bucket.flip(1).contiguous()

    def rows(bk):
        want = pk.full_pair_plain(x, pp, bk, spec, box, form, form.r_cut)
        got = pk.full_pair_cuda(
            x.to(cuda), {k: v.to(cuda) for k, v in pp.items()}, bk.to(cuda),
            _to(spec, cuda), box.to(cuda), form, form.r_cut)
        return want, got.cpu()

    want, got = rows(shuffled)
    fmax = float(want[:, :3].abs().max())
    assert float((got - want)[:, :3].abs().max()) <= 1e-9 * fmax
    want_t, got_t = rows(turned)
    assert float((want_t - want)[:, :3].abs().max()) <= 1e-9 * fmax
    # wrong by far, or not a number: what K2 reads behind a sentinel is
    # whatever its shared memory held (no read leaves the inputs)
    assert not float((got_t - want_t)[:, :3].abs().max()) <= 1e-3 * fmax


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small_216", "small_700"])
def test_full_stencil_kernel_rows_are_bit_equal_between_runs(cuda, case):
    """K2 has no atomics and sums in a fixed order: float32 rows of two
    launches on the same input are equal bit for bit."""
    force, spec, x, box = _case(case)
    spec = _to(spec, cuda)
    form = force._pair_form()
    pp = {k: v.to(cuda, torch.float32)
          for k, v in force._per_particle().items()}
    x, box = x.to(cuda, torch.float32), box.to(cuda, torch.float32)
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    a = pk.full_pair_cuda(x, pp, bucket, spec, box, form, form.r_cut)
    b = pk.full_pair_cuda(x, pp, bucket, spec, box, form, form.r_cut)
    torch.cuda.synchronize()
    assert float(a[:, :3].abs().max()) > 0.0
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("r_cut", [0.7, 0.9])
def test_exclusion_column_forms_match_plain_on_card(cuda, r_cut):
    """0.7 nm: K1's column form; 0.9 nm: K2's."""
    s, x, box = water_system(n_molecules=400, r_cut=r_cut,
                             r_switch=r_cut - 0.1, seed=5, dtype=F64,
                                 device="cpu")
    force, spec, xp = _permuted(s.forces[0], x, box, r_cut)
    kernel = "half_pair" if spec.half_stencil else "cell_pair"
    _check_sweep(force, spec, xp, box, cuda, "float64", kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case,kernel", [
    ("pme_water_rf", "half_pair"), ("pme_water_near", "half_pair"),
    ("pme_water_far", "half_pair"), ("pme_small_400", "cell_pair"),
    ("pme_small_400_far", "cell_pair")])
def test_damped_forms_match_plain_on_card(cuda, case, kernel, dtype):
    """K1 and K2 in the Ewald direct-space form (the full PME force), the
    damped near form and the fused damped far form."""
    force, spec, x, box = _case(case)
    assert force._pair_form().alpha > 0.0
    unsplit = {"pme_water_far": "pme_water_rf",
               "pme_small_400_far": "pme_small_400"}.get(case)
    _check_sweep(force, spec, x, box, cuda, dtype, kernel,
                 unsplit and _case(unsplit)[0])


def _ionic_case(name):
    """(force, spec, x, box, unsplit full force) of the emim/BF4 liquid
    under PME, float64 on the CPU: 400 ion pairs at the equilibrated state
    of bench_data/eq_emim.npz split at 0.7 nm (both grids half stencil), or
    24 pairs at the minimized state of the emim_bf4_24 golden (far grid 2^3:
    full stencil)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    size, which = name.split("_")
    if size == "400":
        s, _, box = ionic_liquid_system(n_pairs=400, neighbors=True,
                                        dtype=F64, device="cpu")
        x = np.load(os.path.join(root, "bench_data", "eq_emim.npz"))["x"]
        r = amm.RESPASystem(s, rcut_in=0.7, rswitch_in=0.6)
    else:
        s, _, box = ionic_liquid_system(n_pairs=24, r_cut=0.65, r_switch=0.55,
                                        neighbors=True, dtype=F64,
                                        device="cpu")
        x = np.load(os.path.join(root, "tests", "data",
                                 "emim_bf4_24_minimized.npz"))["x"]
        r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    # the stored arrays are in column order; the kernels take row-major
    x = torch.as_tensor(np.ascontiguousarray(x), dtype=F64)
    r = nb.retune_neighbor_specs(r, x, box)
    full = s.forces[0]
    near, far = (f for f in r.forces if f.name.endswith("rNonbondedForce"))
    if which == "near":
        return near, r.extra_neighbor_specs["near"], x, box, None
    if which == "far":
        return far, r.neighbors, x, box, full
    return full, r.neighbors, x, box, None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case,kernel", [
    ("400_near", "half_pair"), ("400_far", "half_pair"),
    ("400_full", "half_pair"), ("24_far", "cell_pair"),
    ("24_full", "cell_pair"), ("24_near", "half_pair")])
def test_ionic_liquid_sweeps_match_plain_on_card(cuda, case, kernel, dtype):
    """The damped forms on a charged multi-species liquid whose exclusions
    reach three bonds (bitmask offsets up to +-7)."""
    force, spec, x, box, unsplit = _ionic_case(case)
    assert spec.excbits is not None and force.exclusions.shape[1] == 7
    assert spec.half_stencil == (kernel == "half_pair")
    _check_sweep(force, spec, x, box, cuda, dtype, kernel, unsplit)


def _phenol_case(name):
    """(SolvationSystem, spec, x, box) of phenol in water, float64 on the
    CPU: '1000' waters at 0.75 nm (2,941 atoms, a 3^3 grid with half maps:
    K1) or '200' (541 atoms, a 2^3 grid: K2); an '_overlap' suffix moves
    the solute 0.15 nm into the solvent, so that waters sit inside its
    sigma as they do at small lambda."""
    n_water, *overlap = name.split("_")
    s, x, box, solute = phenol_in_water(n_water=int(n_water), neighbors=True,
                                        dtype=F64, device="cpu")
    if overlap:
        x = x.clone()
        x[:13] += torch.tensor([0.12, 0.08, 0.05], dtype=F64)
    solv = amm.SolvationSystem(s, solute)
    return solv, nb.retune_spec(solv.neighbors, x, box), x, box


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("dlambda", [False, True])
@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("case,kernel", [
    ("1000", "half_pair"), ("200", "cell_pair"), ("200_overlap", "cell_pair")])
def test_softcore_forms_match_plain_on_card(cuda, case, kernel, lam, dlambda,
                                            dtype):
    """The softcore form (the solute indicator as +-1 in the charge column)
    and its dlambda twin (energy column only, zero force)."""
    solv, spec, x, box = _phenol_case(case)
    assert spec.half_stencil == (kernel == "half_pair")
    soft, = (f for f in solv.forces
             if isinstance(f, amm.SoftcoreLennardJonesForce))
    _check_sweep(soft, spec, x, box, cuda, dtype, kernel,
                 form=soft._pair_form({"lambda_vdw": lam}, dlambda=dlambda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case,kernel", [("1000", "half_pair"),
                                         ("200", "cell_pair")])
def test_damped_smoothed_and_scaled_forms_match_plain_on_card(cuda, case,
                                                             kernel, dtype):
    """The damped-smoothed form, and the reaction-field form at
    lambda_coul = 0.5 (the solute's charges halved)."""
    solv, spec, x, box = _phenol_case(case)
    full = solv.forces[0]
    ds = amm.DampedSmoothedForce(charge=full.charge, sigma=full.sigma,
                                 epsilon=full.epsilon,
                                 exclusions=full.exclusions, r_cut=0.75,
                                 r_switch=0.65, alpha=3.0)
    _check_sweep(ds, spec, x, box, cuda, dtype, kernel)
    half = dataclasses.replace(full, charge=full._effective_charge(
        {"lambda_coul": 0.5}), charge_scale_mask=None)
    _check_sweep(half, spec, x, box, cuda, dtype, kernel)


VIRIAL_CASES = [
    ("water_rf", "half_pair"), ("water_near", "half_pair"),
    ("water_far", "half_pair"), ("pme_water_rf", "half_pair"),
    ("pme_water_near", "half_pair"), ("pme_water_far", "half_pair"),
    ("small_400", "cell_pair"), ("small_400_far", "cell_pair"),
    ("pme_small_400", "cell_pair"), ("pme_small_400_far", "cell_pair")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case,kernel", VIRIAL_CASES)
def test_virial_forms_match_plain_on_card(cuda, case, kernel, dtype):
    """The virial flag (each pair's -2 r^2 du/dr^2 in the energy column,
    the forces unchanged) on K1 and K2 in the reaction-field, near, fused
    far and damped PME forms."""
    force, spec, x, box = _case(case)
    unsplit = {"water_far": "water_rf", "pme_water_far": "pme_water_rf",
               "small_400_far": "small_400",
               "pme_small_400_far": "pme_small_400"}.get(case)
    _check_sweep(force, spec, x, box, cuda, dtype, kernel,
                 unsplit and _case(unsplit)[0],
                 form=pf.virial_form(force._pair_form()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case,kernel", [("1000", "half_pair"),
                                         ("200", "cell_pair")])
def test_virial_softcore_and_smoothed_forms_on_card(cuda, case, kernel,
                                                   dtype):
    """The virial flag on the softcore form at lambda 0.5 and on the
    damped-smoothed form (phenol in water)."""
    solv, spec, x, box = _phenol_case(case)
    soft, = (f for f in solv.forces
             if isinstance(f, amm.SoftcoreLennardJonesForce))
    _check_sweep(soft, spec, x, box, cuda, dtype, kernel,
                 form=pf.virial_form(soft._pair_form({"lambda_vdw": 0.5})))
    full = solv.forces[0]
    ds = amm.DampedSmoothedForce(charge=full.charge, sigma=full.sigma,
                                 epsilon=full.epsilon,
                                 exclusions=full.exclusions, r_cut=0.75,
                                 r_switch=0.65, alpha=3.0)
    _check_sweep(ds, spec, x, box, cuda, dtype, kernel,
                 form=pf.virial_form(ds._pair_form()))


@pytest.mark.cuda
def test_kernels_refuse_virial_with_dlambda(cuda):
    """A flag block with both dlambda and virial set is refused at launch
    (the PairForm refuses it on the host first)."""
    solv, spec, x, box = _phenol_case("200")
    soft, = (f for f in solv.forces
             if isinstance(f, amm.SoftcoreLennardJonesForce))
    form = soft._pair_form({"lambda_vdw": 0.5}, dlambda=True)
    both = dataclasses.replace(form, dlambda=False, virial=True)
    object.__setattr__(both, "dlambda", True)
    spec = _to(spec, cuda)
    pp = {k: v.to(cuda) for k, v in soft._per_particle().items()}
    x, box = x.to(cuda), box.to(cuda)
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    with pytest.raises(RuntimeError, match="launch failed"):
        pk.full_pair_cuda(x, pp, bucket, spec, box, both, both.r_cut)


def _check_tile(force, x, box, dev, dtype, unsplit=None, block_size=64,
                shuffle=False, form=None):
    """K3 on the tile list of `force` against its plain twin; in float64
    also against K1 on the same configuration (the same pairs inside the
    cutoff). `unsplit` as in _check_sweep. The list always has dead entries
    (its unused tail) and entries whose second candidate block is the
    sentinel (home blocks with an odd number of partners); with `shuffle`
    its entries are permuted, so that dead entries lie among live ones.
    `form` replaces the force's own pair form; under the virial flag the
    energy is held to the tolerance of sum |e_i| over the atoms."""
    dt = getattr(torch, dtype)
    form = force._pair_form() if form is None else form
    pp = force._per_particle()
    spec = tp.make_tilepair_spec(box, x.shape[0], form.r_cut,
                                 exclusions=force.exclusions,
                                 block_size=block_size,
                                 occupancy_from=x, device=dev)
    xd, bd = x.to(dev, dt), box.to(dev, dt)
    ppd = {k: v.to(dev, dt) for k, v in pp.items()}
    order, hb, cb, wrap, overflow = tp.build_tile_pairs(spec, xd, bd)
    assert not bool(overflow)
    live = hb < spec.n_blocks
    assert bool((~live).any())
    assert bool((live & (cb[:, 1] == spec.n_blocks)).any())
    if shuffle:
        perm = torch.as_tensor(
            np.random.RandomState(5).permutation(hb.shape[0]), device=dev)
        hb, cb, wrap = (t[perm].contiguous() for t in (hb, cb, wrap))
    before = pk.LAUNCHES["tile_pair"]
    e_k, f_k = tp.tile_pair_energy_forces(form, xd, bd, ppd, spec, order, hb,
                                          cb, wrap, form.r_cut)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["tile_pair"] == before + 1
    fs, ms = tp._stage(spec, xd.double(), bd.double(),
                       {k: v.double() for k, v in ppd.items()}, spec.excbits,
                       order)

    def plain(form):
        acc = tp.tile_pair_plain(fs, ms, hb, cb, wrap, bd.double(), form,
                                 form.r_cut)
        f = torch.zeros((x.shape[0] + 1, 3), dtype=F64, device=dev)
        f = f.index_add_(0, order.long(),
                         acc[:spec.n_blocks, :, :3].reshape(-1, 3))[:-1]
        return acc[:spec.n_blocks, :, 3].sum(), f

    e_p, f_p = plain(form)
    rtol, ftol = TOLS[dtype]
    fmax = float(f_p.abs().max())
    if unsplit is not None and dtype == "float32":
        fmax = float(plain(unsplit._pair_form())[1].abs().max())
    e_scale = abs(float(e_p))
    if form.virial:  # a sum of terms of both signs: sum |w_i| of the atoms
        acc = tp.tile_pair_plain(fs, ms, hb, cb, wrap, bd.double(), form,
                                 form.r_cut)
        e_scale = float(acc[:spec.n_blocks, :, 3].abs().sum())
    assert abs(float(e_k) - float(e_p)) <= rtol * e_scale
    assert float((f_k.double() - f_p).abs().max()) <= ftol * fmax
    if dtype == "float64":
        cspec = _to(nb.make_neighbor_spec(box, x.shape[0], form.r_cut,
                                          exclusions=force.exclusions,
                                          occupancy_floor_from=x,
                                              device="cpu"), dev)
        bucket, _ = nb.build_cell_buckets(cspec, xd, bd)
        e_c, f_c = nb.cell_pair_energy_forces(form, xd, bd, ppd, cspec,
                                              bucket, form.r_cut)
        assert abs(float(e_k) - float(e_c)) <= rtol * (
            e_scale if form.virial else abs(float(e_c)))
        assert float((f_k - f_c).abs().max()) <= ftol * fmax


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
def test_tile_pair_kernel_matches_plain_and_cells_on_card(cuda, dtype):
    """K3 against its plain twin; in float64 also against K1 on the same
    configuration (the same pairs inside the cutoff)."""
    s, x, box = water_system(n_molecules=1000, r_cut=0.9, r_switch=0.8,
                             dtype=F64, device="cpu")
    _check_tile(s.forces[0], x, box, cuda, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("block_size", [32, 48, 128])
def test_tile_pair_kernel_block_sizes_on_card(cuda, block_size, dtype):
    """K3 at 32 and 128 atoms a block (one warp and four, two and eight
    candidate groups) and at 48 (a ragged last warp and group), on a
    shuffled list."""
    s, x, box = water_system(n_molecules=1000, r_cut=0.9, r_switch=0.8,
                             dtype=F64, device="cpu")
    _check_tile(s.forces[0], x, box, cuda, dtype, block_size=block_size,
                shuffle=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("group", ["full", "near", "far"])
def test_tile_pair_damped_forms_on_card(cuda, group, dtype):
    """K3 in the damped PME forms, water 1000 at 0.9 nm split at 0.5 nm."""
    s, x, box = water_system(n_molecules=1000, method="pme", dtype=F64,
                             device="cpu")
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    force = {"full": s.forces[0], "near": r.forces[1], "far": r.forces[2]}[
        group]
    _check_tile(force, x, box, cuda, dtype,
                s.forces[0] if group == "far" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
def test_tile_pair_virial_form_on_card(cuda, dtype):
    """K3 with the virial flag (the fused damped far form) against its
    plain twin, and in float64 against K1."""
    s, x, box = water_system(n_molecules=1000, method="pme", dtype=F64,
                             device="cpu")
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    _check_tile(r.forces[2], x, box, cuda, dtype, s.forces[0],
                form=pf.virial_form(r.forces[2]._pair_form()))


@pytest.mark.cuda
def test_energy_only_path_runs_the_kernel(cuda):
    force, spec, x, box = _case("water_far")
    spec = _to(spec, cuda)
    form = force._pair_form()
    pp = {k: v.to(cuda, torch.float32) for k, v in force._per_particle().items()}
    x, box = x.to(cuda, torch.float32), box.to(cuda, torch.float32)
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    before = pk.LAUNCHES["half_pair"]
    e = nb.cell_pair_energy(form, x, box, pp, spec, bucket, form.r_cut)
    e_f, _ = nb.cell_pair_energy_forces(form, x, box, pp, spec, bucket,
                                        form.r_cut)
    assert pk.LAUNCHES["half_pair"] == before + 2
    assert float(e) == float(e_f)


@pytest.mark.cuda
def test_former_unported_configurations_launch_on_card(cuda):
    """A spec without the exclusion bitmask launches K1's column form, and
    a spec without half maps launches K2: neither raises on the card."""
    force, spec, x, box = _case("water_near")
    form = force._pair_form()
    pp = {k: v.to(cuda) for k, v in force._per_particle().items()}
    x, box = x.to(cuda), box.to(cuda)
    for broken, kernel in (
            (dataclasses.replace(_to(spec, cuda), excbits=None), "half_pair"),
            (dataclasses.replace(_to(spec, cuda), half_stencil=False),
             "cell_pair")):
        bucket, _ = nb.build_cell_buckets(broken, x, box)
        before = pk.LAUNCHES[kernel]
        e, f = nb.cell_pair_energy_forces(form, x, box, pp, broken, bucket,
                                          form.r_cut)
        torch.cuda.synchronize()
        assert pk.LAUNCHES[kernel] == before + 1
        assert bool(torch.isfinite(f).all()) and bool(torch.isfinite(e))


@pytest.mark.cuda
def test_small_box_water_steps_on_card(cuda):
    """water_system(n_molecules=400) at its default cutoff steps on the
    card through Context: K2 for the far force, K1 for the near force."""
    s, x, box = water_system(n_molecules=400, neighbors=True,
                             dtype=torch.float32, device=cuda)
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    integ = amm.MultipleTimeScaleIntegrator(
        0.002, [4, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * s.num_particles - 3)
    ctx = amm.Context(r, integ, amm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=1)
    before = dict(pk.LAUNCHES)
    ctx.step(3)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["cell_pair"] > before["cell_pair"]
    assert pk.LAUNCHES["half_pair"] > before["half_pair"]
    assert bool(torch.isfinite(ctx.state.x).all())


@pytest.fixture(scope="module")
def config5_grids():
    """BASELINE config 5's near and far forms and specs on the card, in
    float32: 33,334 q-SPC/Fw waters at the state of
    bench_data/eq_water100k.npz, RESPASystem(0.6, 0.5), capacities retuned
    there (chip_smoke.py::npt_water without the barostat)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev, f32 = torch.device("cuda"), torch.float32
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    eq = np.load(os.path.join(root, "bench_data", "eq_water100k.npz"))
    s, _, _ = water_system(n_molecules=33334, neighbors=True, dtype=f32,
                           device=dev)
    r = nb.retune_neighbor_specs(
        amm.RESPASystem(s, rcut_in=0.6, rswitch_in=0.5), eq["x"], eq["box"])
    near, = (f for f in r.forces if f.name == "NearNonbondedForce")
    far, = (f for f in r.forces if f.name == "FarNonbondedForce")
    x = torch.as_tensor(eq["x"], dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(eq["box"], dtype=f32, device=dev)
    return {"near": (near, r.extra_neighbor_specs["near"]),
            "far": (far, r.neighbors)}, x, box


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["half_pair", "cell_pair"])
@pytest.mark.parametrize("group", ["near", "far"])
def test_float32_energy_rounds_as_the_plain_twin(config5_grids, group,
                                                  kernel):
    """K1 and K2 (the full stencil on the same grid) in float32 give the
    near and the fused far energy of config 5 that the float32 plain twin
    gives, to 1e-7 of |E|: the kernels are built without FMA contraction
    (_build.NVCC_FLAGS), so each pair rounds as the twin's line does.
    Contracted, both kernels erred by -5.15 (near) and +5.21 kJ/mol (far)
    against the float64 twin, 3.8e-6 and 2.3e-5 of |E|, where the float32
    twin errs by +0.47 and -0.48 (k1_ab/rf_bias_variants.py)."""
    forces, x, box = config5_grids
    force, spec = forces[group]
    form = force._pair_form()
    pp = {k: v.to(x.device, torch.float32)
          for k, v in force._per_particle().items()}
    bucket, overflow = nb.build_cell_buckets(spec, x, box)
    assert not bool(overflow)
    run = {"half_pair": pk.half_pair_cuda, "cell_pair": pk.full_pair_cuda}[
        kernel]
    e_k = float(run(x, pp, bucket, spec, box, form, form.r_cut)[:, 3]
                .double().sum())
    e_twin = float(pk.half_pair_plain(x, pp, bucket, spec, box, form,
                                      form.r_cut, with_forces=False)[:, 3]
                   .double().sum())
    assert abs(e_k - e_twin) <= 1e-7 * abs(e_twin)


# --- NBFIX type-pair tables and the 10-12 term (the Amber slice) -----------

# q-SPC/Fw water with an LJ site on H and the O-H row of the LJ table off
# Lorentz-Berthelot (an NBFIX row); with hbond, the O-H slot also carries
# the legacy 10-12 term at tests/test_amber.py's A = 7500 kcal A^12 and
# B = 2300 kcal A^10 (in kJ/mol nm^12 and nm^10 here)
TABLE_SIGMA = np.array([[0.3165492, 0.2], [0.2, 0.1]])
TABLE_EPSILON = np.array([[0.650299, 0.2092], [0.2092, 0.04184]])
A1012, B1012 = 7500 * 4.184e-12, 2300 * 4.184e-10


def _tabled(force, hbond):
    """`force` (a NonbondedForce, NearNonbondedForce or FarNonbondedForce
    of a water system) with the O/H type-pair tables; with `hbond` the
    full force carries the 10-12 term on the O-H pair."""
    if force.name == "FarNonbondedForce":
        return dataclasses.replace(
            force, full=_tabled(force.full, hbond),
            minus_near=_tabled(force.minus_near, hbond))
    n = force.charge.shape[0]
    dt = force.charge.dtype
    tabs = {"lj_type": torch.as_tensor(np.tile([0, 1, 1], n // 3),
                                       dtype=torch.int32),
            "pair_sigma": torch.as_tensor(TABLE_SIGMA, dtype=dt),
            "pair_epsilon": torch.as_tensor(TABLE_EPSILON, dtype=dt)}
    if hbond and force.name == "NonbondedForce":
        hb = np.array([[0.0, 1.0], [1.0, 0.0]])
        tabs.update(pair_a1012=torch.as_tensor(A1012 * hb, dtype=dt),
                    pair_b1012=torch.as_tensor(B1012 * hb, dtype=dt))
    return dataclasses.replace(force, **tabs)


def _sheared(force, spec, x, box):
    """The same water mapped into a sheared (3, 3) cell of the same
    edges (beta 100 degrees), with a spec built for the cell."""
    from atomsmm_tpu_torch.ops.pbc import triclinic_from_lengths_angles

    lengths = [float(b) for b in box]
    h = triclinic_from_lengths_angles(*lengths, 90.0, 100.0, 90.0)
    xs = (x.numpy() / np.array(lengths)) @ h
    n = x.shape[0]
    r_cut = force._pair_form().r_cut
    spec = nb.make_neighbor_spec(h, n, r_cut, exclusions=force.exclusions,
                                 occupancy_floor_from=xs, device="cpu")
    return spec, torch.as_tensor(xs), torch.as_tensor(h)


TABLE_CASES = [
    ("water_rf", "half_pair"), ("water_near", "half_pair"),
    ("water_far", "half_pair"), ("pme_water_rf", "half_pair"),
    ("pme_water_near", "half_pair"), ("pme_water_far", "half_pair"),
    ("tri_water_rf", "half_pair"), ("small_400", "cell_pair"),
    ("small_400_far", "cell_pair"), ("pme_small_400", "cell_pair"),
    ("pme_small_400_far", "cell_pair"), ("tri_small_400", "cell_pair")]
UNSPLIT = {"water_far": "water_rf", "pme_water_far": "pme_water_rf",
           "small_400_far": "small_400", "pme_small_400_far": "pme_small_400"}


def _table_case(case, hbond):
    """(force, spec, x, box, unsplit full force or None) of a TABLE_CASES
    entry with the type-pair tables; 'tri_' maps it into a sheared cell."""
    tri = case.startswith("tri_")
    name = case[4:] if tri else case
    force, spec, x, box = _case(name)
    force = _tabled(force, hbond)
    if tri:
        spec, x, box = _sheared(force, spec, x, box)
    unsplit = UNSPLIT.get(case)
    return force, spec, x, box, unsplit and _tabled(_case(unsplit)[0], hbond)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("virial", [False, True])
@pytest.mark.parametrize("hbond", [False, True])
@pytest.mark.parametrize("case,kernel", TABLE_CASES)
def test_table_forms_match_plain_on_card(cuda, case, kernel, hbond, virial,
                                         dtype):
    """K1 and K2 with NBFIX type-pair tables (each hit reads its pair's
    row), with and without the 10-12 term, in the reaction-field, PME,
    near, fused far and virial forms and on a (3, 3) box, one launch each,
    against the float64 plain twin. The float32 energies are held to 1e-4
    of sum |e_i|: on the lattice the 10-12 term's thousands of kJ/mol
    cancel against the rest to a total of about -140 (water_rf)."""
    force, spec, x, box, unsplit = _table_case(case, hbond)
    form = force._pair_form()
    assert form.table and form.hbond == (hbond and "near" not in case)
    assert spec.half_stencil == (kernel == "half_pair")
    _check_sweep(force, spec, x, box, cuda, dtype, kernel, unsplit,
                 pf.virial_form(form) if virial else None, terms_scale=True)


@pytest.mark.cuda
def test_table_form_refusals_on_card(cuda):
    """A table form raises where its inputs disagree, and on K3; the 10-12
    flag without a table is refused by the kernels themselves."""
    from atomsmm_tpu_torch.utils import InputError

    force, spec, x, box = _case("water_rf")
    tabled = _tabled(force, True)
    spec = _to(spec, cuda)
    x, box = x.to(cuda), box.to(cuda)
    pp = {k: v.to(cuda) for k, v in tabled._per_particle().items()}
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    lb = {k: v for k, v in pp.items() if k not in ("lj_type", "pair_table")}
    with pytest.raises(ValueError, match="table"):
        pk.half_pair_cuda(x, lb, bucket, spec, box, tabled._pair_form(), 0.7)
    with pytest.raises(ValueError, match="table"):
        pk.half_pair_cuda(x, pp, bucket, spec, box, force._pair_form(), 0.7)
    with pytest.raises(InputError, match="table"):
        tp.tile_pair_cuda(*([None] * 5), box, tabled._pair_form(), 0.7)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["half_pair", "cell_pair"])
@pytest.mark.parametrize("group", ["near", "far"])
def test_float32_table_energy_rounds_as_the_plain_twin(config5_grids, group,
                                                        kernel):
    """The table forms (with the 10-12 term in the far form) at config 5's
    near and far grids: K1's and K2's float32 energies summed in float64
    equal the float32 twin's to 1e-7 of |E|, as the Lorentz-Berthelot
    forms do (test_float32_energy_rounds_as_the_plain_twin)."""
    forces, x, box = config5_grids
    force, spec = forces[group]
    force = _tabled(force, True)
    form = force._pair_form()
    assert form.table
    pp = {k: v.to(x.device) for k, v in force._per_particle().items()}
    bucket, overflow = nb.build_cell_buckets(spec, x, box)
    assert not bool(overflow)
    run = {"half_pair": pk.half_pair_cuda, "cell_pair": pk.full_pair_cuda}[
        kernel]
    e_k = float(run(x, pp, bucket, spec, box, form, form.r_cut)[:, 3]
                .double().sum())
    e_twin = float(pk.half_pair_plain(x, pp, bucket, spec, box, form,
                                      form.r_cut, with_forces=False)[:, 3]
                   .double().sum())
    assert abs(e_k - e_twin) <= 1e-7 * abs(e_twin)
