"""The port's CUDA cell-pair kernel against its plain PyTorch twin, on the
card. Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one; the file imports no JAX, so it runs on a machine that has
only PyTorch:  pytest tests/test_torch_kernel.py -m cuda -q

Tolerances: float64 kernel vs float64 plain at energy rtol 1e-10 and force
atol 1e-9 x max|F| (same arithmetic, other summation order); float32 kernel
vs the float64 plain sweep on the same f32 inputs at energy rtol 1e-4 and
force atol 1e-4 x max|F| (f32 cancellation in full - near at short range,
rsqrt rounding, summation order).
"""
import dataclasses

import pytest
import torch

import atomsmm_tpu_torch as amm
from atomsmm_tpu_torch.models import argon_system, water_system
from atomsmm_tpu_torch.ops import neighbors as nb
from atomsmm_tpu_torch.ops import pair_kernel as pk

F64 = torch.float64
TOLS = {"float64": (1e-10, 1e-9), "float32": (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(name):
    """(force, spec, x, box) on the CPU in float64."""
    if name == "argon_lj":
        s, x, box = argon_system(n=864, jitter=0.1, seed=7, neighbors=True,
                                 dtype=F64)
        return s.forces[0], s.neighbors, x, box
    s, x, box = water_system(n_molecules=400, r_cut=0.7, r_switch=0.6, seed=5,
                             neighbors=True, dtype=F64)
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
            "excbits")})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case", ["argon_lj", "water_far", "water_near",
                                  "water_rf"])
def test_kernel_matches_plain_on_card(cuda, case, dtype):
    force, spec, x, box = _case(case)
    dt = getattr(torch, dtype)
    spec = _to(spec, cuda)
    form = force._pair_form()
    pp = {k: v.to(cuda, dt) for k, v in force._per_particle().items()}
    x, box = x.to(cuda, dt), box.to(cuda, dt)
    bucket, overflow = nb.build_cell_buckets(spec, x, box)
    assert not bool(overflow)
    before = pk.LAUNCHES
    e_k, f_k = nb.cell_pair_energy_forces(form, x, box, pp, spec, bucket,
                                          form.r_cut)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + 1
    e_p, fb_p = nb._cell_pair_sums_half(
        spec, form, x.double(), box.double(),
        {k: v.double() for k, v in pp.items()}, bucket, form.r_cut, True)
    f_p = nb._scatter_forces(fb_p, bucket, x.shape[0])
    rtol, ftol = TOLS[dtype]
    assert abs(float(e_k) - float(e_p)) <= rtol * abs(float(e_p))
    assert float((f_k.double() - f_p).abs().max()) \
        <= ftol * float(f_p.abs().max())


@pytest.mark.cuda
def test_energy_only_path_runs_the_kernel(cuda):
    force, spec, x, box = _case("water_far")
    spec = _to(spec, cuda)
    form = force._pair_form()
    pp = {k: v.to(cuda, torch.float32) for k, v in force._per_particle().items()}
    x, box = x.to(cuda, torch.float32), box.to(cuda, torch.float32)
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    before = pk.LAUNCHES
    e = nb.cell_pair_energy(form, x, box, pp, spec, bucket, form.r_cut)
    e_f, _ = nb.cell_pair_energy_forces(form, x, box, pp, spec, bucket,
                                        form.r_cut)
    assert pk.LAUNCHES == before + 2
    assert float(e) == float(e_f)


@pytest.mark.cuda
def test_unported_configurations_raise_on_card(cuda):
    force, spec, x, box = _case("water_near")
    form = force._pair_form()
    pp = {k: v.to(cuda) for k, v in force._per_particle().items()}
    x, box = x.to(cuda), box.to(cuda)
    for broken in (dataclasses.replace(_to(spec, cuda), excbits=None),
                   dataclasses.replace(_to(spec, cuda), half_stencil=False)):
        bucket, _ = nb.build_cell_buckets(broken, x, box)
        with pytest.raises(nb.KernelNotPortedError):
            nb.cell_pair_energy_forces(form, x, box, pp, broken, bucket,
                                       form.r_cut)
