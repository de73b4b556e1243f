"""CMAP and harmonic impropers in the port, float64 on the CPU against the
JAX package, and the card cases (marker ``cuda``).

The spline-derivative tables are host numpy in both packages and agree to
1e-14; the bicubic patch and the improper's wrapped difference are PyTorch
operations whose forces come from autograd, held against jax.grad to
1e-12 at generic angles, on grid knots, at +-pi and across the improper's
wrap. An interop round trip carries CMAP, the improper and SWM4's
DrudeForce from the JAX package.

The JAX package is imported inside the tests that compare with it, so that
the ``cuda`` cases run on a machine that has PyTorch alone:
    pytest tests/test_torch_cmap.py -m cuda -q --noconftest
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from atomsmm_tpu_torch.forces import CMAPTorsionForce, HarmonicImproperForce
from atomsmm_tpu_torch.ops.bonded import dihedral_angle, harmonic_improper_energy
from atomsmm_tpu_torch.ops.cmap import (
    build_cmap_table,
    cmap_energy,
    cmap_interpolate,
)
from atomsmm_tpu_torch.potential import force_fn
from atomsmm_tpu_torch.system import System

F64 = torch.float64
RES = 24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these cases run on the card")
    return torch.device("cuda")


def _grids(n_types=2, seed=0):
    """Random periodic surfaces: a few Fourier modes per type [kJ/mol]."""
    rs = np.random.RandomState(seed)
    ang = -np.pi + 2 * np.pi * np.arange(RES) / RES
    p, q = np.meshgrid(ang, ang, indexing="ij")
    out = []
    for _ in range(n_types):
        g = np.zeros((RES, RES))
        for a in range(3):
            for b in range(3):
                c, ph = rs.normal(0, 2.0, 2)
                g += c * np.cos(a * p + b * q + ph)
        out.append(g)
    return np.stack(out)


def _place(a, b, c, torsion, bond=0.153, angle=1.95):
    """The next chain atom after a, b, c at the given bond length, angle
    and dihedral (a, b, c, d) = torsion (NeRF construction)."""
    bc = (c - b) / np.linalg.norm(c - b)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d = np.array([-bond * math.cos(angle),
                  bond * math.sin(angle) * math.cos(torsion),
                  bond * math.sin(angle) * math.sin(torsion)])
    return c + d[0] * bc + d[1] * m - d[2] * n


def _chain(torsions):
    """Positions of a chain whose consecutive dihedrals are `torsions`."""
    x = [np.zeros(3), np.array([0.153, 0.0, 0.0]),
         np.array([0.2, 0.145, 0.0])]
    for t in torsions:
        x.append(_place(x[-3], x[-2], x[-1], t))
    return np.stack(x)


ANGLES = {
    "generic": np.random.RandomState(1).uniform(-np.pi, np.pi, 12),
    # on the grid's knots (up to the dihedral's rounding) and mid-cell
    "knots": -np.pi + 2 * np.pi * np.array([0, 1, 5, 12, 23, 7, 7.5, 19.5,
                                            3, 16, 11, 22]) / RES,
    # at and next to +-pi, where the cell index wraps
    "pi": np.array([np.pi, -np.pi, np.pi - 1e-9, -np.pi + 1e-9, 3.1, -3.1,
                    np.pi, np.pi - 1e-12, -np.pi, 0.0, 3.14159, -3.14159]),
}


def _cmap_terms(n_dihedrals):
    idx = np.stack([np.arange(k, k + 5) for k in range(n_dihedrals - 1)])
    return idx, np.arange(len(idx)) % 2


def test_build_cmap_table_matches_jax():
    from atomsmm_tpu.ops.cmap import build_cmap_table as jax_table

    grids = _grids(3, seed=4)
    got, want = build_cmap_table(grids), np.asarray(jax_table(grids))
    assert got.shape == (3, RES, RES, 4)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


def test_separable_surface_is_reproduced():
    """f(phi, psi) = cos phi + sin psi sampled on the grid: the bicubic
    patch reproduces it to interpolation accuracy everywhere, and exactly
    (to rounding) at the knots."""
    ang = -np.pi + 2 * np.pi * np.arange(RES) / RES
    table = torch.as_tensor(build_cmap_table(
        (np.cos(ang)[:, None] + np.sin(ang)[None, :])[None]))
    rs = np.random.RandomState(2)
    phi = torch.as_tensor(rs.uniform(-np.pi, np.pi, 50))
    psi = torch.as_tensor(rs.uniform(-np.pi, np.pi, 50))
    e = cmap_interpolate(table, torch.zeros(50, dtype=torch.long), phi, psi)
    exact = torch.cos(phi) + torch.sin(psi)
    assert float((e - exact).abs().max()) < 1e-3
    knots = torch.as_tensor(ang)
    e = cmap_interpolate(table, torch.zeros(RES, dtype=torch.long), knots,
                         knots.flip(0))
    np.testing.assert_allclose(
        e.numpy(), np.cos(ang) + np.sin(ang[::-1]), atol=1e-12)


@pytest.mark.parametrize("case", sorted(ANGLES))
def test_cmap_energy_and_forces_match_jax(case):
    """The CMAP energy of a chain whose dihedrals are the case's angles,
    against the JAX package: energy to 1e-12, forces (autograd against
    jax.grad) to 1e-12 x max|F|; the dihedrals come out as built."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.ops.cmap import cmap_energy as jax_cmap

    x = _chain(ANGLES[case])
    idx, types = _cmap_terms(len(ANGLES[case]))
    table = build_cmap_table(_grids(2))
    phi = dihedral_angle(torch.as_tensor(x), torch.as_tensor(idx[:, :4]))
    wrapped = np.angle(np.exp(1j * ANGLES[case][:-1]))
    np.testing.assert_allclose(np.exp(1j * phi.numpy()), np.exp(1j * wrapped),
                               atol=1e-12)
    xx = torch.as_tensor(x).requires_grad_(True)
    e = cmap_energy(xx, torch.as_tensor(idx), torch.as_tensor(types),
                    torch.as_tensor(table))
    (g,) = torch.autograd.grad(e, xx)

    def ref(y):
        return jax_cmap(y, jnp.asarray(idx), jnp.asarray(types),
                        jnp.asarray(table))

    ej = float(ref(jnp.asarray(x)))
    gj = np.asarray(jax.grad(ref)(jnp.asarray(x)))
    assert float(e.detach()) == pytest.approx(ej, rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                               atol=1e-12 * np.abs(gj).max())


IMPROPERS = {
    "generic": (np.random.RandomState(3).uniform(-np.pi, np.pi, 8),
                np.random.RandomState(4).uniform(-np.pi, np.pi, 8)),
    # phi0 near +pi and phi near -pi: the difference wraps
    "wrap": (np.array([-3.1, -3.0, 3.1, 2.9, -3.14, 3.14, -2.5, 3.0]),
             np.array([3.1, 3.05, -3.1, -3.0, 3.0, -3.0, 2.9, -3.05])),
}


@pytest.mark.parametrize("case", sorted(IMPROPERS))
def test_improper_energy_and_forces_match_jax(case):
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.ops.bonded import harmonic_improper_energy as jax_imp

    torsions, phi0 = IMPROPERS[case]
    x = _chain(torsions)
    idx = np.stack([np.arange(k, k + 4) for k in range(len(torsions))])
    k = np.linspace(20.0, 400.0, len(torsions))
    xx = torch.as_tensor(x).requires_grad_(True)
    e = harmonic_improper_energy(xx, torch.as_tensor(idx),
                                 torch.as_tensor(phi0), torch.as_tensor(k))
    (g,) = torch.autograd.grad(e, xx)

    def ref(y):
        return jax_imp(y, jnp.asarray(idx), jnp.asarray(phi0),
                       jnp.asarray(k))

    ej = float(ref(jnp.asarray(x)))
    gj = np.asarray(jax.grad(ref)(jnp.asarray(x)))
    assert float(e.detach()) == pytest.approx(ej, rel=1e-12)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                               atol=1e-12 * np.abs(gj).max())
    # every wrapped difference is at most pi: a small energy per term
    dphi = np.angle(np.exp(1j * (torsions - phi0)))
    assert float(e.detach()) == pytest.approx(float(np.sum(k * dphi ** 2)),
                                              rel=1e-9)


def _systems():
    """The same CMAP + improper system in both packages: a 14-atom chain."""
    import jax.numpy as jnp

    import atomsmm_tpu as jamm

    torsions = ANGLES["generic"]
    x = _chain(torsions)
    n = len(x)
    idx, types = _cmap_terms(len(torsions))
    iidx = np.stack([np.arange(k, k + 4) for k in range(0, n - 3, 2)])
    phi0 = np.linspace(-3.0, 3.0, len(iidx))
    k = np.full(len(iidx), 150.0)
    table = build_cmap_table(_grids(2))
    masses = np.full(n, 12.0)
    box = np.full(3, 5.0)
    port = System(
        masses=torch.as_tensor(masses), default_box=torch.as_tensor(box),
        molecule=torch.zeros(n, dtype=torch.int32),
        forces=(CMAPTorsionForce(idx=torch.as_tensor(idx),
                                 type_index=torch.as_tensor(types),
                                 table=torch.as_tensor(table)),
                HarmonicImproperForce(idx=torch.as_tensor(iidx),
                                      phi0=torch.as_tensor(phi0),
                                      k=torch.as_tensor(k))))
    ref = jamm.System(
        masses=jnp.asarray(masses), default_box=jnp.asarray(box),
        molecule=jnp.zeros(n, jnp.int32),
        forces=(jamm.CMAPTorsionForce(idx=jnp.asarray(idx),
                                      type_index=jnp.asarray(types),
                                      table=jnp.asarray(table)),
                jamm.HarmonicImproperForce(idx=jnp.asarray(iidx),
                                           phi0=jnp.asarray(phi0),
                                           k=jnp.asarray(k))))
    return port, ref, x, box


def test_forces_in_a_system_match_jax():
    """CMAPTorsionForce and HarmonicImproperForce inside a System through
    force_fn (autograd), against the JAX package's force_fn."""
    import jax.numpy as jnp

    from atomsmm_tpu.potential import force_fn as jforce_fn

    port, ref, x, box = _systems()
    e, f = force_fn(port)(torch.as_tensor(x), torch.as_tensor(box), {})
    ej, fj = jforce_fn(ref)(jnp.asarray(x), jnp.asarray(box), {})
    fj = np.asarray(fj)
    assert float(e) == pytest.approx(float(ej), rel=1e-12)
    np.testing.assert_allclose(f.numpy(), fj, rtol=0,
                               atol=1e-12 * np.abs(fj).max())
    assert [f.group for f in port.forces] == [0, 0]


def test_cmap_force_takes_numpy_tables_once():
    """A numpy table and type index given to CMAPTorsionForce become tensors
    at construction (the type index as int64), and the force they give is
    the one of the tensor-built force, bit for bit."""
    port, _, x, box = _systems()
    built = port.forces[0]
    given = CMAPTorsionForce(idx=built.idx, type_index=_cmap_terms(
        len(ANGLES["generic"]))[1], table=build_cmap_table(_grids(2)))
    assert isinstance(given.table, torch.Tensor)
    assert given.table.dtype == torch.float64
    assert given.type_index.dtype == torch.int64
    assert torch.equal(given.table, built.table)
    xx, bb = torch.as_tensor(x), torch.as_tensor(box)
    e0, f0 = force_fn(dataclasses.replace(port, forces=(built,)))(xx, bb, {})
    e1, f1 = force_fn(dataclasses.replace(port, forces=(given,)))(xx, bb, {})
    assert float(e1) == float(e0)
    assert torch.equal(f1, f0)


def test_interop_round_trip():
    """A JAX system holding CMAP, the improper and SWM4's DrudeForce (with
    a Thole-screened pair added) crosses to the port with its index arrays
    as int64 and gives the same energy and forces (1e-12)."""
    import dataclasses

    import jax.numpy as jnp

    from atomsmm_tpu.models import swm4_water_system as jax_swm4
    from atomsmm_tpu.ops.drude import make_drude_set as jax_drude_set
    from atomsmm_tpu.potential import force_fn as jforce_fn
    from atomsmm_tpu_torch.interop import describe_reference, system_from_numpy

    _, ref, _, _ = _systems()
    js, jx, jb = jax_swm4(n_molecules=8, r_cut=0.3, r_switch=0.25)
    o = 5 * np.arange(8)
    drude = jax_drude_set(np.stack([o + 1, o], 1), np.full(8, -1.71636),
                          np.full(8, 9.7825e-4), screened_pairs=[[0, 1]],
                          thole=2.6)
    forces = (js.forces[0], dataclasses.replace(js.forces[1], drude=drude),
              *ref.forces)
    js = dataclasses.replace(js, forces=forces)
    port = system_from_numpy(describe_reference(js), dtype=F64, device="cpu")
    assert [f.name for f in port.forces] == [
        "NonbondedForce", "DrudeForce", "CMAPTorsionForce",
        "HarmonicImproperForce"]
    ds = port.forces[1].drude
    assert ds.pairs.dtype == torch.int64
    assert ds.screened_pairs.dtype == torch.int64
    rs = np.random.RandomState(5)
    x = np.asarray(jx) + rs.normal(0.0, 0.003, jx.shape)
    e, f = force_fn(port)(torch.as_tensor(x), torch.tensor(np.asarray(jb)),
                          {})
    ej, fj = jforce_fn(js)(jnp.asarray(x), jb, {})
    fj = np.asarray(fj)
    assert float(e) == pytest.approx(float(ej), rel=1e-12)
    np.testing.assert_allclose(f.numpy(), fj, rtol=0,
                               atol=1e-12 * np.abs(fj).max())


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cmap_and_improper_on_the_card_match_the_cpu(cuda, dtype):
    """A 400-atom chain's CMAP and improper terms on the card against the
    float64 CPU: float64 to 1e-12, float32 to 1e-4 of the energy and of
    max|F|."""
    rs = np.random.RandomState(6)
    torsions = rs.uniform(-np.pi, np.pi, 397)
    x = _chain(torsions)
    idx, types = _cmap_terms(len(torsions))
    iidx = np.stack([np.arange(k, k + 4) for k in range(len(torsions))])
    phi0 = rs.uniform(-np.pi, np.pi, len(iidx))
    k = rs.uniform(20.0, 400.0, len(iidx))
    table = build_cmap_table(_grids(2))
    out = []
    for dev, dt in (("cpu", F64), (cuda, dtype)):
        def t(a, d=dt):
            return torch.as_tensor(a, dtype=d, device=dev)

        xx = t(x).requires_grad_(True)
        e = (cmap_energy(xx, t(idx, torch.long), t(types, torch.long),
                         t(table))
             + harmonic_improper_energy(xx, t(iidx, torch.long), t(phi0),
                                        t(k)))
        (g,) = torch.autograd.grad(e, xx)
        out.append((float(e), g.double().cpu().numpy()))
    (e, g), (eg, gg) = out
    tol = 1e-12 if dtype == F64 else 1e-4
    assert eg == pytest.approx(e, rel=tol)
    np.testing.assert_allclose(gg, g, rtol=0, atol=tol * np.abs(g).max())
