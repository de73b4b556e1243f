"""The Amber reader of the port (atomsmm_tpu_torch/io/amber.py) against the
JAX package's (atomsmm_tpu/io/amber.py): the twins of tests/test_amber.py,
float64 on the CPU, with the same prmtop and inpcrd text (the builders of
tests/test_amber.py, imported).

Each case parses the same text with both readers, whose fields must be
equal, and builds both systems with the same keywords: per-force energies
agree to 1e-10 (of the largest term) and forces to 1e-9 x max|F|, on the
dense path and, where the box holds a cell grid, on the cell lists (K1's
plain twin on half-stencil grids, K2's on the full stencil). NBFIX type-pair
tables and the legacy 10-12 term, which the port evaluates in its table
forms, are held against JAX's XLA cell sweep in the full, near and fused
far forms, with RESPA near + far == full at 1e-12; the virial of a table
form against autograd, the dispersion tail with tables against JAX at
1e-12; TIP4P/TIP5P extra points as virtual sites, CHAMBER CMAP and extras,
SETTLE/SHAKE partitioning and HMR; a rigid-water trajectory against JAX at
1e-9 nm. Two extra-point frames that the JAX reader mishandles raise
InputError here. The four PDB cases of tests/test_amber.py are twinned in
tests/test_torch_app.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_amber as ja
from atomsmm_tpu_torch.io import amber as tam
from atomsmm_tpu_torch.ops import neighbors as tnb
from atomsmm_tpu_torch.ops import pair_kernel as pk
from atomsmm_tpu_torch.utils import InputError

F64 = torch.float64
RTOL, FTOL = 1e-10, 1e-9
KCAL = ja.KCAL
AMBER_CHARGE = ja.AMBER_CHARGE


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jam():
    from atomsmm_tpu.io import amber as jam

    return jam


def _same_value(a, b, path):
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=True), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (u, v) in enumerate(zip(a, b)):
            _same_value(u, v, f"{path}[{k}]")
    else:
        assert a == b, (path, a, b)


def _same_top(jtop, ttop):
    """Every parsed field of the two readers equal (the port's reader is a
    copy of the JAX one's numpy)."""
    for f in dataclasses.fields(jtop):
        _same_value(getattr(jtop, f.name), getattr(ttop, f.name), f.name)


def _read_both(text):
    jtop = _jam().read_prmtop(text)
    ttop = tam.read_prmtop(text)
    _same_top(jtop, ttop)
    return jtop, ttop


def _build_both(text, inpcrd=None, **kw):
    jtop, ttop = _read_both(text)
    js, jx, jb = _jam().amber_system(jtop, inpcrd, **kw)
    ts, tx, tb = tam.amber_system(ttop, inpcrd, dtype=F64, device="cpu",
                                  **kw)
    assert [f.name for f in ts.forces] == [type(f).__name__
                                           for f in js.forces]
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if jx is not None:
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    return js, ts


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _aux(js, ts, x, box):
    from atomsmm_tpu.ops import neighbors as jnb

    jaux = jnb.make_aux(js, jnb.all_neighbor_extras(js, x, box))
    taux = tnb.make_aux(ts, tnb.all_neighbor_extras(ts, _t(x), _t(box)))
    return jaux, taux


def _has_tables(system):
    return any(getattr(f, "pair_sigma", None) is not None
               or getattr(getattr(f, "full", None), "pair_sigma", None)
               is not None for f in system.forces)


def _check_energies(js, ts, x, box, cells=False, globals=None):
    """Per-force energies to 1e-10 of the largest term, the forces of each
    force group to 1e-9 x max|F| (of all forces), the port against JAX at
    the same x. With
    `cells` the port runs on its cell lists, and so does JAX unless the
    system has NBFIX tables: JAX's XLA cell sweep stages every
    per-particle column as a float, and its table gather then refuses the
    float type index, so JAX's dense path is the reference there
    (test_table_forms_on_the_cells_match_jax holds the sweeps against
    JAX's XLA sweep with the type cast back)."""
    import jax.numpy as jnp

    from atomsmm_tpu import potential as jpot
    from atomsmm_tpu_torch import potential as tpot

    x, box = np.asarray(x, np.float64), np.asarray(box, np.float64)
    jaux = taux = None
    if cells:
        jaux, taux = _aux(js, ts, x, box)
        assert taux is not None and jaux is not None
        if _has_tables(js):
            jaux = None
    g = globals or {}
    je = jpot.split_potential_energy(js, jnp.asarray(x), jnp.asarray(box), g,
                                     aux=jaux)
    te = tpot.split_potential_energy(ts, _t(x), _t(box), g, aux=taux)
    assert list(je) == list(te)
    scale = max(abs(float(v)) for v in je.values())
    for k in je:
        assert abs(float(te[k]) - float(je[k])) <= RTOL * max(scale, 1e-300), (
            k, float(te[k]), float(je[k]))
    # max|F| of the whole system scales every group's force error (a
    # group's own forces may nearly vanish: water's bonded terms at its
    # equilibrium geometry)
    _, jf_all = jpot.force_fn(js)(jnp.asarray(x), jnp.asarray(box), g, jaux)
    fmax = max(float(np.abs(np.asarray(jf_all)).max()), 1e-300)
    for group in sorted({f.group for f in ts.forces}):
        _, jf = jpot.force_fn(js, [group])(jnp.asarray(x), jnp.asarray(box),
                                           g, jaux)
        _, tf = tpot.force_fn(ts, [group])(_t(x), _t(box), g, taux)
        assert float(np.abs(tf.numpy() - np.asarray(jf)).max()) \
            <= FTOL * fmax, group
    return te


# --- the cases of tests/test_amber.py ---------------------------------------


def _native_water(m, **kw):
    from atomsmm_tpu_torch.models import water_system

    return water_system(n_molecules=m, seed=11, dtype=F64, device="cpu",
                        template_bonded=False, **kw)


@pytest.mark.parametrize("cells", [False, True])
def test_water_prmtop_matches_native_builder(cells):
    m = 27
    ref, x, box = _native_water(m, method="cutoff", r_cut=0.45, r_switch=0.40)
    js, ts = _build_both(ja._water_prmtop(m), box=box.numpy(),
                         method="cutoff", r_cut=0.45, r_switch=0.40,
                         neighbors=cells)
    assert (ts.neighbors is not None) == cells
    te = _check_energies(js, ts, x.numpy(), box.numpy(), cells=cells)
    from atomsmm_tpu_torch.potential import split_potential_energy

    e_ref = split_potential_energy(ref, x, box)
    # the prmtop's sigma round trip through A = 4 eps sigma^12 (1e-9
    # relative) amplified 12x by r^-12, as in the JAX test
    for term in ("NonbondedForce", "HarmonicBondForce", "HarmonicAngleForce",
                 "Total"):
        np.testing.assert_allclose(float(te[term]), float(e_ref[term]),
                                   rtol=1e-6, atol=1e-9, err_msg=term)


def test_water_prmtop_neighbors_and_groups():
    """The cell path equals the dense path in the port, as in JAX."""
    from atomsmm_tpu_torch.potential import split_potential_energy

    m = 27
    _, x, box = _native_water(m, r_cut=0.45, r_switch=0.40)
    text = ja._water_prmtop(m)
    _, ts = _build_both(text, box=box.numpy(), r_cut=0.45, r_switch=0.40,
                        neighbors=True)
    _, td = _build_both(text, box=box.numpy(), r_cut=0.45, r_switch=0.40)
    taux = tnb.make_aux(ts, tnb.all_neighbor_extras(ts, x, box))
    e = split_potential_energy(ts, x, box, aux=taux)
    e_d = split_potential_energy(td, x, box)
    np.testing.assert_allclose(float(e["Total"]), float(e_d["Total"]),
                               rtol=1e-10)


def test_chain_torsion_and_14():
    top = tam.read_prmtop(ja._chain_prmtop())
    _read_both(ja._chain_prmtop())
    assert len(top.torsions) == 2
    assert list(top.torsion_periodicity) == [3, 2]
    assert top.pairs14.tolist() == [[0, 3]]
    assert top.exclusion_pairs() == [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3),
                                     (2, 3)]
    x = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.20, 0.14, 0.0],
                  [0.30, 0.16, 0.12]])
    box = np.full(3, 3.0)
    js, ts = _build_both(ja._chain_prmtop(), box=box, method="cutoff",
                         r_cut=1.2, r_switch=1.0)
    e = _check_energies(js, ts, x, box)
    r14 = np.linalg.norm(x[3] - x[0])
    sig, eps = 0.34, 0.1 * KCAL
    e14 = 4 * (eps / 2.0) * ((sig / r14) ** 12 - (sig / r14) ** 6)
    e14 += ja.ONE_4PI_EPS0 * (0.3 * 0.3 / 1.2) / r14
    np.testing.assert_allclose(float(e["NonbondedExceptionsForce"]), e14,
                               rtol=1e-6)
    assert abs(float(e["NonbondedForce"])) <= 1e-12


def _chains_prmtop(n_chains):
    """n_chains copies of tests/test_amber.py's 4-atom chain (bonds,
    angles, the two-term torsion, the 1-4 pair) numbered interleaved: atom
    k of chain c is k * n_chains + c, so that every excluded pair lies
    n_chains or more indices apart and no +-14 bitmask holds them (the
    cell sweeps take the exclusion id columns)."""
    q = np.array([0.3, -0.3, -0.3, 0.3])
    sig_a, eps_kcal = 3.4, 0.1
    n = 4 * n_chains
    pointers = [0] * 31
    pointers[0], pointers[1] = n, 1
    pointers[12] = 3 * n_chains
    pointers[13] = 2 * n_chains
    pointers[14] = 2 * n_chains
    pointers[11] = n_chains
    pointers[15], pointers[16], pointers[17] = 1, 1, 2
    pointers[18] = 1

    def a(k, c):
        return 3 * (k * n_chains + c)

    bonds, angles, dihedrals = [], [], []
    for c in range(n_chains):
        bonds += [a(0, c), a(1, c), 1, a(1, c), a(2, c), 1, a(2, c), a(3, c),
                  1]
        angles += [a(0, c), a(1, c), a(2, c), 1, a(1, c), a(2, c), a(3, c), 1]
        dihedrals += [a(0, c), a(1, c), a(2, c), a(3, c), 1,
                      a(0, c), a(1, c), -a(2, c), a(3, c), 2]
    order = np.arange(n).reshape(4, n_chains).T.reshape(-1)
    names = np.empty(n, object)
    names[order] = ["C1", "C2", "C3", "C4"] * n_chains
    charges = np.empty(n)
    charges[order] = np.tile(q, n_chains)
    sections = [
        ("ATOM_NAME", list(names), "a"),
        ("CHARGE", list(charges * AMBER_CHARGE), "e"),
        ("MASS", [12.011] * n, "e"),
        ("ATOM_TYPE_INDEX", [1] * n, "i"),
        ("NONBONDED_PARM_INDEX", [1], "i"),
        ("RESIDUE_LABEL", ["CHN"] * n_chains, "a"),
        ("RESIDUE_POINTER", [1 + c for c in range(n_chains)], "i"),
        ("BOND_FORCE_CONSTANT", [300.0], "e"),
        ("BOND_EQUIL_VALUE", [1.5], "e"),
        ("ANGLE_FORCE_CONSTANT", [40.0], "e"),
        ("ANGLE_EQUIL_VALUE", [110.0 * np.pi / 180.0], "e"),
        ("DIHEDRAL_FORCE_CONSTANT", [1.4, 0.2], "e"),
        ("DIHEDRAL_PERIODICITY", [3.0, 2.0], "e"),
        ("DIHEDRAL_PHASE", [0.0, np.pi], "e"),
        ("SCEE_SCALE_FACTOR", [1.2, 1.2], "e"),
        ("SCNB_SCALE_FACTOR", [2.0, 2.0], "e"),
        ("LENNARD_JONES_ACOEF", [4 * eps_kcal * sig_a**12], "e"),
        ("LENNARD_JONES_BCOEF", [4 * eps_kcal * sig_a**6], "e"),
        ("BONDS_INC_HYDROGEN", [], "i"),
        ("BONDS_WITHOUT_HYDROGEN", bonds, "i"),
        ("ANGLES_INC_HYDROGEN", [], "i"),
        ("ANGLES_WITHOUT_HYDROGEN", angles, "i"),
        ("DIHEDRALS_INC_HYDROGEN", [], "i"),
        ("DIHEDRALS_WITHOUT_HYDROGEN", dihedrals, "i"),
    ]
    return ja._prmtop_text(sections, pointers)


def _chain_positions(n_chains, box_l, seed=4):
    """The chain of tests/test_amber.py, randomly rotated, its centres
    apart by at least 0.55 nm, in the interleaved numbering."""
    rs = np.random.RandomState(seed)
    chain = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.20, 0.14, 0.0],
                      [0.30, 0.16, 0.12]])
    chain -= chain.mean(0)
    centres = []
    while len(centres) < n_chains:
        c = rs.uniform(0, box_l, 3)
        d = np.array(centres) - c if centres else np.zeros((0, 3))
        d -= box_l * np.round(d / box_l)
        if not len(d) or np.min(np.linalg.norm(d, axis=1)) > 0.55:
            centres.append(c)
    x = np.zeros((4 * n_chains, 3))
    for c, ctr in enumerate(centres):
        q, _ = np.linalg.qr(rs.normal(size=(3, 3)))
        for k in range(4):
            x[k * n_chains + c] = ctr + chain[k] @ q.T
    return x


@pytest.mark.parametrize("box_l,kernel", [(3.0, "half_pair"),
                                          (2.4, "cell_pair")])
def test_chain_exclusion_columns_on_the_cells(box_l, kernel):
    """Interleaved chains: the exclusions lie beyond the +-14 bitmask, so
    the cell sweep (K1's twin on the 3^3 grid, K2's on the 2^3 one) takes
    the split form (the bitmask within the window, the far ids as id
    columns); energies and forces against JAX's cell sweep."""
    n_chains = 30
    x = _chain_positions(n_chains, box_l)
    box = np.full(3, box_l)
    js, ts = _build_both(_chains_prmtop(n_chains),
                         ja._inpcrd_text(x * 10.0, box_ang=box * 10.0),
                         method="cutoff", r_cut=0.9, r_switch=0.8,
                         neighbors=True)
    spec = ts.neighbors
    assert spec.exclusion_form == "split"
    assert spec.half_stencil == (kernel == "half_pair")
    x = tam.read_inpcrd(ja._inpcrd_text(x * 10.0, box_ang=box * 10.0))[0]
    _check_energies(js, ts, x, box, cells=True)


def test_inpcrd_roundtrip():
    rs = np.random.RandomState(0)
    x_a = rs.uniform(0, 20, (5, 3))
    v_amber = rs.normal(size=(5, 3))
    for text in (ja._inpcrd_text(x_a, v_amber, box_ang=[20.0, 21.0, 22.0]),
                 ja._inpcrd_text(x_a)):
        got, want = tam.read_inpcrd(text), _jam().read_inpcrd(text)
        for g, w in zip(got, want):
            _same_value(g, w, "inpcrd")
    x, v, box = tam.read_inpcrd(ja._inpcrd_text(x_a, v_amber,
                                                box_ang=[20.0, 21.0, 22.0]))
    np.testing.assert_allclose(x, x_a * 0.1, atol=1e-7)
    np.testing.assert_allclose(v, v_amber * 0.1 * 20.455, atol=1e-5)
    np.testing.assert_allclose(box, [2.0, 2.1, 2.2], atol=1e-8)


def _triclinic_inpcrd(x_ang, lengths_angles):
    lines = ja._inpcrd_text(x_ang).splitlines()
    lines.append("".join(f"{v:12.7f}" for v in lengths_angles))
    return "\n".join(lines) + "\n"


def test_triclinic_inpcrd_box():
    text = _triclinic_inpcrd(np.zeros((2, 3)),
                             [20.0, 20.0, 20.0, 90.0, 109.47, 90.0])
    _, _, box = tam.read_inpcrd(text)
    _same_value(box, _jam().read_inpcrd(text)[2], "box")
    assert box.shape == (3, 3)
    np.testing.assert_allclose(abs(np.linalg.det(box)),
                               2.0**3 * np.sin(np.radians(109.47)),
                               rtol=1e-6)


def test_triclinic_inpcrd_on_the_cell_lists():
    """A water prmtop with an angled inpcrd box: the reduced (3, 3) cell
    on the cell lists (K1's twin, fractional images) against JAX's cell
    sweep built for the same cell, and against the port's own dense path.
    (JAX's amber_system refuses an angled box: it checks the cutoff
    against the cell matrix's smallest entry; its system is built on the
    cubic box here and given the cell's neighbor spec.)"""
    from atomsmm_tpu.ops import neighbors as jnb
    from atomsmm_tpu_torch.potential import split_potential_energy

    m = 125
    _, x, box = _native_water(m, r_cut=0.45, r_switch=0.40)
    lengths = [float(box[0]) * 10.0] * 3
    record = "".join(f"{v:12.7f}" for v in lengths + [90.0, 100.0, 90.0])
    h = tam.read_inpcrd(_triclinic_inpcrd(
        np.zeros((2, 3)), lengths + [90.0, 100.0, 90.0]))[2]
    xs = (x.numpy() / float(box[0])) @ h
    crd = ja._inpcrd_text(xs * 10.0) + record + "\n"
    text = ja._water_prmtop(m)
    with pytest.raises(Exception, match="exceeds half"):
        _jam().amber_system(text, crd, r_cut=0.45, r_switch=0.40)
    ts, xr, hb = tam.amber_system(text, crd, r_cut=0.45, r_switch=0.40,
                                  neighbors=True, dtype=F64, device="cpu")
    np.testing.assert_array_equal(hb.numpy(), h)
    assert ts.neighbors.half_stencil
    js, _, _ = _jam().amber_system(text, box=box.numpy(), r_cut=0.45,
                                   r_switch=0.40)
    js = js.with_neighbors(jnb.make_neighbor_spec(
        h, 3 * m, 0.45, exclusions=js.forces[0].exclusions,
        occupancy_floor_from=xr.numpy()))
    e = _check_energies(js, ts, xr.numpy(), h, cells=True)
    td, _, _ = tam.amber_system(text, crd, r_cut=0.45, r_switch=0.40,
                                dtype=F64, device="cpu")
    e_d = split_potential_energy(td, xr, hb)
    np.testing.assert_allclose(float(e["Total"]), float(e_d["Total"]),
                               rtol=1e-10)


@pytest.mark.parametrize("cells", [False, True])
def test_water_prmtop_pme_matches_native_builder(cells):
    m = 27
    ref, x, box = _native_water(m, method="pme", r_cut=0.45, r_switch=0.40,
                                dispersion_correction=True)
    js, ts = _build_both(ja._water_prmtop(m), box=box.numpy(), method="pme",
                         r_cut=0.45, r_switch=0.40,
                         dispersion_correction=True, neighbors=cells)
    assert ts.forces[0].dispersion_coeff == pytest.approx(
        float(js.forces[0].dispersion_coeff), rel=1e-12)
    te = _check_energies(js, ts, x.numpy(), box.numpy(), cells=cells)
    from atomsmm_tpu_torch.potential import split_potential_energy

    np.testing.assert_allclose(
        float(te["Total"]), float(split_potential_energy(ref, x, box)["Total"]),
        rtol=1e-6, atol=1e-9)


def test_missing_section_message():
    with pytest.raises(InputError, match="missing required %FLAG CHARGE"):
        tam.read_prmtop("%FLAG POINTERS\n%FORMAT(10I8)\n" + f"{4:8d}" * 10
                        + "\n")


def _cmap_text(mixed):
    """The CMAP prmtops of tests/test_amber.py: one 24-grid table on a
    5-atom chain, or a 24-grid and a 12-grid table on a 6-atom chain."""
    res1, res2 = 24, 12
    ang1 = -np.pi + 2 * np.pi * np.arange(res1) / res1
    ang2 = -np.pi + 2 * np.pi * np.arange(res2) / res2
    grid1 = np.cos(ang1)[:, None] + np.sin(ang1)[None, :]
    grid2 = 0.5 * np.cos(ang2)[:, None] * np.cos(ang2)[None, :]
    n = 6 if mixed else 5
    pointers = [0] * 31
    pointers[0], pointers[1] = n, 1
    pointers[11] = 1
    pointers[12] = n - 1
    pointers[15] = 1
    pointers[18] = 1
    bonds_a = []
    for i in range(n - 1):
        bonds_a += [3 * i, 3 * (i + 1), 1]
    cmap = ([("CHARMM_CMAP_COUNT", [2, 2], "i"),
             ("CHARMM_CMAP_RESOLUTION", [res1, res2], "i"),
             ("CHARMM_CMAP_PARAMETER_01", list(grid1.reshape(-1)), "e"),
             ("CHARMM_CMAP_PARAMETER_02", list(grid2.reshape(-1)), "e"),
             ("CHARMM_CMAP_INDEX", [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 6, 2], "i")]
            if mixed else
            [("CHARMM_CMAP_COUNT", [1, 1], "i"),
             ("CHARMM_CMAP_RESOLUTION", [res1], "i"),
             ("CHARMM_CMAP_PARAMETER_01", list(grid1.reshape(-1)), "e"),
             ("CHARMM_CMAP_INDEX", [1, 2, 3, 4, 5, 1], "i")])
    sections = [
        ("ATOM_NAME", ["C"] * n, "a"),
        ("CHARGE", [0.0] * n, "e"),
        ("MASS", [12.011] * n, "e"),
        ("ATOM_TYPE_INDEX", [1] * n, "i"),
        ("NONBONDED_PARM_INDEX", [1], "i"),
        ("RESIDUE_LABEL", ["CHN"], "a"),
        ("RESIDUE_POINTER", [1], "i"),
        ("BOND_FORCE_CONSTANT", [0.0], "e"),
        ("BOND_EQUIL_VALUE", [1.5], "e"),
        ("LENNARD_JONES_ACOEF", [0.0], "e"),
        ("LENNARD_JONES_BCOEF", [0.0], "e"),
        ("BONDS_INC_HYDROGEN", [], "i"),
        ("BONDS_WITHOUT_HYDROGEN", bonds_a, "i"),
        ("ANGLES_INC_HYDROGEN", [], "i"),
        ("ANGLES_WITHOUT_HYDROGEN", [], "i"),
    ] + cmap
    return ja._prmtop_text(sections, pointers)


@pytest.mark.parametrize("mixed", [False, True])
def test_chamber_cmap_supported(mixed):
    """CHAMBER CMAP: one table, or tables of two resolutions grouped into
    two CMAPTorsionForces; the bicubic surface against the analytic one
    it sampled, energies and forces against JAX."""
    from atomsmm_tpu_torch.forces import CMAPTorsionForce
    from atomsmm_tpu_torch.ops.bonded import dihedral_angle
    from atomsmm_tpu_torch.potential import potential_energy

    text = _cmap_text(mixed)
    top = tam.read_prmtop(text)
    box = np.full(3, 6.0)
    js, ts = _build_both(text, box=box, method="cutoff", r_cut=1.0,
                         r_switch=0.9)
    cmaps = [f for f in ts.forces if isinstance(f, CMAPTorsionForce)]
    assert len(cmaps) == (2 if mixed else 1)
    x = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.22, 0.14, 0.0],
                  [0.30, 0.18, 0.12], [0.42, 0.10, 0.20],
                  [0.50, 0.22, 0.28]])[:top.natom] + 3.0
    _check_energies(js, ts, x, box)
    xt = _t(x)
    phi = float(dihedral_angle(xt, torch.tensor([[0, 1, 2, 3]]))[0])
    psi = float(dihedral_angle(xt, torch.tensor([[1, 2, 3, 4]]))[0])
    e_ref = np.cos(phi) + np.sin(psi)
    if mixed:
        psi2 = float(dihedral_angle(xt, torch.tensor([[2, 3, 4, 5]]))[0])
        e_ref += 0.5 * np.cos(psi) * np.cos(psi2)
    np.testing.assert_allclose(float(potential_energy(ts, xt, _t(box))),
                               e_ref * KCAL,
                               atol=(5e-3 if mixed else 1e-3) * KCAL)


def test_chamber_extras_supported():
    sig14_a, eps14_kcal = 3.2, 0.04
    text = ja._chain_prmtop() + "\n".join(
        ja._sec("CHARMM_UREY_BRADLEY_COUNT", [1, 1], "i")
        + ja._sec("CHARMM_UREY_BRADLEY", [1, 3, 1], "i")
        + ja._sec("CHARMM_UREY_BRADLEY_FORCE_CONSTANT", [50.0], "e")
        + ja._sec("CHARMM_UREY_BRADLEY_EQUIL_VALUE", [2.5], "e")
        + ja._sec("CHARMM_NUM_IMPROPERS", [1], "i")
        + ja._sec("CHARMM_IMPROPERS", [1, 2, 3, 4, 1], "i")
        + ja._sec("CHARMM_IMPROPER_FORCE_CONSTANT", [20.0], "e")
        + ja._sec("CHARMM_IMPROPER_PHASE", [0.0], "e")
        + ja._sec("LENNARD_JONES_14_ACOEF", [4 * eps14_kcal * sig14_a**12],
                  "e")
        + ja._sec("LENNARD_JONES_14_BCOEF", [4 * eps14_kcal * sig14_a**6],
                  "e")
    ) + "\n"
    top = tam.read_prmtop(text)
    assert len(top.ub_pairs) == 1 and len(top.imp_idx) == 1
    box = np.full(3, 4.0)
    js, ts = _build_both(text, box=box, method="cutoff", r_cut=1.2,
                         r_switch=1.1)
    kinds = [f.name for f in ts.forces]
    assert kinds.count("HarmonicBondForce") == 2
    assert "HarmonicImproperForce" in kinds
    x = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.22, 0.14, 0.0],
                  [0.30, 0.18, 0.12]])
    e = _check_energies(js, ts, x, box)
    r13 = float(np.linalg.norm(x[2] - x[0]))
    np.testing.assert_allclose(float(e["HarmonicBondForce#2"]),
                               0.5 * (2 * 50.0 * KCAL * 100.0)
                               * (r13 - 0.25) ** 2, rtol=1e-6)
    exc, = (f for f in ts.forces if f.name == "NonbondedExceptionsForce")
    np.testing.assert_allclose(float(exc.sigma[0]), 0.32, rtol=1e-7)
    np.testing.assert_allclose(float(exc.epsilon[0]), eps14_kcal * KCAL,
                               rtol=1e-7)


def test_polarizable_prmtop_rejected():
    text = ja._water_prmtop(1) + "\n".join(ja._sec("IPOL", [1], "i")) + "\n"
    with pytest.raises(InputError, match="polarizable"):
        tam.read_prmtop(text)


A_HB, B_HB = 7500.0, 2300.0  # kcal A^12 / kcal A^10 (tests/test_amber.py)


def _hbond_pair_text():
    pointers = [0] * 31
    pointers[0], pointers[1] = 2, 2
    pointers[11] = 2
    pointers[18] = 2
    pointers[19] = 1
    sections = [
        ("ATOM_NAME", ["N", "H"], "a"),
        ("CHARGE", [0.0, 0.0], "e"),
        ("MASS", [14.0, 1.008], "e"),
        ("ATOM_TYPE_INDEX", [1, 2], "i"),
        ("NONBONDED_PARM_INDEX", [1, -1, -1, 2], "i"),
        ("RESIDUE_LABEL", ["A", "B"], "a"),
        ("RESIDUE_POINTER", [1, 2], "i"),
        ("LENNARD_JONES_ACOEF", [0.0, 0.0], "e"),
        ("LENNARD_JONES_BCOEF", [0.0, 0.0], "e"),
        ("HBOND_ACOEF", [A_HB], "e"),
        ("HBOND_BCOEF", [B_HB], "e"),
        ("BONDS_INC_HYDROGEN", [], "i"),
        ("BONDS_WITHOUT_HYDROGEN", [], "i"),
        ("ANGLES_INC_HYDROGEN", [], "i"),
        ("ANGLES_WITHOUT_HYDROGEN", [], "i"),
    ]
    return ja._prmtop_text(sections, pointers)


def test_10_12_hydrogen_bond_supported():
    """A/r^12 - B/r^10 on the flagged type pair, zero elsewhere, units
    from kcal A^n; the tables carry exact Lorentz-Berthelot LJ beside it."""
    from atomsmm_tpu_torch.potential import potential_energy

    top = tam.read_prmtop(_hbond_pair_text())
    assert top.pair_a1012 is not None and top.pair_sigma is not None
    np.testing.assert_allclose(top.pair_a1012[0, 1], A_HB * KCAL * 1e-12,
                               rtol=1e-10)
    box = np.full(3, 3.0)
    js, ts = _build_both(_hbond_pair_text(), box=box, method="cutoff",
                         r_cut=1.0, r_switch=0.9)
    form = ts.forces[0]._pair_form()
    assert form.table and form.hbond
    r = 0.19
    x = np.array([[1.0, 1.0, 1.0], [1.0 + r, 1.0, 1.0]])
    _check_energies(js, ts, x, box)
    e_ref = A_HB * KCAL * 1e-12 / r**12 - B_HB * KCAL * 1e-10 / r**10
    np.testing.assert_allclose(float(potential_energy(ts, _t(x), _t(box))),
                               e_ref, rtol=1e-10)


def _water_hbond_text(m):
    """tests/test_amber.py's water prmtop with its O-H type slot flagged as
    a 10-12 pair (A 7500 kcal A^12, B 2300 kcal A^10): every
    intermolecular O-H pair takes A/r^12 - B/r^10 inside the switch."""
    text = ja._water_prmtop(m)
    head, rest = text.split("%FLAG NONBONDED_PARM_INDEX\n", 1)
    fmt, _, tail = rest.split("\n", 2)
    text = (head + "%FLAG NONBONDED_PARM_INDEX\n" + fmt + "\n"
            + "".join(f"{v:8d}" for v in (1, -1, -1, 3)) + "\n" + tail)
    return text + "\n".join(ja._sec("HBOND_ACOEF", [A_HB], "e")
                            + ja._sec("HBOND_BCOEF", [B_HB], "e")) + "\n"


def _nbfix_water_text(m):
    """The water prmtop with an LJ site on H (sigma 1.0 A, epsilon 0.01
    kcal/mol) and an O-H cross row off Lorentz-Berthelot (sigma 2.0 A,
    epsilon 0.05 kcal/mol): NBFIX tables on a charged, excluded system.
    (A row is NBFIX only between two types with epsilon > 0, as the JAX
    reader detects it.)"""
    text = ja._water_prmtop(m)

    def ab(sig_a, eps_kcal):
        return 4 * eps_kcal * sig_a**12, 4 * eps_kcal * sig_a**6

    (a_oo, b_oo), (a12, b12), (a_hh, b_hh) = (
        ab(3.165492, 0.1554253), ab(2.0, 0.05), ab(1.0, 0.01))
    for flag, vals in (("LENNARD_JONES_ACOEF", [a_oo, a12, a_hh]),
                       ("LENNARD_JONES_BCOEF", [b_oo, b12, b_hh])):
        head, rest = text.split(f"%FLAG {flag}\n", 1)
        fmt, _, tail = rest.split("\n", 2)
        text = (head + f"%FLAG {flag}\n" + fmt + "\n"
                + "".join(f"{v:16.8E}" for v in vals) + "\n" + tail)
    return text


def _water_case(kind, m=125):
    text = {"nbfix": _nbfix_water_text, "hbond": _water_hbond_text}[kind](m)
    _, x, box = _native_water(m, r_cut=0.45, r_switch=0.40)
    return text, x.numpy(), box.numpy()


def _jax_cell_sweep(jforce, x, box, jaux):
    """(E, F) of a JAX NonbondedForce with tables on JAX's XLA cell sweep,
    its PME terms outside the sweep included. The sweep stages the type
    column as a float (ops/neighbors.py::_stage_buckets), which the
    force's own table gather refuses; the pair function here casts it
    back to int32 (exact) and is otherwise the force's own."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.ops import neighbors as jnb

    pair = jforce._pair_fn({})

    def typed(r, pi, pj):
        return pair(r, {**pi, "lj_type": pi["lj_type"].astype(jnp.int32)},
                    {**pj, "lj_type": pj["lj_type"].astype(jnp.int32)})

    typed.takes_rv = True
    nbr = jaux["default"]
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    e, f = jnb.cell_pair_energy_forces(
        typed, xj, bj, jforce._per_particle({}), nbr["spec"], nbr["bucket"],
        jforce.r_cut)
    if jforce.method == "pme":
        e2, g2 = jax.value_and_grad(
            lambda xx: jforce._recip_energy(xx, bj, {}))(xj)
        e, f = e + e2, f - g2
    return e, f


@pytest.mark.parametrize("method", ["cutoff", "pme"])
@pytest.mark.parametrize("kind", ["nbfix", "hbond"])
def test_table_forms_on_the_cells_match_jax(kind, method):
    """NBFIX tables and the 10-12 term on the cell lists: the full force
    on K1's twin (3^3 half stencil) and K2's twin (the same grid's full
    stencil) against JAX's XLA cell sweep, per atom at 1e-10 / 1e-9
    max|F|; then RESPASystem: near + far == full at 1e-12 in the port, the
    near (table form) and fused far (full form with the 10-12 term) groups
    against JAX's."""
    import jax.numpy as jnp

    from atomsmm_tpu import systems as jsystems
    from atomsmm_tpu_torch import systems as tsystems
    from atomsmm_tpu_torch.potential import potential_energy

    text, x, box = _water_case(kind)
    js, ts = _build_both(text, box=box, method=method, r_cut=0.45,
                         r_switch=0.40, neighbors=True)
    top = tam.read_prmtop(text)
    assert top.lj_type is not None
    assert (top.pair_a1012 is not None) == (kind == "hbond")
    form = ts.forces[0]._pair_form()
    assert form.table and form.hbond == (kind == "hbond")
    spec = ts.neighbors
    assert spec.half_stencil and spec.excbits is not None
    jaux, taux = _aux(js, ts, x, box)
    je, jf = _jax_cell_sweep(js.forces[0], x, box, jaux)
    nb = ts.forces[0]
    pp = nb._per_particle()
    xt, bt = _t(x), _t(box)
    bucket = taux["default"]["bucket"]
    e_rest, f_rest = (nb._recip_energy_forces(xt, bt) if method == "pme"
                      else (0.0, 0.0))
    fmax = float(np.abs(np.asarray(jf)).max())
    for plain in (pk.half_pair_plain, pk.full_pair_plain):
        out = plain(xt, pp, bucket, spec, bt, form, form.r_cut)
        e = float(out[:, 3].sum() + e_rest)
        f = out[:-1, :3] + f_rest
        assert abs(e - float(je)) <= RTOL * abs(float(je)), plain.__name__
        assert float((f - torch.as_tensor(np.asarray(jf))).abs().max()) \
            <= FTOL * fmax, plain.__name__
    _check_energies(js, ts, x, box, cells=True)
    # RESPA: the split is exact on the table path
    tr = tsystems.RESPASystem(ts, rcut_in=0.3, rswitch_in=0.25)
    jr = jsystems.RESPASystem(js, rcut_in=0.3, rswitch_in=0.25)
    near, = (f for f in tr.forces if f.name == "NearNonbondedForce")
    assert near._pair_form().table and not near._pair_form().hbond
    far, = (f for f in tr.forces if f.name == "FarNonbondedForce")
    assert far._pair_form().table
    assert far._pair_form().hbond == (kind == "hbond")
    e_full = potential_energy(ts, xt, bt)
    e_split = potential_energy(tr, xt, bt)
    assert abs(float(e_split - e_full)) <= 1e-12 * abs(float(e_full))
    _check_energies(jr, tr, x, box, cells=True)


def test_nbfix_tables_supported():
    """tests/test_amber.py's binary LJ mixture with an NBFIX (1, 2) row:
    the tables parsed exactly, the energy against a numpy brute-force sum
    with the tabulated parameters, the port against JAX on the dense path
    and on the cell lists, and RESPA near + far == full at 1e-12."""
    from atomsmm_tpu_torch import systems as tsystems
    from atomsmm_tpu_torch.potential import potential_energy

    n1 = n2 = 12
    text = ja._nbfix_prmtop(n1, n2)
    top = tam.read_prmtop(text)
    np.testing.assert_allclose(top.pair_sigma[0, 1], 0.36, rtol=1e-7)
    np.testing.assert_allclose(top.pair_epsilon[0, 1], 0.05 * KCAL,
                               rtol=1e-7)
    box = np.array([2.4, 2.4, 2.4])
    x = np.random.RandomState(3).uniform(0, 2.4, (n1 + n2, 3))
    r_cut, r_switch = 0.9, 0.75
    for cells in (False, True):
        js, ts = _build_both(text, box=box, method="cutoff", r_cut=r_cut,
                             r_switch=r_switch, neighbors=cells)
        _check_energies(js, ts, x, box, cells=cells)
    sig_t, eps_t, types = top.pair_sigma, top.pair_epsilon, top.lj_type
    e_ref = 0.0
    for i in range(n1 + n2):
        for j in range(i + 1, n1 + n2):
            d = x[i] - x[j]
            d -= box * np.round(d / box)
            r = np.sqrt((d * d).sum())
            if r >= r_cut:
                continue
            s, ep = sig_t[types[i], types[j]], eps_t[types[i], types[j]]
            u = 4 * ep * ((s / r) ** 12 - (s / r) ** 6)
            if r > r_switch:
                tt = (r - r_switch) / (r_cut - r_switch)
                u *= 1 + tt**3 * (-10 + tt * (15 - 6 * tt))
            e_ref += u
    _, ts = _build_both(text, box=box, method="cutoff", r_cut=r_cut,
                        r_switch=r_switch)
    e = float(potential_energy(ts, _t(x), _t(box)))
    np.testing.assert_allclose(e, e_ref, rtol=1e-6)
    respa = tsystems.RESPASystem(ts, rcut_in=0.5, rswitch_in=0.42)
    np.testing.assert_allclose(float(potential_energy(respa, _t(x), _t(box))),
                               e, rtol=1e-12)


@pytest.mark.parametrize("kind", ["nbfix", "hbond"])
def test_table_virial_matches_autograd(kind):
    """The virial flag on a table form (one sweep, each pair's d . F in the
    energy column) against autograd of the dense energy, the full force
    and the fused far force of a RESPA split."""
    from atomsmm_tpu_torch import systems as tsystems
    from atomsmm_tpu_torch.forces import autograd_virial

    text, x, box = _water_case(kind, m=64)
    _, ts = _build_both(text, box=box, r_cut=0.45, r_switch=0.40,
                        neighbors=True)
    tr = tsystems.RESPASystem(ts, rcut_in=0.3, rswitch_in=0.25)
    xt, bt = _t(x), _t(box)
    for system in (ts, tr):
        aux = tnb.make_aux(system, tnb.all_neighbor_extras(system, xt, bt))
        for f in system.forces:
            if not hasattr(f, "_pair_form"):
                continue
            w, frc = f.virial(xt, bt, {}, aux)
            w_a, f_a = autograd_virial(
                lambda xx, bb: f.energy(xx, bb, {}, None), xt, bt)
            assert abs(float(w - w_a)) <= 1e-9 * abs(float(w_a)), f.name
            assert float((frc - f_a).abs().max()) \
                <= FTOL * float(f_a.abs().max()), f.name


def test_dispersion_coefficient_with_tables_matches_jax():
    from atomsmm_tpu.forces import compute_dispersion_coefficient as jdisp
    from atomsmm_tpu_torch.forces import compute_dispersion_coefficient

    for text in (ja._nbfix_prmtop(12, 7), _nbfix_water_text(27)):
        top = tam.read_prmtop(text)
        kw = dict(lj_type=top.lj_type, pair_sigma=top.pair_sigma,
                  pair_epsilon=top.pair_epsilon)
        got = compute_dispersion_coefficient(
            _t(top.sigma), _t(top.epsilon), 0.75, 0.9, lj_type=torch.as_tensor(
                top.lj_type), pair_sigma=_t(top.pair_sigma),
            pair_epsilon=_t(top.pair_epsilon))
        want = float(jdisp(top.sigma, top.epsilon, 0.75, 0.9, **kw))
        assert abs(got - want) <= 1e-12 * abs(want)
        lb = compute_dispersion_coefficient(top.sigma, top.epsilon, 0.75, 0.9)
        assert lb != got  # the NBFIX row moves the tail


def test_tip4p_extra_points_become_virtual_sites():
    m = 8
    text = ja._tip4p_prmtop(m)
    top = tam.read_prmtop(text)
    _read_both(text)
    assert top.vs_sites is not None and len(top.vs_sites) == m
    c = 0.015 / (2 * 0.09572 * np.cos(104.52 * np.pi / 360.0))
    np.testing.assert_allclose(top.vs_weights[:, 1], c, rtol=1e-6)
    box = np.full(3, 2.0)
    js, ts = _build_both(text, box=box, method="cutoff", r_cut=0.8,
                         r_switch=0.7)
    assert ts.virtual_sites is not None
    hb = [f for f in ts.forces if f.name == "HarmonicBondForce"]
    assert len(hb) == 1 and hb[0].idx.shape[0] == 2 * m
    rs_ = np.random.RandomState(0)
    centres = rs_.uniform(0.3, 1.7, (m, 3))
    r, th = 0.09572, 104.52 * np.pi / 180.0
    mol = np.stack([np.zeros(3), [r * np.sin(th / 2), r * np.cos(th / 2), 0],
                    [-r * np.sin(th / 2), r * np.cos(th / 2), 0],
                    np.zeros(3)])
    x = (centres[:, None, :] + mol).reshape(-1, 3)
    _check_energies(js, ts, x, box)
    from atomsmm_tpu_torch.potential import force_fn

    _, f = force_fn(ts)(_t(x), _t(box), {}, None)
    assert float(f[torch.as_tensor(top.vs_sites).long()].abs().max()) == 0.0


def test_unsupported_extra_points_rejected():
    text = ja._water_prmtop(1).replace("1.00800000E+00", "0.00000000E+00", 1)
    with pytest.raises(InputError, match="underdetermined"):
        tam.read_prmtop(text)


def test_collinear_lone_pair_extra_point():
    text = ja._lone_pair_prmtop()
    top = tam.read_prmtop(text)
    _read_both(text)
    f = 0.16 / 0.1766
    np.testing.assert_allclose(top.vs_weights[0], [1.0 + f, -f, 0.0],
                               rtol=1e-9)
    box = np.full(3, 4.0)
    js, ts = _build_both(text, box=box, method="cutoff", r_cut=1.0,
                         r_switch=0.9)
    c = np.asarray([1.0, 1.0, 1.0])
    u = np.asarray([1.0, 2.0, 2.0]) / 3.0
    cl = c + 0.1766 * u
    x = np.stack([c, cl, np.zeros(3)])
    from atomsmm_tpu_torch.ops.virtual_sites import place_virtual_sites

    xp = place_virtual_sites(ts.virtual_sites, _t(x))
    np.testing.assert_allclose(xp[2].numpy(), cl + 0.16 * u, rtol=0,
                               atol=1e-12)
    _check_energies(js, ts, x, box)


def test_out_of_plane_extra_points_tip5p():
    from atomsmm_tpu_torch.ops.virtual_sites import place_virtual_sites

    text, t0, l0, th = ja._tip5p_prmtop()
    top = tam.read_prmtop(text)
    _read_both(text)
    np.testing.assert_allclose(top.vs_oop[0], -top.vs_oop[1], rtol=1e-9)
    assert abs(top.vs_oop[0]) > 1e-3
    box = np.full(3, 2.0)
    js, ts = _build_both(text, box=box, method="cutoff", r_cut=0.8,
                         r_switch=0.7)
    r = 0.09572
    o = np.asarray([1.0, 1.0, 1.0])
    h1 = o + r * np.asarray([np.sin(t0 / 2), np.cos(t0 / 2), 0.0])
    h2 = o + r * np.asarray([-np.sin(t0 / 2), np.cos(t0 / 2), 0.0])
    x = np.stack([o, h1, h2, np.zeros(3), np.zeros(3)])
    xp = place_virtual_sites(ts.virtual_sites, _t(x)).numpy()
    for lp in (xp[3], xp[4]):
        # the prmtop's 9 significant digits of the angles bound these
        np.testing.assert_allclose(np.linalg.norm(lp - o), 0.070, rtol=1e-7)
        for h in (h1, h2):
            cos_a = np.dot(lp - o, h - o) / (0.070 * r)
            np.testing.assert_allclose(np.arccos(cos_a), th, rtol=1e-7)
    cos_l = np.dot(xp[3] - o, xp[4] - o) / 0.070**2
    np.testing.assert_allclose(np.arccos(cos_l), l0, rtol=1e-7)
    _check_energies(js, ts, x, box)


def test_unpaired_out_of_plane_extra_point_raises():
    """A TIP5P-like water with one of its two lone pairs: the remaining
    out-of-plane site has no mirror partner to take its side from. The
    JAX reader places it on an arbitrary side; the port refuses it,
    naming the site."""
    text, t0, l0, th = ja._tip5p_prmtop()
    # drop the second lone pair: 4 atoms, one O-LP bond, two LP-O-H angles
    pointers = [0] * 31
    pointers[0], pointers[1] = 4, 3
    pointers[2], pointers[12], pointers[4] = 2, 1, 3
    pointers[15], pointers[16], pointers[18], pointers[30] = 2, 2, 3, 1
    qh = 0.241 * AMBER_CHARGE
    sections = [
        ("ATOM_NAME", ["O", "H1", "H2", "EP1"], "a"),
        ("CHARGE", [0.0, qh, qh, -2 * qh], "e"),
        ("MASS", [15.9994, 1.008, 1.008, 0.0], "e"),
        ("ATOM_TYPE_INDEX", [1, 2, 2, 3], "i"),
        ("NONBONDED_PARM_INDEX", [1, 2, 4, 2, 3, 5, 4, 5, 6], "i"),
        ("RESIDUE_LABEL", ["WAT"], "a"),
        ("RESIDUE_POINTER", [1], "i"),
        ("BOND_FORCE_CONSTANT", [553.0 / 2, 900.0 / 2], "e"),
        ("BOND_EQUIL_VALUE", [0.9572, 0.70], "e"),
        ("ANGLE_FORCE_CONSTANT", [100.0 / 2, 100.0 / 2], "e"),
        ("ANGLE_EQUIL_VALUE", [t0, th], "e"),
        ("LENNARD_JONES_ACOEF", [0.0] * 6, "e"),
        ("LENNARD_JONES_BCOEF", [0.0] * 6, "e"),
        ("BONDS_INC_HYDROGEN", [0, 3, 1, 0, 6, 1], "i"),
        ("BONDS_WITHOUT_HYDROGEN", [0, 9, 2], "i"),
        ("ANGLES_INC_HYDROGEN", [3, 0, 6, 1, 9, 0, 3, 2, 9, 0, 6, 2], "i"),
        ("ANGLES_WITHOUT_HYDROGEN", [], "i"),
    ]
    text = ja._prmtop_text(sections, pointers)
    top = _jam().read_prmtop(text)  # the JAX reader picks a side
    assert top.vs_oop is not None and abs(top.vs_oop[0]) > 1e-3
    with pytest.raises(InputError, match="extra point 3 .*unpaired"):
        tam.read_prmtop(text)


def test_collinear_two_neighbor_frame_raises():
    """An extra point framed by a parent whose two massive neighbors are
    collinear with it (H-O-H at 180 degrees) and given EP angles: the
    frame spans no plane. The JAX reader fails in numpy's solve with a
    LinAlgError; the port raises InputError naming the site."""
    text, t0, l0, th = ja._tip5p_prmtop()
    flat = text.replace(f"{t0:16.8E}", f"{np.pi:16.8E}", 1)
    assert flat != text
    with pytest.raises(np.linalg.LinAlgError):
        _jam().read_prmtop(flat)
    with pytest.raises(InputError, match="extra point 3: .*collinear"):
        tam.read_prmtop(flat)


def test_excluded_atoms_list_validated():
    top = tam.read_prmtop(ja._water_prmtop(2) + ja._exclusion_sections(2))
    assert top.natom == 6
    with pytest.raises(InputError, match="EXCLUDED_ATOMS_LIST disagrees"):
        tam.read_prmtop(ja._water_prmtop(2)
                        + ja._exclusion_sections(2, extra_pair=(0, 3)))


def _settle_equal(js, ts):
    for k in ("triplets", "ra", "rb", "rc"):
        np.testing.assert_allclose(getattr(ts.settle, k).numpy(),
                                   np.asarray(getattr(js.settle, k)),
                                   rtol=1e-12, atol=0, err_msg=k)


def test_rigid_water_constraints_build_settle():
    m = 27
    _, x, box = _native_water(m, r_cut=0.45, r_switch=0.40)
    js, ts = _build_both(ja._water_prmtop(m), box=box.numpy(), r_cut=0.45,
                         r_switch=0.40, rigid_water=True)
    assert ts.settle is not None and ts.settle.size == m
    assert ts.constraints is None and ts.num_constraints == 3 * m
    names = {f.name for f in ts.forces}
    assert "HarmonicBondForce" not in names
    assert "HarmonicAngleForce" not in names
    _settle_equal(js, ts)
    xp = x.numpy() + 0.003 * np.random.RandomState(7).normal(size=x.shape)
    _check_energies(js, ts, xp, box.numpy())


def test_h_bonds_constraints_keep_angles_on_shake():
    m = 8
    _, x, box = _native_water(m, r_cut=0.3, r_switch=0.25)
    js, ts = _build_both(ja._water_prmtop(m), box=box.numpy(), r_cut=0.3,
                         r_switch=0.25, constraints="h-bonds")
    assert ts.num_constraints == 2 * m and ts.settle is None
    assert ts.constraints is not None and ts.constraints.size == 2 * m
    np.testing.assert_array_equal(ts.constraints.pairs.numpy(),
                                  np.asarray(js.constraints.pairs))
    np.testing.assert_allclose(ts.constraints.d0.numpy(),
                               np.asarray(js.constraints.d0), rtol=1e-15)
    assert "HarmonicAngleForce" in {f.name for f in ts.forces}
    _check_energies(js, ts, x.numpy(), box.numpy())
    with pytest.raises(InputError, match="constraints"):
        tam.amber_system(tam.read_prmtop(ja._water_prmtop(m)),
                         box=box.numpy(), r_cut=0.3, r_switch=0.25,
                         constraints="all-bonds", device="cpu")


def test_hydrogen_mass_target_semantics():
    m = 8
    _, _, box = _native_water(m, r_cut=0.3, r_switch=0.25)
    js, ts = _build_both(ja._water_prmtop(m), box=box.numpy(), r_cut=0.3,
                         r_switch=0.25, rigid_water=True, hydrogen_mass=3.024)
    masses = ts.masses.numpy()
    np.testing.assert_allclose(masses[1::3], 3.024)
    np.testing.assert_allclose(masses[0::3], 15.9994 - 2 * (3.024 - 1.008))
    np.testing.assert_allclose(masses, np.asarray(js.masses), rtol=1e-15)
    _settle_equal(js, ts)


def _rigid_run(pkg, system, x, box, steps, v):
    if pkg == "jax":
        import jax.numpy as jnp

        from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state

        ctx = Context(system, VelocityVerletIntegrator(0.004), make_state(
            jnp.asarray(x), v=jnp.asarray(v), box=jnp.asarray(box)))
        ctx.step(steps)
        return np.asarray(ctx.get_state().positions)
    from atomsmm_tpu_torch import Context, VelocityVerletIntegrator, make_state

    ctx = Context(system, VelocityVerletIntegrator(0.004), make_state(
        _t(x), v=_t(v), box=_t(box)))
    ctx.step(steps)
    return ctx.get_state().positions.numpy()


def _rigid_start(ts, x):
    from atomsmm_tpu_torch.ops.settle import settle_positions

    x0 = settle_positions(ts.settle, x, x, ts.masses).numpy()
    m = ts.masses.numpy()
    v = np.random.RandomState(4).normal(size=x0.shape) * np.sqrt(
        0.0083144626 * 300.0 / m)[:, None]
    return x0, v


def test_rigid_water_trajectory_matches_jax():
    """20 velocity Verlet steps at 4 fs of rigid HMR water on SETTLE (the
    cell lists on the port's side), velocities from numpy, against the
    JAX package's dense run at 1e-9 nm."""
    m = 27
    _, x, box = _native_water(m, r_cut=0.45, r_switch=0.40)
    kw = dict(box=box.numpy(), r_cut=0.45, r_switch=0.40, rigid_water=True,
              hydrogen_mass=3.024)
    js, ts = _build_both(ja._water_prmtop(m), **kw)
    _, tc = _build_both(ja._water_prmtop(m), neighbors=True, **kw)
    x0, v = _rigid_start(ts, x)
    want = _rigid_run("jax", js, x0, box.numpy(), 20, v)
    got = _rigid_run("torch", tc, x0, box.numpy(), 20, v)
    assert float(np.abs(got - want).max()) <= 1e-9


@pytest.mark.slow
def test_rigid_water_trajectory_holds_geometry():
    from atomsmm_tpu_torch.ops.settle import settle_residual

    m = 27
    _, x, box = _native_water(m, r_cut=0.45, r_switch=0.40)
    ts, _, _ = tam.amber_system(
        tam.read_prmtop(ja._water_prmtop(m)), box=box.numpy(), r_cut=0.45,
        r_switch=0.40, rigid_water=True, hydrogen_mass=3.024, dtype=F64,
        device="cpu")
    x0, v = _rigid_start(ts, x)
    xt = _rigid_run("torch", ts, x0, box.numpy(), 100, v)
    assert float(settle_residual(ts.settle, _t(xt))) < 1e-10


@pytest.mark.parametrize("kind", ["nbfix", "hbond"])
def test_coulomb_energy_of_a_table_system(kind):
    """The Coulomb column of a table system: the port zeroes the tables'
    epsilon and 10-12 terms with the per-particle epsilon, so it equals
    the JAX package's Coulomb energy of the same charges without tables;
    the JAX package zeroes the per-particle column only and keeps the
    tables' LJ (ROADMAP, queue 3)."""
    import jax.numpy as jnp

    from atomsmm_tpu import computers as jcomp
    from atomsmm_tpu_torch import computers as tcomp

    text, x, box = _water_case(kind, m=64)
    js, ts = _build_both(text, box=box, r_cut=0.45, r_switch=0.40)
    jplain, _ = _build_both(ja._water_prmtop(64), box=box, r_cut=0.45,
                            r_switch=0.40)
    want = float(jcomp.coulomb_energy(jplain, jnp.asarray(x),
                                      jnp.asarray(box)))
    got = float(tcomp.coulomb_energy(ts, _t(x), _t(box)))
    assert abs(got - want) <= RTOL * abs(want)
    kept = float(jcomp.coulomb_energy(js, jnp.asarray(x), jnp.asarray(box)))
    assert abs(kept - want) > 1e-6 * abs(want)


def test_tile_list_refuses_a_table_form():
    """The tile list's staging and K3 take no type column: a table system
    raises InputError there (it runs on the cell lists)."""
    from atomsmm_tpu_torch.ops import tilepair as tp

    text, x, box = _water_case("nbfix", m=64)
    _, ts = _build_both(text, box=box, r_cut=0.45, r_switch=0.40)
    nb = ts.forces[0]
    xt, bt = _t(x), _t(box)
    spec = tp.make_tilepair_spec(box, xt.shape[0], 0.45,
                                 exclusions=nb.exclusions, device="cpu")
    order, hb, cb, wrap, *_ = tp.build_tile_pairs(spec, xt, bt)
    with pytest.raises(InputError, match="type-pair table"):
        tp.tile_pair_energy_forces(nb._pair_form(), xt, bt,
                                   nb._per_particle(), spec, order, hb, cb,
                                   wrap, 0.45)
