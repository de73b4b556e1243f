"""A peptide-like chain, alone or in TIP3P water, as Amber prmtop and
inpcrd text for io.amber_system: a topology whose exclusion rows pass 16
columns and reach past +-14 atom indices, as a protein's do.

The chain: backbone carbons 0 ... n_res - 1, then one methyl carbon on
each, then one hydrogen on each backbone carbon, then three on each methyl.
Every angle and proper torsion of the bond graph is a term, so Amber's
exclusions are the 1-2/1-3/1-4 closure of the bonds (bond_closure): a
backbone carbon excludes 24 atoms and its 1-4 pairs lie 20 indices apart.
"""
import numpy as np

AMBER_CHARGE = 18.2223  # sqrt(332.0522 kcal A / (mol e^2)): Amber's unit
KCAL = 4.184
# TIP3P as models.rigid_water_system builds it, in Amber units (A, kcal/mol)
TIP3P_AMBER = {"q_o": -0.834, "q_h": 0.417, "r_oh": 0.9572,
               "theta": 104.52, "sigma_o": 3.1507, "eps_o": 0.6364 / KCAL}
# the chain, in Amber units: C-C and C-H bonds (kcal/mol/A^2, A), one
# angle, one torsion, the LJ (R_min/2 [A], epsilon [kcal/mol]) of an sp3
# carbon and its hydrogen (ff14SB's CT and HC), and the charges of a
# backbone carbon, a methyl carbon and a hydrogen (each unit neutral)
PEPTIDE = {"bond_cc": (310.0, 1.526), "bond_ch": (340.0, 1.09),
           "angle": (50.0, 109.5), "torsion": (0.16, 3.0),
           "lj_c": (1.908, 0.1094), "lj_h": (1.487, 0.0157),
           "q": (-0.09, -0.27, 0.09)}


def bond_closure(n, bonds, width=None):
    """(n, M) int32: each atom's partners within three bonds of the graph
    `bonds` (pairs of atom ids), sorted, -1 padded to `width` (default: the
    widest row; a narrower width raises ValueError)."""
    nbr = [set() for _ in range(n)]
    for i, j in bonds:
        nbr[i].add(j)
        nbr[j].add(i)
    rows = []
    for i in range(n):
        seen, front = {i}, {i}
        for _ in range(3):
            front = {j for f in front for j in nbr[f]} - seen
            seen |= front
        rows.append(sorted(seen - {i}))
    m = max(len(r) for r in rows)
    width = m if width is None else width
    if width < m:
        raise ValueError(f"a row holds {m} partners, wider than {width}")
    out = np.full((n, width), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def peptide_topology(n_res):
    """(bonds, angles, torsions, is_h) of the chain of n_res backbone
    carbons (6 n_res atoms), every angle and proper torsion of its bond
    graph."""
    b = n_res
    n = 6 * b
    bonds = [(i, i + 1) for i in range(b - 1)]
    for v in range(b):
        bonds += [(v, b + v), (v, 2 * b + v)]
        bonds += [(b + v, 3 * b + 3 * v + k) for k in range(3)]
    nbr = [set() for _ in range(n)]
    for i, j in bonds:
        nbr[i].add(j)
        nbr[j].add(i)
    angles = sorted({(min(i, k), j, max(i, k)) for j in range(n)
                     for i in nbr[j] for k in nbr[j] if i != k})
    torsions = sorted({min((i, j, k, l), (l, k, j, i))
                       for a, c in bonds for j, k in ((a, c), (c, a))
                       for i in nbr[j] - {k} for l in nbr[k] - {j, i}})
    return bonds, angles, torsions, np.arange(n) >= 2 * b


def peptide_geometry(n_res, centre):
    """Positions [nm] of peptide_topology's atoms: a planar zigzag
    backbone of C-C bonds along x at the tetrahedral angle, the methyl and
    the hydrogen of each backbone carbon on the outer side of the zigzag,
    one above and one below its plane (the methyls of carbons v and v + 2,
    on the same side, on opposite faces), the methyl hydrogens staggered
    round the C-C axis; centred on `centre`."""
    b = n_res
    cc, ch = PEPTIDE["bond_cc"][1] / 10.0, PEPTIDE["bond_ch"][1] / 10.0
    half = np.deg2rad(PEPTIDE["angle"][1]) / 2.0
    x = np.zeros((6 * b, 3))
    for v in range(b):
        s = 1.0 if v % 2 else -1.0
        c = np.array([v * cc * np.sin(half), s * 0.5 * cc * np.cos(half),
                      0.0])
        out = np.array([0.0, s, 0.0])
        up = np.array([0.0, 0.0, 1.0 if (v // 2) % 2 == 0 else -1.0])
        x[v] = c
        axis = out * np.cos(half) + up * np.sin(half)
        x[b + v] = c + cc * axis
        x[2 * b + v] = c + ch * (out * np.cos(half) - up * np.sin(half))
        e1 = np.cross(axis, [1.0, 0.0, 0.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(axis, e1)
        for k in range(3):
            t = 2.0 * np.pi * k / 3.0
            x[3 * b + 3 * v + k] = x[b + v] + ch * (
                0.334 * axis + 0.943 * (np.cos(t) * e1 + np.sin(t) * e2))
    return x - x.mean(0) + centre


def amber_section(flag, values, kind):
    """One %FLAG section of a prmtop, as lines: integers (10I8), floats
    (5E16.8) or 4-character strings (20a4)."""
    fmt, per, tok = {
        "i": ("%FORMAT(10I8)", 10, lambda v: f"{int(v):8d}"),
        "e": ("%FORMAT(5E16.8)", 5, lambda v: f"{float(v):16.8E}"),
        "a": ("%FORMAT(20a4)", 20, lambda v: f"{str(v):<4s}")}[kind]
    lines = [f"%FLAG {flag}", fmt]
    if not len(values):
        lines.append("")
    for i in range(0, len(values), per):
        lines.append("".join(tok(v) for v in values[i:i + per]))
    return lines


def prmtop_text(pointers, sections):
    """prmtop text of the POINTERS and then `sections`, (flag, values,
    kind) each (amber_section)."""
    lines = ["%VERSION  VERSION_STAMP = V0001.000  DATE = 01/01/26"]
    lines += amber_section("POINTERS", pointers, "i")
    for flag, values, kind in sections:
        lines += amber_section(flag, values, kind)
    return "\n".join(lines) + "\n"


def inpcrd_text(x_nm, box_nm, title="atomsmm_tpu_torch"):
    """inpcrd text of positions [nm] and an orthorhombic box [nm]."""
    vals = (np.asarray(x_nm) * 10.0).reshape(-1)
    lines = [title, f"{len(x_nm):6d}"]
    for i in range(0, len(vals), 6):
        lines.append("".join(f"{v:12.7f}" for v in vals[i:i + 6]))
    lines.append("".join(f"{v:12.7f}" for v in
                         [*(10.0 * float(b) for b in box_nm), 90.0, 90.0,
                          90.0]))
    return "\n".join(lines) + "\n"


def peptide_prmtop(n_res, n_water=0):
    """prmtop text of peptide_topology(n_res) followed by `n_water` TIP3P
    waters (types CT, HC, OW, HW; Lorentz-Berthelot rows A = eps R^12,
    B = 2 eps R^6 with R = R_i + R_j, eps = sqrt(eps_i eps_j))."""
    w, p = TIP3P_AMBER, PEPTIDE
    bonds, angles, torsions, is_h = peptide_topology(n_res)
    nc = len(is_h)
    half = [p["lj_c"][0], p["lj_h"][0],
            w["sigma_o"] * 2.0 ** (1.0 / 6.0) / 2.0, 0.0]
    eps = [p["lj_c"][1], p["lj_h"][1], w["eps_o"], 0.0]
    acoef, bcoef, parm = [], [], [0] * 16
    for i in range(4):
        for j in range(i + 1):
            rmin, e = half[i] + half[j], float(np.sqrt(eps[i] * eps[j]))
            acoef.append(e * rmin ** 12)
            bcoef.append(2.0 * e * rmin ** 6)
            parm[4 * i + j] = parm[4 * j + i] = len(acoef)
    o = nc + 3 * np.arange(n_water)

    def flat(terms, kind):
        return [v for t, k in zip(terms, kind) for v in [3 * a for a in t]
                + [k]]

    chain_bonds_h = [t for t in bonds if is_h[list(t)].any()]
    chain_bonds = [t for t in bonds if not is_h[list(t)].any()]
    water_bonds = [(a, a + k) for a in o for k in (1, 2)]
    bonds_h = chain_bonds_h + water_bonds
    ang_h = [t for t in angles if is_h[list(t)].any()] \
        + [(a + 1, a, a + 2) for a in o]
    ang = [t for t in angles if not is_h[list(t)].any()]
    tor_h = [t for t in torsions if is_h[list(t)].any()]
    tor = [t for t in torsions if not is_h[list(t)].any()]
    n = nc + 3 * n_water
    pointers = [0] * 31
    pointers[0], pointers[1] = n, 4
    pointers[2], pointers[3] = len(bonds_h), len(chain_bonds)
    pointers[4], pointers[5] = len(ang_h), len(ang)
    pointers[6], pointers[7] = len(tor_h), len(tor)
    pointers[11] = 1 + n_water
    pointers[12], pointers[13], pointers[14] = (len(chain_bonds), len(ang),
                                                len(tor))
    pointers[15], pointers[16], pointers[17], pointers[18] = 3, 2, 1, 4
    pointers[20] = 1
    qb, qm, qh = p["q"]
    q = [qb] * n_res + [qm] * n_res + [qh] * (4 * n_res) \
        + [w["q_o"], w["q_h"], w["q_h"]] * n_water
    sections = [
        ("ATOM_NAME", ["CB"] * n_res + ["CM"] * n_res + ["HB"] * n_res
         + ["HM"] * (3 * n_res) + ["O", "H1", "H2"] * n_water, "a"),
        ("CHARGE", [c * AMBER_CHARGE for c in q], "e"),
        ("ATOM_TYPE_INDEX", [1] * (2 * n_res) + [2] * (4 * n_res)
         + [3, 4, 4] * n_water, "i"),
        ("MASS", [12.011] * (2 * n_res) + [1.008] * (4 * n_res)
         + [15.9994, 1.008, 1.008] * n_water, "e"),
        ("NONBONDED_PARM_INDEX", parm, "i"),
        ("RESIDUE_LABEL", ["PEP"] + ["WAT"] * n_water, "a"),
        ("RESIDUE_POINTER", [1] + list(1 + nc + 3 * np.arange(n_water)),
         "i"),
        # types: 1 C-C, 2 C-H, 3 the water O-H
        ("BOND_FORCE_CONSTANT", [p["bond_cc"][0], p["bond_ch"][0], 553.0],
         "e"),
        ("BOND_EQUIL_VALUE", [p["bond_cc"][1], p["bond_ch"][1], w["r_oh"]],
         "e"),
        ("ANGLE_FORCE_CONSTANT", [p["angle"][0], 100.0], "e"),
        ("ANGLE_EQUIL_VALUE", [np.deg2rad(p["angle"][1]),
                               np.deg2rad(w["theta"])], "e"),
        ("DIHEDRAL_FORCE_CONSTANT", [p["torsion"][0]], "e"),
        ("DIHEDRAL_PERIODICITY", [p["torsion"][1]], "e"),
        ("DIHEDRAL_PHASE", [0.0], "e"),
        ("SCEE_SCALE_FACTOR", [1.2], "e"),
        ("SCNB_SCALE_FACTOR", [2.0], "e"),
        ("LENNARD_JONES_ACOEF", acoef, "e"),
        ("LENNARD_JONES_BCOEF", bcoef, "e"),
        ("BONDS_INC_HYDROGEN", flat(bonds_h, [2] * len(chain_bonds_h)
                                    + [3] * len(water_bonds)), "i"),
        ("BONDS_WITHOUT_HYDROGEN", flat(chain_bonds, [1] * len(chain_bonds)),
         "i"),
        ("ANGLES_INC_HYDROGEN", flat(ang_h, [1] * (len(ang_h) - n_water)
                                     + [2] * n_water), "i"),
        ("ANGLES_WITHOUT_HYDROGEN", flat(ang, [1] * len(ang)), "i"),
        ("DIHEDRALS_INC_HYDROGEN", flat(tor_h, [1] * len(tor_h)), "i"),
        ("DIHEDRALS_WITHOUT_HYDROGEN", flat(tor, [1] * len(tor)), "i"),
    ]
    return prmtop_text(pointers, sections)


def peptide_in_water(n_res=6, n_lattice=240, clearance=0.3):
    """(prmtop text, inpcrd text, waters kept): the chain at the centre of
    the box of models.rigid_water_system(n_lattice), every water with an
    atom within `clearance` nm of a chain atom removed (about 200 kept
    for the defaults)."""
    from .water import rigid_water_system

    _, xw, box = rigid_water_system(n_molecules=n_lattice, seed=5,
                                    device="cpu")
    box_l = float(box[0])
    xw = xw.double().numpy()
    xc = peptide_geometry(n_res, np.full(3, box_l / 2.0))
    d = xw[:, None] - xc[None]
    d -= box_l * np.round(d / box_l)
    near = (np.sqrt((d * d).sum(-1)).min(1) < clearance).reshape(-1, 3)
    keep = ~near.any(1)
    xs = np.concatenate([xc, xw.reshape(-1, 3, 3)[keep].reshape(-1, 3)])
    kept = int(keep.sum())
    return (peptide_prmtop(n_res, kept),
            inpcrd_text(xs, np.full(3, box_l), "peptide in TIP3P"), kept)
