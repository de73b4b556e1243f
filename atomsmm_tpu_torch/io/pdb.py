"""Minimal PDB coordinate I/O, fixed-column format v3.3 (counterpart of
atomsmm_tpu/io/pdb.py, which this module copies: it is numpy only).

PDB files serve as coordinate and box sources; topology comes from the
force-field files. Parse ATOM/HETATM records and the CRYST1 box; write
configurations back out for visualization tools.

Units: PDB is in Å; everything returned/accepted here is nm (units.py).
Orthorhombic CRYST1 records return (3,) box lengths; triclinic records
return the reduced (3, 3) cell matrix (rows = lattice vectors, ops/pbc.py)
— both forms run on the dense and cell-list pair paths.

>>> import io, numpy as np
>>> buf = io.StringIO()
>>> write_pdb(buf, np.array([[0.1, 0.2, 0.3]]), box=np.array([2.0, 2.0, 2.0]),
...           atom_name=["O"], residue_name=["WAT"])
>>> pdb = read_pdb(buf.getvalue())
>>> np.round(pdb.positions, 4).tolist()
[[0.1, 0.2, 0.3]]
>>> pdb.box.tolist()
[2.0, 2.0, 2.0]
>>> pdb.atom_name, pdb.residue_name
(['O'], ['WAT'])
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import InputError


@dataclass
class PDBFile:
    """Parsed PDB: coordinates in nm plus per-atom labels."""

    positions: np.ndarray      # (N, 3) [nm], first MODEL only
    box: np.ndarray | None     # (3,) or triclinic (3,3) [nm] from CRYST1
    atom_name: list
    residue_name: list
    residue_id: np.ndarray     # (N,) int
    chain: list
    element: list


def read_pdb(path_or_text) -> PDBFile:
    """Parse ATOM/HETATM records (first MODEL) and the CRYST1 box."""
    text = str(path_or_text)
    if "\n" not in text:
        with open(path_or_text) as fh:
            text = fh.read()
    xyz, names, resnames, resids, chains, elements = [], [], [], [], [], []
    box = None
    for line in text.splitlines():
        rec = line[:6]
        if rec == "CRYST1":
            a, b, c = float(line[6:15]), float(line[15:24]), float(line[24:33])
            angles = [float(line[33:40]), float(line[40:47]), float(line[47:54])]
            if any(abs(t - 90.0) > 1e-6 for t in angles):
                # triclinic: return the reduced (3, 3) cell matrix [nm]
                from ..ops.pbc import triclinic_from_lengths_angles

                box = triclinic_from_lengths_angles(
                    a * 0.1, b * 0.1, c * 0.1, *angles
                )
            else:
                box = np.array([a, b, c]) * 0.1
        elif rec in ("ATOM  ", "HETATM"):
            xyz.append(
                [float(line[30:38]), float(line[38:46]), float(line[46:54])]
            )
            names.append(line[12:16].strip())
            resnames.append(line[17:20].strip())
            rid = line[22:26].strip()
            resids.append(int(rid) if rid else 0)
            chains.append(line[21:22].strip())
            elements.append(line[76:78].strip() if len(line) >= 77 else "")
        elif rec == "ENDMDL":
            break
    if not xyz:
        raise InputError("no ATOM/HETATM records found")
    return PDBFile(
        positions=np.asarray(xyz) * 0.1,
        box=box,
        atom_name=names,
        residue_name=resnames,
        residue_id=np.asarray(resids, np.int32),
        chain=chains,
        element=elements,
    )


def format_cryst1(box) -> str:
    h = np.asarray(box) * 10.0
    if h.ndim == 1:
        a, b, c = h
        al = be = ga = 90.0
    else:  # (3, 3) cell matrix, rows = lattice vectors
        la, lb, lc = (np.linalg.norm(h[i]) for i in range(3))
        ga = np.degrees(np.arccos(np.dot(h[0], h[1]) / (la * lb)))
        be = np.degrees(np.arccos(np.dot(h[0], h[2]) / (la * lc)))
        al = np.degrees(np.arccos(np.dot(h[1], h[2]) / (lb * lc)))
        a, b, c = la, lb, lc
    return (
        f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}{al:7.2f}{be:7.2f}{ga:7.2f}"
        " P 1           1"
    )


def format_model(
    positions, atom_name=None, residue_name=None, residue_id=None,
    element=None, chain=None,
):
    """ATOM record lines for one model; positions (N, 3) in nm.

    Fields are laid out per PDB v3.3 fixed columns: serial 7-11, name 13-16,
    altLoc 17, resName 18-20, chainID 22, resSeq 23-26, iCode 27, x from 31.
    Serials wrap modulo 100000 and resSeq modulo 10000 (OpenMM convention) so
    >99999-atom systems stay monotonic-ish instead of plateauing.
    """
    x = np.asarray(positions) * 10.0
    n = len(x)
    atom_name = atom_name or ["X"] * n
    residue_name = residue_name or ["UNK"] * n
    residue_id = residue_id if residue_id is not None else np.ones(n, int)
    element = element or [str(a)[:1] for a in atom_name]
    chain = chain or ["A"] * n
    lines = []
    for i in range(n):
        name = atom_name[i][:4]
        # PDB convention: 1-3 char names start in column 14
        name_f = f" {name:<3s}" if len(name) < 4 else name
        lines.append(
            f"ATOM  {(i + 1) % 100000:5d} {name_f} {residue_name[i][:3]:<3s} "
            f"{(chain[i] or 'A')[:1]}{int(residue_id[i]) % 10000:4d}    "
            f"{x[i, 0]:8.3f}{x[i, 1]:8.3f}{x[i, 2]:8.3f}{1.0:6.2f}{0.0:6.2f}"
            f"          {element[i][:2]:>2s}"
        )
    return lines


def write_pdb(
    path,
    positions,
    box=None,
    atom_name=None,
    residue_name=None,
    residue_id=None,
    element=None,
    chain=None,
):
    """Write one model. positions (N, 3) in nm; box (3,) in nm."""
    lines = [] if box is None else [format_cryst1(box)]
    lines += format_model(
        positions, atom_name, residue_name, residue_id, element, chain
    )
    lines.append("END")
    out = "\n".join(lines) + "\n"
    if hasattr(path, "write"):
        path.write(out)
    else:
        with open(path, "w") as fh:
            fh.write(out)
