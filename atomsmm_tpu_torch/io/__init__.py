"""File readers and writers (counterpart of atomsmm_tpu/io/): the AMBER
prmtop/inpcrd readers (io/amber.py) and PDB coordinates and boxes."""
from .amber import AmberPrmtop, amber_system, read_inpcrd, read_prmtop
from .pdb import PDBFile, read_pdb, write_pdb

__all__ = [
    "AmberPrmtop",
    "PDBFile",
    "amber_system",
    "read_inpcrd",
    "read_prmtop",
    "read_pdb",
    "write_pdb",
]
