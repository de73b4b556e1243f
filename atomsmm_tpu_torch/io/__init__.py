"""File readers and writers (counterpart of atomsmm_tpu/io/). PDB
coordinates and boxes for now; the AMBER prmtop/inpcrd readers are a later
slice."""
from .pdb import PDBFile, read_pdb, write_pdb

__all__ = [
    "PDBFile",
    "read_pdb",
    "write_pdb",
]
