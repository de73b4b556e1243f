"""Build and load the package's CUDA kernels.

The kernels are plain CUDA C++ with a C interface (``csrc/*.cu``). At first
use they are compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``atomsmm_tpu_torch/_build/`` and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs at
import time: the CPU tests import the package without ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "half_pair.cu",)
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's standard home
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of atomsmm_tpu_torch "
        "are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"atomsmm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the hashed library unless it exists; the
    compiler's resource report goes to ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True, text=True,
    )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library (built first if needed), with the argument
    types of every entry point declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    import ctypes

    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("half_pair_f32", "half_pair_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp]
        fn.restype = ci
    _LIB = lib
    return lib
