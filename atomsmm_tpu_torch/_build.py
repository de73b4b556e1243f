"""Build and load the package's CUDA kernels.

The kernels are plain CUDA C++ with a C interface (``csrc/*.cu``, sharing
the pair forms of ``csrc/pair_forms.cuh``). At first use each source is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``atomsmm_tpu_torch/_build/``, all of them by concurrent ``nvcc``
processes, and loaded with ``ctypes``. A library's file name carries a hash
of its source, every header and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. Nothing here runs at import
time: the CPU tests import the package without ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
#: kernel name -> source; each becomes lib<name>_<hash>.so
KERNELS = {name: CSRC / f"{name}.cu"
           for name in ("half_pair", "cell_pair", "tile_pair")}
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = _HERE / "_build"
# --fmad=false: the kernels round every product and sum as their plain
# twins do (ops/pairfuncs.py, line for line). Contracted into FMAs, the
# float32 near form's energy at config 5's 0.6 nm split (33,334 waters)
# erred by -5.15 kJ/mol and the fused far form's by +5.21, against +0.47 /
# -0.48 for the float32 twin and for the kernels built without contraction
# (k1_ab/rf_bias_variants.py).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: argument kinds of every C entry point: p = pointer, i = int
_SIGNATURES = {
    # + k_rows, then the row strides and the rows' lambda table
    "half_pair": "ppppppppppp" "iiiiiii" "i" "ppppp" "p",
    "cell_pair": "ppppppppppp" "iiiiiiiii" "i" "ppppp" "p",  # + c0, c1
    "tile_pair": "pppppp" "iii" "ppp" "p",
}

_LIBS = {}


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


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (KERNELS[name], *HEADERS):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel whose hashed library is missing, all at once
    (one ``nvcc`` process per source), and return {name: library path}.
    Each compiler's resource report goes to ``<library>.log``."""
    paths = {name: library_path(name) for name in KERNELS}
    todo = {name: so for name, so in paths.items() if not so.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, so in todo.items():
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNELS[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        so = todo[name]
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{KERNELS[name].name} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str):
    """The loaded library of kernel `name` (all kernels are built first if
    needed), with the argument types of its float32 and float64 entry
    points declared."""
    if name in _LIBS:
        return _LIBS[name]
    import ctypes

    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for lib_name, path in build().items():
        lib = ctypes.CDLL(str(path))
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{lib_name}_{suffix}")
            fn.argtypes = [kinds[k] for k in _SIGNATURES[lib_name]]
            fn.restype = ctypes.c_int
        _LIBS[lib_name] = lib
    return _LIBS[name]
