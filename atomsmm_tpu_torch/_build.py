"""Build and load the package's CUDA kernels.

The kernels are plain CUDA C++ with a C interface (``csrc/*.cu``, sharing
the pair forms of ``csrc/pair_forms.cuh``). At first use each source is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``atomsmm_tpu_torch/_build/``, all of them by concurrent ``nvcc``
processes, and loaded with ``ctypes``. A library's file name carries a hash
of its source, every header and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. Nothing here runs at import
time: the CPU tests import the package without ``nvcc``.

A user pair function (CustomNonbondedForce, lowered by ops/pairtrace.py)
is compiled into K1, K2 or K3 at its first use by ``build_user``: one
library per (kernel, generated header, exclusion form, image), from a
wrapper source that includes the header and the kernel's source, which
then instantiates its user form alone (entry point ``half_pair_user``,
``cell_pair_user`` or ``tile_pair_user``) and none of its built-in ones.
K3 takes the bitmask and the (3,) box alone, so its library is one per
(header), built with exclusion form 0 and image 0. Its name hashes the
kernel's source, every header, the flags, the generated header and the
instantiation, so a changed function never loads a stale library.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
#: kernel name -> source; each becomes lib<name>_<hash>.so
KERNELS = {name: CSRC / f"{name}.cu"
           for name in ("half_pair", "cell_pair", "tile_pair", "block_pair")}
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
    # + the packed copy and the work scratch
    "block_pair": "ppppppppp" "iiiii" "ppp" "pp" "p",
}

#: the user entry points (K1 and K2: after x, cols, then the built-in
#: entry point's exclusions, bucket, map, box and sizes, then ncols,
#: nconsts, consts, dconst, k_rows and the host array of the rows'
#: strides, scal, flags, out, stream; K3: the built-in entry point's
#: arrays and sizes, then ncols, nconsts, consts, dconst, scal, flags,
#: acc, stream)
_USER_SIGNATURES = {
    "half_pair": "ppppppp" "iiiii" "ii" "pi" "ip" "ppp" "p",
    "cell_pair": "ppppppp" "iiiiiii" "ii" "pi" "ip" "ppp" "p",  # + c0, c1
    "tile_pair": "pppppp" "iii" "ii" "pi" "ppp" "p",
}

_LIBS = {}
_USER_LIBS = {}


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


def _digest(name: str, extra: str = "") -> str:
    """A hash of kernel `name`'s source, every header, the flags and
    `extra`."""
    h = hashlib.sha256()
    for src in (KERNELS[name], *HEADERS):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(extra.encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def _compile(todo: dict):
    """Run one ``nvcc`` for each {library path: source} at once, each into
    a temporary file moved into place when it succeeds; each compiler's
    resource report goes to ``<library>.log``. Raises if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for so, src in todo.items():
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        procs[so] = (tmp, src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for so, (tmp, src, proc) in procs.items():
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build() -> dict:
    """Compile every kernel whose hashed library is missing, all at once
    (one ``nvcc`` process per source), and return {name: library path}."""
    paths = {name: library_path(name) for name in KERNELS}
    todo = {so: KERNELS[name] for name, so in paths.items()
            if not so.exists()}
    if todo:
        _compile(todo)
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


def _write_whole(path: Path, text: str):
    """Write `text` to a file of its own beside `path`, then move it onto
    `path`: a reader sees the old file or the new one, never a part."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name,
                               suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def user_library_path(name: str, header: str, exc: int, tri: int) -> Path:
    """The library of kernel `name` (half_pair, cell_pair or tile_pair)
    compiled with the generated user-form header `header` for the
    exclusion form `exc` (0 bits, 1 split) and the image `tri` (0 the (3,)
    box, 1 the (3, 3) cell; K3 takes 0 and 0)."""
    key = _digest(name, f"{header} exc={exc} tri={tri}")
    return BUILD_DIR / f"lib{name}_user_{key}.so"


def build_user(jobs) -> list:
    """Compile the user-form libraries of `jobs`, each (kernel name,
    header text, exc, tri), that are missing, all at once (one ``nvcc``
    each), and return their paths in order. Raises if one fails. The
    generated sources are written whole and moved into place, so that
    processes building one library at once never read a part-written
    source."""
    paths = [user_library_path(*job) for job in jobs]
    todo = {}
    for (name, header, exc, tri), so in zip(jobs, paths):
        if so.exists() or so in todo:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = so.stem[3:]
        _write_whole(BUILD_DIR / f"{stem}.cuh", header)
        todo[so] = BUILD_DIR / f"{stem}.cu"
        _write_whole(todo[so],
                     f"// {name} with the user form of {stem}.cuh, exclusion "
                     f"form {exc}, image {tri}\n"
                     f'#include "{stem}.cuh"\n'
                     f"#define ATOMSMM_USER_EXC {int(exc)}\n"
                     f"#define ATOMSMM_USER_TRI {int(tri)}\n"
                     f'#include "{KERNELS[name].name}"\n')
    if todo:
        _compile(todo)
    return paths


def load_user(name: str, header: str, exc: int, tri: int):
    """The user entry point (``<name>_user``) of kernel `name` compiled
    with `header` for (exc, tri), built first if needed."""
    key = (name, header, int(exc), int(tri))
    if key in _USER_LIBS:
        return _USER_LIBS[key]
    import ctypes

    (path,) = build_user([key])
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    fn = getattr(ctypes.CDLL(str(path)), f"{name}_user")
    fn.argtypes = [kinds[k] for k in _USER_SIGNATURES[name]]
    fn.restype = ctypes.c_int
    _USER_LIBS[key] = fn
    return fn
