#!/usr/bin/env python3
"""Which float32 operation of the shared pair forms (csrc/pair_forms.cuh)
biases K1's and K2's reaction-field energy at config 5's grids.

    python3 k1_ab/rf_bias_variants.py [VARIANT ...]

Each variant is a copy of the kernel sources under k1_ab/_variants/
(git-ignored), built in its own process:

  as_is            the sources and nvcc flags as they are (_build.py:
                   --fmad=false, no a*b + c contracted into an FMA)
  fma              nvcc --fmad=true, nvcc's default, as the kernels were
                   built before
  exact_rsqrt      as_is, with rsqrt_t(float) returning 1.0f / sqrtf(x),
                   correctly rounded, in place of the approximate rsqrtf
  fma_exact_rsqrt  the two changes together

For each it runs chip_smoke.py::rf_rows at path (f)'s far and near grids
(33,334 waters from bench_data/eq_water100k.npz, RESPASystem(0.6, 0.5)),
which prints K1's, K2's and the float32 plain twin's per-atom rows and
sums against the float64 twin, and then one JSON line per variant:
{variant: {grid: {K1|K2|twin32: float32 sum - twin sum}}} in kJ/mol.
Needs a CUDA card.
"""
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
VARIANTS = ("as_is", "fma", "exact_rsqrt", "fma_exact_rsqrt")
RSQRT = "__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }"
EXACT = ("__device__ __forceinline__ float rsqrt_t(float x) "
         "{ return 1.0f / sqrtf(x); }")


def run_variant(name):
    from pathlib import Path

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from atomsmm_tpu_torch import _build

    vdir = Path(HERE) / "_variants" / name
    if vdir.exists():
        shutil.rmtree(vdir)
    shutil.copytree(_build.CSRC, vdir)
    if name.endswith("exact_rsqrt"):
        header = vdir / "pair_forms.cuh"
        text = header.read_text()
        if RSQRT not in text:
            raise RuntimeError("rsqrt_t(float) not found in pair_forms.cuh")
        header.write_text(text.replace(RSQRT, EXACT))
    if name.startswith("fma"):
        _build.NVCC_FLAGS = tuple(f for f in _build.NVCC_FLAGS
                                  if not f.startswith("--fmad")) \
            + ("--fmad=true",)
    _build.KERNELS = {k: vdir / f"{k}.cu" for k in _build.KERNELS}
    _build.HEADERS = tuple(sorted(vdir.glob("*.cuh")))
    _build.BUILD_DIR = vdir / "_build"
    for k in _build.build():
        _build.load(k)

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water100k.npz"))
    respa, x, _, box = cs.npt_water(dev, "cutoff", (d["x"], d["v"], d["box"]))
    near_f, far_f = cs.pair_forces(respa)
    out = {}
    for grid, force, spec in (
            ("far", far_f, respa.neighbors),
            ("near", near_f, respa.extra_neighbor_specs["near"])):
        r = cs.rf_rows(f"water100k {grid} [{name}]", force, spec, x, box,
                       dev)
        out[grid] = {k: v[4] - v[5] for k, v in r.items()}
    print(json.dumps({name: out}), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_variant(sys.argv[2])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rf_bias_variants.py needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(cs.smi_line(), flush=True)
    for name in sys.argv[1:] or VARIANTS:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}: {VARIANTS}")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        name], check=True)


if __name__ == "__main__":
    main()
