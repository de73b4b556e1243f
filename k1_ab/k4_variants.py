#!/usr/bin/env python3
"""Where K4's time goes (csrc/block_pair.cu): time copies of the kernel
with one part taken out, at path (o)'s far and near block lists at the
stored 30k state (``chip_smoke.py::block_headline``, float32, RF), on one
NVIDIA GPU.

    python3 k1_ab/k4_variants.py [VARIANT ...]

Each variant is a copy of the kernel sources under k1_ab/_variants/
(git-ignored) with one edit; all are built at once (an ``nvcc`` each),
then each is timed in its own process. Parts taken out:

  as_is          the sources as they are
  no_reduction   the reactions are not added to the output
  no_pair_form   a few products in place of the pair form
  no_evaluation  no hit is evaluated
  no_slot_tests  no slot is tested (so none is evaluated either)
  one_candidate  items of one candidate block (CHUNK = 1) in place of two

and the simpler designs each part of K4 was chosen over, each computing
the sweep:

  static_stride     thread block i takes items i, i + grid, ... in place
                    of claiming the next by an atomic counter
  plain_grid        a thread block per item (a grid of NB ceil(K / CHUNK),
                    the blocks past the live items leaving at once) in
                    place of the persistent grid
  direct_loads      each block copied from the packed copy by the threads
                    (16-byte loads, then a barrier) when the item needs it,
                    in place of bulk copies issued up to a ring ahead
  ring_one_item     a ring of one item (CHUNK + 1 buffers): the next
                    item's copies start only once this item is done
  shared_reactions  the reactions summed in shared rows of the item's
                    candidate atoms (float atomics there) and added to the
                    output once an item, in place of L2 reductions a hit

The part-taken-out variants give wrong forces on purpose and are read only
for their time, each against ``as_is`` of the same call. Prints the card
and one JSON line per variant: K4's and the pack kernel's profiler device
time (ms) per list, and its largest force difference from the float32
plain twin there (the designs that compute the sweep differ only in the
order of their float32 sums).
"""
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

EVALUATE = "  auto evaluate = [&](unsigned code) {\n"
CLAIM = "atomicAdd(work, 1)"
STATIC = [("  int* work = counters(a) + 1;\n",
           "  int* work = counters(a) + 1;\n  int stride_next = blockIdx.x;\n"),
          (CLAIM, "((stride_next += gridDim.x) - gridDim.x)")]
LANDED = "    ++consumed;\n"
DIRECT_COPY = """    {
      const int mv = meta[s];
      if (mv != END) {
        const int blk = mv < 0 ? ((~mv) & 0xffffff) : mv;
        const int4* src =
            reinterpret_cast<const int4*>(a.packed + (size_t)blk * elem);
        int4* dst = reinterpret_cast<int4*>(ring + (size_t)s * elem);
        for (int i = t; i < (int)(elem / 16); i += THREADS) dst[i] = src[i];
      }
      __syncthreads();
    }
"""
LAST_EVAL = ("      evaluate(m0 + lane < left ? merged[m0 + lane] : NO_HIT);\n"
             "    }\n")
REACTION_FLUSH = """    __syncthreads();
    for (int sv = t; sv < CHUNK * span; sv += THREADS) {
      const bool second = sv >= span;
      const int v = second ? sv - span : sv;
      if (v < b && (second ? 1 : 0) < nc) {
        T* row = crow + 4 * sv;
        const int id = (second ? cpos1 : cpos0)[v].id;
        if (id < n && (row[0] != T(0) || row[1] != T(0) || row[2] != T(0))) {
          add_row(a.out + (size_t)id * 4, row[0], row[1], row[2], T(0));
        }
        row[0] = T(0);
        row[1] = T(0);
        row[2] = T(0);
      }
    }
"""
VARIANTS = {
    "as_is": [],
    "no_reduction": [("      atomicAdd(row, gx);\n"
                      "      atomicAdd(row + 1, gy);\n"
                      "      atomicAdd(row + 2, gz);\n", "")],
    "no_pair_form": [("      pair_form<T, DAMPED>(p, r2, hq.q * cq.q, "
                      "hq.s + cq.s, hq.e * cq.e, se,\n"
                      "                           dudr2);\n",
                      "      se = hq.q * cq.q;\n"
                      "      dudr2 = r2 * (hq.s + cq.s) * hq.e * cq.e;\n")],
    "no_evaluation": [(EVALUATE, EVALUATE
                       + "    if (code != 0x12345u) return;\n")],
    "no_slot_tests": [("    for (int e0 = 0; e0 < total; "
                       "e0 += 32 / GROUP) {",
                       "    for (int e0 = 0; e0 < 0 * total; "
                       "e0 += 32 / GROUP) {")],
    "one_candidate": [("constexpr int CHUNK = 2;", "constexpr int CHUNK = 1;")],
    "static_stride": STATIC,
    "plain_grid": STATIC + [(
        "  const int grid = sms * per_sm;\n",
        "  const int grid = args.nb * ((args.k + CHUNK - 1) / CHUNK);\n")],
    "direct_loads": [
        ("      bulk_load(ring + (size_t)s * elem, a.packed + (size_t)blk * "
         "elem, elem,\n                &bars[s]);\n",
         "      mbar_arrive(&bars[s]);\n"),
        (LANDED, LANDED + DIRECT_COPY)],
    "ring_one_item": [("return sizeof(T) == 4 ? 6 : 4;", "return CHUNK + 1;")],
    "shared_reactions": [
        ("  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);\n",
         "  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);\n"
         "  __shared__ T crow[CHUNK * MAX_B * 4];\n"),
        ("hs_all[i] = T(0);\n",
         "hs_all[i] = T(0);\n"
         "  for (int i = t; i < CHUNK * MAX_B * 4; i += THREADS) "
         "crow[i] = T(0);\n"),
        ("      T* row = a.out + (size_t)cj.id * 4;\n",
         "      T* row = crow + 4 * ((second ? span : 0) + v);\n"),
        (LAST_EVAL, LAST_EVAL + REACTION_FLUSH)],
}


def variant_dir(name):
    return os.path.join(HERE, "_variants", f"k4_{name}")


def prepare(name):
    """The variant's copy of the kernel sources, its edits made."""
    sys.path.insert(0, ROOT)
    from atomsmm_tpu_torch import _build

    vdir = variant_dir(name)
    if os.path.exists(vdir):
        shutil.rmtree(vdir)
    shutil.copytree(_build.CSRC, vdir)
    src = os.path.join(vdir, "block_pair.cu")
    with open(src) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: edit not found in block_pair.cu")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)


def use_variant(name):
    """Point the package's build at the variant's K4 source alone, built
    (if it is not yet) into the variant's own directory."""
    from pathlib import Path

    sys.path.insert(0, ROOT)
    from atomsmm_tpu_torch import _build

    vdir = Path(variant_dir(name))
    _build.KERNELS = {"block_pair": vdir / "block_pair.cu"}
    _build.HEADERS = tuple(sorted(vdir.glob("*.cuh")))
    _build.BUILD_DIR = vdir / "_build"
    return _build.build()


def run_variant(name):
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from atomsmm_tpu_torch import _build

    use_variant(name)
    _build.load("block_pair")

    import chip_smoke as cs
    from atomsmm_tpu_torch.ops import blocks as blk

    dev = torch.device("cuda", 0)
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
    respa = cs.block_headline(dev, (d["x"], d["v"], d["box"]))
    x = torch.as_tensor(d["x"], dtype=torch.float32, device=dev).contiguous()
    box = torch.as_tensor(d["box"], dtype=torch.float32, device=dev)
    out = {}
    for label, force, spec in (
            ("far", respa.forces[2], respa.neighbors),
            ("near", respa.forces[1], respa.extra_neighbor_specs["near"])):
        form = force._pair_form()
        pp = {k: v.to(dev, torch.float32).contiguous()
              for k, v in force._per_particle().items()}
        order, cand, _ = blk.build_block_lists(spec, x, box)

        def sweep():
            return blk.block_pair_energy_forces(form, x, box, pp, spec,
                                                order, cand, form.r_cut)

        rows = blk.block_pair_cuda(x, pp, order, cand, spec, box, form,
                                   form.r_cut)
        ref = blk.block_pair_plain(x, pp, order, cand, spec, box, form,
                                   form.r_cut)
        out[label] = {
            "k4_ms": cs.kernel_device_ms(sweep, "block_pair", 50),
            "pack_ms": cs.kernel_device_ms(sweep, "block_pair_pack", 50),
            "max_abs_err_vs_twin": float((rows - ref)[:-1, :3].abs().max())}
    print(json.dumps({name: out}), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_variant(sys.argv[2])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--build":
        use_variant(sys.argv[2])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k4_variants.py needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(cs.smi_line(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}: {list(VARIANTS)}")
    me = os.path.abspath(__file__)
    for name in dict.fromkeys(names):
        prepare(name)
    builds = [subprocess.Popen([sys.executable, me, "--build", name])
              for name in dict.fromkeys(names)]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a variant failed to build")
    for name in names:
        subprocess.run([sys.executable, me, "--one", name], check=True)


if __name__ == "__main__":
    main()
