#!/usr/bin/env python3
"""Count what K3's culling (csrc/tile_pair.cu) meets on the 30k-water tile
lists, in the reaction-field forms, float32, with the plain twin's mask:

    python3 k1_ab/tile_groups.py [cpu]

For the far and the near list: the slots of the live entries, the hits
among them (in range, not excluded), the (home atom, group of 32
candidates) pairs, those that hold a hit, and those whose home atom lies
within the cutoff of the group's bounding box (what the kernel goes on to
test). Runs on the CUDA card, or on the CPU when asked (no kernel is
launched; 256 list entries at a time). Prints one JSON line.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def tile_group_counts(form, fs, ms, hb, cb, wrap, box):
    """What K3's culling meets on this list, counted on the device of fs
    with the plain twin's mask: the slots of the live entries, the hits
    among them (in range, not excluded), the (home atom, group of 32
    candidates) pairs, those that hold a hit, and those whose home atom
    lies within the cutoff of the group's bounding box (what the kernel
    goes on to test)."""
    import torch

    from atomsmm_tpu_torch.ops import pair_kernel as pk

    nb1, b, _ = fs.shape
    rc2 = pk._rc2(form.r_cut, fs.dtype)
    live = hb < nb1 - 1
    hbl, cbl, wl = hb[live].long(), cb[live].long(), wrap[live]
    pad = (-2 * b) % 32
    c = {"slots": 0, "hits": 0, "groups": 0, "groups_hit": 0, "groups_box": 0}
    for lo in range(0, hbl.shape[0], 256):
        h, cc, w = hbl[lo:lo + 256], cbl[lo:lo + 256], wl[lo:lo + 256]
        k = h.shape[0]
        home = fs[h][..., :3]                                  # (K, B, 3)
        cand = (fs[cc][..., :3]
                + (w.to(fs.dtype) * box)[:, :, None, :]).reshape(k, 2 * b, 3)
        d = home[:, :, None, :] - cand[:, None, :, :]
        hit = (torch.sum(d * d, dim=-1) < rc2) & ~pk.excluded(
            ms[h][..., 0][:, :, None], ms[cc][..., 0].reshape(k, 1, 2 * b),
            ms[h][..., 1][:, :, None])
        c["slots"] += hit.numel()
        c["hits"] += int(hit.sum())
        # groups of 32 candidates; a ragged last group repeats its first slot
        cg = torch.cat([cand, cand[:, 2 * b - (2 * b) % 32:][:, :1]
                        .expand(k, pad, 3)], dim=1).reshape(k, -1, 32, 3)
        hg = torch.nn.functional.pad(hit, (0, pad)).reshape(k, b, -1, 32)
        lo_, hi_ = cg.amin(dim=2), cg.amax(dim=2)              # (K, G, 3)
        gap = torch.clamp(torch.maximum(lo_[:, None] - home[:, :, None],
                                        home[:, :, None] - hi_[:, None]),
                          min=0.0)
        c["groups"] += hg.shape[0] * hg.shape[1] * hg.shape[2]
        c["groups_hit"] += int(hg.any(dim=-1).sum())
        c["groups_box"] += int((torch.sum(gap * gap, dim=-1) < rc2).sum())
    return c


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from atomsmm_tpu_torch.ops import tilepair as tp

    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda:0")
    d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
    x, box, lists = cs.tile_lists(dev, (d["x"], d["v"], d["box"]),
                                  torch.float32)
    out = {}
    for label, (force, spec, lst, _) in lists.items():
        form = force._pair_form()
        pp = {k: v.to(dev) for k, v in force._per_particle().items()}
        order, hb, cb, wrap, _ = lst
        fs, ms = tp._stage(spec, x, box, pp, spec.excbits, order)
        g = tile_group_counts(form, fs, ms, hb, cb, wrap, box)
        out[label] = {**g, "hit_share": g["hits"] / g["slots"],
                      "groups_hit_share": g["groups_hit"] / g["groups"],
                      "groups_box_share": g["groups_box"] / g["groups"]}
    print(json.dumps({"device": str(dev), "lists": out}), flush=True)


if __name__ == "__main__":
    main()
