#!/usr/bin/env python3
"""Count what K4 (csrc/block_pair.cu) meets on path (o)'s block lists:
for the far list (0.9 nm cutoff, r_build 1.0 nm) and the near list
(0.5 nm, 0.6 nm) of the 30k-water headline on block lists at the stored
state (``chip_smoke.py::block_headline``, float32), the live slots (home
atom x candidate atom over every listed block pair), the hits (pairs in
range and not excluded, each once) and, for each way of cutting a staged
candidate block into groups, the (home atom, group) pairs whose group box
the home atom can reach and the slots those leave to test:

  * ``g32_list``: 32-atom groups in list order;
  * ``g8_list``: 8-atom groups in list order;
  * ``g8_morton``: 8-atom groups after ordering each block by the Morton
    codes of a 4^3 grid over the block's box;
  * ``g8_serpentine``: the same with a serpentine walk of the 4^3 grid,
    the pack kernel's in-block order (ops/blocks.py::packed_order).

The reach test is K4's: each home block's frame (ops/blocks.py::
block_frames), the candidates staged about its centre, each group's box
over its real atoms, and the point-to-box distance against 1.0001 r_c^2,
with the minimum image of the distance to the box centre where the frame
is not exact.

    python3 k1_ab/block_groups.py            # on the card, path (o)'s lists
    python3 k1_ab/block_groups.py cpu [N]    # on the CPU, N waters (default
                                             # 1000) at their lattice start

Prints one JSON line (the device, and per list the counts). Counting runs
on whichever device it is given; it times nothing.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CHUNK = 8  # home blocks at a time


def morton_order(x, box, order, block_size):
    """packed_order's in-block order with the Morton codes of the 4^3 grid
    (bit k of x, y, z at 3k + 2, 3k + 1, 3k) in place of its serpentine
    walk."""
    import torch

    from atomsmm_tpu_torch.ops.pbc import minimum_image

    n = x.shape[0]
    ids = order.reshape(-1, block_size).long()
    real = ids < n
    xp = torch.cat([x, x.new_zeros((1, 3))])
    ref = xp[ids[:, :1]]
    local = ref + minimum_image(xp[ids] - ref, box)
    big = torch.as_tensor(1e30, dtype=x.dtype, device=x.device)
    lo = torch.where(real[..., None], local, big).amin(dim=1, keepdim=True)
    hi = torch.where(real[..., None], local, -big).amax(dim=1, keepdim=True)
    span = hi - lo
    scale = torch.where(span > 0, 4.0 / torch.where(span > 0, span, 1.0),
                        torch.zeros_like(span))
    cell = torch.clamp(((local - lo) * scale).to(torch.int64), 0, 3)
    key = torch.zeros_like(ids)
    for bit in range(2):
        for dim in range(3):
            key |= ((cell[..., dim] >> bit) & 1) << (3 * bit + 2 - dim)
    key = torch.where(real, key, torch.full_like(key, 64))
    perm = torch.argsort(key, dim=1, stable=True)
    return torch.gather(ids, 1, perm).reshape(-1).to(order.dtype)


def count(spec, x, box, order, cand, r_cut, names=None, hits=True):
    """The counts of one list (the module docstring), for the groupings
    `names` (default: all four), the hits only with `hits`."""
    import torch

    from atomsmm_tpu_torch.ops import blocks as blk
    from atomsmm_tpu_torch.ops.pair_kernel import _rc2, excluded
    from atomsmm_tpu_torch.ops.pbc import minimum_image

    n = x.shape[0]
    b, nb = spec.block_size, spec.n_blocks
    rc2 = _rc2(r_cut, x.dtype)
    wide = rc2 * 1.0001
    xp = torch.cat([x, x.new_zeros((1, 3))])
    groupings = {
        "g32_list": (32, order),
        "g8_list": (8, order),
        "g8_morton": (8, morton_order(x, box, order, b)),
        "g8_serpentine": (8, blk.packed_order(x, box, order, b)),
    }
    if names is not None:
        groupings = {name: groupings[name] for name in names}
    out = {"blocks": nb, "block_size": b, "K": int(cand.shape[1]),
           "block_pairs": int((cand >= 0).sum()), "live_slots": 0,
           "real_slots": 0, "hits": 0, "exact_frames": 0}
    for name in groupings:
        out[name] = {"reached_groups": 0, "tested_slots": 0}
    bits = spec.excbits
    far = spec.exclusions_far
    for lo in range(0, nb, CHUNK):
        hb = torch.arange(lo, min(lo + CHUNK, nb), device=x.device)
        cj = cand[hb].long()                                   # (C, K)
        valid = cj >= 0
        cjc = torch.where(valid, cj, torch.zeros_like(cj))
        for gi, (name, (g, ids_all)) in enumerate(groupings.items()):
            ids = ids_all.reshape(nb, b).long()
            hid = ids[hb]                                      # (C, B)
            # the frame as the pack kernel takes it, from the list order;
            # the home atoms staged in it in this grouping's order
            ctr, _, exact = blk.block_frames(
                x, box, order.reshape(nb, b).long()[hb], r_cut)
            staged_h = ctr[:, None] + minimum_image(xp[hid] - ctr[:, None],
                                                    box)
            cid = torch.where(valid[..., None], ids[cjc],
                              torch.full_like(ids[cjc], n))    # (C, K, B)
            creal = cid < n
            sc = ctr[:, None, None] + minimum_image(
                xp[cid] - ctr[:, None, None], box)             # (C, K, B, 3)
            hreal = hid < n
            if gi == 0:
                out["exact_frames"] += int(exact.sum())
                out["live_slots"] += int(valid.sum()) * b * b
            if gi == 0 and hits:
                out["real_slots"] += int((hreal.sum(1) * creal.sum((1, 2)))
                                         .sum())
                d = minimum_image(xp[hid][:, :, None, None]
                                  - xp[cid][:, None], box)     # (C,B,K,B,3)
                r2 = (d * d).sum(-1)
                h3 = hid[:, :, None, None]
                c3 = cid[:, None]
                far_h = None if far is None else torch.cat(
                    [far, far.new_full((1, far.shape[1]), -1)])[h3]
                hit = (hreal[:, :, None, None] & creal[:, None]
                       & (r2 < rc2) & ~excluded(h3, c3, bits[h3], far_h))
                # the self block once: the candidate behind the home atom
                slot_j = torch.arange(b, device=x.device)
                is_self = (cjc == hb[:, None]) & valid         # (C, K)
                behind = slot_j[None, :] > slot_j[:, None]     # (B, B)
                keep = ~is_self[:, None, :, None] | behind[None, :, None, :]
                out["hits"] += int((hit & keep).sum())
            ng = -(-b // g)
            pad = ng * g - b
            scp = torch.nn.functional.pad(sc, (0, 0, 0, pad))
            crp = torch.nn.functional.pad(creal, (0, pad))
            scg = scp.reshape(sc.shape[:2] + (ng, g, 3))
            crg = crp.reshape(creal.shape[:2] + (ng, g))
            big = torch.as_tensor(1e30, dtype=x.dtype, device=x.device)
            glo = torch.where(crg[..., None], scg, big).amin(dim=3)
            ghi = torch.where(crg[..., None], scg, -big).amax(dim=3)
            gany = crg.any(dim=3)                              # (C, K, G)
            gc, ge = 0.5 * (glo + ghi), 0.5 * (ghi - glo)
            dd = staged_h[:, :, None, None] - gc[:, None]      # (C,B,K,G,3)
            dd = torch.where(exact[:, None, None, None, None], dd,
                             minimum_image(dd, box))
            gap = torch.clamp(dd.abs() - ge[:, None], min=0.0)
            reach = ((gap * gap).sum(-1) < wide) & gany[:, None] \
                & hreal[:, :, None, None] & valid[:, None, :, None]
            reached = int(reach.sum())
            out[name]["reached_groups"] += reached
            out[name]["tested_slots"] += reached * g
    for name in groupings:
        out[name]["share_of_live"] = (out[name]["tested_slots"]
                                      / max(out["live_slots"], 1))
    return out


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    on_cpu = len(sys.argv) > 1 and sys.argv[1] == "cpu"
    from atomsmm_tpu_torch.ops import blocks as blk

    f32 = torch.float32
    if on_cpu:
        import atomsmm_tpu_torch as amm
        from atomsmm_tpu_torch.models import water_system
        from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

        n_mol = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
        dev = torch.device("cpu")
        system, x0, box0 = water_system(n_molecules=n_mol,
                                        neighbors="blocks", dtype=f32,
                                        device=dev)
        respa = amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
        respa = retune_neighbor_specs(respa, x0, box0)
        x, box = x0.contiguous(), box0
        where = {"device": "cpu", "waters": n_mol, "state": "lattice start"}
    else:
        import chip_smoke as cs

        if not torch.cuda.is_available():
            raise SystemExit("block_groups.py needs a CUDA card, or 'cpu'")
        dev = torch.device("cuda", 0)
        d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
        eq = (d["x"], d["v"], d["box"])
        respa = cs.block_headline(dev, eq)
        x = torch.as_tensor(d["x"], dtype=f32, device=dev).contiguous()
        box = torch.as_tensor(d["box"], dtype=f32, device=dev)
        where = {"device": torch.cuda.get_device_name(0),
                 "card": cs.smi_line(), "waters": 10000,
                 "state": "bench_data/eq_water30k.npz"}
    lists = {}
    for label, spec, force in (
            ("far", respa.neighbors, respa.forces[2]),
            ("near", respa.extra_neighbor_specs["near"], respa.forces[1])):
        order, cand, _ = blk.build_block_lists(spec, x, box)
        lists[label] = count(spec, x.double(), box.double(), order, cand,
                             force._pair_form().r_cut)
    print(json.dumps({**where, "lists": lists}), flush=True)


if __name__ == "__main__":
    main()
