#!/usr/bin/env python3
"""Which pairs set K4's largest float32 force error at path (o)'s damped far
list (PME, the RESPA far force fused from the unsplit one), at the stored
30k state, on one NVIDIA GPU.

    python3 k1_ab/k4_far_error.py [--small]

K4 (csrc/block_pair.cu) in float32 and the plain twin
(ops/blocks.py::block_pair_plain) in float64 and float32 sweep the same
list. At the atom where K4's force differs most from the float64 twin's,
every pair in range (waters exclude their own molecule alone) is evaluated
by the plain pair form (ops/pairfuncs.py::form_u_dudr2) in float64 and in
float32 twice: with the minimum image of the float32 positions and the
twin's combination rules, and as K4 takes it, in its home block's frame
(ops/blocks.py::block_frames: both atoms staged about the frame's centre)
with the packed sigma / 2 and sqrt(epsilon), and the minimum image
where that frame is not exact. Prints one JSON line: the
largest errors of K4 and of the float32 twin, the worst atom's error, the
per-pair sums beside K4's row, the pairs that flip across the cutoff in
float32, and the pairs of largest float32 error with their distance and
atom kinds (O, H). ``--small`` runs 400 waters on the CPU (the twin in
place of K4) to try the script.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import blocks as blk
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs
    from atomsmm_tpu_torch.ops.pairfuncs import form_u_dudr2
    from atomsmm_tpu_torch.ops.pbc import minimum_image

    small = "--small" in sys.argv
    f32, f64 = torch.float32, torch.float64
    if small:
        dev = torch.device("cpu")
        system, x0, box0 = water_system(n_molecules=400, method="pme",
                                        neighbors="blocks", dtype=f64,
                                        device=dev)
        ex, ebox = x0.numpy(), box0.numpy()
        card = "cpu"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("k4_far_error.py needs a CUDA card (or --small)")
        import chip_smoke as cs

        dev = torch.device("cuda", 0)
        d = np.load(os.path.join(ROOT, "bench_data", "eq_water30k.npz"))
        ex, ebox = d["x"], d["box"]
        system, _, _ = water_system(n_molecules=10000, method="pme",
                                    neighbors="blocks", dtype=f32,
                                    device=dev)
        card = cs.smi_line()
    respa = retune_neighbor_specs(
        amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4), ex, ebox)
    far, spec = respa.forces[2], respa.neighbors
    form, r_cut = far._pair_form(), far._pair_form().r_cut
    x32 = torch.as_tensor(ex, dtype=f32, device=dev).contiguous()
    box32 = torch.as_tensor(ebox, dtype=f32, device=dev)
    x64, box64 = x32.to(f64), box32.to(f64)
    pp64 = {k: v.to(dev, f64) for k, v in far._per_particle().items()}
    pp32 = {k: v.to(f32).contiguous() for k, v in pp64.items()}
    order, cand, _ = blk.build_block_lists(spec, x32, box32)
    n, b = x32.shape[0], spec.block_size

    k4 = blk.block_pair_rows(form, x32, box32, pp32, spec, order, cand,
                             r_cut)[:-1, :3].double()
    ref = blk.block_pair_plain(x64, pp64, order, cand, spec, box64, form,
                               r_cut)[:-1, :3]
    twin32 = blk.block_pair_plain(x32, pp32, order, cand, spec, box32, form,
                                  r_cut)[:-1, :3].double()
    unsplit = float(blk.block_pair_plain(
        x64, pp64, order, cand, spec, box64, far.full._pair_form(),
        r_cut)[:-1, :3].abs().max())
    err_k4 = (k4 - ref).abs().amax(dim=1)
    err_twin = (twin32 - ref).abs().amax(dim=1)
    a = int(err_k4.argmax())

    # every pair of atom a in range: j, its displacement a - j
    slot = torch.empty(n, dtype=torch.long, device=dev)
    real = order < n
    slot[order[real].long()] = torch.nonzero(real).reshape(-1)
    blk_of = slot // b
    others = torch.arange(n, device=dev)
    d64 = minimum_image(x64[a] - x64, box64)
    r2_64 = (d64 * d64).sum(-1)
    rc2_64, rc2_32 = r_cut ** 2, torch.tensor(r_cut ** 2, dtype=f32)
    mine = (others // 3 != a // 3)
    d32 = minimum_image(x32[a] - x32, box32)
    r2_32 = (d32 * d32).sum(-1)
    # K4's frame: the home block of pair (a, j) is the one whose row lists
    # the other's block (each block pair once), its centre the frame's
    ctr, _, exact = blk.block_frames(x32, box32, order.reshape(-1, b), r_cut)
    ba, bj = blk_of[a], blk_of
    lists = (cand[ba].long()[None, :] == bj[:, None]).any(dim=1)
    home = torch.where(lists, ba.expand_as(bj), bj)
    c = ctr[home]
    sa = c + minimum_image(x32[a] - c, box32)
    sj = c + minimum_image(x32 - c, box32)
    # where the frame is not exact, K4 images each slot
    dfr = torch.where(exact[home][:, None], sa - sj,
                      minimum_image(sa - sj, box32))
    r2_fr = (dfr * dfr).sum(-1)
    in64 = mine & (r2_64 < rc2_64)
    in32 = mine & (r2_32 < rc2_32.item())
    infr = mine & (r2_fr < rc2_32.item())
    pick = torch.nonzero(in64 | in32 | infr).reshape(-1)

    def force(d, r2, q, s, e, inside):
        u, dudr2 = form_u_dudr2(form, torch.where(inside, r2,
                                                  torch.ones_like(r2)),
                                q, s, e)
        g = torch.where(inside, -2.0 * dudr2, torch.zeros_like(dudr2))
        return (g[:, None] * d).double()

    p64 = {k: v[pick] for k, v in pp64.items()}
    p32 = {k: v[pick] for k, v in pp32.items()}
    f_64 = force(d64[pick], r2_64[pick], pp64["charge"][a] * p64["charge"],
                 0.5 * (pp64["sigma"][a] + p64["sigma"]),
                 torch.sqrt(pp64["epsilon"][a] * p64["epsilon"]), in64[pick])
    f_plain = force(d32[pick], r2_32[pick],
                    pp32["charge"][a] * p32["charge"],
                    0.5 * (pp32["sigma"][a] + p32["sigma"]),
                    torch.sqrt(pp32["epsilon"][a] * p32["epsilon"]),
                    in32[pick])
    f_frame = force(dfr[pick], r2_fr[pick],
                    pp32["charge"][a] * p32["charge"],
                    0.5 * pp32["sigma"][a] + 0.5 * p32["sigma"],
                    torch.sqrt(pp32["epsilon"][a]) * torch.sqrt(
                        p32["epsilon"]), infr[pick])
    e_plain = (f_plain - f_64).abs().amax(dim=1)
    e_frame = (f_frame - f_64).abs().amax(dim=1)
    top = torch.argsort(e_frame, descending=True)[:5].tolist()
    kind = "OHH"
    pairs = [{"j": int(pick[i]),
              "kinds": kind[a % 3] + kind[int(pick[i]) % 3],
              "r_nm": float(r2_64[pick[i]].sqrt()),
              "f64_abs": float(f_64[i].abs().max()),
              "err_frame": float(e_frame[i]), "err_plain": float(e_plain[i]),
              "same_block": bool(blk_of[pick[i]] == ba),
              "frame_exact": bool(exact[home[pick[i]]])} for i in top]
    flips = [{"j": int(j), "r_nm": float(r2_64[j].sqrt()),
              "in_f64": bool(in64[j]), "in_f32_plain": bool(in32[j]),
              "in_f32_frame": bool(infr[j])}
             for j in pick.tolist() if not (in64[j] == in32[j] == infr[j])]
    print(json.dumps({
        "card": card, "n": n, "r_cut": r_cut,
        "k4_max_err": float(err_k4.max()),
        "twin32_max_err": float(err_twin.max()),
        "unsplit_max_f": unsplit,
        "atom": a, "atom_kind": kind[a % 3],
        "atom_err_k4": float(err_k4[a]), "atom_err_twin32": float(err_twin[a]),
        "atom_ref_f": ref[a].tolist(),
        "pairs_in_range": int(in64.sum()),
        "sum_f64_vs_ref": float((f_64.sum(0) - ref[a]).abs().max()),
        "sum_frame_err": float((f_frame.sum(0) - ref[a]).abs().max()),
        "sum_plain_err": float((f_plain.sum(0) - ref[a]).abs().max()),
        "sum_frame_vs_k4": float((f_frame.sum(0) - k4[a]).abs().max()),
        "flips": flips, "top_pairs": pairs}), flush=True)


if __name__ == "__main__":
    main()
