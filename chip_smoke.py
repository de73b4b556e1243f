#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atomsmm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, one line each or more; any failure raises and the script exits
non-zero:

1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles csrc/half_pair.cu (K1), csrc/cell_pair.cu (K2) and
   csrc/tile_pair.cu (K3) with nvcc (sm_90a) from the checkout, one nvcc
   per source, all at once;
3. kernels against their plain PyTorch twins on the card. float64 kernel
   vs float64 plain: energy rtol 1e-10, forces atol 1e-9 x max|F| (the
   logic). float32 kernel vs float64 plain on the same f32 inputs: energy
   rtol 1e-4, forces atol 1e-4 x max|F| (f32 cancellation in full - near at
   short range, rsqrt rounding, summation order); the fused damped far form
   scales its float32 force tolerance with the unsplit full force's max|F|
   (the truncated Ewald term jumps at the float32-rounded cutoff);
   - K1: argon 864, water 400 (full cutoff-RF, RESPA near and fused far),
     the 30k equilibrated state's near and far grids, an atom crossing the
     periodic face between rebuilds, water 400 renumbered so that no
     exclusion bitmask fits (the exclusion-column form), and water 2744 at
     1.4 nm (cells above 256 atoms: blocks above 256 threads, several
     128-slot chunks per candidate partition);
   - K2: water 216 (one cell of 1,112 slots), the water 400 and water 700
     far grids at 0.9 nm (full cutoff-RF and fused far forms), the
     renumbered water 400, and a face crossing. Water 216's lattice energy
     is a near-cancellation (-69 kJ/mol of terms summing to thousands), so
     its float32 energy is held to 1e-4 of the sum of the per-atom energy
     magnitudes instead of the total;
   - K3: the 30k state's tile lists (0.9 nm fused far, 0.5 nm near) against
     the plain twin, then against K1 in float64 at the same tolerances (the
     same pairs inside the cutoff), then after moving every atom by at most
     skin/4, staged with xref, against K1 on fresh buckets;
   - the damped PME forms (Ewald direct-space full form, damped near form,
     fused damped far form): K1 at the 30k PME state's far and near grids,
     K2 on the water 700 far grid, K3 on the 30k PME tile lists (and
     against K1 in float64);
   - the emim/BF4 ionic liquid under PME (8- and 5-site ions, every pair
     within three bonds excluded): K1 in the three damped forms at path
     (d)'s far (5^3) and near (6^3) grids from bench_data/eq_emim.npz, and
     K2 on the 24-ion-pair system's 2^3 far grid (K1 on its 3^3 near grid)
     from tests/data/emim_bf4_24_minimized.npz;
   - phenol in water (BASELINE config 3): the softcore form (the solute
     indicator as +-1 in the charge column) and its dlambda twin at lambda
     0, 0.5 and 1 on K1 (path (e)'s 3^3 grid, 1,000 waters) and K2 (200
     waters, 2^3, also with the solute pushed into the solvent), the
     damped-smoothed form, the reaction-field form at lambda_coul = 0.5 and
     the solute-solute LJ term (zero charges) on both, the softcore form on
     K3 (path (e)'s tile list); after path
     (e), K1 and K2 (full stencil, same grid) at lambda 0, 0.05, 0.5 and 1
     at a configuration sampled at lambda_vdw = 0;
   - the virial flag (each pair's -2 r^2 du/dr^2 = d . F in the energy
     column, the forces unchanged; the summed column held to the tolerance
     of sum |w_i| over the atoms, in float32 of the unsplit form's under
     the fused far form): K1 on water 400 (RF, near, far) and the 30k PME
     near and far grids, K2 on the water 700 far grids (RF and PME, full
     and far), K3 on the 30k damped far list;
   - rigid water (path (g), after its runs, at their own grids and
     capacities): K1 in the cutoff-RF form at (g1)'s 0.9 nm grid, in the
     near and fused far forms at (g2)'s two grids, and at (g3)'s TIP4P/Ew
     grid (the M site 0.0125 nm from its O);
   - polarizable water (path (h), after (h1)'s run, at its grid and
     capacity): K1 in the cutoff-RF form at (h1)'s 4^3 grid with the
     Drude charges in the charge column and the Drudes off their cores;
4. slices: 5 outer RESPA+NHC steps of water 400 in float64 on the card
   against the same run on the CPU (plain twins), at 0.7 nm (K1 on both
   grids), at the default 0.9 nm (K2 far, K1 near) and with PME at 0.9 nm
   (K2 far, K1 near, the reciprocal sum on cuFFT): positions and
   velocities to 1e-9 relative; then 3 outer SIN(R) [10, 2, 1] @ 10 fs
   steps of the 24-pair ionic liquid (350 K, tau 0.02 ps, friction 0, so
   no draw enters; v, v1, v2 set from numpy on the isokinetic constraint)
   in the same way; then phenol + 200 waters (SolvationSystem): the
   multi-state energies at 4 states (rel 1e-10), dU/dlambda for both names
   (rel 1e-9) and 5 outer AlchemicalRespaSystem RESPA [4, 2, 1] + NHC steps
   at lambda_vdw 0.5, lambda_coul 0 (x and v to 1e-9 relative), with the
   exact launch counts: K1 the near force, K2 the far force in two sweeps
   (unfused under the charge-scale mask), the softcore force and the
   solute-solute term, each at its group's rate + 1 per pass; then 216
   waters with a MonteCarloBarostat every 2 steps (K2 far, K1 near), 10
   RESPA [2, 2, 1] + NHC steps with the same uniforms fed to both runs
   through _uniforms: x, v and box to 1e-9 relative, equal acceptances
   with at least one move accepted and one rejected, the atomic and
   molecular virials at the end to 1e-10; then path (g)'s slices, 216
   rigid waters: TIP3P on SETTLE under VV + NHC, 10 steps at 0.5 nm (K1,
   3^3) and at 0.9 nm (K2, 1^3), on SHAKE/RATTLE (analytic=False) 5 steps
   at 0.5 nm, HMR x3 + RESPASystem(0.45, 0.4) + RESPA [1, 4, 1] @ 16 fs +
   NHC 5 outer steps (K2 far, K1 near), TIP4P/Ew 10 steps at 0.5 nm and
   LangevinMiddle at friction 0, 5 steps: x and v to 1e-9 relative;
5. main path: the 30k-atom q-SPC/Fw water RESPA [4, 2, 1] @ 4 fs NVT
   headline from bench_data/eq_water30k.npz in float32: step(1), then a
   timed step(100); checks finiteness, K1's launch count (3 per outer
   step + 2 for the force-cache refresh, per pass of step()), temperature,
   potential energy per atom and conserved-energy drift;
6. path (a): small-box water (700 molecules, 2.759 nm box, default 0.9 nm
   cutoff) RESPA [4, 2, 1] @ 4 fs NVT in float32 from the lattice, melted by
   chunked velocity rescaling, then step(1) and a timed step(100); checks
   finiteness, the K2 (far: 1 per outer step + 1) and K1 (near: 2 per
   outer step + 1) launch counts, temperature and drift;
7. path (b): the tile-list entry point at the 30k state: build_tile_pairs
   and tile_pair_energy_forces for the fused far form and the near form in
   float32 and float64 (4 K3 launches), finite and Newton-balanced;
8. path (c): the 30k headline with PME (water_system(method='pme'):
   alpha 2.92029 /nm, grid 45^3, order 6; the near force damped at the
   same alpha) in float32: step(1), then a timed step(100); checks as in
   phase 5 (K1 launches, T, PE per atom, drift) plus the reciprocal
   evaluations (one per outer step + 1 per pass), and the card's float32
   far force (reciprocal included) against its float64 far force at the
   30k state (energy rtol 1e-4, forces 1e-4 x max|F| of the unsplit
   near + far force);
   path (d): the emim/BF4 ionic liquid at full size (400 ion pairs, 5,200
   atoms, 4.934 nm box) with a PME far force, RESPASystem(0.7, 0.6) and
   SIN_R_Integrator(30 fs, [4, 10, 1], 353 K, tau 0.05 ps, gamma 10/ps)
   from bench_data/eq_emim.npz in float32: step(50) to settle, then 100
   timed outer steps as 10 calls of step(10) with the kinetic temperature
   read after each; checks finiteness, the launch counts (11 sweeps per
   outer step, 10 near and 1 far, + 2 per pass of step(), on the kernel
   each grid takes), the reciprocal evaluations (one per outer step + 1
   per pass), the isokinetic constraint residual
   max |m v^2 + Q1 v1^2 / 2 - kT| / kT < 5e-3 and the mean kinetic
   temperature, 165-190 K (the isokinetic kT/2 per degree of freedom is
   176.5 K at the 353 K setpoint); SIN(R) has no conserved energy, so no
   drift is checked;
   path (e): BASELINE config 3 at bench_alchemy's shape (phenol + 1,000
   waters, 2,941 atoms, 3^3 grid, SolvationSystem, float32): 50 timed
   16-state multistate_energies rows (3 K1 launches a state: the scaled
   NonbondedForce, the softcore force, the solute-solute term), a melt and
   50 timed velocity Verlet + OU steps (3 K1 launches a step + 3 per pass)
   split by force, a short solvation_free_energy with MBAR, TI and each
   state's mean temperature (300 +- 40 K), and the float32 dU/dlambda_coul
   against float64;
   path (f): BASELINE config 5 at bench_npt_100k's shape (33,334 q-SPC/Fw
   waters, 100,002 atoms, from bench_data/eq_water100k.npz, a
   MonteCarloBarostat at 1 bar and 300 K every 25 steps, RESPASystem(0.6,
   0.5), RESPA [4, 2, 1] @ 4 fs + NHC, float32), reaction field and PME:
   first K1 against its plain twin at the run's own grids and capacities
   (far and near force, energy and virial forms), then
   step(100), then 8 (PME: 4) timed calls of step(25) with the
   temperature read after each; checks the attempts (exactly those the
   post-increment rule gives), at least one acceptance, no invalid trial,
   the exact launch counts (K1 on both grids: 2 near and 1 far sweeps per
   outer step, 2 per pass for the cache refresh, 6 per volume move), the
   reciprocal evaluations, mean T 280-320 K, PE/atom -14.6 ... -13.8
   kJ/mol, |dV/V| < 3% and finite atomic and molecular pressures (the
   virial form: one K1 sweep of each grid);
   path (g): rigid water at bench_rigid_water's shape, float32.
   (g1) BASELINE-bench config 6: 10,000 TIP3P waters (30,000 atoms), 0.9
   nm RF, every water on SETTLE, VV @ 2 fs + NHC from
   bench_data/eq_tip3p30k.npz retuned at safety 1.03: step(1),
   step(250), a timed step(200), then 8 x step(50) with T and PE read;
   checks finiteness, the SETTLE residual <= 1e-4, the K1 launches (1 a
   step + 1 a pass), T 294-308 K, PE/atom -15.1 ... -14.3 kJ/mol,
   |drift| <= 0.15 kJ/mol/atom/ps (bench.py's bands). (g2) config 6c:
   the same with HMR x3, RESPASystem(0.6, 0.5) and RESPA [1, 4, 1] @ 16
   fs + NHC, the velocities resampled at seed 9: K1 5 a step (1 far, 4
   near) + 2 a pass, T 294-308 K, PE/atom -13.7 ... -12.8, |drift| <=
   0.1. (g3) 2,000 TIP4P/Ew waters (8,000 sites, 3.915 nm, 0.9 nm RF, K1
   on 4^3) melted off the lattice by chunked rescaling (1600 steps), then
   a timed step(100) of VV @ 2 fs + NHC and 4 x step(25) with T read: the
   SETTLE residual, every M within 1e-6 nm of its placement, the M
   velocity rows 0, the mean T 270-330 K, the K1 launches;
   path (h): polarizable water, float32. (h1) config 7 as
   bench_swm4_drude runs it: 2,000 SWM4-NDP waters (10,000 sites, 3.915
   nm, 0.9 nm RF, K1 on 4^3), DrudeLangevinIntegrator(1 fs, 300 K, the
   Drude bath at 1 K): velocities at seed 9, step(1), step(800),
   retune_neighbors(), step(1), a timed step(150), 4 x step(250) with T
   and PE read; checks bench.py's bands (mixed T 180-240 K, T_atoms
   280-320 K, T_drude <= 10 K), the SETTLE residual <= 1e-4, every
   core-Drude distance < 0.05 nm, the M sites placed (1e-6 nm) and at
   rest, the K1 launches (1 a step + 1 a pass). (h2) the same waters
   with massless Drudes at (h1)'s final positions (each pair's momentum
   on its core), DrudeSCFIntegrator(1 fs, 12 iterations, 300 K, 5/ps):
   step(1), a timed step(20); the Drude velocity rows exactly 0, max|F|
   on a Drude row <= 4 k ulp(max|x|) (the float32 floor of the fixed
   point), K1 13 launches a step + 1 a pass, geometry as (h1). (h3) a
   chain of 4,096 CMAP terms on one random periodic 24 x 24 surface and
   4,096 impropers: energy and forces on the card against the float64
   CPU (float64 1e-12, float32 1e-4 of the energy and of max|F|), then
   each force's float32 call timed (CUDA events, device operations);
9. timings: each kernel's device time by torch.profiler (CUDA events
   around a launch wrapper read the host's launch rate once a kernel is
   shorter than its launch), everything else by CUDA events: K1, its
   whole sweep and its plain twin at the headline's near and far shapes,
   with the sweep's device operations
   counted by torch.profiler (1 to 4, exactly one of them the kernel, else
   the phase fails), the work the sweep has to do (slot tests between real
   atoms, in-range evaluations and distinct in-range pairs, counted with
   the twins' masks) and its bound (the function's work, each distinct pair
   once: the larger of the operations over the card's float32 and
   special-function rates and the bytes over its memory rate; the
   constants below); K2 in the same way (kernel, whole sweep, device
   operations, plain twin, bound over its per-atom inputs) on the water 700
   far grid at the state path (a) ended with, and path (a)'s device
   operations per outer step; K3, its launch wrapper, its sweep and its
   plain twin at the 30k near and far lists; the two list builds at 30k;
   the damped K1 (and its plain twin) at path (c)'s near and far shapes,
   the damped K2 on the water 700 far grid, and the reciprocal sum stage
   by stage (spline weights, spread, rfftn, convolution, irfftn, gather,
   corrections); K1 at path (d)'s far and near shapes; K1 and K2 (full
   stencil) with the softcore form at path (e)'s grid, bounded by the
   solute-solvent pairs; K1 at path (f)'s far and near grids in the energy
   and the virial forms, K2 and K3 with the virial flag; K1 at path (g)'s
   grids, SETTLE's two stages at 30k and the virtual-site placement and
   pull-back at (g3) (CUDA events, device operations a call), path (g)'s
   device operations per step; K1 at path (h1)'s grid, (h1)'s and
   (h2)'s device operations per step; then path (c)'s
   and path (d)'s outer steps split by force group (host clock,
   synchronised), path (f)'s outer step and one volume move split by
   part (trial build, e_old at the current box, e_new at the trial box
   on the trial's buckets, rebuild and cache refresh), (g1)'s step split
   by part (K1 sweep, SETTLE's stages, the bucket rebuild), (g2)'s
   outer step by group, and (h1)'s and (h2)'s steps by part (the force
   evaluation: K1, DrudeForce by autograd, the placement and pull-back;
   SETTLE's stages; the baths; (h2)'s SCF loop; the rebuild).

Then one JSON line of kernel results (with each kernel's bound_ms,
bound_by, library_ms = null: no single PyTorch call computes these sweeps;
ms is the kernel's device time in torch.profiler, launch_ms the time of one
call of its launch wrapper by CUDA events, both of this run), the
nvidia-smi line again, and last {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel-vs-plain tolerances (see the module docstring)
F64_RTOL, F64_FTOL = 1e-10, 1e-9
F32_RTOL, F32_FTOL = 1e-4, 1e-4

# The card's peaks for the bounds: float32 outside the tensor cores (FMA = 2
# operations) and device memory, NVIDIA's H100 SXM data sheet at 700 W; the
# special-function unit (rsqrt, sqrt, exp, reciprocal) at 16 results per
# clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 132 SMs x 1.98 GHz.
PEAK_FP32 = 67e12
PEAK_SFU = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12
# Float operations per pair, counted from the kernels' source (FMA = 2):
# a slot test (minimum image 3 x 5, r^2 5, the compare); an evaluation
# besides its form (the slot test again, qq, sigma, the force, energy and
# reaction sums); the forms of csrc/pair_forms.cuh: common part (r, 1/r^2,
# k qq), full half (LJ, quintic switch, reaction-field or Ewald Coulomb,
# sums), near half (switch, shifted-force LJ + Coulomb at r and at rc_in,
# sums; only where r < rc_in) and the damped Coulomb kernel (erfcf's
# polynomial, the exp term). SFU results per evaluation: rsqrt and sqrt,
# and under damping erfcf's exp and reciprocal and one exp.
OPS_SLOT = 21
OPS_EVAL = 36
OPS_COMMON = 3
OPS_FULL = {"rf": 54, "ewald": 48, "smoothed": 52}
OPS_NEAR = 71
OPS_DAMPED = 30
SFU_EVAL, SFU_DAMPED = 2, 3
# the softcore form (cross mask, quintic switch, 1/sig^2, x, the energy and
# du/dr^2 or the lambda derivative) and its two reciprocals on the SFU; the
# work of the function is the solute-solvent pairs in range (cross = 1)
OPS_SOFTCORE = 50
SFU_SOFTCORE = 2
# the virial flag: w = -2 r^2 du/dr^2 in place of u, two multiplies
OPS_VIRIAL = 2


def log(msg):
    print(msg, flush=True)


def require(name, checks):
    """Raise unless every named check holds."""
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{name} checks failed: {failed}")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def to_device(spec, dev):
    import dataclasses

    fields = ("nbr_cells", "exclusions", "nbr_cells_half", "inv_cells_half",
              "excbits")
    return dataclasses.replace(spec, **{
        k: getattr(spec, k).to(dev) for k in fields
        if getattr(spec, k) is not None})


def plain_sweep(spec, form, x, box, pp, bucket):
    """The plain twin of the sweep the spec selects, float64, on the
    device of x: (energy, forces, sum of |per-atom energy|)."""
    import torch

    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f64 = torch.float64
    x, box = x.to(f64), box.to(f64)
    pp = {k: v.to(f64) for k, v in pp.items()}
    plain = pk.half_pair_plain if spec.half_stencil else pk.full_pair_plain
    out = plain(x, pp, bucket, spec, box, form, form.r_cut)
    return (out[:, 3].sum(), out[:-1, :3], float(out[:, 3].abs().sum()))


def sweep_counts(spec, form, x, box, pp, bucket, half=None):
    """The work of the cell sweep the spec selects (half stencil unless
    `half` says otherwise) at these positions, counted on the device of x
    with the plain twins' masks: slot tests between real atoms, in-range
    pair evaluations (the half stencil's self direction and the full
    stencil evaluate both orderings), those inside the near form's cutoff,
    and the distinct in-range pairs, all and inside the near cutoff (the
    work of the function, each pair once). For a softcore form the work of
    the function is the distinct solute-solvent pairs in range (the
    kernels evaluate every in-range pair and multiply by the cross
    mask)."""
    import torch

    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.pbc import minimum_image

    half = spec.half_stencil if half is None else half
    n = x.shape[0]
    hf, hm, cols = pk.stage(spec, x, pp, bucket)
    ncells, cap, _ = hf.shape
    hf_s = torch.cat([hf, hf.new_zeros((1, cap, 8))])
    ids = torch.cat([hm[..., 0], hm.new_full((1, cap), n)])
    nbr = spec.nbr_cells_half if half else spec.nbr_cells
    nbr = torch.where(nbr >= 0, nbr, ncells).long()
    rc2 = pk._rc2(form.r_cut, x.dtype)
    near2 = form.n_rc ** 2 if form.has_near else 0.0
    chunk = max(1, (1 << 22) // (nbr.shape[1] * cap * cap))
    c = {"slots": 0, "evals": 0, "near": 0, "self": 0, "near_self": 0,
         "cross": 0, "cross_self": 0}
    for lo in range(0, ncells, chunk):
        cells = torch.arange(lo, min(lo + chunk, ncells), device=x.device)
        hid = hm[cells][..., 0][:, None, :, None]
        cid = ids[nbr[cells]][:, :, None, :]
        home, cand = hf[cells][:, None, :, None], hf_s[nbr[cells]][:, :, None]
        d = minimum_image(home[..., :3] - cand[..., :3], box)
        r2 = (d * d).sum(-1)
        real = (hid < n) & (cid < n)
        hit = real & (r2 < rc2) & ~pk.excluded(
            hid, cid, hm[cells][..., 1][:, None, :, None],
            None if cols is None else cols[cells][:, None, :, None, :])
        near = hit & (r2 < near2)
        cross = hit & (home[..., 3] * cand[..., 3] < 0)
        for key, m in (("slots", real), ("evals", hit), ("near", near),
                       ("cross", cross)):
            c[key] += int(m.sum())
        if half:
            for key, m in (("self", hit), ("near_self", near),
                           ("cross_self", cross)):
                c[key] += int(m[:, 0].sum())
    if half:
        c["pairs"] = c["evals"] - c["self"] // 2
        c["near_pairs"] = c["near"] - c["near_self"] // 2
        c["cross_pairs"] = c["cross"] - c["cross_self"] // 2
    else:
        c["pairs"], c["near_pairs"] = c["evals"] // 2, c["near"] // 2
        c["cross_pairs"] = c["cross"] // 2
    if form.softcore:
        c["pairs"] = c["cross_pairs"]
    return c


def bound(form, pairs, near, slots, nbytes):
    """The least time of a pair sweep on this card (see the constants
    above), in ms: {"ms", "by", "ops_ms", "sfu_ms", "bytes_ms",
    "with_slots_ms"} for `pairs` distinct in-range pairs, each evaluated
    once, `near` of them inside the near cutoff, and `nbytes` read once and
    written once; with_slots_ms adds the `slots` slot tests."""
    damped = bool(form.alpha)
    per = OPS_EVAL + OPS_COMMON + (OPS_DAMPED if damped else 0) \
        + (OPS_VIRIAL if form.virial else 0)
    if form.has_full:
        per += OPS_FULL["smoothed" if form.smoothed else
                        "ewald" if form.ewald else "rf"]
    if form.softcore:
        per += OPS_SOFTCORE
    ops = pairs * per + (near * OPS_NEAR if form.has_near else 0)
    sfu = pairs * (SFU_EVAL + (SFU_DAMPED if damped else 0)
                   + (SFU_SOFTCORE if form.softcore else 0))
    t = {"ops_ms": ops / PEAK_FP32 * 1e3, "sfu_ms": sfu / PEAK_SFU * 1e3,
         "bytes_ms": nbytes / PEAK_BYTES * 1e3}
    t["ms"] = max(t.values())
    t["by"] = "bytes" if t["ms"] == t["bytes_ms"] else "operations"
    t["with_slots_ms"] = max(
        t["ms"], (ops + slots * OPS_SLOT) / PEAK_FP32 * 1e3)
    return t


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def device_kernels(fn, reps=1, tries=3, enough=bool):
    """(name, device microseconds) of each device operation (kernel, fill,
    copy) that `reps` calls of fn run, from torch.profiler. A profile that
    `enough` refuses (by default one with no device event) is taken again,
    up to `tries` profiles in all; the last is returned. (A profile of work
    that launched kernels has come back with no device event at all, or
    without the events of its first calls, on the card's machine.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        if enough(seen):
            break
    return seen


def kernel_device_ms(fn, kernel, reps=20):
    """Milliseconds of device time per launch of `kernel` inside fn, from
    torch.profiler over `reps` calls. Unlike CUDA events around a wrapper
    this does not grow when the host cannot launch as fast as the kernel
    runs."""
    mine = [us for name, us in device_kernels(fn, reps)
            if f"{kernel}_kernel" in name]
    if not mine:
        raise RuntimeError(f"torch.profiler saw no {kernel} launch")
    return sum(mine) / len(mine) / 1e3


def form_name(form):
    """A pair form's name for the kernels line: its kind, and whether its
    Coulomb kernel is damped (the PME forms)."""
    from atomsmm_tpu_torch.ops import pairfuncs as pf

    name = {pf.LJ_SW_RF: "lj_sw_rf", pf.NEAR: "near", pf.FAR: "far",
            pf.LJ_SW_EWALD: "lj_sw_ewald", pf.SOFTCORE: "softcore",
            pf.DAMPED_SMOOTHED: "damped_smoothed"}[form.kind]
    if form.dlambda:
        return name + "_dlambda"
    return name + ("_damped" if form.alpha and form.kind in (pf.NEAR, pf.FAR)
                   else "") + ("_virial" if form.virial else "")


def judge(label, dtype, e_k, f_k, e_p, f_p, e_scale=None, f_scale=None):
    """Hold (e_k, f_k) against the float64 reference (e_p, f_p) at the
    tolerances of `dtype`; e_scale replaces |e_p| as the energy scale and
    f_scale max|f_p| as the force scale."""
    import torch

    rtol, ftol = ((F64_RTOL, F64_FTOL) if dtype == torch.float64
                  else (F32_RTOL, F32_FTOL))
    scale = abs(float(e_p)) if e_scale is None else e_scale
    e_err = abs(float(e_k) - float(e_p)) / max(scale, 1e-300)
    f_err = float((f_k.double() - f_p.double()).abs().max())
    f_max = float(f_p.abs().max()) if f_scale is None else f_scale
    ok = (bool(torch.isfinite(f_k).all()) and e_err <= rtol
          and f_err <= ftol * f_max)
    log(f"kernel {label} {str(dtype)[6:]}: E {float(e_k):.10g} vs "
        f"{float(e_p):.10g} rel {e_err:.2e} (tol {rtol:g}"
        f"{'' if e_scale is None else ' of sum|e_i|'}); "
        f"max|dF| {f_err:.3e} of max|F| {f_max:.4g}"
        f"{'' if f_scale is None else ' of the unsplit force'} "
        f"(tol {ftol:g}x)")
    if not ok:
        raise RuntimeError(f"kernel disagrees with its reference: {label}")
    return (label, str(dtype)[6:], e_err, f_err, f_max)


def compare(label, force, spec, x, box, dev, results, terms_scale=False,
            unsplit=None, form=None, globals=None):
    """The wrapper's kernel (f64 and f32) against the f64 plain twin on the
    card; the spec picks K1 (half maps) or K2. With `unsplit` (the full
    force a fused far force was split from) the float32 force tolerance
    scales with the unsplit force's max|F|: the far force is the difference
    of two forces of that size, and the truncated Ewald term moves pairs
    across the float32-rounded cutoff with a force jump of up to
    k |qq| [erfc(a rc)/rc² + (2a/sqrt(pi)) exp(-a² rc²)/rc] each. `form`
    replaces the force's own pair form, `globals` the parameters its form
    and per-particle columns read (lambda). Under the virial flag (each
    pair's -2 r^2 du/dr^2 in the energy column) the summed column is held,
    in both dtypes, to the tolerance of sum |w_i| over the atoms (of the
    unsplit form's, with the flag, in float32 with `unsplit`)."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    from atomsmm_tpu_torch.ops.pairfuncs import virial_form

    spec = to_device(spec, dev)
    kernel = "half_pair" if spec.half_stencil else "cell_pair"
    form = force._pair_form(globals) if form is None else form
    virial = form.virial
    unsplit_form = None if unsplit is None else unsplit._pair_form()
    if virial and unsplit_form is not None:
        unsplit_form = virial_form(unsplit_form)
    pp64 = {k: v.to(dev, torch.float64)
            for k, v in force._per_particle(globals).items()}
    for dtype in (torch.float64, torch.float32):
        xd, bd = x.to(dev, dtype), box.to(dev, dtype)
        pp = {k: v.to(dtype) for k, v in pp64.items()}
        bucket, overflow = nb.build_cell_buckets(spec, xd, bd)
        if bool(overflow):
            raise RuntimeError(f"{label}: bucket overflow in the comparison")
        before = dict(pk.LAUNCHES)
        e_k, f_k = nb.cell_pair_energy_forces(form, xd, bd, pp, spec, bucket,
                                              form.r_cut)
        torch.cuda.synchronize()
        if pk.LAUNCHES != {**before, kernel: before[kernel] + 1}:
            raise RuntimeError(f"{label}: the wrapper did not launch {kernel}")
        e_p, f_p, terms = plain_sweep(spec, form, xd, bd, pp, bucket)
        scale = terms if (terms_scale and dtype == torch.float32) or virial \
            else None
        f_scale = None
        if unsplit is not None and dtype == torch.float32:
            _, f_u, terms_u = plain_sweep(spec, unsplit_form, xd, bd, pp,
                                          bucket)
            f_scale = float(f_u.abs().max())
            scale = terms_u if virial else scale
        results.append((kernel,) + judge(f"{kernel} {label}", dtype, e_k,
                                         f_k, e_p, f_p, scale, f_scale)
                       + (form_name(form),))


def permuted(force, x, box, r_cut):
    """The nonbonded force, its spec and positions with the atoms renumbered
    by a fixed permutation: excluded pairs lie far more than +-14 indices
    apart, so no exclusion bitmask fits and the sweeps take the id
    columns."""
    import dataclasses

    import numpy as np
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb

    n = x.shape[0]
    p = np.random.RandomState(3).permutation(n)
    inv = np.argsort(p)
    exc = force.exclusions.cpu().numpy()[p]
    exc = np.where(exc >= 0, inv[np.maximum(exc, 0)], -1).astype(np.int32)
    pt = torch.as_tensor(p)
    force = dataclasses.replace(
        force, exclusions=torch.as_tensor(exc),
        **{k: v[pt] for k, v in force._per_particle().items()})
    spec = nb.make_neighbor_spec(box, n, r_cut, exclusions=exc,
                                 occupancy_floor_from=x[pt], device="cpu")
    if spec.excbits is not None:
        raise RuntimeError("the renumbered water still fits the bitmask")
    return force, spec, x[pt]


def face_crossing(label, system, x, box, dev):
    """Bucket at x with atom 0 just inside the x = 0 face, move it 0.011 nm
    across the face and evaluate on the card against the CPU plain twin."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb

    x = x.clone()
    x[0, 0] = 0.0009
    spec = to_device(system.neighbors, dev)
    bucket, _ = nb.build_cell_buckets(spec, x.to(dev), box.to(dev))
    x[0, 0] -= 0.011
    force = system.forces[0]
    form, pp = force._pair_form(), force._per_particle()
    e_k, f_k = nb.cell_pair_energy_forces(
        form, x.to(dev), box.to(dev), {k: v.to(dev) for k, v in pp.items()},
        spec, bucket, form.r_cut)
    e_p, f_p = nb.cell_pair_energy_forces(form, x, box, pp, system.neighbors,
                                          bucket.cpu(), form.r_cut)
    judge(f"{label} face-crossing", torch.float64, e_k, f_k.cpu(), e_p, f_p)


def phase_kernels(dev, eq):
    """K1 and K2 against their plain twins."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import argon_system, water_system
    from atomsmm_tpu_torch.ops.neighbors import (
        _max_cell_occupancy, retune_neighbor_specs, retune_spec)

    f64 = torch.float64
    results = []
    s, x, box = argon_system(n=864, jitter=0.1, seed=7, neighbors=True,
                             dtype=f64, device="cpu")
    compare("argon864 LJ", s.forces[0], s.neighbors, x, box, dev, results)
    s, x, box = water_system(n_molecules=400, r_cut=0.7, r_switch=0.6, seed=5,
                             neighbors=True, dtype=f64, device="cpu")
    compare("water400 cutoff-RF", s.forces[0], s.neighbors, x, box, dev,
            results)
    r = amm.RESPASystem(s, rcut_in=0.45, rswitch_in=0.35)
    compare("water400 near", r.forces[1], r.extra_neighbor_specs["near"], x,
            box, dev, results)
    compare("water400 far", r.forces[2], r.neighbors, x, box, dev, results)
    pf, pspec, px = permuted(s.forces[0], x, box, 0.7)
    compare("water400 renumbered (exclusion columns)", pf, pspec, px, box,
            dev, results)
    ex, ev, ebox = eq
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f64,
                           device="cpu")
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    r = retune_neighbor_specs(r, ex, ebox, safety=1.03)
    xe, be = torch.as_tensor(ex, dtype=f64), torch.as_tensor(ebox, dtype=f64)
    compare("water30k near", r.forces[1], r.extra_neighbor_specs["near"], xe,
            be, dev, results)
    compare("water30k far", r.forces[2], r.neighbors, xe, be, dev, results)
    s, x, box = argon_system(n=1728, jitter=0.1, seed=3, neighbors=True,
                             dtype=f64, device="cpu")
    face_crossing("half_pair argon1728", s, x, box, dev)
    # cells above 256 atoms: blocks of more than 256 threads, and candidate
    # partitions of more than one 128-slot chunk
    s, x, box = water_system(n_molecules=2744, r_cut=1.4, r_switch=1.3,
                             seed=5, neighbors=True, dtype=f64, device="cpu")
    spec = retune_spec(s.neighbors, x, box)
    occ = _max_cell_occupancy(x.numpy(), box.numpy(), spec.grid)
    if not (spec.half_stencil and 256 < spec.cell_capacity <= 512
            and occ > 256):
        raise RuntimeError(f"water 2744 at 1.4 nm: cap {spec.cell_capacity}, "
                           f"occupancy {occ}; expected cells above 256 atoms")
    compare(f"water2744 rc 1.4 cap {spec.cell_capacity} (cells of up to "
            f"{occ} atoms)", s.forces[0], spec, x, box, dev, results)

    # K1 in the damped PME forms at the 30k PME state's grids
    s, _, _ = water_system(n_molecules=10000, method="pme", neighbors=True,
                           dtype=f64, device="cpu")
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    r = retune_neighbor_specs(r, ex, ebox, safety=1.03)
    compare("water30k pme full (Ewald direct)", s.forces[0], r.neighbors, xe,
            be, dev, results)
    compare("water30k pme near (damped)", r.forces[1],
            r.extra_neighbor_specs["near"], xe, be, dev, results)
    compare("water30k pme far (fused damped)", r.forces[2], r.neighbors, xe,
            be, dev, results, unsplit=s.forces[0])

    # K2: grids too small for half maps at the default 0.9 nm cutoff
    s, x, box = water_system(n_molecules=216, seed=5, neighbors=True,
                             dtype=f64, device="cpu")
    if s.neighbors.cell_capacity <= 1024 or s.neighbors.ncells != 1:
        raise RuntimeError("water 216 should fill one cell above 1,024 slots")
    compare("water216 one cell cap 1112", s.forces[0], s.neighbors, x, box,
            dev, results, terms_scale=True)
    for m, method in ((400, "cutoff"), (700, "cutoff"), (700, "pme")):
        s, x, box = water_system(n_molecules=m, seed=5, neighbors=True,
                                 dtype=f64, method=method, device="cpu")
        r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
        tag = f"water{m} grid {s.neighbors.grid[0]}^3 cap " \
              f"{s.neighbors.cell_capacity}"
        full = "cutoff-RF" if method == "cutoff" else "pme full (Ewald direct)"
        far = "far" if method == "cutoff" else "pme far (fused damped)"
        compare(f"{tag} {full}", s.forces[0], s.neighbors, x, box, dev,
                results)
        compare(f"{tag} {far}", r.forces[2], r.neighbors, x, box, dev,
                results, unsplit=s.forces[0] if method == "pme" else None)
        if m == 400:
            pf, pspec, px = permuted(s.forces[0], x, box, 0.9)
            compare("water400 renumbered (exclusion columns)", pf, pspec, px,
                    box, dev, results)
            face_crossing("cell_pair water400", s, x, box, dev)
    return results


def ionic_liquid(n_pairs, dtype, device, root=HERE):
    """(unsplit system, RESPA system, positions, velocities or None, box)
    of the emim/BF4 liquid under PME with its cell capacities retuned to
    the state it is loaded with: 400 ion pairs, the equilibrated state of
    bench_data/eq_emim.npz split at 0.7 nm (path (d)); or 24 pairs, the
    minimized state of the emim_bf4_24 golden split at 0.5 nm."""
    import numpy as np

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import ionic_liquid_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    if n_pairs == 400:
        d = np.load(os.path.join(root, "bench_data", "eq_emim.npz"))
        x, v, box, kw, split = d["x"], d["v"], d["box"], {}, (0.7, 0.6)
    else:
        d = np.load(os.path.join(root, "tests", "data",
                                 "emim_bf4_24_minimized.npz"))
        x, v, box, split = d["x"], None, None, (0.5, 0.4)
        kw = dict(r_cut=0.65, r_switch=0.55)
    s, _, sbox = ionic_liquid_system(n_pairs=n_pairs, method="pme",
                                     neighbors=True, dtype=dtype,
                                     device=device, **kw)
    box = sbox.cpu().numpy() if box is None else box
    r = amm.RESPASystem(s, rcut_in=split[0], rswitch_in=split[1])
    return s, retune_neighbor_specs(r, x, box), x, v, box


def pair_forces(respa):
    """(near, far) nonbonded forces of a RESPA-split system."""
    near, = (f for f in respa.forces if f.name == "NearNonbondedForce")
    far, = (f for f in respa.forces if f.name == "FarNonbondedForce")
    return near, far


def phase_kernels_ionic(dev):
    """K1 and K2 in the damped forms on the ionic liquid's grids."""
    import torch

    f64 = torch.float64
    results = []
    for n_pairs in (400, 24):
        s, r, x, _, box = ionic_liquid(n_pairs, f64, "cpu")
        x, box = torch.as_tensor(x, dtype=f64), torch.as_tensor(box, dtype=f64)
        near, far = pair_forces(r)
        nspec = r.extra_neighbor_specs["near"]
        want = ((True, True) if n_pairs == 400 else (False, True))
        if (r.neighbors.half_stencil, nspec.half_stencil) != want:
            raise RuntimeError(f"emim {n_pairs}: unexpected stencils")
        tag = f"emim{n_pairs}"
        compare(f"{tag} pme full (Ewald direct) grid {r.neighbors.grid[0]}^3 "
                f"cap {r.neighbors.cell_capacity}", s.forces[0], r.neighbors,
                x, box, dev, results)
        compare(f"{tag} pme far (fused damped) grid {r.neighbors.grid[0]}^3 "
                f"cap {r.neighbors.cell_capacity}", far, r.neighbors, x, box,
                dev, results, unsplit=s.forces[0])
        compare(f"{tag} pme near (damped) grid {nspec.grid[0]}^3 cap "
                f"{nspec.cell_capacity}", near, nspec, x, box, dev, results)
    return results


def tile_lists(dev, eq, dtype, method="cutoff"):
    """{'far'/'near': (force, tile spec, list, cell spec)} at the 30k state
    on the card, with the cell specs of the headline retuned as phase 5;
    under PME also 'full' (the Ewald direct-space form on the far list)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import tilepair as tp
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    ex, _, ebox = eq
    s, _, _ = water_system(n_molecules=10000, neighbors=True,
                           dtype=torch.float64, method=method, device="cpu")
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    r = retune_neighbor_specs(r, ex, ebox, safety=1.03)
    x = torch.as_tensor(ex, dtype=dtype, device=dev)
    box = torch.as_tensor(ebox, dtype=dtype, device=dev)
    groups = [("far", r.forces[2], r.neighbors),
              ("near", r.forces[1], r.extra_neighbor_specs["near"])]
    if method == "pme":
        groups.insert(0, ("full", s.forces[0], r.neighbors))
    out = {}
    for label, force, cspec in groups:
        spec = tp.make_tilepair_spec(ebox, x.shape[0], force._pair_form().r_cut,
                                     exclusions=force.exclusions,
                                     occupancy_from=ex, device=dev)
        lst = tp.build_tile_pairs(spec, x, box)
        if bool(lst[4]):
            raise RuntimeError(f"tile list {label}: overflow at the 30k state")
        out[label] = (force, spec, lst, to_device(cspec, dev))
    return x, box, out


def tile_plain(spec, form, x, box, pp, lst, xref=None):
    """K3's plain twin in float64 on the device of x: (energy, forces, sum
    of |per-atom energy|)."""
    import torch

    from atomsmm_tpu_torch.ops import tilepair as tp

    f64 = torch.float64
    order, hb, cb, wrap, _ = lst
    fs, ms = tp._stage(spec, x.to(f64), box.to(f64),
                       {k: v.to(f64) for k, v in pp.items()}, spec.excbits,
                       order, None if xref is None else xref.to(f64))
    acc = tp.tile_pair_plain(fs, ms, hb, cb, wrap, box.to(f64), form,
                             form.r_cut)
    nb = spec.n_blocks
    f = torch.zeros((x.shape[0] + 1, 3), dtype=f64, device=x.device)
    f.index_add_(0, order.long(), acc[:nb, :, :3].reshape(-1, 3))
    return acc[:nb, :, 3].sum(), f[:-1], float(acc[:nb, :, 3].abs().sum())


def phase_tile_kernel(dev, eq):
    """K3 against its plain twin, then against K1 at the 30k state, in the
    reaction-field and the damped PME forms."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import tilepair as tp

    results = []
    for method, dtype in (("cutoff", torch.float64), ("cutoff", torch.float32),
                          ("pme", torch.float64), ("pme", torch.float32)):
        x, box, lists = tile_lists(dev, eq, dtype, method)
        f_max = {}
        for group, (force, spec, lst, cspec) in lists.items():
            label = group if method == "cutoff" else f"pme {group}"
            form = force._pair_form()
            pp = {k: v.to(dev, dtype)
                  for k, v in force._per_particle().items()}
            e_k, f_k = tp.tile_pair_energy_forces(form, x, box, pp, spec,
                                                  *lst[:4], form.r_cut)
            e_p, f_p, _ = tile_plain(spec, form, x, box, pp, lst)
            f_max[group] = float(f_p.abs().max())
            # the fused damped far form against the unsplit force's scale
            # (see compare)
            f_scale = (f_max["full"] if group == "far" and "full" in f_max
                       and dtype == torch.float32 else None)
            results.append(("tile_pair",) + judge(
                f"tile_pair water30k {label} (E {spec.max_entries})", dtype,
                e_k, f_k, e_p, f_p, f_scale=f_scale) + (form_name(form),))
            if dtype != torch.float64:
                continue
            bucket, _ = nb.build_cell_buckets(cspec, x, box)
            e_c, f_c = nb.cell_pair_energy_forces(form, x, box, pp, cspec,
                                                  bucket, form.r_cut)
            judge(f"tile_pair vs half_pair water30k {label}", dtype, e_k,
                  f_k, e_c, f_c)
            # move every atom by at most skin/4, stage with xref, and hold
            # the stale list against K1 on fresh buckets
            g = torch.Generator(device="cpu").manual_seed(11)
            step = (torch.rand(x.shape, generator=g, dtype=dtype) * 2 - 1) \
                * (spec.skin / 4 / 3 ** 0.5)
            x1 = x + step.to(dev)
            e_k, f_k = tp.tile_pair_energy_forces(form, x1, box, pp, spec,
                                                  *lst[:4], form.r_cut,
                                                  xref=x)
            bucket, _ = nb.build_cell_buckets(cspec, x1, box)
            e_c, f_c = nb.cell_pair_energy_forces(form, x1, box, pp, cspec,
                                                  bucket, form.r_cut)
            judge(f"tile_pair (moved <= skin/4, xref) vs half_pair water30k "
                  f"{label}", dtype, e_k, f_k, e_c, f_c)
    return results


def phase_slice(dev, **water_kw):
    """The whole slice on the card against the CPU, float64, 5 outer steps."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system

    f64 = torch.float64
    split = water_kw.pop("split")
    runs = []
    for device in ("cpu", dev):
        s, x, box = water_system(n_molecules=400, seed=5, neighbors=True,
                                 dtype=f64, device=device, **water_kw)
        r = amm.RESPASystem(s, rcut_in=split[0], rswitch_in=split[1])
        m = r.masses.cpu().numpy()
        v = np.random.RandomState(9).normal(size=(m.size, 3)) \
            * np.sqrt(amm.units.BOLTZMANN * 300.0 / m)[:, None]
        integ = amm.MultipleTimeScaleIntegrator(
            0.002, [4, 2, 1], temperature=300.0, time_scale=0.1,
            degrees_of_freedom=3 * m.size - 3)
        ctx = amm.Context(r, integ, amm.make_state(
            x, v=torch.as_tensor(v, dtype=f64, device=device), box=box))
        ctx.step(5)
        runs.append((ctx.state, r))
    (cpu, r), (gpu, _) = runs
    worst = 0.0
    for a, b in ((cpu.x, gpu.x), (cpu.v, gpu.v)):
        err = float((a - b.cpu()).abs().max()) / float(a.abs().max())
        worst = max(worst, err)
    grids = "far {} ({}), near {}".format(
        r.neighbors.grid, "half" if r.neighbors.half_stencil else "full",
        r.extra_neighbor_specs["near"].grid)
    log(f"slice water400 rc {r.forces[2].full.r_cut} RESPA+NHC 5 steps "
        f"float64, {grids}, card vs CPU: max rel diff {worst:.2e}")
    if not worst < 1e-9:
        raise RuntimeError("the slice on the card departs from the CPU run")


def isokinetic_draw(masses, temperature, tau, seed):
    """(v, v1, v2) drawn with numpy on the isokinetic constraint
    m v^2 + Q1 v1^2 / 2 = kT, Q1 = Q2 = kT tau^2."""
    import numpy as np

    from atomsmm_tpu_torch.units import BOLTZMANN

    rs = np.random.RandomState(seed)
    m = np.asarray(masses, np.float64)[:, None]
    kT = BOLTZMANN * temperature
    q = kT * tau ** 2
    phi = rs.uniform(0.0, 2 * np.pi, size=(m.shape[0], 3))
    return (np.sqrt(kT / m) * np.sin(phi), np.sqrt(2 * kT / q) * np.cos(phi),
            np.sqrt(kT / q) * rs.normal(size=phi.shape))


def constraint_residual(system, state, temperature, tau):
    """max |m v^2 + Q1 v1^2 / 2 - kT| / kT over the degrees of freedom."""
    from atomsmm_tpu_torch.integrate.sinr import V1
    from atomsmm_tpu_torch.units import BOLTZMANN

    kT = BOLTZMANN * temperature
    c = system.masses[:, None] * state.v ** 2 \
        + 0.5 * kT * tau ** 2 * state.extra[V1] ** 2
    return float((c / kT - 1.0).abs().max())


def phase_slice_ionic(dev):
    """3 outer SIN(R) steps of the 24-pair ionic liquid on the card against
    the CPU, float64, friction 0 and the velocities set from numpy."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.integrate.sinr import V1, V2
    from atomsmm_tpu_torch.utils import replace

    f64 = torch.float64
    temp, tau = 350.0, 0.02
    runs = []
    for device in ("cpu", dev):
        _, r, x, _, box = ionic_liquid(24, f64, device)
        v, v1, v2 = (torch.as_tensor(a, dtype=f64, device=device)
                     for a in isokinetic_draw(r.masses.cpu().numpy(), temp,
                                              tau, seed=8))
        integ = amm.SIN_R_Integrator(0.010, [10, 2, 1], temperature=temp,
                                     time_scale=tau, friction=0.0)
        ctx = amm.Context(r, integ, amm.make_state(
            torch.as_tensor(x, dtype=f64, device=device),
            box=torch.as_tensor(box, dtype=f64, device=device)))
        ctx.state = replace(ctx.state, v=v).with_extra(**{V1: v1, V2: v2})
        ctx.step(3)
        runs.append((ctx, r))
    (cpu, r), (gpu, _) = runs
    worst = 0.0
    for a, b in ((cpu.state.x, gpu.state.x), (cpu.state.v, gpu.state.v),
                 (cpu.state.extra[V1], gpu.state.extra[V1]),
                 (cpu.state.extra[V2], gpu.state.extra[V2])):
        worst = max(worst,
                    float((a - b.cpu()).abs().max()) / float(a.abs().max()))
    res = constraint_residual(gpu.system, gpu.state, temp, tau)
    log(f"slice emim24 pme SIN(R)[10, 2, 1]@10fs 3 steps float64, far "
        f"{r.neighbors.grid} ({'half' if r.neighbors.half_stencil else 'full'}"
        f"), near {r.extra_neighbor_specs['near'].grid}, card vs CPU: max rel "
        f"diff {worst:.2e} (x, v, v1, v2); constraint residual {res:.2e}")
    if not (worst < 1e-9 and res < 1e-9):
        raise RuntimeError("the SIN(R) slice on the card departs from the "
                           "CPU run")


def far_precision(dev, eq, respa):
    """The card's float32 far force (PME reciprocal sum, corrections and
    the fused damped pair sweep) against its float64 far force at the 30k
    state: energy rtol 1e-4, forces 1e-4 x max|F| of the unsplit nonbonded
    force (see compare)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    ex, _, ebox = eq
    f64 = torch.float64
    s, _, _ = water_system(n_molecules=10000, method="pme", neighbors=True,
                           dtype=f64, device=dev)
    r64 = retune_neighbor_specs(amm.RESPASystem(s, rcut_in=0.5,
                                                rswitch_in=0.4),
                                ex, ebox, safety=1.03)
    out = []
    for system in (respa, r64):
        dtype = system.masses.dtype
        x = torch.as_tensor(ex, dtype=dtype, device=dev)
        box = torch.as_tensor(ebox, dtype=dtype, device=dev)
        aux = {}
        for name, spec in (("default", system.neighbors),
                           ("near", system.extra_neighbor_specs["near"])):
            bucket, overflow = nb.build_cell_buckets(spec, x, box)
            if bool(overflow):
                raise RuntimeError("far precision: bucket overflow at 30k")
            aux[name] = {"spec": spec, "bucket": bucket}
        out.append(system.forces[2].energy_and_forces(x, box, {}, aux))
    (e32, f32), (e64, f64_) = out
    # force scale: the unsplit nonbonded force (near + far), as in compare
    _, f_near = r64.forces[1].energy_and_forces(
        torch.as_tensor(ex, dtype=f64, device=dev),
        torch.as_tensor(ebox, dtype=f64, device=dev), {}, aux)
    judge("far force with PME reciprocal water30k (card f32 vs card f64)",
          torch.float32, e32, f32, e64, f64_,
          f_scale=float((f64_ + f_near).abs().max()))


def phase_main(dev, eq, steps=100, method="cutoff"):
    """The 30k headline through Context.step: reaction field (phase 5) or
    PME (path (c)), float32."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import pme
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    f32 = torch.float32
    dt, loops = 0.004, [4, 2, 1]
    system, _, _ = water_system(n_molecules=10000, method=method,
                                neighbors=True, dtype=f32, device=dev)
    respa = amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    n = system.num_particles
    integ = amm.MultipleTimeScaleIntegrator(
        dt, loops, temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * n - 3)
    ex, ev, ebox = eq
    respa = retune_neighbor_specs(respa, ex, ebox, safety=1.03)
    caps = (respa.neighbors.cell_capacity,
            respa.extra_neighbor_specs["near"].cell_capacity)
    state = amm.make_state(torch.as_tensor(ex, dtype=f32, device=dev),
                           v=torch.as_tensor(ev, dtype=f32, device=dev),
                           box=torch.as_tensor(ebox, dtype=f32, device=dev))
    ctx = amm.Context(respa, integ, state)
    ctx.step(1)
    torch.cuda.synchronize()
    e0 = float(ctx.conserved_energy())
    pk.reset_launches()
    pme.reset_evaluations()
    t0 = time.perf_counter()
    ctx.step(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    recip = pme.EVALUATIONS["reciprocal"]
    e1 = float(ctx.conserved_energy())
    x, v = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(x).all() and torch.isfinite(v).all())
    temp = float(ctx.temperature())
    pe = float(ctx.get_state(lite=True).potential_energy) / n
    drift = (e1 - e0) / (n * steps * dt)
    passes = ctx.last_step_passes
    expected = {"half_pair": passes * (3 * steps + 2),
                "cell_pair": 0, "tile_pair": 0}
    # the far force (and with it the reciprocal sum) once per outer step,
    # once more for the force-cache refresh of each pass
    expected_recip = passes * (steps + 1) if method == "pme" else 0
    ms = wall / steps * 1e3
    ns_day = dt * 1e-3 * steps / wall * 86400.0
    name = "main" if method == "cutoff" else "path (c)"
    pme_desc = ""
    if method == "pme":
        f = system.forces[0]
        pme_desc = (f" PME alpha {f.ewald_alpha:.5f}/nm grid {f.grid_shape} "
                    f"order {f.spline_order};")
    log(f"{name} water30k {method} RESPA{loops}@{dt*1e3:.0f}fs NVT float32:"
        f"{pme_desc} caps far/near {caps[0]}/{caps[1]} -> "
        f"{ctx.system.neighbors.cell_capacity}/"
        f"{ctx.system.extra_neighbor_specs['near'].cell_capacity}; "
        f"{ms:.3f} ms/step, {ns_day:.3f} ns/day; launches {launches} "
        f"(expected {expected}, passes {passes}); reciprocal evaluations "
        f"{recip} (expected {expected_recip}); T {temp:.2f} K; "
        f"PE/atom {pe:.4f} kJ/mol; drift {drift:.5f} kJ/mol/atom/ps; "
        f"finite {finite}")
    checks = {
        "finite": finite,
        "launches": launches == expected,
        "reciprocal_evaluations": recip == expected_recip,
        "temperature": 280.0 <= temp <= 320.0,
        "pe_per_atom": -14.6 <= pe <= -13.8,
        "drift": abs(drift) <= 0.1,
        "shape": tuple(x.shape) == (n, 3) and tuple(v.shape) == (n, 3),
    }
    require(name, checks)
    if method == "pme":
        far_precision(dev, eq, respa)
    return {"launches": launches["half_pair"], "ms_per_step": ms,
            "ns_day": ns_day, "respa": respa, "state": (ex, ebox),
            "reciprocal": recip}


def phase_small_box(dev, steps=100, melt_steps=200):
    """Path (a): 700 q-SPC/Fw waters at the default cutoff through
    Context.step; the far force runs K2, the near force K1."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f32 = torch.float32
    dt, loops, temp0 = 0.004, [4, 2, 1], 300.0
    system, x, box = water_system(n_molecules=700, neighbors=True, dtype=f32,
                                  device=dev)
    respa = amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    far, near = respa.neighbors, respa.extra_neighbor_specs["near"]
    if far.half_stencil or not near.half_stencil:
        raise RuntimeError("water 700: expected a full-stencil far grid and "
                           "a half-stencil near grid")
    n = system.num_particles
    integ = amm.MultipleTimeScaleIntegrator(
        dt, loops, temperature=temp0, time_scale=0.1,
        degrees_of_freedom=3 * n - 3)
    ctx = amm.Context(respa, integ, amm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(temp0, seed=1)
    # melt off the lattice: the lattice releases potential energy faster
    # than the tau = 0.1 ps bath removes it (bench.py::_melt_equilibrate)
    for _ in range(8):
        ctx.step(melt_steps // 8)
        t_now = float(ctx.temperature())
        if not t_now == t_now or t_now > 5000.0:
            raise RuntimeError(f"small-box melt diverged (T {t_now} K)")
        ctx.set_velocities((temp0 / t_now) ** 0.5 * ctx.state.v)
    ctx.step(1)
    torch.cuda.synchronize()
    e0 = float(ctx.conserved_energy())
    pk.reset_launches()
    t0 = time.perf_counter()
    ctx.step(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    e1 = float(ctx.conserved_energy())
    passes = ctx.last_step_passes
    # per pass: the far force once per outer step, the near force twice
    # (loops [4, 2, 1]), each once more for the force-cache refresh
    expected = {"half_pair": passes * (2 * steps + 1),
                "cell_pair": passes * (steps + 1), "tile_pair": 0}
    xs, vs = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(vs).all())
    temp = float(ctx.temperature())
    drift = (e1 - e0) / (n * steps * dt)
    ms = wall / steps * 1e3
    ns_day = dt * 1e-3 * steps / wall * 86400.0
    log(f"path (a) water700 box {float(box[0]):.3f} nm RESPA{loops}"
        f"@{dt*1e3:.0f}fs NVT float32 after a {melt_steps}-step melt: far "
        f"grid {far.grid} cap {ctx.system.neighbors.cell_capacity} (K2), "
        f"near grid {near.grid} cap "
        f"{ctx.system.extra_neighbor_specs['near'].cell_capacity} (K1); "
        f"{ms:.3f} ms/step, {ns_day:.3f} ns/day; launches {launches} "
        f"(expected {expected}, passes {passes}); T {temp:.2f} K; drift "
        f"{drift:.5f} kJ/mol/atom/ps; finite {finite}")
    checks = {
        "finite": finite,
        "launches": launches == expected,
        # 2,100 atoms: the instantaneous T spreads by ~2% (5 K) about the
        # bath's 300 K; 30 K leaves room for the melt's last relaxation
        "temperature": 270.0 <= temp <= 330.0,
        # the headline's bound: the f32 RESPA+NHC integrator conserves its
        # extended energy to far better than this
        "drift": abs(drift) <= 0.1,
    }
    require("path (a)", checks)
    return {"launches": launches, "ms_per_step": ms, "ns_day": ns_day,
            "respa": ctx.system, "state": ctx.state}


def phase_ionic(dev, settle=50, calls=10, steps_per_call=10):
    """Path (d): BASELINE config 4, the emim/BF4 ionic liquid with a PME
    far force under SIN(R) at a 30 fs outer step, through Context.step."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import pme

    f32 = torch.float32
    dt, loops, temp, tau = 0.030, [4, 10, 1], 353.0, 0.05
    system, respa, ex, ev, ebox = ionic_liquid(400, f32, dev)
    n = system.num_particles
    far, near = respa.neighbors, respa.extra_neighbor_specs["near"]
    integ = amm.SIN_R_Integrator(dt, loops, temperature=temp,
                                 time_scale=tau, friction=10.0)
    # initialize() redraws (v, v1, v2) on the constraint from the state's
    # generator; the loaded velocities only pass through make_state
    ctx = amm.Context(respa, integ, amm.make_state(
        torch.as_tensor(ex, dtype=f32, device=dev),
        v=torch.as_tensor(ev, dtype=f32, device=dev),
        box=torch.as_tensor(ebox, dtype=f32, device=dev), seed=11))
    res0 = constraint_residual(ctx.system, ctx.state, temp, tau)
    ctx.step(settle)
    torch.cuda.synchronize()
    pk.reset_launches()
    pme.reset_evaluations()
    passes, temps = 0, []
    t0 = time.perf_counter()
    for _ in range(calls):
        ctx.step(steps_per_call)
        passes += ctx.last_step_passes
        temps.append(float(ctx.temperature()))  # synchronises
    wall = time.perf_counter() - t0
    steps = calls * steps_per_call
    launches = dict(pk.LAUNCHES)
    recip = pme.EVALUATIONS["reciprocal"]
    # per pass of step(k): loops[1] near sweeps and one far sweep per outer
    # step, and one of each for the force-cache refresh
    kernel = {True: "half_pair", False: "cell_pair"}
    expected = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0}
    expected[kernel[near.half_stencil]] += passes * (
        loops[1] * steps_per_call + 1)
    expected[kernel[far.half_stencil]] += passes * (steps_per_call + 1)
    expected_recip = passes * (steps_per_call + 1)
    x, v = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(x).all() and torch.isfinite(v).all())
    res = constraint_residual(ctx.system, ctx.state, temp, tau)
    t_mean = sum(temps) / len(temps)
    pe = float(ctx.get_state(lite=True).potential_energy) / n
    ms = wall / steps * 1e3
    ns_day = dt * 1e-3 * steps / wall * 86400.0
    f = system.forces[0]
    log(f"path (d) emim/BF4 400 pairs ({n} atoms, box {float(ebox[0]):.3f} "
        f"nm) pme SIN(R){loops}@{dt*1e3:.0f}fs {temp:g} K tau {tau} ps gamma "
        f"10/ps float32: PME alpha {f.ewald_alpha:.5f}/nm grid {f.grid_shape} "
        f"order {f.spline_order}; far grid {far.grid} cap "
        f"{ctx.system.neighbors.cell_capacity} ({kernel[far.half_stencil]}), "
        f"near grid {near.grid} cap "
        f"{ctx.system.extra_neighbor_specs['near'].cell_capacity} "
        f"({kernel[near.half_stencil]}); {steps} outer steps as {calls} calls "
        f"of step({steps_per_call}) after step({settle}): {ms:.3f} ms per "
        f"outer step, {ns_day:.3f} ns/day on {smi_line()}; launches "
        f"{launches} (expected {expected}, passes {passes}); reciprocal "
        f"evaluations {recip} (expected {expected_recip}); constraint "
        f"residual {res:.3e} (at initialisation {res0:.3e}); kinetic T mean "
        f"{t_mean:.2f} K over {len(temps)} readings (min {min(temps):.2f}, "
        f"max {max(temps):.2f}; isokinetic kT/2 per degree of freedom: "
        f"{temp / 2:.1f} K); PE/atom {pe:.4f} kJ/mol; finite {finite}")
    checks = {
        "finite": finite,
        "launches": launches == expected,
        "reciprocal_evaluations": recip == expected_recip,
        "constraint": res < 5e-3,
        "temperature": 165.0 <= t_mean <= 190.0,
        "shape": tuple(x.shape) == (n, 3) and tuple(v.shape) == (n, 3),
    }
    require("path (d)", checks)
    return {"launches": launches, "ms_per_step": ms, "ns_day": ns_day,
            "respa": ctx.system, "state": (ex, ebox), "loops": loops,
            "steps": steps}


def step_device_ops(small, steps=10):
    """Device operations (kernels, fills, copies) per outer step of path
    (a), by torch.profiler over one step(steps) call from the state
    phase_small_box ended with; the call's force-cache refresh (one more
    evaluation of each force) is inside the count."""
    import atomsmm_tpu_torch as amm

    respa, state = small["respa"], small["state"]
    integ = amm.MultipleTimeScaleIntegrator(
        0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * respa.num_particles - 3)
    ctx = amm.Context(respa, integ, amm.make_state(state.x, v=state.v,
                                                   box=state.box))
    ctx.step(1)
    return len(device_kernels(lambda: ctx.step(steps))) / steps


def phase_tile_path(dev, eq):
    """Path (b): the tile-list entry point at 30k, far and near forms, in
    float32 and float64, through the calls a user makes."""
    import torch

    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import tilepair as tp

    pk.reset_launches()
    runs = 0
    for dtype in (torch.float32, torch.float64):
        x, box, lists = tile_lists(dev, eq, dtype)
        for label, (force, spec, lst, _) in lists.items():
            pp = {k: v.to(dev, dtype)
                  for k, v in force._per_particle().items()}
            e, f = tp.tile_pair_energy_forces(force._pair_form(), x, box, pp,
                                              spec, *lst[:4],
                                              force._pair_form().r_cut)
            runs += 1
            net = float(f.sum(0).abs().max()) / float(f.abs().max())
            live = int((lst[1] < spec.n_blocks).sum())
            log(f"path (b) tile list water30k {label} {str(dtype)[6:]}: "
                f"{live} entries of {spec.max_entries} "
                f"({live * spec.block_size * 2 * spec.block_size / 1e6:.1f} M "
                f"slots), E {float(e):.8g}, |sum F|/max|F| {net:.1e}")
            if not (bool(torch.isfinite(f).all()) and net < 1e-3):
                raise RuntimeError(f"path (b) {label}: bad forces")
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    if launches != {"half_pair": 0, "cell_pair": 0, "tile_pair": runs}:
        raise RuntimeError(f"path (b) launches {launches}, expected {runs} K3")
    return launches["tile_pair"]


def time_cuda(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps=20):
    """Host-clock milliseconds of one synchronised call of fn."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def time_cells(label, force, spec, x, box, form=None):
    """K1 or K2 (the kernel the spec selects) at one shape: the kernel's
    device time inside the sweep (torch.profiler), the launch wrapper, the
    whole sweep and the plain twin by CUDA events; the sweep's device
    operations (at most
    4, exactly one of them the kernel, else the phase fails; none seen by
    the profiler fails it too), the work it has to do and its bound.
    `form` replaces the force's own pair form."""
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    n = x.shape[0]
    form = force._pair_form() if form is None else form
    pp = force._per_particle()
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    if spec.half_stencil:
        kernel, cuda, plain = "half_pair", pk.half_pair_cuda, pk.half_pair_plain
        nbr = spec.nbr_cells_half
    else:
        kernel, cuda, plain = "cell_pair", pk.full_pair_cuda, pk.full_pair_plain
        nbr = spec.nbr_cells
    args = (x, pp, bucket, spec, box, form, form.r_cut)
    launch_ms = time_cuda(lambda: cuda(*args), 20)

    def sweep():
        return nb.cell_pair_energy_forces(form, x, box, pp, spec, bucket,
                                          form.r_cut)

    sweep_ms = time_cuda(sweep, 20)
    p_ms = time_cuda(lambda: plain(*args), 3)
    k_ms = kernel_device_ms(sweep, kernel)
    # device operations per sweep: the span between two launches of the
    # kernel among 5 profiled sweeps. The profiler has dropped events at
    # the start of its window (all of one sweep, two or three), so a read
    # with fewer than 3 launches of the kernel is taken again
    seen = [name for name, _ in device_kernels(
        sweep, reps=5, enough=lambda ev: sum(
            f"{kernel}_kernel" in name for name, _ in ev) >= 3)]
    at = [i for i, name in enumerate(seen) if f"{kernel}_kernel" in name]
    spans = {j - i for i, j in zip(at[1:], at[2:])}
    ops = seen[at[1] + 1:at[2] + 1] if len(at) >= 3 else []
    if len(at) < 3 or spans != {len(ops)} or not 1 <= len(ops) <= 4:
        raise RuntimeError(f"{kernel} sweep {label}: kernel launches at "
                           f"{at} of {len(seen)} device operations in 5 "
                           f"sweeps, expected 1 to 4 a sweep with one: "
                           f"{seen}")
    c = sweep_counts(spec, form, x, box, pp, bucket)
    exc = spec.excbits if spec.excbits is not None else spec.exclusions
    b = bound(form, c["pairs"], c["near_pairs"], c["slots"], nbytes(
        x, pp["charge"], pp["sigma"], pp["epsilon"], exc, bucket, nbr, box)
        + (n + 1) * 4 * x.element_size())
    slots_all = spec.ncells * nbr.shape[1] * spec.cell_capacity ** 2
    log(f"timing {kernel} {label} grid {spec.grid} cap "
        f"{spec.cell_capacity}: kernel {k_ms:.4f} ms of device time "
        f"({launch_ms:.4f} ms by CUDA events around its wrapper, the zero "
        f"fill and the host's launch rate included); "
        f"sweep {sweep_ms:.4f} ms with "
        f"{len(ops)} device operations per sweep "
        f"({', '.join(o[:40] for o in ops)}); plain float32 {p_ms:.4f} ms; "
        f"{slots_all / 1e6:.1f} M slots ({slots_all / k_ms / 1e6:.2f} "
        f"Gslot/s), {c['slots'] / 1e6:.2f} M between real atoms, "
        f"{c['evals'] / 1e6:.3f} M in-range evaluations "
        f"({c['evals'] / k_ms / 1e6:.2f} G/s, {c['near'] / 1e6:.3f} M inside "
        f"the near cutoff), {c['pairs'] / 1e6:.3f} M distinct "
        f"{'solute-solvent ' if form.softcore else ''}pairs ({c['pairs']}) "
        f"({c['near_pairs'] / 1e6:.3f} M near); bound "
        f"{b['ms'] * 1e3:.2f} us by {b['by']} "
        f"(ops {b['ops_ms'] * 1e3:.2f}, SFU {b['sfu_ms'] * 1e3:.2f}, bytes "
        f"{b['bytes_ms'] * 1e3:.2f} us; with the slot tests "
        f"{b['with_slots_ms'] * 1e3:.2f} us): {b['ms'] / k_ms:.1%} of the "
        f"bound, {b['with_slots_ms'] / k_ms:.1%} with the slot tests")
    return {"ms": k_ms, "launch_ms": launch_ms, "plain_ms": p_ms,
            "sweep_ms": sweep_ms, "slots": slots_all, "counts": c,
            "bound": b, "launches_per_sweep": len(ops)}


def phase_timings(dev, main, small, eq):
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import tilepair as tp

    respa = main["respa"]
    ex, ebox = main["state"]
    f32 = torch.float32
    x = torch.as_tensor(ex, dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    out = {}
    for label, force, spec in (
            ("far", respa.forces[2], respa.neighbors),
            ("near", respa.forces[1], respa.extra_neighbor_specs["near"])):
        out[("half_pair", label)] = time_cells(label, force, spec, x, box)

    log(f"path (a) device operations per outer step: "
        f"{step_device_ops(small):.1f} (torch.profiler, step(10))")
    # K2 on the path (a) far grid, at its state after the run
    s_sys, s_state = small["respa"], small["state"]
    out[("cell_pair", "far")] = time_cells(
        "water700 far", s_sys.forces[-1], s_sys.neighbors, s_state.x,
        s_state.box)

    # K3 at the 30k lists, beside K1 above
    x, box, lists = tile_lists(dev, eq, f32)
    for label, (force, spec, lst, cspec) in lists.items():
        form = force._pair_form()
        pp = {k: v.to(dev) for k, v in force._per_particle().items()}
        order, hb, cb, wrap, _ = lst
        fs, ms = tp._stage(spec, x, box, pp, spec.excbits, order)
        k_ms = kernel_device_ms(lambda: tp.tile_pair_cuda(
            fs, ms, hb, cb, wrap, box, form, form.r_cut), "tile_pair")
        l_ms = time_cuda(lambda: tp.tile_pair_cuda(
            fs, ms, hb, cb, wrap, box, form, form.r_cut), 20)
        w_ms = time_cuda(lambda: tp.tile_pair_energy_forces(
            form, x, box, pp, spec, order, hb, cb, wrap, form.r_cut), 20)
        p_ms = time_cuda(lambda: tp.tile_pair_plain(
            fs, ms, hb, cb, wrap, box, form, form.r_cut), 3)
        live = int((hb < spec.n_blocks).sum())
        slots = live * spec.block_size * 2 * spec.block_size
        k1 = out[("half_pair", label)]
        # K3 evaluates each distinct pair once: K1's pairs at this state
        c = k1["counts"]
        acc = tp.tile_pair_cuda(fs, ms, hb, cb, wrap, box, form, form.r_cut)
        b = bound(form, c["pairs"], c["near_pairs"], slots,
                  nbytes(fs, ms, hb, cb, wrap, box, acc))
        log(f"timing tile_pair {label} {live} entries: kernel {k_ms:.4f} ms "
            f"of device time ({l_ms:.4f} ms by CUDA events around its "
            f"launch wrapper; {slots / k_ms / 1e6:.2f} Gslot/s, "
            f"{slots / 1e6:.1f} M slots) "
            f"vs half_pair {k1['ms']:.4f} ms ({k1['slots'] / 1e6:.1f} M "
            f"slots); wrapper {w_ms:.4f} ms vs {k1['sweep_ms']:.4f} ms; "
            f"plain float32 {p_ms:.4f} ms; bound {b['ms'] * 1e3:.2f} us by "
            f"{b['by']} for {c['pairs'] / 1e6:.3f} M pairs (with the slot "
            f"tests {b['with_slots_ms'] * 1e3:.2f} us): "
            f"{b['ms'] / k_ms:.1%} of it")
        out[("tile_pair", label)] = {"ms": k_ms, "launch_ms": l_ms,
                                     "plain_ms": p_ms,
                                     "sweep_ms": w_ms, "slots": slots,
                                     "bound": b}
    spec = lists["far"][1]
    cspec = lists["far"][3]
    t_ms = time_cuda(lambda: tp.build_tile_pairs(spec, x, box), 10)
    c_ms = time_cuda(lambda: nb.build_cell_buckets(cspec, x, box), 10)
    log(f"timing list builds water30k far: build_tile_pairs {t_ms:.4f} ms, "
        f"build_cell_buckets {c_ms:.4f} ms")
    return out


def phase_pme_timings(dev, pme_run, small, eq):
    """Path (c)'s damped K1 at its far and near shapes, the damped K2 on
    the water 700 far grid, the damped K3 on the 30k far list and the
    reciprocal sum stage by stage, all in float32 with CUDA events."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import pme
    from atomsmm_tpu_torch.ops import tilepair as tp

    respa = pme_run["respa"]
    ex, ebox = pme_run["state"]
    f32 = torch.float32
    x = torch.as_tensor(ex, dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    out = {}
    for label, force, spec in (
            ("pme far", respa.forces[2], respa.neighbors),
            ("pme near", respa.forces[1],
             respa.extra_neighbor_specs["near"])):
        out[("half_pair", label)] = time_cells(label, force, spec, x, box)

    # K2 in the fused damped far form on the water 700 far grid, at the
    # positions path (a) ended with
    s, _, _ = water_system(n_molecules=700, method="pme", neighbors=True,
                           dtype=f32, device=dev)
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    out[("cell_pair", "pme far")] = time_cells(
        "pme far water700", r.forces[2], small["respa"].neighbors,
        small["state"].x, small["state"].box)

    # K3 in the fused damped far form on the 30k far list
    xt, bt, lists = tile_lists(dev, eq, f32, "pme")
    force, spec, lst, _ = lists["far"]
    form = force._pair_form()
    pp = {k: v.to(dev) for k, v in force._per_particle().items()}
    order_, hb, cb, wrap, _ = lst
    fs, ms = tp._stage(spec, xt, bt, pp, spec.excbits, order_)
    k_ms = kernel_device_ms(lambda: tp.tile_pair_cuda(
        fs, ms, hb, cb, wrap, bt, form, form.r_cut), "tile_pair")
    p_ms = time_cuda(lambda: tp.tile_pair_plain(
        fs, ms, hb, cb, wrap, bt, form, form.r_cut), 3)
    log(f"timing tile_pair pme far water30k: kernel {k_ms:.4f} ms, plain "
        f"float32 {p_ms:.4f} ms")
    out[("tile_pair", "pme far")] = {"ms": k_ms, "plain_ms": p_ms}

    # the reciprocal sum, stage by stage
    nbf = respa.forces[2].full
    q, alpha = nbf.charge, float(nbf.ewald_alpha)
    grid, order = tuple(nbf.grid_shape), int(nbf.spline_order)
    idx, w, dw = pme._spline_setup(x, box, grid, order, True)
    Q = pme._spread(idx, w, q, grid)
    qhat = torch.fft.rfftn(Q)
    _, bq = pme._convolve(qhat, box, alpha, grid, order)
    phi = pme._grid_potential(bq, grid)
    stages = {
        "spline weights": lambda: pme._spline_setup(x, box, grid, order,
                                                    True),
        "spread": lambda: pme._spread(idx, w, q, grid),
        "rfftn": lambda: torch.fft.rfftn(Q),
        "convolution": lambda: pme._convolve(qhat, box, alpha, grid, order),
        "irfftn": lambda: pme._grid_potential(bq, grid),
        "gather": lambda: pme._gather(phi, idx, w, dw, q, box, grid, order),
        "corrections": lambda: pme.pme_corrections_forces(
            x, box, q, nbf.exclusions, alpha),
        "reciprocal total": lambda: pme.pme_reciprocal_energy_forces(
            x, box, q, alpha, grid, order),
    }
    times = {k: time_cuda(fn, 20) for k, fn in stages.items()}
    log("timing PME reciprocal water30k grid {} order {} float32: {}".format(
        grid, order, ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())))
    out["reciprocal"] = times
    return out


def phase_ionic_timings(dev, ionic):
    """K1 at path (d)'s far and near shapes (the fused damped far form and
    the damped near form), as time_cells times every shape."""
    import torch

    respa = ionic["respa"]
    ex, ebox = ionic["state"]
    x = torch.as_tensor(ex, dtype=torch.float32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=torch.float32, device=dev)
    near, far = pair_forces(respa)
    return {
        ("half_pair", "emim far"): time_cells(
            "emim400 pme far", far, respa.neighbors, x, box),
        ("half_pair", "emim near"): time_cells(
            "emim400 pme near", near, respa.extra_neighbor_specs["near"], x,
            box),
    }


def phase_step_split(dev, run, name, loops):
    """Where the outer step of a three-level PME RESPA path goes: each
    force group's evaluation and the two bucket rebuilds timed alone on the
    host clock with a synchronise after every call (so launch overhead
    counts), times its count per outer step of RESPA `loops` (every level
    evaluates its group once per substep: the trailing kick writes the
    cache that the next leading kick reads); the rest of the measured
    ms/step is the integrator (kicks, drifts, baths) and Python."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pme
    from atomsmm_tpu_torch.potential import force_fn

    respa = run["respa"]
    ex, ebox = run["state"]
    x = torch.as_tensor(ex, dtype=torch.float32, device=dev)
    box = torch.as_tensor(ebox, dtype=torch.float32, device=dev)
    aux = nb.make_aux(respa, nb.all_neighbor_extras(respa, x, box))
    full = pair_forces(respa)[1].full
    # evaluations per outer step: one per substep of each level
    calls = {0: loops[0] * loops[1] * loops[2], 1: loops[1] * loops[2],
             2: loops[2]}

    group0 = ", ".join(f.name for f in respa.forces if f.group == 0)
    parts = {  # name: (ms per call, calls per outer step)
        f"group 0, autograd ({group0})": (wall_ms(lambda: force_fn(
            respa, {0})(x, box, {}, aux)), calls[0]),
        "near (group 1, K1)": (wall_ms(lambda: force_fn(
            respa, {1})(x, box, {}, aux)), calls[1]),
        "far (group 2: K1 + PME)": (wall_ms(lambda: force_fn(
            respa, {2})(x, box, {}, aux)), calls[2]),
        "  of which reciprocal sum": (wall_ms(
            lambda: pme.pme_reciprocal_energy_forces(
                x, box, full.charge, float(full.ewald_alpha),
                full.grid_shape, full.spline_order)), calls[2]),
        "  of which corrections": (wall_ms(lambda: pme.pme_corrections_forces(
            x, box, full.charge, full.exclusions,
            float(full.ewald_alpha))), calls[2]),
        "bucket rebuilds (2 grids)": (wall_ms(lambda: nb.all_neighbor_extras(
            respa, x, box)), 1),
    }
    split_log(name, run["ms_per_step"], parts, "integrator, baths, Python")
    return parts


LAMBDAS = (0.0, 0.5, 1.0)


def phenol(n_water, dtype, device, overlap=False):
    """(SolvationSystem, positions, box, cell spec retuned to them) of one
    phenol in n_water q-SPC/Fw waters at the default 0.75 nm, reaction
    field: 1,000 waters give path (e)'s 2,941 atoms in a 3.113 nm box on a
    3^3 grid with half maps (K1), 200 give 541 atoms in 1.832 nm on a 2^3
    grid (K2). `overlap` moves the solute 0.15 nm into the solvent, so that
    waters sit inside its sigma as they do at small lambda."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import phenol_in_water
    from atomsmm_tpu_torch.ops.neighbors import retune_spec

    s, x, box, solute = phenol_in_water(n_water=n_water, neighbors=True,
                                        dtype=dtype, device=device)
    if overlap:
        x = x.clone()
        x[:13] += torch.tensor([0.12, 0.08, 0.05], dtype=dtype, device=device)
    solv = amm.SolvationSystem(s, solute)
    return solv, x, box, retune_spec(solv.neighbors, x, box)


def softcore_of(system):
    import atomsmm_tpu_torch as amm

    soft, = (f for f in system.forces
             if isinstance(f, amm.SoftcoreLennardJonesForce))
    return soft


def compare_softcore(tag, soft, spec, x, box, dev, results, lambdas=LAMBDAS):
    """The softcore form and its dlambda twin at each lambda (see compare)."""
    for lam in lambdas:
        for dlambda in (False, True):
            compare(f"{tag} softcore{' dlambda' if dlambda else ''} lambda "
                    f"{lam:g}", soft, spec, x, box, dev, results,
                    form=soft._pair_form({"lambda_vdw": lam},
                                         dlambda=dlambda))


def phase_kernels_alchemy(dev):
    """K1 (path (e)'s 3^3 grid) and K2 (200 waters, 2^3; also with the
    solute pushed into the solvent) in the softcore form and its dlambda
    twin at lambda 0, 0.5 and 1, the damped-smoothed form and the
    reaction-field form at lambda_coul = 0.5 (the solute's charges scaled);
    then the softcore form on K3 (path (e)'s tile list) against its twin."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import tilepair as tp

    f64 = torch.float64
    results = []
    for n_water, overlap, half in ((1000, False, True), (200, False, False),
                                   (200, True, False)):
        solv, x, box, spec = phenol(n_water, f64, "cpu", overlap)
        if spec.half_stencil != half:
            raise RuntimeError(f"phenol {n_water}: unexpected stencil")
        tag = (f"phenol{n_water}w{' overlap' if overlap else ''} grid "
               f"{spec.grid[0]}^3 cap {spec.cell_capacity}")
        compare_softcore(tag, softcore_of(solv), spec, x, box, dev, results)
        if overlap:
            continue
        full = solv.forces[0]
        ds = amm.DampedSmoothedForce(
            charge=full.charge, sigma=full.sigma, epsilon=full.epsilon,
            exclusions=full.exclusions, r_cut=0.75, r_switch=0.65, alpha=3.0)
        compare(f"{tag} damped-smoothed alpha 3", ds, spec, x, box, dev,
                results)
        compare(f"{tag} cutoff-RF lambda_coul 0.5", full, spec, x, box, dev,
                results, globals={"lambda_coul": 0.5})
        compare(f"{tag} solute-solute LJ (zero charges)", solv.forces[-1],
                spec, x, box, dev, results)
    # K3: the softcore form on path (e)'s tile list
    solv, x, box, _ = phenol(1000, f64, "cpu")
    soft = softcore_of(solv)
    form = soft._pair_form({"lambda_vdw": 0.5})
    for dtype in (f64, torch.float32):
        xd, bd = x.to(dev, dtype), box.to(dev, dtype)
        pp = {k: v.to(dev, dtype) for k, v in soft._per_particle().items()}
        spec = tp.make_tilepair_spec(box, x.shape[0], form.r_cut,
                                     exclusions=soft.exclusions,
                                     occupancy_from=x, device=dev)
        lst = tp.build_tile_pairs(spec, xd, bd)
        e_k, f_k = tp.tile_pair_energy_forces(form, xd, bd, pp, spec,
                                              *lst[:4], form.r_cut)
        e_p, f_p, _ = tile_plain(spec, form, xd, bd, pp, lst)
        results.append(("tile_pair",) + judge(
            "tile_pair phenol1000w softcore lambda 0.5", dtype, e_k, f_k,
            e_p, f_p) + (form_name(form),))
    return results


def phase_kernels_sampled(dev, x):
    """K1 and K2 (the full stencil on the same 3^3 grid) in the softcore
    form and its dlambda twin at lambda 0, 0.05, 0.5 and 1, at a
    configuration x that path (e) sampled at lambda_vdw = 0 (solvent inside
    the solute's sigma)."""
    import dataclasses

    import torch

    from atomsmm_tpu_torch.ops.neighbors import retune_spec

    f64 = torch.float64
    solv, _, box, _ = phenol(1000, f64, "cpu")
    x = x.to("cpu", f64)
    spec = retune_spec(solv.neighbors, x, box)
    results = []
    for half in (True, False):
        sp = dataclasses.replace(spec, half_stencil=half)
        compare_softcore(f"phenol1000w sampled at lambda_vdw 0, grid 3^3 "
                         f"cap {sp.cell_capacity}{'' if half else ' (K2)'}",
                         softcore_of(solv), sp, x, box, dev, results,
                         lambdas=(0.0, 0.05, 0.5, 1.0))
    return results


def phase_slice_alchemy(dev):
    """Phenol + 200 waters in float64, the card against the CPU: the
    multi-state energies at 4 states (rel 1e-10), dU/dlambda for both
    names (rel 1e-9; the softcore dlambda sweep, the quadratic rule), and
    5 outer AlchemicalRespaSystem RESPA [4, 2, 1] + NHC steps at
    lambda_vdw 0.5, lambda_coul 0 (no draw enters), positions and
    velocities to 1e-9 relative."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import alchemy
    from atomsmm_tpu_torch.models import phenol_in_water
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f64 = torch.float64
    steps, loops = 5, [4, 2, 1]
    lams = {"lambda_vdw": [0.0, 0.3, 0.7, 1.0],
            "lambda_coul": [0.0, 0.0, 0.5, 1.0]}
    runs = []
    for device in ("cpu", dev):
        base, x, box, solute = phenol_in_water(n_water=200, neighbors=True,
                                               dtype=f64, device=device)
        solv = amm.SolvationSystem(base, solute)
        es = alchemy.multistate_energies(solv, x, box, lams)
        ti = [alchemy.ti_gradient(solv, x, box, name, 0.5, {other: 0.7})
              for name, other in (("lambda_vdw", "lambda_coul"),
                                  ("lambda_coul", "lambda_vdw"))]
        ars = amm.AlchemicalRespaSystem(base, 0.45, 0.35, solute)
        m = ars.masses.cpu().numpy()
        v = np.random.RandomState(9).normal(size=(m.size, 3)) \
            * np.sqrt(amm.units.BOLTZMANN * 300.0 / m)[:, None]
        integ = amm.MultipleTimeScaleIntegrator(
            0.002, loops, temperature=300.0, time_scale=0.1,
            degrees_of_freedom=3 * m.size - 3)
        ctx = amm.Context(ars, integ, amm.make_state(
            x, v=torch.as_tensor(v, dtype=f64, device=device), box=box))
        ctx.set_parameter("lambda_vdw", 0.5)
        ctx.set_parameter("lambda_coul", 0.0)
        pk.reset_launches()
        ctx.step(steps)
        runs.append((es, torch.stack(ti), ctx.state, ars, dict(pk.LAUNCHES),
                     ctx.last_step_passes))
    (es_c, ti_c, st_c, ars, _, _), (es_g, ti_g, st_g, _, launches,
                                    passes) = runs
    # per pass, each force once more for the force-cache refresh: K1 runs
    # the near force (group 1) on the near grid; K2 the far force unfused
    # under the charge-scale mask (two sweeps, group 2), the softcore force
    # (group 1) and the solute-solute term (group 0) on the far grid
    per_outer = {2: loops[2], 1: loops[1] * loops[2],
                 0: loops[0] * loops[1] * loops[2]}
    expected = {"half_pair": passes * (per_outer[1] * steps + 1),
                "cell_pair": passes * (2 * (per_outer[2] * steps + 1)
                                       + per_outer[1] * steps + 1
                                       + per_outer[0] * steps + 1),
                "tile_pair": 0}
    e_err = float((es_g.cpu() - es_c).abs().max() / es_c.abs().max())
    ti_err = float(((ti_g.cpu() - ti_c).abs() / ti_c.abs()).max())
    md_err = max(float((a - b.cpu()).abs().max()) / float(a.abs().max())
                 for a, b in ((st_c.x, st_g.x), (st_c.v, st_g.v)))
    log(f"slice phenol200w float64 card vs CPU: multistate_energies at 4 "
        f"states {[round(float(e), 6) for e in es_g]} max rel diff "
        f"{e_err:.2e}; ti_gradient (vdw, coul) "
        f"{[round(float(t), 6) for t in ti_g]} max rel diff {ti_err:.2e}; "
        f"AlchemicalRespaSystem RESPA{loops}+NHC {steps} steps at "
        f"lambda_vdw 0.5, lambda_coul 0 (far grid {ars.neighbors.grid}, near "
        f"{ars.extra_neighbor_specs['near'].grid}; launches {launches}, "
        f"expected {expected}, passes {passes}): max rel diff {md_err:.2e} "
        f"(x, v)")
    if not (e_err < 1e-10 and ti_err < 1e-9 and md_err < 1e-9):
        raise RuntimeError("the alchemical slice on the card departs from "
                           "the CPU run")
    if launches != expected:
        raise RuntimeError(f"alchemical slice launches {launches}: expected "
                           f"{expected}")


def phase_alchemy(dev, evals=50, k_states=16):
    """Path (e): BASELINE config 3 at bench_alchemy's shape, float32. The
    multi-state evaluation (16 states, lambda_vdw = lambda_coul), timed
    over `evals` rows; then a short solvation free energy on
    coupling_path(linspace(0, 1, 4)) (n_equil 100, 8 samples 10 steps
    apart, velocity Verlet + OU at 300 K, 5/ps) from a configuration
    melted at the coupled state, with the temperature of each state, MBAR
    and TI; the float32 dU/dlambda_coul against float64 at one sample; one
    MD step split by force."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import alchemy
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux
    from atomsmm_tpu_torch.potential import _energy_and_forces
    from atomsmm_tpu_torch.utils import find_nonbonded_force

    f32 = torch.float32
    temp = 300.0
    solv, x, box, _ = phenol(1000, f32, dev)
    spec = solv.neighbors
    n = solv.num_particles
    if not (spec.half_stencil and spec.grid == (3, 3, 3)):
        raise RuntimeError(f"path (e): expected a 3^3 half-stencil grid, got "
                           f"{spec.grid}")
    aux = make_aux(solv, all_neighbor_extras(solv, x, box))
    lams = torch.linspace(0.0, 1.0, k_states)
    lambdas = {"lambda_vdw": lams, "lambda_coul": lams}
    alchemy.multistate_energies(solv, x, box, lambdas, aux=aux)
    torch.cuda.synchronize()
    pk.reset_launches()
    t0 = time.perf_counter()
    for _ in range(evals):
        rows = alchemy.multistate_energies(solv, x, box, lambdas, aux=aux)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row_launches = dict(pk.LAUNCHES)
    rows_per_s = evals / wall
    expected = {"half_pair": 3 * k_states * evals, "cell_pair": 0,
                "tile_pair": 0}
    log(f"path (e) phenol+1000w ({n} atoms, box {float(box[0]):.3f} nm, grid "
        f"{spec.grid} cap {spec.cell_capacity}) x {k_states} states float32 "
        f"multistate_energies: {rows_per_s:.3f} K-state rows/s "
        f"({rows_per_s * k_states:.1f} state-energies/s, "
        f"{wall / evals * 1e3:.3f} ms a row) on {smi_line()}; launches "
        f"{row_launches} (expected {expected}: the scaled NonbondedForce, "
        f"the softcore force and the solute-solute term, one K1 sweep each "
        f"per state); energies "
        f"{float(rows[0]):.4f} .. {float(rows[-1]):.4f} kJ/mol")
    if not (row_launches == expected and bool(torch.isfinite(rows).all())):
        raise RuntimeError("path (e) multi-state evaluation failed")

    # melt the builder lattice at the coupled state (velocity Verlet + OU,
    # the sampler's integrator), rescaling to 300 K after each chunk; the
    # last chunk is timed (one K1 sweep of each cell-list force a step)
    integ = amm.GlobalThermostatIntegrator(
        0.001, amm.VelocityVerletPropagator(),
        amm.OrnsteinUhlenbeckPropagator(temp, 5.0))
    ctx = amm.Context(solv, integ, amm.make_state(x, box=box, seed=5))
    ctx.set_velocities_to_temperature(temp, seed=6)
    for _ in range(5):
        ctx.step(60)
        t_now = float(ctx.temperature())
        if not t_now == t_now or t_now > 5000.0:
            raise RuntimeError(f"path (e) melt diverged (T {t_now} K)")
        ctx.set_velocities((temp / t_now) ** 0.5 * ctx.state.v)
    ctx.set_parameter("lambda_vdw", 1.0)
    ctx.set_parameter("lambda_coul", 1.0)
    ctx.step(1)
    torch.cuda.synchronize()
    pk.reset_launches()
    md_steps = 50
    t0 = time.perf_counter()
    ctx.step(md_steps)
    torch.cuda.synchronize()
    md_ms = (time.perf_counter() - t0) / md_steps * 1e3
    md_launches = dict(pk.LAUNCHES)
    passes = ctx.last_step_passes
    md_expected = {"half_pair": passes * 3 * (md_steps + 1), "cell_pair": 0,
                   "tile_pair": 0}
    x_melt = ctx.state.x.clone()
    log(f"path (e) MD phenol+1000w VV+OU 1 fs float32 at the coupled state: "
        f"{md_ms:.3f} ms/step ({0.001 * 86400 / md_ms:.3f} ns/day); launches "
        f"{md_launches} (expected {md_expected}, passes {passes}); T "
        f"{float(ctx.temperature()):.2f} K")
    if md_launches != md_expected:
        raise RuntimeError("path (e) MD launch count")

    # one MD step split by force: each force's energy and forces timed
    # alone with a synchronise after every call (the globals as the
    # Context holds them: 0-d tensors on the card)
    g = ctx.parameters
    run = ctx.system  # its cell capacities, retuned if the melt overflowed
    aux = make_aux(run, all_neighbor_extras(run, x_melt, box))

    scaled = solv.forces[find_nonbonded_force(solv)]
    solute_solute = solv.forces[-1]  # the second NonbondedForce
    bonded = [f for f in solv.forces if f.name in (
        "HarmonicBondForce", "HarmonicAngleForce", "PeriodicTorsionForce",
        "NonbondedExceptionsForce")]
    parts = {
        "scaled NonbondedForce (K1)": wall_ms(lambda: _energy_and_forces(
            scaled, x_melt, box, g, aux)),
        "SoftcoreLennardJonesForce (K1)": wall_ms(lambda: _energy_and_forces(
            softcore_of(solv), x_melt, box, g, aux)),
        "solute-solute NonbondedForce (K1)": wall_ms(
            lambda: _energy_and_forces(solute_solute, x_melt, box, g, aux)),
        "group-0 bonded (4 forces, autograd)": wall_ms(lambda: [
            _energy_and_forces(f, x_melt, box, g, aux) for f in bonded]),
        "bucket rebuild": wall_ms(lambda: all_neighbor_extras(run, x_melt,
                                                              box)),
    }
    counted = sum(parts.values())
    log("path (e) MD step split ({:.3f} ms/step): {}; rest (integrator, OU, "
        "Python) {:.3f} ms".format(md_ms, ", ".join(
            f"{k} {v:.3f} ms" for k, v in parts.items()), md_ms - counted))

    # the short solvation free energy from the melted configuration
    temps, sampled = {}, {}

    def reporter(k, c):
        temps.setdefault(k, []).append(float(c.temperature()))
        sampled[k] = c.state.x.clone()

    schedule = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
    pk.reset_launches()
    t0 = time.perf_counter()
    out = alchemy.solvation_free_energy(
        solv, x_melt, box, schedule, temp, n_equil=100, n_samples=8,
        sample_interval=10, friction=5.0, seed=7, reporter=reporter)
    torch.cuda.synchronize()
    dg_wall = time.perf_counter() - t0
    t_mean = {k: sum(v) / len(v) for k, v in sorted(temps.items())}
    f_k = out["f_k"]
    log(f"path (e) solvation_free_energy coupling_path(linspace(0, 1, 4)) "
        f"n_equil 100, 8 samples x 10 steps, VV+OU 300 K 5/ps, float32: "
        f"dg_mbar {out['dg_mbar']:.4f} +- {out['err_mbar']:.4f} kJ/mol, "
        f"dg_ti {out['dg_ti']:.4f} +- {out['err_ti']:.4f} kJ/mol; f_k "
        f"{[round(float(v), 5) for v in f_k]}; TI profile "
        f"{ {k: [round(float(v), 3) for v in p] for k, p in out['ti_profile'].items()} }; "
        f"mean T per state {[round(v, 2) for v in t_mean.values()]} K; "
        f"{dg_wall:.1f} s, launches {dict(pk.LAUNCHES)}")
    finite = all(torch.isfinite(torch.as_tensor(v)).all() for v in (
        out["dg_mbar"], out["dg_ti"], out["err_mbar"], out["err_ti"], f_k))
    checks = {
        "finite": bool(finite),
        "f_0": float(f_k[0]) == 0.0,
        "temperature": all(260.0 <= t <= 340.0 for t in t_mean.values())
        and len(t_mean) == 4,
    }
    require("path (e)", checks)

    # the quadratic dU/dlambda_coul in float32 against float64 at the last
    # sample, beside the sampling noise of its mean at that state
    xs64 = x_melt.double()
    solv64, _, box64, _ = phenol(1000, torch.float64, dev)
    g = {"lambda_vdw": 1.0}
    d32 = float(alchemy.ti_gradient(solv, x_melt, box, "lambda_coul", 0.5, g))
    d64 = float(alchemy.ti_gradient(solv64, xs64, box64, "lambda_coul", 0.5,
                                    g))
    log(f"path (e) dU/dlambda_coul at lambda_coul 0.5 (quadratic rule): "
        f"float32 {d32:.5f}, float64 {d64:.5f} kJ/mol, difference "
        f"{abs(d32 - d64):.5f} kJ/mol; block error of TI "
        f"{out['err_ti']:.4f} kJ/mol")
    return {"rows_per_s": rows_per_s, "row_launches": row_launches,
            "md_launches": md_launches, "md_ms": md_ms, "solv": run,
            "x": x_melt, "box": box, "sampled0": sampled[0], "parts": parts,
            "out": out, "temps": t_mean, "ti_f32_err": abs(d32 - d64)}


def phase_alchemy_timings(dev, alch):
    """K1 with the softcore form at path (e)'s grid and state, and K2 (the
    full stencil on the same grid), as time_cells times every shape."""
    import dataclasses

    from atomsmm_tpu_torch.ops.neighbors import retune_spec

    solv, x, box = alch["solv"], alch["x"].contiguous(), alch["box"]
    soft = softcore_of(solv)
    form = soft._pair_form({"lambda_vdw": 0.5})
    spec = retune_spec(solv.neighbors, x, box)
    return {
        ("half_pair", "softcore"): time_cells(
            "phenol1000w softcore lambda 0.5", soft, spec, x, box, form),
        ("cell_pair", "softcore"): time_cells(
            "phenol1000w softcore lambda 0.5 (full stencil)", soft,
            dataclasses.replace(spec, half_stencil=False), x, box, form),
    }


NPT_N_MOLECULES = 33334  # bench.py::bench_npt_100k: 100,002 atoms
NPT_FREQUENCY = 25


def attempts_due(step0, n, frequency):
    """Volume moves that step(n) attempts from counter step0: one after
    every step whose post-increment counter is frequency - 1 (mod
    frequency)."""
    return sum(1 for s in range(step0 + 1, step0 + n + 1)
               if s % frequency == frequency - 1)


def npt_water(dev, method, eq100, dtype=None):
    """BASELINE config 5 as bench.py::bench_npt_100k builds it: 33,334
    q-SPC/Fw waters with a MonteCarloBarostat (1 bar, 300 K, every 25
    steps), RESPASystem(0.6, 0.5), capacities retuned at the equilibrated
    state of bench_data/eq_water100k.npz; (respa, x, v, box) on the card."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    dtype = dtype or torch.float32
    system, _, _ = water_system(n_molecules=NPT_N_MOLECULES, neighbors=True,
                                method=method, dtype=dtype, device=dev)
    system = system.add_force(amm.MonteCarloBarostat(
        pressure=1.0, temperature=300.0, frequency=NPT_FREQUENCY))
    respa = amm.RESPASystem(system, rcut_in=0.6, rswitch_in=0.5)
    ex, ev, ebox = eq100
    respa = retune_neighbor_specs(respa, ex, ebox)
    t = [torch.as_tensor(a, dtype=dtype, device=dev) for a in (ex, ev, ebox)]
    return respa, t[0], t[1], t[2]


def compare_npt(dev, respa, x, box, method):
    """K1 against its plain twin at path (f)'s own shapes: the RESPA specs
    npt_water tuned at the state of eq_water100k (its far grid takes a
    block of more than 256 threads), the far and the near force, each in
    the energy form and in the virial form that gives path (f)'s
    pressures. The far force's float32 force scale is the unsplit force's
    wherever the smaller grids' checks take it (the fused damped far form,
    and the virial form)."""
    from atomsmm_tpu_torch.ops.pairfuncs import virial_form

    results = []
    near, far = pair_forces(respa)
    for virial in (False, True):
        for name, force, spec in (
                ("far", far, respa.neighbors),
                ("near", near, respa.extra_neighbor_specs["near"])):
            form = force._pair_form()
            unsplit = far.full if name == "far" and (
                virial or method == "pme") else None
            compare(f"water100k {method} {name} grid {spec.grid[0]}^3 cap "
                    f"{spec.cell_capacity}{' virial' if virial else ''}",
                    force, spec, x, box, dev, results, unsplit=unsplit,
                    form=virial_form(form) if virial else form)
    return results


def density(system, box):
    """g/cm^3 of the system's mass in the box."""
    import torch

    return float(system.masses.sum()) * 1.66053907e-3 / float(torch.prod(box))


def phase_npt(dev, eq100, method="cutoff", settle=100, calls=8,
              per_call=25):
    """Path (f): BASELINE config 5 at full size, 100,002 atoms (RESPA
    [4, 2, 1] @ 4 fs, NHC 300 K, MC barostat at 1 bar every 25 steps),
    float32: step(settle), then `calls` timed calls of step(per_call) with
    the temperature read after each."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import computers
    from atomsmm_tpu_torch.integrate import barostat as baro
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import pme

    dt, loops = 0.004, [4, 2, 1]
    respa, x, v, box = npt_water(dev, method, eq100)
    n = respa.num_particles
    kernel_checks = compare_npt(dev, respa, x, box, method)
    integ = amm.MultipleTimeScaleIntegrator(
        dt, loops, temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * 3 * NPT_N_MOLECULES - 3)
    ctx = amm.Context(respa, integ, amm.make_state(x, v=v, box=box))
    far, near = respa.neighbors, respa.extra_neighbor_specs["near"]
    ctx.step(settle)
    torch.cuda.synchronize()
    box0, rho0 = ctx.state.box.clone(), density(respa, ctx.state.box)
    ext0 = {k: int(ctx.state.extra[k]) for k in (baro.BARO_NATT,
                                                 baro.BARO_NACC,
                                                 baro.BARO_NBAD)}
    pk.reset_launches()
    pme.reset_evaluations()
    expected_att = 0
    per_call_runs = []  # (steps, attempts, passes) of each call
    temps = []
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        a = attempts_due(ctx.state.step, per_call, NPT_FREQUENCY)
        ctx.step(per_call)
        expected_att += a
        per_call_runs.append((per_call, a, ctx.last_step_passes))
        temps.append(float(ctx.temperature()))  # synchronises
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev_ms = start.elapsed_time(end)
    launches = dict(pk.LAUNCHES)
    recip = pme.EVALUATIONS["reciprocal"]
    steps = calls * per_call
    att, acc, bad = (int(ctx.state.extra[k]) - ext0[k] for k in (
        baro.BARO_NATT, baro.BARO_NACC, baro.BARO_NBAD))
    # per pass of step(k): near loops[1] times and far once per outer step,
    # one of each for the force-cache refresh, and per volume move e_old,
    # e_new and the refresh (one sweep of each grid each)
    kernel = {True: "half_pair", False: "cell_pair"}
    expected = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0}
    expected_recip = 0
    for k, a, passes in per_call_runs:
        expected[kernel[near.half_stencil]] += passes * (
            loops[1] * k + 1 + 3 * a)
        expected[kernel[far.half_stencil]] += passes * (k + 1 + 3 * a)
        if method == "pme":
            expected_recip += passes * (k + 1 + 3 * a)
    # the pressures at the end, on the virial form (outside the count): one
    # sweep of each grid
    virial_expected = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0}
    for spec in (near, far):
        virial_expected[kernel[spec.half_stencil]] += 1
    before = dict(pk.LAUNCHES)
    obs = computers.compute_observables(ctx.system, ctx.state, ctx.parameters,
                                        include_coulomb=False)
    p_at, p_mol = (float(obs[k]) for k in ("atomic_pressure",
                                           "molecular_pressure"))
    virial_launches = {k: pk.LAUNCHES[k] - before[k] for k in before}
    box1, rho1 = ctx.state.box, density(respa, ctx.state.box)
    dv = float(torch.prod(box1) / torch.prod(box0)) - 1.0
    pe = float(ctx.get_state(lite=True).potential_energy) / n
    xs, vs = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(vs).all())
    t_mean = sum(temps) / len(temps)
    ms = ev_ms / steps
    ns_day = dt * 1e-3 * steps / (ev_ms * 1e-3) * 86400.0
    name = "path (f)" + (" pme" if method == "pme" else "")
    pme_desc = ""
    if method == "pme":
        f = pair_forces(respa)[1].full
        pme_desc = (f" PME alpha {f.ewald_alpha:.5f}/nm grid {f.grid_shape} "
                    f"order {f.spline_order};")
    log(f"{name} water100k ({n} atoms) {method} NPT RESPA{loops}@"
        f"{dt*1e3:.0f}fs NHC 300 K, MC barostat 1 bar every "
        f"{NPT_FREQUENCY} steps, float32:{pme_desc} far grid {far.grid} cap "
        f"{ctx.system.neighbors.cell_capacity} ({kernel[far.half_stencil]}), "
        f"near grid {near.grid} cap "
        f"{ctx.system.extra_neighbor_specs['near'].cell_capacity} "
        f"({kernel[near.half_stencil]}); {steps} timed outer steps as {calls} "
        f"calls of step({per_call}) after step({settle}): {ms:.3f} ms per "
        f"outer step by CUDA events ({wall / steps * 1e3:.3f} ms host clock), "
        f"{ns_day:.3f} ns/day on {smi_line()}; attempts {att} (expected "
        f"{expected_att}), accepted {acc}, invalid trials {bad}; box "
        f"{float(box0[0]):.5f} -> {float(box1[0]):.5f} nm, density "
        f"{rho0:.5f} -> {rho1:.5f} g/cm^3 (dV/V {dv:+.4%}); launches "
        f"{launches} (expected {expected}, passes "
        f"{[p for _, _, p in per_call_runs]}); reciprocal evaluations {recip} "
        f"(expected {expected_recip}); kinetic T mean {t_mean:.2f} K over "
        f"{len(temps)} readings; PE/atom {pe:.4f} kJ/mol; pressure at the "
        f"end: atomic {p_at:.2f} bar, molecular {p_mol:.2f} bar (virial "
        f"sweeps {virial_launches}); finite {finite}")
    checks = {
        "finite": finite,
        "attempts": att == expected_att,
        "accepted": acc >= 1,
        "invalid_trials": bad == 0,
        "launches": launches == expected,
        "reciprocal_evaluations": recip == expected_recip,
        "temperature": 280.0 <= t_mean <= 320.0,
        "pe_per_atom": -14.6 <= pe <= -13.8,
        "volume": abs(dv) < 0.03,
        "pressures": all(abs(p) < float("inf") for p in (p_at, p_mol)),
        "virial_sweeps": virial_launches == virial_expected,
        "shape": tuple(xs.shape) == (n, 3) and tuple(vs.shape) == (n, 3),
    }
    require(name, checks)
    return {"launches": launches, "ms_per_step": ms, "ns_day": ns_day,
            "respa": ctx.system, "ctx": ctx, "loops": loops,
            "state": (xs.detach().cpu().numpy(), box1.cpu().numpy()),
            "virial_launches": virial_launches,
            "kernel_checks": kernel_checks}


def phase_npt_split(dev, run, name):
    """Where path (f)'s outer step and volume move go: each force group's
    evaluation (under PME also the reciprocal sum and its corrections
    alone) and the bucket rebuilds timed alone on the host clock with a
    synchronise after every call, times its count per outer step (as
    phase_step_split), and one volume move split into its trial build
    (molecular scaling and both grids' buckets at the trial box), its two
    energies, the rebuild and cache refresh at the end, and the rest
    (the Metropolis arithmetic)."""
    import torch

    from atomsmm_tpu_torch.context import refresh_force_caches
    from atomsmm_tpu_torch.integrate import barostat as baro
    from atomsmm_tpu_torch.integrate.propagators import StepContext
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pme
    from atomsmm_tpu_torch.potential import force_fn, potential_energy

    ctx = run["ctx"]
    respa, st, g = ctx.system, ctx.state, ctx.parameters
    loops = run["loops"]
    x, box = st.x, st.box
    aux = nb.make_aux(respa, st.extra)
    calls = {0: loops[0] * loops[1] * loops[2], 1: loops[1] * loops[2],
             2: loops[2]}

    pme_tag = " + PME)" if "pme" in name else ")"
    parts = {
        "group 0, autograd (TemplateBondedForce)": (wall_ms(lambda: force_fn(
            respa, {0})(x, box, g, aux)), calls[0]),
        "near (group 1, K1)": (wall_ms(lambda: force_fn(
            respa, {1})(x, box, g, aux)), calls[1]),
        "far (group 2, K1" + pme_tag: (
            wall_ms(lambda: force_fn(respa, {2})(x, box, g, aux)), calls[2]),
    }
    if "pme" in name:
        full = pair_forces(respa)[1].full
        parts["  of which reciprocal sum"] = (wall_ms(
            lambda: pme.pme_reciprocal_energy_forces(
                x, box, full.charge, float(full.ewald_alpha),
                full.grid_shape, full.spline_order)), calls[2])
        parts["  of which corrections"] = (wall_ms(
            lambda: pme.pme_corrections_forces(
                x, box, full.charge, full.exclusions,
                float(full.ewald_alpha))), calls[2])
    parts["bucket rebuilds (2 grids)"] = (wall_ms(
        lambda: nb.update_all_neighbors(respa, st.extra, x, box)), 1)
    split_log(name, run["ms_per_step"], parts, "integrator, NHC, flags, "
              f"Python; the volume move every {NPT_FREQUENCY} steps")
    prop = ctx._barostat
    sctx = StepContext(respa, g, 0.0)
    s_t = torch.tensor(1.001, dtype=x.dtype, device=x.device)

    def trial_build():
        xn = baro.molecular_scale(x, respa.molecule, respa.num_molecules,
                                  respa.masses, s_t)
        return xn, nb.all_neighbor_extras(respa, xn, box * s_t)

    x_new, trial_extras = trial_build()
    trial_aux = nb.make_aux(respa, trial_extras)
    move = {
        "whole attempt": wall_ms(lambda: prop._attempt(sctx, st)),
        "trial build (scaling + 2 grids' buckets)": wall_ms(trial_build),
        "e_old (2 K1 sweeps" + pme_tag: wall_ms(lambda: potential_energy(
            respa, x, box, g, aux=aux)),
        "e_new (the same at the trial box, on its buckets)": wall_ms(
            lambda: potential_energy(respa, x_new, box * s_t, g,
                                     aux=trial_aux)),
        "rebuild + cache refresh": wall_ms(lambda: refresh_force_caches(
            respa, st.with_extra(**nb.update_all_neighbors(
                respa, st.extra, x, box)), g)),
    }
    rest = move["whole attempt"] - sum(
        v for k, v in move.items() if k != "whole attempt")
    log("{} volume move split: {}; rest (uniforms, Metropolis, torch.where, "
        "move size) {:.3f} ms; per outer step at frequency {}: {:.3f} "
        "ms".format(name, ", ".join(f"{k} {v:.3f} ms" for k, v in
                                    move.items()), rest, NPT_FREQUENCY,
                    move["whole attempt"] / NPT_FREQUENCY))
    return parts, move


def phase_slice_npt(dev, steps=10, frequency=2):
    """216 waters (0.6 nm, RESPASystem(0.35, 0.3): K2 far on a 2^3 grid,
    K1 near on 4^3) with a MonteCarloBarostat every 2 steps, float64, 10
    outer RESPA [2, 2, 1] + NHC steps on the card against the CPU, the
    same uniforms fed to both through _uniforms: x, v and box to 1e-9,
    equal acceptances with at least one move accepted and one rejected,
    the atomic and molecular virials at the end to 1e-10 relative."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import computers
    from atomsmm_tpu_torch.integrate import barostat as baro
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f64 = torch.float64
    draws = np.random.RandomState(21).uniform(size=(steps, 2))
    runs = []
    for device in ("cpu", dev):
        s, x, box = water_system(n_molecules=216, r_cut=0.6, r_switch=0.5,
                                 seed=5, neighbors=True, dtype=f64,
                                 device=device)
        s = s.add_force(amm.MonteCarloBarostat(pressure=1.0, temperature=300.0,
                                               frequency=frequency))
        r = amm.RESPASystem(s, rcut_in=0.35, rswitch_in=0.3)
        m = r.masses.cpu().numpy()
        v = np.random.RandomState(9).normal(size=(m.size, 3)) \
            * np.sqrt(amm.units.BOLTZMANN * 300.0 / m)[:, None]
        integ = amm.MultipleTimeScaleIntegrator(
            0.002, [2, 2, 1], temperature=300.0, time_scale=0.1,
            degrees_of_freedom=3 * m.size - 3)
        ctx = amm.Context(r, integ, amm.make_state(
            x, v=torch.as_tensor(v, dtype=f64, device=device), box=box))
        it = iter(draws)

        def uniforms(state, it=it):
            u = next(it)
            return (torch.tensor(2.0 * u[0] - 1.0, dtype=f64,
                                 device=state.x.device),
                    torch.tensor(u[1], dtype=f64, device=state.x.device))

        ctx._barostat._uniforms = uniforms
        pk.reset_launches()
        ctx.step(steps)
        obs = computers.compute_observables(ctx.system, ctx.state, {},
                                            include_coulomb=False)
        runs.append((ctx, obs, dict(pk.LAUNCHES)))
    (cpu, obs_c, _), (gpu, obs_g, launches) = runs
    md_err = max(float((a - b.cpu()).abs().max()) / float(a.abs().max())
                 for a, b in ((cpu.state.x, gpu.state.x),
                              (cpu.state.v, gpu.state.v),
                              (cpu.state.box, gpu.state.box)))
    w_err = max(abs(float(obs_g[k]) - float(obs_c[k])) / abs(float(obs_c[k]))
                for k in ("atomic_virial", "molecular_virial"))
    att, acc = (int(gpu.state.extra[k]) for k in (baro.BARO_NATT,
                                                  baro.BARO_NACC))
    acc_cpu = int(cpu.state.extra[baro.BARO_NACC])
    log(f"slice water216 NPT float64 card vs CPU: far grid "
        f"{gpu.system.neighbors.grid} (K2), near "
        f"{gpu.system.extra_neighbor_specs['near'].grid} (K1); {steps} RESPA "
        f"[2, 2, 1] + NHC steps, barostat every {frequency} steps: attempts "
        f"{att}, accepted {acc} (CPU {acc_cpu}); box "
        f"{float(gpu.state.box[0]):.9f} nm; launches {launches}; max rel diff "
        f"{md_err:.2e} (x, v, box); virials atomic "
        f"{float(obs_g['atomic_virial']):.6f} molecular "
        f"{float(obs_g['molecular_virial']):.6f} kJ/mol, max rel diff "
        f"{w_err:.2e}")
    if not (md_err < 1e-9 and w_err < 1e-10 and att == steps // frequency
            and acc == acc_cpu and 0 < acc < att):
        raise RuntimeError("the NPT slice on the card departs from the CPU "
                           "run")


def phase_kernels_virial(dev, eq):
    """The virial form (each pair's -2 r^2 du/dr^2 in the energy column) on
    K1 and K2 against their plain twins in the reaction-field, near, fused
    far and damped PME forms, and on K3 once (the 30k damped far list)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import tilepair as tp
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs
    from atomsmm_tpu_torch.ops.pairfuncs import virial_form

    f64 = torch.float64
    results = []

    def check(label, force, spec, x, box, unsplit=None):
        compare(label, force, spec, x, box, dev, results, unsplit=unsplit,
                form=virial_form(force._pair_form()))

    s, x, box = water_system(n_molecules=400, r_cut=0.7, r_switch=0.6, seed=5,
                             neighbors=True, dtype=f64, device="cpu")
    r = amm.RESPASystem(s, rcut_in=0.45, rswitch_in=0.35)
    check("water400 cutoff-RF virial", s.forces[0], s.neighbors, x, box)
    check("water400 near virial", r.forces[1],
          r.extra_neighbor_specs["near"], x, box)
    check("water400 far virial", r.forces[2], r.neighbors, x, box,
          unsplit=s.forces[0])
    ex, _, ebox = eq
    s, _, _ = water_system(n_molecules=10000, method="pme", neighbors=True,
                           dtype=f64, device="cpu")
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    r = retune_neighbor_specs(r, ex, ebox, safety=1.03)
    xe, be = torch.as_tensor(ex, dtype=f64), torch.as_tensor(ebox, dtype=f64)
    check("water30k pme near (damped) virial", r.forces[1],
          r.extra_neighbor_specs["near"], xe, be)
    check("water30k pme far (fused damped) virial", r.forces[2],
          r.neighbors, xe, be, unsplit=s.forces[0])
    for method in ("cutoff", "pme"):
        s, x, box = water_system(n_molecules=700, seed=5, neighbors=True,
                                 dtype=f64, method=method, device="cpu")
        r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
        tag = f"water700 grid {s.neighbors.grid[0]}^3 {method}"
        check(f"{tag} full virial", s.forces[0], s.neighbors, x, box)
        check(f"{tag} far virial", r.forces[2], r.neighbors, x, box,
              unsplit=s.forces[0])
    # K3: the fused damped far form with the virial flag on the 30k list
    for dtype in (f64, torch.float32):
        xt, bt, lists = tile_lists(dev, eq, dtype, "pme")
        force, spec, lst, _ = lists["far"]
        form = virial_form(force._pair_form())
        pp = {k: v.to(dev, dtype) for k, v in force._per_particle().items()}
        e_k, f_k = tp.tile_pair_energy_forces(form, xt, bt, pp, spec,
                                              *lst[:4], form.r_cut)
        e_p, f_p, terms = tile_plain(spec, form, xt, bt, pp, lst)
        f_scale = None
        if dtype == torch.float32:  # the unsplit form's scales (compare)
            _, f_u, terms = tile_plain(
                spec, virial_form(lists["full"][0]._pair_form()), xt, bt,
                pp, lst)
            f_scale = float(f_u.abs().max())
        results.append(("tile_pair",) + judge(
            "tile_pair water30k pme far (fused damped) virial", dtype, e_k,
            f_k, e_p, f_p, e_scale=terms, f_scale=f_scale)
            + (form_name(form),))
    return results


def phase_npt_timings(dev, npt, small, eq, timings):
    """K1 at path (f)'s far and near shapes (100k, the state the RF run
    ended with) in the energy form and the virial form, K2 with the virial
    form on the water 700 far grid, and K3 with it on the 30k far list
    (bounded by the pairs K1 counted there, `timings` of phase_timings)."""
    import torch

    from atomsmm_tpu_torch.ops import tilepair as tp
    from atomsmm_tpu_torch.ops.pairfuncs import virial_form

    respa = npt["respa"]
    ex, ebox = npt["state"]
    x = torch.as_tensor(ex, dtype=torch.float32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=torch.float32, device=dev)
    near, far = pair_forces(respa)
    out = {}
    for label, force, spec in (("far", far, respa.neighbors),
                               ("near", near,
                                respa.extra_neighbor_specs["near"])):
        out[("half_pair", f"100k {label}")] = time_cells(
            f"water100k {label}", force, spec, x, box)
        out[("half_pair", f"100k {label} virial")] = time_cells(
            f"water100k {label} virial", force, spec, x, box,
            virial_form(force._pair_form()))
    s_sys, s_state = small["respa"], small["state"]
    force = s_sys.forces[-1]
    out[("cell_pair", "virial")] = time_cells(
        "water700 far virial", force, s_sys.neighbors, s_state.x,
        s_state.box, virial_form(force._pair_form()))
    xt, bt, lists = tile_lists(dev, eq, torch.float32)
    force, spec, lst, _ = lists["far"]
    form = virial_form(force._pair_form())
    pp = {k: v.to(dev) for k, v in force._per_particle().items()}
    order, hb, cb, wrap, _ = lst
    fs, ms = tp._stage(spec, xt, bt, pp, spec.excbits, order)
    k_ms = kernel_device_ms(lambda: tp.tile_pair_cuda(
        fs, ms, hb, cb, wrap, bt, form, form.r_cut), "tile_pair")
    p_ms = time_cuda(lambda: tp.tile_pair_plain(
        fs, ms, hb, cb, wrap, bt, form, form.r_cut), 3)
    c = timings[("half_pair", "far")]["counts"]
    live = int((hb < spec.n_blocks).sum())
    acc = tp.tile_pair_cuda(fs, ms, hb, cb, wrap, bt, form, form.r_cut)
    b = bound(form, c["pairs"], c["near_pairs"],
              live * spec.block_size * 2 * spec.block_size,
              nbytes(fs, ms, hb, cb, wrap, bt, acc))
    log(f"timing tile_pair water30k far virial: kernel {k_ms:.4f} ms, plain "
        f"float32 {p_ms:.4f} ms; bound {b['ms'] * 1e3:.2f} us by {b['by']}")
    out[("tile_pair", "virial")] = {"ms": k_ms, "plain_ms": p_ms, "bound": b}
    return out


# --- path (g): rigid water (SETTLE, SHAKE/RATTLE, HMR, TIP4P/Ew) -----------

G1_BANDS = {"T": (294.0, 308.0), "pe": (-15.1, -14.3), "drift": 0.15}
G2_BANDS = {"T": (294.0, 308.0), "pe": (-13.7, -12.8), "drift": 0.1}
# (g3): 8,000 sites at 300 K spread by ~1.5% (5 K); 30 K leaves room for
# the last relaxation of the melt
G3_T_BAND = (270.0, 330.0)
# (g3)'s conserved-energy drift, kJ/mol/atom/ps: after the melt the NHC
# takes up 0.02-0.05 kJ/mol/atom/ps from the structure still relaxing
# while the conserved energy moves by < 0.005 (float32 and float64,
# k1_ab/rigid_water_relaxation.py); heat made by the integrator at the
# uptake's rate would move the conserved energy as much
G3_DRIFT = 0.02


def rigid_run(builder, dev, steps, kw, hmr=False, respa=None, integ="nhc",
              dt=0.002):
    """One float64 run of a path (g) slice on `dev`: 216 molecules from the
    builder's lattice, velocities from one numpy draw (0 on massless rows),
    optionally HMR x3 and a RESPASystem split; `steps` outer steps of
    VV + NHC ("nhc"), LangevinMiddle at friction 0 ("langevin") or RESPA
    [1, 4, 1] + NHC ("respa"). Returns the Context and the kernel launches
    of the run."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import models
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f64 = torch.float64
    s, x, box = getattr(models, builder)(n_molecules=216, seed=5,
                                         neighbors=True, dtype=f64,
                                         device=dev, **kw)
    if hmr:
        s = amm.HydrogenMassRepartitionedSystem(s, factor=3.0)
    if respa:
        s = amm.RESPASystem(s, rcut_in=respa[0], rswitch_in=respa[1])
    m = s.masses.cpu().numpy()
    v = np.random.RandomState(9).normal(size=(m.size, 3)) * np.sqrt(
        amm.units.BOLTZMANN * 300.0 / np.where(m > 0, m, 1.0))[:, None]
    v[m == 0] = 0.0
    dof = amm.count_degrees_of_freedom(s)
    if integ == "respa":
        integrator = amm.MultipleTimeScaleIntegrator(
            dt, [1, 4, 1], temperature=300.0, time_scale=0.1,
            degrees_of_freedom=dof)
    elif integ == "langevin":
        integrator = amm.LangevinMiddleIntegrator(dt, 300.0, friction=0.0)
    else:
        integrator = amm.GlobalThermostatIntegrator(
            dt, amm.NoseHooverChainPropagator(300.0, dof, 0.1))
    ctx = amm.Context(s, integrator, amm.make_state(
        x, v=torch.as_tensor(v, dtype=f64, device=dev), box=box))
    pk.reset_launches()
    ctx.step(steps)
    return ctx, dict(pk.LAUNCHES)


def geometry_residual(system, x):
    """The largest relative constraint error: SETTLE's, else SHAKE's."""
    from atomsmm_tpu_torch.ops.constraints import constraint_residual
    from atomsmm_tpu_torch.ops.settle import settle_residual

    if system.settle is not None:
        return float(settle_residual(system.settle, x.double()))
    return float(constraint_residual(system.constraints, x.double()))


def phase_slice_rigid(dev):
    """Path (g)'s slices, float64, card against CPU (the plain twins
    there): 216 rigid TIP3P waters on SETTLE, VV + NHC, 10 steps at 0.5 nm
    (K1 on a 3^3 grid) and at 0.9 nm (K2 on a 1^3 grid); the same at 0.5 nm
    on SHAKE/RATTLE (analytic=False), 5 steps; HMR x3 +
    RESPASystem(0.45, 0.4) + RESPA [1, 4, 1] @ 16 fs + NHC, 5 outer steps
    (K2 far on 1^3, K1 near on 3^3; group 0 holds no force); 216 TIP4P/Ew
    at 0.5 nm, VV + NHC, 10 steps; LangevinMiddle at friction 0 on rigid
    TIP3P at 0.5 nm, 5 steps (the projection after the OU step). x and v
    to 1e-9 relative to their largest entry, every grid's kernel
    launched."""
    cases = {
        "tip3p settle 0.5 nm VV+NHC": ("rigid_water_system", 10, dict(
            r_cut=0.5, r_switch=0.4), {}),
        "tip3p settle 0.9 nm VV+NHC": ("rigid_water_system", 10, dict(
            r_cut=0.9, r_switch=0.8), {}),
        "tip3p shake 0.5 nm VV+NHC": ("rigid_water_system", 5, dict(
            r_cut=0.5, r_switch=0.4, analytic=False), {}),
        "tip3p HMR RESPA[1,4,1]@16fs": ("rigid_water_system", 5, dict(
            r_cut=0.9, r_switch=0.8), dict(hmr=True, respa=(0.45, 0.4),
                                           integ="respa", dt=0.016)),
        "tip4p/ew 0.5 nm VV+NHC": ("tip4p_water_system", 10, dict(
            r_cut=0.5, r_switch=0.4), {}),
        "tip3p LangevinMiddle friction 0": ("rigid_water_system", 5, dict(
            r_cut=0.5, r_switch=0.4), dict(integ="langevin")),
    }
    for label, (builder, steps, kw, opts) in cases.items():
        (cpu, _), (gpu, launches) = (
            rigid_run(builder, device, steps, kw, **opts)
            for device in ("cpu", dev))
        worst = max(float((a - b.cpu()).abs().max()) / float(a.abs().max())
                    for a, b in ((cpu.state.x, gpu.state.x),
                                 (cpu.state.v, gpu.state.v)))
        s = gpu.system
        specs = {"far": s.neighbors, **(s.extra_neighbor_specs or {})}
        used = {name: "half_pair" if spec.half_stencil else "cell_pair"
                for name, spec in specs.items()}
        log(f"slice (g) {label} float64, {s.num_particles} atoms, "
            + ", ".join(f"{name} grid {specs[name].grid} ({kernel})"
                        for name, kernel in used.items())
            + f", {steps} steps, card vs CPU: max rel diff {worst:.2e}; "
            f"geometry residual {geometry_residual(s, gpu.state.x):.1e}; "
            f"launches {launches}")
        if not (worst < 1e-9 and all(launches[k] > 0
                                     for k in used.values())):
            raise RuntimeError(f"slice (g) {label}: the card departs from "
                               "the CPU run or skipped a kernel")


def rigid_system(dev, eq, hmr_respa=False):
    """Config 6 (or 6c with hmr_respa) as bench_rigid_water builds it:
    rigid TIP3P waters at 0.9 nm with cell lists, as many as the state `eq`
    holds (10,000 in bench_data/eq_tip3p30k.npz), every water on SETTLE,
    retuned to that state at safety 1.03; 6c adds HMR x3 and
    RESPASystem(0.6, 0.5). Returns (system, dof)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import rigid_water_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    ex, _, ebox = eq
    m = len(ex) // 3
    system, _, _ = rigid_water_system(
        n_molecules=m, r_cut=0.9, r_switch=0.8, neighbors=True,
        dtype=torch.float32, device=dev)
    if system.constraints is not None or system.settle.size != m:
        raise RuntimeError("config 6: a water is off SETTLE")
    dof = amm.count_degrees_of_freedom(system)
    if hmr_respa:
        system = amm.RESPASystem(
            amm.HydrogenMassRepartitionedSystem(system, factor=3.0),
            rcut_in=0.6, rswitch_in=0.5)
    return retune_neighbor_specs(system, ex, ebox, safety=1.03), dof


def phase_rigid(dev, eq, hmr_respa=False, settle=250, steps=200, chunks=8,
                chunk=50):
    """Path (g1), config 6 (VV @ 2 fs + NHC), or (g2), config 6c (HMR x3,
    RESPA [1, 4, 1] @ 16 fs + NHC, the velocities resampled at seed 9), at
    30,000 atoms from bench_data/eq_tip3p30k.npz in float32 through
    Context.step: step(1), step(settle), a timed step(steps) (CUDA events;
    the conserved energy before and after), then `chunks` calls of
    step(chunk) with T and PE read after each. Checks finiteness, the
    SETTLE residual, the exact K1 launches of the timed call and
    bench.py's bands for T, PE per atom and drift."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f32 = torch.float32
    system, dof = rigid_system(dev, eq, hmr_respa)
    name, bands = ("path (g2)", G2_BANDS) if hmr_respa else ("path (g1)",
                                                            G1_BANDS)
    if hmr_respa:
        dt, loops = 0.016, [1, 4, 1]
        integ = amm.MultipleTimeScaleIntegrator(
            dt, loops, temperature=300.0, time_scale=0.1,
            degrees_of_freedom=dof)
    else:
        dt = 0.002
        integ = amm.GlobalThermostatIntegrator(
            dt, amm.NoseHooverChainPropagator(300.0, dof, 0.1))
    ex, ev, ebox = eq
    n = system.num_particles
    ctx = amm.Context(system, integ, amm.make_state(
        torch.as_tensor(ex, dtype=f32, device=dev),
        v=torch.as_tensor(ev, dtype=f32, device=dev),
        box=torch.as_tensor(ebox, dtype=f32, device=dev)))
    if hmr_respa:
        # the stored velocities were drawn for the physical masses
        ctx.set_velocities_to_temperature(300.0, seed=9)
    ctx.step(1)
    ctx.step(settle)
    torch.cuda.synchronize()
    e0 = float(ctx.conserved_energy())
    pk.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    ctx.step(steps)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / steps
    launches = dict(pk.LAUNCHES)
    passes = ctx.last_step_passes
    e1 = float(ctx.conserved_energy())
    drift = (e1 - e0) / (n * steps * dt)
    x, v = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(x).all() and torch.isfinite(v).all())
    residual = geometry_residual(system, x)
    temps, pes = [], []
    for _ in range(chunks):
        ctx.step(chunk)
        temps.append(float(ctx.temperature()))
        pes.append(float(ctx.get_state(lite=True).potential_energy) / n)
    temp, pe = sum(temps) / chunks, sum(pes) / chunks
    # per pass of step(n): VV evaluates the forces once a step (the
    # trailing kick writes the cache the leading kick reads); RESPA
    # [1, 4, 1] the far force once and the near force 4 times an outer
    # step (group 0 holds no force); one more of each for the cache refresh
    per_step, refresh = (5, 2) if hmr_respa else (1, 1)
    expected = {"half_pair": passes * (per_step * steps + refresh),
                "cell_pair": 0, "tile_pair": 0}
    grids = ", ".join(
        f"{k} {spec.grid} cap {spec.cell_capacity}" for k, spec in
        {"far": ctx.system.neighbors,
         **(ctx.system.extra_neighbor_specs or {})}.items())
    ns_day = dt * 1e-3 * 86400.0 / (ms * 1e-3)
    scheme = (f"HMR x3 RESPA{loops}@{dt * 1e3:.0f}fs" if hmr_respa
              else f"VV@{dt * 1e3:.0f}fs")
    log(f"{name} tip3p30k SETTLE {scheme} NHC float32: grids {grids}; "
        f"{ms:.3f} ms/step by CUDA events ({wall / steps * 1e3:.3f} by the "
        f"host clock), {ns_day:.3f} ns/day; launches {launches} (expected "
        f"{expected}, passes {passes}); T {temp:.2f} K (band {bands['T']}; "
        f"reads {', '.join(f'{t:.2f}' for t in temps)}); PE/atom {pe:.4f} "
        f"kJ/mol (band {bands['pe']}; reads "
        f"{', '.join(f'{e:.4f}' for e in pes)}); drift {drift:.5f} "
        f"kJ/mol/atom/ps "
        f"(bound {bands['drift']}); SETTLE residual {residual:.2e}; finite "
        f"{finite}")
    checks = {
        "finite": finite,
        "launches": launches == expected,
        "settle_residual": residual <= 1e-4,
        "temperature": bands["T"][0] <= temp <= bands["T"][1],
        "pe_per_atom": bands["pe"][0] <= pe <= bands["pe"][1],
        "drift": abs(drift) <= bands["drift"],
    }
    require(name, checks)
    return {"ctx": ctx, "launches": launches, "ms_per_step": ms,
            "ns_day": ns_day, "dt": dt, "T": temp, "pe": pe,
            "drift": drift, "residual": residual}


def phase_tip4p(dev, n_molecules=2000, melt_steps=1600, steps=100, chunks=4,
                chunk=25):
    """Path (g3): 2,000 TIP4P/Ew waters (8,000 sites, 3.915 nm box, 0.9 nm
    reaction field, a 4^3 grid: K1) in float32, melted off the lattice at
    2 fs by chunked velocity rescaling (as path (a); T before each rescale
    and PE logged), then step(1), a timed step(steps) of VV @ 2 fs + NHC
    and `chunks` calls of step(chunk) with T, PE and the conserved energy
    read after each. Checks finiteness, the SETTLE residual, every M
    within 1e-6 nm of its placement, the M velocity rows exactly 0 (after
    the timed call), the mean T 270-330 K, the conserved-energy drift of
    the timed call and of the reads after it (per atom with mass) and the
    exact K1 launches. The thermostat's uptake over the reads is logged
    beside the drift: heat from the relaxing structure goes there."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import tip4p_water_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.virtual_sites import place_virtual_sites

    dt, temp0 = 0.002, 300.0
    system, x, box = tip4p_water_system(n_molecules=n_molecules,
                                        neighbors=True, dtype=torch.float32,
                                        device=dev)
    if not system.neighbors.half_stencil:
        raise RuntimeError("path (g3): expected a half-stencil grid (K1)")
    dof = amm.count_degrees_of_freedom(system)
    n = system.num_particles
    atoms = int((system.masses > 0).sum())  # the M sites carry no energy
    ctx = amm.Context(system, amm.GlobalThermostatIntegrator(
        dt, amm.NoseHooverChainPropagator(temp0, dof, 0.1)),
        amm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(temp0, seed=1)

    def pe():
        return float(ctx.get_state(lite=True).potential_energy) / atoms

    melt = []
    for _ in range(8):
        ctx.step(melt_steps // 8)
        t_now = float(ctx.temperature())
        if not t_now == t_now or t_now > 5000.0:
            raise RuntimeError(f"path (g3) melt diverged (T {t_now} K)")
        melt.append((t_now, pe()))
        ctx.set_velocities((temp0 / t_now) ** 0.5 * ctx.state.v)
    ctx.step(1)
    torch.cuda.synchronize()
    e0 = float(ctx.conserved_energy())
    pk.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    ctx.step(steps)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    launches = dict(pk.LAUNCHES)
    passes = ctx.last_step_passes
    expected = {"half_pair": passes * (steps + 1), "cell_pair": 0,
                "tile_pair": 0}
    e1 = float(ctx.conserved_energy())
    drift = (e1 - e0) / (atoms * steps * dt)
    xs, vs = ctx.state.x, ctx.state.v
    sites = system.virtual_sites.sites
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(vs).all())
    residual = geometry_residual(system, xs)
    m_err = float((place_virtual_sites(system.virtual_sites, xs)[sites]
                   - xs[sites]).abs().max())
    m_still = bool((vs[sites] == 0).all())
    bath0 = float(ctx.integrator.conserved_extra(ctx.state))
    reads = []  # (T, PE per atom)
    for _ in range(chunks):
        ctx.step(chunk)
        reads.append((float(ctx.temperature()), pe()))
    temp = sum(t for t, _ in reads) / chunks
    span = atoms * chunks * chunk * dt
    drift_reads = (float(ctx.conserved_energy()) - e1) / span
    uptake = (float(ctx.integrator.conserved_extra(ctx.state)) - bath0) / span
    ns_day = dt * 1e-3 * 86400.0 / (ms * 1e-3)
    log(f"path (g3) tip4p/ew {n_molecules} molecules ({n} sites) box "
        f"{float(box[0]):.3f} nm VV@2fs NHC float32: melt of {melt_steps} "
        f"steps, T before each rescale and PE/atom "
        + ", ".join(f"{t:.2f} K {e:.4f}" for t, e in melt)
        + f"; grid {system.neighbors.grid} cap "
        f"{ctx.system.neighbors.cell_capacity} (K1); {ms:.3f} ms/step, "
        f"{ns_day:.3f} ns/day; launches {launches} (expected {expected}, "
        f"passes {passes}); drift {drift:.5f} kJ/mol/atom/ps over the "
        f"timed call, {drift_reads:.5f} over the reads (bound "
        f"{G3_DRIFT}), the thermostat's uptake {uptake:.5f}; T {temp:.2f} "
        f"K (band {G3_T_BAND}); reads every {chunk} steps, T and PE/atom: "
        + ", ".join(f"{t:.2f} K {e:.4f}" for t, e in reads)
        + f"; SETTLE residual {residual:.2e}; max |M - placement| "
        f"{m_err:.2e} nm; M velocities zero {m_still}; finite {finite}")
    checks = {
        "finite": finite,
        "launches": launches == expected,
        "settle_residual": residual <= 1e-4,
        "m_placement": m_err <= 1e-6,
        "m_velocities": m_still,
        "temperature": G3_T_BAND[0] <= temp <= G3_T_BAND[1],
        "drift": max(abs(drift), abs(drift_reads)) <= G3_DRIFT,
    }
    require("path (g3)", checks)
    return {"ctx": ctx, "launches": launches, "ms_per_step": ms,
            "ns_day": ns_day, "drift": drift, "T": temp}


def phase_kernels_rigid(dev, g1, g2, g3):
    """K1 against its plain twin, float64 and float32, at path (g)'s own
    grids and capacities and the states its runs ended with: (g1)'s 0.9 nm
    grid (cutoff-RF form), (g2)'s near (0.6 nm) and fused far grids and
    (g3)'s TIP4P/Ew grid (the M site 0.0125 nm from its O, excluded from
    its own molecule)."""
    results = []
    for label, run in (("tip3p30k", g1), ("tip3p30k hmr", g2),
                       ("tip4p8k", g3)):
        s, st = run["ctx"].system, run["ctx"].state
        x, box = st.x.detach().cpu().double(), st.box.detach().cpu().double()
        if s.extra_neighbor_specs:
            near, far = pair_forces(s)
            compare(f"{label} near", near, s.extra_neighbor_specs["near"],
                    x, box, dev, results)
            compare(f"{label} far", far, s.neighbors, x, box, dev, results,
                    unsplit=far.full)
        else:
            compare(f"{label} cutoff-RF", s.forces[0], s.neighbors, x, box,
                    dev, results)
        if not s.neighbors.half_stencil:
            raise RuntimeError(f"{label}: expected K1 on the far grid")
    return results


def phase_rigid_timings(dev, g1, g2, g3):
    """Path (g) on the clock: K1 at (g1)'s grid, (g2)'s near and far grids
    and (g3)'s grid (time_cells: device time, plain twin, bound); SETTLE's
    two stages, the virtual-site placement and pull-back by CUDA events
    with their device operations per call (torch.profiler); (g1)'s step
    split by part and (g2)'s outer step by group, each part timed alone on
    the host clock with a synchronise after every call, times its count
    per step; the device operations per step of (g1), (g2) and (g3)."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops.settle import (
        settle_positions,
        settle_velocities,
    )
    from atomsmm_tpu_torch.ops.virtual_sites import (
        place_virtual_sites,
        pull_back_forces,
    )
    from atomsmm_tpu_torch.potential import force_fn

    out = {}
    for key, run in (("g1", g1), ("g2", g2), ("g3", g3)):
        s, st = run["ctx"].system, run["ctx"].state
        if s.extra_neighbor_specs:
            near, far = pair_forces(s)
            out[("half_pair", f"{key} near")] = time_cells(
                f"path ({key}) near", near, s.extra_neighbor_specs["near"],
                st.x, st.box)
            out[("half_pair", f"{key} far")] = time_cells(
                f"path ({key}) far", far, s.neighbors, st.x, st.box)
        else:
            out[("half_pair", key)] = time_cells(
                f"path ({key})", s.forces[0], s.neighbors, st.x, st.box)

    def ops_per_call(fn):
        return len(device_kernels(fn, reps=5)) / 5

    # SETTLE at 30k (g1's state), the virtual sites at 8,000 (g3's)
    s, st = g1["ctx"].system, g1["ctx"].state
    ss, m, x, v = s.settle, s.masses, st.x, st.v
    x_unc = x + 0.002 * v
    ops = {
        "settle_positions": (lambda: settle_positions(ss, x_unc, x, m)),
        "settle_velocities": (lambda: settle_velocities(ss, x, v, m)),
    }
    s4, st4 = g3["ctx"].system, g3["ctx"].state
    vs4 = s4.virtual_sites
    f4 = torch.randn_like(st4.x)
    ops["place_virtual_sites"] = (lambda: place_virtual_sites(vs4, st4.x))
    ops["pull_back_forces"] = (lambda: pull_back_forces(vs4, st4.x, f4))
    cops = {name: {"ms": time_cuda(fn, 50), "ops": ops_per_call(fn)}
            for name, fn in ops.items()}
    out["constraint_ops"] = cops
    log("timing path (g) constraint ops, float32: " + "; ".join(
        f"{k} {t['ms']:.4f} ms by CUDA events, {t['ops']:.0f} device "
        f"operations a call" for k, t in cops.items())
        + f" (SETTLE on {ss.size} waters, the placement on {vs4.size} "
        "sites)")

    # (g1): one VV + NHC step by part
    aux = nb.make_aux(s, st.extra)
    g = g1["ctx"].parameters
    parts = {
        "forces (K1 sweep)": (wall_ms(lambda: force_fn(s)(x, st.box, g,
                                                           aux)), 1),
        "settle_positions": (wall_ms(ops["settle_positions"]), 1),
        "settle_velocities": (wall_ms(ops["settle_velocities"]), 2),
        "bucket rebuild": (wall_ms(lambda: nb.update_all_neighbors(
            s, st.extra, x, st.box)), 1),
    }
    split_log("path (g1)", g1["ms_per_step"], parts,
              "NHC, kicks, drift, Python")
    out["g1_split"] = parts
    # (g2): one RESPA [1, 4, 1] outer step by group
    s2, st2 = g2["ctx"].system, g2["ctx"].state
    x2, aux2, g = st2.x, nb.make_aux(s2, st2.extra), g2["ctx"].parameters
    parts = {
        "group 0 (no force)": (wall_ms(lambda: force_fn(s2, {0})(
            x2, st2.box, g, aux2)), 4),
        "near (group 1, K1)": (wall_ms(lambda: force_fn(s2, {1})(
            x2, st2.box, g, aux2)), 4),
        "far (group 2, K1)": (wall_ms(lambda: force_fn(s2, {2})(
            x2, st2.box, g, aux2)), 1),
        "settle_positions": (wall_ms(lambda: settle_positions(
            s2.settle, x2 + 0.004 * st2.v, x2, s2.masses)), 4),
        "settle_velocities": (wall_ms(lambda: settle_velocities(
            s2.settle, x2, st2.v, s2.masses)), 18),
        "bucket rebuilds (2 grids)": (wall_ms(lambda: nb.update_all_neighbors(
            s2, st2.extra, x2, st2.box)), 1),
    }
    split_log("path (g2)", g2["ms_per_step"], parts,
              "NHC, kicks, drifts, Python")
    out["g2_split"] = parts
    for key, run in (("g1", g1), ("g2", g2), ("g3", g3)):
        ctx = run["ctx"]
        out[f"{key}_ops_per_step"] = len(device_kernels(
            lambda: ctx.step(5))) / 5
    log("path (g) device operations per outer step (torch.profiler, "
        "step(5), the force-cache refresh and flag read of the call "
        "included): " + ", ".join(
            f"({k}) {out[f'{k}_ops_per_step']:.1f}" for k in ("g1", "g2",
                                                              "g3")))
    return out


# --- path (h): polarizable water (SWM4-NDP Drude oscillators), CMAP --------

# bench.py's bands for config 7 (swm4_10k_drude_el): the mixed kinetic
# temperature over every counted degree of freedom (the cold 1 K Drude
# oscillators pull it far below the 300 K atom bath), the atom bath's and
# the Drude relative motion's
H1_BANDS = {"T": (180.0, 240.0), "T_atoms": (280.0, 320.0),
            "T_drude_max": 10.0}
# the SCF's float32 floor: the update x_D += F_D / k loses steps below half
# an ulp of the coordinates, and the spring's force reads d = x_D - x_O to
# an ulp, so the relaxed Drude rows keep |F_D| of order k ulp(x); the bound
# is four of those at the run's largest coordinate
H2_ULPS = 4.0


def swm4(dev, drude_mass=0.4, n_molecules=2000):
    """Config 7's system as bench_swm4_drude builds it: SWM4-NDP waters at
    0.9 nm reaction field with cell lists, float32, on the card."""
    import torch

    from atomsmm_tpu_torch.models import swm4_water_system

    system, x, box = swm4_water_system(
        n_molecules=n_molecules, r_cut=0.9, r_switch=0.8,
        drude_mass=drude_mass, neighbors=True, dtype=torch.float32,
        device=dev)
    if not system.neighbors.half_stencil:
        raise RuntimeError("path (h): expected a half-stencil grid (K1)")
    return system, x, box


def drude_checks(system, state):
    """Finiteness, the SETTLE residual, the largest core-Drude distance,
    the M sites' distance from their placement and whether their velocity
    rows are exactly zero, at `state`."""
    import torch

    from atomsmm_tpu_torch.integrate.drude import find_drude_set
    from atomsmm_tpu_torch.ops.drude import drude_displacements
    from atomsmm_tpu_torch.ops.virtual_sites import place_virtual_sites

    xs, vs = state.x, state.v
    sites = system.virtual_sites.sites
    d = drude_displacements(find_drude_set(system), xs)
    return {
        "finite": bool(torch.isfinite(xs).all() and torch.isfinite(vs).all()),
        "residual": geometry_residual(system, xs),
        "d_max": float(torch.linalg.norm(d, dim=1).max()),
        "m_err": float((place_virtual_sites(system.virtual_sites, xs)[sites]
                        - xs[sites]).abs().max()),
        "m_still": bool((vs[sites] == 0).all()),
    }


def phase_swm4(dev, melt=800, steps=150, reads=4, chunk=250):
    """Path (h1), config 7 exactly as bench_swm4_drude runs it: 2,000
    SWM4-NDP waters (10,000 sites, 3.91 nm box, 0.9 nm RF, K1),
    DrudeLangevinIntegrator(1 fs, 300 K; the Drude bath at 1 K, 20/ps) in
    float32: velocities at 300 K (seed 9), step(1), step(melt),
    retune_neighbors(), step(1), a timed step(steps) (CUDA events), then
    `reads` calls of step(chunk) with T and PE read after each (bench.py's
    telemetry), and drude_temperatures at the end. Checks bench.py's bands
    (mixed T, T_atoms, T_drude), the SETTLE residual, the core-Drude
    distances (< 0.05 nm), the M sites placed and at rest, finiteness and
    the exact K1 launches of the timed call (1 a step + 1 a pass)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.drude import drude_temperatures

    dt = 0.001
    system, x, box = swm4(dev)
    n = system.num_particles
    integ = amm.DrudeLangevinIntegrator(dt, 300.0, system=system)
    ctx = amm.Context(system, integ, amm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=9)
    ctx.step(1)
    ctx.step(melt)
    ctx.retune_neighbors()
    ctx.step(1)
    torch.cuda.synchronize()
    pk.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    ctx.step(steps)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / steps
    launches = dict(pk.LAUNCHES)
    passes = ctx.last_step_passes
    expected = {"half_pair": passes * (steps + 1), "cell_pair": 0,
                "tile_pair": 0}
    temps, pes = [], []
    for _ in range(reads):
        ctx.step(chunk)
        temps.append(float(ctx.temperature()))
        pes.append(float(ctx.get_state().potential_energy) / n)
    temp = sum(temps) / reads
    t_atoms, t_drude = (float(t) for t in drude_temperatures(
        integ.thermostat.drude, ctx.state.v, system.masses,
        n_constraints=system.num_constraints))
    c = drude_checks(system, ctx.state)
    ns_day = dt * 1e-3 * 86400.0 / (ms * 1e-3)
    spec = ctx.system.neighbors
    log(f"path (h1) swm4-ndp {system.num_molecules} molecules ({n} sites) "
        f"box {float(box[0]):.3f} nm Drude-EL@1fs float32: grid {spec.grid} "
        f"cap {spec.cell_capacity} (K1); {ms:.3f} ms/step by CUDA events "
        f"({wall / steps * 1e3:.3f} by the host clock), {ns_day:.3f} "
        f"ns/day; launches {launches} (expected {expected}, passes "
        f"{passes}); T {temp:.2f} K (band {H1_BANDS['T']}; reads "
        f"{', '.join(f'{t:.2f}' for t in temps)}); PE/site "
        f"{', '.join(f'{e:.4f}' for e in pes)} kJ/mol; T_atoms {t_atoms:.2f} "
        f"K (band {H1_BANDS['T_atoms']}), T_drude {t_drude:.3f} K (max "
        f"{H1_BANDS['T_drude_max']}); SETTLE residual {c['residual']:.2e}; "
        f"max |x_D - x_O| {c['d_max']:.5f} nm; max |M - placement| "
        f"{c['m_err']:.2e} nm; M velocities zero {c['m_still']}; finite "
        f"{c['finite']}")
    checks = {
        "finite": c["finite"],
        "launches": launches == expected,
        "settle_residual": c["residual"] <= 1e-4,
        "displacements": c["d_max"] < 0.05,
        "m_placement": c["m_err"] <= 1e-6,
        "m_velocities": c["m_still"],
        "temperature": H1_BANDS["T"][0] <= temp <= H1_BANDS["T"][1],
        "t_atoms": H1_BANDS["T_atoms"][0] <= t_atoms <= H1_BANDS["T_atoms"][1],
        "t_drude": t_drude <= H1_BANDS["T_drude_max"],
    }
    require("path (h1)", checks)
    return {"ctx": ctx, "launches": launches, "ms_per_step": ms,
            "ns_day": ns_day, "T": temp, "T_atoms": t_atoms,
            "T_drude": t_drude}


def phase_swm4_scf(dev, h1, steps=20, n_iter=12):
    """Path (h2): the same 2,000 waters with massless Drudes
    (drude_mass=0) at (h1)'s final positions, each pair's momentum on its
    core and the Drude rows at rest, under DrudeSCFIntegrator(1 fs,
    n_iter, 300 K, 5/ps) in float32: step(1), then a timed step(steps).
    Checks finiteness, the Drude velocity rows exactly 0, the SETTLE
    residual, the displacements, the M sites, the exact K1 launches
    (n_iter + 1 a step + 1 a pass) and the force left on the Drude rows:
    at most H2_ULPS k ulp(max|x|) (the float32 floor of the fixed point)."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    dt = 0.001
    system, _, _ = swm4(dev, drude_mass=0.0)
    st = h1["ctx"].state
    m = h1["ctx"].system.masses[:, None]
    v = st.v.clone()
    v[0::5] = (m[0::5] * v[0::5] + m[1::5] * v[1::5]) / (m[0::5] + m[1::5])
    v[1::5] = 0.0
    ctx = amm.Context(system, amm.DrudeSCFIntegrator(
        dt, n_iter=n_iter, temperature=300.0, friction=5.0, system=system),
        amm.make_state(st.x, v=v, box=st.box))
    ctx.step(1)
    torch.cuda.synchronize()
    pk.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    ctx.step(steps)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    launches = dict(pk.LAUNCHES)
    passes = ctx.last_step_passes
    expected = {"half_pair": passes * ((n_iter + 1) * steps + 1),
                "cell_pair": 0, "tile_pair": 0}
    c = drude_checks(system, ctx.state)
    d_still = bool((ctx.state.v[1::5] == 0).all())
    f = ctx.get_state().forces
    f_drude = float(f[1::5].abs().max())
    f_max = float(f.abs().max())
    x_max = float(ctx.state.x.abs().max())
    k = float(system.forces[1].drude.k.max())
    ulp = float(np.spacing(np.float32(x_max)))
    f_bound = H2_ULPS * k * ulp
    temp = float(ctx.temperature())
    ns_day = dt * 1e-3 * 86400.0 / (ms * 1e-3)
    log(f"path (h2) swm4-ndp SCF ({n_iter} iterations) @1fs + OU 5/ps "
        f"float32, from (h1)'s positions: {ms:.3f} ms/step by CUDA events, "
        f"{ns_day:.3f} ns/day; launches {launches} (expected {expected}, "
        f"passes {passes}); max |F| on a Drude row {f_drude:.4f} kJ/mol/nm "
        f"= {f_drude / f_max:.2e} of max|F| {f_max:.1f} (bound "
        f"{H2_ULPS:g} k ulp(max|x| = {x_max:.3f} nm) = {f_bound:.4f}); T "
        f"{temp:.2f} K; Drude velocities zero {d_still}; SETTLE residual "
        f"{c['residual']:.2e}; max |x_D - x_O| {c['d_max']:.5f} nm; max |M "
        f"- placement| {c['m_err']:.2e} nm; M velocities zero "
        f"{c['m_still']}; finite {c['finite']}")
    checks = {
        "finite": c["finite"],
        "launches": launches == expected,
        "drude_velocities": d_still,
        "drude_forces": f_drude <= f_bound,
        "settle_residual": c["residual"] <= 1e-4,
        "displacements": c["d_max"] < 0.05,
        "m_placement": c["m_err"] <= 1e-6,
        "m_velocities": c["m_still"],
    }
    require("path (h2)", checks)
    return {"ctx": ctx, "launches": launches, "ms_per_step": ms,
            "ns_day": ns_day, "f_drude": f_drude, "f_max": f_max,
            "n_iter": n_iter}


def _place(a, b, c, torsion, bond=0.153, angle=1.95):
    """The next chain atom after a, b, c at the given bond length, angle
    and dihedral (a, b, c, d) = torsion (NeRF construction)."""
    import numpy as np

    bc = (c - b) / np.linalg.norm(c - b)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    return (c - bond * np.cos(angle) * bc
            + bond * np.sin(angle) * (np.cos(torsion) * m
                                      - np.sin(torsion) * n))


def phase_cmap(dev, n_terms=4096, res=24, seed=11):
    """Path (h3): CMAP and harmonic impropers on the card. A chain of
    n_terms + 4 atoms with random dihedrals (centred at the origin), n_terms
    CMAP terms (i..i+4) on one random periodic res x res surface, n_terms
    impropers (i..i+3) with random phi0 and k, in a 100 nm box; energy and forces (autograd)
    of both forces on the card in float64 and float32 against the float64
    CPU: 1e-12, and 1e-4 of the energy and of max|F|. Then each force's
    energy-and-forces call timed on the card in float32 (CUDA events,
    device operations a call)."""
    import numpy as np
    import torch

    from atomsmm_tpu_torch.forces import (
        CMAPTorsionForce,
        HarmonicImproperForce,
    )
    from atomsmm_tpu_torch.ops.cmap import build_cmap_table
    from atomsmm_tpu_torch.potential import force_fn
    from atomsmm_tpu_torch.system import System

    rs = np.random.RandomState(seed)
    x = [np.zeros(3), np.array([0.153, 0.0, 0.0]),
         np.array([0.2, 0.145, 0.0])]
    for t in rs.uniform(-np.pi, np.pi, n_terms + 1):
        x.append(_place(x[-3], x[-2], x[-1], t))
    x = np.stack(x)
    x -= x.mean(0)
    n = len(x)
    ang = -np.pi + 2 * np.pi * np.arange(res) / res
    p, q = np.meshgrid(ang, ang, indexing="ij")
    # a few random Fourier modes about a mean of 3 kJ/mol
    grid = 3.0 + sum(rs.normal(0, 2.0) * np.cos(a * p + b * q
                                               + rs.uniform(0, 2 * np.pi))
                     for a in range(4) for b in range(4))
    table = build_cmap_table(grid[None])
    cidx = np.stack([np.arange(i, i + 5) for i in range(n_terms)])
    iidx = np.stack([np.arange(i, i + 4) for i in range(n_terms)])
    phi0 = rs.uniform(-np.pi, np.pi, n_terms)
    k = rs.uniform(20.0, 400.0, n_terms)

    def build(device, dtype):
        def t(a, d=dtype):
            return torch.as_tensor(a, dtype=d, device=device)

        forces = (CMAPTorsionForce(idx=t(cidx, torch.int64),
                                   type_index=t(np.zeros(n_terms),
                                                torch.int64),
                                   table=t(table)),
                  HarmonicImproperForce(idx=t(iidx, torch.int64),
                                        phi0=t(phi0), k=t(k)))
        system = System(masses=t(np.full(n, 12.0)),
                        default_box=t(np.full(3, 100.0)),
                        molecule=t(np.zeros(n), torch.int32), forces=forces)
        return system, t(x), t(np.full(3, 100.0))

    cpu, xc, bc = build("cpu", torch.float64)
    out = {}
    for dtype in (torch.float64, torch.float32):
        card, xg, bg = build(dev, dtype)
        for i, force in enumerate(card.forces):
            one = card.replace_forces([force])
            e, f = force_fn(one)(xg, bg)
            e_c, f_c = force_fn(cpu.replace_forces([cpu.forces[i]]))(xc, bc)
            tol = 1e-12 if dtype == torch.float64 else 1e-4
            e_err = abs(float(e) - float(e_c)) / abs(float(e_c))
            f_err = float((f.double().cpu() - f_c).abs().max())
            f_max = float(f_c.abs().max())
            ok = (bool(torch.isfinite(f).all()) and e_err <= tol
                  and f_err <= tol * f_max)
            log(f"path (h3) {force.name} {n_terms} terms {str(dtype)[6:]} "
                f"card vs float64 CPU: E {float(e):.10g} vs {float(e_c):.10g} "
                f"rel {e_err:.2e}; max|dF| {f_err:.3e} of max|F| "
                f"{f_max:.4g} (tol {tol:g})")
            if not ok:
                raise RuntimeError(f"path (h3) {force.name} {dtype}: the "
                                   "card departs from the CPU")
            if dtype == torch.float32:
                fn = force_fn(one)
                out[force.name] = {
                    "ms": time_cuda(lambda: fn(xg, bg), 20),
                    "ops": len(device_kernels(lambda: fn(xg, bg), 5)) / 5}
    log("path (h3) timing, float32, energy and forces by autograd: " + "; ".join(
        f"{name} {t['ms']:.4f} ms by CUDA events, {t['ops']:.0f} device "
        f"operations a call" for name, t in out.items()))
    return out


def phase_kernels_swm4(dev, h1):
    """K1 against its plain twin, float64 and float32, at (h1)'s own grid
    and capacity and the state its run ended with: the Drudes off their
    cores, the Drude charges in the charge column (cutoff-RF form)."""
    results = []
    s, st = h1["ctx"].system, h1["ctx"].state
    compare("swm4 10k cutoff-RF", s.forces[0], s.neighbors,
            st.x.detach().cpu().double(), st.box.detach().cpu().double(),
            dev, results)
    return results


def phase_swm4_timings(dev, h1, h2):
    """Path (h) on the clock: K1 at (h1)'s grid (time_cells: device time,
    plain twin, bound); one (h1) step and one (h2) step split by part, each
    part timed alone on the host clock with a synchronise after every
    call, times its count per step; the device operations per step of
    (h1) and (h2) (torch.profiler)."""
    import dataclasses

    from atomsmm_tpu_torch.integrate.drude import (
        DrudeOrnsteinUhlenbeckPropagator,
        find_drude_set,
    )
    from atomsmm_tpu_torch.integrate.propagators import (
        OrnsteinUhlenbeckPropagator,
        StepContext,
    )
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops.drude import drude_scf_minimize
    from atomsmm_tpu_torch.ops.settle import (
        settle_positions,
        settle_velocities,
    )
    from atomsmm_tpu_torch.ops.virtual_sites import (
        place_virtual_sites,
        pull_back_forces,
    )
    from atomsmm_tpu_torch.potential import _energy_and_forces, force_fn

    out = {}
    s, st = h1["ctx"].system, h1["ctx"].state
    out[("half_pair", "h1")] = time_cells("path (h1)", s.forces[0],
                                          s.neighbors, st.x, st.box)

    def split(run, forces_label, scf_iters, bath, bath_label):
        """Each part of one step of `run` (force evaluations: scf_iters in
        the SCF loop, and the write kick's), timed alone."""
        ctx = run["ctx"]
        s, st, g = ctx.system, ctx.state, ctx.parameters
        x, v, box, m = st.x, st.v, st.box, s.masses
        aux = nb.make_aux(s, st.extra)
        vs = s.virtual_sites
        xe = place_virtual_sites(vs, x)
        f = force_fn(s)(x, box, g, aux)[1]
        # the bath without its projection: SETTLE's is timed on its own
        bare = StepContext(dataclasses.replace(s, settle=None,
                                               virtual_sites=None), g, 0.001)
        parts = {}
        if scf_iters:
            ds = find_drude_set(s)
            parts[f"SCF loop ({scf_iters} force evaluations)"] = (wall_ms(
                lambda: drude_scf_minimize(
                    lambda y: force_fn(s)(y, box, g, aux)[1], ds, x,
                    scf_iters), 5), 1)
        parts.update({
            forces_label: (wall_ms(lambda: force_fn(s)(x, box, g, aux)), 1),
            "  K1 sweep": (wall_ms(lambda: _energy_and_forces(
                s.forces[0], xe, box, g, aux)), 1),
            "  DrudeForce by autograd": (wall_ms(lambda: _energy_and_forces(
                s.forces[1], xe, box, g, aux)), 1),
            "  placement + pull-back": (wall_ms(lambda: (
                place_virtual_sites(vs, x), pull_back_forces(vs, x, f))), 1),
            "settle_positions": (wall_ms(lambda: settle_positions(
                s.settle, x + 0.001 * v, x, m)), 1),
            "settle_velocities": (wall_ms(lambda: settle_velocities(
                s.settle, x, v, m)), 4),
            bath_label: (wall_ms(lambda: bath.apply(bare, st, 0.5)), 2),
            "bucket rebuild": (wall_ms(lambda: nb.update_all_neighbors(
                s, st.extra, x, box)), 1),
        })
        return parts

    parts = split(h1, "forces (all groups)", 0,
                  DrudeOrnsteinUhlenbeckPropagator(
                      find_drude_set(h1["ctx"].system), 300.0, 5.0),
                  "Drude OU (without its projection)")
    split_log("path (h1)", h1["ms_per_step"], parts, "kicks, drift, Python")
    out["h1_split"] = parts
    parts = split(h2, "forces (the write kick)", h2["n_iter"],
                  OrnsteinUhlenbeckPropagator(300.0, 5.0),
                  "OU (without its projection)")
    split_log("path (h2)", h2["ms_per_step"], parts, "kicks, drift, Python")
    out["h2_split"] = parts
    for key, run, k in (("h1", h1, 5), ("h2", h2, 2)):
        ctx = run["ctx"]
        out[f"{key}_ops_per_step"] = len(device_kernels(
            lambda: ctx.step(k))) / k
    log("path (h) device operations per step (torch.profiler, step(5) and "
        "step(2), the force-cache refresh and flag read of the call "
        "included): " + ", ".join(
            f"({k}) {out[f'{k}_ops_per_step']:.1f}" for k in ("h1", "h2")))
    return out


def split_log(name, step_ms, parts, rest_of):
    """Log a step split: each part's ms x its count per step, and the rest
    of the measured step. A part whose name starts with two spaces is a
    piece of the part before it and is not counted again."""
    counted = sum(ms * k for p, (ms, k) in parts.items()
                  if not p.startswith("  "))
    log("{} split per outer step ({:.3f} ms/step): {}; rest ({}) {:.3f} "
        "ms".format(name, step_ms, ", ".join(
            f"{p.strip()} {ms:.3f} ms x {k}" for p, (ms, k) in parts.items()),
            rest_of, step_ms - counted))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    import numpy as np

    from atomsmm_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        _build.load(name)
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in libs.values())})")
    d = np.load(os.path.join(HERE, "bench_data", "eq_water30k.npz"))
    eq = (d["x"], d["v"], d["box"])
    d = np.load(os.path.join(HERE, "bench_data", "eq_water100k.npz"))
    eq100 = (d["x"], d["v"], d["box"])
    results = (phase_kernels(dev, eq) + phase_kernels_ionic(dev)
               + phase_kernels_alchemy(dev) + phase_tile_kernel(dev, eq)
               + phase_kernels_virial(dev, eq))
    phase_slice(dev, r_cut=0.7, r_switch=0.6, split=(0.45, 0.35))
    phase_slice(dev, split=(0.5, 0.4))
    phase_slice(dev, method="pme", split=(0.5, 0.4))
    phase_slice_ionic(dev)
    phase_slice_alchemy(dev)
    phase_slice_npt(dev)
    phase_slice_rigid(dev)
    main_run = phase_main(dev, eq)
    pme_run = phase_main(dev, eq, method="pme")
    small = phase_small_box(dev)
    tile_launches = phase_tile_path(dev, eq)
    ionic = phase_ionic(dev)
    alch = phase_alchemy(dev)
    npt = phase_npt(dev, eq100)
    npt_pme = phase_npt(dev, eq100, method="pme", calls=4)
    d = np.load(os.path.join(HERE, "bench_data", "eq_tip3p30k.npz"))
    eq_tip3p = (d["x"], d["v"], d["box"])
    g1 = phase_rigid(dev, eq_tip3p)
    g2 = phase_rigid(dev, eq_tip3p, hmr_respa=True)
    g3 = phase_tip4p(dev)
    h1 = phase_swm4(dev)
    h2 = phase_swm4_scf(dev, h1)
    phase_cmap(dev)
    results += (phase_kernels_sampled(dev, alch["sampled0"])
                + npt["kernel_checks"] + npt_pme["kernel_checks"]
                + phase_kernels_rigid(dev, g1, g2, g3)
                + phase_kernels_swm4(dev, h1))
    timings = phase_timings(dev, main_run, small, eq)
    timings.update(phase_pme_timings(dev, pme_run, small, eq))
    timings.update(phase_ionic_timings(dev, ionic))
    timings.update(phase_alchemy_timings(dev, alch))
    timings.update(phase_npt_timings(dev, npt, small, eq, timings))
    timings.update(phase_rigid_timings(dev, g1, g2, g3))
    timings.update(phase_swm4_timings(dev, h1, h2))
    phase_step_split(dev, pme_run, "path (c)", [4, 2, 1])
    phase_step_split(dev, ionic, "path (d)", ionic["loops"])
    phase_npt_split(dev, npt, "path (f)")
    phase_npt_split(dev, npt_pme, "path (f) pme")

    def f32_err(kernel, prefix):
        return max(r[4] for r in results if r[0] == kernel
                   and r[2] == "float32" and prefix in r[1])

    def forms(kernel):
        """The forms a kernel was held in against its plain twin."""
        return sorted({r[6] for r in results if r[0] == kernel})

    # launches of each kernel on each path, each counted from zero over
    # that path's timed run
    by_path = {
        "main": {"half_pair": main_run["launches"]},
        "path_c": {"half_pair": pme_run["launches"]},
        "path_a": small["launches"],
        "path_b": {"tile_pair": tile_launches},
        "path_d": ionic["launches"],
        "path_e_rows": alch["row_launches"],
        "path_e_md": alch["md_launches"],
        "path_f": npt["launches"],
        "path_f_pme": npt_pme["launches"],
        "path_f_pressure": npt["virial_launches"],
        "path_g1": g1["launches"],
        "path_g2": g2["launches"],
        "path_g3": g3["launches"],
        "path_h1": h1["launches"],
        "path_h2": h2["launches"],
    }

    def entry(kernel, source, replaces, launches, err, key, shape, pme_key):
        # no single PyTorch call computes a cutoff pair sweep over cell
        # buckets or a tile list: library_ms is null
        t, tp_ = timings[key], timings[pme_key]
        return {"name": kernel, "route": "cuda",
                "launches_by_path": {path: counts.get(kernel, 0)
                                     for path, counts in by_path.items()},
                "source": f"atomsmm_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"]["ms"], "bound_by": t["bound"]["by"],
                "library_ms": None, "launch_ms": t["launch_ms"],
                "shape": shape, "pme_ms": tp_["ms"],
                "pme_plain_ms": tp_["plain_ms"], "forms": forms(kernel)}

    emim = {f"emim_{g}_{k}": (t["bound"]["ms"] if k == "bound_ms" else t[k])
            for g in ("far", "near") for k in ("ms", "plain_ms", "bound_ms")
            for t in (timings[("half_pair", f"emim {g}")],)}
    kernels = {"kernels": [
        entry("half_pair", "half_pair.cu", "atomsmm_tpu/ops/pallas_pair.py:240",
              pme_run["launches"], f32_err("half_pair", "water30k"),
              ("half_pair", "far"), "30k water far grid 7^3 cap 112, f32; "
              "launches: path (c), 30k PME; pme_ms: its damped far sweep",
              ("half_pair", "pme far")),
        entry("cell_pair", "cell_pair.cu", "atomsmm_tpu/ops/pallas_pair.py:87",
              small["launches"]["cell_pair"],
              f32_err("cell_pair", "water700"), ("cell_pair", "far"),
              "water 700 far grid 2^3 cap 456, f32", ("cell_pair", "pme far")),
        entry("tile_pair", "tile_pair.cu", "atomsmm_tpu/ops/tilepair.py:369",
              tile_launches, f32_err("tile_pair", "far"),
              ("tile_pair", "far"), "30k water 0.9 nm tile list, f32",
              ("tile_pair", "pme far")),
    ]}
    # K1 at path (d)'s two shapes (5,200 atoms, fused damped far form on the
    # 5^3 grid, damped near form on the 6^3 grid), float32
    kernels["kernels"][0].update(emim)
    # K1 and K2 with the softcore form at path (e)'s 3^3 grid (K2 on its
    # full stencil), float32; the bound counts the solute-solvent pairs
    for entry_, kernel in zip(kernels["kernels"], ("half_pair", "cell_pair")):
        t = timings[(kernel, "softcore")]
        entry_.update({"softcore_ms": t["ms"],
                       "softcore_plain_ms": t["plain_ms"],
                       "softcore_bound_ms": t["bound"]["ms"],
                       "softcore_bound_by": t["bound"]["by"]})
    # the virial form (path (f)'s pressure): K1 at path (f)'s far and near
    # shapes beside the energy form there, K2 on the water 700 far grid,
    # K3 on the 30k far list, float32
    k1 = kernels["kernels"][0]
    k1["path_f_max_abs_err"] = f32_err("half_pair", "water100k")
    for label in ("far", "near"):
        for form, key in (("", f"100k {label}"),
                          ("virial_", f"100k {label} virial")):
            t = timings[("half_pair", key)]
            k1.update({f"path_f_{form}{label}_ms": t["ms"],
                       f"path_f_{form}{label}_plain_ms": t["plain_ms"],
                       f"path_f_{form}{label}_bound_ms": t["bound"]["ms"]})
    for entry_, kernel in zip(kernels["kernels"][1:],
                              ("cell_pair", "tile_pair")):
        t = timings[(kernel, "virial")]
        entry_.update({"virial_ms": t["ms"], "virial_plain_ms": t["plain_ms"],
                       "virial_bound_ms": t["bound"]["ms"]})
    # path (g): K1 at (g1)'s grid, (g2)'s near and far grids and (g3)'s
    # TIP4P/Ew grid, float32, and its float32 error against the plain twin
    # at those grids
    k1["path_g_max_abs_err"] = f32_err("half_pair", "tip")
    for key in ("g1", "g2 near", "g2 far", "g3"):
        t = timings[("half_pair", key)]
        tag = key.replace(" ", "_")
        k1.update({f"path_{tag}_ms": t["ms"],
                   f"path_{tag}_plain_ms": t["plain_ms"],
                   f"path_{tag}_bound_ms": t["bound"]["ms"],
                   f"path_{tag}_bound_by": t["bound"]["by"]})
    # path (h): K1 at (h1)'s SWM4-NDP grid (the Drude charges in the charge
    # column), float32, and its float32 error against the plain twin there;
    # (h3)'s CMAP and improper evaluations are PyTorch operations, logged
    # above, not kernels
    k1["path_h_max_abs_err"] = f32_err("half_pair", "swm4")
    t = timings[("half_pair", "h1")]
    k1.update({"path_h_ms": t["ms"], "path_h_plain_ms": t["plain_ms"],
               "path_h_bound_ms": t["bound"]["ms"],
               "path_h_bound_by": t["bound"]["by"]})
    print(json.dumps(kernels), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
