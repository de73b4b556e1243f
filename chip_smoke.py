#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atomsmm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, one line each or more; any failure raises and the script exits
non-zero:

1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles csrc/half_pair.cu (K1), csrc/cell_pair.cu (K2),
   csrc/tile_pair.cu (K3) and csrc/block_pair.cu (K4) with nvcc (sm_90a)
   from the checkout, one nvcc per source, all at once (path (p) builds
   its user forms of K1 and K2 the same way);
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
     exclusion bitmask fits the whole table (the split form), and water
     2744 at 1.4 nm (cells above 256 atoms: blocks above 256 threads,
     several 128-slot chunks per candidate partition);
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
     at a configuration sampled at lambda_vdw = 0; the softcore float32
     energies are held to 1e-4 of the sum of the per-atom energy
     magnitudes (a sampled total can near-cancel);
   - K1's float32 energy error in the reaction-field form, localised at
     the 30k far grid and at path (f)'s far and near grids: K1's and K2's
     per-atom rows against their float64 twins on one bucket, their
     float32 sums and a float64 sum of the same rows (logged, not held);
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
   LangevinMiddle at friction 0, 5 steps: x and v to 1e-9 relative; then
   replica exchange: phenol + 60 waters (K2, 2^3), 4 replicas on
   coupling_path, friction 0, velocities from numpy,
   neighbor_update_every=4, 12 steps and one swap with pinned uniforms:
   x, v and box to 1e-9 relative, the swap energies to 1e-10, the same
   accept mask;
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
   from bench_data/eq_emim.npz in float32: step(30) to settle, then 60
   timed outer steps as 6 calls of step(10) with the kinetic temperature
   read after each (50 and 10 calls before path (o) joined the script); checks finiteness, the launch counts (11 sweeps per
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
   path (i): BASELINE config 3b at bench_hrex's shape (phenol + 1,000
   waters, skin 0.2, 3^3, SolvationSystem, 16 states on coupling_path,
   VV + OU 300 K 5/ps @ 1 fs, float32): a 200-step melt at the coupled
   state, a sequential Context timed over 100 steps at
   neighbor_update_every=5 and at 1, then HREXSampler(
   neighbor_update_every=5, seed=3): a warm chunk and swap, then 4 x
   (25 steps + attempt_swaps()) timed by CUDA events; checks no
   staleness or overflow flag (run() raises), each row's mean T 260-340
   K, the attempts exactly the eligible pairs, the acceptance in [0, 1],
   the K1 launches (3 a replica step + 3 a replica a run + 12 an
   eligible pair of a swap) and the rebuilds (1 a run + 1 a group);
   path (j): the 30k headline under Simulation (app.py), float32:
   minimize_energy (50 FIRE iterations on the cell lists, K1 on both
   grids) from the stored state, velocities at 300 K, the reporters
   (StateDataReporter every 25 steps, ExtendedStateDataReporter with
   pressures and the Coulomb energy every 50, PDB, XYZ of six atoms,
   centres of mass and the integrator variables every 100), step(100),
   save_checkpoint and save_system, step(100); then three times a fresh
   Simulation from load_system + load_checkpoint with the same
   reporters, step(100); checks PE and max|F| falling in FIRE, the rows
   at exactly the due steps, Total = PE + KE, every row's T and PE/atom
   above FIRE's minimum inside the bands of the witness of that start
   (J_BANDS, tests/quench_witness.py), finite pressures, every frame,
   each restored state bitwise equal to the saved one, the uninterrupted
   run within 3 x the continuations' spread of them (K1's atomics), and
   K1's launches as derived (2 a FIRE iteration a pass; 3 an outer step
   + 2 a pass of each step(n); 2 a lite and 6 a full snapshot, 4 an
   extended row); logs ms per FIRE iteration and per outer step with and
   without reporters, a full and a lite row in ms and in outer steps,
   the checkpoint and system I/O, profile_forces and profile_step, and a
   trace() file; then a resume that is deterministic end to end (216
   waters on K2 alone, float32, LangevinMiddle, which draws from the
   CUDA generator every step): the restored states and the continuations
   bitwise equal to the uninterrupted run;
   path (k): triclinic (3, 3) cells on K1 and K2, which round each slot
   in fractional coordinates through inv(H). (k1) the 30k stored state
   with its box as diag(L, L, L), every spec built for the matrix, on K1
   against K1 at the (3,) box, per group, float64 (1e-10, 1e-9 max|F|)
   and float32 (1e-4); (k2) the same state with the molecules' centres
   mapped affinely into a sheared reduced cell (SHEAR), 10 outer steps
   through Context.step in float32 and in float64: finite, T 280-320 K,
   ms per outer step; (k3) 400 waters in the sheared cell at 0.7 nm, RF
   and PME, 5 outer RESPA steps in float64 on the card against the CPU
   (1e-9); K1's and K2's launches over (k2) and (k3), counted from 0,
   equal to the count derived from the code (far 1 an outer step + 1 a
   pass, near 2 an outer step + 1 a pass); K1 and K2 against their plain
   twins at (k2)'s and (k3)'s grids, K1's device time at (k2)'s; (k4) PME
   against the plane-wave Ewald sum on tests/test_triclinic.py's sheared
   cell on the card (2e-5);
   path (l): Amber input, BASELINE config 6's state as 0.15 M NaCl: 54
   waters of bench_data/eq_tip3p30k.npz drawn by
   numpy.random.default_rng(7), no two closer than 1 nm, replaced by 27
   Na+ and 27 Cl- (Joung-Cheatham TIP3P ions, the Na+-Cl- row of the LJ
   table an NBFIX row, Luo & Roux's R_min and epsilon), 29,892 atoms,
   written as prmtop and inpcrd text by this script's writer
   (nacl_prmtop, models.peptide.inpcrd_text) and read by io.amber_system(method="pme",
   r_cut=0.9, rigid_water=True, neighbors=True) in float32: 600
   LangevinMiddle steps at 1 fs settle the ions, then (g1)'s integrator,
   step(1), a timed step(200), 8 x step(50) with T and PE read; checks
   lj_type set, every water on SETTLE, finiteness, the SETTLE residual,
   K1's launches (1 a step + 1 a pass), T 280-320 K, PE/atom inside
   L_BANDS (from the witness k1_ab/nacl_energy.py), |drift| <= 0.15; then
   K1 in the table forms against its plain twin at (l)'s grid and state
   (full PME and RF, near and fused far of RESPASystem(0.6, 0.5), the
   virial forms), the 10-12 variant (the OW-HW slot a 10-12 pair) on K1
   and on K2 (the far grid's full stencil), and K1's table form timed
   beside its Lorentz-Berthelot form on the same bucket; with a float64
   slice of 200 TIP3P + 2 Na+ + 2 Cl- from the same writer on K2, 10
   steps card vs CPU (x, v 1e-9, energies 1e-10);
   path (m): more than one rank (parallel/mesh.py, parallel/spatial.py,
   a mesh of replicas), through torch.distributed. (m1) path (f)'s system
   and integrator with PME under SpatialContext on a 1-rank DeviceMesh
   over NCCL: step(1), a timed step(100); checks the reciprocal path
   (the slab FFT: a real NCCL reduce_scatter and all_to_all on one rank),
   K2's exact launches over the rank's home cells (3 per outer step + 2
   per pass + 6 per volume move) and no K1 launch, the reciprocal
   evaluations, the attempts, no invalid trial, T 280-320 K, PE/atom
   -14.6 ... -13.8, |dV/V| < 3%; logs ms per outer step beside path (f)'s
   PME step of the same call; then K2 against its plain twin and timed on
   the full stencils of (m1)'s far (10^3 cap 136) and near (14^3 cap 60)
   grids. (m2) two gloo ranks spawned on this card (NCCL refuses two ranks
   on one GPU): the sharded far and near RF sweeps of config 5 equal the
   one-process K2 rows bit for bit in float32 and float64, 10 outer RF
   steps under SpatialContext leave the ranks' x, v and box bitwise equal
   and within M2_X_TOL / M2_V_TOL of a one-process full-stencil Context,
   and the atom-sharded reciprocal sum on a grid whose K1 two ranks do not
   divide agrees with the one-process sum (M2_PME_RTOL / M2_PME_FTOL).
   (m3) path (i)'s 16 replicas over two gloo ranks (8 a rank), a chunk of
   25 steps and a swap, against the one-process sampler at the same
   seeds: the same swap attempts, acceptance in [0, 1], each row's T
   260-340 K, state-steps/s of both;
   path (n): what the port ran on the CPU only, or raised on. (n1) path
   (f) (RF) with the 100,002-atom state's molecules moved into the
   sheared cell shear_cell(L) (SHEAR, as path (k) shears the 30k state):
   step(100), 12 timed x step(25), one volume move timed alone; path
   (f)'s bands, at least one acceptance and no invalid trial among the 12
   timed attempts, the cell's shape H / V^(1/3) kept to N1_SHAPE_TOL, K1
   launches 3 an outer step + 2 a pass + 6 a move; ms per outer step and
   per move beside path (f)'s RF of this call, (f)'s Context also timed
   over the same calls just before (n1)'s, and (n1)'s step and move
   split as path (f)'s. (n2) the exclusion table of nearest_neighbour_table
   (water's O-H bonds plus each oxygen's bond to its nearest oxygen,
   closed to 1-4: 17-64 columns, most excluded pairs far beyond +-14
   indices) at the 30k headline's far and near grids: K1, and K2 on the
   same grids' full stencils, in the split form against their float64
   plain twins (the tolerances above), then timed beside the bitmask
   form on the same bucket; and a float64 slice of a
   peptide-like chain (models.peptide: 36 atoms, 24 excluded partners
   a backbone carbon) in 201 TIP3P waters written as prmtop and inpcrd
   text and read by io.amber_system (PME 0.5 nm, a 3^3 grid, K1 in the
   split form), 10 steps card vs CPU (x, v 1e-9, energies 1e-10). (n3)
   the 30k state at a 2.0 nm cutoff: a 3^3 grid with half maps whose
   cells pass K1's 1,024 atoms, so the sweep takes K2 on the full
   stencil: K2 against its twin, 5 VV + NHC steps with the launches
   counted (K2 only), K2 timed. (n4) BASELINE config 1 (argon 4,096,
   float32, VV @ 2 fs, bench.py's melt) without a NeighborSpec, on the
   dense path (no kernel launched, |drift| <= N4_DRIFT), beside the same
   run on its cell list; the goldens' argon 864 and 27 waters under
   NonbondedForce(method='nocutoff'), float64, card against CPU (each
   force's energy and the forces to 1e-9);
   path (o): the 30k headline on block lists (ops/blocks.py):
   water_system(n_molecules=10000, neighbors="blocks"), RESPASystem(0.5,
   0.4) with the near force on its own block list, each list's K retuned
   at the stored state (retune_block_spec, safety 1.15), RF at 0.9 nm,
   RESPA [4, 2, 1] @ 4 fs + NHC at 300 K from bench_data/eq_water30k.npz,
   float32, no cut: the two list builds timed beside the cell buckets';
   K4 (csrc/block_pair.cu) against its plain twin at (o)'s own far and
   near lists in the RF forms and in path (c)'s damped PME forms (float64
   1e-10 / 1e-9 max|F|, float32 1e-4, the damped far form's float32 force
   tolerance of the unsplit max|F|); at step 0 the far and near sweeps on
   K4 against K1's on the headline's cell grids (float64) and the whole
   force of the step in float32; then step(1) and a timed step(100)
   against the headline's bands (T 280-320 K, PE/atom -14.6 ... -13.8,
   |drift| <= 0.1), with K4's launches counted (near 2 and far 1 an outer
   step, 2 a pass, no K1) and the ms per outer step beside the headline's
   of the same call (its ratio logged, no target);
   path (p): CustomNonbondedForce on K1 and K2 (ops/pairtrace.py traces
   and lowers the function, _build.build_user compiles it into the
   kernel). First the cold build of every user-form library the path runs,
   one nvcc each, all at once (its seconds logged). (p1) the headline's
   pair energy (switched LJ + reaction field over charge, sigma, epsilon)
   written in torch operations as a CustomNonbondedForce with the same
   exclusions, 0.9 nm on the 7^3 far grid (K1), the bonded terms as built,
   from bench_data/eq_water30k.npz, float32, MTS [4, 1] @ 2 fs + NHC 300 K
   (the pair force at 2 fs, the bonded terms at 0.5 fs; RESPASystem splits
   only NonbondedForce): at step 0 the user form's kernel against its
   float64 twin (float64 1e-10 / 1e-9 max|F|, float32 1e-4) and K1's
   float32 user form against K1's built-in lj_sw_rf form at one bucket
   (1e-4 of E and of max|F|); then step(1) and a timed step(100) against
   the headline's bands, K1's user-form launches counted (1 a step + 1 a
   pass, no built-in launch) and the callable cell sweep's calls (none);
   the same run with the built-in NonbondedForce, its ms per step beside;
   one evaluation by the callable sweep with autograd (the parent's
   route), timed and held against K1. (p2) Buckingham exp-6 (scaled by a
   global lambda) + erfc-damped Coulomb (exp, erfc, pow, where, clamp) on
   the 30k far grid (K1: the bitmask form, the split form with (n2)'s
   nearest-neighbour table, a sheared (3, 3) cell) and on path (a)'s
   water-700 far grid (K2: both exclusion forms): each against its float64
   twin in float64 and float32 for the energy and forces, the virial flag
   and dU/dlambda, then energy, energy and forces, virial and dU/dlambda
   through the force at each grid with the launches counted (4 on K1, 4
   on K2);
   path (p3): path (i)'s 16-row stack (config 3b) with its softcore force
   written as a CustomNonbondedForce whose function reads the row's
   lambda_vdw as a global: K1 and K2 (the full stencil of the same grid)
   compiled with the user form sweep the 16 rows in one launch, the rows'
   lambdas a (16, C) table of constants, float64 and float32 against the
   batched float64 twin, each row against its single-row launch (K2 bit
   for bit, K1 at the float32 tolerance); the user force's rows, energies,
   forces and dU/dlambda, against the built-in softcore force's in
   float64; an HREXSampler with the user force runs 5 batched steps with
   its launches counted (the user form one K1 launch a batched step + 1 a
   run); the batched launch beside the 16 single-row launches, by CUDA
   events. Path (p4): K3 compiled with (p1)'s user function on the 30k far
   tile list, float64 and float32, energy and virial flags, against its
   float64 twin and against K3's built-in lj_sw_rf form on the same list;
   both timed. Path (q1): the legacy 10-12 term with atoms of one LJ type
   that differ (an Amber slice: the peptide-like chain in TIP3P water,
   amber_system) on the card's dense path, card against CPU in float64,
   the force and 5 VV steps of the slice. Path (q2): a function of
   torch.atan lowers and runs on the kernels; one that does not lower
   (torch.sign) runs on the callable cell sweep on the card, counted in
   CALLABLE_SWEEPS with one warning, both card against CPU. The cutoff
   band: K1, K2, K3 and K4 in float32 at mask cutoffs 1e-12 either side
   of O-O pairs' float64 distances, against their float64 twins;
9. timings: each kernel's device time by CUDA events: its launch
   wrapper's calls back to back, queued behind a busy wait of the stream
   so that the host's launch rate does not enter, less its zero fill (and
   a user form's column block) timed the same way; K4 and its pack kernel
   by torch.profiler, which splits them; everything else by CUDA events:
   K1, its
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
   SETTLE's stages; the baths; (h2)'s SCF loop; the rebuild); K4 (its
   device time with the pack kernel its C entry point launches first),
   its launch wrapper, its sweep and its plain twin at path (o)'s far and
   near lists at the stored 30k state (RF, and the damped far form),
   bounded by the distinct pairs K1 counts on the same state, its sweep
   at most 4 device operations with one K4 launch (else the phase
   fails), and the slots it tested (its own count) logged as a share of
   the list's; K1 on (p1)'s user form and on (p2)'s at the 30k far grid
   beside the built-in form there, K2 on (p2)'s at path (a)'s far grid
   (device time, wrapper, sweep, plain twin, the lowered form's operations
   and its bound).

Then one JSON line of kernel results (its launches_by_path counts each
kernel over each path's run, path_j, path_k, path_m, path_n and path_o
included; K4's entry carries path (o)'s step time and its ratio to the
headline's, the list builds, its pack and K4 parts and its device
operations a sweep; K1's and K2's entries carry `user`: the user form's
time, plain time, bound, launches on (p), float32 error and build
seconds, K1's also (p1)'s step beside the built-in force's and the
parent's route; K2's entry carries its time, plain time and bound at (m1)'s
grids and at (n3)'s, K1's and K2's their split exclusion form's beside
the bitmask form at (n2)'s grids; with each
kernel's bound_ms,
bound_by, library_ms = null: no single PyTorch call computes these sweeps
(a cutoff pair sweep over cell buckets, a tile list or a block list);
ms is the kernel's device time by CUDA events (K4's by torch.profiler),
launch_ms the time of one call of its launch wrapper by CUDA events, both
of this run; K1's and K2's `user_rows` carry (p3)'s batched launch, the 16
single-row launches of the same rows, the plain twin, the bound and the
float32 error; K3's `user` (p4)'s user form beside its built-in form on
the same list), the nvidia-smi line again, and last {"ok": true,
"device": {...}}.
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
# a table form (NBFIX): the pair's row read from the type-pair table (two
# gathers, of integer index arithmetic and loads) in place of the
# Lorentz-Berthelot sigma (2 operations) and epsilon (a sqrt on the SFU);
# the 10-12 term of the full half: r^-10 (3), its energy (4) and du/dr^2 (7)
OPS_COMBINE = 2
OPS_HBOND = 14
# a user form (CustomNonbondedForce): the evaluation besides its lowered
# graph is OPS_EVAL less the charge product and the sigma mean, which the
# graph holds itself; the graph's own operations and special-function
# results are counted from its generated code (LoweredPair.counts)
OPS_USER_EVAL = OPS_EVAL - 1 - OPS_COMBINE


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
    """A cell spec with every tensor field on `dev`."""
    import dataclasses

    import torch

    return dataclasses.replace(spec, **{
        f.name: getattr(spec, f.name).to(dev)
        for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)})


def is_user(form):
    """Whether `form` is a user form (ops/pairtrace.py::UserForm)."""
    return hasattr(form, "lowered")


def user_form_in(form, force, dtype, globals, dev):
    """User form `form` (its flags kept) with `force`'s function lowered
    in `dtype`."""
    import dataclasses

    low = force.lowered(dtype, globals, dev)
    return dataclasses.replace(form, lowered=low,
                               consts=low.consts_of(globals, dev))


def plain_sweep(spec, form, x, box, pp, bucket):
    """The plain twin of the sweep the spec selects, float64, on the
    device of x: (energy, forces, sum of |per-atom energy|)."""
    import torch

    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import takes_half_stencil

    f64 = torch.float64
    x, box = x.to(f64), box.to(f64)
    pp = {k: v.to(f64) for k, v in pp.items()}
    plain = (pk.half_pair_plain if takes_half_stencil(spec)
             else pk.full_pair_plain)
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
    mask). A user form stages no charges: its slots and pairs depend on
    the positions, the cutoff and the exclusions alone."""
    import torch

    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import takes_half_stencil
    from atomsmm_tpu_torch.ops.pbc import minimum_image

    half = takes_half_stencil(spec) if half is None else half
    n = x.shape[0]
    if is_user(form):
        pp = {k: x.new_ones(n) for k in ("charge", "sigma", "epsilon")}
    hf, hm, cols = pk.stage(spec, x, pp, bucket)
    ncells, cap, _ = hf.shape
    hf_s = torch.cat([hf, hf.new_zeros((1, cap, 8))])
    ids = torch.cat([hm[..., 0], hm.new_full((1, cap), n)])
    nbr = spec.nbr_cells_half if half else spec.nbr_cells
    nbr = torch.where(nbr >= 0, nbr, ncells).long()
    rc2 = pk._rc2(form.r_cut, x.dtype)
    has_near = not is_user(form) and form.has_near
    near2 = form.n_rc ** 2 if has_near else 0.0
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
    if not is_user(form) and form.softcore:
        c["pairs"] = c["cross_pairs"]
    return c


def bound(form, pairs, near, slots, nbytes):
    """The least time of a pair sweep on this card (see the constants
    above), in ms: {"ms", "by", "ops_ms", "sfu_ms", "bytes_ms",
    "with_slots_ms"} for `pairs` distinct in-range pairs, each evaluated
    once, `near` of them inside the near cutoff, and `nbytes` read once and
    written once; with_slots_ms adds the `slots` slot tests. A user form
    counts OPS_USER_EVAL and its lowered graph's operations and special
    results (LoweredPair.counts)."""
    if is_user(form):
        c = form.lowered.counts()
        per = OPS_USER_EVAL + c["flops"] + (OPS_VIRIAL if form.virial else 0)
        ops, sfu = pairs * per, pairs * c["special"]
    else:
        damped = bool(form.alpha)
        per = OPS_EVAL + OPS_COMMON + (OPS_DAMPED if damped else 0) \
            + (OPS_VIRIAL if form.virial else 0) \
            - (OPS_COMBINE if form.table else 0) \
            + (OPS_HBOND if form.hbond else 0)
        if form.has_full:
            per += OPS_FULL["smoothed" if form.smoothed else
                            "ewald" if form.ewald else "rf"]
        if form.softcore:
            per += OPS_SOFTCORE
        ops = pairs * per + (near * OPS_NEAR if form.has_near else 0)
        sfu = pairs * (SFU_EVAL + (SFU_DAMPED if damped else 0)
                       + (SFU_SOFTCORE if form.softcore else 0)
                       - (1 if form.table else 0))
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
    copy) that `reps` calls of fn run, from torch.profiler. The profile
    runs a warm-up cycle of `reps` calls before the one it records
    (torch.profiler.schedule(wait=0, warmup=1, active=1)): the tracer is
    started in the warm-up and the recorded calls find it running (a
    profile that recorded from its first call lost the events of its first
    calls, and once five profiles in a row kept only 7 of a sweep read's
    24 events). A profile that `enough` refuses (by default one with no
    device event) is taken again, after a pause of half a second, up to
    `tries` profiles in all; the last is returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        seen = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        if enough(seen):
            break
        log(f"profiler read {attempt + 1} of {tries} refused: {len(seen)} "
            f"device events")
    return seen


def kernel_device_ms(fn, kernel, reps=20):
    """Milliseconds of device time per launch of `kernel` inside fn, from
    torch.profiler over `reps` calls: for a call of several kernels whose
    split is wanted (K4 and its pack). A single kernel is timed by CUDA
    events instead (kernel_event_ms)."""
    mine = [us for name, us in device_kernels(fn, reps)
            if f"{kernel}_kernel" in name]
    if not mine:
        raise RuntimeError(f"torch.profiler saw no {kernel} launch")
    return sum(mine) / len(mine) / 1e3


# the card's clock for torch.cuda._sleep's cycles (the H100 SXM's boost
# clock; a slower clock holds the stream longer)
SLEEP_HZ = 1.98e9


def event_ms(fn, reps=20, hold_ms=30.0):
    """Device milliseconds of one call of fn: CUDA events around `reps`
    calls back to back, queued behind a busy wait of the stream
    (torch.cuda._sleep) that lasts until the host has queued them all, so
    that the host's launch rate does not enter (the events time the
    device's work alone, gaps between its operations included). Where the
    host took longer than the wait to queue the calls, the wait doubles
    and the read is taken again."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(int(hold_ms * 1e-3 * SLEEP_HZ))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued < 0.5 * hold_ms:
            break
        hold_ms *= 2.0
    return start.elapsed_time(end) / reps


def kernel_event_ms(launch, around, reps=20):
    """Device milliseconds of the kernel that `launch` runs (its wrapper:
    the kernel and the device operations it stages), by CUDA events
    (event_ms): the wrapper's time less that of `around`, which runs the
    wrapper's other device operations alone (the output's zero fill, a
    user form's column block)."""
    return event_ms(launch, reps) - event_ms(around, reps)


def form_name(form):
    """A pair form's name for the kernels line: its kind, and whether its
    Coulomb kernel is damped (the PME forms)."""
    from atomsmm_tpu_torch.ops import pairfuncs as pf

    if is_user(form):
        return "user" + ("_virial" if form.virial else "") \
            + ("_dlambda" if form.dconst >= 0 else "")
    name = {pf.LJ_SW_RF: "lj_sw_rf", pf.NEAR: "near", pf.FAR: "far",
            pf.LJ_SW_EWALD: "lj_sw_ewald", pf.SOFTCORE: "softcore",
            pf.DAMPED_SMOOTHED: "damped_smoothed"}[form.kind]
    if form.dlambda:
        return name + "_dlambda"
    return name + ("_damped" if form.alpha and form.kind in (pf.NEAR, pf.FAR)
                   else "") + ("_table" if form.table else "") \
        + ("_hbond" if form.hbond else "") + ("_virial" if form.virial else "")


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
    unsplit form's, with the flag, in float32 with `unsplit`). A user form
    (a CustomNonbondedForce's, its flags kept) is lowered in each dtype for
    the kernel and in float64 for the plain twin, and its launches count
    in pair_kernel.USER_LAUNCHES."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    from atomsmm_tpu_torch.ops.pairfuncs import virial_form

    spec = to_device(spec, dev)
    kernel = "half_pair" if nb.takes_half_stencil(spec) else "cell_pair"
    form = force._pair_form(globals) if form is None else form
    user = is_user(form)
    virial = form.virial
    unsplit_form = None if unsplit is None else unsplit._pair_form()
    if virial and unsplit_form is not None:
        unsplit_form = virial_form(unsplit_form)
    pp64 = {k: v.to(dev, torch.float64)
            for k, v in force._per_particle(globals).items()}
    plain_form = user_form_in(form, force, torch.float64, globals, dev) \
        if user else form
    for dtype in (torch.float64, torch.float32):
        xd, bd = x.to(dev, dtype).contiguous(), box.to(dev, dtype)
        pp = {k: v.to(dtype) for k, v in pp64.items()}
        bucket, overflow = nb.build_cell_buckets(spec, xd, bd)
        if bool(overflow):
            raise RuntimeError(f"{label}: bucket overflow in the comparison")
        form_k = user_form_in(form, force, dtype, globals, dev) if user \
            else form
        before = (dict(pk.LAUNCHES), dict(pk.USER_LAUNCHES))
        e_k, f_k = nb.cell_pair_energy_forces(form_k, xd, bd, pp, spec,
                                              bucket, form.r_cut)
        torch.cuda.synchronize()
        now, c = (pk.LAUNCHES, pk.USER_LAUNCHES), int(user)
        if now[c] != {**before[c], kernel: before[c][kernel] + 1} \
                or now[1 - c] != before[1 - c]:
            raise RuntimeError(f"{label}: the wrapper did not launch {kernel}"
                               f"{' on the user form' if user else ''} once")
        e_p, f_p, terms = plain_sweep(spec, plain_form, xd, bd, pp, bucket)
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


def rf_rows(label, force, spec, x, box, dev):
    """Where K1's float32 energy error arises, in one force's energy form at
    one grid: K1's and K2's float32 per-atom energy rows on the same bucket
    against their float64 plain twins (the same float32 inputs), and K1's
    plain twin run in float32 ("twin32") against the same float64 twin:
    max and RMS of the row errors, the float32 sum the wrappers take (the
    energy), and a float64 sum of the same float32 rows. Row errors in both
    kernels point at the per-slot arithmetic they share
    (csrc/pair_forms.cuh), row errors in K1 alone at its atomics, and a
    float32 sum worse than the float64 sum of its rows at the final
    reduction; the float32 twin's rows err as the kernels' do when the
    error is the form's own float32 rounding (its constants, rsqrt), not
    the kernels'. Logs one line; returns {name: (row max, row rms, f32 sum
    rel, f64-summed rows rel, f32 sum, twin sum, f64 sum of the f32
    rows)}."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    spec = to_device(spec, dev)
    form = force._pair_form()
    f32, f64 = torch.float32, torch.float64
    x32, b32 = x.to(dev, f32).contiguous(), box.to(dev, f32)
    pp32 = {k: v.to(dev, f32) for k, v in force._per_particle().items()}
    bucket, overflow = nb.build_cell_buckets(spec, x32, b32)
    if bool(overflow):
        raise RuntimeError(f"{label}: bucket overflow")
    pp64 = {k: v.to(f64) for k, v in pp32.items()}
    out, parts = {}, []
    def twin32(*args):
        return pk.half_pair_plain(*args, with_forces=False)

    for kernel, run, plain in (("K1", pk.half_pair_cuda, pk.half_pair_plain),
                               ("K2", pk.full_pair_cuda, pk.full_pair_plain),
                               ("twin32", twin32, pk.half_pair_plain)):
        rows = run(x32, pp32, bucket, spec, b32, form, form.r_cut)[:, 3]
        ref = plain(x32.to(f64), pp64, bucket, spec, b32.to(f64), form,
                    form.r_cut, with_forces=False)[:, 3]
        d = rows.to(f64) - ref
        e64 = float(ref.sum())
        e32 = float(rows.sum())
        e32_64 = float(rows.to(f64).sum())
        out[kernel] = (float(d.abs().max()), float(d.pow(2).mean().sqrt()),
                       abs(e32 - e64) / abs(e64), abs(e32_64 - e64) / abs(e64),
                       e32, e64, e32_64)
        parts.append(
            f"{kernel}: rows max|de| {out[kernel][0]:.3e} rms "
            f"{out[kernel][1]:.3e} kJ/mol (rms |e_i| "
            f"{float(ref.pow(2).mean().sqrt()):.4g}), float32 sum "
            f"{e32:.10g} (rel {out[kernel][2]:.2e}), float64 sum of the "
            f"float32 rows {e32_64:.10g} (rel {out[kernel][3]:.2e}), twin "
            f"{e64:.10g}")
    log(f"K1 float32 energy error localised, {label} grid {spec.grid[0]}^3 "
        f"cap {spec.cell_capacity}: " + "; ".join(parts))
    return out


def permuted(force, x, box, r_cut):
    """The nonbonded force, its spec and positions with the atoms renumbered
    by a fixed permutation: excluded pairs lie far more than +-14 indices
    apart, so no exclusion bitmask fits the whole table and the sweeps
    take the split form."""
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
    if spec.exclusion_form != "split":
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
    compare("water400 renumbered (split exclusions)", pf, pspec, px, box,
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
    rf_rows("water30k far", r.forces[2], r.neighbors, xe, be, dev)
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
            compare("water400 renumbered (split exclusions)", pf, pspec, px,
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
                "cell_pair": 0, "tile_pair": 0, "block_pair": 0}
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
                "cell_pair": passes * (steps + 1), "tile_pair": 0,
                "block_pair": 0}
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


def phase_ionic(dev, settle=30, calls=6, steps_per_call=10):
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
    expected = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0,
                "block_pair": 0}
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
    if launches != {"half_pair": 0, "cell_pair": 0, "tile_pair": runs,
                    "block_pair": 0}:
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


def time_cells(label, force, spec, x, box, form=None, plain_reps=3):
    """K1 or K2 (the kernel the spec selects) at one shape: the kernel's
    device time, the launch wrapper, the whole sweep and the plain twin by
    CUDA events; the sweep's device
    operations (at most
    4, exactly one of them the kernel, else the phase fails; none seen by
    the profiler fails it too), the work it has to do and its bound.
    `form` replaces the force's own pair form; a user form (of a
    CustomNonbondedForce, in the dtype of x) stages its column block in
    each sweep, a zero fill and a copy a column more. The kernel's device
    time is taken by CUDA events (kernel_event_ms: the launch wrapper less
    its zero fill and column block), the device operations a sweep by
    torch.profiler."""
    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    n = x.shape[0]
    form = force._pair_form() if form is None else form
    user = is_user(form)
    pp = force._per_particle()
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    if nb.takes_half_stencil(spec):
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
    p_ms = time_cuda(lambda: plain(*args), plain_reps)

    def around():  # the wrapper's device operations besides the kernel
        torch.zeros((n + 1, 4), dtype=x.dtype, device=x.device)
        if user:
            pk.user_columns(form, pp, n, x.dtype, x.device)

    k_ms = kernel_event_ms(lambda: cuda(*args), around)
    # device operations per sweep: the span between two launches of the
    # kernel among 32 profiled sweeps. The profiler has dropped events at
    # the start of its window (all of one sweep, two or three; three reads
    # in a row kept only 2 of 5 sweeps once, and ten reads of 8 sweeps in a
    # row 7 of 24 events), so the window holds 32 sweeps and a read with
    # fewer than 3 launches of the kernel is taken again, up to 10 reads
    seen = [name for name, _ in device_kernels(
        sweep, reps=32, tries=10, enough=lambda ev: sum(
            f"{kernel}_kernel" in name for name, _ in ev) >= 3)]
    at = [i for i, name in enumerate(seen) if f"{kernel}_kernel" in name]
    spans = {j - i for i, j in zip(at[1:], at[2:])}
    ops = seen[at[1] + 1:at[2] + 1] if len(at) >= 3 else []
    most = 4 + (1 + len(form.lowered.names) if user else 0)
    if len(at) < 3 or spans != {len(ops)} or not 1 <= len(ops) <= most:
        raise RuntimeError(f"{kernel} sweep {label}: kernel launches at "
                           f"{at} of {len(seen)} device operations in 32 "
                           f"sweeps, expected 1 to {most} a sweep with one: "
                           f"{seen}")
    c = sweep_counts(spec, form, x, box, pp, bucket)
    # the split form's far ids are read up to a row's first -1 padding
    far = spec.exclusions_far
    far_bytes = 0 if far is None else int((far >= 0).sum()) * 4
    # a table form reads the types and the (T, T, 4) table, not sigma, eps;
    # a user form its column block and its constants
    if user:
        cols = (pk.user_columns(form, pp, n, x.dtype, x.device), form.consts)
    else:
        cols = (pp["charge"],) + ((pp["lj_type"], pp["pair_table"])
                                  if form.table
                                  else (pp["sigma"], pp["epsilon"]))
    b = bound(form, c["pairs"], c["near_pairs"], c["slots"], nbytes(
        x, *cols, spec.excbits, bucket, nbr, box)
        + far_bytes + (n + 1) * 4 * x.element_size())
    graph = ""
    if user:
        k = form.lowered.counts()
        graph = (f"; the lowered form {len(form.lowered.vals)} values, "
                 f"{k['flops']} float operations and {k['special']} "
                 f"special-function results a pair")
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
        f"{'solute-solvent ' if not user and form.softcore else ''}pairs "
        f"({c['pairs']}) ({c['near_pairs'] / 1e6:.3f} M near){graph}; bound "
        f"{b['ms'] * 1e3:.2f} us by {b['by']} "
        f"(ops {b['ops_ms'] * 1e3:.2f}, SFU {b['sfu_ms'] * 1e3:.2f}, bytes "
        f"{b['bytes_ms'] * 1e3:.2f} us; with the slot tests "
        f"{b['with_slots_ms'] * 1e3:.2f} us): {b['ms'] / k_ms:.1%} of the "
        f"bound, {b['with_slots_ms'] / k_ms:.1%} with the slot tests")
    return {"ms": k_ms, "launch_ms": launch_ms, "plain_ms": p_ms,
            "sweep_ms": sweep_ms, "slots": slots_all, "counts": c,
            "bound": b, "launches_per_sweep": len(ops)}


def tile_kernel_ms(fs, ms, hb, cb, wrap, box, form, reps=20):
    """K3's device milliseconds on staged inputs, by CUDA events: its
    launch wrapper less the accumulator's zero fill (kernel_event_ms)."""
    import torch

    from atomsmm_tpu_torch.ops import tilepair as tp

    return kernel_event_ms(
        lambda: tp.tile_pair_cuda(fs, ms, hb, cb, wrap, box, form,
                                  form.r_cut),
        lambda: torch.zeros((fs.shape[0], fs.shape[1], 4), dtype=fs.dtype,
                            device=fs.device), reps)


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
        k_ms = tile_kernel_ms(fs, ms, hb, cb, wrap, box, form)
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
    k_ms = tile_kernel_ms(fs, ms, hb, cb, wrap, bt, form)
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
    _, bq = pme.convolve(qhat, box, alpha, grid, order)
    phi = pme._grid_potential(bq, grid)
    stages = {
        "spline weights": lambda: pme._spline_setup(x, box, grid, order,
                                                    True),
        "spread": lambda: pme._spread(idx, w, q, grid),
        "rfftn": lambda: torch.fft.rfftn(Q),
        "convolution": lambda: pme.convolve(qhat, box, alpha, grid, order),
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
    """The softcore form and its dlambda twin at each lambda (see compare).
    The float32 energy is held to the tolerance of the sum of |e_i| over
    the atoms: at a sampled configuration the total can near-cancel (-0.0086
    kJ/mol of terms summing to hundreds at lambda 0.5)."""
    for lam in lambdas:
        for dlambda in (False, True):
            compare(f"{tag} softcore{' dlambda' if dlambda else ''} lambda "
                    f"{lam:g}", soft, spec, x, box, dev, results,
                    terms_scale=True,
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
                "tile_pair": 0, "block_pair": 0}
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
    multi-state evaluation (16 states, lambda_vdw = lambda_coul, one
    batched evaluation of 16 rows that share x and the bucket: one K1
    launch per pair force a row of states), timed over `evals` rows, then
    K1 and K2 over those 16 stride-0 rows against their twin and their
    single-row launches, and timed; then a short solvation free energy on
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
    expected = {"half_pair": 3 * evals, "cell_pair": 0, "tile_pair": 0,
                "block_pair": 0}
    log(f"path (e) phenol+1000w ({n} atoms, box {float(box[0]):.3f} nm, grid "
        f"{spec.grid} cap {spec.cell_capacity}) x {k_states} states float32 "
        f"multistate_energies: {rows_per_s:.3f} K-state rows/s "
        f"({rows_per_s * k_states:.1f} state-energies/s, "
        f"{wall / evals * 1e3:.3f} ms a row) on {smi_line()}; launches "
        f"{row_launches} (expected {expected}: the scaled NonbondedForce, "
        f"the softcore force and the solute-solute term, one batched K1 "
        f"launch each over the {k_states} states of a row); energies "
        f"{float(rows[0]):.4f} .. {float(rows[-1]):.4f} kJ/mol")
    if not (row_launches == expected and bool(torch.isfinite(rows).all())):
        raise RuntimeError("path (e) multi-state evaluation failed")
    # K1 and K2 over the 16 lambda rows of one configuration: x, the box
    # and the bucket shared (stride 0), the lambdas and charge columns per
    # row; not counted on any path
    g_rows = alchemy.device_globals(lambdas, x)
    shared = (x.expand(k_states, *x.shape), box.expand(k_states, 3),
              aux["default"]["bucket"].expand(k_states,
                                              *aux["default"]["bucket"].shape))
    kernel_checks = phase_kernels_replica(
        dev, f"path (e) 16 lambda states, x shared, grid 3^3 cap "
        f"{spec.cell_capacity}", solv, *shared, g_rows)
    row_timings = time_rows(f"path (e) 16 lambda states x shared cap "
                            f"{spec.cell_capacity}", solv, *shared, g_rows)

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
                   "tile_pair": 0, "block_pair": 0}
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
            "kernel_checks": kernel_checks, "row_timings": row_timings,
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
    if method == "cutoff":
        near_f, far_f = pair_forces(respa)
        far_r = rf_rows("water100k far", far_f, respa.neighbors, x, box, dev)
        near_r = rf_rows("water100k near", near_f,
                         respa.extra_neighbor_specs["near"], x, box, dev)
        full_r = rf_rows("water100k unsplit (far grid)", far_f.full,
                         respa.neighbors, x, box, dev)
        # the split's float32 errors against their sum, and the unsplit
        # form's own on the far grid
        parts = []
        for k in ("K1", "K2", "twin32"):
            d_far, d_near, d_full = (r[k][4] - r[k][5]
                                     for r in (far_r, near_r, full_r))
            whole = far_r[k][5] + near_r[k][5]
            parts.append(f"{k} {d_far:+.4f} + {d_near:+.4f} = "
                         f"{d_far + d_near:+.4f} kJ/mol (rel "
                         f"{abs(d_far + d_near) / abs(whole):.2e}), unsplit "
                         f"{d_full:+.4f} (rel "
                         f"{abs(d_full) / abs(full_r[k][5]):.2e})")
        log("K1 float32 energy error, water100k far + near and unsplit: "
            + "; ".join(parts))
        # the kernels round each pair as the float32 twin does (no FMA
        # contraction): their rows, summed in float64, give the twin's
        # energy to 1e-7 of |E| (contracted, 4e-6 near and 2.3e-5 far)
        require("K1/K2 float32 RF energy against the float32 twin", {
            f"{k} {g}": abs(r[k][6] - r["twin32"][6]) <= 1e-7 * abs(r[k][5])
            for g, r in (("far", far_r), ("near", near_r), ("unsplit", full_r))
            for k in ("K1", "K2")})
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
    expected = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0,
                "block_pair": 0}
    expected_recip = 0
    for k, a, passes in per_call_runs:
        expected[kernel[near.half_stencil]] += passes * (
            loops[1] * k + 1 + 3 * a)
        expected[kernel[far.half_stencil]] += passes * (k + 1 + 3 * a)
        if method == "pme":
            expected_recip += passes * (k + 1 + 3 * a)
    # the pressures at the end, on the virial form (outside the count): one
    # sweep of each grid
    virial_expected = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0,
                       "block_pair": 0}
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
        lambda: nb.update_all_neighbors(respa, st.extra, x, box,
                                        force=True)), 1)
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
                respa, st.extra, x, box, force=True)), g)),
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
    k_ms = tile_kernel_ms(fs, ms, hb, cb, wrap, bt, form)
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
                "cell_pair": 0, "tile_pair": 0, "block_pair": 0}
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
                "tile_pair": 0, "block_pair": 0}
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
            s, st.extra, x, st.box, force=True)), 1),
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
            s2, st2.extra, x2, st2.box, force=True)), 1),
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
                "tile_pair": 0, "block_pair": 0}
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
                "cell_pair": 0, "tile_pair": 0, "block_pair": 0}
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
                s, st.extra, x, box, force=True)), 1),
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


# --------------------------------------------------------------------------
# The replica axis: K1 and K2 over a stack of rows (paths (i) and (e))
# --------------------------------------------------------------------------


def rows_pair_forces(system):
    """The forces of `system` that sweep a built-in pair form on the cells
    (for a SolvationSystem: the scaled NonbondedForce, the softcore force
    and the solute-solute term), in force order."""
    return [f for f in system.forces
            if hasattr(f, "_rows_form") and hasattr(f, "_pair_form")]


def row_of(pp, k_rows, r):
    """Row r's per-particle columns: (K, N) columns cut to row r."""
    return {key: v[r] if v.ndim == 2 and v.shape[0] == k_rows
            and key != "pair_table" else v for key, v in pp.items()}


def cast_rows(t, dtype):
    """t in dtype, a stride-0 (shared) stack kept shared."""
    if t.dtype == dtype:
        return t
    if t.ndim and t.stride(0) == 0:
        return t[0].to(dtype).expand_as(t)
    return t.to(dtype)


def judge_rows(label, kernel, dtype, out, ref, terms, results, name):
    """Every row of a batched kernel output (K, N + 1, 4) against the
    float64 twin's rows at the tolerances of `dtype`: the energy relative
    to |E| of the row (to sum |e_i| with `terms`), the forces to max|F|
    of the row. Logs the worst row, raises on any row out of tolerance,
    appends one result."""
    import torch

    rtol, ftol = ((F64_RTOL, F64_FTOL) if dtype == torch.float64
                  else (F32_RTOL, F32_FTOL))
    worst, score = (0.0, 0.0, 0.0, 0), -1.0
    ok = bool(torch.isfinite(out).all())
    for r in range(out.shape[0]):
        e_p = float(ref[r, :, 3].sum())
        scale = float(ref[r, :, 3].abs().sum()) if terms else abs(e_p)
        e_err = abs(float(out[r, :, 3].double().sum()) - e_p) \
            / max(scale, 1e-300)
        f_max = float(ref[r, :-1, :3].abs().max())
        f_err = float((out[r, :-1, :3].double() - ref[r, :-1, :3]).abs()
                      .max())
        ok &= e_err <= rtol and f_err <= ftol * f_max
        row_score = e_err / rtol + f_err / (ftol * max(f_max, 1e-300))
        if row_score > score:
            worst, score = (e_err, f_err, f_max, r), row_score
    log(f"kernel {kernel} {label} {str(dtype)[6:]}, {out.shape[0]} rows in "
        f"one launch: worst row {worst[3]}: E rel {worst[0]:.2e} (tol "
        f"{rtol:g}{' of sum|e_i|' if terms else ''}), max|dF| "
        f"{worst[1]:.3e} of max|F| {worst[2]:.4g} (tol {ftol:g}x)")
    if not ok:
        raise RuntimeError(f"batched kernel disagrees with its twin: "
                           f"{kernel} {label}")
    results.append((kernel, label, str(dtype)[6:], worst[0], worst[1],
                    worst[2], name))


def phase_kernels_replica(dev, tag, system, xs, boxes, buckets, globals):
    """K1 and K2 over the K rows of a stack, at one grid: for each pair
    force of `system` (rows_pair_forces) one batched launch of each kernel
    (K2 on the same grid's full stencil) in float64 and float32 against
    the batched float64 plain twin (judge_rows), and each row of the
    launch against the single-row launch of that row: K2's bit for bit,
    K1's within the same tolerances (its atomics add in another order from
    launch to launch). xs, boxes and buckets may be stride-0 stacks (the
    lambda states of one configuration); `globals` holds the rows' (K,)
    lambdas. The launches here are not counted on any path. Returns the
    results."""
    import dataclasses

    import torch

    from atomsmm_tpu_torch.ops import pair_kernel as pk

    results = []
    k_rows = xs.shape[0]
    half = system.neighbors
    full = dataclasses.replace(half, half_stencil=False)
    f64 = torch.float64
    for force in rows_pair_forces(system):
        form, lamb = force._rows_form(globals)
        pp = force._per_particle(globals)
        terms = force is not system.forces[0]
        what = f"{tag} {type(force).__name__}" \
            f"{'#2' if terms and not form.softcore else ''}"
        for spec, kernel, cuda_fn, plain in (
                (half, "half_pair", pk.half_pair_cuda, pk.half_pair_plain),
                (full, "cell_pair", pk.full_pair_cuda, pk.full_pair_plain)):
            ref = plain(cast_rows(xs, f64), {
                key: cast_rows(v, f64) if v.is_floating_point() else v
                for key, v in pp.items()}, buckets, spec,
                cast_rows(boxes, f64), form, form.r_cut,
                lamb=None if lamb is None else lamb.to(f64))
            for dtype in (f64, torch.float32):
                xd, bd = cast_rows(xs, dtype), cast_rows(boxes, dtype)
                ppd = {key: cast_rows(v, dtype) if v.is_floating_point()
                       else v for key, v in pp.items()}
                out = cuda_fn(xd, ppd, buckets, spec, bd, form, form.r_cut,
                              lamb=None if lamb is None else lamb.to(dtype))
                torch.cuda.synchronize()
                judge_rows(what, kernel, dtype, out, ref, terms, results,
                           form_name(form))
                singles = [cuda_fn(
                    xd[r].contiguous(), row_of(ppd, k_rows, r),
                    buckets[r].contiguous(), spec, bd[r].contiguous(),
                    form if lamb is None else dataclasses.replace(
                        form, lamb=float(lamb[r])), form.r_cut)
                    for r in range(k_rows)]
                rows_vs_singles(f"{kernel} {what}", kernel, dtype, out,
                                singles, terms)
    return results


def rows_vs_singles(label, kernel, dtype, out, singles, terms):
    """Each row of a batched launch's output (K, N + 1, 4) against the
    single-row launch of that row: K2's bit for bit, K1's at the
    tolerances of `dtype` (its atomics add in another order from launch to
    launch), the energy to sum |e_i| with `terms`. Raises on a row that
    departs; logs the outcome."""
    import torch

    rtol, ftol = ((F64_RTOL, F64_FTOL) if dtype == torch.float64
                  else (F32_RTOL, F32_FTOL))
    for r, one in enumerate(singles):
        if kernel == "cell_pair":
            same = torch.equal(out[r], one)
        else:
            e_scale = float(one[:, 3].abs().sum()) if terms \
                else abs(float(one[:, 3].sum()))
            same = (abs(float(out[r, :, 3].double().sum()
                              - one[:, 3].double().sum()))
                    <= rtol * max(e_scale, 1e-300)
                    and float((out[r, :-1, :3] - one[:-1, :3]).abs().max())
                    <= ftol * float(one[:-1, :3].abs().max()))
        if not same:
            raise RuntimeError(f"{label} {str(dtype)[6:]}: row {r} of the "
                               "batched launch departs from its single-row "
                               "launch")
    log(f"kernel {label} {str(dtype)[6:]}: each of the {len(singles)} rows "
        f"equals its single-row launch "
        f"{'bit for bit' if kernel == 'cell_pair' else 'within the tolerances'}")


def phase_rows_at_headline(dev, eq, k_rows=2):
    """The K = 1 launch (the single-system path every Context takes)
    against the rows of a batched launch at the 30k headline's far grid
    (7^3 cap 112, the fused far form, float32): K rows of the same state,
    x and the bucket shared (stride 0). K2 (on the grid's full stencil):
    each row bit for bit the K = 1 launch. K1: each row within 4 times
    the K = 1 launch's own run-to-run spread (its atomics; three launches,
    floored at 1e-7 of max|F| and of sum|e_i|). `k1_ab/k1_outputs.py`
    holds the same K = 1 rows against another version of the package."""
    import dataclasses

    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f32 = torch.float32
    ex, _, ebox = eq
    x = torch.as_tensor(ex, dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f32,
                           device=dev)
    r = nb.retune_neighbor_specs(amm.RESPASystem(s, 0.5, 0.4), ex, ebox,
                                 safety=1.03)
    force, spec = r.forces[2], r.neighbors
    form, pp = force._pair_form(), force._per_particle()
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    rows = (x.expand(k_rows, *x.shape), pp, bucket.expand(k_rows,
                                                          *bucket.shape))
    report = {}
    for kernel, cuda_fn, kspec in (
            ("half_pair", pk.half_pair_cuda, spec),
            ("cell_pair", pk.full_pair_cuda,
             dataclasses.replace(spec, half_stencil=False))):
        singles = [cuda_fn(x, pp, bucket, kspec, box, form, form.r_cut)
                   for _ in range(3)]
        out = cuda_fn(rows[0], pp, rows[2], kspec, box.expand(k_rows, 3),
                      form, form.r_cut)
        torch.cuda.synchronize()
        f_max = float(singles[0][:-1, :3].abs().max())
        e_terms = float(singles[0][:, 3].abs().sum())

        def gap(a, b):
            return (float((a[:-1, :3] - b[:-1, :3]).abs().max()) / f_max,
                    abs(float(a[:, 3].double().sum() - b[:, 3].double()
                              .sum())) / e_terms)

        spread = [max(gap(a, b)[i] for a in singles for b in singles)
                  for i in (0, 1)]
        worst = [max(gap(out[k], singles[0])[i] for k in range(k_rows))
                 for i in (0, 1)]
        if kernel == "cell_pair":
            ok = all(torch.equal(out[k], singles[0]) for k in range(k_rows))
        else:
            ok = all(w <= 4.0 * max(sp, 1e-7) for w, sp in zip(worst, spread))
        log(f"K = 1 vs batched rows, {kernel} water30k far grid "
            f"{spec.grid} cap {spec.cell_capacity} float32: {k_rows} "
            f"stride-0 rows against the K = 1 launch, forces "
            f"{worst[0]:.3e} of max|F|, energy {worst[1]:.3e} of sum|e_i|; "
            f"the K = 1 launch's own spread over 3 launches {spread[0]:.3e}, "
            f"{spread[1]:.3e}; "
            f"{'bit for bit' if kernel == 'cell_pair' and ok else ''}")
        if not ok:
            raise RuntimeError(f"{kernel}: the batched rows depart from the "
                               "K = 1 launch at the headline's far grid")
        report[kernel] = {"rows_vs_k1": worst, "k1_spread": spread}
    return report


def time_rows(label, system, xs, boxes, buckets, globals, plain_reps=2):
    """The batched launch of K1 and K2 (the same grid's full stencil) over
    the K rows of a stack, in the form of the scaled NonbondedForce (the
    first force): the launch wrapper (zero fill and kernel) by CUDA events
    over 20 calls, the plain float32 twin by CUDA events, the single-row
    launch of row 0 (the kernel at K = 1) beside it, and the bound: K
    times each row's distinct in-range pairs (sweep_counts), the bytes each
    input is read (a stride-0 input once) and the (K, N + 1, 4) output
    written. CUDA events, not torch.profiler: with these reads added, the
    profiler lost most device events of path (k)'s later reads in two runs
    out of two (PERF.md §6)."""
    import dataclasses

    from atomsmm_tpu_torch.ops import pair_kernel as pk

    force = system.forces[0]
    form, lamb = force._rows_form(globals)
    if lamb is not None:  # the kernels' table of lambdas: the dtype of x
        lamb = lamb.to(xs.dtype)
    pp = force._per_particle(globals)
    k_rows, n = xs.shape[0], xs.shape[1]
    out = {}
    half = system.neighbors
    for spec, kernel, cuda_fn, plain, nbr in (
            (half, "half_pair", pk.half_pair_cuda, pk.half_pair_plain,
             half.nbr_cells_half),
            (dataclasses.replace(half, half_stencil=False), "cell_pair",
             pk.full_pair_cuda, pk.full_pair_plain, half.nbr_cells)):
        args = (xs, pp, buckets, spec, boxes, form, form.r_cut)
        k_ms = time_cuda(lambda: cuda_fn(*args, lamb=lamb), 20)
        one = (xs[0].contiguous(), row_of(pp, k_rows, 0),
               buckets[0].contiguous(), spec, boxes[0].contiguous(), form,
               form.r_cut)
        k1_ms = time_cuda(lambda: cuda_fn(*one), 20)
        p_ms = time_cuda(lambda: plain(*args, lamb=lamb), plain_reps)
        pairs = near = slots = 0
        for r in range(k_rows):
            c = sweep_counts(spec, form, xs[r], boxes[r], row_of(pp, k_rows,
                                                                 r),
                             buckets[r])
            pairs, near, slots = (pairs + c["pairs"], near + c["near_pairs"],
                                  slots + c["slots"])

        def once(t):
            return t[0] if t.ndim and t.stride(0) == 0 else t

        b = bound(form, pairs, near, slots, nbytes(
            once(xs), once(pp["charge"]), pp["sigma"], pp["epsilon"],
            spec.excbits,
            once(buckets), nbr, once(boxes))
            + k_rows * (n + 1) * 4 * xs.element_size())
        log(f"timing {kernel} {label} grid {spec.grid} cap "
            f"{spec.cell_capacity}, {k_rows} rows in one launch "
            f"({form_name(form)}, float32): launch {k_ms:.4f} ms by CUDA "
            f"events ({k_ms / k_rows:.4f} ms a row); the single-row launch "
            f"of row 0 {k1_ms:.4f} ms; plain float32 twin over the rows "
            f"{p_ms:.3f} ms; {pairs} distinct in-range pairs over the rows; "
            f"bound {b['ms'] * 1e3:.2f} us by {b['by']} ({b['ms'] / k_ms:.1%} "
            f"of the bound)")
        out[kernel] = {"ms": k_ms, "k1_ms": k1_ms, "plain_ms": p_ms,
                       "bound": b, "rows": k_rows, "pairs": pairs}
    return out


def swap_eligible(k_states, parity):
    """Pairs (i, i + 1) an exchange attempt of this parity tries."""
    return len(range(parity, k_states - 1, 2))


def phase_hrex(dev, k_states=16, chunk=25, reps=4, update_every=5):
    """Path (i): BASELINE config 3b at bench_hrex's shape (phenol + 1,000
    waters, 2,941 atoms, skin 0.2 on the 3^3 grid, SolvationSystem,
    coupling_path over 16 states, velocity Verlet + OU at 300 K, 5/ps, 1
    fs, float32). A Context melts the builder's lattice at the coupled
    state, 200 steps at K = 1 (4 chunks of 50, each followed by a rescale
    to 300 K); the sequential comparator, a Context at
    neighbor_update_every=5, and the same state at K = 1 each time 100
    steps; then HREXSampler(neighbor_update_every=5, seed=3) runs one warm
    chunk and swap, then `reps` chunks of `chunk` steps, each followed by
    attempt_swaps(), timed with CUDA events (replica steps and swaps
    apart). The 16 replicas are one stacked State: a step of the stack is
    one batched step. Checks: no staleness or overflow flag in any replica
    (run() raises), each row's mean T 260-340 K, the attempts exactly the
    eligible pairs, the acceptance in [0, 1], K1's launches exactly as
    derived: 3 a step of the whole stack (one batched launch each for the
    scaled NonbondedForce, the softcore force and the solute-solute term),
    3 at each run() (the force caches under the rows' globals), 9 a swap
    (three batched energies of the stack, as the JAX package takes them),
    and one bucket build a rebuild of the stack. The batched step is split
    by part (the sweeps, group 0, the OU draws, the rebuild; the rest the
    integrator's own operations), each timed alone with a synchronise
    after every call. Then K1 and K2 over the 16 rows at (i)'s own bucket
    (phase_kernels_replica) and their batched times (time_rows)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.alchemy import coupling_path
    from atomsmm_tpu_torch.integrate.propagators import _normal
    from atomsmm_tpu_torch.models import phenol_in_water
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.parallel import HREXSampler
    from atomsmm_tpu_torch.state import kinetic_energy
    from atomsmm_tpu_torch.units import BOLTZMANN
    from atomsmm_tpu_torch.utils import count_degrees_of_freedom

    f32, temp = torch.float32, 300.0
    base, x, box, solute = phenol_in_water(n_water=1000, neighbors=True,
                                           skin=0.2, dtype=f32, device=dev)
    solv = amm.SolvationSystem(base, solute)
    spec = solv.neighbors
    if not (spec.half_stencil and spec.grid == (3, 3, 3)):
        raise RuntimeError(f"path (i): expected a 3^3 half-stencil grid, got "
                           f"{spec.grid}")
    lams = coupling_path(torch.linspace(0.0, 1.0, k_states,
                                        dtype=torch.float64))

    def integrator():
        return amm.GlobalThermostatIntegrator(
            0.001, amm.VelocityVerletPropagator(),
            amm.OrnsteinUhlenbeckPropagator(temp, 5.0))

    def coupled(ctx):
        ctx.set_parameter("lambda_vdw", 1.0)
        ctx.set_parameter("lambda_coul", 1.0)
        return ctx

    warm = coupled(amm.Context(solv, integrator(),
                               amm.make_state(x, box=box, seed=1)))
    warm.set_velocities_to_temperature(temp, seed=2)
    for _ in range(4):
        warm.step(50)
        t_now = float(warm.temperature())
        if not t_now == t_now or t_now > 5000.0:
            raise RuntimeError(f"path (i) melt diverged (T {t_now} K)")
        warm.set_velocities((temp / t_now) ** 0.5 * warm.state.v)
    run_sys = warm.system
    xw, vw = warm.state.x.clone(), warm.state.v.clone()

    seq = {}
    steps = chunk * reps
    for k_upd in (update_every, 1):
        ctx = coupled(amm.Context(run_sys, integrator(),
                                  amm.make_state(xw, v=vw, box=box, seed=1),
                                  neighbor_update_every=k_upd))
        ctx.step(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.step(steps)
        torch.cuda.synchronize()
        seq[k_upd] = steps / (time.perf_counter() - t0)

    sampler = HREXSampler(run_sys, xw, box, lams, temp, dt=0.001, seed=3,
                          neighbor_update_every=update_every)
    if sampler.states.rows != k_states:
        raise RuntimeError("path (i): the sampler's states are not one "
                           f"stack of {k_states} rows")
    sampler.run(chunk)
    sampler.attempt_swaps()
    torch.cuda.synchronize()
    dof = count_degrees_of_freedom(run_sys)
    masses = run_sys.masses
    att0, acc0 = sampler.swap_attempts, sampler.swap_accepts
    rebuilds = [0]
    real_build = nb.build_cell_buckets

    def counting_build(*args):
        rebuilds[0] += 1
        return real_build(*args)

    nb.build_cell_buckets = counting_build
    pk.reset_launches()
    eligible, run_ms, swap_ms, t_rows = 0, [], [], []
    try:
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            eligible += swap_eligible(k_states, sampler._parity)
            ev[0].record()
            sampler.run(chunk)
            ev[1].record()
            sampler.attempt_swaps()
            ev[2].record()
            torch.cuda.synchronize()
            run_ms.append(ev[0].elapsed_time(ev[1]))
            swap_ms.append(ev[1].elapsed_time(ev[2]))
            t_rows.append(2.0 * kinetic_energy(masses, sampler.states.v)
                          / (dof * BOLTZMANN))
    finally:
        nb.build_cell_buckets = real_build
    launches = dict(pk.LAUNCHES)
    expected = {"half_pair": reps * (3 * (chunk + 1) + 9), "cell_pair": 0,
                "tile_pair": 0, "block_pair": 0}
    rebuilds_derived = reps * (1 + chunk // update_every
                               + chunk % update_every)
    t_mean = torch.stack(t_rows).mean(0).tolist()
    total_s = (sum(run_ms) + sum(swap_ms)) / 1e3
    batch = k_states * steps / total_s
    att, acc = sampler.swap_attempts - att0, sampler.swap_accepts - acc0
    step_ms = sum(run_ms) / (reps * chunk)  # a batched step of all rows
    st = sampler.states
    g = sampler._on_device(sampler._globals(sampler.lambdas))
    aux = nb.make_aux(run_sys, st.extra)
    pair = rows_pair_forces(run_sys)
    group0 = [f for f in run_sys.forces
              if not f.inert and not any(f is p for p in pair)]
    split = {
        "K1 sweeps (3 batched launches)": wall_ms(lambda: [
            f.energy_and_forces_rows(st.x, st.box, g, aux) for f in pair]),
        "group 0 (bonded, exceptions; autograd over the stack)": wall_ms(
            lambda: [f.energy_and_forces_rows(st.x, st.box, g, aux)
                     for f in group0]),
        f"OU draws ({k_states} generator launches)": wall_ms(
            lambda: _normal(st.rng, st.v)),
    }
    rebuild_ms = wall_ms(lambda: nb.update_all_neighbors(
        run_sys, st.extra, st.x, st.box, force=True))
    split[f"rebuild of the stack / {update_every}"] = \
        rebuild_ms / update_every
    log(f"path (i) HREX phenol+1000w ({run_sys.num_particles} atoms, grid "
        f"{spec.grid} cap {run_sys.neighbors.cell_capacity}, skin "
        f"{spec.skin:.3f} nm) x {k_states} states, neighbor_update_every "
        f"{update_every}, VV+OU 1 fs float32 on {smi_line()}: "
        f"{batch:.2f} state-steps/s over {reps} x ({chunk} steps + a swap) "
        f"(CUDA events, {total_s:.3f} s); sequential Context "
        f"{seq[update_every]:.2f} steps/s at K = {update_every}, "
        f"{seq[1]:.2f} at K = 1 (host clock, {steps} steps); batch / "
        f"sequential {batch / seq[update_every]:.4f} (K = {update_every}), "
        f"K = {update_every} / K = 1 {seq[update_every] / seq[1]:.4f}")
    log(f"path (i) split: batched steps {sum(run_ms):.3f} ms "
        f"({step_ms:.4f} ms a step of the {k_states}-row stack, "
        f"{step_ms / k_states:.4f} ms a replica step, {run_ms}), swaps "
        f"{sum(swap_ms):.3f} ms ({sum(swap_ms) / reps:.3f} ms an attempt, "
        f"{swap_ms}; {100 * sum(swap_ms) / (sum(run_ms) + sum(swap_ms)):.2f}"
        f"% of the run), stack rebuilds {rebuilds[0]} (derived "
        f"{rebuilds_derived}) at {rebuild_ms:.4f} ms each (one synchronised, "
        f"host clock) = "
        f"{100 * rebuilds[0] * rebuild_ms / (sum(run_ms) + sum(swap_ms)):.2f}"
        f"% of the run")
    log("path (i) batched step split ({:.4f} ms a step of the stack, CUDA "
        "events; parts synchronised, host clock): {}; rest (the "
        "integrator's kicks, drift and OU arithmetic, the staleness flags, "
        "Python) {:.4f} ms; swap {:.4f} ms an attempt".format(
            step_ms, ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()),
            step_ms - sum(split.values()), sum(swap_ms) / reps))
    log(f"path (i) swaps: {att} attempts ({eligible} eligible pairs), {acc} "
        f"accepted, acceptance {acc / att:.4f} (all: "
        f"{sampler.acceptance_rate:.4f} of {sampler.swap_attempts}); mean T "
        f"per row {[round(t, 2) for t in t_mean]} K; launches {launches} "
        f"(expected {expected})")
    checks = {
        "finite": bool(torch.isfinite(sampler.positions()).all()),
        "temperature": all(260.0 <= t <= 340.0 for t in t_mean),
        "attempts": att == eligible,
        "acceptance": 0.0 <= acc / att <= 1.0,
        "launches": launches == expected,
        "rebuilds": rebuilds[0] == rebuilds_derived,
    }
    require("path (i)", checks)
    # K1 and K2 over the 16 rows at path (i)'s own bucket (the cap the melt
    # retuned to), each row its own x, lambdas and charge column, in the
    # three forms a step sweeps; these launches are not counted
    cap = run_sys.neighbors.cell_capacity
    kernel_checks = phase_kernels_replica(
        dev, f"path (i) 16 replicas grid 3^3 cap {cap}", run_sys, st.x,
        st.box, st.extra["nbr_bucket"], g)
    timings = time_rows(f"path (i) 16 replicas cap {cap}", run_sys, st.x,
                        st.box, st.extra["nbr_bucket"], g)
    return {"launches": launches, "kernel_checks": kernel_checks,
            "x0": xw, "box": box, "lams": lams, "system": run_sys,
            "update_every": update_every,
            "stack": (st.x, st.box, st.extra["nbr_bucket"], g),
            "state_steps_per_s": batch,
            "seq_steps_per_s": seq, "swap_ms": sum(swap_ms) / reps,
            "step_ms": step_ms, "rebuild_ms": rebuild_ms, "split": split,
            "acceptance": acc / att, "t_rows": t_mean, "timings": timings}


def phase_slice_hrex(dev, k_states=4, steps=12, update_every=4):
    """Replica exchange in float64, the card against the CPU: phenol + 60
    waters at 0.5 nm (tests/test_torch_hrex.py's fixture, K2 on its 2^3
    grid), 4 replicas on coupling_path, the bath at friction 0 and the
    velocities from numpy (no draw enters), neighbor_update_every=4, 12
    steps, then one exchange attempt with the uniforms pinned from numpy:
    x, v and box to 1e-9 relative, the swap energies to 1e-10 relative,
    the same accept mask. The replicas are one stacked State: on the card
    each step is one batched K2 launch per force over the 4 rows."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.alchemy import coupling_path
    from atomsmm_tpu_torch.models import phenol_in_water
    from atomsmm_tpu_torch.parallel import HREXSampler
    from atomsmm_tpu_torch.utils import replace

    f64 = torch.float64
    u = np.random.RandomState(4).uniform(size=k_states)
    runs = []
    for device in ("cpu", dev):
        base, x, box, solute = phenol_in_water(
            n_water=60, r_cut=0.5, r_switch=0.42, seed=5, neighbors=True,
            dtype=f64, device=device)
        solv = amm.SolvationSystem(base, solute)
        m = solv.masses.cpu().numpy()
        v = np.random.RandomState(9).normal(size=(k_states,) + x.shape) \
            * np.sqrt(amm.units.BOLTZMANN * 300.0 / m)[None, :, None]
        sampler = HREXSampler(
            solv, x, box, coupling_path(torch.linspace(0.0, 1.0, k_states,
                                                       dtype=f64)),
            300.0, dt=0.0005, friction=0.0, seed=3,
            neighbor_update_every=update_every)
        sampler.states = replace(sampler.states,
                                 v=torch.as_tensor(v, device=device))
        sampler.run(steps)
        before = sampler.positions().clone()
        _, energies, _ = sampler._swap.deltas(
            sampler.states, sampler._globals(sampler.lambdas), 0)
        sampler._swap._uniforms = lambda key, k, like: torch.as_tensor(
            u, dtype=like.dtype, device=like.device)
        sampler.attempt_swaps()
        moved = [not torch.equal(a, b)
                 for a, b in zip(before, sampler.positions())]
        runs.append((sampler.positions().cpu(), sampler.states.v.cpu(),
                     sampler.states.box.cpu(), energies.cpu(), moved,
                     solv.neighbors.grid))
    (xc, vc, bc, ec, mc, grid), (xg, vg, bg, eg, mg, _) = runs
    md_err = max(float((a - b).abs().max()) / float(a.abs().max())
                 for a, b in ((xc, xg), (vc, vg), (bc, bg)))
    e_err = float(((eg - ec).abs() / ec.abs()).max())
    log(f"slice hrex phenol60w float64 card vs CPU ({k_states} replicas, "
        f"grid {grid}, neighbor_update_every {update_every}, {steps} steps, "
        f"friction 0): x, v, box max rel diff {md_err:.2e}; swap energies "
        f"{[round(float(e), 6) for e in eg.reshape(-1)]} max rel diff "
        f"{e_err:.2e}; accept mask (rows moved) card {mg}, CPU {mc}")
    if not (md_err < 1e-9 and e_err < 1e-10 and mg == mc):
        raise RuntimeError("the replica-exchange slice on the card departs "
                           "from the CPU run")


# --------------------------------------------------------------------------
# Path (j): the headline under Simulation; path (k): triclinic cells
# --------------------------------------------------------------------------

# the shear of paths (k2) and (k3): b = (sx L, L, 0), c = (cx L, cy L, L),
# angles 88.2, 88.3 and 87.1 degrees. Mapping an equilibrated liquid's
# molecules affinely into the cell compresses some close contacts; at this
# strain that warms 900 waters by 2-3 K over 10 steps (at 0.15 / 0.1 / 0.1,
# 20 K), so (k2) stays inside the headline's temperature band
SHEAR = (0.05, 0.03, 0.03)
# the rows of path (j)'s reporters: StateDataReporter, the extended one,
# and the four every-100 reporters
J_INTERVALS = {"state": 25, "extended": 50, "frames": 100}
# path (j)'s bands for the rows of a run started from FIRE's minimum with
# velocities at 300 K, set from the witness (tests/quench_witness.py: the
# JAX package and this port, float64, 216 waters, the same start, agree
# to 1e-11 over 200 steps): its rows read T 194.6-237.3 K and PE/atom
# 1.47-1.99 kJ/mol above FIRE's minimum, each band widened by 3 sigma of
# its own fluctuation there (T 7.1 K, PE/atom 0.12 kJ/mol)
J_BANDS = {"T": (173.0, 259.0), "pe_rise": (1.1, 2.35)}
# K1 launches of one snapshot: lite (the total energy: near and far
# sweeps), full (the per-force split, the forces and the per-group
# energies: two sweeps each) and the extended row's observables (the
# virial form of each pair force, then the Coulomb energy: two sweeps each)
J_SNAPSHOT_LAUNCHES = {"lite": 2, "full": 6, "extended": 4}


def shear_cell(box_l, shear=SHEAR):
    """The sheared reduced cell of edge box_l: a = (L, 0, 0),
    b = (sx L, L, 0), c = (cx L, cy L, L)."""
    import numpy as np

    sx, cx, cy = shear
    return np.array([[box_l, 0.0, 0.0], [sx * box_l, box_l, 0.0],
                     [cx * box_l, cy * box_l, box_l]])


def into_cell(x, molecule, masses, box_l, cell):
    """numpy float64 positions with each molecule's centre of mass mapped
    affinely from the cube of edge box_l into `cell` (rows = lattice
    vectors), each molecule's geometry kept."""
    import numpy as np

    x = np.asarray(x, np.float64)
    mol = np.asarray(molecule, np.int64)
    m = np.asarray(masses, np.float64)
    tot = np.bincount(mol, m)
    com = np.stack([np.bincount(mol, m * x[:, d]) for d in range(3)], 1) \
        / tot[:, None]
    return x + (com @ (np.asarray(cell) / box_l) - com)[mol]


def water_in_cell(system, x, box_l, cell, r_cut, device):
    """A water_system() built without cell lists, with positions `x` in the
    cube of edge box_l, moved into `cell`: its default box, positions
    (into_cell), cell list and, under PME, grid all for the cell;
    (system, positions as float64 numpy)."""
    import torch

    from atomsmm_tpu_torch.ops.neighbors import make_neighbor_spec
    from atomsmm_tpu_torch.ops.pme import choose_pme_parameters
    from atomsmm_tpu_torch.utils import replace

    xs = into_cell(x.detach().cpu().numpy(), system.molecule.cpu().numpy(),
                   system.masses.cpu().numpy(), box_l, cell)
    nb = system.forces[0]
    if nb.method == "pme":
        _, grid, _ = choose_pme_parameters(r_cut, cell,
                                           alpha=float(nb.ewald_alpha),
                                           order=int(nb.spline_order))
        nb = replace(nb, grid_shape=grid)
    system = replace(system, forces=(nb,) + tuple(system.forces[1:]),
                     default_box=torch.as_tensor(
                         cell, dtype=system.masses.dtype, device=device))
    return system.with_neighbors(make_neighbor_spec(
        cell, system.num_particles, r_cut, exclusions=nb.exclusions,
        occupancy_floor_from=xs, device=device)), xs


def headline(dev, eq, dtype, cell=None):
    """The 30k headline as phase_main builds it (water_system of the
    stored state's 10,000 waters, RESPASystem(0.5, 0.4), MTS [4, 2, 1] @
    4 fs + NHC 300 K, both grids' capacities retuned at safety 1.03 from
    bench_data/eq_water30k.npz) in `dtype`: (system, integrator, state). With `cell`, a (3, 3) matrix,
    the stored state is moved into it (water_in_cell): every spec is
    built for the cell and marked triclinic."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    ex, ev, ebox = eq
    system, _, _ = water_system(n_molecules=len(ex) // 3,
                                neighbors=cell is None,
                                dtype=dtype, device=dev)
    box = torch.as_tensor(ebox, dtype=dtype, device=dev)
    x = ex
    if cell is not None:
        system, x = water_in_cell(system, torch.as_tensor(ex),
                                  float(ebox[0]), cell, 0.9, dev)
        box = torch.as_tensor(cell, dtype=dtype, device=dev)
    respa = amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    respa = retune_neighbor_specs(respa, x, box, safety=1.03)
    integ = amm.MultipleTimeScaleIntegrator(
        0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * system.num_particles - 3)
    state = amm.make_state(torch.as_tensor(x, dtype=dtype, device=dev),
                           v=torch.as_tensor(ev, dtype=dtype, device=dev),
                           box=box)
    return respa, integ, state


def snapshot(state):
    """Copies of everything a checkpoint holds, on the state's device (the
    generator advances in place)."""
    return dict(x=state.x.clone(), v=state.v.clone(), box=state.box.clone(),
                step=state.step, rng=state.rng.get_state().clone(),
                rng_device=state.rng.device,
                extra={k: v.clone() for k, v in state.extra.items()})


def equals_snapshot(state, snap):
    """`state` equals `snap` bit for bit: x, v, box, the step, every extended
    variable (dtype and value) and the generator (device and state)."""
    import torch

    same = [state.step == snap["step"],
            state.rng.device == snap["rng_device"],
            torch.equal(state.rng.get_state(), snap["rng"]),
            sorted(state.extra) == sorted(snap["extra"])]
    for k in ("x", "v", "box"):
        got = getattr(state, k)
        same.append(got.dtype == snap[k].dtype and torch.equal(got, snap[k]))
    for k, want in snap["extra"].items():
        got = state.extra.get(k)
        same.append(got is not None and got.dtype == want.dtype
                    and torch.equal(got, want))
    return all(same)


def counted_context(ctx):
    """Wrap ctx.step and ctx.get_state to record each step(n) call's n and
    passes, and the lite and full snapshots; returns the record."""
    rec = {"calls": [], "lite": 0, "full": 0}
    step, get_state = ctx.step, ctx.get_state

    def counted_step(n):
        out = step(n)
        rec["calls"].append((n, ctx.last_step_passes))
        return out

    def counted_get_state(lite=False):
        rec["lite" if lite else "full"] += 1
        return get_state(lite=lite)

    ctx.step, ctx.get_state = counted_step, counted_get_state
    return rec


def j_reporters(outs):
    """Path (j)'s reporters, writing into the StringIOs of `outs`."""
    import atomsmm_tpu_torch as amm

    every = J_INTERVALS
    return [
        amm.StateDataReporter(outs["state"], every["state"]),
        amm.ExtendedStateDataReporter(outs["extended"], every["extended"],
                                      pressure=True, coulomb_energy=True),
        amm.PDBReporter(outs["pdb"], every["frames"]),
        amm.XYZReporter(outs["xyz"], every["frames"], atoms=range(6),
                        symbols=["O", "H", "H"] * 2),
        amm.CenterOfMassReporter(outs["com"], every["frames"]),
        amm.CustomIntegratorReporter(outs["custom"], every["frames"]),
    ]


def csv_rows(text):
    """(header names, rows as float lists) of a StateDataReporter CSV."""
    lines = text.strip().splitlines()
    names = [h.strip('"') for h in lines[0].split(",")]
    return names, [[float(v) for v in line.split(",")] for line in lines[1:]]


def phase_simulation(dev, eq, main_ms, fire_steps=50, half=100,
                     continuations=3):
    """Path (j): the 30k headline under Simulation, float32. FIRE
    (minimize_energy, `fire_steps` iterations on the cell lists, K1 on
    both grids) from the stored state, then velocities at 300 K (seed 7)
    and the run from FIRE's minimum: FIRE takes the liquid's thermal
    potential energy out (3.4 kJ/mol/atom in 50 iterations), and the
    Nose-Hoover chain puts it back over picoseconds, so the rows are held
    to J_BANDS, set from the witness of that start. Then the
    reporters (StateDataReporter every 25, ExtendedStateDataReporter with
    pressure and the Coulomb energy every 50, PDB, XYZ of six atoms,
    centres of mass and the integrator variables every 100), step(half),
    save_checkpoint and save_system, step(half); then `continuations`
    times a fresh Simulation from load_system + load_checkpoint with the
    same reporters, step(half). Checks: PE and max|F| fall in FIRE; the
    rows at exactly the due steps; Total = PE + KE to the printed digits;
    every row's T and PE/atom above FIRE's minimum inside J_BANDS; finite
    pressures; every frame written; the restored state
    bitwise equal to the saved one; the uninterrupted run no farther from
    the continuations (the largest max|dx| of the run against each) than
    3 x their spread (the largest max|dx| between two of them): K1's
    atomics vary the last bits, and chaos grows them to 1e-2 nm in 100
    steps; a spread of 0 asks for equality; K1's launches as derived (2 a FIRE
    iteration per pass; 3 an outer step + 2 a pass of each step(n); 2 a
    lite and 6 a full snapshot; 4 an extended row). Logged: ms per FIRE
    iteration, per outer step with and without reporters, a full and a
    lite row in ms and in outer steps, the checkpoint and system I/O,
    profile_forces and profile_step beside phase_main's step, and a
    trace() file."""
    import io
    import math
    import shutil
    import tempfile

    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import minimize as fire
    from atomsmm_tpu_torch.checkpoint import load_system, save_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux
    from atomsmm_tpu_torch.potential import force_fn
    from atomsmm_tpu_torch.profiling import profile_forces, profile_step, \
        trace

    f32 = torch.float32
    tmp = tempfile.mkdtemp(prefix="path_j_")
    try:
        respa, integ, state = headline(dev, eq, f32)
        n = respa.num_particles
        sim = amm.Simulation(respa, integ, state)
        ctx = sim.context

        def pe_fmax(c):
            s, st = c.system, c.state
            aux = make_aux(s, all_neighbor_extras(s, st.x, st.box))
            e, f = force_fn(s)(st.x, st.box, c.parameters, aux)
            return float(e) / n, float(torch.linalg.norm(f, dim=1).max())

        pe0, f0 = pe_fmax(ctx)
        passes = []
        fire_pass = fire._fire_pass

        def counted_pass(*args):
            passes.append(1)
            return fire_pass(*args)

        fire._fire_pass = counted_pass
        try:
            pk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.minimize_energy(steps=fire_steps)
            torch.cuda.synchronize()
            fire_ms = (time.perf_counter() - t0) * 1e3 / fire_steps
            fire_launches = dict(pk.LAUNCHES)
        finally:
            fire._fire_pass = fire_pass
        pe1, f1 = pe_fmax(ctx)
        expected_fire = {"half_pair": 2 * fire_steps * len(passes),
                         "cell_pair": 0, "tile_pair": 0, "block_pair": 0}
        log(f"path (j) FIRE {fire_steps} iterations on the cell lists: PE/atom "
            f"{pe0:.4f} -> {pe1:.4f} kJ/mol, max|F| {f0:.1f} -> {f1:.1f} "
            f"kJ/mol/nm; {fire_ms:.3f} ms per iteration (rebuild, K1 near "
            f"and far, group 0 by autograd, the FIRE update); passes "
            f"{len(passes)}; launches {fire_launches} (expected "
            f"{expected_fire})")
        sim.set_velocities_to_temperature(300.0, seed=7)

        outs = {k: io.StringIO() for k in ("state", "extended", "pdb", "xyz",
                                           "com", "custom")}
        sim.reporters = j_reporters(outs)
        rec = counted_context(ctx)
        s0 = sim.current_step
        pk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step(half)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        ck, sysf = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "sys.npz")
        t0 = time.perf_counter()
        sim.save_checkpoint(ck)
        save_ck_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        save_system(sysf, sim.system)
        save_sys_ms = (time.perf_counter() - t0) * 1e3
        saved = snapshot(ctx.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step(half)
        torch.cuda.synchronize()
        t_second = time.perf_counter() - t0
        launches = dict(pk.LAUNCHES)
        x_u = ctx.state.x.clone()
        rep_ms = (t_first + t_second) * 1e3 / (2 * half)

        ext_rows = outs["extended"].getvalue().count("\n") - 1
        expected = {"half_pair": sum(
            p * (3 * k + 2) for k, p in rec["calls"])
            + J_SNAPSHOT_LAUNCHES["lite"] * rec["lite"]
            + J_SNAPSHOT_LAUNCHES["full"] * rec["full"]
            + J_SNAPSHOT_LAUNCHES["extended"] * ext_rows,
            "cell_pair": 0, "tile_pair": 0, "block_pair": 0}

        names, rows = csv_rows(outs["state"].getvalue())
        ext_names, ext = csv_rows(outs["extended"].getvalue())
        col = {k: names.index(k) for k in names}

        def due(kind):
            return [k for k in range(s0 + 1, s0 + 2 * half + 1)
                    if k % J_INTERVALS[kind] == 0]

        steps = [int(r[col["Step"]]) for r in rows]
        temps = [r[col["Temperature (K)"]] for r in rows]
        pes = [r[col["Potential Energy (kJ/mole)"]] / n for r in rows]
        total_ok = all(
            abs(r[col["Total Energy (kJ/mole)"]]
                - r[col["Potential Energy (kJ/mole)"]]
                - r[col["Kinetic Energy (kJ/mole)"]])
            <= 1e-5 * (abs(r[col["Potential Energy (kJ/mole)"]])
                       + abs(r[col["Kinetic Energy (kJ/mole)"]]))
            for r in rows)
        pressures = [r[ext_names.index(k)] for r in ext
                     for k in ("Atomic Pressure (bar)",
                               "Molecular Pressure (bar)")]
        frames = {k: outs[k].getvalue() for k in ("pdb", "xyz", "com",
                                                  "custom")}
        log(f"path (j) reporting run: step({half}) twice, {len(rows)} state "
            f"rows at steps {steps}; T {[round(t, 2) for t in temps]} K; "
            f"PE/atom {[round(p, 4) for p in pes]} kJ/mol; {ext_rows} extended "
            f"rows, pressures (atomic, molecular) "
            f"{[round(p, 1) for p in pressures]} bar; frames: PDB "
            f"{frames['pdb'].count('ENDMDL')}, XYZ "
            f"{frames['xyz'].count('step ')}, COM "
            f"{frames['com'].count('step ')}, integrator "
            f"{frames['custom'].count('# step')}; PE/atom above FIRE's "
            f"minimum {[round(p - pe1, 4) for p in pes]} (band "
            f"{J_BANDS['pe_rise']}), T band {J_BANDS['T']}; step(n) calls "
            f"{rec['calls']}; snapshots lite {rec['lite']} full "
            f"{rec['full']}; launches {launches} (expected {expected}); "
            f"{rep_ms:.3f} ms/step with reporters; checkpoint saved in "
            f"{save_ck_ms:.3f} ms ({os.path.getsize(ck)} bytes), system in "
            f"{save_sys_ms:.3f} ms ({os.path.getsize(sysf)} bytes)")

        def restored():
            t0 = time.perf_counter()
            system = load_system(sysf, device=dev)
            torch.cuda.synchronize()
            load_sys_ms = (time.perf_counter() - t0) * 1e3
            integ2 = amm.MultipleTimeScaleIntegrator(
                0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
                degrees_of_freedom=3 * n - 3)
            s = amm.Simulation(system, integ2, amm.make_state(
                saved["x"], v=saved["v"], box=saved["box"]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.load_checkpoint(ck)
            torch.cuda.synchronize()
            load_ck_ms = (time.perf_counter() - t0) * 1e3
            return s, load_sys_ms, load_ck_ms

        conts, bitwise = [], []
        for _ in range(continuations):
            s, load_sys_ms, load_ck_ms = restored()
            bitwise.append(equals_snapshot(s.context.state, saved))
            s.reporters = j_reporters({k: io.StringIO() for k in outs})
            s.step(half)
            conts.append(s)
        xs = [s.context.state.x for s in conts]
        spread = max(float((a - b).abs().max())
                     for i, a in enumerate(xs) for b in xs[i + 1:])
        diff = max(float((x_u - a).abs().max()) for a in xs)
        log(f"path (j) restore: load_system {load_sys_ms:.3f} ms, "
            f"load_checkpoint {load_ck_ms:.3f} ms; restored state bitwise "
            f"equal to the saved one (x, v, box, {len(saved['extra'])} "
            f"extended variables, the generator, the step): {bitwise}; "
            f"after step({half}): max|x - x_uninterrupted| {diff:.3e} nm, "
            f"spread of {continuations} continuations {spread:.3e} nm")

        c = conts[0]
        cctx = c.context
        c.reporters = []
        c.step(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.step(50)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3 / 50
        ext_rep = amm.ExtendedStateDataReporter(
            io.StringIO(), 50, pressure=True, coulomb_energy=True)
        sdr = amm.StateDataReporter(io.StringIO(), 25)
        full_ms = wall_ms(lambda: ext_rep.report(c, cctx.get_state()), 5)
        snap_ms = wall_ms(lambda: cctx.get_state(), 5)
        lite_ms = wall_ms(lambda: sdr.report(c, cctx.get_state(lite=True)),
                          5)
        lite = cctx.get_state(lite=True)
        frame_ms = {type(r).__name__: wall_ms(lambda r=r: r.report(c, lite), 2)
                    for r in j_reporters({k: io.StringIO() for k in outs})[2:]}
        prof = profile_forces(cctx, reps=10)
        prof_step = profile_step(cctx, steps=20, tries=2)
        with trace(os.path.join(tmp, "trace")) as tracer:
            cctx.step(2)
        trace_bytes = os.path.getsize(tracer.trace_file)
        log(f"path (j) times: {bare_ms:.3f} ms/step without reporters, "
            f"{rep_ms:.3f} with ({rep_ms / bare_ms:.3f}x); a full row "
            f"(snapshot + extended columns) {full_ms:.3f} ms = "
            f"{full_ms / bare_ms:.3f} outer steps (the full snapshot alone "
            f"{snap_ms:.3f} ms), a lite row {lite_ms:.3f} ms = "
            f"{lite_ms / bare_ms:.3f} outer steps; a frame of each "
            f"every-100 reporter (ms) "
            f"{ {k: round(v, 3) for k, v in frame_ms.items()} }; "
            f"profile_forces "
            f"{ {k: round(v, 4) for k, v in prof.items()} } ms; profile_step "
            f"{prof_step:.3f} ms against phase_main's {main_ms:.3f} ms/step; "
            f"trace() wrote {trace_bytes} bytes")
        checks = {
            "fire_pe_falls": pe1 < pe0,
            "fire_fmax_falls": f1 < f0,
            "fire_launches": fire_launches == expected_fire,
            "rows_at_due_steps": steps == due("state"),
            "extended_rows": [int(r[0]) for r in ext] == due("extended"),
            "total_is_pe_plus_ke": total_ok,
            "temperature": all(J_BANDS["T"][0] <= t <= J_BANDS["T"][1]
                               for t in temps),
            "pe_per_atom": all(J_BANDS["pe_rise"][0] <= p - pe1
                               <= J_BANDS["pe_rise"][1] for p in pes),
            "pressures_finite": all(math.isfinite(p) for p in pressures),
            "frames": all(frames[k].count(tag) == len(due("frames"))
                          for k, tag in (("pdb", "ENDMDL"), ("xyz", "step "),
                                         ("com", "step "),
                                         ("custom", "# step"))),
            "launches": launches == expected,
            "restored_bitwise": all(bitwise),
            "continuation": diff <= 3.0 * spread if spread > 0
            else diff == 0.0,
            "finite": bool(torch.isfinite(x_u).all()),
            "profile_keys": sorted(prof) == ["group 0", "group 1", "group 2",
                                             "overhead"],
            "trace_written": trace_bytes > 0,
        }
        require("path (j)", checks)
        return {"launches": launches, "fire_launches": fire_launches,
                "fire_ms": fire_ms, "ms_per_step": rep_ms,
                "bare_ms": bare_ms, "full_row_ms": full_ms,
                "lite_row_ms": lite_ms}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_simulation_resume(dev, steps=10):
    """A resume on the card that is deterministic end to end: 216 waters at
    the default 0.9 nm (one cell: K2 alone, no atomics; group 0 by
    autograd through a reshape), float32, LangevinMiddleIntegrator(1 fs,
    300 K, 1/ps), whose every step draws from the CUDA generator. FIRE 20
    iterations, velocities at seed 3, step(steps), save_checkpoint and
    save_system, step(steps); twice a fresh Simulation from load_system +
    load_checkpoint, step(steps). Checks: each restored state bitwise equal
    to the saved one, the two continuations and the uninterrupted run
    bitwise equal."""
    import shutil
    import tempfile

    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.checkpoint import load_system, save_system
    from atomsmm_tpu_torch.models import water_system

    tmp = tempfile.mkdtemp(prefix="resume_")
    try:
        system, x, box = water_system(n_molecules=216, neighbors=True,
                                      dtype=torch.float32, device=dev)
        if system.neighbors.half_stencil:
            raise RuntimeError("the resume slice expects one cell (K2)")

        def integrator():
            return amm.LangevinMiddleIntegrator(0.001, 300.0, 1.0)

        sim = amm.Simulation(system, integrator(),
                             amm.make_state(x, box=box))
        sim.minimize_energy(steps=20)
        sim.set_velocities_to_temperature(300.0, seed=3)
        sim.step(steps)
        ck = os.path.join(tmp, "ck.npz")
        sysf = os.path.join(tmp, "sys.npz")
        sim.save_checkpoint(ck)
        save_system(sysf, sim.system)
        saved = snapshot(sim.context.state)
        sim.step(steps)
        ends, bitwise = [], []
        for _ in range(2):
            s = amm.Simulation(load_system(sysf, device=dev), integrator(),
                               amm.make_state(saved["x"], v=saved["v"],
                                              box=saved["box"]))
            s.load_checkpoint(ck)
            bitwise.append(equals_snapshot(s.context.state, saved))
            s.step(steps)
            ends.append(s.context.state)
        same = [torch.equal(e.x, sim.context.state.x)
                and torch.equal(e.v, sim.context.state.v) for e in ends]
        log(f"resume water216 K2 float32 LangevinMiddle: restored bitwise "
            f"{bitwise}; continuations bitwise equal to the uninterrupted "
            f"run (x and v) {same}; max|dx| "
            f"{float((ends[0].x - sim.context.state.x).abs().max()):.3e}")
        require("resume slice", {"restored_bitwise": all(bitwise),
                                 "continuation_bitwise": all(same)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sweep_launches(system, calls, per_step):
    """K1 and K2 launches of Context.step calls [(n, passes), ...] on a
    RESPA system, derived from the code: each spec's force is evaluated
    per_step[name] times an outer step and once more at the start of each
    pass, by K1 where the spec has half maps, else by K2."""
    want = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0, "block_pair": 0}
    specs = {"far": system.neighbors,
             "near": system.extra_neighbor_specs["near"]}
    for name, spec in specs.items():
        kernel = "half_pair" if spec.half_stencil else "cell_pair"
        want[kernel] += sum(p * (per_step[name] * n + 1) for n, p in calls)
    return want


def phase_triclinic(dev, eq, k2_steps=10):
    """Path (k): triclinic (3, 3) cells on K1 and K2, which round each slot
    in fractional coordinates (pair_forms.cuh::Image). (k1) the 30k
    headline state with its box given as diag(L, L, L) (every spec built
    for the matrix, so the whole triclinic route) against K1 at the (3,)
    box, per group, float64 (energy 1e-10, forces 1e-9 max|F|) and float32
    (1e-4); (k2) the same state with the molecules' centres mapped into
    the sheared cell shear_cell(L) (SHEAR), `k2_steps` outer RESPA steps
    through Context.step in float32 and float64: finite, T 280-320 K, ms
    per outer step; (k3) 400 waters in the sheared cell at 0.7 nm, RF and
    PME, RESPA [2, 2, 1] + NHC, 5 outer steps in float64 on the card
    against the CPU (x, v to 1e-9 relative). The launch counts are set to
    0 just before (k2) and read after (k3)'s card runs, and must equal the
    count derived from the code (sweep_launches). Then K1 and K2 against
    their float64 plain twins at (k2)'s and (k3)'s grids (K2 on (k2)'s far
    grid without its half maps), K1's device time at (k2)'s grids, and
    (k4) PME against the plane-wave Ewald sum on tests/test_triclinic.py's
    sheared cell on the card (2e-5)."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux
    from atomsmm_tpu_torch.ops.pbc import max_cutoff, \
        triclinic_from_lengths_angles
    from atomsmm_tpu_torch.ops.pme import ewald_reference_energy, \
        pme_reciprocal_energy
    from atomsmm_tpu_torch.potential import force_fn
    from atomsmm_tpu_torch.utils import replace

    f32, f64 = torch.float32, torch.float64
    box_l = float(eq[2][0])
    results, k1 = [], []
    for dtype in (f64, f32):
        ortho, _, st_o = headline(dev, eq, dtype)
        tric, _, st_t = headline(dev, eq, dtype, cell=np.diag([box_l] * 3))
        if not (st_t.box.shape == (3, 3)
                and tric.neighbors.grid == ortho.neighbors.grid
                and tric.extra_neighbor_specs["near"].grid
                == ortho.extra_neighbor_specs["near"].grid):
            raise RuntimeError("(k1): the diag(L) specs do not have the (3,) "
                               "specs' grids")
        aux_o = make_aux(ortho, all_neighbor_extras(ortho, st_o.x, st_o.box))
        aux_t = make_aux(tric, all_neighbor_extras(tric, st_t.x, st_t.box))
        for g in (0, 1, 2):
            e_o, f_o = force_fn(ortho, {g})(st_o.x, st_o.box, {}, aux_o)
            e_t, f_t = force_fn(tric, {g})(st_t.x, st_t.box, {}, aux_t)
            k1.append(judge(f"(k1) group {g} K1 at diag(L) (3,3) vs K1 at "
                            f"(3,) 30k", dtype, e_t, f_t, e_o, f_o))
        del ortho, tric, aux_o, aux_t

    cell = shear_cell(box_l)
    k2_ms, expected = {}, {"half_pair": 0, "cell_pair": 0, "tile_pair": 0,
                           "block_pair": 0}
    pk.reset_launches()
    for dtype in (f32, f64):
        respa, integ, state = headline(dev, eq, dtype, cell=cell)
        ctx = amm.Context(respa, integ, state)
        rec = counted_context(ctx)
        ctx.step(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.step(k2_steps)
        torch.cuda.synchronize()
        k2_ms[str(dtype)[6:]] = (time.perf_counter() - t0) * 1e3 / k2_steps
        for k, v in sweep_launches(respa, rec["calls"],
                                   {"far": 1, "near": 2}).items():
            expected[k] += v
        temp = float(ctx.temperature())
        finite = bool(torch.isfinite(ctx.state.x).all()
                      and torch.isfinite(ctx.state.v).all())
        log(f"path (k2) water30k in the sheared cell {np.round(cell, 4).tolist()} "
            f"(shear {SHEAR}; max_cutoff {max_cutoff(cell):.4f} nm > 0.9), "
            f"grids far {ctx.system.neighbors.grid} near "
            f"{ctx.system.extra_neighbor_specs['near'].grid}, "
            f"{str(dtype)[6:]}: {k2_steps} outer steps at "
            f"{k2_ms[str(dtype)[6:]]:.3f} ms/step; T {temp:.2f} K; finite "
            f"{finite}")
        require(f"path (k2) {str(dtype)[6:]}",
                {"finite": finite, "temperature": 280.0 <= temp <= 320.0})
        if dtype == f64:
            k2_sys, k2_x = respa, ctx.state.x.clone()
            k2_box = ctx.state.box.clone()
        del ctx, state

    k3 = {}
    for method in ("cutoff", "pme"):
        runs = []
        for device in ("cpu", dev):
            system, x, _ = water_system(n_molecules=400, method=method,
                                        r_cut=0.7, r_switch=0.6, dtype=f64,
                                        device=device)
            box3 = float(system.default_box[0])
            cell3 = shear_cell(box3)
            system, xs = water_in_cell(system, x, box3, cell3, 0.7, device)
            respa = amm.RESPASystem(system, rcut_in=0.45, rswitch_in=0.35)
            m = system.masses.cpu().numpy()
            v = np.random.RandomState(2).normal(size=xs.shape) * np.sqrt(
                amm.units.BOLTZMANN * 300.0 / m)[:, None]
            integ = amm.MultipleTimeScaleIntegrator(
                0.004, [2, 2, 1], temperature=300.0, time_scale=0.1,
                degrees_of_freedom=3 * system.num_particles - 3)
            ctx = amm.Context(respa, integ, amm.make_state(
                torch.as_tensor(xs, device=device),
                v=torch.as_tensor(v, device=device),
                box=torch.as_tensor(cell3, device=device)))
            rec = counted_context(ctx)
            ctx.step(5)
            if device != "cpu":
                torch.cuda.synchronize()
                for k, v_ in sweep_launches(respa, rec["calls"],
                                            {"far": 1, "near": 2}).items():
                    expected[k] += v_
                k3[method] = (respa, ctx.state.x.clone(),
                              ctx.state.box.clone())
            runs.append((ctx.state.x.cpu(), ctx.state.v.cpu()))
        (xc, vc), (xg, vg) = runs
        err = max(float((a - b).abs().max()) / float(a.abs().max())
                  for a, b in ((xc, xg), (vc, vg)))
        log(f"path (k3) water400 {method} in the sheared cell, float64 card "
            f"vs CPU, RESPA [2, 2, 1] + NHC 5 outer steps, grids far "
            f"{respa.neighbors.grid} (half maps "
            f"{respa.neighbors.half_stencil}) near "
            f"{respa.extra_neighbor_specs['near'].grid}: x, v max rel diff "
            f"{err:.2e}")
        require(f"path (k3) {method}", {"card_equals_cpu": err < 1e-9})
    launches = dict(pk.LAUNCHES)
    log(f"path (k) launches over (k2) and (k3) on the card: {launches} "
        f"(derived {expected})")
    require("path (k)", {"launches": launches == expected})

    # K1 and K2 against their plain twins at path (k)'s grids
    far, near = k2_sys.neighbors, k2_sys.extra_neighbor_specs["near"]
    compare("water30k sheared far", k2_sys.forces[2], far, k2_x, k2_box, dev,
            results)
    compare("water30k sheared near", k2_sys.forces[1], near, k2_x, k2_box,
            dev, results)
    compare("water30k sheared far, full stencil", k2_sys.forces[2],
            replace(far, half_stencil=False), k2_x, k2_box, dev, results)
    for method, (r3, x3, b3) in k3.items():
        compare(f"water400 sheared {method} far", r3.forces[2], r3.neighbors,
                x3, b3, dev, results)
        compare(f"water400 sheared {method} near", r3.forces[1],
                r3.extra_neighbor_specs["near"], x3, b3, dev, results)
    # K1's device time at (k2)'s grids, float32, at the float64 run's end
    sys32, _, _ = headline(dev, eq, f32, cell=cell)
    x32, b32 = k2_x.to(f32).contiguous(), k2_box.to(f32)
    timings = {}
    for label, force, spec in (
            ("far", sys32.forces[2], sys32.neighbors),
            ("near", sys32.forces[1], sys32.extra_neighbor_specs["near"])):
        timings[label] = time_cells(f"water30k sheared {label}", force, spec,
                                    x32, b32)

    h = torch.as_tensor(triclinic_from_lengths_angles(
        2.2, 2.0, 2.4, 90.0, 105.0, 80.0), dtype=f64, device=dev)
    rs = np.random.RandomState(3)
    x = torch.as_tensor(rs.uniform(0, 1, (24, 3)), device=dev) @ h
    q = torch.as_tensor(rs.uniform(-1, 1, (24,)), device=dev)
    q = q - q.mean()
    e_pme = float(pme_reciprocal_energy(x, h, q, 3.0, (32, 32, 32), 6))
    e_ref = float(ewald_reference_energy(x, h, q, 3.0, kmax=14))
    rel = abs(e_pme - e_ref) / abs(e_ref)
    log(f"path (k4) PME vs plane-wave Ewald on a sheared cell on the card: "
        f"{e_pme:.12g} vs {e_ref:.12g}, rel {rel:.2e} (tol 2e-5)")
    require("path (k4)", {"pme_vs_ewald": rel <= 2e-5})
    return {"launches": launches, "k2_ms": k2_ms, "k1": k1,
            "kernel_checks": results, "timings": timings}


# --- path (l): Amber input, BASELINE config 6's state as 0.15 M NaCl -------

# Joung & Cheatham (2008) TIP3P ions, (R_min/2 [A], epsilon [kcal/mol])
ION_NA = (1.369, 0.0874)
ION_CL = (2.513, 0.0356)
# the Na+-Cl- row off Lorentz-Berthelot, (R_min [A], epsilon [kcal/mol]):
# the NBFIX of Luo & Roux (2010), fitted for CHARMM ions; here it only has
# to be off the combining rule
NBFIX_NACL = (3.731, 0.0839)
# the 10-12 variant's O-H slot, (A [kcal A^12], B [kcal A^10]) as in
# tests/test_amber.py:605
HBOND_AB = (7500.0, 2300.0)
N_IONS = 27          # Na+ and as many Cl-: 0.15 M in 10,000 waters' box
ION_SEPARATION = 1.0  # nm, the least O-O distance of the replaced waters
# path (l)'s bands. T as (g1), and (g1)'s drift bound. PE per atom from
# the witness k1_ab/nacl_energy.py (path (l)'s protocol run for 3,000
# steps on the card: its reads lie in -14.11 ... -13.97, sigma 0.04),
# +-3 sigma and rounded outward. The band first set here, (g1)'s -15.1 ...
# -14.3 moved by the ions' -0.7, failed: the settle-in equipartitions the
# waters, which (g1)'s stored state does not (PERF.md section 6)
L_BANDS = {"T": (280.0, 320.0), "pe": (-14.25, -13.75), "drift": 0.15}


def nacl_prmtop(n_water, n_na, n_cl, hbond=False):
    """prmtop text of `n_water` TIP3P waters then `n_na` Na+ and `n_cl`
    Cl- (types OW, HW, Na+, Cl-), the Na+-Cl- row of ACOEF/BCOEF at
    NBFIX_NACL; with `hbond` the OW-HW slot is a 10-12 pair (HBOND_AB).
    Same-type and Lorentz-Berthelot rows: A = eps R_min^12,
    B = 2 eps R_min^6 with R_min = R_min/2_i + R_min/2_j and
    eps = sqrt(eps_i eps_j)."""
    import numpy as np

    from atomsmm_tpu_torch.models.peptide import (AMBER_CHARGE, TIP3P_AMBER,
                                                  prmtop_text)

    w = TIP3P_AMBER
    n = 3 * n_water + n_na + n_cl
    half = [w["sigma_o"] * 2.0 ** (1.0 / 6.0) / 2.0, 0.0, ION_NA[0],
            ION_CL[0]]
    eps = [w["eps_o"], 0.0, ION_NA[1], ION_CL[1]]
    acoef, bcoef, parm = [], [], [0] * 16
    for i in range(4):
        for j in range(i + 1):
            rmin, e = half[i] + half[j], float(np.sqrt(eps[i] * eps[j]))
            if (i, j) == (3, 2):
                rmin, e = NBFIX_NACL
            acoef.append(e * rmin ** 12)
            bcoef.append(2.0 * e * rmin ** 6)
            parm[4 * i + j] = parm[4 * j + i] = len(acoef)
    if hbond:
        parm[1] = parm[4] = -1
    o = 3 * np.arange(n_water)
    bonds = np.stack([3 * o, 3 * (o + 1), np.ones_like(o), 3 * o,
                      3 * (o + 2), np.ones_like(o)], 1).reshape(-1)
    angles = np.stack([3 * (o + 1), 3 * o, 3 * (o + 2), np.ones_like(o)],
                      1).reshape(-1)
    pointers = [0] * 31
    pointers[0], pointers[1] = n, 4              # NATOM, NTYPES
    pointers[2], pointers[4] = 2 * n_water, n_water  # NBONH, NTHETH
    pointers[11] = n_water + n_na + n_cl         # NRES
    pointers[15], pointers[16], pointers[18] = 1, 1, 4
    pointers[19] = 1 if hbond else 0             # NPHB
    pointers[20] = 1                             # IFBOX
    q = [w["q_o"], w["q_h"], w["q_h"]] * n_water + [1.0] * n_na \
        + [-1.0] * n_cl
    sections = [
        ("ATOM_NAME", ["O", "H1", "H2"] * n_water + ["Na+"] * n_na
         + ["Cl-"] * n_cl, "a"),
        ("CHARGE", [c * AMBER_CHARGE for c in q], "e"),
        ("ATOM_TYPE_INDEX", [1, 2, 2] * n_water + [3] * n_na + [4] * n_cl,
         "i"),
        ("MASS", [15.9994, 1.008, 1.008] * n_water + [22.99] * n_na
         + [35.45] * n_cl, "e"),
        ("NONBONDED_PARM_INDEX", parm, "i"),
        ("RESIDUE_LABEL", ["WAT"] * n_water + ["Na+"] * n_na
         + ["Cl-"] * n_cl, "a"),
        ("RESIDUE_POINTER", list(1 + 3 * np.arange(n_water))
         + list(1 + 3 * n_water + np.arange(n_na + n_cl)), "i"),
        ("BOND_FORCE_CONSTANT", [553.0], "e"),
        ("BOND_EQUIL_VALUE", [w["r_oh"]], "e"),
        ("ANGLE_FORCE_CONSTANT", [100.0], "e"),
        ("ANGLE_EQUIL_VALUE", [w["theta"] * np.pi / 180.0], "e"),
        ("LENNARD_JONES_ACOEF", acoef, "e"),
        ("LENNARD_JONES_BCOEF", bcoef, "e"),
        ("BONDS_INC_HYDROGEN", list(bonds), "i"),
        ("BONDS_WITHOUT_HYDROGEN", [], "i"),
        ("ANGLES_INC_HYDROGEN", list(angles), "i"),
        ("ANGLES_WITHOUT_HYDROGEN", [], "i"),
    ]
    if hbond:
        sections += [("HBOND_ACOEF", [HBOND_AB[0]], "e"),
                     ("HBOND_BCOEF", [HBOND_AB[1]], "e")]
    return prmtop_text(pointers, sections)


def nacl_state(x, v, box_l, n_ions, separation, seed):
    """Waters of (x, v) (O, H, H each) with 2 n_ions of them, drawn by
    numpy.random.default_rng(seed) no two O closer than `separation`,
    replaced by n_ions Na+ and n_ions Cl- at their O sites (the O's
    velocity): (x, v) as waters then Na+ then Cl-, and the number of
    waters left."""
    import numpy as np

    m = len(x) // 3
    o = x[0::3]
    chosen = []
    for i in np.random.default_rng(seed).permutation(m):
        d = o[chosen] - o[i]
        d -= box_l * np.round(d / box_l)
        if not chosen or np.sqrt((d * d).sum(1)).min() >= separation:
            chosen.append(int(i))
            if len(chosen) == 2 * n_ions:
                break
    if len(chosen) < 2 * n_ions:
        raise RuntimeError(f"only {len(chosen)} waters {separation} nm apart")
    keep = np.setdiff1d(np.arange(m), chosen)
    xs = np.concatenate([x.reshape(m, 3, 3)[keep].reshape(-1, 3), o[chosen]])
    vs = np.concatenate([v.reshape(m, 3, 3)[keep].reshape(-1, 3),
                         v[0::3][chosen]])
    return xs, vs, len(keep)


def nacl_system(text, crd, dtype, dev, method="pme"):
    """io.amber_system on prmtop and inpcrd text as path (l) calls it."""
    from atomsmm_tpu_torch.io import amber_system

    return amber_system(text, crd, method=method, r_cut=0.9,
                        rigid_water=True, neighbors=True, dtype=dtype,
                        device=dev)


def phase_amber(dev, eq, seed=7, settle=600, steps=200, chunks=8, chunk=50):
    """Path (l): BASELINE config 6's state (bench_data/eq_tip3p30k.npz,
    10,000 TIP3P waters) as 0.15 M NaCl, read from prmtop and inpcrd text
    through io.amber_system(method="pme", r_cut=0.9, rigid_water=True,
    neighbors=True) in float32 on the card: 54 waters drawn by
    numpy.random.default_rng(seed) no two closer than 1 nm replaced by 27
    Na+ and 27 Cl- (Joung-Cheatham TIP3P ions, the Na+-Cl- row an NBFIX
    row): 9,946 waters + 54 ions = 29,892 atoms. The ions settle in under
    LangevinMiddle at 1 fs (10/ps, 300 K) for `settle` steps, then (g1)'s
    integrator (VV @ 2 fs + NHC 300 K): step(1), a timed step(steps) (CUDA
    events; the conserved energy before and after), `chunks` x
    step(chunk) with T and PE read. Checks: lj_type set and the table
    form on K1, every water on SETTLE, finiteness, the SETTLE residual,
    the K1 launches of the timed call (1 a step + 1 a pass), L_BANDS."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models.peptide import TIP3P_AMBER, inpcrd_text
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f32 = torch.float32
    ex, ev, ebox = eq
    box_l = float(ebox[0])
    x, v, n_water = nacl_state(ex, ev, box_l, N_IONS, ION_SEPARATION, seed)
    na_cl = (ION_NA, ION_CL, NBFIX_NACL)
    log(f"path (l) parameters: TIP3P {TIP3P_AMBER}; Na+ R_min/2 "
        f"{na_cl[0][0]} A eps {na_cl[0][1]} kcal/mol; Cl- R_min/2 "
        f"{na_cl[1][0]} A eps {na_cl[1][1]} kcal/mol; NBFIX Na+-Cl- R_min "
        f"{na_cl[2][0]} A eps {na_cl[2][1]} kcal/mol (Lorentz-Berthelot "
        f"would give {na_cl[0][0] + na_cl[1][0]:.3f} A, "
        f"{np.sqrt(na_cl[0][1] * na_cl[1][1]):.4f} kcal/mol)")
    t0 = time.perf_counter()
    text = nacl_prmtop(n_water, N_IONS, N_IONS)
    crd = inpcrd_text(x, ebox)
    t1 = time.perf_counter()
    system, xt, box = nacl_system(text, crd, f32, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    nb = system.forces[0]
    n = system.num_particles
    form = nb._pair_form()
    log(f"path (l) files: prmtop {len(text) / 1e6:.2f} MB, inpcrd "
        f"{len(crd) / 1e6:.2f} MB written in {t1 - t0:.2f} s; amber_system "
        f"{t2 - t1:.2f} s: {n} atoms ({n_water} waters, {N_IONS} Na+, "
        f"{N_IONS} Cl-), {nb.pair_sigma.shape[0]} LJ types, form table "
        f"{form.table} hbond {form.hbond}, grid {system.neighbors.grid} cap "
        f"{system.neighbors.cell_capacity}, PME grid {nb.grid_shape} alpha "
        f"{nb.ewald_alpha:.5f}")
    require("path (l) system", {
        "atoms": n == 29892, "lj_type": nb.lj_type is not None,
        "table_form": form.table and not form.hbond,
        "nbfix_row": abs(float(nb.pair_sigma[2, 3]) - NBFIX_NACL[0] / 10.0
                         / 2.0 ** (1.0 / 6.0)) < 1e-6,
        "settle": (system.settle is not None
                   and system.settle.size == n_water
                   and system.constraints is None),
        "k1": system.neighbors.half_stencil})
    dof = amm.count_degrees_of_freedom(system)
    vt = torch.as_tensor(v, dtype=f32, device=dev)
    ctx = amm.Context(system, amm.LangevinMiddleIntegrator(
        0.001, 300.0, friction=10.0), amm.make_state(xt, v=vt, box=box))
    t0 = time.perf_counter()
    ctx.step(settle)
    temp_settled = float(ctx.temperature())
    log(f"path (l) settle-in: {settle} LangevinMiddle steps at 1 fs, 10/ps, "
        f"300 K in {time.perf_counter() - t0:.2f} s; T {temp_settled:.2f} K")
    st = ctx.state
    ctx = amm.Context(system, amm.GlobalThermostatIntegrator(
        0.002, amm.NoseHooverChainPropagator(300.0, dof, 0.1)),
        amm.make_state(st.x, v=st.v, box=st.box))
    ctx.step(1)
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
    drift = (e1 - e0) / (n * steps * 0.002)
    xs, vs = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(vs).all())
    residual = geometry_residual(system, xs)
    temps, pes = [], []
    for _ in range(chunks):
        ctx.step(chunk)
        temps.append(float(ctx.temperature()))
        pes.append(float(ctx.get_state(lite=True).potential_energy) / n)
    temp, pe = sum(temps) / chunks, sum(pes) / chunks
    expected = {"half_pair": passes * (steps + 1), "cell_pair": 0,
                "tile_pair": 0, "block_pair": 0}
    ns_day = 0.002 * 1e-3 * 86400.0 / (ms * 1e-3)
    bands = L_BANDS
    log(f"path (l) nacl30k from prmtop/inpcrd, PME, SETTLE, VV@2fs NHC "
        f"float32: {ms:.3f} ms/step by CUDA events ({wall / steps * 1e3:.3f} "
        f"by the host clock), {ns_day:.3f} ns/day; launches {launches} "
        f"(expected {expected}, passes {passes}); T {temp:.2f} K (band "
        f"{bands['T']}; reads {', '.join(f'{t:.2f}' for t in temps)}); "
        f"PE/atom {pe:.4f} kJ/mol (band {bands['pe']}; reads "
        f"{', '.join(f'{e:.4f}' for e in pes)}); drift {drift:.5f} "
        f"kJ/mol/atom/ps (bound {bands['drift']}); SETTLE residual "
        f"{residual:.2e}; finite {finite}")
    require("path (l)", {
        "finite": finite,
        "launches": launches == expected,
        "settle_residual": residual <= 1e-4,
        "temperature": bands["T"][0] <= temp <= bands["T"][1],
        "pe_per_atom": bands["pe"][0] <= pe <= bands["pe"][1],
        "drift": abs(drift) <= bands["drift"],
    })
    return {"ctx": ctx, "launches": launches, "ms_per_step": ms,
            "ns_day": ns_day, "T": temp, "pe": pe, "drift": drift,
            "residual": residual, "n_water": n_water}


def phase_kernels_amber(dev, run):
    """K1 against its plain twin at path (l)'s grid and state, float64 and
    float32, in the table forms: the full PME (Ewald direct space) and
    reaction-field forms, the near and fused far forms of
    RESPASystem(0.6, 0.5) (near on its own grid) and the virial forms of
    the full and far ones; then the 10-12 variant (the same files with the
    OW-HW slot a 10-12 pair, HBOND_AB): K1 in the full and fused far forms
    and K2 on a full-stencil spec of the far grid. Then K1's table form
    timed beside its Lorentz-Berthelot form (the same force without the
    tables, each pair combining per-particle sigma and epsilon) on the same
    grid and bucket, float32."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models.peptide import inpcrd_text
    from atomsmm_tpu_torch.ops.pairfuncs import virial_form
    from atomsmm_tpu_torch.utils import replace

    f32 = torch.float32
    ctx = run["ctx"]
    system = ctx.system
    x = ctx.state.x.detach().cpu().double()
    box = ctx.state.box.detach().cpu().double()
    nb, spec = system.forces[0], system.neighbors
    results = []
    compare("nacl30k table pme", nb, spec, x, box, dev, results)
    rf = replace(nb, method="cutoff", grid_shape=(0, 0, 0))
    compare("nacl30k table cutoff-RF", rf, spec, x, box, dev, results)
    compare("nacl30k table pme virial", nb, spec, x, box, dev, results,
            form=virial_form(nb._pair_form()))
    respa = amm.RESPASystem(system, rcut_in=0.6, rswitch_in=0.5)
    near, far = pair_forces(respa)
    compare("nacl30k table near", near, respa.extra_neighbor_specs["near"],
            x, box, dev, results)
    compare("nacl30k table far", far, spec, x, box, dev, results,
            unsplit=far.full)
    compare("nacl30k table far virial", far, spec, x, box, dev, results,
            unsplit=far.full, form=virial_form(far._pair_form()))
    # the 10-12 variant, K1 and K2
    hb_sys, _, _ = nacl_system(nacl_prmtop(run["n_water"], N_IONS, N_IONS,
                                           hbond=True),
                               inpcrd_text(x.numpy(), box.numpy()), f32, dev)
    hb = hb_sys.forces[0]
    if not (hb._pair_form().table and hb._pair_form().hbond
            and hb.pair_a1012 is not None):
        raise RuntimeError("the 10-12 variant lost its term")
    hb_far = pair_forces(amm.RESPASystem(hb_sys, rcut_in=0.6,
                                         rswitch_in=0.5))[1]
    full_stencil = replace(hb_sys.neighbors, half_stencil=False)
    compare("nacl30k hbond pme", hb, hb_sys.neighbors, x, box, dev, results)
    compare("nacl30k hbond far", hb_far, hb_sys.neighbors, x, box, dev,
            results, unsplit=hb_far.full)
    compare("nacl30k hbond pme K2", hb, full_stencil, x, box, dev, results)
    compare("nacl30k hbond far K2", hb_far, full_stencil, x, box, dev,
            results, unsplit=hb_far.full)
    x32, b32 = x.to(dev, f32).contiguous(), box.to(dev, f32)
    lb = replace(nb, lj_type=None, pair_sigma=None, pair_epsilon=None)
    timings = {"table": time_cells("nacl30k table pme", nb, spec, x32, b32),
               "lb": time_cells("nacl30k Lorentz-Berthelot pme", lb, spec,
                                x32, b32)}
    t, l_ = timings["table"], timings["lb"]
    log(f"path (l) K1 table form {t['ms']:.4f} ms vs Lorentz-Berthelot "
        f"{l_['ms']:.4f} ms of device time on the same grid and bucket "
        f"({t['ms'] / l_['ms']:.3f}x)")
    return results, timings


def phase_slice_amber(dev, n_water=200, n_ions=2, steps=10, seed=3):
    """Path (l)'s slice, float64, card against CPU (the plain twins there):
    204 TIP3P waters on the lattice of models.rigid_water_system, 4 of them
    (drawn by numpy.random.default_rng(seed), no two O closer than 0.7 nm)
    replaced by 2 Na+ and 2 Cl-, written as prmtop and inpcrd text by the
    path (l) writer and read through io.amber_system (PME, 0.9 nm, rigid
    water; a 1^3 grid: K2 with the table form), `steps` steps of VV @ 2 fs
    + NHC with velocities from one numpy draw: x and v to 1e-9 relative,
    the per-force energies at the CPU's final positions to 1e-10 of the
    largest, K2 launched and K1 not."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import rigid_water_system
    from atomsmm_tpu_torch.models.peptide import inpcrd_text
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux
    from atomsmm_tpu_torch.potential import split_potential_energy

    f64 = torch.float64
    m = n_water + 2 * n_ions
    _, x, box = rigid_water_system(n_molecules=m, r_cut=0.9, dtype=f64,
                                   seed=5, device="cpu")
    box_l = float(box[0])
    x = x.numpy()
    xs, vs, kept = nacl_state(x, np.zeros_like(x), box_l, n_ions, 0.7, seed)
    text = nacl_prmtop(kept, n_ions, n_ions)
    crd = inpcrd_text(xs, np.full(3, box_l))
    runs = []
    for device in ("cpu", dev):
        system, xt, bt = nacl_system(text, crd, f64, device)
        mass = system.masses.cpu().numpy()
        v = np.random.RandomState(9).normal(size=xt.shape) * np.sqrt(
            amm.units.BOLTZMANN * 300.0 / mass)[:, None]
        dof = amm.count_degrees_of_freedom(system)
        ctx = amm.Context(system, amm.GlobalThermostatIntegrator(
            0.002, amm.NoseHooverChainPropagator(300.0, dof, 0.1)),
            amm.make_state(xt, v=torch.as_tensor(v, device=device), box=bt))
        pk.reset_launches()
        ctx.step(steps)
        launches = dict(pk.LAUNCHES)
        runs.append((system, ctx, launches))
    (cs, cpu, _), (gs, gpu, launches) = runs
    worst = max(float((a - b.cpu()).abs().max()) / float(a.abs().max())
                for a, b in ((cpu.state.x, gpu.state.x),
                             (cpu.state.v, gpu.state.v)))
    xe, be = cpu.state.x, cpu.state.box
    e_c = split_potential_energy(cs, xe, be, aux=make_aux(
        cs, all_neighbor_extras(cs, xe, be)))
    xg, bg = xe.to(dev), be.to(dev)
    e_g = split_potential_energy(gs, xg, bg, aux=make_aux(
        gs, all_neighbor_extras(gs, xg, bg)))
    scale = max(abs(float(v)) for v in e_c.values())
    e_err = max(abs(float(e_g[k]) - float(e_c[k])) for k in e_c) / scale
    log(f"slice (l) {gs.num_particles} atoms ({kept} TIP3P, {n_ions} Na+, "
        f"{n_ions} Cl-) from prmtop/inpcrd, PME, float64, grid "
        f"{gs.neighbors.grid} (half maps {gs.neighbors.half_stencil}), "
        f"table form {gs.forces[0]._pair_form().table}, {steps} VV+NHC "
        f"steps card vs CPU: x, v max rel diff {worst:.2e}; energies max "
        f"rel diff {e_err:.2e} of the largest term; launches {launches}")
    require("slice (l)", {
        "card_equals_cpu": worst < 1e-9, "energies": e_err <= 1e-10,
        "k2": launches["cell_pair"] > 0 and launches["half_pair"] == 0,
        "table": gs.forces[0]._pair_form().table})


# --- path (m): more than one rank (SpatialContext, replicas over a mesh) ---

# (m2): the 2-rank float32 RF trajectory against the one-process
# full-stencil Context after M2_STEPS outer steps: positions to M2_X_TOL nm,
# velocities to M2_V_TOL of max|v| (the ranks sum the bonded forces with
# atomics, so float32 last bits differ from the one-process run)
M2_STEPS = 10
M2_X_TOL, M2_V_TOL = 1e-4, 1e-2
# (m2)'s atom-sharded reciprocal sum against the one-process sum on the same
# float32 inputs (the spread adds in another order): energy and forces
M2_PME_RTOL, M2_PME_FTOL = 1e-5, 1e-4


def full_stencil(system):
    """`system` with every cell list on its full stencil: the one-process
    counterpart of a sharded sweep (K2 on both grids)."""
    import dataclasses

    from atomsmm_tpu_torch.utils import replace

    extra = {name: dataclasses.replace(s, half_stencil=False)
             for name, s in (system.extra_neighbor_specs or {}).items()}
    return replace(system, neighbors=dataclasses.replace(
        system.neighbors, half_stencil=False),
        extra_neighbor_specs=extra or None)


def npt_integrator(loops=(4, 2, 1)):
    import atomsmm_tpu_torch as amm

    return amm.MultipleTimeScaleIntegrator(
        0.004, list(loops), temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * 3 * NPT_N_MOLECULES - 3)


def phase_spatial_one_rank(dev, eq100, path_f_pme_ms, steps=100):
    """(m1): config 5 with PME (path (f)'s system and integrator) under
    SpatialContext on a 1-rank DeviceMesh over NCCL: step(1), then a timed
    step(100). The reciprocal sum must take the slab FFT (a real NCCL
    reduce_scatter and all_to_all on one rank), every pair sweep K2 over
    the rank's home cells (exact count, no K1 launch), and T, PE/atom,
    |dV/V| and the invalid trials must stay inside path (f)'s bands. Then
    K2 against its plain twin and timed at (m1)'s far and near grids on
    their full stencils."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.forces import last_reciprocal_dispatch
    from atomsmm_tpu_torch.integrate import barostat as baro
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import pme
    from atomsmm_tpu_torch.parallel import SpatialContext

    loops = [4, 2, 1]
    respa, x, v, box = npt_water(dev, "pme", eq100)
    n = respa.num_particles
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
            ctx = SpatialContext(respa, npt_integrator(loops),
                                 amm.make_state(x, v=v, box=box), mesh=mesh)
            ctx.step(1)
            torch.cuda.synchronize()
            box0 = ctx.state.box.clone()
            ext0 = {k: int(ctx.state.extra[k])
                    for k in (baro.BARO_NATT, baro.BARO_NACC, baro.BARO_NBAD)}
            a = attempts_due(ctx.state.step, steps, NPT_FREQUENCY)
            pk.reset_launches()
            pme.reset_evaluations()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            ctx.step(steps)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / steps
            launches, recip = dict(pk.LAUNCHES), pme.EVALUATIONS["reciprocal"]
            passes = ctx.last_step_passes
            dispatch = last_reciprocal_dispatch()
            temp = float(ctx.temperature())
            pe = float(ctx.get_state(lite=True).potential_energy) / n
            att, acc, bad = (int(ctx.state.extra[k]) - ext0[k] for k in (
                baro.BARO_NATT, baro.BARO_NACC, baro.BARO_NBAD))
            dv = float(torch.prod(ctx.state.box) / torch.prod(box0)) - 1.0
            finite = bool(torch.isfinite(ctx.state.x).all()
                          and torch.isfinite(ctx.state.v).all())
            xs, boxs, run_sys = ctx.state.x.clone(), ctx.state.box.clone(), \
                ctx.system
        finally:
            dist.destroy_process_group()
    # per pass: near loops[1] and far once a step, one of each for the
    # force-cache refresh, and e_old, e_new and the refresh of each move
    expected = {"half_pair": 0, "tile_pair": 0, "block_pair": 0,
                "cell_pair": passes * (
        (loops[1] + 1) * steps + 2 + 6 * a)}
    expected_recip = passes * (steps + 1 + 3 * a)
    far_f = pair_forces(run_sys)[1].full
    log(f"path (m1) water100k ({n} atoms) PME NPT RESPA{loops}@4fs NHC 300 "
        f"K, MC barostat every {NPT_FREQUENCY} steps, float32, under "
        f"SpatialContext on a 1-rank DeviceMesh (NCCL): grid "
        f"{far_f.grid_shape}, reciprocal path {dispatch}; far grid "
        f"{run_sys.neighbors.grid} cap {run_sys.neighbors.cell_capacity}, "
        f"near grid {run_sys.extra_neighbor_specs['near'].grid} cap "
        f"{run_sys.extra_neighbor_specs['near'].cell_capacity}, both swept "
        f"by K2 on the full stencil; step({steps}) {ms:.3f} ms per outer "
        f"step by CUDA events (path (f) PME on K1, same call: "
        f"{path_f_pme_ms:.3f} ms, ratio {ms / path_f_pme_ms:.3f}) on "
        f"{smi_line()}; launches {launches} (expected {expected}, passes "
        f"{passes}); reciprocal evaluations {recip} (expected "
        f"{expected_recip}); T {temp:.2f} K; PE/atom {pe:.4f} kJ/mol; "
        f"attempts {att} (expected {a}), accepted {acc}, invalid {bad}; "
        f"dV/V {dv:+.4%}; finite {finite}")
    require("path (m1)", {
        "finite": finite,
        "dispatch": dispatch == "slab_fft",
        "launches": launches == expected,
        "reciprocal_evaluations": recip == expected_recip,
        "attempts": att == a,
        "invalid_trials": bad == 0,
        "temperature": 280.0 <= temp <= 320.0,
        "pe_per_atom": -14.6 <= pe <= -13.8,
        "volume": abs(dv) < 0.03,
    })
    # K2 at (m1)'s own grids and state: against its plain twin, then timed
    kernel_checks, timings = [], {}
    near, far = pair_forces(run_sys)
    for label, force, spec in (
            ("far", far, run_sys.neighbors),
            ("near", near, run_sys.extra_neighbor_specs["near"])):
        full = dataclasses.replace(spec, half_stencil=False)
        compare(f"path (m1) water100k pme {label} grid {spec.grid[0]}^3 cap "
                f"{spec.cell_capacity} full stencil", force, full, xs, boxs,
                dev, kernel_checks,
                unsplit=far.full if label == "far" else None)
        timings[label] = time_cells(f"path (m1) water100k pme {label} full "
                                    "stencil", force, full, xs, boxs,
                                    plain_reps=1)
    return {"launches": launches, "ms_per_step": ms, "dispatch": dispatch,
            "kernel_checks": kernel_checks, "timings": timings}


def m2_rank(rank, world, store, out_dir):
    """(m2), one gloo rank of two sharing the card: the sharded far and
    near RF sweeps in float32 and float64 against the one-process K2 rows
    of this rank, M2_STEPS outer RF steps under SpatialContext in float32,
    and the atom-sharded reciprocal sum on a grid that two ranks do not
    divide against the one-process sum; saves what it got."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import build_cell_buckets
    from atomsmm_tpu_torch.ops.pme import (
        _good_fft_size,
        pme_reciprocal_energy_forces,
    )
    from atomsmm_tpu_torch.parallel import SpatialContext, spatial

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    d = np.load(os.path.join(HERE, "bench_data", "eq_water100k.npz"))
    eq100 = (d["x"], d["v"], d["box"])
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    out = {}
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("dp",))
        for dtype in (torch.float64, torch.float32):
            respa, x, v, box = npt_water(dev, "cutoff", eq100, dtype)
            near, far = pair_forces(respa)
            for label, force, spec in (
                    ("far", far, respa.neighbors),
                    ("near", near, respa.extra_neighbor_specs["near"])):
                bucket, _ = build_cell_buckets(spec, x, box)
                form, pp = force._pair_form(), force._per_particle()
                rows = spatial.sharded_cell_pair_rows(
                    form, x, box, pp, spec, bucket, form.r_cut, mesh)
                whole = pk.full_pair_rows(form, x, box, pp, spec, bucket,
                                          form.r_cut)
                out[f"{label} {str(dtype)[6:]}"] = bool(
                    torch.equal(rows, whole))
        pk.reset_launches()
        ctx = SpatialContext(respa, npt_integrator(),
                             amm.make_state(x, v=v, box=box), mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.step(M2_STEPS)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) / M2_STEPS * 1e3
        out["launches"] = dict(pk.LAUNCHES)
        out["x"], out["v"], out["box"] = (t.cpu() for t in (
            ctx.state.x, ctx.state.v, ctx.state.box))
        pme_sys, xp, _, boxp = npt_water(dev, "pme", eq100)
        full = pair_forces(pme_sys)[1].full
        grid = tuple(full.grid_shape)
        while grid[0] % world == 0:
            grid = (_good_fft_size(grid[0] + 1),) + grid[1:]
        args = (xp, boxp, full.charge, float(full.ewald_alpha), grid)
        e_s, f_s = spatial.sharded_pme_reciprocal_energy(
            *args, mesh, order=full.spline_order)
        e_1, f_1 = pme_reciprocal_energy_forces(*args, full.spline_order)
        out["pme"] = (grid, float(e_s), float(e_1),
                      float((f_s - f_1).abs().max()),
                      float(f_1.abs().max()))
        torch.save(out, os.path.join(out_dir, f"m2_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world, *args):
    """Run fn(rank, world, store, out_dir, *args) in `world` spawned
    processes (gloo ranks on this card) and return each rank's saved
    results; raises with a rank's traceback when one fails."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(fn, args=(world, os.path.join(tmp, "store"), tmp)
                           + args, nprocs=world, join=True,
                           start_method="spawn")
        name = fn.__name__.split("_")[0]
        return [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def phase_spatial_two_ranks(dev, eq100, world=2):
    """(m2): two gloo ranks sharing the card (NCCL refuses two ranks on one
    GPU; gloo takes CUDA tensors for all_reduce and broadcast, which is
    all the sweeps, the state's synchronisation and the atom-sharded sum
    use). Checks: the sharded far and near RF sweeps equal the one-process
    K2 rows bit for bit (float32 and float64), the two ranks' x, v and box
    bitwise equal after step(M2_STEPS) under SpatialContext, within
    M2_X_TOL / M2_V_TOL of a one-process full-stencil Context from the
    same state, and the atom-sharded reciprocal sum on a grid whose K1 two
    ranks do not divide within M2_PME_RTOL / M2_PME_FTOL of the one-process
    sum."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    t0 = time.perf_counter()
    outs = spawn_ranks(m2_rank, world)
    spawn_s = time.perf_counter() - t0
    respa, x, v, box = npt_water(dev, "cutoff", eq100)
    pk.reset_launches()
    ref = amm.Context(full_stencil(respa), npt_integrator(),
                      amm.make_state(x, v=v, box=box))
    ref.step(M2_STEPS)
    ref_launches = dict(pk.LAUNCHES)
    r0 = outs[0]
    dx = float((r0["x"] - ref.state.x.cpu()).abs().max())
    dvel = float((r0["v"] - ref.state.v.cpu()).abs().max())
    vmax = float(ref.state.v.abs().max())
    grid, e_s, e_1, df, fmax = r0["pme"]
    sweeps = {k: all(o[k] for o in outs) for k in r0
              if k.startswith(("far", "near"))}
    same = all(torch.equal(o[k], r0[k]) for o in outs[1:]
               for k in ("x", "v", "box"))
    log(f"path (m2) water100k RF on {world} gloo ranks sharing "
        f"{smi_line()} ({spawn_s:.1f} s with the spawn): sharded sweeps "
        f"equal to the one-process K2 rows bit for bit {sweeps}; "
        f"step({M2_STEPS}) under SpatialContext {r0['step_ms']:.3f} ms per "
        f"outer step on rank 0 (host clock), launches on rank 0 "
        f"{r0['launches']} (one-process full-stencil Context {ref_launches});"
        f" ranks bitwise equal {same}; rank 0 against the one-process "
        f"Context max|dx| {dx:.3e} nm (tol {M2_X_TOL:g}), max|dv| {dvel:.3e} "
        f"of max|v| {vmax:.4g} nm/ps (tol {M2_V_TOL:g}x); atom-sharded PME "
        f"on grid {grid}: E {e_s:.8g} vs {e_1:.8g} (rel "
        f"{abs(e_s - e_1) / abs(e_1):.2e}), max|dF| {df:.3e} of max|F| "
        f"{fmax:.4g}")
    require("path (m2)", {
        **{f"sweep {k}": ok for k, ok in sweeps.items()},
        "ranks_bitwise_equal": same,
        "x": dx <= M2_X_TOL, "v": dvel <= M2_V_TOL * vmax,
        "k2_only": r0["launches"]["half_pair"] == 0
        and r0["launches"]["cell_pair"] > 0,
        "pme_indivisible": grid[0] % world != 0,
        "pme_energy": abs(e_s - e_1) <= M2_PME_RTOL * abs(e_1),
        "pme_forces": df <= M2_PME_FTOL * fmax,
    })
    return {"launches": r0["launches"], "step_ms": r0["step_ms"]}


def m3_rank(rank, world, store, out_dir, x0_path, chunk):
    """(m3), one gloo rank of two sharing the card: path (i)'s 16 replicas
    over a 2-rank DeviceMesh (8 a rank), one chunk of `chunk` steps and a
    swap, timed; saves the swap counts and each row's T."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from atomsmm_tpu_torch.parallel import HREXSampler
    from atomsmm_tpu_torch.parallel.replicas import gather_rows

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("dp",))
        run_sys, xw, box, lams = hrex_inputs(dev, x0_path)
        sampler = HREXSampler(run_sys, xw, box, lams, 300.0, mesh=mesh,
                              dt=0.001, seed=3, neighbor_update_every=5)
        out = run_hrex_chunk(sampler, run_sys, chunk)
        t_rows = gather_rows(out.pop("t_local"), sampler.k_states, mesh)
        out["t_rows"] = t_rows.tolist()
        torch.save(out, os.path.join(out_dir, f"m3_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def hrex_inputs(dev, x0_path):
    """Path (i)'s system retuned at its melted state, that state and the
    16-state ladder, from the file phase_hrex_mesh writes."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.alchemy import coupling_path
    from atomsmm_tpu_torch.models import phenol_in_water
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    saved = torch.load(x0_path, weights_only=False)
    base, _, _, solute = phenol_in_water(n_water=1000, neighbors=True,
                                         skin=0.2, dtype=torch.float32,
                                         device=dev)
    xw, box = saved["x"].to(dev), saved["box"].to(dev)
    run_sys = retune_neighbor_specs(amm.SolvationSystem(base, solute), xw,
                                    box)
    lams = coupling_path(torch.linspace(0.0, 1.0, saved["k_states"],
                                        dtype=torch.float64))
    return run_sys, xw, box, lams


def run_hrex_chunk(sampler, run_sys, chunk):
    """One chunk of `chunk` steps and a swap attempt, timed by CUDA events:
    {ms, attempts, accepts, t_local (each own row's T)}."""
    import torch

    from atomsmm_tpu_torch.state import kinetic_energy
    from atomsmm_tpu_torch.units import BOLTZMANN
    from atomsmm_tpu_torch.utils import count_degrees_of_freedom

    sampler.run(1)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    sampler.run(chunk)
    sampler.attempt_swaps()
    ev[1].record()
    torch.cuda.synchronize()
    dof = count_degrees_of_freedom(run_sys)
    t_local = 2.0 * kinetic_energy(run_sys.masses, sampler.states.v) \
        / (dof * BOLTZMANN)
    return {"ms": ev[0].elapsed_time(ev[1]),
            "attempts": sampler.swap_attempts,
            "accepts": sampler.swap_accepts, "t_local": t_local}


def phase_hrex_mesh(dev, hrex, world=2, chunk=25):
    """(m3): BASELINE config 3b over a mesh: path (i)'s 16 replicas (its
    melted state, retuned capacities, seed 3, neighbor_update_every=5) on
    two gloo ranks sharing the card, 8 a rank, one chunk of `chunk` steps
    and a swap, against the one-process sampler at the same seeds in this
    process: the same number of swap attempts, the acceptance in [0, 1]
    on both, each row's T 260-340 K; state-steps/s of both."""
    import tempfile

    import torch

    from atomsmm_tpu_torch.parallel import HREXSampler

    k_states = 16
    with tempfile.TemporaryDirectory() as tmp:
        x0_path = os.path.join(tmp, "x0.pt")
        torch.save({"x": hrex["x0"].cpu(), "box": hrex["box"].cpu(),
                    "k_states": k_states}, x0_path)
        t0 = time.perf_counter()
        outs = spawn_ranks(m3_rank, world, x0_path, chunk)
        spawn_s = time.perf_counter() - t0
        run_sys, xw, box, lams = hrex_inputs(dev, x0_path)
    one = run_hrex_chunk(HREXSampler(run_sys, xw, box, lams, 300.0, dt=0.001,
                                     seed=3, neighbor_update_every=5),
                         run_sys, chunk)
    r0 = outs[0]
    rate = k_states * chunk / (max(o["ms"] for o in outs) / 1e3)
    rate_one = k_states * chunk / (one["ms"] / 1e3)
    t_rows = r0["t_rows"]
    log(f"path (m3) config 3b ({run_sys.num_particles} atoms) x {k_states} "
        f"states over {world} gloo ranks sharing {smi_line()} "
        f"({spawn_s:.1f} s with the spawn): {chunk} steps + a swap "
        f"{max(o['ms'] for o in outs):.1f} ms (CUDA events, slower rank) = "
        f"{rate:.2f} state-steps/s; one process {one['ms']:.1f} ms = "
        f"{rate_one:.2f} state-steps/s; swaps: mesh {r0['accepts']} of "
        f"{r0['attempts']}, one process {one['accepts']} of "
        f"{one['attempts']}; T per row {[round(t, 1) for t in t_rows]} K")
    require("path (m3)", {
        "same_attempts": all(o["attempts"] == one["attempts"] for o in outs),
        "ranks_agree": all(o["accepts"] == r0["accepts"] for o in outs),
        "acceptance": all(0 <= a <= one["attempts"]
                          for a in (r0["accepts"], one["accepts"])),
        "temperature": all(260.0 <= t <= 340.0 for t in t_rows),
    })
    return {"state_steps_per_s": rate, "one_process_state_steps_per_s":
            rate_one}



# --- path (n): what the port ran on the CPU only, or raised on -------------

# (n1)'s cell shape: H / V^(1/3) held to this after the volume moves (the
# float32 box scaled by s at each accepted move rounds by ~6e-8 a move)
N1_SHAPE_TOL = 1e-6
# (n4): BASELINE config 1, argon NVE; its conserved-energy drift bound
N4_DRIFT = 0.1  # kJ/mol/atom/ps


def npt_water_in_cell(dev, eq100):
    """Path (f)'s system (npt_water, RF) with the equilibrated state's
    molecules' centres mapped into the sheared cell shear_cell(L) of the
    cube's edge L (water_in_cell: the far and near cell lists built for
    the cell), capacities retuned there; (respa, x, v, cell) on the card,
    float32."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    f32 = torch.float32
    ex, ev, ebox = eq100
    box_l = float(ebox[0])
    cell = shear_cell(box_l)
    system, _, _ = water_system(n_molecules=NPT_N_MOLECULES, neighbors=False,
                                dtype=f32, device=dev)
    system, xs = water_in_cell(system, torch.as_tensor(ex), box_l, cell,
                               float(system.forces[0].r_cut), dev)
    system = system.add_force(amm.MonteCarloBarostat(
        pressure=1.0, temperature=300.0, frequency=NPT_FREQUENCY))
    respa = amm.RESPASystem(system, rcut_in=0.6, rswitch_in=0.5)
    respa = retune_neighbor_specs(respa, xs, cell)
    return (respa, torch.as_tensor(xs, dtype=f32, device=dev),
            torch.as_tensor(ev, dtype=f32, device=dev),
            torch.as_tensor(cell, dtype=f32, device=dev))


def cell_shape(box):
    """H / V^(1/3): the cell's shape, blind to its volume."""
    import torch

    b = box.double()
    return b / torch.linalg.det(b).abs() ** (1.0 / 3.0)


def phase_npt_sheared(dev, eq100, f_run, f_move_ms, settle=100, calls=12,
                      per_call=25):
    """(n1): path (f) (config 5, RF, MTS [4, 2, 1] @ 4 fs + NHC 300 K, MC
    barostat at 1 bar every 25 steps, float32) with the 100,002-atom state
    sheared into the (3, 3) cell shear_cell(L) as path (k) shears the 30k
    state: step(settle), then `calls` timed calls of step(per_call) (300
    outer steps, 12 volume moves), the temperature read after each; then
    one volume move timed alone (host clock, synchronised). Path (f)'s own
    Context (`f_run`) runs the same calls again just before, so that the
    two are timed side by side in one state of the process (path (f)'s
    phase runs long before this one). Checks path (f)'s bands (T 280-320
    K, PE/atom -14.6 ... -13.8 kJ/mol, |dV/V| < 3% over the timed steps),
    at least one acceptance and no invalid trial among the timed attempts
    (12: a move of the adaptive size is accepted about one time in four,
    so 8 would see none about one run in ten), the cell's shape
    (H / V^(1/3) to N1_SHAPE_TOL from the start) and the exact K1
    launches of the timed steps (3 an outer step + 2 a pass + 6 a move).
    `f_move_ms` is path (f)'s volume move (phase_npt_split) of this call.
    Returns the run as phase_npt does, for phase_npt_split."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.integrate import barostat as baro
    from atomsmm_tpu_torch.integrate.propagators import StepContext
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import takes_half_stencil

    loops = [4, 2, 1]
    respa, x, v, cell = npt_water_in_cell(dev, eq100)
    n = respa.num_particles
    far, near = respa.neighbors, respa.extra_neighbor_specs["near"]
    if not (takes_half_stencil(far) and takes_half_stencil(near)):
        raise RuntimeError("(n1): both sheared grids should take K1")
    ctx = amm.Context(respa, npt_integrator(loops),
                      amm.make_state(x, v=v, box=cell))
    ctx.step(settle)
    torch.cuda.synchronize()

    def timed(context, record):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(calls):
            record(context)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (calls * per_call)

    f_beside_ms = timed(f_run["ctx"], lambda c: c.step(per_call))
    box0, shape0 = ctx.state.box.clone(), cell_shape(cell)
    ext0 = {k: int(ctx.state.extra[k]) for k in (
        baro.BARO_NATT, baro.BARO_NACC, baro.BARO_NBAD)}
    pk.reset_launches()
    expected_att, runs, temps = 0, [], []

    def record(c):
        nonlocal expected_att
        a = attempts_due(c.state.step, per_call, NPT_FREQUENCY)
        c.step(per_call)
        expected_att += a
        runs.append((per_call, a, c.last_step_passes))
        temps.append(float(c.temperature()))

    ms = timed(ctx, record)
    steps = calls * per_call
    launches = dict(pk.LAUNCHES)
    expected = {"half_pair": sum(p * ((loops[1] + 1) * k + 2 + 6 * a)
                                 for k, a, p in runs),
                "cell_pair": 0, "tile_pair": 0, "block_pair": 0}
    att, acc, bad = (int(ctx.state.extra[k]) - ext0[k] for k in (
        baro.BARO_NATT, baro.BARO_NACC, baro.BARO_NBAD))
    box1 = ctx.state.box
    dv = float(torch.linalg.det(box1.double())
               / torch.linalg.det(box0.double())) - 1.0
    shape_err = float((cell_shape(box1) - shape0).abs().max())
    pe = float(ctx.get_state(lite=True).potential_energy) / n
    finite = bool(torch.isfinite(ctx.state.x).all()
                  and torch.isfinite(ctx.state.v).all())
    t_mean = sum(temps) / len(temps)
    st = ctx.state
    move_ms = wall_ms(lambda: ctx._barostat._attempt(
        StepContext(ctx.system, ctx.parameters, 0.0), st), reps=10)
    f_ms = f_run["ms_per_step"]
    log(f"path (n1) water100k ({n} atoms) RF NPT RESPA{loops}@4fs NHC 300 "
        f"K, MC barostat 1 bar every {NPT_FREQUENCY} steps, float32, in the "
        f"sheared cell (shear {SHEAR}) of edge {float(cell[0, 0]):.5f} nm: "
        f"far grid {far.grid} cap {ctx.system.neighbors.cell_capacity}, near "
        f"grid {near.grid} cap "
        f"{ctx.system.extra_neighbor_specs['near'].cell_capacity} (K1); "
        f"{steps} timed outer steps as {calls} x step({per_call}) after "
        f"step({settle}): {ms:.3f} ms per outer step by CUDA events; path "
        f"(f) RF at (3,) in the same call: {f_ms:.3f} ms in its own phase "
        f"(ratio {ms / f_ms:.3f}), {f_beside_ms:.3f} ms over the same "
        f"calls just before this run (ratio {ms / f_beside_ms:.3f}); one "
        f"volume move {move_ms:.3f} ms by the host clock (path (f) RF: "
        f"{f_move_ms:.3f} ms) on {smi_line()}; attempts {att} (expected "
        f"{expected_att}), accepted {acc}, invalid trials {bad}; dV/V "
        f"{dv:+.4%}; cell shape H/V^(1/3) max change {shape_err:.2e} (tol "
        f"{N1_SHAPE_TOL:g}); launches {launches} (expected {expected}); T "
        f"mean {t_mean:.2f} K over {len(temps)} readings; PE/atom {pe:.4f} "
        f"kJ/mol; finite {finite}")
    require("path (n1)", {
        "finite": finite, "attempts": att == expected_att,
        "accepted": acc >= 1, "invalid_trials": bad == 0,
        "launches": launches == expected,
        "temperature": 280.0 <= t_mean <= 320.0,
        "pe_per_atom": -14.6 <= pe <= -13.8, "volume": abs(dv) < 0.03,
        "shape": shape_err <= N1_SHAPE_TOL,
        "box": tuple(box1.shape) == (3, 3)})
    return {"launches": launches, "ms_per_step": ms, "move_ms": move_ms,
            "f_ms": f_ms, "f_beside_ms": f_beside_ms,
            "f_move_ms": f_move_ms, "ctx": ctx, "loops": loops}


def nearest_neighbour_table(x, box, dev):
    """The exclusion table of (n2): the 1-2/1-3/1-4 closure of water's own
    bonds (O-H) plus one O-O bond from each molecule's oxygen to its
    nearest oxygen (minimum image, found on the card), so that excluded
    pairs lie at contact distance and mostly far beyond +-14 indices;
    (N, M) int32, -1 padded, M its widest row."""
    import numpy as np
    import torch

    from atomsmm_tpu_torch.models.peptide import bond_closure

    n = len(x)
    o = torch.as_tensor(x[0::3], dtype=torch.float64, device=dev)
    b = torch.as_tensor(box, dtype=torch.float64, device=dev)
    nearest = []
    for lo in range(0, len(o), 2000):
        d = o[lo:lo + 2000, None] - o[None]
        d = d - b * torch.round(d / b)
        r2 = (d * d).sum(-1)
        r2[torch.arange(len(r2)), torch.arange(lo, lo + len(r2))] = np.inf
        nearest.append(r2.argmin(1))
    nearest = torch.cat(nearest).cpu().numpy()
    bonds = [(i, j) for i in range(0, n, 3)
             for j in (i + 1, i + 2, 3 * int(nearest[i // 3]))]
    return bond_closure(n, bonds)


def with_table(spec, table):
    """`spec` (grid, capacity, maps kept) with the exclusion table
    `table`, in the form the spec derives from it (NeighborSpec)."""
    import dataclasses

    import torch

    return dataclasses.replace(
        spec, exclusions=torch.as_tensor(table, device=spec.nbr_cells.device),
        excbits=None)


def phase_kernels_wide(dev, eq):
    """(n2), the kernels: K1 and K2 (on the full stencil of the same grid)
    against their float64 plain twins at the 30k headline's far and near
    grids (phase_kernels' RF specs) with nearest_neighbour_table's
    exclusion table (17-64 columns, the split form); then K1 and K2 timed
    there in the split form beside the same bucket's bitmask form (water's
    own exclusions)."""
    import dataclasses

    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    f64, f32 = torch.float64, torch.float32
    ex, _, ebox = eq
    table = nearest_neighbour_table(ex, ebox, dev)
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f64,
                           device="cpu")
    r = amm.RESPASystem(s, rcut_in=0.5, rswitch_in=0.4)
    r = retune_neighbor_specs(r, ex, ebox, safety=1.03)
    xe, be = torch.as_tensor(ex, dtype=f64), torch.as_tensor(ebox, dtype=f64)
    grids = {"far": (r.forces[2], r.neighbors),
             "near": (r.forces[1], r.extra_neighbor_specs["near"])}
    wide = {g: with_table(spec, table) for g, (_, spec) in grids.items()}
    far_ids = wide["far"].exclusions_far
    m, m_far = table.shape[1], far_ids.shape[1]
    log(f"path (n2) table: water30k's O-H bonds + each oxygen's bond to its "
        f"nearest oxygen, closed to 1-4: {m} columns, {m_far} of them outside "
        f"+-14 indices (form {wide['far'].exclusion_form})")
    require("path (n2) table", {
        "width": 17 <= m <= 64, "split": all(
            w.exclusion_form == "split" for w in wide.values()),
        "far_wider_than_16": m_far > 16})
    results = []
    for g, (force, _) in grids.items():
        for stencil, sp in (("", wide[g]), (", full stencil",
                                            dataclasses.replace(
                                                wide[g], half_stencil=False))):
            compare(f"water30k wide table ({m} columns) {g}{stencil}",
                    force, sp, xe, be, dev, results)
    # K1 and K2 timed on one bucket in the split form, beside the bitmask
    # form (water's own exclusions); K2 on the full stencil of the far grid
    s32, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f32,
                             device=dev)
    r32 = retune_neighbor_specs(
        amm.RESPASystem(s32, rcut_in=0.5, rswitch_in=0.4), ex, ebox,
        safety=1.03)
    x32, b32 = xe.to(dev, f32).contiguous(), be.to(dev, f32)
    timings = {}
    for g, force, spec, stencils in (
            ("far", r32.forces[2], r32.neighbors, (True, False)),
            ("near", r32.forces[1], r32.extra_neighbor_specs["near"],
             (True,))):
        forms = {"split": with_table(spec, table), "bits": spec}
        for half in stencils:
            kernel = "half_pair" if half else "cell_pair"
            for name, sp in forms.items():
                timings[(kernel, g, name)] = time_cells(
                    f"water30k {g} exclusions {name}"
                    + ("" if half else " full stencil"), force,
                    dataclasses.replace(sp, half_stencil=half), x32, b32,
                    plain_reps=1)
    return results, timings


def phase_slice_peptide(dev, steps=10):
    """(n2), the slice: peptide_in_water's chain (36 atoms, 24 excluded
    partners a backbone carbon, 1-4 pairs 20 indices apart) in about 200
    TIP3P waters, written as prmtop and inpcrd text and read by
    io.amber_system (PME at 0.5 nm: a 3^3 grid with half maps, K1 in the
    split exclusion form; rigid water), `steps` steps of VV @ 1 fs + NHC
    with velocities from one numpy draw, float64, card against CPU: x and
    v to 1e-9 relative, the per-force energies at the CPU's final
    positions to 1e-10 of the largest, K1 launched and K2 not."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.io import amber_system
    from atomsmm_tpu_torch.models.peptide import peptide_in_water
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import all_neighbor_extras, make_aux
    from atomsmm_tpu_torch.potential import split_potential_energy

    f64 = torch.float64
    text, crd, kept = peptide_in_water()
    runs = []
    for device in ("cpu", dev):
        system, xt, bt = amber_system(text, crd, method="pme", r_cut=0.5,
                                      rigid_water=True, neighbors=True,
                                      dtype=f64, device=device)
        mass = system.masses.cpu().numpy()
        v = np.random.RandomState(9).normal(size=xt.shape) * np.sqrt(
            amm.units.BOLTZMANN * 300.0 / mass)[:, None]
        dof = amm.count_degrees_of_freedom(system)
        ctx = amm.Context(system, amm.GlobalThermostatIntegrator(
            0.001, amm.NoseHooverChainPropagator(300.0, dof, 0.1)),
            amm.make_state(xt, v=torch.as_tensor(v, device=device), box=bt))
        pk.reset_launches()
        ctx.step(steps)
        launches = dict(pk.LAUNCHES)
        runs.append((system, ctx, launches))
    (cs, cpu, _), (gs, gpu, launches) = runs
    worst = max(float((a - b.cpu()).abs().max()) / float(a.abs().max())
                for a, b in ((cpu.state.x, gpu.state.x),
                             (cpu.state.v, gpu.state.v)))
    xe, be = cpu.state.x, cpu.state.box
    e_c = split_potential_energy(cs, xe, be, aux=make_aux(
        cs, all_neighbor_extras(cs, xe, be)))
    xg, bg = xe.to(dev), be.to(dev)
    e_g = split_potential_energy(gs, xg, bg, aux=make_aux(
        gs, all_neighbor_extras(gs, xg, bg)))
    scale = max(abs(float(v)) for v in e_c.values())
    e_err = max(abs(float(e_g[k]) - float(e_c[k])) for k in e_c) / scale
    spec = gs.neighbors
    m = spec.exclusions.shape[1]
    log(f"slice (n2) {gs.num_particles} atoms (a 36-atom chain, {kept} TIP3P) "
        f"from prmtop/inpcrd, PME 0.5 nm, float64, grid {spec.grid} (half "
        f"maps {spec.half_stencil}), exclusions {m} columns, "
        f"{spec.exclusions_far.shape[1]} far (form {spec.exclusion_form}), "
        f"{steps} VV+NHC steps at 1 fs card vs CPU: x, v max rel diff "
        f"{worst:.2e}; energies max rel diff {e_err:.2e} of the largest "
        f"term; launches {launches}")
    require("slice (n2)", {
        "card_equals_cpu": worst < 1e-9, "energies": e_err <= 1e-10,
        "split": spec.exclusion_form == "split" and m > 16,
        "k1": launches["half_pair"] > 0 and launches["cell_pair"] == 0})
    return {"launches": launches}


def phase_k2_past_1024(dev, eq, r_cut=2.0, steps=5):
    """(n3): the 30k state at a 2.0 nm cutoff, a 3^3 grid with half maps
    and cells of about 1,100 atoms: the spec's capacity passes K1's 1,024,
    so the sweep goes to K2 on the full stencil. K2 against its float64
    plain twin there (f64 1e-10 and 1e-9 max|F|, f32 1e-4), `steps` VV
    steps at 0.5 fs through Context in float32 with the launches counted
    (K2 only), and K2 timed there."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.neighbors import (make_neighbor_spec,
                                                 takes_half_stencil)

    f64, f32 = torch.float64, torch.float32
    ex, ev, ebox = eq
    results = []
    for dtype, device in ((f64, "cpu"), (f32, dev)):
        s, _, _ = water_system(n_molecules=len(ex) // 3, r_cut=r_cut,
                               r_switch=r_cut - 0.1, dtype=dtype,
                               device=device)
        spec = make_neighbor_spec(ebox, s.num_particles, r_cut,
                                  exclusions=s.forces[0].exclusions,
                                  occupancy_floor_from=ex, device=device)
        if not (spec.grid == (3, 3, 3) and spec.half_stencil
                and spec.cell_capacity > pk.K1_MAX_CAP
                and not takes_half_stencil(spec)):
            raise RuntimeError(f"(n3): grid {spec.grid} cap "
                               f"{spec.cell_capacity}: expected a 3^3 half-"
                               "stencil grid past K1's capacity")
        if dtype == f64:
            compare(f"water30k rc {r_cut} grid 3^3 cap {spec.cell_capacity} "
                    "(half maps, past K1's capacity)", s.forces[0], spec,
                    torch.as_tensor(ex, dtype=f64),
                    torch.as_tensor(ebox, dtype=f64), dev, results)
    system = s.with_neighbors(spec)
    dof = 3 * system.num_particles - 3
    ctx = amm.Context(system, amm.GlobalThermostatIntegrator(
        0.0005, amm.NoseHooverChainPropagator(300.0, dof, 0.1)),
        amm.make_state(torch.as_tensor(ex, dtype=f32, device=dev),
                       v=torch.as_tensor(ev, dtype=f32, device=dev),
                       box=torch.as_tensor(ebox, dtype=f32, device=dev)))
    ctx.step(1)
    pk.reset_launches()
    ctx.step(steps)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    expected = {"half_pair": 0, "cell_pair": ctx.last_step_passes
                * (steps + 1), "tile_pair": 0, "block_pair": 0}
    temp = float(ctx.temperature())
    finite = bool(torch.isfinite(ctx.state.x).all())
    log(f"path (n3) water30k rc {r_cut}: grid {spec.grid} cap "
        f"{spec.cell_capacity} (half maps; K1 takes at most "
        f"{pk.K1_MAX_CAP}), {steps} VV+NHC steps at 0.5 fs float32 on the "
        f"card: launches {launches} (expected {expected}); T {temp:.2f} K; "
        f"finite {finite}")
    require("path (n3)", {"launches": launches == expected,
                          "finite": finite})
    x32 = ctx.state.x.contiguous()
    timing = time_cells(f"water30k rc {r_cut} past K1's capacity",
                        system.forces[0], spec, x32, ctx.state.box,
                        plain_reps=1)
    return {"launches": launches, "kernel_checks": results,
            "timing": timing}


def nve_run(system, x, box, steps, melt=4, melt_steps=50):
    """Config 1's protocol (bench.py::bench_argon_nve): VV @ 2 fs,
    velocities at 120 K (seed 3), `melt` x step(melt_steps) with a rescale
    to 120 K after each, step(1); then `steps` timed steps: (ms per step
    by CUDA events, |conserved-energy drift| per atom per ps, launches
    of the timed steps)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    ctx = amm.Context(system, amm.VelocityVerletIntegrator(dt=0.002),
                      amm.make_state(x, box=box))
    ctx.set_velocities_to_temperature(120.0, seed=3)
    for _ in range(melt):
        ctx.step(melt_steps)
        ctx.set_velocities((120.0 / float(ctx.temperature())) ** 0.5
                           * ctx.state.v)
    ctx.step(1)
    e0 = float(ctx.conserved_energy())
    pk.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    ctx.step(steps)
    end.record()
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    drift = abs(float(ctx.conserved_energy()) - e0) / x.shape[0] \
        / (steps * 0.002)
    return start.elapsed_time(end) / steps, drift, launches, float(
        ctx.temperature())


def phase_dense(dev, n=4096, steps=100):
    """(n4): the dense path on the card. Config 1 (argon_system(n=4096,
    jitter 0.1, seed 1), float32) without a NeighborSpec (forces by
    autograd of the chunked O(N^2) sum) and with one (K1), nve_run each:
    the dense run launches no kernel, its drift within N4_DRIFT; then the
    goldens' argon 864 (tests/test_goldens.py) and 27 waters under
    NonbondedForce(method='nocutoff'), float64, card against CPU: each
    force's energy and the forces to 1e-9."""
    import torch

    from atomsmm_tpu_torch.models import argon_system, water_system
    from atomsmm_tpu_torch.potential import force_fn, split_potential_energy

    out = {}
    for label, neighbors in (("dense", False), ("cells", True)):
        system, x, box = argon_system(n=n, jitter=0.1, seed=1,
                                      neighbors=neighbors,
                                      dtype=torch.float32, device=dev)
        out[label] = nve_run(system, x, box, steps)
    (d_ms, d_drift, d_l, d_t), (c_ms, c_drift, c_l, c_t) = (out["dense"],
                                                          out["cells"])
    log(f"path (n4) argon {n} NVE VV @ 2 fs float32 (config 1), {steps} "
        f"timed steps after the melt: dense path {d_ms:.3f} ms/step, "
        f"|drift| {d_drift:.3e} kJ/mol/atom/ps (bound {N4_DRIFT}), T "
        f"{d_t:.2f} K, launches {d_l}; cell lists {c_ms:.3f} ms/step, "
        f"|drift| {c_drift:.3e}, T {c_t:.2f} K, launches {c_l}; dense/cells "
        f"{d_ms / c_ms:.2f} on {smi_line()}")
    checks = {"dense_no_kernel": not any(d_l.values()),
              "dense_drift": d_drift <= N4_DRIFT,
              "cells_k1": c_l["half_pair"] > 0}
    f64 = torch.float64
    for label in ("argon864", "water27 nocutoff"):
        got = []
        for device in ("cpu", dev):
            if label == "argon864":
                s, x, box = argon_system(n=864, jitter=0.1, seed=7,
                                         dtype=f64, device=device)
            else:
                s, x, box = water_system(n_molecules=27, method="nocutoff",
                                         r_cut=0.45, r_switch=0.35, seed=2,
                                         dtype=f64, device=device)
            e = split_potential_energy(s, x, box)
            got.append(({k: float(v) for k, v in e.items()},
                        force_fn(s)(x, box, {}, None)[1].cpu()))
        (e_c, f_c), (e_g, f_g) = got
        scale = max(abs(v) for v in e_c.values())
        e_err = max(abs(e_g[k] - e_c[k]) for k in e_c) / scale
        f_err = float((f_g - f_c).abs().max()) / float(f_c.abs().max())
        log(f"path (n4) {label} dense float64 card vs CPU: energies max rel "
            f"diff {e_err:.2e} of the largest term (Total "
            f"{e_c['Total']:.10g}), forces {f_err:.2e} of max|F|")
        checks[f"{label} card_equals_cpu"] = e_err <= 1e-9 and f_err <= 1e-9
    require("path (n4)", checks)
    return {"dense_ms": d_ms, "cells_ms": c_ms, "drift": d_drift,
            "cells_drift": c_drift}


# path (o)'s bands: the headline's (PERF.md section 2)
O_BANDS = {"T": (280.0, 320.0), "pe": (-14.6, -13.8), "drift": 0.1}


def block_headline(dev, eq):
    """The headline's system on block lists: water_system(n_molecules=
    10000, neighbors="blocks") in float32 on the card, split by
    RESPASystem(0.5, 0.4) (the near force on its own block list), each
    list's K retuned at the stored state (retune_block_spec through
    retune_neighbor_specs, safety 1.15)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    ex, _, ebox = eq
    system, _, _ = water_system(n_molecules=10000, neighbors="blocks",
                                dtype=torch.float32, device=dev)
    respa = amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    return retune_neighbor_specs(respa, ex, ebox)


def compare_blocks(label, force, spec, lists, x, box, results,
                   unsplit=None):
    """K4 in float64 and float32 against its float64 plain twin on the card
    at one block list (`lists` = (order, cand), the same list for both
    dtypes); with `unsplit` (the full force a damped far force was split
    from) the float32 force tolerance scales with the unsplit form's
    max|F| (see compare). Returns the twin's (energy, forces)."""
    import torch

    from atomsmm_tpu_torch.ops import blocks as blk
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f64 = torch.float64
    form = force._pair_form()
    order, cand = lists
    pp64 = {k: v.to(x.device, f64) for k, v in force._per_particle().items()}
    x64, box64 = x.to(f64), box.to(f64)
    ref = blk.block_pair_plain(x64, pp64, order, cand, spec, box64, form,
                               form.r_cut)
    e_p, f_p = ref[:, 3].sum(), ref[:-1, :3]
    f_unsplit = None
    if unsplit is not None:
        f_unsplit = float(blk.block_pair_plain(
            x64, pp64, order, cand, spec, box64, unsplit._pair_form(),
            form.r_cut)[:-1, :3].abs().max())
    for dtype in (f64, torch.float32):
        before = pk.LAUNCHES["block_pair"]
        out = blk.block_pair_cuda(
            x.to(dtype).contiguous(), {k: v.to(dtype) for k, v in
                                       pp64.items()},
            order, cand, spec, box.to(dtype), form, form.r_cut)
        torch.cuda.synchronize()
        if pk.LAUNCHES["block_pair"] != before + 1:
            raise RuntimeError(f"{label}: block_pair_cuda did not launch K4")
        results.append(("block_pair",) + judge(
            f"block_pair {label}", dtype, out[:, 3].sum(), out[:-1, :3], e_p,
            f_p, f_scale=f_unsplit if dtype != f64 else None)
            + (form_name(form),))
    return e_p, f_p


def phase_blocks(dev, eq, main, pme_run, steps=100):
    """Path (o): the 30k headline on block lists through Context.step, K4
    held against its plain twin at the run's own lists and against K1 at
    step 0 (the module docstring)."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import blocks as blk
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.potential import force_fn

    f32, f64 = torch.float32, torch.float64
    ex, ev, ebox = eq
    t0 = time.perf_counter()
    respa = block_headline(dev, eq)
    setup_s = time.perf_counter() - t0
    specs = {"far": respa.neighbors,
             "near": respa.extra_neighbor_specs["near"]}
    x = torch.as_tensor(ex, dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    lists, build_ms = {}, {}
    for label, spec in specs.items():
        order, cand, overflow = blk.build_block_lists(spec, x, box)
        if bool(overflow):
            raise RuntimeError(f"path (o) {label} list: overflow at the "
                               "state it was retuned at")
        lists[label] = (order, cand)
        build_ms[label] = time_cuda(
            lambda: blk.build_block_lists(spec, x, box), 10)
    cells = {"far": main["respa"].neighbors,
             "near": main["respa"].extra_neighbor_specs["near"]}
    cell_ms = {label: time_cuda(lambda: nb.build_cell_buckets(c, x, box), 10)
               for label, c in cells.items()}
    for label, spec in specs.items():
        per_row = (lists[label][1] >= 0).sum(dim=1).double()
        log(f"path (o) {label} block list: r_build {spec.r_build:.3f} nm, "
            f"{spec.n_blocks} blocks of {spec.block_size}, K "
            f"{spec.max_cand}, candidates per block mean "
            f"{float(per_row.mean()):.2f} max {int(per_row.max())}, "
            f"{int(per_row.sum())} block pairs "
            f"({int(per_row.sum()) * spec.block_size ** 2 / 1e6:.1f} M "
            f"slots); build_block_lists {build_ms[label]:.4f} ms beside "
            f"build_cell_buckets {cell_ms[label]:.4f} ms (CUDA events)")

    # K4 against its plain twin at (o)'s own lists, RF and damped PME
    results = []
    for method, run in (("rf", main), ("pme", pme_run)):
        far_f, near_f = run["respa"].forces[2], run["respa"].forces[1]
        for label, force in (("far", far_f), ("near", near_f)):
            compare_blocks(
                f"path (o) water30k {method} {label}", force, specs[label],
                lists[label], x, box, results,
                unsplit=far_f.full if (method, label) == ("pme", "far")
                else None)
    # step 0: the block path against K1's cell path on the same state
    main_forces = main["respa"].forces
    x64, box64 = x.double(), box.double()
    for label, force in (("far", main_forces[2]), ("near", main_forces[1])):
        form = force._pair_form()
        pp = {k: v.to(dev, f64) for k, v in force._per_particle().items()}
        e_b, f_b = blk.block_pair_energy_forces(
            form, x64, box64, pp, specs[label], *lists[label], form.r_cut)
        cspec = cells[label]
        bucket, _ = nb.build_cell_buckets(cspec, x64, box64)
        e_c, f_c = nb.cell_pair_energy_forces(form, x64, box64, pp, cspec,
                                              bucket, form.r_cut)
        judge(f"block_pair vs half_pair path (o) water30k {label} step 0",
              f64, e_b, f_b, e_c, f_c)
    aux_b = nb.make_aux(respa, nb.all_neighbor_extras(respa, x, box))
    aux_c = nb.make_aux(main["respa"],
                        nb.all_neighbor_extras(main["respa"], x, box))
    (e_b, f_b), (e_c, f_c) = (force_fn(s)(x, box, {}, a) for s, a in (
        (respa, aux_b), (main["respa"], aux_c)))
    judge("path (o) whole force at step 0 (block lists vs cell lists)",
          f32, e_b, f_b, e_c, f_c)

    # the run
    dt, loops = 0.004, [4, 2, 1]
    n = respa.num_particles
    integ = amm.MultipleTimeScaleIntegrator(
        dt, loops, temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * n - 3)
    state = amm.make_state(x, v=torch.as_tensor(ev, dtype=f32, device=dev),
                           box=box)
    ctx = amm.Context(respa, integ, state)
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
    xs, vs = ctx.state.x, ctx.state.v
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(vs).all())
    temp = float(ctx.temperature())
    pe = float(ctx.get_state(lite=True).potential_energy) / n
    drift = (e1 - e0) / (n * steps * dt)
    passes = ctx.last_step_passes
    # near loops[1] and far once an outer step, one of each for the
    # force-cache refresh of each pass
    expected = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0,
                "block_pair": passes * (3 * steps + 2)}
    ms = wall / steps * 1e3
    ratio = ms / main["ms_per_step"]
    log(f"path (o) water30k cutoff on block lists RESPA{loops}@"
        f"{dt * 1e3:.0f}fs NVT float32: set-up {setup_s:.2f} s; K far/near "
        f"{specs['far'].max_cand}/{specs['near'].max_cand} -> "
        f"{ctx.system.neighbors.max_cand}/"
        f"{ctx.system.extra_neighbor_specs['near'].max_cand}; {ms:.3f} "
        f"ms/step ({ratio:.3f}x the headline's {main['ms_per_step']:.3f} on "
        f"cell lists in this run), "
        f"{dt * 1e-3 * steps / wall * 86400.0:.3f} ns/day; launches "
        f"{launches} (expected {expected}, passes {passes}); T {temp:.2f} "
        f"K; PE/atom {pe:.4f} kJ/mol; drift {drift:.5f} kJ/mol/atom/ps; "
        f"finite {finite}")
    checks = {
        "finite": finite,
        "launches": launches == expected,
        "temperature": O_BANDS["T"][0] <= temp <= O_BANDS["T"][1],
        "pe_per_atom": O_BANDS["pe"][0] <= pe <= O_BANDS["pe"][1],
        "drift": abs(drift) <= O_BANDS["drift"],
        "shape": tuple(xs.shape) == (n, 3) and tuple(vs.shape) == (n, 3),
    }
    require("path (o)", checks)
    return {"launches": launches["block_pair"], "ms_per_step": ms,
            "ratio": ratio, "respa": ctx.system, "results": results,
            "build_ms": build_ms, "cell_build_ms": cell_ms}


def phase_block_timings(dev, blocks, timings, eq, pme_run, reps=20):
    """K4 at path (o)'s far and near lists at the stored 30k state (the
    state K1 and K3 are timed at in phase_timings), RF, and the damped far
    form: its device time (torch.profiler: K4 and the pack kernel its C
    entry point launches before it, summed), its launch wrapper, its sweep
    and its plain twin (CUDA events), and its bound over the distinct pairs
    K1 counted on the same state. A sweep must be at most 4 device
    operations, one of them K4; the slots K4 tested (its own count of the
    (home atom, 8-atom group) pairs its groups' reach left, 8 slots each)
    are logged as a share of the list's, and the home blocks whose frame
    is exact by the plain twin of K4's test (blocks.block_frames)."""
    import torch

    from atomsmm_tpu_torch.ops import blocks as blk

    f32 = torch.float32
    ex, _, ebox = eq
    x = torch.as_tensor(ex, dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    system = blocks["respa"]
    specs = {"far": system.neighbors,
             "near": system.extra_neighbor_specs["near"]}
    forces = blocks["respa"].forces
    out = {}
    for key, force, spec, k1_key in (
            ("far", forces[2], specs["far"], "far"),
            ("near", forces[1], specs["near"], "near"),
            ("pme far", pme_run["respa"].forces[2], specs["far"],
             "pme far")):
        form = force._pair_form()
        pp = {k: v.to(dev, f32).contiguous()
              for k, v in force._per_particle().items()}
        order, cand, _ = blk.build_block_lists(spec, x, box)
        args = (x, pp, order, cand, spec, box, form, form.r_cut)

        def sweep():
            return blk.block_pair_energy_forces(form, x, box, pp, spec,
                                                order, cand, form.r_cut)

        k4_ms = kernel_device_ms(sweep, "block_pair", reps)
        pack_ms = kernel_device_ms(sweep, "block_pair_pack", reps)
        k_ms = k4_ms + pack_ms
        # device operations per sweep: the span between two K4 launches
        # among 8 profiled sweeps, read again where the profiler dropped
        # events (as time_cells reads them)
        seen = [name for name, _ in device_kernels(
            sweep, reps=8, tries=10, enough=lambda ev: sum(
                "block_pair_kernel" in name for name, _ in ev) >= 3)]
        at = [i for i, name in enumerate(seen) if "block_pair_kernel" in name]
        spans = {j - i for i, j in zip(at[1:], at[2:])}
        ops_per_sweep = len(seen[at[1] + 1:at[2] + 1]) if len(at) >= 3 else 0
        require(f"path (o) {key} sweep", {
            "k4_launches_seen": len(at) >= 3,
            "one_k4_a_sweep": spans == {ops_per_sweep},
            "device_ops_at_most_4": 1 <= ops_per_sweep <= 4})
        launch_ms = time_cuda(lambda: blk.block_pair_cuda(*args), 20)
        sweep_ms = time_cuda(sweep, 20)
        p_ms = time_cuda(lambda: blk.block_pair_plain(*args), 3)
        live = int((cand >= 0).sum())
        slots = live * spec.block_size ** 2
        exact = int(blk.block_frames(x, box, order.reshape(
            -1, spec.block_size), form.r_cut)[2].sum())
        k1 = timings[("half_pair", k1_key)]
        k3 = timings.get(("tile_pair", k1_key))
        c = k1["counts"]
        rows = blk.block_pair_cuda(*args)
        b = bound(form, c["pairs"], c["near_pairs"], slots, nbytes(
            x, pp["charge"], pp["sigma"], pp["epsilon"], spec.excbits,
            order, cand, box, rows))
        n_tested = 8 * blk.k4_tested_pairs(rows)
        log(f"timing block_pair path (o) {key} list ({live} block pairs, "
            f"K {spec.max_cand}): kernel {k_ms:.4f} ms of device time (K4 "
            f"{k4_ms:.4f} + pack {pack_ms:.4f}; {ops_per_sweep:g} device "
            f"operations a sweep; {launch_ms:.4f} ms by CUDA events around "
            f"its wrapper; {slots / 1e6:.1f} M slots, {slots / k_ms / 1e6:.2f}"
            f" Gslot/s; {n_tested / 1e6:.2f} M tested by K4's count, "
            f"{n_tested / slots:.1%} of them; {exact} of {spec.n_blocks} "
            "frames exact by block_frames) "
            f"vs half_pair {k1['ms']:.4f} ms"
            + (f", tile_pair {k3['ms']:.4f} ms" if k3 else "")
            + f" on the same state; sweep {sweep_ms:.4f} ms; plain float32 "
            f"{p_ms:.4f} ms; bound {b['ms'] * 1e3:.2f} us by {b['by']} for "
            f"{c['pairs'] / 1e6:.3f} M distinct pairs (with the slot tests "
            f"{b['with_slots_ms'] * 1e3:.2f} us): {b['ms'] / k_ms:.1%} of "
            "it")
        out[("block_pair", key)] = {"ms": k_ms, "launch_ms": launch_ms,
                                    "plain_ms": p_ms, "sweep_ms": sweep_ms,
                                    "slots": slots, "bound": b,
                                    "k4_ms": k4_ms, "pack_ms": pack_ms,
                                    "ops_per_sweep": ops_per_sweep}
    return out


# path (p)'s bands: the headline's (PERF.md section 2)
P_BANDS = {"T": (280.0, 320.0), "pe": (-14.6, -13.8), "drift": 0.1}
# (p2)'s Buckingham exp-6 parameters of q-SPC/Fw's oxygen and hydrogen
# (A kJ/mol, B 1/nm, C kJ nm^6/mol; the O-O repulsion of the LJ oxygen at
# 0.3 nm, its dispersion 4 eps sigma^6), each atom's drawn 1% about its
# type's from a seed, the global lambda scaling the exp-6 term, the
# Coulomb damping alpha and the core radius inside which the energy is a
# constant
BUCK_OH = {"A": (3.3e5, 1.0e3), "B": (37.0, 40.0), "C": (2.6e-3, 0.0)}
BUCK_LAMBDA, BUCK_ALPHA, BUCK_CORE = 0.6, 3.1, 0.08


def headline_user_fn(r_cut, r_switch, eps_rf):
    """The headline's pair energy (NonbondedForce, method 'cutoff': LJ
    under the quintic switch + the reaction-field Coulomb) written as a
    CustomNonbondedForce energy function of r over charge, sigma and
    epsilon, in torch operations."""
    import torch

    from atomsmm_tpu_torch.units import ONE_4PI_EPS0

    k_rf = (eps_rf - 1.0) / ((2.0 * eps_rf + 1.0) * r_cut ** 3)
    c_rf = 1.0 / r_cut + k_rf * r_cut ** 2
    inv_w = 1.0 / (r_cut - r_switch)

    def headline_pair(r, pi, pj, g):
        sig = 0.5 * (pi["sigma"] + pj["sigma"])
        eps = torch.sqrt(pi["epsilon"] * pj["epsilon"])
        t = sig / r
        t2 = t * t
        s6 = t2 * t2 * t2
        xs = torch.clamp((r - r_switch) * inv_w, 0.0, 1.0)
        sw = 1.0 + xs * xs * xs * (-10.0 + xs * (15.0 - 6.0 * xs))
        qq = pi["charge"] * pj["charge"]
        return 4.0 * eps * s6 * (s6 - 1.0) * sw \
            + ONE_4PI_EPS0 * qq * (1.0 / r + k_rf * r * r - c_rf)

    return headline_pair


def buck_user_fn():
    """Buckingham exp-6, scaled by the global lam, + the erfc-damped
    Coulomb: exp, erfc, pow, where and clamp, a form no built-in has."""
    import torch

    from atomsmm_tpu_torch.units import ONE_4PI_EPS0

    def buckingham_pair(r, pi, pj, g):
        a = torch.sqrt(pi["A"] * pj["A"])
        b = 0.5 * (pi["B"] + pj["B"])
        c = torch.sqrt(pi["C"] * pj["C"])
        rr = torch.clamp(r, min=BUCK_CORE)
        u6 = a * torch.exp(-b * rr) - c / torch.pow(rr, 6.0)
        u6 = torch.where(r < BUCK_CORE, 0.0 * u6 + 50.0, u6)
        return g["lam"] * u6 + ONE_4PI_EPS0 * pi["q"] * pj["q"] * torch.erfc(
            BUCK_ALPHA * r) / r

    return buckingham_pair


def buck_force(system, dev, exclusions=None, seed=13):
    """A CustomNonbondedForce of buck_user_fn over `system`'s waters (O, H,
    H a molecule): each atom's A, B, C drawn 1% about its type's
    (BUCK_OH, numpy seed), its charge as q, float32 on `dev`, cut at the
    system's nonbonded cutoff."""
    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm

    nbf = system.forces[0]
    n = nbf.charge.shape[0]
    rng = np.random.default_rng(seed)
    is_h = (np.arange(n) % 3) != 0
    pp = {}
    for k, (o, h) in BUCK_OH.items():
        v = np.where(is_h, h, o) * (1.0 + 0.01 * rng.standard_normal(n))
        pp[k] = torch.as_tensor(v, dtype=torch.float32, device=dev)
    pp["q"] = nbf.charge.to(dev, torch.float32)
    return amm.CustomNonbondedForce(
        per_particle=pp, energy_function=buck_user_fn(),
        exclusions=nbf.exclusions if exclusions is None else exclusions,
        r_cut=float(nbf.r_cut))


def user_flag_forms(force, globals, dev, flags=("energy", "virial",
                                                 "dlambda")):
    """`force`'s user form in float32 under each of `flags`: as it is,
    with the virial flag, and with its tangent seeded on the global 'lam'
    (dU/dlambda)."""
    import dataclasses

    import torch

    from atomsmm_tpu_torch.ops.pairtrace import user_form

    low = force.lowered(torch.float32, globals, dev)
    form = user_form(low, globals, force.r_cut, dev)
    extra = {"energy": {}, "virial": {"virial": True},
             "dlambda": {"dconst": low.constant_index("lam")}}
    return {flag: dataclasses.replace(form, **extra[flag]) for flag in flags}


def user_headline(dev, eq, builtin=False):
    """(p1)'s system: the 30k water of the headline (water_system(10000,
    neighbors=True), float32) with its NonbondedForce written as a
    CustomNonbondedForce of headline_user_fn over charge, sigma and
    epsilon with the same exclusions and 0.9 nm cutoff (with `builtin` the
    NonbondedForce itself), in force group 1, the bonded terms in group 0;
    the cell capacity retuned at the stored state (safety 1.03) on the
    7^3 far grid, which K1 sweeps."""
    import dataclasses

    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops.neighbors import retune_neighbor_specs

    ex, _, ebox = eq
    system, _, _ = water_system(n_molecules=len(ex) // 3, neighbors=True,
                                dtype=torch.float32, device=dev)
    nbf = system.forces[0]
    if builtin:
        pair = dataclasses.replace(nbf, group=1)
    else:
        pair = amm.CustomNonbondedForce(
            per_particle={"charge": nbf.charge, "sigma": nbf.sigma,
                          "epsilon": nbf.epsilon},
            exclusions=nbf.exclusions, r_cut=float(nbf.r_cut), group=1,
            energy_function=headline_user_fn(float(nbf.r_cut),
                                             float(nbf.r_switch),
                                             float(nbf.eps_rf)))
    system = dataclasses.replace(system, forces=(pair,) + tuple(
        dataclasses.replace(f, group=0) for f in system.forces[1:]))
    return retune_neighbor_specs(system, ex, ebox, safety=1.03)


def p1_run(dev, eq, system, steps):
    """step(1), then a timed step(steps) of `system` under (p1)'s
    integrator (MTS [4, 1] @ 2 fs + NHC 300 K: the pair force at 2 fs, the
    bonded terms at 0.5 fs) from the stored state, float32; the launches
    (LAUNCHES and USER_LAUNCHES) and the callable cell sweep's calls
    counted from zero over the timed run."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import forces as forces_mod
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f32 = torch.float32
    ex, ev, ebox = eq
    dt, loops = 0.002, [4, 1]
    n = system.num_particles
    integ = amm.MultipleTimeScaleIntegrator(
        dt, loops, temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * n - 3)
    state = amm.make_state(torch.as_tensor(ex, dtype=f32, device=dev),
                           v=torch.as_tensor(ev, dtype=f32, device=dev),
                           box=torch.as_tensor(ebox, dtype=f32, device=dev))
    ctx = amm.Context(system, integ, state)
    ctx.step(1)
    torch.cuda.synchronize()
    e0 = float(ctx.conserved_energy())
    fn_calls = [0]
    callable_sweep = forces_mod.cell_pair_energy_fn

    def counted(*args, **kw):
        fn_calls[0] += 1
        return callable_sweep(*args, **kw)

    forces_mod.cell_pair_energy_fn = counted
    try:
        pk.reset_launches()
        t0 = time.perf_counter()
        ctx.step(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**pk.LAUNCHES,
                    **{f"{k}_user": v for k, v in pk.USER_LAUNCHES.items()}}
    finally:
        forces_mod.cell_pair_energy_fn = callable_sweep
    e1 = float(ctx.conserved_energy())
    xs, vs = ctx.state.x, ctx.state.v
    return {"ms": wall / steps * 1e3, "launches": launches,
            "fn_calls": fn_calls[0], "passes": ctx.last_step_passes,
            "finite": bool(torch.isfinite(xs).all()
                           and torch.isfinite(vs).all()),
            "T": float(ctx.temperature()),
            "pe": float(ctx.get_state(lite=True).potential_energy) / n,
            "drift": (e1 - e0) / (n * steps * dt), "dt": dt, "loops": loops,
            "shape": tuple(xs.shape) == (n, 3) and tuple(vs.shape) == (n, 3)}


def phase_user_forms(dev, eq, main, small, steps=100):
    """Path (p): CustomNonbondedForce on K1 and K2 (the module docstring).
    (p1) the headline's pair force as a user function through Context;
    (p2) the Buckingham + erfc function with a global lambda at the 30k
    far grid (K1: both exclusion forms and a sheared cell) and at path
    (a)'s water-700 2^3 grid (K2: both exclusion forms), each kernel
    against its plain twin in every flag, and a few evaluations through
    the force's entry points with the launches counted."""
    import dataclasses

    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch import _build
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    f32, f64 = torch.float32, torch.float64
    ex, ev, ebox = eq
    x = torch.as_tensor(ex, dtype=f32, device=dev).contiguous()
    box = torch.as_tensor(ebox, dtype=f32, device=dev)
    g_buck = {"lam": torch.tensor(BUCK_LAMBDA, dtype=f32, device=dev)}

    # the systems and forces of (p1) and (p2)
    usys = user_headline(dev, eq)
    user = usys.forces[0]
    spec = usys.neighbors
    if not nb.takes_half_stencil(spec):
        raise RuntimeError("path (p1): expected K1's half-stencil grid")
    water30k, _, _ = water_system(n_molecules=len(ex) // 3, dtype=f32,
                                  device=dev)
    buck30k = buck_force(water30k, dev)
    table30k = nearest_neighbour_table(ex, ebox, dev)
    cell = shear_cell(float(ebox[0]))
    sheared, xs_cell = water_in_cell(water30k, x, float(ebox[0]), cell, 0.9,
                                     dev)
    small_x = small["state"].x.detach().contiguous()
    small_box = small["state"].box.detach()
    small_spec = small["respa"].neighbors
    if small_spec.half_stencil:
        raise RuntimeError("path (p2): expected path (a)'s full-stencil "
                           "far grid")
    water700, _, _ = water_system(n_molecules=small_x.shape[0] // 3,
                                  dtype=f32, device=dev)
    buck700 = buck_force(water700, dev)
    table700 = nearest_neighbour_table(small_x.double().cpu().numpy(),
                                       small_box.double().cpu().numpy(), dev)

    # the cold build of every user-form library (p) runs, one nvcc each,
    # all at once: (kernel, header, exclusion form, image)
    jobs = []
    for dtype in (f32, f64):
        head = user.lowered(dtype, {}, dev).cuda_source()
        buck = buck30k.lowered(dtype, g_buck, dev).cuda_source()
        jobs += [("half_pair", head, 0, 0), ("half_pair", buck, 0, 0),
                 ("half_pair", buck, 1, 0), ("half_pair", buck, 0, 1),
                 ("cell_pair", buck, 0, 0), ("cell_pair", buck, 1, 0)]
    t0 = time.perf_counter()
    paths = _build.build_user(jobs)
    build_s = time.perf_counter() - t0
    log(f"path (p) build: {build_s:.2f} s for {len(paths)} user-form "
        f"libraries, one nvcc each, all at once (cold: "
        f"{', '.join(p.name for p in paths)})")

    # (p1) at step 0: the user form's kernel against its plain twin, and
    # K1 on the user form against K1 on the built-in form at one bucket
    results = []
    compare("user path (p1) water30k headline fn", user, spec, x, box, dev,
            results, form=user_flag_forms(user, {}, dev)["energy"])
    bucket, _ = nb.build_cell_buckets(spec, x, box)
    nbf = water30k.forces[0]
    pp = {k: v.to(dev, f32) for k, v in user.per_particle.items()}
    e_u, f_u = nb.cell_pair_energy_forces(
        user._kernel_form({}, x, {"spec": spec, "bucket": bucket}), x, box,
        pp, spec, bucket, user.r_cut)
    e_b, f_b = nb.cell_pair_energy_forces(nbf._pair_form(), x, box,
                                          nbf._per_particle(), spec, bucket,
                                          nbf.r_cut)
    results.append(("half_pair",) + judge(
        "half_pair path (p1) user form vs the built-in lj_sw_rf form at "
        "one bucket", f32, e_u, f_u, e_b, f_b) + ("user_vs_builtin",))

    # (p1) the run, then the same run with the built-in NonbondedForce
    run = p1_run(dev, eq, usys, steps)
    passes = run["passes"]
    # the pair force once an outer step, once more for the force-cache
    # refresh of each pass; the bonded terms take no kernel
    expected = {"half_pair": 0, "cell_pair": 0, "tile_pair": 0,
                "block_pair": 0, "half_pair_user": passes * (steps + 1),
                "cell_pair_user": 0, "tile_pair_user": 0}
    builtin = p1_run(dev, eq, user_headline(dev, eq, builtin=True), steps)
    expected_b = {**expected, "half_pair": passes * (steps + 1),
                  "half_pair_user": 0}
    # one evaluation by the parent's route: the callable sweep, forces by
    # autograd, at the stored state
    pair_fn = user._pair_fn({})

    def parent():
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            e = nb.cell_pair_energy_fn(pair_fn, xx, box, pp, spec, bucket,
                                       user.r_cut)
            (grad,) = torch.autograd.grad(e, xx)
        return e.detach(), -grad

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e_parent, f_parent = parent()
    torch.cuda.synchronize()
    parent_ms = (time.perf_counter() - t0) * 1e3
    judge("path (p1) parent's route (callable sweep, autograd) vs the user "
          "form on K1", f32, e_parent, f_parent, e_u, f_u)
    del e_parent, f_parent
    torch.cuda.empty_cache()
    log(f"path (p1) water30k headline pair force as CustomNonbondedForce on "
        f"K1 (grid {spec.grid} cap {spec.cell_capacity}) MTS"
        f"{run['loops']}@{run['dt'] * 1e3:.0f}fs NVT float32: "
        f"{run['ms']:.3f} ms/step beside {builtin['ms']:.3f} with the "
        f"built-in NonbondedForce under the same integrator "
        f"({run['ms'] / builtin['ms']:.3f}x) and the headline's "
        f"{main['ms_per_step']:.3f} (RESPA [4, 2, 1] @ 4 fs); one "
        f"evaluation by the parent's route (callable sweep + autograd) "
        f"{parent_ms:.1f} ms; launches {run['launches']} (expected "
        f"{expected}, passes {passes}); built-in run launches "
        f"{builtin['launches']}; callable sweep calls {run['fn_calls']}; "
        f"T {run['T']:.2f} K; PE/atom {run['pe']:.4f} kJ/mol; drift "
        f"{run['drift']:.5f} kJ/mol/atom/ps; finite {run['finite']}; "
        f"built-in run T {builtin['T']:.2f} K, PE/atom "
        f"{builtin['pe']:.4f}, drift {builtin['drift']:.5f}")
    require("path (p1)", {
        "finite": run["finite"] and run["shape"],
        "launches": run["launches"] == expected,
        "builtin_launches": builtin["launches"] == expected_b,
        "callable_sweep": run["fn_calls"] == 0,
        "temperature": P_BANDS["T"][0] <= run["T"] <= P_BANDS["T"][1],
        "pe_per_atom": P_BANDS["pe"][0] <= run["pe"] <= P_BANDS["pe"][1],
        "drift": abs(run["drift"]) <= P_BANDS["drift"],
    })

    # (p2): the Buckingham form against its plain twin in every flag
    spec30k = spec
    cell_spec = sheared.neighbors
    cases = [
        ("water30k buckingham bits", buck30k, spec30k, x, box),
        ("water30k buckingham split", dataclasses.replace(
            buck30k, exclusions=torch.as_tensor(table30k, device=dev)),
         with_table(spec30k, table30k), x, box),
        ("water30k buckingham sheared", buck30k, cell_spec,
         torch.as_tensor(xs_cell, dtype=f32, device=dev),
         torch.as_tensor(cell, dtype=f32, device=dev)),
        ("water700 buckingham bits", buck700, small_spec, small_x,
         small_box),
        ("water700 buckingham split", dataclasses.replace(
            buck700, exclusions=torch.as_tensor(table700, device=dev)),
         with_table(small_spec, table700), small_x, small_box),
    ]
    for label, force, spec_, x_, box_ in cases:
        for flag, form in user_flag_forms(force, g_buck, dev).items():
            tag = "" if flag == "energy" else f" {flag}"
            compare(f"user path (p2) {label}{tag}", force, spec_, x_, box_,
                    dev, results, terms_scale=flag == "dlambda", form=form,
                    globals=g_buck)
    # a few evaluations through the force's entry points, counted: energy,
    # energy and forces, the virial and dU/dlambda, at the 30k far grid
    # (K1) and on path (a)'s far grid (K2)
    pk.reset_launches()
    for force, spec_, x_, box_ in ((buck30k, spec30k, x, box),
                                   (buck700, small_spec, small_x,
                                    small_box)):
        s = amm.System(masses=torch.ones(x_.shape[0], dtype=f32, device=dev),
                       forces=(force,), default_box=box_).with_neighbors(
            spec_)
        aux = nb.make_aux(s, nb.all_neighbor_extras(s, x_, box_))
        e = force.energy(x_, box_, g_buck, aux)
        e2, f2 = force.energy_and_forces(x_, box_, g_buck, aux)
        w, _ = force.virial(x_, box_, g_buck, aux)
        dl = force.denergy_dlambda(x_, box_, g_buck, "lam", aux)
        if not all(bool(torch.isfinite(t).all()) for t in (e, e2, f2, w, dl)):
            raise RuntimeError("path (p2): a non-finite evaluation")
    torch.cuda.synchronize()
    p2_launches = dict(pk.USER_LAUNCHES)
    require("path (p2)", {"launches": p2_launches == {"half_pair": 4,
                                                      "cell_pair": 4,
                                                      "tile_pair": 0},
                          "builtin": pk.LAUNCHES == {k: 0 for k in
                                                     pk.LAUNCHES}})
    log(f"path (p2) launches through the force's entry points: "
        f"{p2_launches} (4 each: energy, energy and forces, virial, "
        f"dU/dlambda)")

    launches = {"half_pair": run["launches"]["half_pair_user"]
                + p2_launches["half_pair"],
                "cell_pair": p2_launches["cell_pair"]}
    err = {k: max(r[4] for r in results if r[0] == k and r[2] == "float32"
                  and r[6].startswith("user"))
           for k in ("half_pair", "cell_pair")}
    return {"build_s": build_s, "run": run, "builtin": builtin,
            "parent_ms": parent_ms, "launches": launches,
            "run_launches": run["launches"], "p2_launches": p2_launches,
            "max_abs_err": err, "results": results,
            "shapes": {"k1": (user, spec, x, box, {}),
                       "k1_buck": (buck30k, spec, x, box, g_buck),
                       "k2": (buck700, small_spec, small_x, small_box,
                              g_buck),
                       "k1_builtin": (nbf, spec, x, box)}}


def phase_user_timings(dev, user):
    """Path (p)'s kernels timed with the others, after every path has run
    (time_cells): K1 on (p1)'s and (p2)'s user forms at the 30k far grid,
    beside K1's built-in lj_sw_rf form on the same positions and grid, K2
    on (p2)'s at path (a)'s far grid."""
    shapes = user["shapes"]
    labels = {"k1": "user path (p1) water30k far headline fn",
              "k1_buck": "user path (p2) water30k far buckingham",
              "k2": "user path (p2) water700 far buckingham"}
    out = {}
    for key, label in labels.items():
        force, spec, x, box, g = shapes[key]
        out[key] = time_cells(label, force, spec, x, box,
                              form=user_flag_forms(force, g, dev,
                                                   ("energy",))["energy"])
    out["k1_builtin"] = time_cells("path (p1) water30k far built-in "
                                   "lj_sw_rf", *shapes["k1_builtin"])
    log(f"path (p1) K1 on the user form "
        f"{out['k1']['ms'] / out['k1_builtin']['ms']:.3f}x the built-in "
        f"form's device time; bounds {out['k1']['bound']['ms'] * 1e3:.2f} "
        f"and {out['k1_builtin']['bound']['ms'] * 1e3:.2f} us over the same "
        f"pairs")
    return out


# --- paths (p3), (p4), (q) and the cutoff band on the card ------------------


def softcore_user_fn(r_cut, r_switch, name="lambda_vdw"):
    """The softcore force's pair energy (SoftcoreLennardJonesForce: the
    Beutler softcore LJ under the quintic switch, times the solute-solvent
    cross mask) as a CustomNonbondedForce energy function over sigma,
    epsilon and solute, its lambda read as the global `name`: in a stack,
    the row's."""
    import torch

    from atomsmm_tpu_torch.ops import pairfuncs as pf
    from atomsmm_tpu_torch.ops.switching import switch_quintic

    def softcore_pair(r, pi, pj, g):
        sig = 0.5 * (pi["sigma"] + pj["sigma"])
        eps = torch.sqrt(pi["epsilon"] * pj["epsilon"])
        u = pf.softcore_lj(r, sig, eps, g[name]) \
            * switch_quintic(r.r, r_switch, r_cut)
        cross = pi["solute"] + pj["solute"] \
            - 2.0 * pi["solute"] * pj["solute"]
        return u * cross

    softcore_pair.takes_rv = True
    return softcore_pair


def softcore_as_user(system):
    """(the SoftcoreLennardJonesForce of `system`, the CustomNonbondedForce
    of softcore_user_fn over its atoms: the same columns, exclusions,
    cutoff and group)."""
    import atomsmm_tpu_torch as amm

    soft = next(f for f in system.forces
                if type(f).__name__ == "SoftcoreLennardJonesForce")
    user = amm.CustomNonbondedForce(
        per_particle={"sigma": soft.sigma, "epsilon": soft.epsilon,
                      "solute": soft.solute.to(soft.sigma.dtype)},
        exclusions=soft.exclusions, r_cut=float(soft.r_cut), group=soft.group,
        energy_function=softcore_user_fn(float(soft.r_cut),
                                         float(soft.r_switch),
                                         soft.lambda_name))
    return soft, user


def phase_user_rows(dev, hrex, steps=5):
    """Path (p3): config 3b's 16-row stack (path (i): phenol + 1,000
    waters, 16 lambda states, at the sampler's last state and bucket) with
    its softcore force written as a CustomNonbondedForce whose function
    reads the row's lambda_vdw as a global. (1) K1 (half stencil) and K2
    (the grid's full stencil) compiled with the user form sweep the 16
    rows in one launch, the rows' lambdas a (16, C) table of constants,
    float64 and float32 against the batched float64 plain twin
    (judge_rows, to sum |e_i|), and each row against its single-row launch
    (K2 bit for bit, K1 within the tolerances); (2) the user force's rows
    against the built-in softcore force's (the same function) in float64;
    (3) an HREXSampler on the system with the user force in place of the
    softcore force runs `steps` batched steps: the user form one K1 launch
    a batched step + 1 a run, the other two pair forces two built-in K1
    launches a step + 2, no callable sweep; (4) the batched launch timed
    beside the 16 single-row launches of the same rows, by CUDA events."""
    import dataclasses

    import torch

    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops.pairtrace import UserForm
    from atomsmm_tpu_torch.parallel import HREXSampler

    run_sys = hrex["system"]
    xs, boxes, buckets, g = hrex["stack"]
    k_rows, n = xs.shape[0], xs.shape[1]
    soft, user = softcore_as_user(run_sys)
    pp = user.per_particle
    half = run_sys.neighbors
    full = dataclasses.replace(half, half_stencil=False)
    f64, f32 = torch.float64, torch.float32
    t0 = time.perf_counter()
    exc = int(half.exclusions_far is not None)
    _build_user_libs([(k, user.lowered(dt, {"lambda_vdw": 1.0}, dev), exc, 0)
                      for k in ("half_pair", "cell_pair")
                      for dt in (f64, f32)])
    build_s = time.perf_counter() - t0
    log(f"path (p3) build: 4 user-form libraries (K1, K2 x float64, "
        f"float32) {build_s:.2f} s")

    def rows_form(dtype, r=None):
        low = user.lowered(dtype, {"lambda_vdw": 1.0}, dev)
        c = low.consts_rows(g, k_rows, dev)
        return UserForm(low, c if r is None else c[r], user.r_cut)

    results, timings, deltas = [], {}, {}
    for spec, kernel, cuda_fn, plain in (
            (half, "half_pair", pk.half_pair_cuda, pk.half_pair_plain),
            (full, "cell_pair", pk.full_pair_cuda, pk.full_pair_plain)):
        pp64 = {k: v.to(f64) for k, v in pp.items()}
        before = pk.USER_LAUNCHES[kernel]
        ref = plain(cast_rows(xs, f64), pp64, buckets, spec,
                    cast_rows(boxes, f64), rows_form(f64), user.r_cut)
        for dtype in (f64, f32):
            xd, bd = cast_rows(xs, dtype), cast_rows(boxes, dtype)
            ppd = {k: v.to(dtype) for k, v in pp.items()}
            form = rows_form(dtype)
            out = cuda_fn(xd, ppd, buckets, spec, bd, form, user.r_cut)
            torch.cuda.synchronize()
            judge_rows(f"path (p3) softcore as a user function, {k_rows} "
                       f"rows", kernel, dtype, out, ref, True, results,
                       "user_rows")
            singles = [cuda_fn(xd[r].contiguous(), ppd,
                               buckets[r].contiguous(), spec,
                               bd[r].contiguous(), rows_form(dtype, r),
                               user.r_cut) for r in range(k_rows)]
            rows_vs_singles(f"{kernel} path (p3) softcore as a user "
                            "function", kernel, dtype, out, singles, True)
        deltas[kernel] = pk.USER_LAUNCHES[kernel] - before
        # the batched launch beside the rows' single-row launches (float32)
        xd, bd = cast_rows(xs, f32), cast_rows(boxes, f32)
        ppd = {k: v.to(f32) for k, v in pp.items()}
        form = rows_form(f32)
        forms = [rows_form(f32, r) for r in range(k_rows)]
        args = (xd, ppd, buckets, spec, bd, form, user.r_cut)
        k_ms = kernel_event_ms(
            lambda: cuda_fn(*args),
            lambda: (torch.zeros((k_rows, n + 1, 4), dtype=f32, device=dev),
                     pk.user_columns(form, ppd, n, f32, dev)))
        singles_ms = event_ms(lambda: [cuda_fn(
            xd[r], ppd, buckets[r], spec, bd[r], forms[r], user.r_cut)
            for r in range(k_rows)], reps=5)
        p_ms = time_cuda(lambda: plain(*args), 1)
        pairs = near = slots = 0
        for r in range(k_rows):
            c = sweep_counts(spec, form, xd[r], bd[r], ppd, buckets[r])
            pairs, near, slots = (pairs + c["pairs"], near + c["near_pairs"],
                                  slots + c["slots"])
        nbr = spec.nbr_cells_half if kernel == "half_pair" else spec.nbr_cells
        b = bound(form, pairs, near, slots, nbytes(
            xd[0], pk.user_columns(form, ppd, n, f32, dev), form.consts,
            spec.excbits, buckets[0], nbr, bd[0])
            + k_rows * (n + 1) * 4 * 4)
        log(f"timing {kernel} path (p3) {k_rows} rows grid {spec.grid} cap "
            f"{spec.cell_capacity}, the softcore user form, float32 on "
            f"{smi_line()}: one batched launch {k_ms:.4f} ms (CUDA events, "
            f"the kernel), the {k_rows} single-row launches of the same rows "
            f"{singles_ms:.4f} ms (CUDA events, their wrappers back to back; "
            f"{singles_ms / k_ms:.2f}x); plain float32 twin {p_ms:.3f} ms; "
            f"{pairs} in-range pairs over the rows; bound "
            f"{b['ms'] * 1e3:.2f} us by {b['by']} ({b['ms'] / k_ms:.1%} of "
            f"the bound)")
        timings[kernel] = {"ms": k_ms, "singles_ms": singles_ms,
                           "plain_ms": p_ms, "bound": b, "rows": k_rows}

    # the user force's rows against the built-in softcore force's, float64
    aux = {"default": {"spec": half, "bucket": buckets}}
    x64, b64 = cast_rows(xs, f64), cast_rows(boxes, f64)
    g64 = {k: v.to(f64) if isinstance(v, torch.Tensor) else v
           for k, v in g.items()}
    soft64 = dataclasses.replace(soft, sigma=soft.sigma.to(f64),
                                 epsilon=soft.epsilon.to(f64),
                                 solute=soft.solute.to(f64))
    user64 = dataclasses.replace(user, per_particle={
        k: v.to(f64) for k, v in pp.items()})
    e_u, f_u = user64.energy_and_forces_rows(x64, b64, g64, aux)
    e_s, f_s = soft64.energy_and_forces_rows(x64, b64, g64, aux)
    d_u = user64.denergy_dlambda(x64, b64, g64, "lambda_vdw", aux)
    d_s = torch.stack([soft64.denergy_dlambda(
        x64[r], b64[r], {k: v[r] if isinstance(v, torch.Tensor) else v
                         for k, v in g64.items()}, "lambda_vdw",
        {"default": {"spec": half, "bucket": buckets[r]}})
        for r in range(k_rows)])
    e_err = float(((e_u - e_s).abs() / e_s.abs().clamp(min=1.0)).max())
    f_err = float((f_u - f_s).abs().max() / f_s.abs().max())
    d_err = float(((d_u - d_s).abs() / d_s.abs().clamp(min=1.0)).max())
    log(f"path (p3) the user force's {k_rows} rows against the built-in softcore "
        f"force's, float64 on the card: energies {e_err:.2e} (rel), forces "
        f"{f_err:.2e} of max|F|, dU/dlambda_vdw {d_err:.2e} (rel; the user "
        f"form's tangent seeded on the global, one launch over the rows)")

    # the sampler's batched steps with the user force in the system
    user_sys = dataclasses.replace(run_sys, forces=tuple(
        user if f is soft else f for f in run_sys.forces))
    sampler = HREXSampler(user_sys, hrex["x0"], hrex["box"], hrex["lams"],
                          300.0, dt=0.001, seed=3,
                          neighbor_update_every=hrex["update_every"])
    pk.reset_launches()
    sampler.run(steps)
    torch.cuda.synchronize()
    run_launches = {**pk.LAUNCHES,
                    **{f"{k}_user": v for k, v in pk.USER_LAUNCHES.items()},
                    "callable_cell": pk.CALLABLE_SWEEPS["cell"]}
    expected = {"half_pair": 2 * (steps + 1), "cell_pair": 0,
                "tile_pair": 0, "block_pair": 0,
                "half_pair_user": steps + 1, "cell_pair_user": 0,
                "tile_pair_user": 0, "callable_cell": 0}
    finite = bool(torch.isfinite(sampler.positions()).all())
    log(f"path (p3) HREXSampler with the softcore force as a user function, "
        f"{k_rows} rows, {steps} batched steps: launches {run_launches} "
        f"(expected {expected}); finite {finite}")
    require("path (p3)", {
        "kernel launches": deltas == {"half_pair": 2 * (k_rows + 1),
                                      "cell_pair": 2 * (k_rows + 1)},
        "user vs built-in": e_err <= F64_RTOL and f_err <= F64_FTOL
        and d_err <= F64_RTOL,
        "run launches": run_launches == expected, "finite": finite})
    return {"results": results, "timings": timings, "build_s": build_s,
            "launches": run_launches,
            "max_abs_err": {k: max(r[4] for r in results if r[0] == k
                                   and r[2] == "float32")
                            for k in ("half_pair", "cell_pair")}}


def _build_user_libs(jobs):
    """Build the user-form libraries of `jobs` (kernel, lowered form, exc,
    tri) at once, one nvcc each (_build.build_user)."""
    from atomsmm_tpu_torch import _build

    _build.build_user([(k, low.cuda_source(), exc, tri)
                       for k, low, exc, tri in jobs])


def phase_tile_user(dev, eq):
    """Path (p4): K3 compiled with (p1)'s user function (the headline's
    switched LJ + reaction field over charge, sigma and epsilon) on the 30k
    far tile list (0.9 nm + 0.1 skin, the far list of path (b)), float64
    and float32, in its energy and virial flags, against the float64 plain
    twin on the same inputs; its energy and forces against K3's built-in
    lj_sw_rf form on the same list (the same function, float64 at the
    kernel tolerances); then both timed by CUDA events, with the bound of
    the 30k state's distinct pairs."""
    import dataclasses

    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import tilepair as tp
    from atomsmm_tpu_torch.ops.pairtrace import user_form

    f64, f32 = torch.float64, torch.float32
    s, _, _ = water_system(n_molecules=10000, neighbors=True, dtype=f64,
                           device="cpu")
    nbf = s.forces[0]
    rc = float(nbf.r_cut)
    user = amm.CustomNonbondedForce(
        per_particle={"charge": nbf.charge.to(dev),
                      "sigma": nbf.sigma.to(dev),
                      "epsilon": nbf.epsilon.to(dev)},
        exclusions=nbf.exclusions.to(dev), r_cut=rc,
        energy_function=headline_user_fn(rc, float(nbf.r_switch),
                                         float(nbf.eps_rf)))
    t0 = time.perf_counter()
    _build_user_libs([("tile_pair", user.lowered(dt, {}, dev), 0, 0)
                      for dt in (f64, f32)])
    build_s = time.perf_counter() - t0
    builtin = nbf._pair_form()
    results, out = [], {}
    pk.reset_launches()
    for dtype in (f64, f32):
        x, box, lists = tile_lists(dev, eq, dtype)
        _, spec, lst, cspec = lists["far"]
        order, hb, cb, wrap, _ = lst
        pp = {k: v.to(dtype) for k, v in user.per_particle.items()}
        for flag in ("energy", "virial"):
            kw = {"virial": True} if flag == "virial" else {}
            form = dataclasses.replace(user_form(
                user.lowered(dtype, {}, dev), {}, rc, dev), **kw)
            plain = dataclasses.replace(user_form(
                user.lowered(f64, {}, dev), {}, rc, dev), **kw)
            e_k, f_k = tp.tile_pair_energy_forces(form, x, box, pp, spec,
                                                  order, hb, cb, wrap, rc)
            fs, ms = tp._stage(spec, x.to(f64), box.to(f64),
                               {k: v.to(f64) for k, v in pp.items()},
                               spec.excbits, order,
                               names=plain.lowered.names)
            acc = tp.tile_pair_plain(fs, ms, hb, cb, wrap, box.to(f64),
                                     plain, rc)
            nbk = spec.n_blocks
            f_p = torch.zeros((x.shape[0] + 1, 3), dtype=f64, device=dev)
            f_p.index_add_(0, order.long(), acc[:nbk, :, :3].reshape(-1, 3))
            terms = float(acc[:nbk, :, 3].abs().sum())
            results.append(("tile_pair",) + judge(
                f"tile_pair (p4) water30k far list, the headline as a user "
                f"function{' (virial)' if kw else ''}", dtype, e_k, f_k,
                acc[:nbk, :, 3].sum(), f_p[:-1],
                e_scale=terms if kw else None) + (form_name(form),))
        if dtype == f64:
            pb = {k: v.to(dtype) for k, v in nbf._per_particle().items()}
            pb = {k: v.to(dev) for k, v in pb.items()}
            e_b, f_b = tp.tile_pair_energy_forces(builtin, x, box, pb, spec,
                                                  order, hb, cb, wrap, rc)
            e_u, f_u = tp.tile_pair_energy_forces(
                user_form(user.lowered(f64, {}, dev), {}, rc, dev), x, box,
                pp, spec, order, hb, cb, wrap, rc)
            judge("tile_pair (p4) user form vs built-in lj_sw_rf", f64, e_u,
                  f_u, e_b, f_b)
            continue
        # the five launches of the checks above (float64: the two flags and
        # the built-in comparison; float32: the two flags), then float32
        # timings of the user form and the built-in form on the list
        launches = dict(pk.USER_LAUNCHES)
        require("path (p4)", {"launches": launches == {
            "half_pair": 0, "cell_pair": 0, "tile_pair": 5}})
        pb = {k: v.to(dev, f32) for k, v in nbf._per_particle().items()}
        form = user_form(user.lowered(f32, {}, dev), {}, rc, dev)
        fs_u, ms_u = tp._stage(spec, x, box, pp, spec.excbits, order,
                               names=form.lowered.names)
        fs_b, ms_b = tp._stage(spec, x, box, pb, spec.excbits, order)
        u_ms = tile_kernel_ms(fs_u, ms_u, hb, cb, wrap, box, form)
        b_ms = tile_kernel_ms(fs_b, ms_b, hb, cb, wrap, box, builtin)
        p_ms = time_cuda(lambda: tp.tile_pair_plain(
            fs_u, ms_u, hb, cb, wrap, box, form, rc), 1)
        bucket, _ = nb.build_cell_buckets(cspec, x, box)
        c = sweep_counts(cspec, builtin, x, box, pb, bucket)
        live = int((hb < spec.n_blocks).sum())
        slots = live * spec.block_size * 2 * spec.block_size
        acc = tp.tile_pair_cuda(fs_u, ms_u, hb, cb, wrap, box, form, rc)
        bu = bound(form, c["pairs"], 0, slots,
                   nbytes(fs_u, ms_u, hb, cb, wrap, box, acc))
        bb = bound(builtin, c["pairs"], 0, slots,
                   nbytes(fs_b, ms_b, hb, cb, wrap, box, acc))
        log(f"timing tile_pair path (p4) water30k far list ({live} entries), "
            f"float32 on {smi_line()}: the user form {u_ms:.4f} ms, the "
            f"built-in lj_sw_rf form {b_ms:.4f} ms on the same list "
            f"({u_ms / b_ms:.3f}x; CUDA events, the kernel); plain float32 "
            f"twin {p_ms:.3f} ms; {c['pairs']} distinct pairs; bound user "
            f"{bu['ms'] * 1e3:.2f} us by {bu['by']} ({bu['ms'] / u_ms:.1%}), "
            f"built-in {bb['ms'] * 1e3:.2f} us ({bb['ms'] / b_ms:.1%})")
        out = {"ms": u_ms, "builtin_ms": b_ms, "plain_ms": p_ms,
               "bound": bu, "builtin_bound": bb}
    return {"results": results, "timing": out, "build_s": build_s,
            "launches": launches["tile_pair"],
            "max_abs_err": max(r[4] for r in results
                               if r[2] == "float32")}


def hbond_slice(device, n_res=4, seed=9):
    """(q1)'s Amber slice: the peptide-like chain in TIP3P water
    (models.peptide.peptide_in_water, read by amber_system, cutoff 0.9 nm,
    reaction field, no NeighborSpec), float64 on `device`, its
    NonbondedForce given the LJ types of its (sigma, epsilon) rows, the
    legacy 10-12 term between the water oxygen's type and the chain's
    hydrogen type (A 7500 kcal A^12, B 2300 kcal A^10), and one chain
    hydrogen its own sigma, so that atoms of one type differ: no type-pair
    table holds the term, and the force runs on the dense path. The
    positions are the file's moved by a draw of 0.005 nm
    (numpy.random.default_rng(seed))."""
    import dataclasses

    import numpy as np
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models.peptide import peptide_in_water

    prm, crd, _ = peptide_in_water(n_res)
    s, x, box = amm.amber_system(prm, crd, method="cutoff", r_cut=0.9,
                                 dtype=torch.float64, device=device)
    k = next(i for i, f in enumerate(s.forces)
             if type(f).__name__ == "NonbondedForce")
    nbf = s.forces[k]
    rows = np.stack([nbf.sigma.cpu().numpy(), nbf.epsilon.cpu().numpy()], 1)
    _, types = np.unique(rows, axis=0, return_inverse=True)
    types = types.reshape(-1).astype(np.int32)
    n_types = int(types.max()) + 1
    o_type = int(types[int(np.argmax(rows[:, 1]))])      # the water oxygen
    h_type = int(types[int(np.argmin(np.where(rows[:, 1] > 0, rows[:, 1],
                                              np.inf)))])
    a = np.zeros((n_types, n_types))
    b = np.zeros((n_types, n_types))
    kcal = 4.184
    for i, j in ((o_type, h_type), (h_type, o_type)):
        a[i, j], b[i, j] = 7500.0 * kcal * 1e-12, 2300.0 * kcal * 1e-10
    sig = nbf.sigma.clone()
    sig[int(np.nonzero(types == h_type)[0][0])] *= 1.1
    nbf = dataclasses.replace(
        nbf, lj_type=torch.as_tensor(types, device=device), sigma=sig,
        pair_a1012=torch.as_tensor(a, device=device),
        pair_b1012=torch.as_tensor(b, device=device))
    if not nbf._dense_only:
        raise RuntimeError("(q1): the slice's 10-12 term found a table")
    s = dataclasses.replace(s, forces=s.forces[:k] + (nbf,)
                            + s.forces[k + 1:])
    noise = np.random.default_rng(seed).normal(scale=0.005,
                                               size=tuple(x.shape))
    return s, x + torch.as_tensor(noise, device=device), box


def phase_dense_hbond(dev, steps=5):
    """(q1): the 10-12 term with atoms of one LJ type that differ, on the
    card's dense path (hbond_slice): the force's energy and forces, card
    against CPU in float64 (energy 1e-10, forces 1e-9 x max|F|), then
    `steps` velocity-Verlet steps of the whole slice at 1 fs, card against
    CPU (x and v to 1e-9 of their largest entry), with no pair-kernel
    launch."""
    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    out = []
    pk.reset_launches()
    for device in ("cpu", dev):
        s, x, box = hbond_slice(device)
        nbf = next(f for f in s.forces
                   if type(f).__name__ == "NonbondedForce")
        e, f = nbf.energy_and_forces(x, box, {})
        ctx = amm.Context(s, amm.VelocityVerletIntegrator(0.001),
                          amm.make_state(x, box=box))
        ctx.set_velocities(torch.as_tensor(
            __import__("numpy").random.default_rng(4).normal(
                scale=0.3, size=tuple(x.shape)), dtype=x.dtype,
            device=x.device))
        ctx.step(steps)
        out.append((e, f, ctx.state.x, ctx.state.v))
    torch.cuda.synchronize()
    (e_c, f_c, x_c, v_c), (e_g, f_g, x_g, v_g) = out
    judge(f"dense (q1) Amber slice, the 10-12 term over mixed types, card "
          f"vs CPU ({x_c.shape[0]} atoms)", torch.float64, e_g, f_g.cpu(),
          e_c, f_c)
    dx = float((x_g.cpu() - x_c).abs().max()) / float(x_c.abs().max())
    dv = float((v_g.cpu() - v_c).abs().max()) / float(v_c.abs().max())
    launches = dict(pk.LAUNCHES)
    log(f"path (q1) {steps} VV steps of the slice on the dense path, card "
        f"vs CPU: x {dx:.2e}, v {dv:.2e} of the largest entry; pair-kernel "
        f"launches {launches}")
    require("path (q1)", {"trajectory": dx <= 1e-9 and dv <= 1e-9,
                          "no kernel": launches == {k: 0 for k in launches}})
    return {"atoms": x_c.shape[0], "x_err": dx, "v_err": dv}


def phase_callable(dev, n_water=216, r_cut=0.6):
    """(q2): a user function of torch.atan on a CUDA cell list lowers and
    runs on the kernels (a user launch, no callable sweep), card against
    CPU; a function that does not lower (torch.sign) runs on the callable
    cell sweep on the card, counted in CALLABLE_SWEEPS with one warning
    and no kernel launch, card against CPU: water 216 at 0.6 nm (a grid
    too small for half maps, K2), float64, energy 1e-10 and forces
    1e-9 x max|F|."""
    import warnings

    import torch

    import atomsmm_tpu_torch as amm
    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk

    def atan_pair(r, pi, pj, g):
        return pi["q"] * pj["q"] * torch.atan(0.5 / r) / r

    def sign_pair(r, pi, pj, g):
        return torch.sign(r) * pi["q"] * pj["q"] / r

    report = {}
    for name, fn in (("atan", atan_pair), ("sign", sign_pair)):
        out = []
        for device in ("cpu", dev):
            s, x, box = water_system(n_molecules=n_water, r_cut=r_cut,
                                     r_switch=r_cut - 0.1, seed=5,
                                     dtype=torch.float64, device=device)
            nbf = s.forces[0]
            force = amm.CustomNonbondedForce(
                per_particle={"q": nbf.charge}, exclusions=nbf.exclusions,
                energy_function=fn, r_cut=r_cut)
            spec = nb.make_neighbor_spec(box, x.shape[0], r_cut,
                                         exclusions=nbf.exclusions,
                                         device=device)
            sysd = amm.System(masses=s.masses, forces=(force,),
                              default_box=box).with_neighbors(spec)
            aux = nb.make_aux(sysd, nb.all_neighbor_extras(sysd, x, box))
            pk.reset_launches()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                e, f = force.energy_and_forces(x, box, {}, aux)
                force.energy(x, box, {}, aux)
            if device != "cpu":
                torch.cuda.synchronize()
                counts = {"user": dict(pk.USER_LAUNCHES),
                          "builtin": dict(pk.LAUNCHES),
                          "callable": pk.CALLABLE_SWEEPS["cell"],
                          "warnings": sum("callable cell sweep" in str(w.message)
                                          for w in caught)}
            out.append((e, f))
        (e_c, f_c), (e_g, f_g) = out
        judge(f"path (q2) {name} function card vs CPU", torch.float64, e_g,
              f_g.cpu(), e_c, f_c)
        log(f"path (q2) the {name} function on the card's cell list: user "
            f"launches {counts['user']}, built-in {counts['builtin']}, "
            f"callable sweeps {counts['callable']}, warnings "
            f"{counts['warnings']}")
        if name == "atan":
            ok = (sum(counts["user"].values()) == 2
                  and counts["callable"] == 0 and counts["warnings"] == 0)
        else:
            ok = (counts["callable"] == 2 and counts["warnings"] == 1
                  and not any(counts["user"].values())
                  and not any(counts["builtin"].values()))
        require(f"path (q2) {name}", {"route": ok})
        report[name] = counts
    return report


def band_water(n_molecules, seed=7, n_pairs=4):
    """(force, x, box, pairs) for the cutoff-band checks: water at 0.9 nm
    (reaction field, float64 on the CPU), each molecule moved off its
    lattice site by a draw of up to 0.03 nm a component
    (numpy.random.default_rng(seed)), the coordinates wrapped into the box
    and rounded to float32; n_pairs O-O pairs of other molecules at
    float64 distances between 0.85 and 0.89 nm."""
    import numpy as np
    import torch

    from atomsmm_tpu_torch.models import water_system
    from atomsmm_tpu_torch.ops.pbc import minimum_image

    f32, f64 = torch.float32, torch.float64
    system, x, box = water_system(n_molecules=n_molecules, r_cut=0.9,
                                  r_switch=0.8, method="cutoff", seed=5,
                                  dtype=f64, device="cpu")
    m = n_molecules
    shift = np.random.default_rng(seed).uniform(-0.03, 0.03, (m, 1, 3))
    x = (x.reshape(m, 3, 3) + torch.as_tensor(shift)).reshape(-1, 3)
    box = box.to(f32).to(f64)
    x = (x - box * torch.floor(x / box)).to(f32).to(f64)
    o = torch.arange(0, x.shape[0], 3)
    d = minimum_image(x[o][:, None] - x[o][None], box).norm(dim=-1)
    i, j = torch.nonzero(torch.triu((d > 0.85) & (d < 0.89), 1),
                         as_tuple=True)
    pairs = [float(d[a, b]) for a, b in zip(i[:n_pairs], j[:n_pairs])]
    return system.forces[0], x, box, pairs


def phase_cutoff_band(dev):
    """K1, K2, K3 and K4 in float32 at mask cutoffs 1e-12 inside and
    outside the float64 distance of an O-O pair (band_water: 4 pairs, 8
    cutoffs each kernel), against their float64 plain twins on the same
    float32 inputs at the float32 tolerances: the kernels decide a hit
    within CUT_BAND of r_c^2 in float64, as the reference does. Water 800
    takes K1's half stencil; water 400 K2's full one, the tile list (K3)
    and the block list (K4)."""
    import dataclasses

    import torch

    from atomsmm_tpu_torch.ops import blocks as tb
    from atomsmm_tpu_torch.ops import neighbors as nb
    from atomsmm_tpu_torch.ops import pair_kernel as pk
    from atomsmm_tpu_torch.ops import tilepair as tp

    f32, f64 = torch.float32, torch.float64
    worst = {}
    for kernel, m in (("half_pair", 800), ("cell_pair", 400),
                      ("tile_pair", 400), ("block_pair", 400)):
        force, x, box, pairs = band_water(m)
        form = force._pair_form()
        pp = {k: v.to(dev) for k, v in force._per_particle().items()}
        x32, b32 = x.to(dev, f32), box.to(dev, f32)
        pp32 = {k: v.to(f32) for k, v in pp.items()}
        x64, b64 = x32.double(), b32.double()
        pp64 = {k: v.to(f64) for k, v in pp32.items()}

        def summed(out):
            return out[:, 3].sum(), out[:-1, :3]

        if kernel in ("half_pair", "cell_pair"):
            spec = nb.make_neighbor_spec(box, x.shape[0], 0.9,
                                         exclusions=force.exclusions,
                                         occupancy_floor_from=x, device=dev)
            if kernel == "cell_pair":
                spec = dataclasses.replace(spec, half_stencil=False)
            bucket, _ = nb.build_cell_buckets(spec, x32, b32)
            plain = (pk.half_pair_plain if kernel == "half_pair"
                     else pk.full_pair_plain)

            def run(r_cut):
                return nb.cell_pair_energy_forces(form, x32, b32, pp32, spec,
                                                  bucket, r_cut)

            def ref(r_cut):
                return summed(plain(x64, pp64, bucket, spec, b64, form,
                                    r_cut))
        elif kernel == "tile_pair":
            spec = tp.make_tilepair_spec(b32, x.shape[0], 0.9,
                                         exclusions=force.exclusions,
                                         occupancy_from=x, device=dev)
            lst = tp.build_tile_pairs(spec, x32, b32)
            fs, ms = tp._stage(spec, x64, b64, pp64, spec.excbits, lst[0])

            def run(r_cut):
                return tp.tile_pair_energy_forces(form, x32, b32, pp32, spec,
                                                  *lst[:4], r_cut)

            def ref(r_cut):
                acc = tp.tile_pair_plain(fs, ms, *lst[1:4], b64, form, r_cut)
                f = torch.zeros((x.shape[0] + 1, 3), dtype=f64, device=dev)
                f.index_add_(0, lst[0].long(),
                             acc[:spec.n_blocks, :, :3].reshape(-1, 3))
                return acc[:spec.n_blocks, :, 3].sum(), f[:-1]
        else:
            spec = to_device(tb.make_block_spec(
                box, x.shape[0], 0.9, skin=0.1, exclusions=force.exclusions,
                occupancy_from=x, device="cpu"), dev)
            order, cand, _ = tb.build_block_lists(spec, x32, b32)

            def run(r_cut):
                return tb.block_pair_energy_forces(form, x32, b32, pp32,
                                                   spec, order, cand, r_cut)

            def ref(r_cut):
                return summed(tb.block_pair_plain(x64, pp64, order, cand,
                                                  spec, b64, form, r_cut))
        err = 0.0
        for dist in pairs:
            for side in (1.0, -1.0):
                r_cut = dist * (1.0 + side * 1e-12)
                before = pk.LAUNCHES[kernel]
                e_k, f_k = run(r_cut)
                torch.cuda.synchronize()
                if pk.LAUNCHES[kernel] != before + 1:
                    raise RuntimeError(f"cutoff band: {kernel} not launched")
                e_p, f_p = ref(r_cut)
                f_err = float((f_k.double() - f_p).abs().max()) \
                    / float(f_p.abs().max())
                e_err = abs(float(e_k) - float(e_p)) / abs(float(e_p))
                err = max(err, f_err / F32_FTOL, e_err / F32_RTOL)
                if f_err > F32_FTOL or e_err > F32_RTOL:
                    raise RuntimeError(
                        f"cutoff band: {kernel} float32 at r_c {r_cut!r} "
                        f"(pair at {dist!r} nm): E rel {e_err:.2e}, forces "
                        f"{f_err:.2e} of max|F|")
        worst[kernel] = err
        log(f"cutoff band {kernel} water {m}: {2 * len(pairs)} mask cutoffs "
            f"1e-12 about an O-O pair's float64 distance, float32 against "
            f"the float64 twin: worst {err:.3f} of the float32 tolerances")
    return worst


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
    headline_rows = phase_rows_at_headline(dev, eq)
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
    phase_slice_hrex(dev)
    phase_slice_amber(dev)
    peptide = phase_slice_peptide(dev)
    main_run = phase_main(dev, eq)
    pme_run = phase_main(dev, eq, method="pme")
    small = phase_small_box(dev)
    tile_launches = phase_tile_path(dev, eq)
    blocks = phase_blocks(dev, eq, main_run, pme_run)
    user = phase_user_forms(dev, eq, main_run, small)
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
    hrex = phase_hrex(dev)
    sim_run = phase_simulation(dev, eq, main_run["ms_per_step"])
    phase_simulation_resume(dev)
    tric = phase_triclinic(dev, eq)
    amber = phase_amber(dev, eq_tip3p)
    amber_checks, amber_timings = phase_kernels_amber(dev, amber)
    m1 = phase_spatial_one_rank(dev, eq100, npt_pme["ms_per_step"])
    m2 = phase_spatial_two_ranks(dev, eq100)
    m3 = phase_hrex_mesh(dev, hrex)
    wide_checks, wide_timings = phase_kernels_wide(dev, eq)
    n3 = phase_k2_past_1024(dev, eq)
    n4 = phase_dense(dev)
    results += (blocks["results"]
                + phase_kernels_sampled(dev, alch["sampled0"])
                + npt["kernel_checks"] + npt_pme["kernel_checks"]
                + phase_kernels_rigid(dev, g1, g2, g3)
                + phase_kernels_swm4(dev, h1) + hrex["kernel_checks"]
                + alch["kernel_checks"]
                + tric["kernel_checks"] + amber_checks + m1["kernel_checks"]
                + wide_checks + n3["kernel_checks"])
    timings = phase_timings(dev, main_run, small, eq)
    timings.update(phase_pme_timings(dev, pme_run, small, eq))
    timings.update(phase_block_timings(dev, blocks, timings, eq, pme_run))
    timings.update(phase_ionic_timings(dev, ionic))
    timings.update(phase_alchemy_timings(dev, alch))
    timings.update(phase_npt_timings(dev, npt, small, eq, timings))
    timings.update(phase_rigid_timings(dev, g1, g2, g3))
    timings.update(phase_swm4_timings(dev, h1, h2))
    user["timings"] = phase_user_timings(dev, user)
    phase_step_split(dev, pme_run, "path (c)", [4, 2, 1])
    phase_step_split(dev, ionic, "path (d)", ionic["loops"])
    _, f_move = phase_npt_split(dev, npt, "path (f)")
    phase_npt_split(dev, npt_pme, "path (f) pme")
    n1 = phase_npt_sheared(dev, eq100, npt, f_move["whole attempt"])
    phase_npt_split(dev, n1, "path (n1)")
    p3 = phase_user_rows(dev, hrex)
    p4 = phase_tile_user(dev, eq)
    q1 = phase_dense_hbond(dev)
    q2 = phase_callable(dev)
    band = phase_cutoff_band(dev)
    results += p3["results"] + p4["results"]

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
        "path_i": hrex["launches"],
        "path_j": sim_run["launches"],
        "path_j_fire": sim_run["fire_launches"],
        "path_k": tric["launches"],
        "path_l": amber["launches"],
        "path_m": m1["launches"],
        "path_m2_rank0": m2["launches"],
        "path_n1": n1["launches"],
        "path_n2_slice": peptide["launches"],
        "path_n3": n3["launches"],
        "path_o": {"block_pair": blocks["launches"]},
        "path_p1": user["run_launches"],
        "path_p3": {"half_pair": p3["launches"]["half_pair_user"]},
        "path_p4": {"tile_pair": p4["launches"]},
    }

    def entry(kernel, source, replaces, launches, err, key, shape, pme_key):
        # no single PyTorch call computes a cutoff pair sweep over cell
        # buckets, a tile list or a block list: library_ms is null
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
        entry("block_pair", "block_pair.cu",
              "atomsmm_tpu/ops/blocks.py:182 (XLA, no pallas_call)",
              blocks["launches"], f32_err("block_pair", "far"),
              ("block_pair", "far"), "30k water far block list (o), 0.9 nm "
              "+ 0.1 skin, f32; launches: path (o)",
              ("block_pair", "pme far")),
    ]}
    # path (o): K4 at its near list, the run's outer step beside the
    # headline's of this run, and the list builds
    k4 = kernels["kernels"][3]
    t = timings[("block_pair", "near")]
    far_t = timings[("block_pair", "far")]
    k4.update({"k4_ms": far_t["k4_ms"], "pack_ms": far_t["pack_ms"],
               "ops_per_sweep": far_t["ops_per_sweep"],
               "near_ms": t["ms"], "near_plain_ms": t["plain_ms"],
               "near_bound_ms": t["bound"]["ms"],
               "near_bound_by": t["bound"]["by"],
               "path_o_step_ms": blocks["ms_per_step"],
               "path_o_step_over_headline": blocks["ratio"],
               "path_o_build_far_ms": blocks["build_ms"]["far"],
               "path_o_build_near_ms": blocks["build_ms"]["near"],
               "cell_build_far_ms": blocks["cell_build_ms"]["far"],
               "cell_build_near_ms": blocks["cell_build_ms"]["near"]})
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
    # paths (i) and (e): K1 and K2 over 16 rows in one launch (16 replicas
    # at (i)'s own bucket; 16 lambda states of one configuration, x and the
    # bucket shared, at (e)'s), the scaled NonbondedForce's form, float32:
    # the batched kernel, its single-row launch (K = 1), the batched plain
    # twin, the bound (16 rows' distinct pairs), and the worst row's
    # float32 error against the batched twin
    for entry_, kernel in zip(kernels["kernels"][:2],
                              ("half_pair", "cell_pair")):
        entry_["path_i_max_abs_err"] = f32_err(kernel, "path (i)")
        entry_["path_e_rows_max_abs_err"] = f32_err(kernel, "path (e)")
        entry_["rows_vs_k1_at_30k_far"] = headline_rows[kernel]["rows_vs_k1"]
        for path, t in (("i", hrex["timings"][kernel]),
                        ("e", alch["row_timings"][kernel])):
            entry_.update({
                f"rows_path_{path}_ms": t["ms"],
                f"rows_path_{path}_k1_ms": t["k1_ms"],
                f"rows_path_{path}_plain_ms": t["plain_ms"],
                f"rows_path_{path}_bound_ms": t["bound"]["ms"],
                f"rows_path_{path}_bound_by": t["bound"]["by"],
                f"rows_path_{path}_rows": t["rows"]})
    # path (j): the headline under Simulation (FIRE, then the reporting
    # run), ms per FIRE iteration and per outer step; path (k): K1 at
    # (k2)'s sheared far and near grids (the fractional minimum image),
    # float32, and K1's and K2's float32 errors against their plain twins
    # at (k2)'s and (k3)'s sheared grids
    k1.update({"path_j_fire_ms": sim_run["fire_ms"],
               "path_j_ms": sim_run["ms_per_step"]})
    for label, t in tric["timings"].items():
        k1.update({f"path_k2_{label}_ms": t["ms"],
                   f"path_k2_{label}_plain_ms": t["plain_ms"],
                   f"path_k2_{label}_bound_ms": t["bound"]["ms"],
                   f"path_k2_{label}_bound_by": t["bound"]["by"]})
    for entry_, kernel in zip(kernels["kernels"][:2],
                              ("half_pair", "cell_pair")):
        entry_["path_k_max_abs_err"] = f32_err(kernel, "sheared")
    # path (l): K1's table form at (l)'s grid (PME, NBFIX tables), float32,
    # beside its Lorentz-Berthelot form on the same bucket; K1's and K2's
    # float32 errors against their plain twins in the table forms (K2 on
    # the 10-12 variant's full stencil)
    t, t_lb = amber_timings["table"], amber_timings["lb"]
    k1.update({"path_l_ms": t["ms"], "path_l_plain_ms": t["plain_ms"],
               "path_l_bound_ms": t["bound"]["ms"],
               "path_l_bound_by": t["bound"]["by"],
               "path_l_lorentz_berthelot_ms": t_lb["ms"],
               "path_l_step_ms": amber["ms_per_step"]})
    for entry_, kernel in zip(kernels["kernels"][:2],
                              ("half_pair", "cell_pair")):
        entry_["path_l_max_abs_err"] = f32_err(kernel, "nacl30k")
    # path (m): K2 on the full stencil of (m1)'s far and near grids (config
    # 5 with PME under SpatialContext on one NCCL rank), float32, its
    # float32 error against the plain twin there, and the steps of (m1),
    # (m2) and (m3)
    k2 = kernels["kernels"][1]
    k2["path_m_max_abs_err"] = f32_err("cell_pair", "path (m1)")
    for label, t in m1["timings"].items():
        k2.update({f"path_m_{label}_ms": t["ms"],
                   f"path_m_{label}_plain_ms": t["plain_ms"],
                   f"path_m_{label}_bound_ms": t["bound"]["ms"],
                   f"path_m_{label}_bound_by": t["bound"]["by"]})
    k2.update({"path_m1_step_ms": m1["ms_per_step"],
               "path_m2_step_ms": m2["step_ms"],
               "path_m3_state_steps_per_s": m3["state_steps_per_s"]})
    # path (n): K1 and K2 in the split exclusion form (the bitmask within
    # +-14 indices, each atom's far ids scanned from global memory) at the
    # 30k headline's grids with (n2)'s table, beside the bitmask form on
    # the same bucket (K2 on the far grid's full stencil), float32, their float32 errors against the plain twins, and
    # the split form's launches in (n2)'s slice; K2 past K1's capacity
    # (n3's 2.0 nm, 3^3 grid); (n1)'s sheared NPT step and volume move
    # beside path (f)'s; (n4)'s dense argon step beside its cell list
    for entry_, kernel in zip(kernels["kernels"][:2],
                              ("half_pair", "cell_pair")):
        entry_["exclusion_forms"] = ["bits", "split"]
        entry_["path_n2_max_abs_err"] = f32_err(kernel, "wide table")
        entry_["path_n2_slice_launches"] = peptide["launches"][kernel]
        for (kern, g, form), t in wide_timings.items():
            if kern != kernel:
                continue
            tag = f"path_n2_{g}_{form}"
            entry_.update({f"{tag}_ms": t["ms"],
                           f"{tag}_plain_ms": t["plain_ms"],
                           f"{tag}_bound_ms": t["bound"]["ms"],
                           f"{tag}_bound_by": t["bound"]["by"]})
    t = n3["timing"]
    k2.update({"path_n3_ms": t["ms"], "path_n3_plain_ms": t["plain_ms"],
               "path_n3_bound_ms": t["bound"]["ms"],
               "path_n3_bound_by": t["bound"]["by"],
               "path_n3_launches": n3["launches"]["cell_pair"],
               "path_n3_max_abs_err": f32_err("cell_pair",
                                              "past K1's capacity")})
    k1.update({"path_n1_step_ms": n1["ms_per_step"],
               "path_n1_move_ms": n1["move_ms"],
               "path_n1_f_step_ms": n1["f_ms"],
               "path_n1_f_beside_step_ms": n1["f_beside_ms"],
               "path_n1_f_move_ms": n1["f_move_ms"],
               "path_n4_dense_step_ms": n4["dense_ms"],
               "path_n4_cells_step_ms": n4["cells_ms"]})
    # path (p): K1 and K2 compiled with a user pair function
    # (CustomNonbondedForce): K1 on (p1)'s headline function at the 30k far
    # grid (beside the built-in form's time there and (p1)'s run), K2 on
    # (p2)'s Buckingham function at path (a)'s far grid, float32; launches
    # on (p): K1 (p1)'s run and (p2)'s evaluations, K2 (p2)'s
    for entry_, kernel, key, shape in (
            (k1, "half_pair", "k1", "30k water far grid 7^3, the headline's "
             "switched LJ + RF as a user function, f32; launches: (p1)'s "
             "run and (p2)'s evaluations"),
            (k2, "cell_pair", "k2", "water 700 far grid 2^3 (path (a)'s "
             "state), Buckingham exp-6 + erfc with lambda, f32; launches: "
             "(p2)'s evaluations")):
        t = user["timings"][key]
        entry_["user"] = {
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"]["ms"], "bound_by": t["bound"]["by"],
            "launch_ms": t["launch_ms"], "launches": user["launches"][kernel],
            "max_abs_err": user["max_abs_err"][kernel], "shape": shape,
            "build_s": user["build_s"], "library_ms": None}
    t, tb = user["timings"]["k1_buck"], user["timings"]["k1_builtin"]
    k1["user"].update({
        "buckingham_ms": t["ms"], "buckingham_plain_ms": t["plain_ms"],
        "buckingham_bound_ms": t["bound"]["ms"],
        "builtin_ms": tb["ms"], "builtin_bound_ms": tb["bound"]["ms"],
        "path_p1_step_ms": user["run"]["ms"],
        "path_p1_builtin_step_ms": user["builtin"]["ms"],
        "parent_route_ms": user["parent_ms"]})
    # path (p3): K1 and K2 over (i)'s 16 rows on the softcore force as a
    # user function, one launch, beside the 16 single-row launches; path
    # (p4): K3 on (p1)'s user function at the 30k far list beside its
    # built-in form; (q): the dense 10-12 slice and the callable sweep;
    # the cutoff band's worst share of the float32 tolerances
    for entry_, kernel in ((k1, "half_pair"), (k2, "cell_pair")):
        t = p3["timings"][kernel]
        entry_["user_rows"] = {
            "ms": t["ms"], "singles_ms": t["singles_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"]["ms"],
            "bound_by": t["bound"]["by"], "rows": t["rows"],
            "max_abs_err": p3["max_abs_err"][kernel],
            "launches": p3["launches"][f"{kernel}_user"],
            "build_s": p3["build_s"], "library_ms": None}
    t = p4["timing"]
    kernels["kernels"][2]["user"] = {
        "ms": t["ms"], "builtin_ms": t["builtin_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound"]["ms"],
        "bound_by": t["bound"]["by"],
        "builtin_bound_ms": t["builtin_bound"]["ms"],
        "launches": p4["launches"], "max_abs_err": p4["max_abs_err"],
        "build_s": p4["build_s"], "library_ms": None}
    for entry_ in kernels["kernels"]:
        entry_["cutoff_band_worst"] = band[entry_["name"]]
    k1.update({"path_q1_atoms": q1["atoms"],
               "path_q2_callable_sweeps": q2["sign"]["callable"]})
    print(json.dumps(kernels), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
