#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dycoreplanet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. the card: torch's device name, and nvidia-smi's name + power limit;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel),
     and no spill in K1's residual-free (TRACK = false) instances, in
     K2m's (ADVECT_T = false), nor in the operands-mode instances of K1o,
     K2o and K2mo;
  3. kernel checks at 32x128x256 f32 on a seeded developed flow: K2
     (forcing), K1 (Richardson + projection head, with its four norms),
     K1u (K1's residual-free variant: the -1 sentinel, the b norms),
     K3 (faces_div), K5 (correct), and K4 (tridiag) on the momentum and
     the temperature systems of the direct Helmholtz solves, each
     against its plain PyTorch version on the card, with errors, the
     mean device time of one call over 50 back-to-back calls, and the
     roofline bound; K4 also at every n of K4_NS in three layouts, f32
     and f64, with NaN where it must not read and its operands checked
     unchanged; the whole direct Helmholtz solve's residual; K2, K1 and
     K1u (iteration pairs (1,1), (2,1), (1,3), (3,3), and (3,3) in
     groups of sweeps) at the bench shape, a shape no tile divides
     (6x20x36) and one smaller than a tile (4x8x16), in f32 and f64; the
     f64 instantiations of K3-K5 at 8x16x32; K2m (the forcing without
     the fused temperature transport, for `temperature advection =
     semi-lagrangian`) at the same three shapes, f32 and f64, and the
     resident blocks an SM of K2 and K2m; the semi-Lagrangian transport
     on the card against the same function in f64 on the CPU;
  4. main path: BoussinesqModel.run, 20 gated steps at 32x128x256 f32
     with the bench opt-ins, after 2 warm-up steps — zero escalations,
     finite fields, small post-projection divergence, K2, K1 and K5
     launched on every step, K3 and K4 never; then the same 20 steps as
     one multi_step chunk, a CUDA graph replay (after the chunk that
     captures it), against the run: its state, its rows against the
     run's records, the hand kernels one replay runs on the device
     (counted by torch.profiler; the replay calls no wrapper), one
     replay, host ms/step of both, the capture's peak memory; without
     collected diagnostics; and with one graph kept (the cap: graphs
     dropped and captured anew, the results unchanged);
  5. escalated path: one step_strong from the same state — K2, K3 and
     K5 launch once, and the result agrees with the fast step; then a
     forced miss in a multi_step chunk (a corrupted fast-diagonalization
     constant): one escalation, the chunk redone with CG from the
     original state equals a step_strong loop;
  6. the other paths at full width, each as run and as a multi_step
     graph from the same state, the two compared: `helmholtz solver =
     direct` (zero escalations, K2, K3 and K5 once and K4 twice a step,
     no K1, no operand copied for K4; one step_strong; one direct step
     against the default model's full-CG step_strong), `residual check
     interval = 4` (K1 on 5 steps, K1u on 15, residuals -1 on the
     unchecked steps) and `NSE solver interval = 2` (every other step a
     temperature substep: K1, K2 and K5 on 10 steps); then the
     semi-Lagrangian path (`temperature advection = semi-lagrangian`):
     K2m, K1 and K5 every step, the fused K2 never, graph and run
     bitwise equal, on the default path, the direct path and at `NSE
     solver interval = 2` (the transport in every step and substep);
  6b. the 2D annulus at work size (data/aqua_planet_test_2d.prm at its
     own `initial global refinement` = 8: 256 x 3072 cells, f32, its dt):
     the direct path (K4 twice a step, no shell kernel built) and, at
     the prm's own refinement 4, the default path (Richardson, no hand
     kernel) as 20 gated steps through run and as one multi_step graph,
     bitwise equal, 0 escalations, max|div u| <= 1e-4; K4 on
     AnnulusHelmholtzDirect's momentum and temperature systems as it
     passes them, from the direct run's last state (every column block
     nonzero), f32 and f64, against its plain version (no operand
     copied, no pair axis); the default path at work size through run
     (two sweeps miss the f32 gate there, as in the JAX model: CG
     repairs every miss) and its 20 fast steps as one graph replay
     against the same steps eagerly, bitwise; a forced miss repaired by
     CG; one step of each path on the card against the f64 CPU step;
  6c. the shell step on a mesh of shards, all on the one card, for the
     meshes 2 x 2 and 2 x 4 at 32x128x256 on the seeded developed flow
     (BoussinesqModel.prepare_sharded): K2o and K1o (the forcing and
     Richardson kernels in their operands halo mode) on every shard
     against their plain versions, f32 and f64, with phase 3's
     tolerances, and the shards' outputs stitched together against K2 and
     K1; K1o under its launch plan bitwise K1o on a (8, 8, 32) tile in
     every output cell, its sums within K1o's tolerances; 20 gated steps
     through run, f32: 0 escalations, max|div u| <= 1e-4, K2o and K1o A
     x B times a step and no single-device kernel, the state within 1e-4
     of max|u| of the single-device run's (phase 4), a second run bitwise
     the first; one shard's kernel, plain and bound times, and the
     launch plans of K2o (its radial chunk, blocks and the card's
     resident slots: ops/forcing.py plan_operands) and K1o (its tile,
     blocks, resident slots and shared memory: ops/richardson.py
     plan_operands); the mesh
     step's device ms, kernels and host launches a step (torch.profiler)
     beside the single-device eager step's;
  6d. the semi-Lagrangian transport and temperature substeps on the same
     meshes: K2mo (the forcing without the fused transport in its
     operands mode) on every shard against its plain version, f32 and
     f64, with phase 3's K2m tolerances, and the stitched shards against
     K2m; the stitched sharded SL transport bitwise the single-device
     one; 20 gated steps through run, f32, of the SL model at `NSE solver
     interval` = 1 and = 2 (both meshes) and of the Eulerian model at =
     2 (2 x 2): 0 escalations, max|div u| <= 1e-4, K2mo (or K2o) and K1o
     A x B times an NSE step and no other forcing kernel, the transport
     on the shards every step (SL) or substep (Eulerian), the state
     within 1e-4 of max|u| of the single-device run's (phase 6), a
     second run bitwise the first; K2mo's wrapper, plain and bound times,
     launch plan and in-step time; the SL mesh step's device ms, kernels
     and host launches a step beside the single-device SL eager step's;
  7. the CLI (with --no-output) on data/aqua_planet_shell_test_3d-classic.prm, on a copy
     of it with `set helmholtz solver = direct`, and with `--chunk 4` on
     the prm (adaptive dt: eager chunks) and on a copy with a fixed dt
     (graph chunks); on a semi-Lagrangian copy, and on one with a fixed
     dt with `--chunk 4`; on data/aqua_planet.prm and
     data/aqua_planet_test_2d.prm (5 steps each), and on the latter with
     `--chunk 4`;
  7b. the CLI with output at 32x128x256 f32 on a copy of the classic prm
     with a fixed dt of 0.0005, every file in a temp directory: (a) per
     step with checkpoints every 2, --write-mesh and --profile (max|div
     u| <= 1e-4 every step, mesh.vts, 5 .vts, a .pvd of 5, two
     checkpoints, the trace naming rich_fused, forcing_kernel and
     correct_kernel, the .vts temperature at step 4 bitwise the
     checkpoint's T); (b) a restart from (a)'s step 2, its checkpoint
     at its step 2 bitwise (a)'s at step 4; (c) --chunk 2 (graph
     chunks), its .vts at step 4 byte for byte (a)'s; (d) `solver
     diagnostics level = 3` with --profile, the Richardson trails
     printed and the trace naming forcing_kernel and correct_kernel but
     not rich_fused; (e) aqua_planet_test_2d.prm with output and
     checkpoints; then the host ms of one VTK write and one checkpoint,
     the files' sizes and the host ms/step;
  8. the FEEC personality and the coupled momentum solves (plain
     PyTorch, as jnp in the JAX package, which runs no kernel there):
     (a) the FEEC 3x3 FGMRES at 32x128x256 f32 with
     aqua_planet_shell_test_3d-feec.prm's physics, the bench's dt, from
     the seeded developed flow, 3 steps: finite, max|div u|, the outer
     iterations and residuals and the gate's verdict, host and device
     ms/step, kernels, host launches and host syncs a step, peak memory;
     (b) one FEEC 3x3 step (8x16x32) and one annulus coupled step of
     each 2x2 solve (16x192) in f64 on the card against the CPU from the
     same state: the same outer iterations, within 1e-10; (c) FEEC with
     `momentum solver = projection` at 32x128x256 f32 (the plain
     rotational forcing, K1 and K5, no forcing kernel) as 20 gated steps
     through run and as a multi_step graph, compared; (d) the annulus
     coupled path at refinement 8 (256x3072) f32: the prm's Schur GMRES,
     the block FGMRES, and the Schur path with `helmholtz solver =
     direct` (K4 once a step, on the temperature solve); (e) the shell's
     Schur 2x2 path at 16x64x128; (f) the CLI on the FEEC prm (one
     step at its own 8x16x32);
  9. the cuboid (plain PyTorch, as jnp in the JAX package, which runs
     no Pallas kernel there) and K4 in CuboidPoissonDirect's layout: (a)
     K4 on that solver's operands (the rfft2's real and imaginary parts
     as the pair axis) at 128^3, f32 and f64, against its plain version
     (phase 3's K4 tolerances), no copy, the solve's residual and its
     distance to CuboidPoissonFastDiag within the Poisson spot-check's
     tolerance, and 5 solves through the solver, one launch each; (b)
     data/aqua_planet_cube_test_3d.prm as it stands (the Schur GMRES) at
     64^3 f32, 2 steps from its IC, and (c) with `use schur complement
     solver = false` (the FEEC 3x3 FGMRES with the cuboid curls) at
     64^3, 3 steps: outer iterations, host syncs, host and device ms,
     kernels and busy share a step, peak memory, max|div u|, the gate;
     (d) the standard personality on the 128^3 box: the direct path
     (CuboidHelmholtzDirect, no K4) as 20 gated steps through run and as
     a graph, bitwise, from its third step, and the default path through
     run (its f32 gate missed, as in the JAX model: escalations counted)
     with its fast chunk as a graph against the same steps eagerly,
     bitwise; (e) the 2D slab at 256 x 1024, 20 gated steps after its
     first, max|div u| <= 1e-4; (f) 3 f64 steps of (b), (c) and the
     default path at 16^3 on the card against the CPU: equal
     iterations, within 1e-12 of each field's scale; (g) the CLI on the
     cube prm at its own 16^3, 5 steps with output into a temporary
     directory;
 10. the mimetic (staggered C-grid) personality (plain PyTorch, as jnp in
     the JAX package; K4 only on the direct temperature solve) and
     `poisson solver = cg | mg` (K4 in the multigrid line smoother's
     layout), built by make_model: (a) the mimetic shell at 32x128x256
     f32 from the seeded developed flow with the FEEC prm's physics
     (the default path and `helmholtz solver = direct`) and with the
     flagship's, 3 steps through run each: CG iterations, host syncs,
     host and device ms a step, max|div u| <= 1e-4 after every step, K4
     once a step on the direct path and never elsewhere, K1-K3, K5 0 on
     the device (profiler); (b) the mimetic 128^3 box, the annulus at
     256x3072 and the slab at 256x1024 (from its second step, held to
     1e-3: the f32 round-off of its fast solve), 3 steps each; (c) one
     mimetic step a geometry (and the shell's direct path) in f64 on the
     card against the CPU: equal iterations, within 1e-12; (d) `poisson
     solver = mg` and `= cg` on the shell at 32x128x256 f32 with the
     bench opt-ins, 3 steps through run: Poisson iterations, K4's
     launches (a V-cycle each preconditioner application), phi against
     the fast diagonalization's on the seeded flow's right-hand side;
     K4 on the line smoother's operands (radial, periodic lon 2-rhs,
     and the lat lines' moved view) against its plain version, f32 and
     f64, nothing copied, one launch's time against its bound; one
     V-cycle's launches; mg on the annulus at 64x768 (periodic lines)
     and the 64^3 box (Jacobi smoother, no K4); (e) the CLI on the FEEC prm with `feec
     formulation = staggered`: the personality line, and a restart
     bitwise an uninterrupted run's checkpoint;
 11. the remaining solvers and transports of one device: (a) K4 in the
     layouts of ShellPoissonDirect, ShellPoissonSpectral and
     AnnulusPoissonDirect at 32x128x256 and 256x3072, f32 and f64,
     against its plain version, nothing copied, the pair axis where the
     real and imaginary parts share their coefficients, the wrapper's
     time beside the bound, each solve whole (launches a solve, its true
     residual; the spectral CG on a shell with stretched radial faces,
     its cap raised to 400, and once more as the factory builds it by
     default, rtol 1e-7 and cap 120), and f64 on the card against the CPU (equal
     CG iterations, within 1e-12); (b) the semi-Lagrangian transport on the
     annulus at 256x3072 (the direct path: 20 gated steps through run
     and as a graph, bitwise) and on the slab at 256x1024 (20 gated
     steps, escalations counted, its fast chunk as a graph bitwise the
     same steps eagerly), one f64 step of each on the card against the
     CPU; (c) Richardson momentum beside CG temperature on the flagship
     at 32x128x256 f32, 5 steps through run: K2, K3 and K5 once a step
     and K1 never, by the wrappers and by the profiler, one f64 step on
     the card against the CPU, and a forced momentum miss that the gate
     redoes with CG; (d) the bench model on a stretched shell at
     32x128x256 f32 (its Poisson solve the spectral CG, so no CUDA
     graph): 5 steps through run and as one multi_step chunk, bitwise
     equal, K4 the CG iterations + 1 a step, and one profiled step;
 12. bfloat16 (the bf16-storage, f32-compute forms) and the native VTK
     encoder: (a) K2, K2m, K1, K1u, K3 and K5 in bf16 at 32x128x256 on
     the seeded flow (K2, K2m, K1 and K1u also at 6x20x36 and 4x8x16, K1
     and K1u at (1,1), (3,3) and (3,3) in groups of sweeps), K4's bf16
     form on the bf16 multigrid's lines at level 0, and K2o, K1o
     and K2mo in bf16 on every shard of the 2x2 mesh (stitched against
     K2, K1 and K2m), each against its plain version: every output
     within one bf16 ulp of its scale plus 1e-5 x scale (K1's float32
     norms at the f32 tolerances, K4's float32 x at 1e-5 x scale), the
     kernel's and the plain version's times and the bound at 2 bytes a
     value; (b) the bf16 flagship at 32x128x256: 20 gated steps through
     run and as one graph chunk, bitwise, 0 escalations, max|div u|
     within BF16_DIV_MARGIN of the CPU's reading from the same bf16 states
     (cpu_div_reading), max|u| within 10% of the f32 run's, one profiled
     eager step (device ms, kernels, busy
     share, in-step ms, every hand kernel counted as the wrappers count
     it); (c) the annulus at 256x3072 with `helmholtz solver = direct` in
     bf16 (20 steps, run and graph bitwise, K4 40) and one bf16 step of
     the shell with `poisson solver = mg` (0 escalations, every K4
     launch on the device the bf16 form), their max|div u| held to the
     CPU's reading as in (b); (d) a bf16 checkpoint restored bitwise,
     its float32 time exact, and a restart from it bitwise; (e) VTK
     writes at 32x128x256 with the native encoder and with the Python
     one, interleaved, host ms, the files byte for byte equal;
 13. the Krylov solves, the escalation and the plain path on the mesh,
     and the mimetic personality on the mesh (2x2 and 2x4 shards on the
     one card, 32x128x256 f32, the seeded flow): (a) step_strong for 5
     steps against one device's (within 1e-4 of max|u|, the Krylov
     counts equal or one apart, max|div u| <= 1e-4, K2o A*B times a
     step and nothing else launched); (b) run for 20 steps with every
     fast step missing its f32 gate (the fast Poisson solve's constants
     tripled, as in phase 5: no tolerance makes the seeded flow's f32
     gate miss): the escalations and the window of one device's run, a
     second run bitwise the first; (c) `fixed solver iters` = 0 and `poisson solver
     = cg`, 5 steps each on 2x2 against one device (the stalled f32
     Jacobi-CG Poisson's max|div u| held to twice one device's); (d) one
     kernels=False step against the kernel path (1e-5 of max|u|, no hand
     kernel launched); (e) the mimetic shell on 2x4, 3 steps against one
     device; (f) the escalated 2x4 step's device ms, host ms, kernels,
     host launches and host syncs, and the semi-Lagrangian model's
     escalated step (K2mo A*B times);
 14. the multigrid and the coupled solves on the mesh (32x128x256,
     the seeded flow, every shard on the one card): (a) `poisson solver =
     mg` f32, one step on 2x2 and one on 2x4 with the CG capped at 16 on
     both sides (the V-cycle relaxing along r alone, as the JAX mesh
     rebuilds it: ~215 CG iterations where one device's two-axis V-cycle
     takes 11): K4 A*B x 52 x (CG iterations + 1) times, K2o and K1o A*B
     times a step, the CG counts within 5% of one device's with the same
     radial-only rebuild (equal when capped), u and T within 1e-5 of
     max|u|, max|div u| within twice one device's; one shard's K4 against
     its plain version, nothing copied; one V-cycle of the 2x4 step
     profiled beside one device's; (b) the FEEC 3x3 with the flagship's
     physics on 2x4, one step: the outer count against one device's,
     max|u|, max|div u|, host ms, syncs; (c) the shell's 2x2 block FGMRES
     and Schur GMRES at 16x64x128 on 2x2, 2 steps each; (d) one bf16 mg
     step on 2x4 within 2^-7 of one device's, every K4 rhs bf16;
 15. the annulus, the 3D box and the 2D slab on their own meshes
     (("phi",), ("y", "x"), ("x",); every shard on the one card): (a) the
     annulus prm at 256x3072 f32 on 4 and 8 phi shards, 5 steps through
     run against one device's run (escalations equal, u and T within
     1e-4 of max|u|, max|div u| <= 1e-4), one 8-shard step profiled; (b)
     the standard 128^3 box on 2x4, 2 steps through run (every step CG,
     as on one device, equal CG counts), and the cube prm's FEEC 3x3 at
     64^3, one step from one device's first (outer count within one);
     (c) the mimetic box and annulus and the SL slab against one device;
     (d) `poisson solver = mg` on the annulus (8 phi shards) and the
     walled box (2x4), CG capped at 8: K4 shards x line solves a V-cycle
     x V-cycles exactly (the box smooths by Jacobi: 0), one phi shard's
     K4 against its plain version in f32 and f64, nothing copied; (e) one
     f64 mesh step of each on the card against the CPU; (f) a sharded
     checkpoint of each restored bitwise;
 16. direct Helmholtz and the spectral CG on the mesh, and the mesh's
     communication ledger (every shard on the one card, f32 unless
     named): (a) the flagship with `helmholtz solver = direct` on 2x4, 5
     steps through run against one device's (escalations equal, within
     1e-4 of max|u|, K4 2 a step as on one device, K2o 8 a step, K1o 0),
     one step profiled; (b) the annulus prm at 256x3072 direct on 8 phi
     shards, the same; (c) the 128^3 box direct on 2x4, 2 steps, K4 0;
     (d) the stretched shell at 32x128x256 on 2x4, 2 steps, each step's
     Poisson CG count against one device's (equal or one apart, the
     difference printed), K4 the iterations + 1; (e) the comm ledger of
     one step of (a), (b), (d) and of the default 2x4 step, count and
     bytes per op; (f) f64 card vs CPU of each new sharded solver
     (1e-12);
 17. the mesh across processes (parallel/dist.py), its ranks
     scripts/torch_multihost_smoke.py processes, (b) and (c) started in
     phase 7's pool, (a) alone: (a) 2 gloo ranks sharing the card run the
     flagship at 32x128x256 f32 on 2x2 (two shards a rank), 5 gated
     steps through run: 0 escalations, K2o and K1o 2 x 5 times on each
     rank, the gathered state bitwise the single-controller 2x2 run's
     from the same state; each rank's host ms a step, one more step's
     device ms, kernels and host syncs, its messages and bytes a step
     (point-to-point and all-gathered) and its comm ledger (the
     single-controller one's); (b) 4 gloo ranks run the annulus prm at
     256x3072 with `helmholtz solver = direct` on 4 phi shards, 3 steps:
     K4 twice a step on each rank, bitwise a single-controller process
     started beside them; (c) a one-rank NCCL world
     runs the flagship on 2x2 for the same 5 steps as (a), bitwise,
     its sums all-gathered on the NCCL group; NCCL moves between ranks
     are not run (one card);
 18. the last counterparts of the JAX package's entry points and
     scripts: (a) entry()'s fn on the card, K2, K1 and K5 once each and
     K3 and K4 never (the wrappers' counts and the profiler's), its new
     state within ENTRY_TOL of each field's scale of
     entry(device="cpu")'s; the gap taken apart: the same step with
     K1, with K2, and with all three in their plain versions on the
     card, each with its Poisson right-hand side, solution and
     iterations against the CPU's, the kernel step against the card's
     plain step, the step with K1 and K5 launched against
     the card's plain step (ENTRY_K1K5_TOL), K2's rhs_u against its
     plain version's (ENTRY_K2_TOL), the card's plain step against the
     CPU's (ENTRY_DEVICE_TOL), and the card's Poisson solve of the CPU's
     right-hand side; (b) scripts/torch_soak_production.py
     --scale3d at its full 2000 steps in chunks of 100 (32x128x256 f32,
     the first chunk a graph replay, the adaptive ones eager): ok, the
     resume bitwise, steps/s, the CFL range, escalations; after (b) and
     (c) one adaptive chunk of SOAK_PROFILE_STEPS profiled (host and
     device ms a step, busy share); (c) the 2D
     production soak at 64x2048 f32 (the annulus's projection path:
     `momentum solver` auto picks it beside `use FEEC solver` false, as
     in the JAX package; the prm's Schur switch is read by the coupled
     solve alone), its steps cut to SOAK_2D_STEPS: ok, the resume
     bitwise; (d)
     scripts/torch_comm_bytes.py on the card and with --device cpu, both
     started in phase 7's pool: the weak and strong tables equal, row
     for row;
 19. one JSON line with every kernel's numbers (the bf16 forms under
     by_dtype["bfloat16"]), then, last, the {"ok": true, "device": ...}
     line.
Imports neither JAX nor the JAX package. Needs one CUDA card.
"""

import atexit
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 20
# H100 SXM data-sheet peaks (see PERF.md): HBM bandwidth, f32 (non-tensor)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(msg: str) -> None:
    """One progress line, led by the seconds since the script started."""
    print(f"chip_smoke: [{time.perf_counter() - _T0:6.1f} s] {msg}",
          flush=True)


def bound_of(n_bytes, n_ops):
    """Least time (ms) for the work: the larger of bytes/bandwidth and
    operations/peak f32 rate; and which of the two bounds it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(n_cells, fields, ops_per_cell, itemsize=4):
    """bound_of for a kernel that moves `fields` arrays of n_cells values."""
    return bound_of(fields * n_cells * itemsize, ops_per_cell * n_cells)


def compare(name, got, want, rtol, atol):
    """max |got - want| over the outputs; fails beyond atol + rtol|want|."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        excess = float(torch.max(d - (atol + rtol * w.abs())))
        if excess > 0:
            fail(f"{name}: kernel and plain version disagree "
                 f"(max |diff| {float(d.max()):.3e}, rtol {rtol}, "
                 f"atol {atol:.3e})")
        err = max(err, float(d.max()))
    return err


def check_k1(name, got, want, pre, dtype):
    """K1 against its plain version: iterates and faces rtol = atol =
    2e-6 (f64 1e-12), rhs_phi rtol 1e-4 and atol 2e-5 x scale (f64
    1e-11), and the four norms (check_norms; `pre`: short_norms). Returns
    the max abs error of the fields and check_norms' worst ratio."""
    import torch

    f32 = dtype == torch.float32
    tol = 2e-6 if f32 else 1e-12
    err = compare(f"{name} iterates/faces", (got[0], got[1]) + tuple(
        got[2][:3]), (want[0], want[1]) + tuple(want[2][:3]), tol, tol)
    sc = float(want[2][3].abs().max()) + 1e-30
    err = max(err, compare(f"{name} rhs_phi", (got[2][3],), (want[2][3],),
                           1e-4 if f32 else 1e-11,
                           (2e-5 if f32 else 1e-11) * sc))
    return err, check_norms(name, got[3], want[3], pre, dtype)


def check_k1u(name, got, want, dtype):
    """K1u against its plain version: iterates, faces and rhs_phi at
    check_k1's tolerances, the residual norms exactly the -1 sentinel in
    both, the b norms at check_norms' rtol 1e-5 (f64 1e-12). Returns the
    max abs error of the fields."""
    import torch

    f32 = dtype == torch.float32
    tol = 2e-6 if f32 else 1e-12
    err = compare(f"{name} iterates/faces", (got[0], got[1]) + tuple(
        got[2][:3]), (want[0], want[1]) + tuple(want[2][:3]), tol, tol)
    sc = float(want[2][3].abs().max()) + 1e-30
    err = max(err, compare(f"{name} rhs_phi", (got[2][3],), (want[2][3],),
                           1e-4 if f32 else 1e-11,
                           (2e-5 if f32 else 1e-11) * sc))
    g = [float(x) for x in got[3]]
    w = [float(x) for x in want[3]]
    if not g[0] == g[2] == w[0] == w[2] == -1.0:
        fail(f"{name}: residual norms {g[0]!r}, {g[2]!r} (plain {w[0]!r}, "
             f"{w[2]!r}), expected the sentinel -1")
    rtol_b = 1e-5 if f32 else 1e-12
    for b in (1, 3):
        if not abs(g[b] - w[b]) <= rtol_b * w[b]:
            fail(f"{name}: b norm {g[b]!r} vs plain {w[b]!r} (rtol {rtol_b})")
    return err


def same_bits(a, b):
    """Whether two tuples of K1 outputs (u*, T, (faces, rhs_phi)) are
    bitwise equal."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(
        (a[0], a[1]) + tuple(a[2]), (b[0], b[1]) + tuple(b[2])))


def rel_diff(a, b):
    """Largest scale-relative difference over u, p, T and the faces of
    two states."""
    out = 0.0
    for x, y in zip((a.u, a.p, a.T) + tuple(a.u_faces),
                    (b.u, b.p, b.T) + tuple(b.u_faces)):
        out = max(out, float((x - y).abs().max()
                             / y.abs().max().clamp_min(1e-30)))
    return out


def drive(model, fn):
    """Run fn() on the model with every kernel's launch count set to 0
    just before and read just after: (fn's result, the counts, host
    seconds up to a synchronize)."""
    import torch

    for k in model.kernels().values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {name: k.launches for name, k in model.kernels().items()}, wall


def short_norms(rk, args):
    """The plain version's residual norms (rn_u, rn_T) one sweep short of
    rk's iteration counts (after no sweep: |b - A x0|)."""
    short = copy.copy(rk)
    short.iters_u, short.iters_T = rk.iters_u - 1, rk.iters_T - 1
    n = short.plain(*args)[3]
    return float(n[0]), float(n[2])


def norm_ratios(got, want, pre, eps):
    """|d rn| / (0.1 rn + 2 eps |r_pre|) for rn_u and rn_T (check_norms),
    with rn and r_pre the plain version's."""
    return [abs(float(got[r]) - float(want[r]))
            / max(0.1 * float(want[r]) + 2 * eps * p, 1e-300)
            for r, p in ((0, pre[0]), (2, pre[1]))]


def check_norms(name, got, want, pre, dtype):
    """The norms the honesty gate reads (rn_u, bn_u, rn_T, bn_T). The
    b norms are plain sums: rtol 1e-5 (f64 1e-12). A residual norm rn
    must agree within 0.1 rn + 2 eps |r_pre|, r_pre the residual one
    sweep earlier (short_norms): the two versions round the last update
    r - A (r/D) differently (1/D as a table, the operator in conductance
    form), by about an ulp of r_pre a cell, and earlier differences
    shrink with every sweep; 0.1 rn covers the order of the sums. A
    residual norm of 0, or one left un-updated by the last sweep, fails
    it (phase 3 shows both on the bench flow). Second, looser: within
    eps |b|, 1/16 of the gate's f32 floor (16 eps |b|). Returns the
    largest |d rn| / tolerance."""
    import torch

    eps = float(torch.finfo(dtype).eps)
    rtol_b = 1e-5 if dtype == torch.float32 else 1e-12
    g = [float(x) for x in got]
    w = [float(x) for x in want]
    ratios = norm_ratios(got, want, pre, eps)
    for (r, b), ratio in zip(((0, 1), (2, 3)), ratios):
        if not abs(g[b] - w[b]) <= rtol_b * w[b]:
            fail(f"{name}: b norm {g[b]!r} vs plain {w[b]!r} (rtol {rtol_b})")
        if not (ratio <= 1.0 and abs(g[r] - w[r]) <= eps * w[b]):
            fail(f"{name}: residual norm {g[r]!r} vs plain {w[r]!r}: "
                 f"{ratio:.3g} x the tolerance 0.1 rn + 2 eps |r_pre|, "
                 f"{abs(g[r] - w[r]) / (eps * w[b]):.3g} eps |b|")
    return max(ratios)


PAIRS = ((1, 1), (2, 1), (1, 3), (3, 3))
# K4's system sizes checked: 600 rows exceed what a block of 32 threads
# stages in shared memory (at most 593 in f32), so the general kernel
# solves them
K4_NS = (1, 2, 5, 32, 33, 40, 600)


def check_k1_k2(dev, shape, dtype_name):
    """K2, then K1 and K1u at every iteration pair of PAIRS on K2's
    output and at (3, 3) in groups of sweeps, against their plain
    versions on one grid. Returns (K2 err, K1 err, K1 launches of one
    call at each, the worst residual-norm ratio of check_norms, K1u err,
    K1u launches of one call at each, whether K1u's outputs equal K1's
    bitwise at every pair)."""
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import richardson as k1
    from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson

    m = BoussinesqModel(bench_params(shape, dtype=dtype_name), device=dev)
    s = seed_developed_flow(m)
    f32 = m.torch_dtype == torch.float32
    args2 = (s.u, s.u_faces, s.T, s.p, BENCH_DT)
    g2 = m._forcing(*args2)
    w2 = m._forcing.plain(*args2)
    scale = max(float(w.abs().max()) for w in w2)
    label = f"{shape} {dtype_name}"
    e2 = compare(f"K2 {label}", g2, w2, 0.0 if f32 else 1e-12,
                 (1e-5 if f32 else 1e-12) * scale)
    kT = m._scalar(m.dtype.type(BENCH_DT) * m.dtype.type(m.one_over_Pe))
    a1 = (g2[0], m._vol_t * g2[1] + kT * m._T_lap_offset_t, s.T, BENCH_DT)
    e1, nr, passes = 0.0, 0.0, []
    e1u, passes_u, bitwise = 0.0, [], True

    def make(iu, iT, track):
        return ShellRichardson(
            m.geo, one_over_Re=m.one_over_Re, one_over_Pe=m.one_over_Pe,
            nse_interval=m.params.NSE_solver_interval,
            helm_diags=m.helm_diags, T_diag=m.T_diag, iters_u=iu,
            iters_T=iT, u_specs=m.u_specs, T_specs_hom=m.T_specs_hom,
            track_residual=track)

    # the sweeps in groups through device memory, as for iteration
    # counts whose halo no tile's shared memory holds: (3, 3) in two
    # passes or more under a limit of 2,500 values of shared memory
    itemsize = torch.finfo(m.torch_dtype).bits // 8
    for iu, iT, grouped in [p + (False,) for p in PAIRS] + [(3, 3, True)]:
        what = f"{label} iters ({iu},{iT}){' in groups' if grouped else ''}"
        rk, rku = make(iu, iT, True), make(iu, iT, False)
        if grouped:
            for r_, track in ((rk, True), (rku, False)):
                r_.plan = (lambda dtype, track=track: k1.plan(
                    shape, itemsize, 3, 3, smem_limit=2500 * itemsize,
                    track=track))
        g1 = rk(*a1)
        e, r = check_k1(f"K1 {what}", g1, rk.plain(*a1),
                        short_norms(rk, a1), m.torch_dtype)
        e1, nr = max(e1, e), max(nr, r)
        passes.append(len(rk.plan(m.torch_dtype)))
        g1u = rku(*a1)
        e1u = max(e1u, check_k1u(f"K1u {what}", g1u, rku.plain(*a1),
                                 m.torch_dtype))
        passes_u.append(len(rku.plan(m.torch_dtype)))
        bitwise = bitwise and same_bits(g1, g1u)
    return e2, e1, passes, nr, e1u, passes_u, bitwise


def check_k4(name, tk, sys4, want, tol):
    """K4 on one system (lower, diag, upper, rhs) against the plain
    version's `want`, within rtol = atol = tol: with NaN in lower[0] and
    upper[n-1], which neither reads, and every operand bitwise unchanged
    by the call. Returns the max abs error."""
    import torch

    low, diag, up, rhs = (a.clone() for a in sys4)
    low[0] = float("nan")
    up[-1] = float("nan")
    before = [a.clone() for a in (low, diag, up, rhs)]
    got = tk(low, diag, up, rhs)
    torch.cuda.synchronize()
    bits = {2: torch.int16, 4: torch.int32,
            8: torch.int64}[rhs.element_size()]
    for a, b in zip((low, diag, up, rhs), before):
        if not torch.equal(a.view(bits), b.view(bits)):
            fail(f"{name}: the kernel changed a caller's operand")
    return compare(name, (got,), (want,), tol, tol)


def check_k4_cases(dev):
    """K4 against its plain version on seeded diagonally dominant
    systems: n in K4_NS (the staged kernel, and the general one above
    what a block stages), m = 3 x 2 x 131 (not a multiple of 4), f32
    (rtol = atol = 1e-5 x scale) and f64 (1e-12 x scale), in three
    layouts: the direct solver's (lower and upper one value a row,
    diag broadcast over an axis of size 2), lower and upper one value a
    row with a full diag, and four full arrays. Returns the max abs
    error."""
    import torch
    from dycoreplanet_tpu_torch.ops.tridiag import TridiagSolve

    gen = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for dtype in (torch.float32, torch.float64):
        def r(shape):
            return torch.rand(shape, generator=gen, device=dev, dtype=dtype)
        for n in K4_NS:
            for lshape, dshape in (((n, 1, 1, 1), (n, 3, 1, 131)),
                                   ((n, 1, 1, 1), (n, 3, 2, 131)),
                                   ((n, 3, 2, 131), (n, 3, 2, 131))):
                low, up = -r(lshape), -r(lshape)
                diag = 2.0 + r(dshape)
                rhs = 2 * r((n, 3, 2, 131)) - 1
                tk = TridiagSolve()
                want = tk.plain(low, diag, up, rhs)
                sc = float(want.abs().max())
                tol = (1e-5 if dtype == torch.float32 else 1e-12) * sc
                err = max(err, check_k4(
                    f"K4 tridiag n {n} {dtype} lower {lshape} diag "
                    f"{dshape}", tk, (low, diag, up, rhs), want, tol))
                if tk.launches != 1 or tk.copies != 0:
                    fail(f"K4 tridiag n {n}: {tk.launches} launches, "
                         f"{tk.copies} copies (expected 1, 0)")
    phase(f"K4 tridiag, n {list(K4_NS)}, m 786, f32 and f64, three "
          f"layouts: max abs err {err:.3e} (rtol=atol=1e-5 x scale f32, "
          f"1e-12 x scale f64)")
    return err


def direct_params(p):
    """The same configuration with `helmholtz solver = direct`."""
    p.numerics.helmholtz_solver = "direct"
    return p


def interval_params(p):
    """The same configuration with `residual check interval = 4`."""
    p.numerics.residual_check_interval = 4
    return p


def nse2_params(p):
    """The same configuration with `NSE solver interval = 2`."""
    p.NSE_solver_interval = 2
    return p


def sl_params(p):
    """The same configuration with `temperature advection =
    semi-lagrangian`."""
    p.numerics.temperature_advection = "semi-lagrangian"
    return p


# every hand kernel's wrapper name that a replay's device kernels are
# counted under on every path (a path without the wrapper: 0)
REPLAY_NAMES = ("forcing", "forcing_momentum", "forcing_operands",
                "forcing_momentum_operands", "richardson_operands")
# the shell's hand kernels, none of which an annulus model builds or runs
SHELL_NAMES = ("forcing", "forcing_momentum", "richardson",
               "richardson_free", "faces_div", "correct",
               "forcing_operands", "forcing_momentum_operands",
               "richardson_operands")
# the annulus at work size: aqua_planet_test_2d.prm at its own resolution
# knob `initial global refinement` = 8 (256 x 3072 cells), its own dt
ANNULUS_PRM = "aqua_planet_test_2d.prm"
ANNULUS_REFINEMENT = 8


def check_k2m(dev, shape, dtype_name):
    """K2m, the forcing without the fused transport, against its plain
    version on the seeded developed flow of a semi-Lagrangian model:
    atol 1e-5 x scale (f64 1e-12 x scale), one launch, rhs_u alone.
    Returns the max abs error."""
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, bench_params, seed_developed_flow)

    m = BoussinesqModel(sl_params(bench_params(shape, dtype=dtype_name)),
                        device=dev)
    s = seed_developed_flow(m)
    args = (s.u, s.u_faces, s.T, s.p, BENCH_DT)
    got, want = m._forcing(*args), m._forcing.plain(*args)
    label = f"K2m {shape} {dtype_name}"
    if not torch.is_tensor(got) or m._forcing.launches != 1:
        fail(f"{label}: expected rhs_u alone from one launch")
    f32 = m.torch_dtype == torch.float32
    scale = float(want.abs().max())
    return compare(label, (got,), (want,), 0.0 if f32 else 1e-12,
                   (1e-5 if f32 else 1e-12) * scale)


def replay_launches(label, model, fn, want):
    """Run fn(), a multi_step call that replays one captured chunk, and
    count the hand kernels it ran on the device (torch.profiler, by
    kernel name): one replay, no kernel wrapper called (a replay goes
    through none), and the device's counts `want`, with 0 for every
    other name of the model's wrappers and of REPLAY_NAMES (the fused K2
    on the semi-Lagrangian paths, K2m on the others, the operands-mode
    kernels, which no graph runs), and on the annulus and the cuboid
    of SHELL_NAMES (no shell kernel). Returns (fn's result, the
    counts)."""
    from dycoreplanet_tpu_torch.diagnostics.device_time import (
        device_launches)

    rep = model.chunk_graphs.replays
    for k in model.kernels().values():
        k.launches = 0
    names = dict.fromkeys(list(model.kernels()) + list(REPLAY_NAMES) + (
        list(SHELL_NAMES) if model.geo.kind != "shell" else []))
    want = {**dict.fromkeys(names, 0), **want}
    out, counts = device_launches(fn, names)
    if model.chunk_graphs.replays != rep + 1:
        fail(f"{label}: the chunk took {model.chunk_graphs.replays - rep} "
             f"replays, expected 1")
    called = {name: k.launches for name, k in model.kernels().items()
              if k.launches}
    if called:
        fail(f"{label}: the replay called kernel wrappers {called}")
    if counts != want:
        fail(f"{label}: the replay ran the hand kernels {counts} times on "
             f"the device, expected {want}")
    return out, counts


def graph_vs_run(label, model, s0, want, run_out=None, bitwise=False,
                 div_tol=1e-4):
    """One path at full width as BoussinesqModel.run and as one
    multi_step chunk of N_STEPS from the same state (a CUDA graph; the
    first chunk captures it): both zero escalations; the run's wrapper
    launches and the replay's device kernels (replay_launches) `want`;
    one replay; states within 1e-6 of each other (expected bitwise;
    required with `bitwise`); the chunk's rows against the run's
    records, at the model's own dt (the time step `run` takes), each
    row's post-projection divergence below ``div_tol``. `run_out`:
    the run's (result, launches, seconds) when the caller drove it.
    Returns (run launches, the replay's device kernels, run ms/step, graph
    ms/step (host clock, unprofiled), the chunk's state and rows)."""
    import torch

    dt = model.params.time_step
    if run_out is None:
        model.run(max_steps=2, state=s0)
        run_out = drive(model, lambda: model.run(max_steps=N_STEPS,
                                                 state=s0))
    (s_run, hist), l_run, w_run = run_out
    if l_run != want:
        fail(f"{label}: run launches {l_run}, expected {want}")

    def chunk():
        s, packed, _ = model.multi_step(s0, dt, N_STEPS)
        return s, packed.cpu().numpy()   # the rows, one copy

    model.multi_step(s0, dt, N_STEPS)               # capture, replay
    (s_g, rows), l_g = replay_launches(label, model, chunk, want)
    _, _, w_g = drive(model, chunk)                 # timed, unprofiled
    if model.escalations != 0:
        fail(f"{label}: {model.escalations} escalation(s)")
    for x in (s_g.u, s_g.p, s_g.T) + tuple(s_g.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail(f"{label}: the graph chunk produced non-finite fields")
    rel = rel_diff(s_g, s_run)
    if not rel <= (0.0 if bitwise else 1e-6):
        fail(f"{label}: graph chunk vs run: max rel diff {rel:.3e} > "
             f"{0.0 if bitwise else 1e-6}")
    keys = ("cfl", "max_velocity", "T_min", "T_max", "div_norm",
            "poisson_iters", "temperature_iters")
    rec = [[h[k] for k in keys] for h in hist]
    same_rows = bool((rows[:, :7] == rec).all())
    for j, (r, h) in enumerate(zip(rows, hist)):
        if (int(r[5]), int(r[6])) != (h["poisson_iters"],
                                      h["temperature_iters"]):
            fail(f"{label}: row {j} iterations {r[5:7]} vs run {h}")
        for k, v in zip(keys[:4], r[:4]):
            if not abs(float(v) - h[k]) <= 1e-5 * abs(h[k]) + 1e-30:
                fail(f"{label}: row {j} {k} {float(v)!r} vs run {h[k]!r}")
        if not float(r[4]) < div_tol:
            fail(f"{label}: row {j} post-projection divergence {r[4]:.3e}")
    if not (rows[:, 10] == 1.0).all():
        fail(f"{label}: a graph step's solver_ok is 0")
    ms_run, ms_g = w_run / N_STEPS * 1e3, w_g / N_STEPS * 1e3
    phase(f"{label}: multi_step graph of {N_STEPS} steps vs run: max rel "
          f"diff {rel:.3e} (bitwise {rel == 0.0}), rows == records "
          f"{same_rows}, device kernels of the replay {l_g} (profiler; run "
          f"wrapper launches {l_run}), 1 replay a chunk, no wrapper called, "
          f"0 escalations; host ms/step run {ms_run:.4f}, graph {ms_g:.4f}")
    return l_run, l_g, ms_run, ms_g, s_g, rows


def annulus_params(dtype="float32", refinement=ANNULUS_REFINEMENT,
                   **numerics):
    """ANNULUS_PRM at `refinement` with `numerics` settings; its physics,
    walls, dt and tolerances are the prm's own."""
    from dycoreplanet_tpu_torch.base.params import Parameters

    p = Parameters.from_file(os.path.join(HERE, "data", ANNULUS_PRM))
    p.initial_global_refinement = refinement
    p.numerics.dtype = dtype
    for k, v in numerics.items():
        setattr(p.numerics, k, v)
    return p


def check_annulus_k4(dev, model, state, dtype_name):
    """K4 on the two radial systems of an annulus direct step at work
    size (AnnulusHelmholtzDirect's layout as it passes it: lower and
    upper one value a row, diag (nr, C, 2nm), rhs a strided view of the
    (C, nr, 2nm) transform), from `state`'s forcing (a developed flow,
    so that every column block C of the right-hand side and of the
    solution is nonzero, which the check requires), against its plain
    version on the card: rtol = atol = 1e-5 x scale (f64 1e-12 x
    scale), NaN in lower[0] and upper[n-1], the operands unchanged, no
    operand copied. Returns {system: numbers}."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.ops import tridiag as k4

    m = model
    dt = m._scalar(m.params.time_step)
    dt_T = m._dt_T(dt)
    rhs_u = state.u + dt * m._plain_forcing.explicit_forcing(
        state.u, state.u_faces, state.p, state.T)
    T_adv = m._advected_temperature(state.u, state.u_faces, state.T, dt_T)
    coef = m._scalar(m.dtype.type(dt) * m.dtype.type(m.one_over_Re))
    kT = m._scalar(m.dtype.type(dt_T) * m.dtype.type(m.one_over_Pe))
    f32 = m.torch_dtype == torch.float32
    tk = m._tridiag
    rows = {}
    for what, solver, b, c in (
            ("momentum", m.helmholtz_direct, m._vol_t[None] * rhs_u, coef),
            ("temperature", m.temperature_direct,
             (m._vol_t * T_adv)[None], kT)):
        sys4 = solver.systems(b, c)
        lay = k4.layout(*sys4, pair=tk.pair)
        n4, m4 = sys4[3].shape[0], sys4[3][0].numel()
        if lay.copied or lay.pair_axis is not None:
            fail(f"K4 annulus {what} {dtype_name}: layout copies "
                 f"{lay.copied}, pair axis {lay.pair_axis}")
        w4 = tk.plain(*sys4)
        for c in range(sys4[3].shape[1]):
            if not (bool(sys4[3][:, c].abs().max() > 0)
                    and bool(w4[:, c].abs().max() > 0)):
                fail(f"K4 annulus {what} {dtype_name}: column block {c} of "
                     "the right-hand side or of the solution is all zeros")
        sc = float(w4.abs().max())
        tol = (1e-5 if f32 else 1e-12) * sc
        copies0 = tk.copies
        err = check_k4(f"K4 tridiag annulus ({what}, {dtype_name})", tk,
                       sys4, w4, tol)
        if tk.copies != copies0:
            fail(f"K4 annulus {what}: the wrapper copied an operand")
        ms = time_ms(lambda: tk(*sys4))
        pms = time_ms(lambda: tk.plain(*sys4))
        itemsize = sys4[3].element_size()
        b_ms, b_by = bound_of(itemsize * k4.values_moved(*sys4),
                              k4.OPS_PER_VALUE * n4 * m4)
        cols = [size for size, _ in lay.axes]
        phase(f"K4 tridiag, annulus {what} systems {dtype_name} (n {n4}, "
              f"columns {cols}, rhs strides {tuple(sys4[3].stride())}, "
              f"{tk.plan(lay, sys4[3].device)[0]} threads a block; every "
              f"column block nonzero): 0 "
              f"operands copied, no pair axis, max abs err {err:.3e} (tol "
              f"{tol:.3e} = {'1e-5' if f32 else '1e-12'} x scale), kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms * 1e3:.2f} us "
              f"({b_by}; {k4.values_moved(*sys4)} values moved)")
        rows[what] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=pms,
                          bound_ms=b_ms, bound_by=b_by, n=n4, columns=cols,
                          copies=0)
    return rows


def annulus_phases(dev):
    """The annulus (ANNULUS_PRM, f32): the direct path at work size
    (ANNULUS_REFINEMENT; K4 twice a step, no shell kernel built) and the
    default path (Richardson with every residual tracked; no hand kernel)
    at the prm's own refinement 4, where its two sweeps meet the gate, as
    20 gated steps through run and as one multi_step graph, bitwise
    equal, 0 escalations; K4 in AnnulusHelmholtzDirect's layout at work
    size from the direct run's last state, f32 and f64; the default path
    at work size, where two sweeps miss the f32 gate and every miss is
    redone with CG, and its fast chunk as a graph against the same steps
    eagerly; a forced miss repaired by CG; one step of each path at work
    size on the card against the f64 CPU step from the same state.
    Returns (K4's rows by system, run launches by path, replay device
    kernels by path)."""
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.convert import (
        state_from_numpy, state_to_numpy)

    t0 = time.perf_counter()
    dmodel = BoussinesqModel(annulus_params(helmholtz_solver="direct"),
                             device=dev)
    geo = dmodel.geo
    if geo.kind != "annulus" or set(dmodel.kernels()) != {"tridiag"}:
        fail(f"annulus model: geometry {geo.kind}, kernels "
             f"{list(dmodel.kernels())}")
    if any(getattr(dmodel, k) is not None for k in (
            "_forcing", "_proj", "_richardson", "_richardson_free")):
        fail("annulus model: a shell kernel wrapper was built")
    dt = dmodel.params.time_step
    s0 = dmodel.initial_state()
    phase(f"annulus {ANNULUS_PRM} at refinement {ANNULUS_REFINEMENT}: "
          f"{geo.cell_shape} = {geo.n_cells} cells f32, dt {dt}; direct "
          f"model built in {time.perf_counter() - t0:.1f} s, kernels "
          f"{list(dmodel.kernels())}")

    # ---- the graphable paths: 20 gated steps through run and as a graph
    by_path, replay_by_path, ends = {}, {}, {}
    small = BoussinesqModel(annulus_params(refinement=4), device=dev)
    for label, model, want in (
            ("annulus direct", dmodel, {"tridiag": 2 * N_STEPS}),
            ("annulus default (refinement 4)", small, {"tridiag": 0})):
        if set(model.kernels()) != {"tridiag"}:
            fail(f"{label}: kernels {list(model.kernels())}")
        s_init = model.initial_state()
        model.run(max_steps=2, state=s_init)
        run_out = drive(model, lambda: model.run(max_steps=N_STEPS,
                                                 state=s_init))
        (s_end, hist), launches, wall = run_out
        check_annulus_run(label, model, s_end, hist)
        l_r, l_g, ms_r, ms_g, _, _ = graph_vs_run(
            label, model, s_init, want, run_out, bitwise=True)
        _, d_last = model.step(s_end, dt)
        phase(f"{label} {model.geo.cell_shape}: {N_STEPS} gated steps, 0 "
              f"escalations, launches {launches}, {describe(hist, d_last)}; "
              f"host ms/step run {ms_r:.4f}, graph {ms_g:.4f}")
        key = "annulus_direct" if "direct" in label else "annulus_default"
        by_path[key] = l_r
        replay_by_path[key + "_graph"] = l_g
        ends[label] = (model, s_end)

    # ---- K4 in the annulus layout, f32 and f64, from the direct run's
    # last state: both velocity components carry a nonzero forcing there
    # (from the initial state, at rest, u_phi's right-hand side is 0)
    k4_rows = {}
    s_dev = ends["annulus direct"][1]
    for what, r in check_annulus_k4(dev, dmodel, s_dev, "float32").items():
        k4_rows[f"annulus_{what}"] = r
    d64 = BoussinesqModel(annulus_params("float64",
                                         helmholtz_solver="direct"),
                          device=dev)
    s64 = state_from_numpy(d64, *state_to_numpy(s_dev))
    for what, r in check_annulus_k4(dev, d64, s64, "float64").items():
        k4_rows[f"annulus_{what}_f64"] = r
    del d64, s64

    # ---- the default path at work size: every fast step misses the
    # gate, and run redoes it with CG and opens the escalation window
    amodel = BoussinesqModel(annulus_params(), device=dev)
    run_out = drive(amodel, lambda: amodel.run(max_steps=N_STEPS, state=s0))
    (a_end, a_hist), a_launches, a_wall = run_out
    check_annulus_run("annulus default", amodel, a_end, a_hist,
                      escalated=True)
    _, d_fast = amodel.step(a_end, dt)
    phase(f"annulus default {geo.cell_shape}: {N_STEPS} gated steps through "
          f"run, {amodel.escalations} escalation(s) (two Richardson sweeps "
          f"miss the f32 gate: the fast step's residuals helmholtz "
          f"{d_fast.helmholtz_residual:.3e} temperature "
          f"{d_fast.temperature_residual:.3e}, solver_ok "
          f"{d_fast.solver_ok}), every step redone or run with CG, "
          f"launches {a_launches}, {describe(a_hist, d_fast)}; host "
          f"ms/step {a_wall / N_STEPS * 1e3:.4f}")
    by_path["annulus_default_work_size"] = a_launches
    ends["annulus default"] = (amodel, a_end)

    # ---- the default path's fast chunk at work size as a graph: the 20
    # fast steps of a multi_step chunk before the gate's verdict (which
    # then redoes the chunk with CG), replayed and eager, bitwise equal,
    # the missed steps the same
    from dycoreplanet_tpu_torch.models.graphs import ChunkGraphs

    amodel.chunk_graphs = ChunkGraphs(amodel)
    amodel.chunk_graphs.run(s0, dt, N_STEPS, True)      # capture, replay
    (s_gf, rows_gf, _), l_gf = replay_launches(
        "annulus default fast chunk", amodel,
        lambda: amodel.chunk_graphs.run(s0, dt, N_STEPS, True), {})
    s_ef, rows_ef, _ = amodel._chunk(s0, dt, N_STEPS, True, False)
    rel_f = rel_diff(s_gf, s_ef)
    if not (rel_f == 0.0 and torch.equal(rows_gf, rows_ef)):
        fail(f"annulus default fast chunk {geo.cell_shape}: graph vs eager "
             f"max rel diff {rel_f:.3e}, rows equal "
             f"{bool(torch.equal(rows_gf, rows_ef))}; expected bitwise")
    missed = int((rows_gf[:, 10] < 0.5).sum())
    phase(f"annulus default fast chunk {geo.cell_shape}: {N_STEPS} fast "
          f"steps as one graph replay vs eagerly: bitwise equal states and "
          f"rows, {missed} of {N_STEPS} steps miss the gate in both, "
          f"device kernels of the replay {l_gf}")
    replay_by_path["annulus_default_work_size_fast_graph"] = l_gf
    del s_gf, s_ef

    # ---- a forced miss on the default path: the chunk redone with CG
    fm = BoussinesqModel(annulus_params(refinement=4), device=dev)
    fm.poisson_spectral._inv_denom = 3.0 * fm.poisson_spectral._inv_denom
    fm.poisson_spectral.to(dev)
    sf = fm.initial_state()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        s_fm, rows_fm, _ = fm.multi_step(sf, dt, 4)
    if fm.escalations != 1 or not warned:
        fail(f"annulus forced miss: {fm.escalations} escalation(s), "
             f"{len(warned)} warning(s), expected 1 and 1")
    if fm.chunk_graphs is None or fm.chunk_graphs.replays != 1:
        fail("annulus forced miss: the fast chunk did not run as a graph")
    if not bool((rows_fm[:, 10] == 1).all()):
        fail("annulus forced miss: the CG chunk did not converge")
    w_fm = sf
    for _ in range(4):
        w_fm, _ = fm.step_strong(w_fm, dt)
    rel_fm = rel_diff(s_fm, w_fm)
    if not rel_fm <= 1e-6:
        fail(f"annulus forced miss: the CG chunk vs a step_strong loop: "
             f"rel diff {rel_fm:.3e} > 1e-6")
    phase(f"annulus forced miss in a multi_step chunk of 4 (refinement 4): "
          f"1 escalation, the chunk redone with CG (poisson iters "
          f"{rows_fm[:, 5].tolist()}, temperature iters "
          f"{rows_fm[:, 6].tolist()}), vs a step_strong loop max rel diff "
          f"{rel_fm:.3e}")
    del fm, s_fm, w_fm

    # ---- one step on the card against the f64 CPU step, same state
    for label in ("annulus direct", "annulus default"):
        model, s_end = ends[label]
        numerics = ({"helmholtz_solver": "direct"} if "direct" in label
                    else {})
        cpu = BoussinesqModel(annulus_params("float64", **numerics),
                              device="cpu")
        u, faces, p, T, time_, n = state_to_numpy(s_end)
        s_cpu, _ = cpu.step(state_from_numpy(cpu, u, faces, p, T, time_, n),
                            dt)
        s_card, _ = model.step(s_end, dt)
        worst = {}
        for name, x, y in zip(("u", "p", "T", "uf0", "uf1"),
                              (s_card.u, s_card.p, s_card.T)
                              + tuple(s_card.u_faces),
                              (s_cpu.u, s_cpu.p, s_cpu.T)
                              + tuple(s_cpu.u_faces)):
            worst[name] = float((x.cpu().double() - y).abs().max()
                                / y.abs().max().clamp_min(1e-30))
        if not max(worst.values()) <= 1e-4:
            fail(f"{label}: one step on the card vs the f64 CPU step: rel "
                 f"diff {worst} > 1e-4")
        phase(f"{label} {geo.cell_shape}: one step on the card (f32) vs the "
              f"f64 CPU step from the same state: max rel diff of the field "
              f"scale " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + " (tol 1e-4)")
        del cpu
    phase(f"annulus phases {time.perf_counter() - t0:.1f} s")
    return k4_rows, by_path, replay_by_path


# the meshes of the mesh phase (6c), all shards on the one card: 2 x 4 is
# what build_mesh makes of 8 devices (the JAX package's default), and the
# path whose launches the kernels line reports
MESHES = ((2, 2), (2, 4))
MAIN_MESH = (2, 4)


def mesh_model(dev, mesh_shape, dtype="float32", options=lambda p: p):
    """The bench model (with ``options`` applied to its parameters)
    prepared for a mesh of A x B shards on dev."""
    import numpy as np
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import BENCH_SHAPE, bench_params
    from dycoreplanet_tpu_torch.parallel.mesh import Mesh

    A, B = mesh_shape
    model = BoussinesqModel(options(bench_params(BENCH_SHAPE, dtype)),
                            device=dev)
    return model.prepare_sharded(
        Mesh(np.array([[dev] * B] * A, dtype=object), ("lat", "lon")))


def step_profile(fn, n):
    """Device ms, device kernels and host launches a step of fn(), which
    runs n steps, from one torch.profiler window; the device ms a step of
    each hand kernel, by wrapper name; the busy share: device kernel
    time over the host time from fn's call to a synchronize after it;
    and the hand kernels of the window by wrapper name ("counts")."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import (
        count_kernels, device_rows, host_launches, profiled, wrapper_of)

    window = []

    def timed():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window.append(time.perf_counter() - t0)
        return out

    _, prof = profiled(timed)
    rows = device_rows(prof)
    dev_ms = sum(ms for _, ms, _ in rows)
    by = {}
    for name, ms, _ in rows:
        w = wrapper_of(name)
        if w is not None:
            by[w] = by.get(w, 0.0) + ms / n
    return {"device_ms_per_step": dev_ms / n,
            "kernels_per_step": sum(c for _, _, c in rows) / n,
            "host_launches_per_step": host_launches(prof) / n,
            "kernel_ms_per_step": by,
            "busy_share": dev_ms / (window[0] * 1e3),
            "counts": count_kernels(prof, SHELL_NAMES + ("tridiag",)),
            "rows": rows}


def launch_plan(kf, dev, dtype):
    """The operands launch of K2o / K2mo on one shard, as its wrapper plans
    it on this card: {rs, blocks, slots, per_sm, smem_bytes} and a line
    that says it."""
    import torch
    from dycoreplanet_tpu_torch.ops import forcing as k2

    rs, grid, slots = kf.operands_plan(dev, dtype)
    per_sm = kf.occupancy(dtype)
    plan = dict(rs=rs, blocks=grid[0] * grid[1] * grid[2], slots=slots,
                per_sm=per_sm, smem_bytes=k2.shared_bytes(
                    torch.tensor([], dtype=dtype).element_size(),
                    kf.advect_T, operands=True))
    return plan, (f"launch a shard {kf.local_shape}: RS {rs}, "
                  f"{plan['blocks']} blocks, {slots} resident slots "
                  f"({slots // per_sm} SMs x {per_sm}), "
                  f"{plan['smem_bytes']} bytes of shared memory a block")


def k1o_launch_plan(kr, dev, dtype):
    """The operands launch of K1o on one shard, as its wrapper plans it on
    this card: {tile, blocks, slots, smem_bytes} and a line that says
    it."""
    ps, slots = kr.operands_plan(dev, dtype)
    plan = dict(tile=list(ps.tile), blocks=ps.n_blocks, slots=slots,
                smem_bytes=ps.smem_bytes)
    return plan, (f"launch a shard {kr.local_shape}: tile {ps.tile}, "
                  f"{ps.n_blocks} blocks, {slots} resident slots, "
                  f"{ps.smem_bytes} bytes of shared memory a block")


def check_k1o_plan_bits(kr, args1, out1, what, f32, eps):
    """K1o under its plan against a (8, 8, 32) tile, the launch before the
    shard chose its tile, on every shard: u*, T_new, the faces and
    rhs_raw bitwise equal; the five sums within the K1o tolerances (their
    per-block partials go in another order)."""
    import torch
    from dycoreplanet_tpu_torch.ops import richardson as k1

    planned = k1.plan_operands

    def k1_tile(shape, sms, per_sm, itemsize, iters_u, iters_T):
        tile, halo = (8, 8, 32), max(iters_u, iters_T) + 1
        return k1.PassPlan(iters_u, iters_T, halo, tile, tuple(
            -(-n // t) for n, t in zip(shape, tile)), k1.shared_bytes(
                tile, halo, itemsize, operands=True))

    k1.plan_operands = k1_tile
    kr._card.clear()
    try:
        ref = {ab: kr.call_operands(*a) for ab, a in args1.items()}
        torch.cuda.synchronize()
    finally:
        k1.plan_operands = planned
        kr._card.clear()
    for ab, got in out1.items():
        for i, name in enumerate(("u*", "T_new", "f0", "f1", "f2",
                                  "rhs_raw")):
            if not torch.equal(got[i], ref[ab][i]):
                fail(f"K1o {what} shard {ab}: {name} under the plan differs "
                     f"from the (8, 8, 32) tile's by "
                     f"{float((got[i] - ref[ab][i]).abs().max()):.3e}")
        g = [float(x) for x in got[6]]
        w = [float(x) for x in ref[ab][6]]
        for k in (1, 3):
            if not abs(g[k] - w[k]) <= (1e-5 if f32 else 1e-12) * w[k]:
                fail(f"K1o {what} shard {ab}: |b|^2 {g[k]!r} vs the (8, 8, "
                     f"32) tile's {w[k]!r}")
        for r, bb in ((0, 1), (2, 3)):
            rg, rw = g[r] ** 0.5, w[r] ** 0.5
            if not abs(rg - rw) <= 0.1 * rw + 4 * eps * w[bb] ** 0.5:
                fail(f"K1o {what} shard {ab}: |r| {rg!r} vs the (8, 8, 32) "
                     f"tile's {rw!r}")
        if not abs(g[4] - w[4]) <= (1e-4 if f32 else 1e-11) * float(
                ref[ab][5].abs().sum()):
            fail(f"K1o {what} shard {ab}: sum(rhs) {g[4]!r} vs the (8, 8, "
                 f"32) tile's {w[4]!r}")


def check_mesh_kernels(dev, mesh_shape, dtype_name, timing=False):
    """K2o and K1o on every shard of a mesh at the bench shape, on the
    seeded developed flow, against their plain versions with phase 3's
    tolerances (K2o 1e-5 x scale, f64 1e-12; K1o iterates and faces rtol
    = atol = 2e-6, f64 1e-12, rhs_raw rtol 1e-4 and atol 2e-5 x scale, f64
    1e-11; the shard's sums: |b|^2 rtol 1e-5 (f64 1e-12), |r| within 0.1
    |r| + 4 eps |b|), and the shards' outputs stitched together against the
    single-device K2 and K1; K1o under its plan bitwise a (8, 8, 32)
    tile's. With ``timing``: shard (0, 0)'s wrapper and plain times and
    its bound. Returns (K2o error, K1o error, timings)."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import forcing as k2
    from dycoreplanet_tpu_torch.ops import richardson as k1
    from dycoreplanet_tpu_torch.parallel.halo import halo_pad
    from dycoreplanet_tpu_torch.parallel.mesh import (
        build, shard_state, unshard_field)
    from dycoreplanet_tpu_torch.parallel.sharded_pallas import forcing_halos

    model = mesh_model(dev, mesh_shape, dtype_name)
    f32 = model.torch_dtype == torch.float32
    s0 = seed_developed_flow(model)
    dt = model._scalar(BENCH_DT)
    mesh = model._mesh.mesh
    sh = shard_state(s0, model.geo, mesh)
    kf, kr = model._mesh.forcing.kern, model._mesh.richardson.kern
    nr, nl, no = kf.local_shape
    halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, mesh)
    what = f"{mesh_shape[0]}x{mesh_shape[1]} {dtype_name}"
    tol2 = 1e-5 if f32 else 1e-12
    out2, err2 = {}, 0.0
    args2 = {}
    for (a, b), u in sh.u.items():
        args2[a, b] = (u, tuple(f[a, b] for f in sh.u_faces), sh.T[a, b],
                       sh.p[a, b], dt, halos[a, b], (a * nl, b * no))
        got = kf.call_operands(*args2[a, b])
        want = kf.plain_operands(*args2[a, b])
        torch.cuda.synchronize()
        sc = max(float(w.abs().max()) for w in want)
        err2 = max(err2, compare(f"K2o {what} shard {(a, b)}", got, want,
                                 0.0, tol2 * sc))
        out2[a, b] = got
    k2_out = model._forcing(s0.u, s0.u_faces, s0.T, s0.p, dt)
    sc = max(float(w.abs().max()) for w in k2_out)
    d2 = compare(f"K2o {what} stitched vs K2", [unshard_field(build(
        mesh, lambda a, b: out2[a, b][i])) for i in range(2)], k2_out, 0.0,
        tol2 * sc)
    # K1o on K2o's outputs: rhs_T as the step forms it
    kT = model._scalar(model.dtype.type(dt) * model.dtype.type(
        model.one_over_Pe))
    ops = model._mesh.ops
    rhs_u = build(mesh, lambda a, b: out2[a, b][0])
    rhs_T = build(mesh, lambda a, b: ops.vol[a, b] * out2[a, b][1]
                  + kT * ops.T_lap_offset[a, b])
    GH = kr.GH
    st5 = rhs_u.map(lambda u, r, t: torch.cat([u, r[None], t[None]]),
                    rhs_T, sh.T)
    st5 = halo_pad(st5, mesh, "lon", 3, width=GH, periodic=True)
    st5 = halo_pad(st5, mesh, "lat", 2, width=GH, periodic=False)
    tol1 = 2e-6 if f32 else 1e-12
    eps = float(torch.finfo(model.torch_dtype).eps)
    out1, err1 = {}, 0.0
    args1 = {}
    for (a, b), e in st5.items():
        args1[a, b] = (e[:3], e[3], e[4], dt, (a * nl, b * no))
        got = kr.call_operands(*args1[a, b])
        want = kr.plain_operands(*args1[a, b])
        torch.cuda.synchronize()
        err1 = max(err1, compare(f"K1o {what} shard {(a, b)}", got[:5],
                                 want[:5], tol1, tol1))
        sc1 = float(want[5].abs().max()) + 1e-30
        err1 = max(err1, compare(f"K1o {what} rhs_raw shard {(a, b)}",
                                 (got[5],), (want[5],),
                                 1e-4 if f32 else 1e-11,
                                 (2e-5 if f32 else 1e-11) * sc1))
        g = [float(x) for x in got[6]]
        w = [float(x) for x in want[6]]
        for k in (1, 3):
            if not abs(g[k] - w[k]) <= (1e-5 if f32 else 1e-12) * w[k]:
                fail(f"K1o {what} shard {(a, b)}: |b|^2 {g[k]!r} vs plain "
                     f"{w[k]!r}")
        for r, bb in ((0, 1), (2, 3)):
            rg, rw = g[r] ** 0.5, w[r] ** 0.5
            if not abs(rg - rw) <= 0.1 * rw + 4 * eps * w[bb] ** 0.5:
                fail(f"K1o {what} shard {(a, b)}: |r| {rg!r} vs plain "
                     f"{rw!r}")
        out1[a, b] = got
    k1_out = model._richardson(unshard_field(rhs_u), unshard_field(rhs_T),
                               s0.T, dt)
    d1 = compare(f"K1o {what} stitched vs K1", [unshard_field(build(
        mesh, lambda a, b: out1[a, b][i])) for i in range(5)],
        [k1_out[0], k1_out[1]] + list(k1_out[2][:3]), tol1, tol1)
    check_k1o_plan_bits(kr, args1, out1, what, f32, eps)
    plan2, plan_msg = launch_plan(kf, dev, model.torch_dtype)
    plan1, plan1_msg = k1o_launch_plan(kr, dev, model.torch_dtype)
    phase(f"K2o / K1o {what}: every shard against its plain version, max "
          f"abs err {err2:.3e} / {err1:.3e}; stitched against K2 / K1 "
          f"{d2:.3e} / {d1:.3e}; K2o {plan_msg}; K1o {plan1_msg}, every "
          f"shard's outputs bitwise a (8, 8, 32) tile's")
    times = None
    if timing:
        itemsize = 4 if f32 else 8
        cells = nr * nl * no
        halo_vals = sum(t.numel() for t in halos[0, 0].values())
        b2_ms, b2_by = bound_of(
            (k2.FIELDS_MOVED * cells + halo_vals) * itemsize,
            k2.OPS_PER_CELL * cells)
        ext = nr * (nl + 2 * GH) * (no + 2 * GH)
        b1_ms, b1_by = bound_of(
            (5 * ext + 8 * cells) * itemsize,
            k1.ops_per_cell(kr.iters_u, kr.iters_T) * cells)
        times = {
            "K2o": dict(ms=time_ms(lambda: kf.call_operands(*args2[0, 0])),
                        plain_ms=time_ms(
                            lambda: kf.plain_operands(*args2[0, 0]), reps=5),
                        bound_ms=b2_ms, bound_by=b2_by, launch=plan2),
            "K1o": dict(ms=time_ms(lambda: kr.call_operands(*args1[0, 0])),
                        plain_ms=time_ms(
                            lambda: kr.plain_operands(*args1[0, 0]), reps=5),
                        bound_ms=b1_ms, bound_by=b1_by, launch=plan1)}
        for name, t in times.items():
            phase(f"{name} {what}, one shard {kf.local_shape}: kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    return max(err2, d2), max(err1, d1), times


def check_mesh_run(label, model, st0, want, s_ref, n_transport):
    """20 gated steps through run on a mesh from the sharded state st0,
    the wrappers' launches counted (every name of the model's wrappers
    not in ``want`` 0): 0 escalations, finite fields, max|div u| <= 1e-4,
    the transport on the shards called ``n_transport`` times, the state
    within 1e-4 of max|u| of the single-device state ``s_ref`` after the
    same steps, and a second run bitwise the first. Returns (launches,
    max|u - u_ref|, max|u_ref|, max|div u|, host seconds)."""
    import torch
    from dycoreplanet_tpu_torch.parallel.mesh import unshard_state

    model.run(max_steps=2, state=st0)             # warm-up
    tr = model._mesh.transport
    calls = tr.calls
    (s_end, hist), counts, wall = drive(
        model, lambda: model.run(max_steps=N_STEPS, state=st0))
    calls = tr.calls - calls
    want = {**{name: 0 for name in counts}, **want}
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")
    if calls != n_transport:
        fail(f"{label}: the transport on the shards ran {calls} times in "
             f"{N_STEPS} steps, expected {n_transport}")
    if model.escalations != 0 or len(hist) != N_STEPS:
        fail(f"{label}: {model.escalations} escalation(s), "
             f"{len(hist)} steps")
    g = unshard_state(s_end)
    for x in (g.u, g.p, g.T) + tuple(g.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail(f"{label}: non-finite fields")
    div_max = max(h["div_norm"] for h in hist)
    if not div_max <= 1e-4:
        fail(f"{label}: max|div u| {div_max:.3e} > 1e-4")
    du = float((g.u - s_ref.u).abs().max())
    u_sc = float(s_ref.u.abs().max())
    if not du <= 1e-4 * u_sc:
        fail(f"{label}: max|u_mesh - u_single| {du:.3e} > 1e-4 x "
             f"{u_sc:.3e}")
    s_again, _ = model.run(max_steps=N_STEPS, state=st0)
    again = unshard_state(s_again)
    if not all(torch.equal(x, y) for x, y in zip(
            (g.u, g.p, g.T) + tuple(g.u_faces),
            (again.u, again.p, again.T) + tuple(again.u_faces))):
        fail(f"{label}: two runs from the same state differ")
    return counts, du, u_sc, div_max, wall


def mesh_phases(dev, s0, s_single, single_model):
    """6c: the shell step on a mesh of shards on the one card, for each
    mesh of MESHES at the bench shape and flow: K2o and K1o against their
    plain versions (f32 and f64) and against K2 and K1; 20 gated steps
    through run (0 escalations, max|div u| <= 1e-4, K2o and K1o A x B
    times a step, no single-device kernel); the state after them within
    1e-4 of the scale of the single-device run's (``s_single``, the same
    20 steps from ``s0``); a second run bitwise the first; the mesh
    step's device ms, kernels and host launches a step beside the
    single-device eager step's. Returns ({mesh label: launches}, the
    K1o and K2o rows' numbers)."""
    from dycoreplanet_tpu_torch.parallel.mesh import shard_state

    t0 = time.perf_counter()
    launches, rows = {}, {"K1o": {}, "K2o": {}}
    for mesh_shape in MESHES:
        A, B = mesh_shape
        label = f"mesh_{A}x{B}"
        errs = {}
        for dname in ("float32", "float64"):
            e2, e1, times = check_mesh_kernels(
                dev, mesh_shape, dname, timing=dname == "float32")
            errs[dname] = (e2, e1)
            if times is not None:
                for k in ("K1o", "K2o"):
                    rows[k][label] = dict(times[k])
        model = mesh_model(dev, mesh_shape)
        st0 = shard_state(s0, model.geo, model._mesh.mesh)
        counts, du, u_sc, div_max, wall = check_mesh_run(
            label, model, st0, {"forcing_operands": N_STEPS * A * B,
                                "richardson_operands": N_STEPS * A * B},
            s_single, 0)
        launches[label] = counts
        prof_m = step_profile(
            lambda: model.run(max_steps=5, state=st0), 5)
        for k, w in (("K1o", "richardson_operands"),
                     ("K2o", "forcing_operands")):
            ms = prof_m["kernel_ms_per_step"].get(w, 0.0)
            rows[k][label].update(
                in_step_ms=ms, in_step_ms_per_shard=ms / (A * B),
                launches_per_step=A * B,
                step_device_ms=prof_m["device_ms_per_step"],
                step_kernels=prof_m["kernels_per_step"],
                step_host_launches=prof_m["host_launches_per_step"])
        rows["K2o"][label]["max_abs_err"] = max(
            e[0] for e in errs.values())
        rows["K1o"][label]["max_abs_err"] = max(
            e[1] for e in errs.values())
        phase(f"{label} {model.geo.cell_shape} f32: {N_STEPS} gated steps, "
              f"0 escalations, launches {counts}, max|div u| "
              f"{div_max:.3e}, max|u_mesh - u_single| {du:.3e} "
              f"({du / u_sc:.3e} of max|u|), a second run bitwise equal, "
              f"{wall / N_STEPS * 1e3:.3f} ms/step (host clock); device "
              f"{prof_m['device_ms_per_step']:.4f} ms/step in "
              f"{prof_m['kernels_per_step']:.1f} kernels, "
              f"{prof_m['host_launches_per_step']:.1f} host launches a "
              f"step; K2o {rows['K2o'][label]['in_step_ms']:.4f} ms and K1o "
              f"{rows['K1o'][label]['in_step_ms']:.4f} ms a step")
        del model
    prof_1 = step_profile(
        lambda: single_model.run(max_steps=5, state=s0), 5)
    phase(f"single-device eager step, same flow: device "
          f"{prof_1['device_ms_per_step']:.4f} ms/step in "
          f"{prof_1['kernels_per_step']:.1f} kernels, "
          f"{prof_1['host_launches_per_step']:.1f} host launches a step")
    phase(f"mesh phases {time.perf_counter() - t0:.1f} s")
    return launches, rows


def check_mesh_sl(dev, mesh_shape, dtype_name, timing=False):
    """K2mo on every shard of a mesh at the bench shape, on the seeded
    developed flow of a semi-Lagrangian model, against its plain version
    with phase 3's K2m tolerance (1e-5 x scale, f64 1e-12 x scale), and
    the shards' outputs stitched together against the single-device K2m;
    the sharded SL transport stitched together, bitwise the single-device
    transport. With ``timing``: shard (0, 0)'s wrapper and plain times and
    its bound. Returns (K2mo error, timings)."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import forcing as k2
    from dycoreplanet_tpu_torch.parallel.mesh import (
        build, shard_state, unshard_field)
    from dycoreplanet_tpu_torch.parallel.sharded_pallas import forcing_halos

    model = mesh_model(dev, mesh_shape, dtype_name, sl_params)
    f32 = model.torch_dtype == torch.float32
    s0 = seed_developed_flow(model)
    dt = model._scalar(BENCH_DT)
    mesh = model._mesh.mesh
    sh = shard_state(s0, model.geo, mesh)
    kf = model._mesh.forcing.kern
    if kf.advect_T:
        fail("K2mo: the SL mesh model's forcing carries the transport")
    nr, nl, no = kf.local_shape
    halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, mesh, advect_T=False)
    what = f"{mesh_shape[0]}x{mesh_shape[1]} {dtype_name}"
    tol = 1e-5 if f32 else 1e-12
    out, args, err = {}, {}, 0.0
    for (a, b), u in sh.u.items():
        args[a, b] = (u, tuple(f[a, b] for f in sh.u_faces), sh.T[a, b],
                      sh.p[a, b], dt, halos[a, b], (a * nl, b * no))
        got = kf.call_operands(*args[a, b])
        want = kf.plain_operands(*args[a, b])
        torch.cuda.synchronize()
        if not torch.is_tensor(got):
            fail(f"K2mo {what}: expected rhs_u alone")
        err = max(err, compare(f"K2mo {what} shard {(a, b)}", (got,),
                               (want,), 0.0, tol * float(want.abs().max())))
        out[a, b] = got
    k2m = model._forcing(s0.u, s0.u_faces, s0.T, s0.p, dt)
    d2 = compare(f"K2mo {what} stitched vs K2m",
                 (unshard_field(build(mesh, lambda a, b: out[a, b])),),
                 (k2m,), 0.0, tol * float(k2m.abs().max()))
    dt_T = model._dt_T(dt)
    single = model._semi_lagrangian(s0.u, s0.T, dt_T)
    shd = unshard_field(model._mesh.transport(sh.u, sh.u_faces, sh.T, dt_T))
    torch.cuda.synchronize()
    if not torch.equal(shd, single):
        fail(f"SL transport {what}: the shards stitched together differ "
             f"from the single-device transport by "
             f"{float((shd - single).abs().max()):.3e}")
    plan, plan_msg = launch_plan(kf, dev, model.torch_dtype)
    phase(f"K2mo {what}: every shard against its plain version, max abs "
          f"err {err:.3e}; stitched against K2m {d2:.3e}; the sharded SL "
          f"transport stitched bitwise the single-device one; K2mo "
          f"{plan_msg}")
    times = None
    if timing:
        itemsize = 4 if f32 else 8
        cells = nr * nl * no
        halo_vals = sum(t.numel() for t in halos[0, 0].values())
        b_ms, b_by = bound_of(
            (k2.MOMENTUM_FIELDS_MOVED * cells + halo_vals) * itemsize,
            k2.MOMENTUM_OPS_PER_CELL * cells)
        times = dict(ms=time_ms(lambda: kf.call_operands(*args[0, 0])),
                     plain_ms=time_ms(lambda: kf.plain_operands(*args[0, 0]),
                                      reps=5),
                     bound_ms=b_ms, bound_by=b_by, launch=plan)
        phase(f"K2mo {what}, one shard {kf.local_shape}: kernel "
              f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, "
              f"bound {b_ms * 1e3:.2f} us ({b_by})")
    return max(err, d2), times


def mesh_sl_phases(dev, ss0, s0, refs, sl_model):
    """6d: the semi-Lagrangian transport and the temperature substeps on
    the meshes of MESHES at the bench shape, all shards on the one card:
    K2mo against its plain version (f32 and f64) and against K2m, the
    sharded SL transport bitwise the single-device one; 20 gated steps
    through run of the SL model at NSE solver interval 1 and 2 from the
    SL flow ``ss0``, and on 2 x 2 of the Eulerian model at NSE solver
    interval 2 from ``s0``, each against the single-device run's state
    ``refs[label]`` (phase 6): 0 escalations, max|div u| <= 1e-4, K2mo or
    K2o and K1o A x B times an NSE step and no other forcing kernel, the
    transport on the shards every SL step and every Eulerian substep, a
    second run bitwise the first; the SL mesh step's device ms, kernels
    and host launches a step beside the single-device SL eager step's
    (``sl_model``). Returns ({path label: launches}, the K2mo row's
    numbers by mesh)."""
    from dycoreplanet_tpu_torch.parallel.mesh import shard_state

    t0 = time.perf_counter()
    launches, rows = {}, {}
    half = N_STEPS // 2
    for mesh_shape in MESHES:
        A, B = mesh_shape
        tag = f"{A}x{B}"
        errs = []
        for dname in ("float32", "float64"):
            e, times = check_mesh_sl(dev, mesh_shape, dname,
                                     timing=dname == "float32")
            errs.append(e)
            if times is not None:
                rows[f"sl_mesh_{tag}"] = dict(times)
        paths = [("sl", sl_params, ss0, N_STEPS, "forcing_momentum_operands",
                  N_STEPS),
                 ("sl_nse2", lambda p: sl_params(nse2_params(p)), ss0, half,
                  "forcing_momentum_operands", N_STEPS)]
        if mesh_shape == (2, 2):
            paths.append(("nse2", nse2_params, s0, half, "forcing_operands",
                          half))
        for key, options, flow, n_nse, forcing, n_tr in paths:
            label = f"{key}_mesh_{tag}"
            model = mesh_model(dev, mesh_shape, options=options)
            st0 = shard_state(flow, model.geo, model._mesh.mesh)
            counts, du, u_sc, div_max, wall = check_mesh_run(
                label, model, st0, {forcing: n_nse * A * B,
                                    "richardson_operands": n_nse * A * B},
                refs[key], n_tr)
            launches[label] = counts
            msg = (f"{label} {model.geo.cell_shape} f32: {N_STEPS} gated "
                   f"steps, 0 escalations, launches {counts}, the transport "
                   f"on the shards {n_tr} times, max|div u| {div_max:.3e}, "
                   f"max|u_mesh - u_single| {du:.3e} ({du / u_sc:.3e} of "
                   f"max|u|), a second run bitwise equal, "
                   f"{wall / N_STEPS * 1e3:.3f} ms/step (host clock)")
            if key == "sl":
                prof = step_profile(
                    lambda: model.run(max_steps=5, state=st0), 5)
                ms = prof["kernel_ms_per_step"].get(forcing, 0.0)
                rows[label].update(
                    max_abs_err=max(errs), in_step_ms=ms,
                    in_step_ms_per_shard=ms / (A * B),
                    launches_per_step=A * B,
                    step_device_ms=prof["device_ms_per_step"],
                    step_kernels=prof["kernels_per_step"],
                    step_host_launches=prof["host_launches_per_step"])
                msg += (f"; device {prof['device_ms_per_step']:.4f} ms/step "
                        f"in {prof['kernels_per_step']:.1f} kernels, "
                        f"{prof['host_launches_per_step']:.1f} host launches "
                        f"a step; K2mo {ms:.4f} ms a step")
            phase(msg)
            del model
    prof_1 = step_profile(lambda: sl_model.run(max_steps=5, state=ss0), 5)
    phase(f"single-device SL eager step, same flow: device "
          f"{prof_1['device_ms_per_step']:.4f} ms/step in "
          f"{prof_1['kernels_per_step']:.1f} kernels, "
          f"{prof_1['host_launches_per_step']:.1f} host launches a step")
    for r in rows.values():
        r["single_device_sl_step_device_ms"] = prof_1["device_ms_per_step"]
    phase(f"mesh SL and substep phases {time.perf_counter() - t0:.1f} s")
    return launches, rows


def check_annulus_run(label, model, s_end, hist, escalated=False):
    """A 20-step annulus run: all steps, finite fields, max|div u| <=
    1e-4, no operand copied for K4, and 0 escalations (or, with
    `escalated`, at least one)."""
    import torch

    if len(hist) != N_STEPS:
        fail(f"{label}: {len(hist)} steps")
    if (model.escalations == 0) == escalated:
        fail(f"{label}: {model.escalations} escalation(s)")
    for x in (s_end.u, s_end.p, s_end.T) + tuple(s_end.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail(f"{label}: non-finite fields")
    divs = [h["div_norm"] for h in hist]
    if not max(divs) <= 1e-4:
        fail(f"{label}: post-projection divergence {max(divs):.3e} > 1e-4")
    if model._tridiag.copies:
        fail(f"{label}: K4's wrapper copied {model._tridiag.copies} "
             "operand(s)")


def describe(hist, diag):
    """A run's divergence, speed, CFL and T range, and the solver numbers
    of one more step."""
    return (f"max|div u| {max(h['div_norm'] for h in hist):.3e}, max|u| "
            f"{hist[-1]['max_velocity']:.4e}, max CFL "
            f"{max(h['cfl'] for h in hist):.3e}, T range "
            f"[{hist[-1]['T_min']:.4f}, {hist[-1]['T_max']:.4f}], "
            f"iterations helmholtz {diag.helmholtz_iters.tolist()} poisson "
            f"{diag.poisson_iters} temperature {diag.temperature_iters}, "
            f"residuals helmholtz {diag.helmholtz_residual:.3e} poisson "
            f"{diag.poisson_residual:.3e} temperature "
            f"{diag.temperature_residual:.3e}")


# ---------------------------------------------------------------- phase 7b
OUT_SHAPE = (32, 128, 256)
# a fixed dt at which the chunks of (c) run with 0 escalations from the
# prm's state of rest: at the bench's 0.002 the prm's two
# momentum Richardson sweeps miss the f32 gate at this size, so a chunk
# is redone with CG and (c) no longer runs (a)'s steps
OUT_DT = 0.0005


def cli_runs(jobs, timeout=600):
    """``python -m dycoreplanet_tpu_torch -p prm argv`` for every (label,
    prm, argv) of ``jobs`` (``python argv`` where prm is None; a fourth
    entry: the environment's additions), all started together (each
    process spends most of its seconds on the host, starting up); waits
    for all of them and kills any still running at ``timeout`` seconds;
    each run's seconds go to CLI_SECONDS by its label. Returns [(rc,
    stdout, stderr)] in the order of ``jobs``."""
    procs = []
    for label, prm, argv, *env in jobs:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        head = ([] if prm is None
                else ["-m", "dycoreplanet_tpu_torch", "-p", prm])
        procs.append((subprocess.Popen(
            [sys.executable] + head + argv, cwd=HERE, stdout=out,
            stderr=err, text=True,
            env=dict(os.environ, **env[0]) if env else None), out, err))
    t_start = time.perf_counter()
    t_end = t_start + timeout
    running = dict(enumerate(procs))
    while running and time.perf_counter() < t_end:
        for i, (proc, _, _) in list(running.items()):
            if proc.poll() is not None:
                CLI_SECONDS[jobs[i][0]] = time.perf_counter() - t_start
                del running[i]
        time.sleep(0.1)
    results = []
    for proc, out, err in procs:
        try:
            rc = proc.wait(timeout=max(t_end - time.perf_counter(), 0.1))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        texts = []
        for f in (out, err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        results.append((rc, *texts))
    return results


# the CLI runs of phases 8-10 that need nothing of their phase, started
# side by side with phase 7's: {label: (rc, stdout, stderr)}, and
# ["the directory they wrote in"]; empty where a phase runs alone
CLI_AHEAD = {}
CLI_AHEAD_DIR = []
# the seconds of every CLI run, by label (cli_runs)
CLI_SECONDS = {}


def cli_dir():
    """The directory a phase's CLI jobs write in: the one of the runs
    started ahead, or a new temporary one."""
    import contextlib

    if CLI_AHEAD_DIR:
        return contextlib.nullcontext(CLI_AHEAD_DIR[0])
    return tempfile.TemporaryDirectory()


def run_clis(jobs, timeout=600):
    """cli_runs(jobs), taking a job's run from CLI_AHEAD where it was
    started ahead; fails unless every run exits with rc 0 and none
    escalated. Returns their stdouts."""
    ahead = [CLI_AHEAD.pop(label, None) for label, *_ in jobs]
    fresh = iter(cli_runs([j for j, a in zip(jobs, ahead) if a is None],
                          timeout))
    runs = [a if a is not None else next(fresh) for a in ahead]
    outs = []
    for (label, *_), (rc, out, err) in zip(jobs, runs):
        if rc != 0:
            fail(f"CLI ({label}) rc {rc}:\n{out[-2000:]}\n{err[-2000:]}")
        if "retrying chunk with full CG" in err:
            fail(f"CLI ({label}) escalated:\n{err[-2000:]}")
        outs.append(out)
    return outs


def run_cli(label, prm, argv, timeout=600):
    """run_clis of one run: its stdout."""
    return run_clis([(label, prm, argv)], timeout)[0]


def out_prm(tmp, src, outdir, extra=""):
    """A copy of ``src`` that writes into ``outdir`` (never into the
    checkout), with ``extra`` appended."""
    import re

    with open(src) as f:
        text = re.sub(r"set dirname output = .*",
                      f"set dirname output = {outdir}", f.read())
    path = os.path.join(tmp, os.path.basename(outdir) + ".prm")
    with open(path, "w") as f:
        f.write(text + "\n" + extra)
    return path


def vts_arrays(path):
    """{name: float32 array} of a .vts file's decoded data blocks."""
    import base64
    import struct
    import xml.etree.ElementTree as ET

    import numpy as np

    out = {}
    for a in ET.parse(path).getroot().iter("DataArray"):
        raw = base64.b64decode(a.text.strip())
        (n,) = struct.unpack("<I", raw[:4])
        out[a.attrib.get("Name", "points")] = np.frombuffer(
            raw[4:4 + n], np.float32)
    return out


def timer_ms(stdout, section):
    """(ms a call, calls) of a section of the last timer table printed."""
    rows = [ln for ln in stdout.splitlines()
            if ln.startswith(f"| {section} ")]
    if not rows:
        fail(f"no timer row '{section}'")
    cells = [c.strip() for c in rows[-1].strip("|").split("|")]
    calls, total = int(cells[1]), float(cells[2].rstrip("s"))
    return 1e3 * total / calls, calls


def trace_text(trace_dir):
    files = os.listdir(trace_dir)
    if len(files) != 1:
        fail(f"expected one profiler trace in {trace_dir}, found {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        return f.read()


def same_file(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def cli_output_phase(tmp, side_jobs=()):
    """Phase 7b: the CLI with output at 32x128x256 f32 on the card, a
    fixed dt; every file in ``tmp``. Its runs but (b) go side by side
    with ``side_jobs`` (cli_runs jobs, phase 7's). Returns (the numbers
    it printed, cli_runs of side_jobs)."""
    import numpy as np

    t0 = time.perf_counter()
    classic = os.path.join(HERE, "data",
                           "aqua_planet_shell_test_3d-classic.prm")
    nr, nlat, nlon = OUT_SHAPE
    extra = ("subsection Numerics\n"
             f"  set n radial = {nr}\n  set n lat = {nlat}\n"
             f"  set n lon = {nlon}\nend\n"
             "subsection Boussinesq Model\n  set adapt time step = false\n"
             f"  set time step = {OUT_DT}\n  set final time = 10\nend\n")
    level3 = ("subsection Boussinesq Model\n"
              "  set solver diagnostics level = 3\nend\n")
    d = {k: os.path.join(tmp, f"out-{k}") for k in "abcde"}
    prof = {k: os.path.join(tmp, f"prof-{k}") for k in "ad"}
    ck = lambda k, n: os.path.join(d[k], f"boussinesq_ckpt_{n:06d}.npz")
    vts = lambda k, n: os.path.join(d[k], f"boussinesq_{n:06d}.vts")

    own = [
        # (a) per step, checkpoints every 2, the mesh, a profiler trace
        ("7b a", out_prm(tmp, classic, d["a"], extra),
         ["--max-steps", "4", "--checkpoint-every", "2", "--write-mesh",
          "--profile", prof["a"]]),
        # (c) graph chunks of 2: the same file at step 4
        ("7b c", out_prm(tmp, classic, d["c"], extra),
         ["--chunk", "2", "--max-steps", "4"]),
        # (d) level 3: the trails, on the unfused branch (no K1)
        ("7b d", out_prm(tmp, classic, d["d"], extra + level3),
         ["--max-steps", "2", "--no-output", "--profile", prof["d"]]),
        # (e) the annulus prm with output and checkpoints
        ("7b e", out_prm(
            tmp, os.path.join(HERE, "data", "aqua_planet_test_2d.prm"),
            d["e"]), ["--max-steps", "4", "--checkpoint-every", "2"])]
    # all but (b), which restarts from (a), side by side with side_jobs
    runs = cli_runs(own + list(side_jobs))
    side = runs[len(own):]
    for (label, _, _), (rc, out, err) in zip(own, runs):
        if rc != 0 or "retrying chunk with full CG" in err:
            fail(f"CLI ({label}) rc {rc}:\n{out[-2000:]}\n{err[-2000:]}")
    out_a, _, out_d, out_e = [out for _, out, _ in runs[:len(own)]]
    divs = [float(ln.split(":")[-1]) for ln in out_a.splitlines()
            if "Post-projection max |div u|" in ln]
    if len(divs) != 4 or not all(np.isfinite(x) and x <= 1e-4
                                 for x in divs):
        fail(f"7b a: max|div u| per step {divs}")
    want = (["boussinesq.pvd", "mesh.vts"]
            + [f"boussinesq_{n:06d}.vts" for n in range(5)]
            + [f"boussinesq_ckpt_{n:06d}.npz{j}" for n in (2, 4)
               for j in ("", ".json")])
    if sorted(os.listdir(d["a"])) != sorted(want):
        fail(f"7b a: files {sorted(os.listdir(d['a']))}, not {sorted(want)}")
    with open(os.path.join(d["a"], "boussinesq.pvd")) as f:
        n_pvd = f.read().count("<DataSet ")
    if n_pvd != 5:
        fail(f"7b a: the .pvd has {n_pvd} entries, not 5")
    trace = trace_text(prof["a"])
    for name in ("rich_fused", "forcing_kernel", "correct_kernel"):
        if name not in trace:
            fail(f"7b a: the profiler trace does not name {name}")
    with np.load(ck("a", 4)) as z:
        T4 = z["T"]
        if z["T"].dtype != np.float32 or int(z["step_number"]) != 4:
            fail(f"7b a: ckpt_000004 T {z['T'].dtype}, step "
                 f"{int(z['step_number'])}")
    T_vts = vts_arrays(vts("a", 4))["temperature"]
    if T_vts.tobytes() != np.ascontiguousarray(T4.T).reshape(-1).tobytes():
        fail("7b a: the temperature of boussinesq_000004.vts is not "
             "ckpt_000004's T bitwise")
    phase(f"7b (a) {OUT_SHAPE} f32 dt {OUT_DT}: 4 steps rc 0, max|div u| "
          f"{max(divs):.3e}, mesh.vts, 5 .vts, a .pvd of 5, ckpt 2 and 4; "
          f"the trace names rich_fused, forcing_kernel, correct_kernel; "
          f"the .vts temperature at step 4 is the checkpoint's T bitwise")

    # (b) a restart from (a)'s step 2, 2 steps: (a)'s step 4 bitwise
    out_b = run_cli("7b b", out_prm(tmp, classic, d["b"], extra),
                    ["--restart", ck("a", 2), "--max-steps", "2",
                     "--checkpoint-every", "2"])
    if f"Restarted from {ck('a', 2)} at step 2" not in out_b:
        fail("7b b: no restart line")
    with np.load(ck("a", 4)) as za, np.load(ck("b", 2)) as zb:
        bad = [k for k in za.files
               if za[k].dtype != zb[k].dtype
               or za[k].tobytes() != zb[k].tobytes()]
        if sorted(za.files) != sorted(zb.files) or bad:
            fail(f"7b b: the restarted ckpt_000002 differs from (a)'s "
                 f"ckpt_000004 in {bad}")
    phase("7b (b) restart from (a)'s ckpt_000002, 2 steps: its "
          "ckpt_000002 is (a)'s ckpt_000004 bitwise (u, faces, p, T, "
          "time, step_number)")

    if not same_file(vts("c", 4), vts("a", 4)):
        fail("7b c: boussinesq_000004.vts of --chunk 2 differs from (a)'s")
    phase("7b (c) --chunk 2 (graph chunks): boussinesq_000004.vts is "
          "(a)'s byte for byte, 0 escalations")

    for name in ("helmholtz richardson", "temperature richardson"):
        n = out_d.count(f"   [{name}] ||r|| trail (2 its): ")
        if n != 2:
            fail(f"7b d: {n} trails of {name} with 2 iterations, not 2")
    trace = trace_text(prof["d"])
    if ("forcing_kernel" not in trace or "correct_kernel" not in trace
            or "rich_fused" in trace):
        fail("7b d: the trace must name forcing_kernel and correct_kernel "
             "and not rich_fused")
    trail = [ln.strip() for ln in out_d.splitlines() if "||r|| trail" in ln]
    phase(f"7b (d) solver diagnostics level 3, 2 steps: {trail[:2]}; the "
          f"trace names forcing_kernel and correct_kernel, not rich_fused")

    files_e = sorted(os.listdir(d["e"]))
    if len([f for f in files_e if f.endswith(".vts")]) != 5 or \
            not os.path.exists(ck("e", 4)):
        fail(f"7b e: files {files_e}")
    grid_e = [ln for ln in out_e.splitlines() if "Grid cells" in ln]
    phase(f"7b (e) aqua_planet_test_2d.prm: rc 0, {len(files_e)} files "
          f"({grid_e[0].strip(' |') if grid_e else ''})")

    vtk_ms, vtk_calls = timer_ms(out_a, "output: vtk")
    ck_ms, ck_calls = timer_ms(out_a, "output: checkpoint")
    step_ms, _ = timer_ms(out_a, "step: NSE + temperature solve")
    vtk_b, _ = timer_ms(out_b, "output: vtk")
    ck_b, _ = timer_ms(out_b, "output: checkpoint")
    step_b, _ = timer_ms(out_b, "step: NSE + temperature solve")
    nums = dict(vtk_ms=vtk_ms, checkpoint_ms=ck_ms, step_ms=step_ms,
                vtk_ms_no_profiler=vtk_b, checkpoint_ms_no_profiler=ck_b,
                step_ms_no_profiler=step_b,
                vts_bytes=os.path.getsize(vts("a", 4)),
                npz_bytes=os.path.getsize(ck("a", 4)))
    phase(f"7b output at {OUT_SHAPE} f32, host clock: output: vtk "
          f"{vtk_ms:.1f} ms a call ({vtk_calls} calls), output: checkpoint "
          f"{ck_ms:.1f} ms a call ({ck_calls} calls), step "
          f"{step_ms:.1f} ms/step, all under --profile (a); without it "
          f"(b): vtk {vtk_b:.1f} ms, checkpoint {ck_b:.1f} ms, step "
          f"{step_b:.1f} ms/step; .vts {nums['vts_bytes']} bytes, .npz "
          f"{nums['npz_bytes']} bytes")
    phase(f"7b phases {time.perf_counter() - t0:.1f} s")
    return nums, side



# ----------------------------------------------------------------- phase 8
FEEC_PRM = "aqua_planet_shell_test_3d-feec.prm"
# (a): FEEC 3x3 steps at the bench shape (the first counts host syncs)
FEEC_STEPS = 2
# (a): the outer cap of FEEC_PRM's physics, whose solve stalls at the
# prm's cap of 512 (~25 host s a step on an NVIDIA H100 80GB HBM3 host)
FEEC_PRM_CAP = 64
# (b): the card against the CPU in f64
FEEC_SMALL = (8, 16, 32)
# (d): annulus coupled steps at work size
COUPLED_STEPS = 2
# (e): the shell's Schur 2x2 path
SCHUR_SHAPE = (16, 64, 128)


def feec_params(shape, dtype="float32"):
    """FEEC_PRM at `shape` (its physics and tolerances), f32 or f64, with
    the bench's fixed dt."""
    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models.presets import BENCH_DT

    p = Parameters.from_file(os.path.join(HERE, "data", FEEC_PRM))
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
    p.numerics.dtype = dtype
    p.time_step = BENCH_DT
    p.adapt_time_step = False
    p.final_time = 1e9
    return p


def count_syncs(fn):
    """Run fn() with CUDA's sync debug mode warning on every host
    synchronization (a read back of a device value): (fn's result, the
    synchronizations counted)."""
    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def coupled_steps(label, model, s0, n):
    """n steps of a coupled model from s0 by ``step``, each step's
    diagnostics read: finite fields, else a failure. Returns (the last
    state, the steps' diagnostics, the wrapper launches, host ms/step)."""
    import torch

    def loop():
        s, diags = s0, []
        for _ in range(n):
            s, d = model.step(s, model.params.time_step)
            d.cfl                      # the step's one diagnostics copy
            diags.append(d)
        return s, diags

    (s, diags), launches, wall = drive(model, loop)
    for x in (s.u, s.p, s.T) + tuple(s.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail(f"{label}: non-finite fields")
    return s, diags, launches, wall / n * 1e3


def solves(diags):
    """The outer iterations and residuals, the temperature residuals, the
    gate's verdicts and the divergence of coupled steps."""
    r3 = lambda v: float(f"{v:.3e}")    # noqa: E731
    return (f"outer iterations {[d.poisson_iters for d in diags]}, outer "
            f"residuals {[r3(d.helmholtz_residual) for d in diags]}, "
            f"temperature residuals "
            f"{[r3(d.temperature_residual) for d in diags]}, gate "
            f"{[d.solver_ok for d in diags]}, max|div u| "
            f"{[r3(d.div_norm) for d in diags]}")


def annulus_coupled_params(dtype="float32", schur=True, **kw):
    """annulus_params with `momentum solver = coupled`: with ``schur`` the
    prm's own `use schur complement solver = true`, else the block
    FGMRES."""
    p = annulus_params(dtype, momentum_solver="coupled", **kw)
    p.use_schur_complement_solver = schur
    return p


def feec_cli_jobs(tmp=None):
    """Phase 8 (f)'s CLI run: the prm as it is, whose final time lets one
    step of dt 0.1 run (the CPU tests run it with --chunk too,
    tests/test_torch_cli.py)."""
    return [(FEEC_PRM, os.path.join(HERE, "data", FEEC_PRM),
             ["--max-steps", "3", "--no-output"])]


def feec_phases(dev):
    """Phase 8, the FEEC personality and the coupled solves (plain PyTorch:
    the JAX package runs no kernel in them) and the kernels they put on
    new paths: (a) the FEEC 3x3 FGMRES at the bench shape, f32, FEEC_PRM's
    physics and with the flagship's, the bench's dt, from the seeded
    developed flow; (b) one FEEC
    3x3 step and one annulus coupled step in f64 on the card against the
    CPU from the same state; (c) FEEC with `momentum solver = projection`
    and the flagship's physics (K1, K3, K5, no forcing kernel) as 20
    gated steps through run and as a
    multi_step graph; (d) the annulus coupled path at work size (the prm's
    Schur GMRES, the block FGMRES, and the Schur path with `helmholtz
    solver = direct`: K4 on the temperature solve); (e) the
    Schur 2x2 path on the shell; (f) the CLI on FEEC_PRM. Returns (run
    launches by path, replay device kernels by path)."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.convert import (
        state_from_numpy, state_to_numpy)
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    by_path, replay_by_path = {}, {}

    # ---- (a) the FEEC 3x3 FGMRES at the bench shape ----------------------
    # with FEEC_PRM's physics (Re 100: the solve stalls at its cap of 512
    # outer iterations at this size, in f32 and f64, in the JAX model too;
    # scripts/probe_coupled_gate.py; here capped at FEEC_PRM_CAP, the same
    # iterations fewer times) and with the flagship's (Re ~7e4), from
    # the seeded developed flow: FEEC_STEPS steps, the first with the
    # host syncs counted (it also pays cuBLAS's one-time set-up), the rest
    # timed; then one step under torch.profiler, for FEEC_PRM's physics
    # with the cap at one cycle of 16 (a 512-iteration step holds ~0.8 M
    # kernels, whose profile takes minutes to read)
    n_cells = int(np.prod(BENCH_SHAPE))
    for label, params in (("FEEC prm", feec_params(BENCH_SHAPE)),
                          ("flagship", bench_params(BENCH_SHAPE))):
        t_a = time.perf_counter()
        params.use_FEEC_solver = True
        m = BoussinesqModel(params, device=dev)
        if m.momentum_solver != "coupled" or set(m.kernels()) != {"tridiag"}:
            fail(f"FEEC model: momentum solver {m.momentum_solver}, kernels "
                 f"{list(m.kernels())}")
        if label == "FEEC prm":
            m.params.numerics.max_cg_iters = FEEC_PRM_CAP
        s0 = seed_developed_flow(m)
        def first_step():
            out = m.step(s0, BENCH_DT)
            out[1].cfl                  # its diagnostics copy, counted too
            return out

        (s1, d1), n_sync = count_syncs(first_step)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s_a, diags, launches, ms_a = coupled_steps(
            f"FEEC 3x3 ({label})", m, s1, FEEC_STEPS - 1)
        mem_peak = torch.cuda.max_memory_allocated()
        diags = [d1] + diags
        cap = m.params.numerics.max_cg_iters
        if label == "FEEC prm":
            m.params.numerics.max_cg_iters = 16
        d_prof = []
        prof = step_profile(lambda: d_prof.append(m.step(s_a, BENCH_DT)[1]),
                            1)
        m.params.numerics.max_cg_iters = cap
        its_prof = d_prof[0].poisson_iters
        by_path["feec_3x3" if label == "FEEC prm"
                else "feec_3x3_flagship"] = launches
        its = [d.poisson_iters for d in diags]
        ms_it = ms_a / max(sum(its[1:]) / len(its[1:]), 1)
        tol = max(m.params.numerics.helmholtz_tol,
                  16 * float(torch.finfo(torch.float32).eps))
        phase(f"8 (a) FEEC 3x3 FGMRES {BENCH_SHAPE} = {n_cells} cells f32, "
              f"{label} physics (1/Re {m.one_over_Re:.3e}), dt {BENCH_DT}, "
              f"outer cap {cap}, "
              f"seeded developed flow: {FEEC_STEPS} steps finite, "
              f"{solves(diags)} (outer rtol max(helmholtz tol, 16 eps) = "
              f"{tol:.3e}); host {ms_a:.2f} ms/step (steps 2-{FEEC_STEPS}, "
              f"each read back), {ms_it:.3f} ms an "
              f"outer iteration; {n_sync} host syncs in step 1 "
              f"({n_sync / its[0]:.2f} an outer iteration); profiled step "
              f"({its_prof} outer iterations"
              + (", the cap at 16" if label == "FEEC prm" else "")
              + f"): device {prof['device_ms_per_step']:.3f} ms in "
              f"{prof['kernels_per_step']:.0f} kernels "
              f"({prof['host_launches_per_step']:.0f} host launches), "
              f"{prof['device_ms_per_step'] / its_prof:.3f} device ms and "
              f"{prof['kernels_per_step'] / its_prof:.0f} kernels an outer "
              f"iteration; peak memory {mem_peak / 2**20:.1f} MiB "
              f"({(mem_peak - mem0) / 2**20:.1f} above the "
              f"{mem0 / 2**20:.1f} MiB before); launches {launches}; "
              f"{time.perf_counter() - t_a:.1f} s" + since())
        del m, s0, s1, s_a

    # ---- (b) the card against the CPU, f64, from the same state ----------
    cases = (("FEEC 3x3", lambda: feec_params(FEEC_SMALL, "float64")),
             ("annulus coupled Schur", lambda: annulus_coupled_params(
                 "float64", refinement=4)),
             ("annulus coupled FGMRES", lambda: annulus_coupled_params(
                 "float64", schur=False, refinement=4)))
    for label, params in cases:
        cpu = BoussinesqModel(params(), device="cpu")
        card = BoussinesqModel(params(), device=dev)
        if cpu.geo.kind == "shell":
            s_cpu = seed_developed_flow(cpu)
        else:
            s_cpu = cpu.initial_state()
            for _ in range(2):
                s_cpu, _ = cpu.step(s_cpu, cpu.params.time_step)
        s_card = state_from_numpy(card, *state_to_numpy(s_cpu))
        dt = cpu.params.time_step
        c1, dc = cpu.step(s_cpu, dt)
        g1, dg = card.step(s_card, dt)
        u_scale = float(c1.u.abs().max())
        worst = {}
        for name, x, y in zip(("u", "p", "T") + tuple(
                f"uf{i}" for i in range(len(c1.u_faces))),
                (g1.u, g1.p, g1.T) + tuple(g1.u_faces),
                (c1.u, c1.p, c1.T) + tuple(c1.u_faces)):
            scale = float(y.abs().max()) if name in ("p", "T") else u_scale
            worst[name] = float((x.cpu() - y).abs().max()) / max(scale, 1e-300)
        if dg.poisson_iters != dc.poisson_iters or max(worst.values()) > 1e-10:
            fail(f"8 (b) {label} {cpu.geo.cell_shape} f64: the card's step "
                 f"({dg.poisson_iters} outer iterations) vs the CPU's "
                 f"({dc.poisson_iters}): rel diff {worst} (tol 1e-10)")
        phase(f"8 (b) {label} {cpu.geo.cell_shape} f64, one step on the card "
              f"vs the CPU from the same state: outer iterations "
              f"{dg.poisson_iters} on both, max rel diff (u and the faces "
              f"to max|u|, p and T to their own) "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + " (tol 1e-10)" + since())
        del cpu, card

    # ---- (c) FEEC with momentum solver = projection ----------------------
    # the flagship's physics and opt-ins: at FEEC_PRM's Re of 100 one
    # Richardson sweep misses the f32 gate at this size, and every chunk
    # would be redone with CG
    p_c = bench_params(BENCH_SHAPE)
    p_c.use_FEEC_solver = True
    p_c.numerics.momentum_solver = "projection"
    pm = BoussinesqModel(p_c, device=dev)
    want_p = {"faces_div": 0, "correct": N_STEPS, "tridiag": 0,
              "richardson": N_STEPS}
    if pm.momentum_solver != "projection" or pm._forcing is not None:
        fail(f"FEEC projection model: {pm.momentum_solver}, forcing "
             f"wrapper {pm._forcing}")
    ps0 = seed_developed_flow(pm)
    l_pr, l_pg, ms_pr, ms_pg, s_pg, _ = graph_vs_run(
        "8 (c) FEEC projection", pm, ps0, want_p)
    # the chunk graph_vs_run captured, replayed under the profiler
    pprof = step_profile(lambda: pm.multi_step(ps0, BENCH_DT, N_STEPS),
                         N_STEPS)
    phase(f"8 (c) FEEC projection {BENCH_SHAPE} f32 (the flagship's physics "
          f"and opt-ins; the plain rotational forcing, K1, K5, no forcing "
          f"kernel): {N_STEPS} gated steps, 0 "
          f"escalations, run launches {l_pr}; graph replay "
          f"{pprof['device_ms_per_step']:.4f} device ms/step in "
          f"{pprof['kernels_per_step']:.1f} kernels, "
          f"{pprof['host_launches_per_step']:.2f} host launches a step; host "
          f"ms/step run {ms_pr:.4f}, graph {ms_pg:.4f}" + since())
    by_path["feec_projection"] = l_pr
    replay_by_path["feec_projection_graph"] = l_pg
    del pm, ps0, s_pg

    # ---- (d) the annulus coupled path at work size -----------------------
    for label, kw, want_k4 in (
            ("annulus coupled Schur", {}, 0),
            ("annulus coupled FGMRES", {"schur": False}, 0),
            ("annulus coupled Schur direct", {"helmholtz_solver": "direct"},
             COUPLED_STEPS)):
        am = BoussinesqModel(annulus_coupled_params(**kw), device=dev)
        if set(am.kernels()) != {"tridiag"}:
            fail(f"8 (d) {label}: kernels {list(am.kernels())}")
        _, diags, launches, ms = coupled_steps(
            label, am, am.initial_state(), COUPLED_STEPS)
        if launches != {"tridiag": want_k4}:
            fail(f"8 (d) {label}: launches {launches}, expected "
                 f"{{'tridiag': {want_k4}}}")
        key = label.replace(" ", "_")
        by_path[key] = launches
        phase(f"8 (d) {label} {am.geo.cell_shape} f32, {ANNULUS_PRM}'s "
              f"physics and dt: {COUPLED_STEPS} steps from rest, "
              f"{solves(diags)}, temperature iterations "
              f"{[d.temperature_iters for d in diags]}; launches {launches}; "
              f"host {ms:.2f} ms/step" + since())
        del am

    # ---- (e) the Schur 2x2 path on the shell -----------------------------
    p_s = feec_params(SCHUR_SHAPE)
    p_s.use_schur_complement_solver = True
    sm = BoussinesqModel(p_s, device=dev)
    _, diags, launches, ms = coupled_steps("Schur", sm,
                                           seed_developed_flow(sm), 2)
    by_path["feec_schur"] = launches
    phase(f"8 (e) Schur 2x2 (GMRES around inner CG) {SCHUR_SHAPE} f32, "
          f"{FEEC_PRM}'s physics with `use schur complement solver = "
          f"true`, dt {BENCH_DT}: 2 steps, {solves(diags)}; launches "
          f"{launches}; host {ms:.2f} ms/step" + since())
    del sm

    # ---- (f) the CLI -----------------------------------------------------
    (out,) = run_clis(feec_cli_jobs())
    its = [ln.strip() for ln in out.splitlines() if "Solver iterations" in ln]
    divs = [ln.strip() for ln in out.splitlines() if "Post-projection" in ln]
    if len(divs) != 1 or "FEEC (rotational, coupled 3x3)" not in out:
        fail(f"8 (f) CLI on {FEEC_PRM}: {len(divs)} steps printed, expected "
             f"1 (its final time 0.09, dt 0.1)")
    phase(f"8 (f) CLI on {FEEC_PRM} --max-steps 3 --no-output: rc 0, 1 step "
          f"(final time 0.09, dt 0.1): {its[-1]}; {divs[-1]}" + since())
    phase(f"phase 8 {time.perf_counter() - t0:.1f} s")
    return by_path, replay_by_path


# ----------------------------------------------------------------- phase 9
CUBE_PRM = "aqua_planet_cube_test_3d.prm"
# (a): K4 in CuboidPoissonDirect's layout, and the solves through it
CUBE_K4_SHAPE = (128, 128, 128)
K4_SOLVES = 5
# `initial global refinement` of (b) the prm's Schur GMRES (64^3), (c)
# the FEEC 3x3 FGMRES (64^3: at 128^3 it takes 175 outer iterations and
# 3.5 s a step on an H100, 120 s of the phase; PERF.md §4) and (d) the
# standard personality (128^3)
CUBE_SCHUR_REF, CUBE_3X3_REF, CUBE_STD_REF = 6, 6, 7
# (e): the 2D (z, x) slab
SLAB_SHAPE = (256, 1024)
# (f) the card against the CPU in f64 and (g) the CLI: the prm's own 16^3
CUBE_SMALL_REF = 4


def cube_params(refinement, dtype="float32", schur=True, feec=True,
                **numerics):
    """CUBE_PRM at `refinement` (its physics, dt 0.01 and tolerances), f32
    or f64: with ``schur`` the prm's own Schur GMRES, else the FEEC 3x3
    FGMRES; ``feec`` False is the standard personality."""
    from dycoreplanet_tpu_torch.base.params import Parameters

    p = Parameters.from_file(os.path.join(HERE, "data", CUBE_PRM))
    p.initial_global_refinement = refinement
    p.numerics.dtype = dtype
    p.use_schur_complement_solver = schur
    p.use_FEEC_solver = feec
    p.final_time = 1e9
    for k, v in numerics.items():
        setattr(p.numerics, k, v)
    return p


def slab_params(shape=SLAB_SHAPE, dtype="float32"):
    """The reference's dim=2 cuboid, the (z, x) slab, at `shape`
    (`numerics.nz` / `nx`), with the JAX package's TestCuboid2D physics
    (tests/test_model.py): buoyancy 0.2, unit reference velocity and
    length, T_ref 3, dt 0.01."""
    from dycoreplanet_tpu_torch.base.params import Parameters

    p = Parameters.from_text("")
    p.space_dimension = 2
    p.cuboid_geometry = True
    p.numerics.nz, p.numerics.nx = shape
    p.numerics.dtype = dtype
    p.physical_constants.expansion_coefficient = 0.2
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 3.0
    p.time_step = 0.01
    p.final_time = 1e9
    return p


def check_cuboid_k4(dev):
    """(a): K4 on CuboidPoissonDirect's operands as it passes them (rhs
    the rfft2's real and imaginary parts, (nz, ny, nx/2+1, 2), the pair
    axis; diag (nz, ny, nx/2+1, 1); lower and upper one value a row) at
    CUBE_K4_SHAPE from a seeded mean-free right-hand side, f32 and f64,
    against its plain version (rtol = atol = 1e-5 x scale, f64 1e-12 x
    scale; NaN in lower[0] and upper[n-1]; the operands unchanged; no
    copy); the whole solve's residual and, mean-free, its distance to
    CuboidPoissonFastDiag's solution, both within the model's Poisson
    spot-check tolerance max(poisson tol 1e-8, 256 eps); K4_SOLVES
    solves through the solver's entry point, one launch each, counted
    from 0. Returns {dtype: numbers}."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.grid.factory import make_cuboid
    from dycoreplanet_tpu_torch.ops import stencil as st
    from dycoreplanet_tpu_torch.ops import tridiag as k4
    from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
    from dycoreplanet_tpu_torch.solvers.spectral import (
        CuboidPoissonDirect, CuboidPoissonFastDiag)

    geo = make_cuboid(*CUBE_K4_SHAPE)
    p_specs = [BCSpec(BC.NEUMANN, BC.NEUMANN), None, None]
    rows = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        f32 = dtype == torch.float32
        solver = CuboidPoissonDirect(geo, dtype=np.dtype(name), device=dev)
        tk = solver.tridiag
        gen = torch.Generator(device=dev).manual_seed(14)
        b = torch.randn(geo.cell_shape, generator=gen, device=dev,
                        dtype=dtype)
        b = b - b.mean()
        sys4 = solver.systems(b)
        lay = k4.layout(*sys4, pair=tk.pair)
        if lay.copied or lay.pair != 2 or not lay.row_coefficients:
            fail(f"K4 cuboid {name}: layout copies {lay.copied}, pair "
                 f"{lay.pair}, row coefficients {lay.row_coefficients}")
        w4 = tk.plain(*sys4)
        sc = float(w4.abs().max())
        tol = (1e-5 if f32 else 1e-12) * sc
        err = check_k4(f"K4 tridiag cuboid ({name})", tk, sys4, w4, tol)
        ms = time_ms(lambda: tk(*sys4))
        pms = time_ms(lambda: tk.plain(*sys4))
        itemsize = sys4[3].element_size()
        moved = k4.values_moved(*sys4)
        b_ms, b_by = bound_of(itemsize * moved,
                              k4.OPS_PER_VALUE * sys4[3].numel())
        # the whole solve
        x = solver.solve(b)[0]
        res = float((-st.weak_laplacian(geo, x, p_specs) - b).norm()
                    / b.norm())
        xf = CuboidPoissonFastDiag(geo, dtype=np.dtype(name),
                                   device=dev).solve(b)[0]
        dist = float(((x - x.mean()) - (xf - xf.mean())).abs().max()
                     / xf.abs().max())
        tol_p = max(1e-8, 256 * float(torch.finfo(dtype).eps))
        if not (res <= tol_p and dist <= tol_p):
            fail(f"K4 cuboid {name}: the direct solve's residual {res:.3e}, "
                 f"its distance to the fast diagonalization {dist:.3e} "
                 f"(tol {tol_p:.3e})")
        # the solver's entry point, K4_SOLVES times, counts from 0
        tk.launches = tk.copies = 0
        for _ in range(K4_SOLVES):
            solver.solve(b)
        torch.cuda.synchronize()
        if (tk.launches, tk.copies) != (K4_SOLVES, 0):
            fail(f"K4 cuboid {name}: {tk.launches} launches, {tk.copies} "
                 f"copies in {K4_SOLVES} solves (expected {K4_SOLVES}, 0)")
        cols = [size for size, _ in lay.axes]
        phase(f"9 (a) K4 tridiag, CuboidPoissonDirect's layout "
              f"{CUBE_K4_SHAPE} {name} (n {sys4[3].shape[0]}, columns "
              f"{cols}, pair axis {lay.pair_axis}, rhs strides "
              f"{tuple(sys4[3].stride())}, {tk.plan(lay, dev)[0]} threads a "
              f"block): 0 operands copied, max abs err {err:.3e} (tol "
              f"{tol:.3e} = {'1e-5' if f32 else '1e-12'} x scale), kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms * 1e3:.2f} us "
              f"({b_by}; {moved} values moved); the solve's residual "
              f"{res:.3e}, mean-free distance to CuboidPoissonFastDiag "
              f"{dist:.3e} (tol {tol_p:.3e}); {K4_SOLVES} solves: "
              f"{tk.launches} launches, {tk.copies} copies")
        rows[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=pms,
                          bound_ms=b_ms, bound_by=b_by,
                          launches=tk.launches, copies=tk.copies,
                          residual=res, fastdiag_distance=dist)
    return rows


def coupled_cube(dev, label, params, n, profile_cap=None):
    """(b), (c): n steps of a coupled cube model from its IC, f32, the
    first with its host syncs counted, the rest timed with the peak
    memory, then one step under torch.profiler, with ``profile_cap``
    outer iterations at most (the FEEC 3x3's ~120-iteration step holds
    ~140 k kernels, whose profile takes a minute to read; its device ms
    a step is then the profiled ms an outer iteration times the step's
    iterations). Returns (run launches, the numbers)."""
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel

    m = BoussinesqModel(params, device=dev)
    if (m.geo.kind != "cuboid" or m.momentum_solver != "coupled"
            or set(m.kernels()) != {"tridiag"}):
        fail(f"9 {label}: geometry {m.geo.kind}, momentum solver "
             f"{m.momentum_solver}, kernels {list(m.kernels())}")
    dt = m.params.time_step

    def first_step():
        out = m.step(m.initial_state(), dt)
        out[1].cfl                      # its diagnostics copy, counted too
        return out

    (s1, d1), n_sync = count_syncs(first_step)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s_n, diags, launches, ms = coupled_steps(label, m, s1, n - 1)
    peak = torch.cuda.max_memory_allocated() - mem0
    diags = [d1] + diags
    cap = m.params.numerics.max_cg_iters
    if profile_cap is not None:
        m.params.numerics.max_cg_iters = profile_cap
    d_prof = []
    prof = step_profile(lambda: d_prof.append(m.step(s_n, dt)[1]), 1)
    m.params.numerics.max_cg_iters = cap
    if launches != {"tridiag": 0}:
        fail(f"9 {label}: launches {launches}")
    its = [d.poisson_iters for d in diags]
    its_prof = d_prof[0].poisson_iters
    per_it = prof["device_ms_per_step"] / its_prof
    dev_ms = per_it * sum(its[1:]) / len(its[1:])
    phase(f"9 {label} {m.geo.cell_shape} = {m.geo.n_cells} cells f32, "
          f"{CUBE_PRM}'s physics, dt {dt}, from its IC: {n} steps finite, "
          f"{solves(diags)}; host {ms:.2f} ms/step (steps 2-{n}, each read "
          f"back); {n_sync} host syncs in step 1 ({n_sync / its[0]:.2f} an "
          f"outer iteration); profiled step ({its_prof} outer iterations"
          + (f", the cap at {profile_cap}" if profile_cap else "")
          + f"): device {prof['device_ms_per_step']:.3f} ms in "
          f"{prof['kernels_per_step']:.0f} kernels "
          f"({prof['host_launches_per_step']:.0f} host launches), busy "
          f"share {prof['busy_share']:.3f}, {per_it:.3f} device ms and "
          f"{prof['kernels_per_step'] / its_prof:.0f} kernels an outer "
          f"iteration, so {dev_ms:.3f} device ms a step of steps 2-{n}; "
          f"peak "
          f"memory {peak / 2**20:.1f} MiB above the "
          f"{mem0 / 2**20:.1f} MiB before; launches {launches}")
    del m
    return launches, dict(outer_iterations=its, host_syncs_step1=n_sync,
                          host_ms_per_step=ms,
                          device_ms_per_step=dev_ms,
                          device_ms_per_iteration=per_it,
                          kernels_per_iteration=(prof["kernels_per_step"]
                                                 / its_prof),
                          busy=prof["busy_share"], peak_mib=peak / 2**20,
                          div=[d.div_norm for d in diags],
                          gate=[d.solver_ok for d in diags])


def cube_cli_jobs(tmp):
    """Phase 9 (g)'s CLI run: CUBE_PRM with output into tmp/cube-out."""
    outdir = os.path.join(tmp, "cube-out")
    return [(CUBE_PRM, out_prm(tmp, os.path.join(HERE, "data", CUBE_PRM),
                               outdir), ["--max-steps", "5"])]


def cuboid_phases(dev):
    """Phase 9, the cuboid (plain PyTorch: the JAX package runs no Pallas
    kernel there) and K4 in CuboidPoissonDirect's layout: (a) K4 in that
    layout; (b) CUBE_PRM as it stands (the Schur GMRES) and (c) with
    the FEEC 3x3 FGMRES; (d) the standard personality at 128^3, the
    default and the direct path, through run and as a graph; (e) the 2D
    slab; (f) (b), (c) and (d) in f64 on the card against the CPU; (g)
    the CLI on CUBE_PRM with output. Returns (run launches by path,
    replay device kernels by path, K4's rows by dtype)."""
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.graphs import ChunkGraphs

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    by_path, replay_by_path, cells = {}, {}, {}

    # ---- (a) K4 in CuboidPoissonDirect's layout --------------------------
    k4_rows = check_cuboid_k4(dev)
    phase("9 (a) done" + since())

    # ---- (b), (c) the coupled solves on the cube -------------------------
    for key, label, params, n in (
            ("cube_schur", "(b) cube Schur GMRES",
             cube_params(CUBE_SCHUR_REF), 2),
            ("cube_feec_3x3", "(c) cube FEEC 3x3 FGMRES",
             cube_params(CUBE_3X3_REF, schur=False), 2)):
        by_path[key], cells[key] = coupled_cube(
            dev, label, params, n,
            profile_cap=16 if key == "cube_feec_3x3" else None)
        phase(f"9 {label[:3]} done" + since())

    # ---- (d) the standard personality at 128^3 ---------------------------
    # the prm's tolerances in f32 are max(tol, 16 eps) = 1.9e-6: the
    # default path's two temperature sweeps miss them every step, and the
    # first step from rest misses the Poisson spot-check, in the JAX model
    # too (PERF.md). So the direct path runs from the state after its
    # first steps (0 escalations), the default path through run with its
    # escalations counted, and its fast chunk as a graph against the same
    # steps eagerly
    dm = BoussinesqModel(cube_params(CUBE_STD_REF, feec=False,
                                     helmholtz_solver="direct"), device=dev)
    if set(dm.kernels()) != {"tridiag"} or dm.helmholtz_direct is None:
        fail(f"9 (d) direct: kernels {list(dm.kernels())}")
    dt = dm.params.time_step
    s_warm, _ = dm.run(max_steps=2)
    dm.escalations = 0
    dm._strong_steps_left = 0
    l_r, l_g, ms_r, ms_g, s_g, _ = graph_vs_run(
        "9 (d) cube direct", dm, s_warm, {"tridiag": 0}, bitwise=True)
    prof = step_profile(lambda: dm.multi_step(s_warm, dt, N_STEPS), N_STEPS)
    busy = prof["busy_share"]
    phase(f"9 (d) cube direct {dm.geo.cell_shape} f32 (the standard "
          f"personality, `helmholtz solver = direct`: full fast "
          f"diagonalizations, no K4): {N_STEPS} gated steps from the state "
          f"after 2, 0 escalations, graph = run bitwise; graph replay "
          f"{prof['device_ms_per_step']:.4f} device ms/step in "
          f"{prof['kernels_per_step']:.1f} kernels, busy share "
          f"{busy:.3f}; host "
          f"ms/step run {ms_r:.4f}, graph {ms_g:.4f}" + since())
    by_path["cube_direct"] = l_r
    replay_by_path["cube_direct_graph"] = l_g
    cells["cube_direct"] = dict(device_ms_per_step=prof["device_ms_per_step"],
                                kernels_per_step=prof["kernels_per_step"],
                                busy=busy, host_ms_run=ms_r,
                                host_ms_graph=ms_g)
    del dm, s_warm, s_g

    am = BoussinesqModel(cube_params(CUBE_STD_REF, feec=False), device=dev)
    s0 = am.initial_state()
    (a_end, a_hist), a_launches, a_wall = drive(
        am, lambda: am.run(max_steps=N_STEPS, state=s0))
    check_annulus_run("9 (d) cube default", am, a_end, a_hist,
                      escalated=True)
    _, d_fast = am.step(a_end, dt)
    phase(f"9 (d) cube default {am.geo.cell_shape} f32: {N_STEPS} gated "
          f"steps through run, {am.escalations} escalation(s) (the fast "
          f"step's residuals helmholtz {d_fast.helmholtz_residual:.3e} "
          f"temperature {d_fast.temperature_residual:.3e}, solver_ok "
          f"{d_fast.solver_ok}), launches {a_launches}, "
          f"{describe(a_hist, d_fast)}; host ms/step "
          f"{a_wall / N_STEPS * 1e3:.4f}" + since())
    by_path["cube_default"] = a_launches
    am.chunk_graphs = ChunkGraphs(am)
    am.chunk_graphs.run(s0, dt, N_STEPS, True)          # capture, replay
    (s_gf, rows_gf, _), l_gf = replay_launches(
        "9 (d) cube default fast chunk", am,
        lambda: am.chunk_graphs.run(s0, dt, N_STEPS, True), {})
    s_ef, rows_ef, _ = am._chunk(s0, dt, N_STEPS, True, False)
    rel_f = rel_diff(s_gf, s_ef)
    if not (rel_f == 0.0 and torch.equal(rows_gf, rows_ef)):
        fail(f"9 (d) cube default fast chunk: graph vs eager max rel diff "
             f"{rel_f:.3e}; expected bitwise")
    fprof = step_profile(lambda: am.chunk_graphs.run(s0, dt, N_STEPS, True),
                         N_STEPS)
    missed = int((rows_gf[:, 10] < 0.5).sum())
    phase(f"9 (d) cube default fast chunk: {N_STEPS} fast steps as one "
          f"graph replay vs eagerly: bitwise equal states and rows, "
          f"{missed} of {N_STEPS} steps miss the gate in both; replay "
          f"{fprof['device_ms_per_step']:.4f} device ms/step in "
          f"{fprof['kernels_per_step']:.1f} kernels, busy share "
          f"{fprof['busy_share']:.3f}" + since())
    replay_by_path["cube_default_fast_graph"] = l_gf
    cells["cube_default"] = dict(
        escalations=am.escalations, host_ms_run=a_wall / N_STEPS * 1e3,
        fast_graph_device_ms_per_step=fprof["device_ms_per_step"],
        fast_graph_kernels_per_step=fprof["kernels_per_step"],
        fast_graph_busy=fprof["busy_share"],
        fast_steps_missed=missed)
    del am, s0, a_end, s_gf, s_ef

    # ---- (e) the 2D slab -------------------------------------------------
    # its first step from rest leaves max|div u| above 1e-4 in f32 (the
    # projection's cancellation from rest; the JAX model's is 3.8e-3
    # there too): the 20 gated steps start from the state after it
    sm = BoussinesqModel(slab_params(), device=dev)
    if sm.geo.cell_shape != SLAB_SHAPE or sm.geo.dim != 2:
        fail(f"9 (e) slab: cells {sm.geo.cell_shape}")
    s1, h1 = sm.run(max_steps=1)
    sm.escalations = 0
    sm._strong_steps_left = 0
    (e_end, e_hist), e_launches, e_wall = drive(
        sm, lambda: sm.run(max_steps=N_STEPS, state=s1))
    if len(e_hist) != N_STEPS or not max(
            h["div_norm"] for h in e_hist) <= 1e-4:
        fail(f"9 (e) slab: max|div u| "
             f"{max(h['div_norm'] for h in e_hist):.3e} > 1e-4")
    eprof = step_profile(lambda: sm.run(max_steps=N_STEPS, state=e_end),
                         N_STEPS)
    _, d_e = sm.step(e_end, sm.params.time_step)
    phase(f"9 (e) slab {SLAB_SHAPE} f32: step 1 from rest max|div u| "
          f"{h1[0]['div_norm']:.3e}; then {N_STEPS} gated steps through run, "
          f"{sm.escalations} escalation(s), launches {e_launches}, "
          f"{describe(e_hist, d_e)} (<= 1e-4); host ms/step "
          f"{e_wall / N_STEPS * 1e3:.4f}; {N_STEPS} more under the "
          f"profiler: {eprof['device_ms_per_step']:.4f} device ms/step in "
          f"{eprof['kernels_per_step']:.1f} kernels, busy share "
          f"{eprof['busy_share']:.3f}" + since())
    by_path["slab"] = e_launches
    cells["slab"] = dict(escalations=sm.escalations,
                         div_step1=h1[0]["div_norm"],
                         max_div=max(h["div_norm"] for h in e_hist),
                         host_ms_run=e_wall / N_STEPS * 1e3,
                         device_ms_per_step=eprof["device_ms_per_step"],
                         kernels_per_step=eprof["kernels_per_step"],
                         busy=eprof["busy_share"])
    del sm, s1, e_end

    # ---- (f) the card against the CPU, f64 -------------------------------
    for label, params in (
            ("Schur", lambda: cube_params(CUBE_SMALL_REF, "float64")),
            ("FEEC 3x3", lambda: cube_params(CUBE_SMALL_REF, "float64",
                                             schur=False)),
            ("standard default", lambda: cube_params(
                CUBE_SMALL_REF, "float64", feec=False))):
        cpu = BoussinesqModel(params(), device="cpu")
        card = BoussinesqModel(params(), device=dev)
        sc, sg = cpu.initial_state(), card.initial_state()
        dt = cpu.params.time_step
        its, worst = [], 0.0
        for k in range(3):
            sc, dc = cpu.step(sc, dt)
            sg, dg = card.step(sg, dt)
            if dg.poisson_iters != dc.poisson_iters:
                fail(f"9 (f) {label} step {k}: {dg.poisson_iters} outer "
                     f"iterations on the card, {dc.poisson_iters} on the CPU")
            its.append(dg.poisson_iters)
            for x, y in zip((sg.u, sg.p, sg.T) + tuple(sg.u_faces),
                            (sc.u, sc.p, sc.T) + tuple(sc.u_faces)):
                worst = max(worst, float((x.cpu() - y).abs().max()
                                         / y.abs().max().clamp_min(1e-300)))
        if not worst <= 1e-12:
            fail(f"9 (f) {label}: the card vs the CPU, rel diff {worst:.3e} "
                 f"> 1e-12")
        phase(f"9 (f) {label} {cpu.geo.cell_shape} f64, 3 steps on the card "
              f"vs the CPU: iterations {its} on both, max rel diff of each "
              f"field's scale {worst:.3e} (tol 1e-12)" + since())
        del cpu, card

    # ---- (g) the CLI with output -----------------------------------------
    with cli_dir() as tmp:
        (out,) = run_clis(cube_cli_jobs(tmp))
        files = sorted(os.listdir(os.path.join(tmp, "cube-out")))
        want = [f"boussinesq_{k:06d}.vts" for k in range(6)]
        if "Geometry               : cuboid" not in out or [
                f for f in files if f.endswith(".vts")] != want \
                or "boussinesq.pvd" not in files:
            fail(f"9 (g) CLI on {CUBE_PRM}: files {files}")
        divs = [ln.strip() for ln in out.splitlines() if "Post-projection" in ln]
        its = [ln.strip() for ln in out.splitlines()
               if "Solver iterations" in ln]
        phase(f"9 (g) CLI on {CUBE_PRM} (its own 16^3) --max-steps 5 with "
              f"output: rc 0, {len(files)} files ({files[0]} .. "
              f"{files[-1]}); last step {its[-1]}; {divs[-1]}" + since())
    phase(f"phase 9 {time.perf_counter() - t0:.1f} s")
    return by_path, replay_by_path, k4_rows, cells


# ---------------------------------------------------------------- phase 10
# (a), (b): mimetic steps through run a case; (d): Poisson CG steps
MIM_STEPS = 3
MG_STEPS = 2
# a profiled step with more CG iterations than this runs with the cap at
# this many, its device ms then the profiled ms an iteration times the
# step's iterations (a 500-iteration step holds ~10^5 kernels, whose
# profile takes minutes to read; the shell's 11-iteration MG-CG step
# holds 51,476, ~20 host s of reading)
PROFILE_ITER_CAP = 4
# (c): the card against the CPU in f64, one step a geometry
MIM_F64_TOL = 1e-12


# (e): the CLI's prm additions
MIM_STAGGERED = ("subsection Numerics\n  set feec formulation = staggered\n"
                 "end\n")
MIM_FIXED = ("subsection Boussinesq Model\n  set adapt time step = false\n"
             "  set time step = 0.01\n  set final time = 10\nend\n")


def mimetic_cli_jobs(tmp):
    """Phase 10 (e)'s first two CLI runs, FEEC_PRM with `feec formulation
    = staggered`: 3 steps without output, and 4 at a fixed dt with a
    checkpoint every step into tmp/mim-a (whose step 2 (e) restarts
    from)."""
    src = os.path.join(HERE, "data", FEEC_PRM)
    return [("10 (e) mimetic", out_prm(tmp, src, os.path.join(tmp, "mim"),
                                       MIM_STAGGERED),
             ["--max-steps", "3", "--no-output"]),
            ("10 (e) a", out_prm(tmp, src, os.path.join(tmp, "mim-a"),
                                 MIM_STAGGERED + MIM_FIXED),
             ["--max-steps", "4", "--checkpoint-every", "1"])]


def mimetic(params):
    """`params` with `use FEEC solver = true` and `feec formulation =
    staggered` (the mimetic C-grid model), run without end."""
    params.use_FEEC_solver = True
    params.numerics.feec_formulation = "staggered"
    params.final_time = 1e9
    return params


def recording_steps(model):
    """Wrap the model's step and step_strong (what run calls) so that each
    call is kept as (its name, its diagnostics): returns that list."""
    calls = []
    for name in ("step", "step_strong"):
        orig = getattr(model, name)

        def wrapped(s, dt, orig=orig, name=name):
            out = orig(s, dt)
            calls.append((name, out[1]))
            return out
        setattr(model, name, wrapped)
    return calls


def krylov_run(label, m, s0, n, want, div_tol=1e-4, tag="10"):
    """n steps of a model whose step runs a Krylov loop (the mimetic
    momentum CG, the Poisson CG of `poisson solver = cg | mg`) through
    run from s0: the first step's host syncs counted (a run of one step),
    then the n steps with the wrapper launches counted from 0 (``want``:
    the expected counts of a list of step calls, (name, diagnostics)),
    finite fields, max|div u| <= div_tol after every step (None: recorded
    only); then one more
    ``step`` under torch.profiler (the CG cap at PROFILE_ITER_CAP if the
    steps took more): device ms and kernels a step, busy share, and the
    hand kernels on the device, by name, those ``want`` expects and no
    other. ``tag``: the phase's number in its messages. Returns
    (launches, numbers)."""
    import torch

    dt = m.params.time_step
    calls = recording_steps(m)
    _, n_sync = count_syncs(lambda: m.run(max_steps=1, state=s0))
    m.escalations = 0
    m._strong_steps_left = 0
    del calls[:]
    (s_end, hist), launches, wall = drive(
        m, lambda: m.run(max_steps=n, state=s0))
    if launches != want(calls):
        fail(f"{tag} {label}: launches {launches}, expected {want(calls)}")
    diags = [d for _, d in calls]
    if len(hist) != n:
        fail(f"{tag} {label}: {len(hist)} steps, not {n}")
    for x in (s_end.u, s_end.p, s_end.T) + tuple(s_end.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail(f"{tag} {label}: non-finite fields")
    divs = [h["div_norm"] for h in hist]
    if div_tol is not None and not max(divs) <= div_tol:
        fail(f"{tag} {label}: max|div u| per step {divs} > {div_tol}")
    helm = [int(d.helmholtz_iters[0]) for d in diags]
    pois = [d.poisson_iters for d in diags]
    cap = m.params.numerics.max_cg_iters
    capped = max(helm + pois) > PROFILE_ITER_CAP
    if capped:
        m.params.numerics.max_cg_iters = PROFILE_ITER_CAP
    n_calls = len(calls)
    prof = step_profile(lambda: m.step(s_end, dt)[1].cfl, 1)
    m.params.numerics.max_cg_iters = cap
    d_prof = calls[n_calls:]
    its_prof = max(int(d_prof[-1][1].helmholtz_iters[0]),
                   d_prof[-1][1].poisson_iters, 1)
    its_run = sum(max(h, p_) for h, p_ in zip(helm, pois)) / n_calls
    dev_ms = (prof["device_ms_per_step"] / its_prof * its_run if capped
              else prof["device_ms_per_step"])
    # every hand kernel exactly as the wrappers counted the profiled step
    # call (profiled's lead kernels take the loss of a long eager
    # window's first device records)
    want_prof = {**{k: 0 for k in prof["counts"]}, **want(d_prof)}
    got = prof["counts"]
    if got != want_prof:
        fail(f"{tag} {label}: the profiled step ran the hand kernels "
             f"{got} on the device, expected {want_prof}")
    nums = dict(steps=n, step_calls=n_calls, escalations=m.escalations,
                helmholtz_iters=helm, poisson_iters=pois,
                temperature_iters=[d.temperature_iters for d in diags],
                gate=[d.solver_ok for d in diags], div=divs,
                host_syncs_step1=n_sync, host_ms_per_step=wall / n * 1e3,
                device_ms_per_step=dev_ms,
                profiled_iterations=its_prof, profile_capped=capped,
                kernels_per_step=prof["kernels_per_step"],
                host_launches_per_step=prof["host_launches_per_step"],
                busy=prof["busy_share"],
                k4_ms_per_step=(prof["kernel_ms_per_step"].get("tridiag", 0.0)
                                / its_prof * its_run if capped else
                                prof["kernel_ms_per_step"].get("tridiag",
                                                               0.0)),
                profiled_counts=prof["counts"])
    phase(f"{tag} {label} {m.geo.cell_shape} f32 (1/Re {m.one_over_Re:.3e}, dt "
          f"{dt}): {n} steps through run, {n_calls} step calls, "
          f"{m.escalations} escalation(s), CG iterations helmholtz {helm} "
          f"poisson {pois}, temperature {nums['temperature_iters']}, gate "
          f"{nums['gate']}, max|div u| per step "
          f"{[float(f'{x:.3e}') for x in divs]}; launches {launches}; "
          f"{n_sync} host syncs in step 1; host {nums['host_ms_per_step']:.2f}"
          f" ms/step; device {dev_ms:.3f} ms/step (profiled step "
          f"{its_prof} iterations{', capped' if capped else ''}: "
          f"{prof['device_ms_per_step']:.3f} ms in "
          f"{prof['kernels_per_step']:.0f} kernels, "
          f"{prof['host_launches_per_step']:.0f} host launches, busy share "
          f"{prof['busy_share']:.3f}, hand kernels {prof['counts']})")
    return launches, nums


def k4_per_step(per_call):
    """want() of krylov_run: K4 ``per_call(diagnostics)`` times a step
    call, no other hand kernel."""
    return lambda calls: {"tridiag": sum(per_call(d) for _, d in calls)}


def check_mg_k4(dev, geo, p_specs):
    """(d): K4 on the MG line smoother's operands at level 0 of the shell
    at BENCH_SHAPE, f32 and f64, as PoissonMultigrid.line_operands passes
    them (the contiguous radial lines, the periodic lon lines' 2-rhs
    pair, and the lat lines, whose residual is a moved-axis view: a
    hierarchy relaxing along lat only), against the plain version
    (rtol = atol = 1e-5 x scale f32, 1e-12 x scale f64; NaN in lower[0]
    and upper[n-1]; the operands unchanged), the layout (nothing
    copied), one launch's mean time over 50 calls, the plain version's
    and the bound; the launches of one V-cycle. Returns {dtype: {kind:
    numbers}} and the V-cycle's launches."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.ops import tridiag as k4
    from dycoreplanet_tpu_torch.solvers.multigrid import PoissonMultigrid

    rows, per_cycle = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        f32 = dtype == torch.float32
        tk = k4.TridiagSolve()
        mg = PoissonMultigrid(geo, p_specs, dtype=np.dtype(name), device=dev,
                              tridiag=tk)
        mg_lat = PoissonMultigrid(geo, p_specs, dtype=np.dtype(name),
                                  device=dev, tridiag=tk,
                                  line_axes_allowed=(1,))
        if mg_lat.line_axes != [1]:
            fail(f"10 (d) K4: the lat-only hierarchy relaxes along "
                 f"{mg_lat.line_axes}")
        gen = torch.Generator(device=dev).manual_seed(15)
        r = torch.randn(geo.cell_shape, generator=gen, device=dev,
                        dtype=dtype)
        kinds = [(f"axis {a} "
                  f"({'lon, periodic 2-rhs' if mg.specs[a] is None else 'r'})",
                  mg, a) for a in mg.line_axes]
        kinds.append(("axis 1 (lat, moved view)", mg_lat, 1))
        rows[name] = {}
        for kind, m_, axis in kinds:
            ops = m_.line_operands(0, axis, r)
            lay = k4.layout(*ops, pair=tk.pair)
            if lay.copied:
                fail(f"10 (d) K4 MG {kind} {name}: copied {lay.copied}")
            want = tk.plain(*ops)
            sc = float(want.abs().max())
            tol = (1e-5 if f32 else 1e-12) * sc
            tk.copies = 0
            err = check_k4(f"K4 tridiag MG {kind} ({name})", tk, ops, want,
                           tol)
            ms = time_ms(lambda: tk(*ops))
            pms = time_ms(lambda: tk.plain(*ops), reps=10)
            moved = k4.values_moved(*ops)
            b_ms, b_by = bound_of(ops[3].element_size() * moved,
                                  k4.OPS_PER_VALUE * ops[3].numel())
            phase(f"10 (d) K4 tridiag, MG line layout {kind} {name}: rhs "
                  f"{tuple(ops[3].shape)} strides {tuple(ops[3].stride())}, "
                  f"lower {tuple(ops[0].shape)} strides "
                  f"{tuple(ops[0].stride())}, columns "
                  f"{[size for size, _ in lay.axes]}, pair axis "
                  f"{lay.pair_axis}, {tk.plan(lay, dev)[0]} threads a block, "
                  f"staged {tk.plan(lay, dev)[1]}: 0 operands copied, max abs "
                  f"err {err:.3e} (tol {tol:.3e}), operands unchanged; "
                  f"kernel {ms:.4f} ms, plain {pms:.3f} ms, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}; {moved} values moved)")
            rows[name][kind] = dict(max_abs_err=err, tol=tol, ms=ms,
                                    plain_ms=pms, bound_ms=b_ms,
                                    bound_by=b_by, values_moved=moved,
                                    copies=0)
        tk.launches = tk.copies = 0
        mg(r)
        torch.cuda.synchronize()
        if (tk.launches, tk.copies) != (mg.line_solves_per_cycle(), 0):
            fail(f"10 (d) K4 MG {name}: one V-cycle {tk.launches} launches, "
                 f"{tk.copies} copies (expected {mg.line_solves_per_cycle()}"
                 f", 0)")
        per_cycle[name] = tk.launches
        phase(f"10 (d) one V-cycle {name}: {len(mg.geos)} levels "
              f"{[g.cell_shape for g in mg.geos]}, line axes {mg.line_axes}: "
              f"{tk.launches} K4 launches, 0 copies")
    return rows, per_cycle


def mimetic_phases(dev):
    """Phase 10, the mimetic (staggered C-grid) personality (plain
    PyTorch, as jnp in the JAX package, K4 only on the direct temperature
    solve) and `poisson solver = cg | mg` (K4 in the multigrid line
    smoother's layout): (a) the mimetic shell at BENCH_SHAPE, FEEC_PRM's
    physics, default and direct paths, then the flagship's; (b) the
    mimetic 128^3 box, annulus at refinement 8 and 256 x 1024 slab; (c)
    one mimetic step a geometry in f64 on the card against the CPU; (d)
    mg and cg on the shell at BENCH_SHAPE with the bench opt-ins, K4 in
    the MG layout, mg on the annulus and the box; (e) the CLI on FEEC_PRM
    with `feec formulation = staggered`, and a restart. Returns (run
    launches by path, K4 MG rows, numbers)."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.models import make_model
    from dycoreplanet_tpu_torch.models.convert import (
        state_from_numpy, state_to_numpy)
    from dycoreplanet_tpu_torch.models.mimetic import MimeticBoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import stencil as st

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    by_path, cells = {}, {}

    # ---- (a) the mimetic shell at the bench shape ------------------------
    for key, label, params, per_call in (
            ("mimetic_shell", "(a) mimetic shell, FEEC prm",
             feec_params(BENCH_SHAPE), lambda d: 0),
            ("mimetic_shell_direct", "(a) mimetic shell direct, FEEC prm",
             direct_params(feec_params(BENCH_SHAPE)), lambda d: 1),
            ("mimetic_shell_flagship", "(a) mimetic shell, flagship",
             bench_params(BENCH_SHAPE), lambda d: 0)):
        m = make_model(mimetic(params), device=dev)
        if (not isinstance(m, MimeticBoussinesqModel)
                or set(m.kernels()) != {"tridiag"}):
            fail(f"10 {label}: {type(m).__name__}, kernels "
                 f"{list(m.kernels())}")
        s0 = seed_developed_flow(m)
        by_path[key], cells[key] = krylov_run(
            label, m, s0, MIM_STEPS, k4_per_step(per_call))
        phase(f"10 {label} done" + since())
        del m, s0

    # ---- (b) the box, the annulus and the slab ---------------------------
    # the slab from the state after its first step, held to 1e-3: the
    # mimetic projection is the fast solve alone (no spot-check, no CG
    # repair), and Cuboid2DPoissonFastDiag's f32 round-off at 256 x 1024
    # is ~1e-4 of |b| (ROADMAP Queue 3); its first step from rest leaves
    # 3.0e-3 on an NVIDIA H100 80GB HBM3 at 700 W
    for key, label, params, skip, div_tol in (
            ("mimetic_box", "(b) mimetic box", cube_params(CUBE_STD_REF), 0,
             1e-4),
            ("mimetic_annulus", "(b) mimetic annulus", annulus_params(), 0,
             1e-4),
            ("mimetic_slab", "(b) mimetic slab", slab_params(), 1, 1e-3)):
        m = make_model(mimetic(params), device=dev)
        s0 = m.initial_state()
        for _ in range(skip):
            s0, d0 = m.step(s0, m.params.time_step)
            phase(f"10 {label}: the first step from rest, max|div u| "
                  f"{d0.div_norm:.3e}")
        by_path[key], cells[key] = krylov_run(
            label, m, s0, MIM_STEPS, k4_per_step(lambda d: 0), div_tol)
        phase(f"10 {label} done" + since())
        del m, s0

    # ---- (c) the card against the CPU, f64 -------------------------------
    for label, params in (
            ("shell", lambda: feec_params(FEEC_SMALL, "float64")),
            ("shell direct", lambda: direct_params(
                feec_params(FEEC_SMALL, "float64"))),
            ("box", lambda: cube_params(CUBE_SMALL_REF, "float64")),
            ("annulus", lambda: annulus_params("float64", refinement=4)),
            ("slab", lambda: slab_params((16, 64), "float64"))):
        cpu = make_model(mimetic(params()), device="cpu")
        card = make_model(mimetic(params()), device=dev)
        if cpu.geo.kind == "shell":
            s_cpu = seed_developed_flow(cpu)
        else:
            s_cpu = cpu.initial_state()
            for _ in range(2):
                s_cpu, _ = cpu.step(s_cpu, cpu.params.time_step)
        s_card = state_from_numpy(card, *state_to_numpy(s_cpu))
        dt = cpu.params.time_step
        c1, dc = cpu.step(s_cpu, dt)
        g1, dg = card.step(s_card, dt)
        u_scale = float(c1.u.abs().max())
        worst = {}
        for name, x, y in zip(("u", "p", "T") + tuple(
                f"uf{i}" for i in range(len(c1.u_faces))),
                (g1.u, g1.p, g1.T) + tuple(g1.u_faces),
                (c1.u, c1.p, c1.T) + tuple(c1.u_faces)):
            scale = float(y.abs().max()) if name in ("p", "T") else u_scale
            worst[name] = float((x.cpu() - y).abs().max()) / max(scale, 1e-300)
        its = (dg.helmholtz_iters.tolist(), dg.poisson_iters)
        if (its != (dc.helmholtz_iters.tolist(), dc.poisson_iters)
                or max(worst.values()) > MIM_F64_TOL):
            fail(f"10 (c) {label} {cpu.geo.cell_shape} f64: the card's step "
                 f"(iterations {its}) vs the CPU's "
                 f"({dc.helmholtz_iters.tolist()}, {dc.poisson_iters}): rel "
                 f"diff {worst} (tol {MIM_F64_TOL})")
        phase(f"10 (c) mimetic {label} {cpu.geo.cell_shape} f64, one step on "
              f"the card vs the CPU from the same state: CG iterations "
              f"{its[0]} on both, max rel diff (u and the faces to max|u|, "
              f"p and T to their own) "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + f" (tol {MIM_F64_TOL})" + since())
        del cpu, card

    # ---- (d) poisson solver = mg and cg ----------------------------------
    # Jacobi-CG in f32 at this size stalls at `max cg iters` (500) every
    # step, short of max(poisson tol, 16 eps) = 1.9e-6, in the JAX model
    # too (ROADMAP Queue 3: both packages on the CPU), leaving max|div
    # u| 5.1e-4 after step 1: so the cg path's gate, escalation and
    # divergence are recorded, not held; the mg path (what keeps f32 CG
    # out of that regime) is held to its gate, 1e-4 and phi's residual
    models = {}
    for solver in ("mg", "cg"):
        params = bench_params(BENCH_SHAPE)
        params.numerics.poisson_solver = solver
        m = make_model(params, device=dev)
        if m.poisson_spectral is not None or (
                (m.poisson_precond is not None) != (solver == "mg")):
            fail(f"10 (d) {solver}: the Poisson strategy was not built")
        mg = m.poisson_precond
        per_cycle = mg.line_solves_per_cycle() if mg is not None else 0
        s0 = seed_developed_flow(m)
        key = f"poisson_{solver}_shell"

        def want(calls, per_cycle=per_cycle):
            # K2 and K5 every step; K1 on a fast step, K3 on a strong
            # one (escalated); K4 a V-cycle an application of the
            # preconditioner: once before CG's loop and once an iteration
            fast = sum(name == "step" for name, _ in calls)
            return {"forcing": len(calls), "richardson": fast,
                    "faces_div": len(calls) - fast, "correct": len(calls),
                    "tridiag": sum(per_cycle * (d.poisson_iters + 1)
                                   for _, d in calls)}
        by_path[key], cells[key] = krylov_run(
            f"(d) shell poisson solver = {solver}", m, s0, MG_STEPS, want,
            1e-4 if solver == "mg" else None)
        if solver == "mg" and not all(cells[key]["gate"]):
            fail(f"10 (d) {solver}: the gate {cells[key]['gate']}")
        models[solver] = m
        phase(f"10 (d) {solver} done" + since())
    m_mg = models["mg"]
    # phi against the fast diagonalization's on the same right-hand side
    # (the seeded flow's projection right-hand side): MG-CG's mean-free
    # distance held to the CG's rtol max(poisson tol, 16 eps); the true
    # relative residuals (evaluated in f64) recorded: f32's floor on this
    # nearly divergence-free right-hand side, ~1e-5 of |b| for the fast
    # solve too (on the CPU at 16x64x128)
    fd = make_model(bench_params(BENCH_SHAPE), device=dev)
    s0 = seed_developed_flow(fd)
    rhs = -fd._vol_t * st.divergence(fd.geo, list(s0.u_faces)) / BENCH_DT
    rhs = rhs - rhs.mean()
    phi_fd = fd.poisson_spectral.solve(rhs)[0]
    rhs64 = rhs.double()

    def true_res(phi):
        r = -st.weak_laplacian(fd.geo, phi.double(), fd.p_specs) - rhs64
        return float(r.norm() / rhs64.norm())

    def mean_free(phi):
        return phi - st.volume_mean(fd.geo, phi)

    tol = max(m_mg.params.numerics.poisson_tol,
              16 * float(torch.finfo(torch.float32).eps))
    phi_rows = {}
    for solver, m in models.items():
        phi, its, rn, ok = m._solve_pressure_poisson(rhs)
        dist = float((mean_free(phi) - mean_free(phi_fd)).norm()
                     / mean_free(phi_fd).norm())
        phi_rows[solver] = dict(iterations=its, residual=true_res(phi),
                                converged=bool(ok), distance=dist)
    if not (phi_rows["mg"]["converged"]
            and phi_rows["mg"]["distance"] <= tol):
        fail(f"10 (d) mg: phi {phi_rows['mg']} against the fast "
             f"diagonalization's (tol {tol:.3e})")
    res_fd = true_res(phi_fd)
    phase(f"10 (d) phi on the seeded flow's projection rhs {BENCH_SHAPE} f32 "
          f"(poisson tol {m_mg.params.numerics.poisson_tol}, CG rtol "
          f"{tol:.3e}): MG-CG {phi_rows['mg']['iterations']} iterations "
          f"(converged {phi_rows['mg']['converged']}), Jacobi-CG "
          f"{phi_rows['cg']['iterations']} (converged "
          f"{phi_rows['cg']['converged']}); |phi - phi_fd| / |phi_fd| "
          f"(mean-free) MG {phi_rows['mg']['distance']:.3e} (tol "
          f"{tol:.3e}), CG {phi_rows['cg']['distance']:.3e}; true relative "
          f"residual (f64) MG {phi_rows['mg']['residual']:.3e}, CG "
          f"{phi_rows['cg']['residual']:.3e}, fast diagonalization "
          f"{res_fd:.3e}" + since())
    cells["phi"] = dict(phi_rows, fastdiag_residual=res_fd)
    del fd, models, m, s0
    k4_rows, per_cycle = check_mg_k4(dev, m_mg.geo, m_mg.p_specs)
    mg_cell = cells["poisson_mg_shell"]
    k4_step = by_path["poisson_mg_shell"]["tridiag"] / MG_STEPS
    phase(f"10 (d) K4 on the mg path: {per_cycle['float32']} launches a "
          f"V-cycle, {k4_step:.0f} a step ({MG_STEPS} steps), "
          f"{mg_cell['k4_ms_per_step']:.3f} device ms a step in K4 "
          f"({mg_cell['k4_ms_per_step'] / max(k4_step, 1):.4f} ms a launch "
          f"in the step)" + since())
    del m_mg

    # the annulus (its periodic phi lines) at refinement 6 (64 x 768) and
    # the box (Jacobi smoother) at 64^3: at 256 x 3072 and 128^3 they took
    # 1.26 and 0.49 s a step on the host, 34 s of the phase, on an NVIDIA
    # H100 80GB HBM3 at 700 W
    for key, label, params, smoother in (
            ("poisson_mg_annulus", "(d) annulus poisson solver = mg",
             annulus_params(refinement=6, poisson_solver="mg"), "line"),
            ("poisson_mg_box", "(d) box poisson solver = mg",
             cube_params(CUBE_SCHUR_REF, feec=False, poisson_solver="mg"),
             "jacobi")):
        params.final_time = 1e9
        m = make_model(params, device=dev)
        mg = m.poisson_precond
        if mg.smoother != smoother:
            fail(f"10 {label}: smoother {mg.smoother}")
        per_cycle_m = mg.line_solves_per_cycle()
        by_path[key], cells[key] = krylov_run(
            label, m, m.initial_state(), 2,
            k4_per_step(lambda d, c=per_cycle_m: c * (d.poisson_iters + 1)))
        cells[key]["k4_per_cycle"] = per_cycle_m
        phase(f"10 {label}: {len(mg.geos)} levels, line axes "
              f"{mg.line_axes}, {per_cycle_m} K4 launches a V-cycle" + since())
        del m

    # ---- (e) the CLI ------------------------------------------------------
    with cli_dir() as tmp:
        src = os.path.join(HERE, "data", FEEC_PRM)
        d = {k: os.path.join(tmp, f"mim-{k}") for k in "ab"}
        ck = lambda k, n: os.path.join(d[k], f"boussinesq_ckpt_{n:06d}.npz")
        # the first two side by side
        out, _ = run_clis(mimetic_cli_jobs(tmp))
        if "Formulation            : FEEC mimetic (staggered C-grid)" \
                not in out:
            fail("10 (e) CLI: no mimetic personality line")
        divs = [ln.strip() for ln in out.splitlines() if "Post-projection" in ln]
        out_b = run_cli("10 (e) b", out_prm(tmp, src, d["b"],
                                            MIM_STAGGERED + MIM_FIXED),
                        ["--restart", ck("a", 2), "--max-steps", "2",
                         "--checkpoint-every", "1"])
        if f"Restarted from {ck('a', 2)} at step 2" not in out_b:
            fail("10 (e) b: no restart line")
        with np.load(ck("a", 4)) as za, np.load(ck("b", 2)) as zb:
            bad = [k for k in za.files
                   if za[k].dtype != zb[k].dtype
                   or za[k].tobytes() != zb[k].tobytes()]
            if sorted(za.files) != sorted(zb.files) or bad:
                fail(f"10 (e) b: the restarted ckpt_000002 differs from "
                     f"(a)'s ckpt_000004 in {bad}")
        n_vts = len([f for f in os.listdir(d["a"]) if f.endswith(".vts")])
        phase(f"10 (e) CLI on {FEEC_PRM} with `feec formulation = "
              f"staggered` (its own 8x16x32): --max-steps 3 --no-output rc 0, "
              f"the personality line; last {divs[-1] if divs else '?'}; with "
              f"output and --checkpoint-every 1 at dt 0.01: {n_vts} .vts; a "
              f"restart from its ckpt_000002, 2 steps: ckpt_000002 is the "
              f"uninterrupted run's ckpt_000004 bitwise" + since())
    phase(f"phase 10 {time.perf_counter() - t0:.1f} s")
    return by_path, k4_rows, per_cycle, cells


# ---------------------------------------------------------------- phase 11
# (a): K4 in the layouts of the three remaining Poisson solvers, at the
# flagship's shell and the annulus prm's work size, and the solves whole
SOLVER_K4 = {"ShellPoissonDirect": "the lat eigentransform's real and "
             "imaginary parts on axis 2 as the pair axis, (nr, nlat, 2, "
             "nm); diag (nr, nlat, 1, nm); lower and upper (nr, 1, 1, 1)",
             "ShellPoissonSpectral": "the radial lines of the spectral "
             "CG's preconditioner, rhs and diag (nr, nlat, 2nm), lower and "
             "upper (nr, nlat, 1) broadcasts; no pair axis",
             "AnnulusPoissonDirect": "torch.view_as_real of the rfft over "
             "phi, (nr, nphi/2+1, 2), the trailing 2 the pair axis; diag "
             "(nr, nphi/2+1, 1); lower and upper (nr, 1, 1): one launch "
             "where the JAX package makes two"}
SOLVER_LINES = {"ShellPoissonDirect": "dycoreplanet_tpu/solvers/"
                "spectral.py:498-511", "ShellPoissonSpectral":
                "dycoreplanet_tpu/solvers/spectral.py:428-430",
                "AnnulusPoissonDirect": "dycoreplanet_tpu/solvers/"
                "spectral.py:281-289"}
# the spectral CG at work size: its factory's rtol (1e-7, f32 clamps it
# to 16 eps) with room past the factory's cap of 120 (one more solve at
# the factory's own settings records where that cap leaves it)
SPECTRAL_MAXITER = 400
# (d): the bench model on a shell of non-uniform radial spacing (its
# spectral CG at `poisson tol` and `max cg iters`, as the model passes
# them)
STRETCHED_STEPS = 5
# (b): the 2D SL paths; (c): Richardson momentum beside CG temperature
SL2D_F64_TOL = 1e-12
RICH_CG_STEPS = 5


def solver_geometry(name, small=False):
    """The geometry of a solver's check: the flagship's shell (32 x 128 x
    256; for ShellPoissonSpectral, the solve the factory builds on a
    shell of non-uniform radial spacing, that shell with its radial faces
    stretched, presets.stretched_shell) or ANNULUS_PRM's annulus at
    ANNULUS_REFINEMENT (256 x 3072); with ``small`` 8 x 16 x 32 and
    refinement 4 (16 x 192)."""
    from dycoreplanet_tpu_torch.grid.factory import make_geometry, make_shell
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_SHAPE, stretched_shell)

    shape = FEEC_SMALL if small else BENCH_SHAPE
    if name == "ShellPoissonSpectral":
        return stretched_shell(shape)
    if name.startswith("Shell"):
        return make_shell(*shape, 1.0, 3.0)
    return make_geometry(annulus_params(
        refinement=4 if small else ANNULUS_REFINEMENT))


def p_specs_of(geo):
    from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
    neu = BCSpec(BC.NEUMANN, BC.NEUMANN)
    return ([neu, BCSpec(BC.POLE, BC.POLE), None] if geo.kind == "shell"
            else [neu, None])


def make_solver(name, geo, dtype, dev, **kw):
    import numpy as np
    from dycoreplanet_tpu_torch.solvers import spectral

    return getattr(spectral, name)(geo, dtype=np.dtype(dtype), device=dev,
                                   **kw)


def seeded_rhs(geo, dtype, dev, seed=16, on_cpu=False):
    """A seeded mean-free right-hand side on dev, drawn there (or with
    ``on_cpu`` drawn by the CPU's generator, then moved: the same values
    as on a machine without a card)."""
    import torch
    at = "cpu" if on_cpu else dev
    gen = torch.Generator(device=at).manual_seed(seed)
    b = torch.randn(geo.cell_shape, generator=gen, device=at, dtype=dtype)
    return (b - b.mean()).to(dev)


def check_solver_k4(dev):
    """(a): for each of the three solvers at work size, f32 and f64: K4 on
    the operands the solver passes (its ``systems`` / ``line_operands``),
    against its plain version (rtol = atol = 1e-5 x scale, f64 1e-12 x
    scale; NaN in lower[0] and upper[n-1]; the operands unchanged) and,
    both, against the f64 solution of the same systems (the kernel's
    error at most twice the plain version's plus that tolerance), none
    copied, the pair axis where the real and imaginary parts share their
    coefficients; the wrapper's and the plain version's times and the
    bound of the operands as passed; then one solve through the solver's
    entry point with the launches counted from 0 (1 for a direct solve,
    the CG iterations + 1 for the spectral CG), no copy, and the solve's
    true relative residual |-L x - b| / |b| (in f64): <= 1e-10 in f64
    (the spectral CG: 10 x its rtol), recorded and held to 1e-3 in f32.
    The spectral CG runs on the stretched shell (solver_geometry) with
    its cap at SPECTRAL_MAXITER, and once more in f32 as
    make_poisson_solver builds it by default (rtol 1e-7, cap 120; the
    model passes its `poisson tol` and `max cg iters` instead, (d)): its
    iterations, whether it stopped at the cap, its true residual and its
    host ms a solve. Then each solver in f64 on the card against the same solver
    on the CPU at 8 x 16 x 32 / 16 x 192 (the right-hand side drawn on
    the CPU), within 1e-12 of |x|, the spectral CG at rtol 1e-11 with
    equal iterations. Returns {solver: {dtype: numbers}}."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.ops import stencil as st
    from dycoreplanet_tpu_torch.ops import tridiag as k4
    from dycoreplanet_tpu_torch.solvers.spectral import make_poisson_solver

    rows = {}
    for name in SOLVER_K4:
        geo = solver_geometry(name)
        spectral_cg = name == "ShellPoissonSpectral"
        rows[name] = {}
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            f32 = dtype == torch.float32
            kw = {"maxiter": SPECTRAL_MAXITER} if spectral_cg else {}
            solver = make_solver(name, geo, dname, dev, **kw)
            tk = solver.tridiag
            b = seeded_rhs(geo, dtype, dev)
            if spectral_cg:
                nr, nlat, _ = geo.cell_shape
                gen = torch.Generator(device=dev).manual_seed(17)
                r = torch.randn((nr, nlat, 2 * solver.nm), generator=gen,
                                device=dev, dtype=dtype)
                sys4 = solver.line_operands(r)
            else:
                sys4 = solver.systems(b)
            lay = k4.layout(*sys4, pair=tk.pair)
            want_pair = 1 if spectral_cg else 2
            if (lay.copied or lay.pair != want_pair
                    or lay.row_coefficients == spectral_cg):
                fail(f"11 (a) K4 {name} {dname}: layout copies "
                     f"{lay.copied}, pair {lay.pair} (expected "
                     f"{want_pair}), row coefficients "
                     f"{lay.row_coefficients}")
            w4 = tk.plain(*sys4)
            sc = float(w4.abs().max())
            tol = (1e-5 if f32 else 1e-12) * sc
            err = check_k4(f"11 (a) K4 tridiag {name} ({dname})", tk, sys4,
                           w4, tol)
            # against the f64 solution of the same systems: the kernel's
            # error at most twice the plain version's plus the tolerance
            # above (the annulus's pinned k = 0 mode leaves ~1e-4 of the
            # scale to f32 in both)
            w64 = tk.plain(*(a.double() for a in sys4))
            e_k = float((tk(*sys4).double() - w64).abs().max())
            e_p = float((w4.double() - w64).abs().max())
            if not e_k <= 2 * e_p + tol:
                fail(f"11 (a) K4 {name} {dname}: error against the f64 "
                     f"solution {e_k:.3e}, the plain version's {e_p:.3e}")
            ms = time_ms(lambda: tk(*sys4))
            pms = time_ms(lambda: tk.plain(*sys4))
            moved = k4.values_moved(*sys4)
            b_ms, b_by = bound_of(sys4[3].element_size() * moved,
                                  k4.OPS_PER_VALUE * sys4[3].numel())
            # the whole solve through its entry point
            tk.launches = tk.copies = 0
            x, its = solver.solve(b)
            torch.cuda.synchronize()
            want_l = its + 1 if spectral_cg else 1
            launches = tk.launches
            if (launches, tk.copies) != (want_l, 0):
                fail(f"11 (a) {name} {dname}: {launches} launches, "
                     f"{tk.copies} copies in one solve ({its} CG "
                     f"iterations; expected {want_l}, 0)")
            b64 = b.double()

            def true_res(x):
                return float((-st.weak_laplacian(geo, x.double(),
                                                 p_specs_of(geo))
                              - b64).norm() / b64.norm())
            res = true_res(x)
            res_tol = (1e-3 if f32 else 10 * solver.rtol if spectral_cg
                       else 1e-10)
            if not (bool(torch.isfinite(x).all()) and res <= res_tol):
                fail(f"11 (a) {name} {dname}: the solve's true relative "
                     f"residual {res:.3e} > {res_tol} ({its} iterations)")
            factory = None
            if spectral_cg and f32:
                # the solve as the factory builds it by default (rtol
                # 1e-7, cap 120)
                fs = make_poisson_solver(geo, dtype=np.float32, device=dev)
                if not isinstance(fs, type(solver)):
                    fail(f"11 (a) the factory built {type(fs).__name__} on "
                         f"the stretched shell")
                fs.solve(b)
                torch.cuda.synchronize()
                fs.tridiag.launches = 0
                t1 = time.perf_counter()
                xf, itf = fs.solve(b)
                torch.cuda.synchronize()
                f_ms = (time.perf_counter() - t1) * 1e3
                if (not bool(torch.isfinite(xf).all())
                        or fs.tridiag.launches != itf + 1):
                    fail(f"11 (a) ShellPoissonSpectral at the factory's "
                         f"settings: {fs.tridiag.launches} launches in "
                         f"{itf} iterations, or a non-finite solution")
                factory = dict(rtol=fs.rtol, maxiter=fs.maxiter,
                               iterations=itf, at_cap=itf >= fs.maxiter,
                               residual=true_res(xf), host_ms=f_ms)
                phase(f"11 (a) {name} {geo.cell_shape} f32 as "
                      f"make_poisson_solver builds it by default (rtol "
                      f"{fs.rtol}, cap "
                      f"{fs.maxiter}): {itf} CG iterations"
                      f"{' (stopped at its cap)' if factory['at_cap'] else ''}"
                      f", true relative residual {factory['residual']:.3e} "
                      f"(with the cap at {SPECTRAL_MAXITER}: {its} "
                      f"iterations, {res:.3e}), host {f_ms:.2f} ms a solve")
                del fs, xf
            cols = [size for size, _ in lay.axes]
            phase(f"11 (a) K4 tridiag, {name}'s layout {geo.cell_shape} "
                  f"{dname} (n {sys4[3].shape[0]}, batch axes {cols}, pair "
                  f"axis {lay.pair_axis}, {tk.plan(lay, dev)[0]} threads a "
                  f"block): 0 operands copied, max abs err {err:.3e} (tol "
                  f"{tol:.3e}), against the f64 solution {e_k:.3e} (the "
                  f"plain version's {e_p:.3e}), kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, "
                  f"bound {b_ms * 1e3:.2f} us ({b_by}; {moved} values "
                  f"moved); one solve: {its} CG iterations, {launches} "
                  f"launch(es), 0 copies, true relative residual {res:.3e}")
            rows[name][dname] = dict(
                max_abs_err=err, tol=tol, err_vs_f64=e_k,
                plain_err_vs_f64=e_p, ms=ms, plain_ms=pms,
                bound_ms=b_ms, bound_by=b_by, launches=launches,
                copies=tk.copies, iterations=its, residual=res,
                n=sys4[3].shape[0], columns=cols, pair_axis=lay.pair_axis,
                **({"factory_solve": factory} if factory else {}))
            del solver, sys4, w4, x
        # f64: the card against the CPU at the small size
        small = solver_geometry(name, small=True)
        kw = {"rtol": 1e-11, "maxiter": 300} if spectral_cg else {}
        # drawn on the CPU, and a draw whose CG count at rtol 1e-11 on the
        # stretched shell does not move with the order of CG's dot
        # products' sums (tests/test_torch_spectral_direct.py
        # test_card_check_count_is_order_free): equal counts on the card
        # and the CPU then hold the card's arithmetic, not the order of
        # its reductions
        b = seeded_rhs(small, torch.float64, dev, seed=19, on_cpu=True)
        xg, ig = make_solver(name, small, "float64", dev, **kw).solve(b)
        xc, ic = make_solver(name, small, "float64", "cpu", **kw).solve(
            b.cpu())
        rel = float((xg.cpu() - xc).abs().max() / xc.abs().max())
        if ig != ic or not rel <= 1e-12:
            fail(f"11 (a) {name} f64 {small.cell_shape}: the card ({ig} "
                 f"iterations) vs the CPU ({ic}): rel diff {rel:.3e} > "
                 f"1e-12")
        phase(f"11 (a) {name} f64 {small.cell_shape}: the card vs the CPU, "
              f"{ig} iterations on both, max |x_card - x_cpu| / |x| "
              f"{rel:.3e} (tol 1e-12)")
        rows[name]["card_vs_cpu"] = dict(iterations=ig, rel_diff=rel)
    return rows


def card_vs_cpu_step(label, dev, make, state_of):
    """One f64 step on the card against the same step on the CPU from the
    same state (``make(device)`` builds the model, ``state_of(model)``
    the state): equal iteration counts and verdicts, every field within
    SL2D_F64_TOL of its scale. Returns the worst relative difference."""
    from dycoreplanet_tpu_torch.models.convert import (
        state_from_numpy, state_to_numpy)

    cpu, card = make("cpu"), make(dev)
    s_cpu = state_of(cpu)
    s_card = state_from_numpy(card, *state_to_numpy(s_cpu))
    dt = cpu.params.time_step
    c1, dc = cpu.step(s_cpu, dt)
    g1, dg = card.step(s_card, dt)
    worst = 0.0
    for x, y in zip((g1.u, g1.p, g1.T) + tuple(g1.u_faces),
                    (c1.u, c1.p, c1.T) + tuple(c1.u_faces)):
        worst = max(worst, float((x.cpu() - y).abs().max()
                                 / y.abs().max().clamp_min(1e-300)))
    its_g = (dg.helmholtz_iters.tolist(), dg.poisson_iters,
             dg.temperature_iters, dg.solver_ok)
    its_c = (dc.helmholtz_iters.tolist(), dc.poisson_iters,
             dc.temperature_iters, dc.solver_ok)
    if its_g != its_c or not worst <= SL2D_F64_TOL:
        fail(f"11 {label} {cpu.geo.cell_shape} f64: the card's step "
             f"(iterations {its_g}) vs the CPU's ({its_c}): rel diff "
             f"{worst:.3e} (tol {SL2D_F64_TOL})")
    phase(f"11 {label} {cpu.geo.cell_shape} f64, one step on the card vs "
          f"the CPU from the same state: iterations and verdict {its_g} on "
          f"both, max rel diff of each field's scale {worst:.3e} (tol "
          f"{SL2D_F64_TOL})")
    return worst


def remaining_phases(dev):
    """Phase 11, the remaining solvers and transports of one device: (a)
    K4 in the layouts of ShellPoissonDirect, ShellPoissonSpectral and
    AnnulusPoissonDirect (check_solver_k4); (b) the semi-Lagrangian
    transport on the annulus at refinement 8 (256 x 3072; the direct
    path, 20 gated steps through run and as a graph, bitwise, the
    transport once a step) and on the slab at 256 x 1024 (20 gated steps
    through run after its first, escalations counted, its fast chunk as a
    graph bitwise the same steps eagerly), then one f64 step of each on
    the card against the CPU; (c) Richardson momentum beside CG
    temperature on the flagship shell at 32 x 128 x 256 f32 (krylov_run:
    RICH_CG_STEPS steps through run, K2, K3 and K5 once a step and K1
    never, by the wrappers and by the profiler), one f64 step on the card
    against the CPU, and a forced momentum miss (f64) that escalates; (d)
    the bench model on a shell of non-uniform radial spacing
    (stretched_run). Returns (K4 rows by solver, run launches by path,
    replay device kernels by path, numbers)."""
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.graphs import ChunkGraphs
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_SHAPE, bench_params, seed_developed_flow)

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    by_path, replay_by_path, cells = {}, {}, {}

    # ---- (a) K4 in the three solvers' layouts ----------------------------
    k4_rows = check_solver_k4(dev)
    phase("11 (a) done" + since())

    # ---- (b) SL on the annulus and the slab ------------------------------
    am = BoussinesqModel(sl_params(annulus_params(helmholtz_solver="direct")),
                         device=dev)
    if am._semi_lagrangian is None or set(am.kernels()) != {"tridiag"}:
        fail(f"11 (b) annulus SL: kernels {list(am.kernels())}")
    s0 = am.initial_state()
    am.run(max_steps=2, state=s0)
    calls0 = am._semi_lagrangian.calls
    run_out = drive(am, lambda: am.run(max_steps=N_STEPS, state=s0))
    n_sl = am._semi_lagrangian.calls - calls0
    (a_end, a_hist), _, _ = run_out
    check_annulus_run("11 (b) annulus SL direct", am, a_end, a_hist)
    l_r, l_g, ms_r, ms_g, _, _ = graph_vs_run(
        "11 (b) annulus SL direct", am, s0, {"tridiag": 2 * N_STEPS},
        run_out, bitwise=True)
    if n_sl != N_STEPS:
        fail(f"11 (b) annulus SL: {n_sl} transports in {N_STEPS} steps")
    _, d_a = am.step(a_end, am.params.time_step)
    phase(f"11 (b) annulus SL direct {am.geo.cell_shape} f32: {N_STEPS} "
          f"gated steps, 0 escalations, the transport {n_sl} times, "
          f"launches {l_r}, {describe(a_hist, d_a)}; host ms/step run "
          f"{ms_r:.4f}, graph {ms_g:.4f}" + since())
    by_path["annulus_sl_direct"] = l_r
    replay_by_path["annulus_sl_direct_graph"] = l_g
    cells["annulus_sl_direct"] = dict(
        escalations=0, max_div=max(h["div_norm"] for h in a_hist),
        host_ms_run=ms_r, host_ms_graph=ms_g)
    del am, s0, a_end

    # the slab: its first step from rest leaves max|div u| above 1e-4 in
    # f32 (phase 9 (e)); the 20 steps start after it
    sm = BoussinesqModel(sl_params(slab_params()), device=dev)
    s1, h1 = sm.run(max_steps=1)
    sm.escalations = 0
    sm._strong_steps_left = 0
    calls0 = sm._semi_lagrangian.calls
    (e_end, e_hist), e_launches, e_wall = drive(
        sm, lambda: sm.run(max_steps=N_STEPS, state=s1))
    n_sl = sm._semi_lagrangian.calls - calls0
    divs = [h["div_norm"] for h in e_hist]
    if len(e_hist) != N_STEPS or not max(divs) <= 1e-4 or n_sl < N_STEPS:
        fail(f"11 (b) slab SL: {len(e_hist)} steps, max|div u| "
             f"{max(divs):.3e} (tol 1e-4), {n_sl} transports")
    for x in (e_end.u, e_end.p, e_end.T) + tuple(e_end.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail("11 (b) slab SL: non-finite fields")
    esc = sm.escalations
    sm.escalations = 0
    sm._strong_steps_left = 0
    dt = sm.params.time_step
    sm.chunk_graphs = ChunkGraphs(sm)
    sm.chunk_graphs.run(s1, dt, N_STEPS, True)          # capture, replay
    (s_gf, rows_gf, _), l_gf = replay_launches(
        "11 (b) slab SL fast chunk", sm,
        lambda: sm.chunk_graphs.run(s1, dt, N_STEPS, True), {})
    s_ef, rows_ef, _ = sm._chunk(s1, dt, N_STEPS, True, False)
    rel_f = rel_diff(s_gf, s_ef)
    if not (rel_f == 0.0 and torch.equal(rows_gf, rows_ef)):
        fail(f"11 (b) slab SL fast chunk: graph vs eager max rel diff "
             f"{rel_f:.3e}; expected bitwise")
    missed = int((rows_gf[:, 10] < 0.5).sum())
    _, d_e = sm.step(e_end, dt)
    phase(f"11 (b) slab SL {SLAB_SHAPE} f32: step 1 from rest max|div u| "
          f"{h1[0]['div_norm']:.3e}; then {N_STEPS} gated steps through "
          f"run, {esc} escalation(s), the transport {n_sl} times, launches "
          f"{e_launches}, {describe(e_hist, d_e)} (<= 1e-4); host ms/step "
          f"{e_wall / N_STEPS * 1e3:.4f}; the fast chunk of {N_STEPS} as "
          f"one graph replay vs eagerly: bitwise equal states and rows, "
          f"{missed} of {N_STEPS} steps miss the gate in both, device "
          f"kernels of the replay {l_gf}" + since())
    by_path["slab_sl"] = e_launches
    replay_by_path["slab_sl_fast_graph"] = l_gf
    cells["slab_sl"] = dict(escalations=esc, div_step1=h1[0]["div_norm"],
                            max_div=max(divs), fast_steps_missed=missed,
                            host_ms_run=e_wall / N_STEPS * 1e3)
    del sm, s1, e_end, s_gf, s_ef

    def settled(m):
        s = m.initial_state()
        for _ in range(2):
            s, _ = m.step(s, m.params.time_step)
        return s
    for label, make in (
            ("(b) annulus SL direct", lambda d: BoussinesqModel(sl_params(
                annulus_params("float64", refinement=4,
                               helmholtz_solver="direct")), device=d)),
            ("(b) annulus SL default", lambda d: BoussinesqModel(sl_params(
                annulus_params("float64", refinement=4)), device=d)),
            ("(b) slab SL", lambda d: BoussinesqModel(sl_params(
                slab_params((16, 64), "float64")), device=d))):
        cells[f"f64 {label}"] = card_vs_cpu_step(label, dev, make, settled)
    phase("11 (b) done" + since())

    # ---- (c) Richardson momentum beside CG temperature --------------------
    def rich_cg(p):
        p.numerics.fixed_solver_iters = 0
        p.numerics.momentum_fixed_iters = 1
        return p
    m = BoussinesqModel(rich_cg(bench_params(BENCH_SHAPE)), device=dev)
    if "richardson" in m.kernels() or m._graphable(False, False):
        fail(f"11 (c): kernels {list(m.kernels())}, graphable "
             f"{m._graphable(False, False)}")

    def want(calls):
        return {"forcing": len(calls), "faces_div": len(calls),
                "correct": len(calls), "tridiag": 0}
    s0 = seed_developed_flow(m)
    by_path["richardson_cg"], cells["richardson_cg"] = krylov_run(
        "(c) Richardson momentum, CG temperature", m, s0, RICH_CG_STEPS,
        want, tag="11")
    del m, s0
    def small64(**numerics):
        def make(d):
            p = rich_cg(bench_params(FEEC_SMALL, "float64"))
            for k, v in numerics.items():
                setattr(p.numerics, k, v)
            return BoussinesqModel(p, device=d)
        return make
    cells["f64 (c)"] = card_vs_cpu_step(
        "(c) Richardson momentum, CG temperature", dev, small64(),
        seed_developed_flow)
    # a forced momentum miss, in f64 at FEEC_SMALL: `helmholtz tol` 1e-15
    # (16 eps) is below one sweep's reach (f32 clamps any tolerance to 16
    # eps, which the flagship's one sweep meets)
    fm = small64(helmholtz_tol=1e-15)(dev)
    s0 = seed_developed_flow(fm)
    dt = fm.params.time_step
    _, d_miss = fm.step(s0, dt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        s_fm, h_fm = fm.run(max_steps=1, state=s0)
    s_st, d_st = fm.step_strong(s0, dt)
    rel_fm = rel_diff(s_fm, s_st)
    if (d_miss.solver_ok or fm.escalations != 1 or not d_st.solver_ok
            or not rel_fm == 0.0):
        fail(f"11 (c) forced momentum miss: the fast step's verdict "
             f"{d_miss.solver_ok}, {fm.escalations} escalation(s), the "
             f"strong step's verdict {d_st.solver_ok}, run vs step_strong "
             f"rel diff {rel_fm:.3e}")
    phase(f"11 (c) forced momentum miss {fm.geo.cell_shape} f64 (helmholtz "
          f"tol 1e-15): the fast step's helmholtz residual "
          f"{d_miss.helmholtz_residual:.3e}, solver_ok False; run: 1 "
          f"escalation, the step redone with CG (helmholtz "
          f"{d_st.helmholtz_iters.tolist()}, temperature "
          f"{d_st.temperature_iters} iterations), bitwise step_strong's"
          + since())
    cells["richardson_cg_forced_miss"] = dict(
        escalations=fm.escalations,
        helmholtz_residual=d_miss.helmholtz_residual)
    del fm, s0, s_fm, s_st

    # ---- (d) the model on a shell of non-uniform radial spacing ---------
    by_path["stretched_shell"], cells["stretched_shell"] = stretched_run(dev)
    phase("11 (d) done" + since())
    phase(f"phase 11 {time.perf_counter() - t0:.1f} s")
    return k4_rows, by_path, replay_by_path, cells


def stretched_run(dev):
    """(d): the bench model on presets.stretched_shell at 32 x 128 x 256
    f32, whose Poisson solve make_poisson_solver builds as
    ShellPoissonSpectral on the model's K4 wrapper, stopping at `poisson
    tol` and `max cg iters` as the JAX model passes them: it runs no
    CUDA graph (_graphable: the spectral CG reads its stopping test every
    iteration); STRETCHED_STEPS gated steps through run and the same
    steps as one multi_step chunk from the same state, each with the
    launches counted from 0: K1, K2 and K5 once a step, K4 the CG
    iterations + 1 a step, no escalation, no graph built, the two
    bitwise equal, max|div u| <= 1e-4; then one step under
    torch.profiler, its hand kernels exactly those. Returns (the run's
    launches, numbers)."""
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_SHAPE, bench_params, seed_developed_flow, stretched_shell)
    from dycoreplanet_tpu_torch.solvers.spectral import ShellPoissonSpectral

    shape, n = BENCH_SHAPE, STRETCHED_STEPS
    m = BoussinesqModel(bench_params(shape), geometry=stretched_shell(shape),
                        device=dev)
    ps, num = m.poisson_spectral, m.params.numerics
    if (not isinstance(ps, ShellPoissonSpectral)
            or ps.tridiag is not m.kernels()["tridiag"]
            or (ps.rtol, ps.maxiter) != (num.poisson_tol, num.max_cg_iters)
            or m._graphable(False, False)):
        fail(f"11 (d) stretched shell: Poisson solve {type(ps).__name__}, "
             f"graphable {m._graphable(False, False)}")
    s0 = seed_developed_flow(m)
    dt = m.params.time_step

    def want(poisson_iters):
        k = len(poisson_iters)
        return {"forcing": k, "richardson": k, "faces_div": 0,
                "correct": k, "tridiag": sum(i + 1 for i in poisson_iters)}
    (r_end, r_hist), r_launches, r_wall = drive(
        m, lambda: m.run(max_steps=n, state=s0))
    r_its = [h["poisson_iters"] for h in r_hist]
    r_esc = m.escalations
    (c_end, c_rows, _), c_launches, c_wall = drive(
        m, lambda: m.multi_step(s0, dt, n))
    c_its = [int(x) for x in c_rows[:, 5].tolist()]
    divs = [h["div_norm"] for h in r_hist]
    rel = rel_diff(r_end, c_end)
    for x in (r_end.u, r_end.p, r_end.T) + tuple(r_end.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail("11 (d) stretched shell: non-finite fields")
    if (m.escalations or m.chunk_graphs is not None or len(r_hist) != n
            or r_launches != want(r_its) or c_launches != want(c_its)
            or r_its != c_its or rel != 0.0 or not max(divs) <= 1e-4):
        fail(f"11 (d) stretched shell {shape}: {m.escalations} "
             f"escalation(s), graphs {m.chunk_graphs}, run launches "
             f"{r_launches} (expected {want(r_its)}), multi_step launches "
             f"{c_launches} (expected {want(c_its)}), Poisson iterations "
             f"{r_its} / {c_its}, run vs multi_step rel diff {rel:.3e}, "
             f"max|div u| {divs}")
    diag = []

    def one_step():
        diag.append(m.step(r_end, dt)[1])
        return diag[-1].cfl
    prof = step_profile(one_step, 1)
    its_p = int(diag[0].poisson_iters)
    want_p = {**{k: 0 for k in prof["counts"]}, **want([its_p])}
    if prof["counts"] != want_p:
        fail(f"11 (d) stretched shell: the profiled step ran the hand "
             f"kernels {prof['counts']} on the device, expected {want_p}")
    phase(f"11 (d) the bench model on a stretched shell {shape} f32 "
          f"(ShellPoissonSpectral, rtol {ps.rtol}, cap {ps.maxiter}; no "
          f"CUDA graph): {n} steps through run and as one multi_step "
          f"chunk, bitwise equal, 0 escalations, Poisson CG iterations "
          f"{r_its}, launches {r_launches} (the same in the chunk), "
          f"max|div u| per step {[float(f'{x:.3e}') for x in divs]}; host "
          f"ms/step run {r_wall / n * 1e3:.2f}, chunk "
          f"{c_wall / n * 1e3:.2f}; one profiled step: "
          f"{prof['device_ms_per_step']:.3f} device ms in "
          f"{prof['kernels_per_step']:.0f} kernels (K4 "
          f"{prof['kernel_ms_per_step'].get('tridiag', 0.0):.3f} ms), "
          f"{prof['host_launches_per_step']:.0f} host launches, busy share "
          f"{prof['busy_share']:.3f}, hand kernels {prof['counts']}")
    return r_launches, dict(
        shape=list(shape), steps=n, escalations=r_esc, poisson_iters=r_its,
        div=divs, host_ms_run=r_wall / n * 1e3,
        host_ms_chunk=c_wall / n * 1e3,
        device_ms_per_step=prof["device_ms_per_step"],
        k4_ms_per_step=prof["kernel_ms_per_step"].get("tridiag", 0.0),
        kernels_per_step=prof["kernels_per_step"],
        host_launches_per_step=prof["host_launches_per_step"],
        busy=prof["busy_share"], profiled_counts=prof["counts"])


# ---------------------------------------------------------------- phase 12
# bfloat16 on one device and on the mesh, and the native VTK encoder:
# (a) every bf16 form against its plain version; (b) the flagship in
# bf16 through run and as a graph chunk; (c) the annulus at work size
# (direct) and the shell's multigrid Poisson solve in bf16; (d) a bf16
# checkpoint and a restart from it; (e) one VTK write at BENCH_SHAPE with
# the native encoder and with the Python one
BF16 = "bfloat16"
# the bf16 forms' shapes besides BENCH_SHAPE, and K1's iteration pairs
# there ((3, 3) also in groups of sweeps through device memory)
BF16_SHAPES = ((6, 20, 36), (4, 8, 16))
BF16_PAIRS = ((1, 1), (3, 3))
# the bf16 flagship's state against the f32 run's after N_STEPS: the JAX
# package's bf16 test bound (tests/test_mixed_precision.py, 10% of the
# f64 max velocity)
BF16_TRACK = 0.1
# the card's bf16 max|div u| against the CPU's from the same state: the
# rounding the bf16 step leaves in the divergence dominates it (f32
# reads ~5e-5), and the two sides round the same float32 values but for
# the kernels' reassociation
BF16_DIV_MARGIN = 2.0
# VTK writes a side in phase 12 (e), native and Python interleaved
VTK_WRITES = 6


def bf16_ulp(scale):
    """The spacing of bfloat16 values (8 significant bits) at ``scale``:
    one bf16 ulp of an output's scale."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0


def compare_bf16(name, got, want, reassoc=1e-5):
    """bfloat16 outputs of a kernel against its plain version (the f32
    plain version on the widened inputs, each output rounded once): each
    within one bf16 ulp of its scale (max |want|) plus ``reassoc`` x scale
    (the two f32 computations' reassociation before they round). Returns
    (the max abs error, the worst error in ulps of its output's
    scale)."""
    import torch

    err = ulps = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
            fail(f"{name} output {k}: {g.dtype} / {w.dtype}, expected "
                 f"bfloat16")
        sc = float(w.float().abs().max())
        ulp = bf16_ulp(sc)
        d = float((g.float() - w.float()).abs().max())
        if not d <= ulp + reassoc * sc:
            fail(f"{name} output {k}: max |diff| {d:.3e} > one bf16 ulp "
                 f"{ulp:.3e} of its scale {sc:.3e} + {reassoc} x scale")
        err, ulps = max(err, d), max(ulps, d / ulp if ulp else 0.0)
    return err, ulps


def cpu_div_reading(model, cpu_model, state):
    """One step from ``state`` on the card (``model``) and from a copy of
    it on the CPU (``cpu_model``, the same parameters on the CPU, whose
    wrappers run their plain versions: the float32 plain version on the
    widened inputs, each output rounded once to bfloat16): (the card's
    post-projection max|div u|, the CPU's). The CPU's is an independent
    reading of what bf16 rounding leaves in that step's divergence."""
    import torch

    def step(m, s):
        return float(m.step(s, m._scalar(m.params.time_step))[1].div_norm)

    cpu = torch.device("cpu")
    host = state._replace(u=state.u.to(cpu), p=state.p.to(cpu),
                          T=state.T.to(cpu),
                          u_faces=tuple(f.to(cpu) for f in state.u_faces))
    return step(model, state), step(cpu_model, host)


def hold_div_to_cpu(label, card, cpu):
    """The card's max|div u| ``card`` (one or more steps) within
    BF16_DIV_MARGIN of the CPU's reading ``cpu`` from the same states.
    Returns the limit."""
    limit = BF16_DIV_MARGIN * cpu
    if not card <= limit:
        fail(f"{label}: max|div u| {card:.4e} > {BF16_DIV_MARGIN} x the "
             f"CPU's {cpu:.4e} from the same bf16 state")
    return limit


def check_k1_bf16(name, rk, args1):
    """K1 (or K1u) in bf16 against its plain version: u*, T_new, the faces
    and rhs_phi by compare_bf16; the float32 norms: K1's by check_norms
    at f32 (the kernel computes and sums in f32), K1u's the -1 sentinel
    and its b norms rtol 1e-5. Returns compare_bf16's (err, ulps)."""
    import torch

    got, want = rk(*args1), rk.plain(*args1)
    torch.cuda.synchronize()
    out = compare_bf16(name, (got[0], got[1]) + tuple(got[2]),
                       (want[0], want[1]) + tuple(want[2]))
    if any(x.dtype != torch.float32 for x in tuple(got[3]) + tuple(want[3])):
        fail(f"{name}: norms {[x.dtype for x in got[3]]}, expected float32")
    if rk.track_residual:
        check_norms(name, got[3], want[3], short_norms(rk, args1),
                    torch.float32)
    else:
        g, w = [float(x) for x in got[3]], [float(x) for x in want[3]]
        if not g[0] == g[2] == w[0] == w[2] == -1.0 or not all(
                abs(g[b] - w[b]) <= 1e-5 * w[b] for b in (1, 3)):
            fail(f"{name}: norms {g} vs plain {w}")
    return out


def bf16_richardson(m, iu, iT, track, grouped=False):
    """A ShellRichardson of model m at (iu, iT) sweeps; ``grouped``: its
    sweeps in groups (several passes through device memory) under a limit
    of 2,500 values of shared memory."""
    import torch
    from dycoreplanet_tpu_torch.ops import kernel_lib
    from dycoreplanet_tpu_torch.ops import richardson as k1
    from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson

    rk = ShellRichardson(
        m.geo, one_over_Re=m.one_over_Re, one_over_Pe=m.one_over_Pe,
        nse_interval=m.params.NSE_solver_interval, helm_diags=m.helm_diags,
        T_diag=m.T_diag, iters_u=iu, iters_T=iT, u_specs=m.u_specs,
        T_specs_hom=m.T_specs_hom, track_residual=track)
    if grouped:
        size = torch.finfo(kernel_lib.compute_dtype(m.torch_dtype)).bits // 8
        rk.plan = (lambda dtype: k1.plan(
            m.geo.cell_shape, size, iu, iT, smem_limit=2500 * size,
            track=track))
        if len(rk.plan(m.torch_dtype)) < 2:
            fail(f"K1 bf16 ({iu},{iT}) in groups: one pass")
    return rk


def check_k1_k2_bf16(dev, shape):
    """K2, K2m, then K1 and K1u at every pair of BF16_PAIRS and at (3, 3)
    in groups, in bf16 at ``shape``, against their plain versions
    (compare_bf16). Returns {name: worst ulps}."""
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, bench_params, seed_developed_flow)

    m = BoussinesqModel(bench_params(shape, BF16), device=dev)
    sm = BoussinesqModel(sl_params(bench_params(shape, BF16)), device=dev)
    s = seed_developed_flow(m)
    dt = m._scalar(BENCH_DT)
    a2 = (s.u, s.u_faces, s.T, s.p, dt)
    out = {}
    g2 = m._forcing(*a2)
    out["K2"] = compare_bf16(f"K2 bf16 {shape}", g2, m._forcing.plain(*a2))
    out["K2m"] = compare_bf16(f"K2m bf16 {shape}", (sm._forcing(*a2),),
                              (sm._forcing.plain(*a2),))
    a1 = (g2[0], m._vol_t * g2[1] + m._product(dt, m.one_over_Pe)
          * m._T_lap_offset_t, s.T, dt)
    for iu, iT, grouped in [p + (False,) for p in BF16_PAIRS] + [
            (3, 3, True)]:
        for track, name in ((True, "K1"), (False, "K1u")):
            what = (f"{name} bf16 {shape} ({iu},{iT})"
                    f"{' in groups' if grouped else ''}")
            e = check_k1_bf16(what, bf16_richardson(m, iu, iT, track,
                                                    grouped), a1)
            out[name] = max(out.get(name, (0.0, 0.0)), e)
    return out


def bf16_mesh_kernels(dev, timing):
    """K2o, K1o and K2mo in bf16 on every shard of the 2 x 2 mesh at
    BENCH_SHAPE, on the seeded developed flow, against their plain
    versions (compare_bf16; K1o's sums: |b|^2 rtol 1e-5 and |r| within
    0.1 |r| + 4 eps_f32 |b|, as in f32), and the shards stitched together
    against the single-device K2, K1 and K2m in bf16 (compare_bf16). With
    ``timing``: shard (0, 0)'s kernel and plain times and bound at 2 bytes
    a value. Returns {name: numbers}."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import forcing as k2
    from dycoreplanet_tpu_torch.ops import richardson as k1
    from dycoreplanet_tpu_torch.parallel.halo import halo_pad
    from dycoreplanet_tpu_torch.parallel.mesh import (
        build, shard_state, unshard_field)
    from dycoreplanet_tpu_torch.parallel.sharded_pallas import forcing_halos

    rows = {}
    eps = float(torch.finfo(torch.float32).eps)
    for sl in (False, True):
        model = mesh_model(dev, (2, 2), BF16, sl_params if sl else
                           (lambda p: p))
        s0 = seed_developed_flow(model)
        dt = model._scalar(BENCH_DT)
        mesh = model._mesh.mesh
        sh = shard_state(s0, model.geo, mesh)
        kf, kr = model._mesh.forcing.kern, model._mesh.richardson.kern
        nr, nl, no = kf.local_shape
        halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, mesh,
                              advect_T=not sl)
        name = "K2mo" if sl else "K2o"
        out2, a2, e2 = {}, {}, (0.0, 0.0)
        for (a, b), u in sh.u.items():
            a2[a, b] = (u, tuple(f[a, b] for f in sh.u_faces), sh.T[a, b],
                        sh.p[a, b], dt, halos[a, b], (a * nl, b * no))
            got = kf.call_operands(*a2[a, b])
            want = kf.plain_operands(*a2[a, b])
            got, want = ((got,), (want,)) if sl else (got, want)
            e2 = max(e2, compare_bf16(f"{name} bf16 shard {(a, b)}", got,
                                      want))
            out2[a, b] = got
        single = model._forcing(s0.u, s0.u_faces, s0.T, s0.p, dt)
        single = (single,) if sl else single
        d2 = compare_bf16(f"{name} bf16 stitched vs single device", [
            unshard_field(build(mesh, lambda a, b: out2[a, b][i]))
            for i in range(len(single))], single)
        rows[name] = dict(max_abs_err=max(e2[0], d2[0]),
                          max_err_ulps=max(e2[1], d2[1]))
        if timing:
            cells = nr * nl * no
            halo_vals = sum(t.numel() for t in halos[0, 0].values())
            fields = k2.MOMENTUM_FIELDS_MOVED if sl else k2.FIELDS_MOVED
            rows[name].update(zip(("bound_ms", "bound_by"), bound_of(
                2 * (fields * cells + halo_vals),
                (k2.MOMENTUM_OPS_PER_CELL if sl else k2.OPS_PER_CELL)
                * cells)))
            rows[name].update(
                ms=time_ms(lambda: kf.call_operands(*a2[0, 0])),
                plain_ms=time_ms(lambda: kf.plain_operands(*a2[0, 0]),
                                 reps=5))
        if sl:
            break
        # K1o on K2o's outputs, rhs_T as the step forms it
        ops = model._mesh.ops
        kT = model._product(dt, model.one_over_Pe)
        rhs_u = build(mesh, lambda a, b: out2[a, b][0])
        rhs_T = build(mesh, lambda a, b: ops.vol[a, b] * out2[a, b][1]
                      + kT * ops.T_lap_offset[a, b])
        GH = kr.GH
        st5 = rhs_u.map(lambda u, r, t: torch.cat([u, r[None], t[None]]),
                        rhs_T, sh.T)
        st5 = halo_pad(st5, mesh, "lon", 3, width=GH, periodic=True)
        st5 = halo_pad(st5, mesh, "lat", 2, width=GH, periodic=False)
        out1, a1, e1 = {}, {}, (0.0, 0.0)
        for (a, b), e in st5.items():
            a1[a, b] = (e[:3], e[3], e[4], dt, (a * nl, b * no))
            got = kr.call_operands(*a1[a, b])
            want = kr.plain_operands(*a1[a, b])
            e1 = max(e1, compare_bf16(f"K1o bf16 shard {(a, b)}", got[:6],
                                      want[:6]))
            g = [float(x) for x in got[6]]
            w = [float(x) for x in want[6]]
            b_ok = all(abs(g[k] - w[k]) <= 1e-5 * w[k] for k in (1, 3))
            r_ok = all(abs(g[r] ** 0.5 - w[r] ** 0.5)
                       <= 0.1 * w[r] ** 0.5 + 4 * eps * w[bb] ** 0.5
                       for r, bb in ((0, 1), (2, 3)))
            if got[6].dtype != torch.float32 or not (b_ok and r_ok):
                fail(f"K1o bf16 shard {(a, b)}: sums {g} ({got[6].dtype}) "
                     f"vs plain {w}")
            out1[a, b] = got
        k1_out = model._richardson(unshard_field(rhs_u),
                                   unshard_field(rhs_T), s0.T, dt)
        d1 = compare_bf16("K1o bf16 stitched vs K1", [unshard_field(build(
            mesh, lambda a, b: out1[a, b][i])) for i in range(5)],
            [k1_out[0], k1_out[1]] + list(k1_out[2][:3]))
        rows["K1o"] = dict(max_abs_err=max(e1[0], d1[0]),
                           max_err_ulps=max(e1[1], d1[1]))
        if timing:
            cells = nr * nl * no
            ext = nr * (nl + 2 * GH) * (no + 2 * GH)
            rows["K1o"].update(zip(("bound_ms", "bound_by"), bound_of(
                2 * (5 * ext + 8 * cells),
                k1.ops_per_cell(kr.iters_u, kr.iters_T) * cells)))
            rows["K1o"].update(
                ms=time_ms(lambda: kr.call_operands(*a1[0, 0])),
                plain_ms=time_ms(lambda: kr.plain_operands(*a1[0, 0]),
                                 reps=5))
    phase("12 (a) K2o / K1o / K2mo bf16 on the 2x2 mesh, every shard "
          "against its plain version and stitched against K2 / K1 / K2m: " +
          "; ".join(f"{k} max abs err {r['max_abs_err']:.3e} "
                    f"({r['max_err_ulps']:.2f} ulps of scale)"
                    + (f", kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f}"
                       f" ms, bound {r['bound_ms'] * 1e3:.2f} us" if timing
                       else "") for k, r in rows.items()))
    return rows


def bf16_mg_k4(dev):
    """K4's bf16 form on the MG line smoother's operands at level 0 of
    the bf16 shell at BENCH_SHAPE, on every line axis: the rhs the bf16
    residual's moved view (on the periodic lon lines alone, their
    Sherman-Morrison column solved once: solvers/multigrid.py), the
    coefficients the smoother's float32 tables, x float32, against the
    plain version (rtol = atol = 1e-5 x scale, the f32
    tolerance: both recur in f32 on the same values), nothing copied, one
    launch's time and the bound (rhs at 2 bytes, the coefficients and x
    at 4). Returns {kind: numbers}."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import BENCH_SHAPE, bench_params
    from dycoreplanet_tpu_torch.ops import tridiag as k4

    p = bench_params(BENCH_SHAPE, BF16)
    p.numerics.poisson_solver = "mg"
    m = BoussinesqModel(p, device=dev)
    mg, tk = m.poisson_precond, m._tridiag
    gen = torch.Generator(device=dev).manual_seed(15)
    r = torch.randn(m.geo.cell_shape, generator=gen, device=dev).to(
        torch.bfloat16)
    rows = {}
    for a in mg.line_axes:
        kind = (f"axis {a} (r)" if a == 0 else f"axis {a}") + (
            " periodic" if mg.specs[a] is None else "")
        ops = mg.line_operands(0, a, r)
        if ops[3].dtype != torch.bfloat16 or any(
                x.dtype != torch.float32 for x in ops[:3]):
            fail(f"12 (a) K4 MG bf16 {kind}: operands "
                 f"{[x.dtype for x in ops]}, expected f32 coefficients and "
                 f"a bf16 rhs")
        lay = k4.layout(*ops, pair=tk.pair)
        want = tk.plain(*ops)
        sc = float(want.abs().max())
        tk.copies = 0
        err = check_k4(f"K4 tridiag MG bf16 {kind}", tk, ops, want,
                       1e-5 * sc)
        if lay.copied or tk.copies or tk(*ops).dtype != torch.float32:
            fail(f"12 (a) K4 MG bf16 {kind}: copied {lay.copied}, x not "
                 f"float32")
        n_x = ops[3].numel()
        coef = k4.values_moved(*ops) - 2 * n_x      # lower, diag, upper
        b_ms, b_by = bound_of(4 * coef + 2 * n_x + 4 * n_x,
                              k4.OPS_PER_VALUE * n_x)
        rows[kind] = dict(max_abs_err=err, ms=time_ms(lambda: tk(*ops)),
                          plain_ms=time_ms(lambda: tk.plain(*ops), reps=10),
                          bound_ms=b_ms, bound_by=b_by)
    phase("12 (a) K4 tridiag bf16 (bf16 rhs, f32 coefficients), MG line "
          "layout at level 0, every line axis: " + "; ".join(
              f"{k}: max abs err {r['max_abs_err']:.3e} (tol 1e-5 x scale), "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})"
              for k, r in rows.items()) + "; 0 operands copied, x float32")
    return rows


def bf16_phases(dev, s_f32):
    """Phase 12. ``s_f32``: the f32 flagship's state after N_STEPS steps
    from the seeded flow (phase 4). Returns (the bf16 rows by kernel
    name, the launches by path, the replays' device kernels by path)."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.io import vtk
    from dycoreplanet_tpu_torch.io.checkpoint import (
        load_checkpoint, save_checkpoint)
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import forcing as k2
    from dycoreplanet_tpu_torch.ops import projection as k3
    from dycoreplanet_tpu_torch.ops import richardson as k1
    from dycoreplanet_tpu_torch.ops import stencil as st

    t0 = time.perf_counter()
    rows, launches, replays = {}, {}, {}
    # ---- (a) the kernels at BENCH_SHAPE, on the seeded developed flow
    bm = BoussinesqModel(bench_params(BENCH_SHAPE, BF16), device=dev)
    n = bm.geo.n_cells
    b0 = seed_developed_flow(bm)
    dt = bm._scalar(BENCH_DT)
    fk, rk, pk = bm._forcing, bm._richardson, bm._proj
    slm = BoussinesqModel(sl_params(bench_params(BENCH_SHAPE, BF16)),
                          device=dev)
    im = BoussinesqModel(interval_params(bench_params(BENCH_SHAPE, BF16)),
                         device=dev)

    def add(name, err, fn, plain, fields, ops):
        b_ms, b_by = bound(n, fields, ops, itemsize=2)
        rows[name] = dict(max_abs_err=err[0], max_err_ulps=err[1],
                          ms=time_ms(fn), plain_ms=time_ms(plain, reps=10),
                          bound_ms=b_ms, bound_by=b_by)

    a2 = (b0.u, b0.u_faces, b0.T, b0.p, dt)
    g2 = fk(*a2)
    add("K2", compare_bf16("K2 bf16", g2, fk.plain(*a2)),
        lambda: fk(*a2), lambda: fk.plain(*a2), k2.FIELDS_MOVED,
        k2.OPS_PER_CELL)
    fm = slm._forcing
    add("K2m", compare_bf16("K2m bf16", (fm(*a2),), (fm.plain(*a2),)),
        lambda: fm(*a2), lambda: fm.plain(*a2), k2.MOMENTUM_FIELDS_MOVED,
        k2.MOMENTUM_OPS_PER_CELL)
    a1 = (g2[0], bm._vol_t * g2[1] + bm._product(dt, bm.one_over_Pe)
          * bm._T_lap_offset_t, b0.T, dt)
    add("K1", check_k1_bf16("K1 bf16", rk, a1), lambda: rk(*a1),
        lambda: rk.plain(*a1), k1.FIELDS_MOVED,
        k1.ops_per_cell(rk.iters_u, rk.iters_T))
    rku = im._richardson_free
    add("K1u", check_k1_bf16("K1u bf16", rku, a1), lambda: rku(*a1),
        lambda: rku.plain(*a1), k1.FIELDS_MOVED,
        k1.ops_per_cell(rku.iters_u, rku.iters_T, track=False))
    u_star = rk(*a1)[0]
    g3, w3 = pk.faces_div(u_star, dt), pk.plain(u_star, dt)
    e3 = compare_bf16("K3 bf16", g3[:4], w3[:4])
    if g3[4].dtype != torch.float32:
        fail(f"K3 bf16: the sum is {g3[4].dtype}, expected float32")
    compare("K3 bf16 sum", (g3[4] / n,), (w3[4] / n,), 1e-4,
            2e-5 * float(w3[3].float().abs().max()))
    add("K3", e3, lambda: pk.faces_div(u_star, dt),
        lambda: pk.plain(u_star, dt), k3.FIELDS_MOVED, k3.OPS_PER_CELL)
    rhs_phi = (g3[3] - g3[4] / float(n)).to(torch.bfloat16)
    phi, _ = bm.poisson_spectral.solve(rhs_phi)
    a5 = (u_star, g3[:3], phi, b0.p, dt, st.volume_mean(bm.geo, phi))
    add("K5", compare_bf16("K5 bf16", pk.correct(*a5),
                           pk.correct_plain(*a5)),
        lambda: pk.correct(*a5), lambda: pk.correct_plain(*a5),
        k3.CORRECT_FIELDS_MOVED, k3.CORRECT_OPS_PER_CELL)
    phase(f"12 (a) bf16 kernels at {BENCH_SHAPE} against their plain "
          f"versions (each output within one bf16 ulp of its scale + 1e-5 x "
          f"scale; K1's norms float32 at f32's tolerances; K3's sum "
          f"float32): " +
          "; ".join(f"{k} max abs err {r['max_abs_err']:.3e} "
                    f"({r['max_err_ulps']:.2f} ulps), kernel {r['ms']:.4f} "
                    f"ms, plain {r['plain_ms']:.3f} ms, bound "
                    f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}, 2 bytes "
                    f"a value)" for k, r in rows.items()))
    for shape in BF16_SHAPES:
        small = check_k1_k2_bf16(dev, shape)
        for k, e in small.items():
            rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], e[0])
            rows[k]["max_err_ulps"] = max(rows[k]["max_err_ulps"], e[1])
        phase(f"12 (a) K2 / K2m / K1 / K1u bf16 at {shape}, K1 and K1u at "
              f"{list(BF16_PAIRS)} and (3,3) in groups: " + ", ".join(
                  f"{k} {e[1]:.2f} ulps" for k, e in small.items()))
    rows["K4 MG"] = bf16_mg_k4(dev)
    rows.update(bf16_mesh_kernels(dev, timing=True))
    phase("12 (a) done" + f" ({time.perf_counter() - t0:.1f} s)")

    # ---- (b) the flagship in bf16
    want_l = {"forcing": N_STEPS, "richardson": N_STEPS, "faces_div": 0,
              "correct": N_STEPS, "tridiag": 0}
    bm.run(max_steps=2, state=b0)
    run_b = drive(bm, lambda: bm.run(max_steps=N_STEPS, state=b0))
    (s_b, hist_b), l_b, _ = run_b
    if l_b != want_l or len(hist_b) != N_STEPS:
        fail(f"12 (b) bf16 flagship: run launches {l_b}, expected {want_l}")
    if any(x.dtype != torch.bfloat16 for x in
           (s_b.u, s_b.p, s_b.T) + tuple(s_b.u_faces)):
        fail("12 (b) bf16 flagship: a state field left bfloat16")
    divs = [h["div_norm"] for h in hist_b]
    # the card's and the CPU's step from the run's first state (the seeded
    # flow) and from its last; the run's steps between held to the larger
    # CPU reading
    cpu_bm = BoussinesqModel(bench_params(BENCH_SHAPE, BF16), device="cpu")
    div_0, cpu_0 = cpu_div_reading(bm, cpu_bm, b0)
    div_c, cpu_c = cpu_div_reading(bm, cpu_bm, s_b)
    hold_div_to_cpu("12 (b) bf16 flagship, from the seeded flow", div_0,
                    cpu_0)
    hold_div_to_cpu(f"12 (b) bf16 flagship, from step {N_STEPS}", div_c,
                    cpu_c)
    div_tol = hold_div_to_cpu(f"12 (b) bf16 flagship, {N_STEPS} steps",
                              max(divs), max(cpu_0, cpu_c))
    rows["div_flagship"] = dict(card_first=div_0, cpu_first=cpu_0,
                                card_last=div_c, cpu_last=cpu_c,
                                run_max=max(divs))
    _, l_g, ms_r, ms_g, s_g, _ = graph_vs_run(
        "12 (b) bf16 flagship", bm, b0, want_l, run_b, bitwise=True,
        div_tol=div_tol)
    u_b, u_f = s_b.u.float(), s_f32.u
    track = float((u_b - u_f).abs().max() / u_f.abs().max())
    if not track <= BF16_TRACK:
        fail(f"12 (b) bf16 flagship vs f32 after {N_STEPS} steps: max|du| "
             f"{track:.3e} of max|u| > {BF16_TRACK}")
    prof = step_profile(lambda: bm.run(max_steps=1, state=b0), 1)
    once = {k: v // N_STEPS for k, v in l_b.items()}
    hand = {k: v for k, v in prof["counts"].items()
            if k in once or v}
    if hand != once:
        fail(f"12 (b) bf16 flagship: the profiler counted {hand} hand "
             f"kernels in one step, the wrappers {once}")
    for k in ("forcing", "richardson", "correct"):
        rows[{"forcing": "K2", "richardson": "K1", "correct": "K5"}[k]][
            "in_step_ms"] = prof["kernel_ms_per_step"].get(k)
    launches["bf16_main"] = l_b
    replays["bf16_main_graph"] = l_g
    phase(f"12 (b) bf16 flagship {BENCH_SHAPE}: {N_STEPS} gated steps, "
          f"{bm.escalations} escalations, launches {l_b}, max|div u| "
          f"first/last/max {divs[0]:.4e}/{divs[-1]:.4e}/{max(divs):.4e}; "
          f"one step from the first / last state: card {div_0:.4e} / "
          f"{div_c:.4e}, CPU {cpu_0:.4e} / {cpu_c:.4e} (limit "
          f"{BF16_DIV_MARGIN} x the CPU's; f32 phase 4: < 1e-4), graph = "
          f"run bitwise, max|u| "
          f"{hist_b[-1]['max_velocity']:.4f} vs f32 "
          f"{float(u_f.abs().max()):.4f}, max|u_bf16 - u_f32| {track:.3e} of "
          f"max|u| (tol {BF16_TRACK}); one eager step: "
          f"{prof['device_ms_per_step']:.3f} device ms, "
          f"{prof['kernels_per_step']:.0f} kernels, busy share "
          f"{prof['busy_share']:.3f}, hand kernels {hand} (= the wrappers'), "
          f"in-step ms {prof['kernel_ms_per_step']}; host ms/step run "
          f"{ms_r:.3f}, graph {ms_g:.3f}")

    # ---- (c) the annulus at work size, direct; the shell's MG
    am = BoussinesqModel(annulus_params(BF16, helmholtz_solver="direct"),
                         device=dev)
    a0 = am.initial_state()
    want_a = {"tridiag": 2 * N_STEPS}
    am.run(max_steps=2, state=a0)
    run_a = drive(am, lambda: am.run(max_steps=N_STEPS, state=a0))
    (s_a, hist_a), l_a, _ = run_a
    cpu_am = BoussinesqModel(annulus_params(BF16, helmholtz_solver="direct"),
                             device="cpu")
    da_0, ca_0 = cpu_div_reading(am, cpu_am, a0)
    da_c, ca_c = cpu_div_reading(am, cpu_am, s_a)
    hold_div_to_cpu("12 (c) bf16 annulus direct, from the initial state",
                    da_0, ca_0)
    hold_div_to_cpu(f"12 (c) bf16 annulus direct, from step {N_STEPS}",
                    da_c, ca_c)
    tol_a = hold_div_to_cpu(
        f"12 (c) bf16 annulus direct, {N_STEPS} steps",
        max(h["div_norm"] for h in hist_a), max(ca_0, ca_c))
    rows["div_annulus"] = dict(card_first=da_0, cpu_first=ca_0,
                               card_last=da_c, cpu_last=ca_c,
                               run_max=max(h["div_norm"] for h in hist_a))
    _, l_ag, _, _, _, _ = graph_vs_run(
        "12 (c) bf16 annulus direct", am, a0, want_a, run_a, bitwise=True,
        div_tol=tol_a)
    launches["bf16_annulus_direct"] = l_a
    replays["bf16_annulus_direct_graph"] = l_ag
    phase(f"12 (c) bf16 annulus direct {am.geo.cell_shape}: launches "
          f"{l_a}, max|div u| {max(h['div_norm'] for h in hist_a):.4e}; one "
          f"step from the first / last state: card {da_0:.4e} / "
          f"{da_c:.4e}, CPU {ca_0:.4e} / {ca_c:.4e}, "
          f"max|u| {hist_a[-1]['max_velocity']:.4e}, {am.escalations} "
          f"escalations")
    p = bench_params(BENCH_SHAPE, BF16)
    p.numerics.poisson_solver = "mg"
    mgm = BoussinesqModel(p, device=dev)
    m0 = seed_developed_flow(mgm)
    (s_m, hist_m), l_m, w_m = drive(mgm, lambda: mgm.run(max_steps=1,
                                                          state=m0))
    prof_m = step_profile(lambda: mgm.run(max_steps=1, state=m0), 1)
    k4_bf16 = sum(c for name, _, c in prof_m["rows"]
                  if "thomas_" in name and "bfloat16" in name)
    per_cycle = mgm.poisson_precond.line_solves_per_cycle()
    iters = hist_m[0]["poisson_iters"]
    # every line solve takes the bf16 form (the periodic lon lines too)
    if (mgm.escalations or l_m["tridiag"] != per_cycle * (iters + 1)
            or prof_m["counts"]["tridiag"] != l_m["tridiag"]
            or k4_bf16 != l_m["tridiag"]):
        fail(f"12 (c) bf16 shell mg: K4 {l_m['tridiag']} launches, "
             f"{prof_m['counts']['tridiag']} on the device ({k4_bf16} of the "
             f"bf16 form), {iters} CG iterations x {per_cycle}, "
             f"{mgm.escalations} escalations")
    p = bench_params(BENCH_SHAPE, BF16)
    p.numerics.poisson_solver = "mg"
    dm_0, cm_0 = cpu_div_reading(mgm, BoussinesqModel(p, device="cpu"), m0)
    hold_div_to_cpu("12 (c) bf16 shell mg, from the seeded flow", dm_0, cm_0)
    rows["div_mg"] = dict(card_first=dm_0, cpu_first=cm_0,
                          run_first=hist_m[0]["div_norm"])
    launches["bf16_poisson_mg"] = l_m
    phase(f"12 (c) bf16 shell poisson solver = mg {BENCH_SHAPE}, one step: "
          f"{iters} CG iterations, 0 escalations, K4 launches "
          f"{l_m['tridiag']} (= {per_cycle} a V-cycle x {iters + 1}), "
          f"{k4_bf16} of them the bf16 form on the device (every line), "
          f"max|div u| {hist_m[0]['div_norm']:.4e}; one step from the "
          f"seeded flow: card {dm_0:.4e}, CPU {cm_0:.4e}, "
          f"{w_m * 1e3:.0f} host ms")

    # ---- (d) a bf16 checkpoint and a restart from it
    with tempfile.TemporaryDirectory() as tmp:
        # from time 4.25, where float32 times lie between bfloat16 values
        s2, _ = bm.run(max_steps=2, state=b0._replace(time=4.25))
        path = save_checkpoint(os.path.join(tmp, "bf16_ckpt.npz"), s2)
        r2, _ = load_checkpoint(path, dev)
        with np.load(path) as data:
            kinds = {k: str(data[k].dtype) for k in ("u", "T", "time")}
        if not same_bits((r2.u, r2.T, (r2.p,) + tuple(r2.u_faces)),
                         (s2.u, s2.T, (s2.p,) + tuple(s2.u_faces))):
            fail("12 (d) the bf16 checkpoint did not restore bitwise")
        if (r2.time, r2.step_number) != (s2.time, s2.step_number):
            fail(f"12 (d) the bf16 checkpoint restored time "
                 f"{r2.time!r} / step {r2.step_number}, saved {s2.time!r} / "
                 f"{s2.step_number}")
        s5a, _ = bm.run(max_steps=3, state=s2)
        s5b, _ = bm.run(max_steps=3, state=r2)
        if not same_bits((s5a.u, s5a.T, (s5a.p,) + tuple(s5a.u_faces)),
                         (s5b.u, s5b.T, (s5b.p,) + tuple(s5b.u_faces))) or \
                s5a.time != s5b.time:
            fail("12 (d) 3 steps from the restored bf16 state differ from "
                 "3 steps from the saved one")
        ck_bytes = os.path.getsize(path)
    phase(f"12 (d) bf16 checkpoint ({ck_bytes} bytes; arrays {kinds}): "
          f"restored bitwise, time {r2.time!r} exact, 3 steps from it "
          f"bitwise 3 steps from the saved state")

    # ---- (e) VTK writes and the velocity block's encoding with the
    # native encoder and with Python's, interleaved
    with tempfile.TemporaryDirectory() as tmp:
        host = [x.float().cpu().numpy() for x in (s_b.u, s_b.p, s_b.T)]

        def write(name):
            t = time.perf_counter()
            vtk.write_vts(os.path.join(tmp, name), bm.geo,
                          scalars={"pressure": host[1],
                                   "temperature": host[2]},
                          vectors={"velocity": host[0]})
            return (time.perf_counter() - t) * 1e3

        def encode_ms(fn, a):
            t = time.perf_counter()
            fn(a)
            return (time.perf_counter() - t) * 1e3

        encode = vtk._b64_block
        block = np.ascontiguousarray(host[0])
        native, plain, enc_n, enc_p = [], [], [], []
        for _ in range(VTK_WRITES):
            native.append(write("native.vts"))
            vtk._b64_block = vtk._b64_block_plain
            try:
                plain.append(write("plain.vts"))
            finally:
                vtk._b64_block = encode
            enc_n.append(encode_ms(vtk._b64_block, block))
            enc_p.append(encode_ms(vtk._b64_block_plain, block))
        if not same_file(os.path.join(tmp, "native.vts"),
                         os.path.join(tmp, "plain.vts")):
            fail("12 (e) the native encoder's .vts differs from the Python "
                 "encoder's")
        vts_bytes = os.path.getsize(os.path.join(tmp, "native.vts"))
    # the native encoder separates from Python's where every one of its
    # times is below every one of the other's
    rows["VTK"] = dict(native_ms=native, plain_ms=plain, vts_bytes=vts_bytes,
                       encode_native_ms=enc_n, encode_plain_ms=enc_p,
                       block_bytes=block.nbytes,
                       write_separated=max(native) < min(plain),
                       encode_separated=max(enc_n) < min(enc_p))
    phase(f"12 (e) {VTK_WRITES} VTK writes a side at {BENCH_SHAPE} (u, p, "
          f"T; {vts_bytes} bytes), interleaved, host ms: native encoder "
          f"{[round(x, 1) for x in native]}, Python encoder "
          f"{[round(x, 1) for x in plain]} (separated: "
          f"{rows['VTK']['write_separated']}); the velocity block alone "
          f"({block.nbytes} bytes): native {[round(x, 2) for x in enc_n]}, "
          f"Python {[round(x, 2) for x in enc_p]} (separated: "
          f"{rows['VTK']['encode_separated']}); files byte for byte equal")
    phase(f"phase 12 {time.perf_counter() - t0:.1f} s")
    return rows, launches, replays


# phase 13: the steps of each Krylov check, and the meshes of (a)
KRYLOV_MESH_STEPS = 5
# (c): the steps of `poisson solver = cg` on the mesh
KRYLOV_MESH_CG_STEPS = 2
KRYLOV_MESH_MIM_STEPS = 3


def hold_mesh(label, got, want, divs, tol=1e-4, div_tol=1e-4, tag="13"):
    """A mesh state (gathered) against the single-device state after the
    same steps: finite, within tol of max|u| (u, T) and every max|div u|
    <= div_tol. Returns (max|u - u_one|, max|u_one|, max|div u|)."""
    import torch

    for x in (got.u, got.p, got.T) + tuple(got.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail(f"{tag} {label}: non-finite fields")
    du = float((got.u - want.u).abs().max())
    u_sc = float(want.u.abs().max())
    dT = float((got.T - want.T).abs().max() / want.T.abs().max())
    if not du <= tol * u_sc or not dT <= tol:
        fail(f"{tag} {label}: max|u_mesh - u_one| {du:.3e} ({du / u_sc:.3e} "
             f"of max|u|), T rel {dT:.3e}, tol {tol:.0e}")
    div_max = max(divs)
    if not div_max <= div_tol:
        fail(f"{tag} {label}: max|div u| {div_max:.3e} > {div_tol:.3e}")
    return du, u_sc, div_max


def iters_of(diags):
    """(helmholtz, temperature, poisson) iterations of each step."""
    return [(int(d.helmholtz_iters[0]), d.temperature_iters,
             d.poisson_iters) for d in diags]


def same_iters(label, got, want, tag="13"):
    """The mesh's Krylov counts against one device's: equal, or at most
    one iteration apart a solve (f32 sums in another order move a count
    at its knife edge, ROADMAP.md Queue 3); the differences as text."""
    diff = [tuple(a - b for a, b in zip(g, w)) for g, w in zip(got, want)]
    if any(abs(x) > 1 for d in diff for x in d):
        fail(f"{tag} {label}: Krylov iterations {got}, one device {want}")
    return ("equal" if not any(any(d) for d in diff)
            else f"apart by {diff} (the f32 sums' order)")


def mesh_cg_phases(dev):
    """Phase 13: the Krylov solves, the escalation and the plain
    path on the mesh, and the mimetic personality on the mesh, at
    BENCH_SHAPE f32 from the seeded flow, every shard on the one card:
    (a) step_strong for KRYLOV_MESH_STEPS steps on 2x2 and 2x4 against one
    device's (u and T within 1e-4, Krylov counts equal or one apart,
    max|div u| <= 1e-4, K2o A*B times a step and nothing else launched);
    (b) run for N_STEPS on 2x4 with every fast step missing its f32 gate
    (the fast Poisson solve's constants tripled, as phase 5 forces a
    miss): the escalations and the window left of one device's run, K2o (N_STEPS + escalations) * A*B times, K1o once a
    fast try, and a second run (a fresh model) bitwise the first; (c)
    `fixed solver iters` = 0 (all-CG) and `poisson solver = cg`,
    KRYLOV_MESH_STEPS and KRYLOV_MESH_CG_STEPS steps on 2x2 against one
    device (the f32
    Jacobi-CG Poisson solve stalls short of its tolerance: its max|div u|
    held to twice one device's); (d) one
    kernels=False step against the kernel path on 2x4 (within 1e-5 of
    max|u|, no hand kernel launched); (e) the mimetic shell on 2x4
    against one device, KRYLOV_MESH_MIM_STEPS steps; (f) the escalated 2x4
    step's device ms, host ms, kernels, host launches and host syncs a
    step, and the semi-Lagrangian model's escalated 2x4 step (K2mo A*B
    times). Returns ({path: launches}, numbers)."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel, make_model
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.parallel.mesh import (
        Mesh, shard_state, unshard_state)

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    launches, nums = {}, {}
    dt, n = BENCH_DT, KRYLOV_MESH_STEPS

    def steps(model, s, k, fn):
        ds = []
        for _ in range(k):
            s, d = getattr(model, fn)(s, dt)
            ds.append(d)
        return s, ds

    def on_mesh(model, shape, **kw):
        A, B = shape
        return model.prepare_sharded(Mesh(np.array([[dev] * B] * A,
                                                   dtype=object),
                                          ("lat", "lon")), **kw)

    one = BoussinesqModel(bench_params(BENCH_SHAPE), device=dev)
    s0 = seed_developed_flow(one)

    # ---- (a) step_strong on 2x2 and 2x4 ---------------------------------
    s_one, d_one = steps(one, s0, n, "step_strong")
    for A, B in MESHES:
        label = f"(a) step_strong {A}x{B}"
        m = mesh_model(dev, (A, B))
        st0 = shard_state(s0, m.geo, m._mesh.mesh)
        steps(m, st0, 1, "step_strong")                       # warm-up
        (sm, dm), counts, wall = drive(
            m, lambda: steps(m, st0, n, "step_strong"))
        want = {**{k: 0 for k in counts}, "forcing_operands": n * A * B}
        if counts != want:
            fail(f"13 {label}: launches {counts}, expected {want}")
        du, u_sc, div = hold_mesh(label, unshard_state(sm), s_one,
                                  [d.div_norm for d in dm])
        its = same_iters(label, iters_of(dm), iters_of(d_one))
        launches[f"escalated_mesh_{A}x{B}"] = counts
        nums[label] = dict(du=du / u_sc, div=div, iters=iters_of(dm),
                           one_iters=iters_of(d_one),
                           host_ms=wall / n * 1e3)
        phase(f"13 {label}: {n} steps, launches {counts}, max|u_mesh - "
              f"u_one| {du / u_sc:.3e} of max|u|, max|div u| {div:.3e}, "
              f"(helmholtz, temperature, poisson) iterations "
              f"{iters_of(dm)}, {its} to one device's; "
              f"{wall / n * 1e3:.1f} host ms a step" + since())
        del m

    # ---- (f) the escalated 2x4 step, profiled -------------------------
    m = mesh_model(dev, MAIN_MESH)
    st0 = shard_state(s0, m.geo, m._mesh.mesh)
    steps(m, st0, 1, "step_strong")
    prof = step_profile(lambda: m.step_strong(st0, dt), 1)
    _, syncs = count_syncs(lambda: m.step_strong(st0, dt))
    _, _, wall = drive(m, lambda: m.step_strong(st0, dt))
    prof_1 = step_profile(lambda: one.step_strong(s0, dt), 1)
    _, syncs_1 = count_syncs(lambda: one.step_strong(s0, dt))
    nums["(f) escalated 2x4"] = dict(
        device_ms=prof["device_ms_per_step"],
        kernels=prof["kernels_per_step"],
        host_launches=prof["host_launches_per_step"],
        busy=prof["busy_share"], host_ms=wall * 1e3, syncs=syncs,
        k2o_ms=prof["kernel_ms_per_step"].get("forcing_operands", 0.0),
        one_device_ms=prof_1["device_ms_per_step"],
        one_kernels=prof_1["kernels_per_step"], one_syncs=syncs_1)
    phase(f"13 (f) escalated step on {MAIN_MESH[0]}x{MAIN_MESH[1]}: "
          f"{prof['device_ms_per_step']:.4f} device ms in "
          f"{prof['kernels_per_step']:.0f} kernels (K2o "
          f"{nums['(f) escalated 2x4']['k2o_ms']:.4f} ms), "
          f"{prof['host_launches_per_step']:.0f} host launches, {syncs} "
          f"host syncs, {wall * 1e3:.1f} host ms, busy "
          f"{prof['busy_share']:.3f}; one device's step_strong "
          f"{prof_1['device_ms_per_step']:.4f} device ms in "
          f"{prof_1['kernels_per_step']:.0f} kernels, {syncs_1} host syncs"
          + since())
    del m

    # ---- (b) run with every fast step missing its gate ---------------
    # no tolerance makes the seeded flow's f32 gate miss (its solves are
    # mass-dominated: one Richardson sweep meets 16 eps at dt up to
    # 0.05), so the miss is forced as in phase 5: the fast Poisson
    # solve's constants tripled, which the spot-check catches on every
    # fast step and the escalated CG repairs (the sharded solve copies
    # them when the mesh is prepared)
    def corrupt(model):
        ps = model.poisson_spectral
        ps._inv_denom = 3.0 * ps._inv_denom
        ps.to(dev)
        return model

    one_t = corrupt(BoussinesqModel(bench_params(BENCH_SHAPE), device=dev))
    s1_end, h1 = one_t.run(max_steps=N_STEPS, state=s0)
    if one_t.escalations < 1:
        fail("13 (b): the corrupted fast solve did not miss on one device")
    runs = []
    for _ in range(2):
        m = on_mesh(corrupt(BoussinesqModel(bench_params(BENCH_SHAPE),
                                            device=dev)), MAIN_MESH)
        st0 = shard_state(s0, m.geo, m._mesh.mesh)
        (sm, hm), counts, wall = drive(
            m, lambda: m.run(max_steps=N_STEPS, state=st0))
        runs.append((unshard_state(sm), m.escalations,
                     m._strong_steps_left, counts, wall, hm))
        del m
    (g, esc, left, counts, wall, hm), again = runs[0], runs[1][0]
    AB = MAIN_MESH[0] * MAIN_MESH[1]
    label = f"(b) run {MAIN_MESH[0]}x{MAIN_MESH[1]}, escalating"
    if esc != one_t.escalations or left != one_t._strong_steps_left:
        fail(f"13 {label}: {esc} escalation(s), {left} left; one device "
             f"{one_t.escalations}, {one_t._strong_steps_left}")
    if counts.get("forcing_operands") != (N_STEPS + esc) * AB:
        fail(f"13 {label}: launches {counts}, K2o expected "
             f"{(N_STEPS + esc) * AB}")
    if not all(torch.equal(x, y) for x, y in zip(
            (g.u, g.p, g.T) + tuple(g.u_faces),
            (again.u, again.p, again.T) + tuple(again.u_faces))):
        fail(f"13 {label}: two runs from the same state differ")
    du, u_sc, div = hold_mesh(label, g, s1_end, [h["div_norm"] for h in hm])
    launches["escalating_run_mesh_2x4"] = counts
    nums[label] = dict(escalations=esc, du=du / u_sc, div=div,
                       host_ms=wall / N_STEPS * 1e3)
    phase(f"13 {label}: {N_STEPS} steps, {esc} escalation(s) and "
          f"{left} strong steps left as on one device, launches {counts}, "
          f"a second run bitwise the first, max|u_mesh - u_one| "
          f"{du / u_sc:.3e} of max|u|, max|div u| {div:.3e}, "
          f"{wall / N_STEPS * 1e3:.1f} host ms a step" + since())

    # ---- (c) the all-CG configuration and poisson solver = cg -----------
    def all_cg(p):
        p.numerics.fixed_solver_iters = 0
        p.numerics.momentum_fixed_iters = 0
        return p

    def poisson_cg(p):
        p.numerics.poisson_solver = "cg"
        return p

    n_full = n
    for key, opts in (("all_cg", all_cg), ("poisson_cg", poisson_cg)):
        label = f"(c) {key} 2x2"
        # the Jacobi-CG steps stall at 500 iterations, ~2 host s a step
        n = KRYLOV_MESH_CG_STEPS if key == "poisson_cg" else n_full
        one_c = BoussinesqModel(opts(bench_params(BENCH_SHAPE)), device=dev)
        s_c1, d_c1 = steps(one_c, s0, n, "step")
        m = mesh_model(dev, (2, 2), options=opts)
        st0 = shard_state(s0, m.geo, m._mesh.mesh)
        (sm, dm), counts, wall = drive(m, lambda: steps(m, st0, n, "step"))
        want = {k: 0 for k in counts}
        want["forcing_operands"] = n * 4
        if key == "poisson_cg":       # K1o beside the Jacobi-CG Poisson
            want["richardson_operands"] = n * 4
        if counts != want:
            fail(f"13 {label}: launches {counts}, expected {want}")
        # the f32 Jacobi-CG Poisson solve stalls at its cap short of
        # `poisson tol` (phase 10 (d), ROADMAP.md Queue 3): its max|div u|
        # is held to twice one device's
        div_1 = max(d.div_norm for d in d_c1)
        du, u_sc, div = hold_mesh(
            label, unshard_state(sm), s_c1, [d.div_norm for d in dm],
            div_tol=max(1e-4, 2 * div_1) if key == "poisson_cg" else 1e-4)
        its = same_iters(label, iters_of(dm), iters_of(d_c1))
        launches[f"{key}_mesh_2x2"] = counts
        nums[label] = dict(du=du / u_sc, div=div, one_div=div_1,
                           iters=iters_of(dm), one_iters=iters_of(d_c1),
                           host_ms=wall / n * 1e3,
                           kernels=m.sharded_kernels())
        phase(f"13 {label}: {n} steps ({m.sharded_kernels()}), launches "
              f"{counts}, max|u_mesh - u_one| {du / u_sc:.3e} of max|u|, "
              f"max|div u| {div:.3e} (one device {div_1:.3e}), iterations "
              f"{iters_of(dm)}, {its} to one device's; "
              f"{wall / n * 1e3:.1f} host ms a step" + since())
        del m, one_c

    # ---- (d) kernels=False against the kernel path --------------------
    mk = mesh_model(dev, MAIN_MESH)
    mp = on_mesh(BoussinesqModel(bench_params(BENCH_SHAPE), device=dev),
                 MAIN_MESH, kernels=False)
    st0 = shard_state(s0, mk.geo, mk._mesh.mesh)
    s_k, _ = mk.step(st0, dt)
    (s_p, d_p), counts, wall = drive(mp, lambda: mp.step(st0, dt))
    if any(counts.values()):
        fail(f"13 (d) kernels=False: launches {counts}, expected none")
    gk, gp = unshard_state(s_k), unshard_state(s_p)
    du = float((gk.u - gp.u).abs().max())
    u_sc = float(gk.u.abs().max())
    if not du <= 1e-5 * u_sc or not d_p.div_norm <= 1e-4:
        fail(f"13 (d) kernels=False: max|u - u_kernels| {du:.3e} "
             f"(1e-5 x {u_sc:.3e}), max|div u| {d_p.div_norm:.3e}")
    nums["(d) kernels=False"] = dict(du=du / u_sc, div=d_p.div_norm,
                                     host_ms=wall * 1e3,
                                     kernels=mp.sharded_kernels())
    phase(f"13 (d) kernels=False on {MAIN_MESH[0]}x{MAIN_MESH[1]} "
          f"({mp.sharded_kernels()}): launches {counts}, max|u - "
          f"u_kernels| {du / u_sc:.3e} of max|u| (tol 1e-5), max|div u| "
          f"{d_p.div_norm:.3e}, {wall * 1e3:.1f} host ms" + since())
    del mk, mp

    # ---- (f) the semi-Lagrangian escalated step: K2mo -----------------
    sl_one = BoussinesqModel(sl_params(bench_params(BENCH_SHAPE)),
                             device=dev)
    s_sl1, d_sl1 = steps(sl_one, s0, 1, "step_strong")
    m = mesh_model(dev, MAIN_MESH, options=sl_params)
    st0 = shard_state(s0, m.geo, m._mesh.mesh)
    (sm, dm), counts, wall = drive(m, lambda: steps(m, st0, 1,
                                                    "step_strong"))
    want = {**{k: 0 for k in counts}, "forcing_momentum_operands": AB}
    if counts != want:
        fail(f"13 (f) SL step_strong: launches {counts}, expected {want}")
    du, u_sc, div = hold_mesh("(f) SL step_strong", unshard_state(sm),
                              s_sl1, [d.div_norm for d in dm])
    launches["sl_escalated_mesh_2x4"] = counts
    phase(f"13 (f) SL step_strong on {MAIN_MESH[0]}x{MAIN_MESH[1]}: "
          f"launches {counts}, max|u_mesh - u_one| {du / u_sc:.3e} of "
          f"max|u|, max|div u| {div:.3e}, iterations {iters_of(dm)} "
          f"({same_iters('SL', iters_of(dm), iters_of(d_sl1))})" + since())
    del m, sl_one

    # ---- (e) the mimetic shell on the mesh ----------------------------
    mim_one = make_model(mimetic(bench_params(BENCH_SHAPE)), device=dev)
    sm0 = seed_developed_flow(mim_one)
    k = KRYLOV_MESH_MIM_STEPS
    s_m1, d_m1 = steps(mim_one, sm0, k, "step")
    m = on_mesh(make_model(mimetic(bench_params(BENCH_SHAPE)), device=dev),
                MAIN_MESH)
    st0 = shard_state(sm0, m.geo, m._mesh.mesh)
    (sm, dm), counts, wall = drive(m, lambda: steps(m, st0, k, "step"))
    if any(counts.values()):
        fail(f"13 (e) mimetic: launches {counts}, expected none")
    label = f"(e) mimetic {MAIN_MESH[0]}x{MAIN_MESH[1]}"
    du, u_sc, div = hold_mesh(label, unshard_state(sm), s_m1,
                              [d.div_norm for d in dm])
    its = same_iters(label, iters_of(dm), iters_of(d_m1))
    nums[label] = dict(du=du / u_sc, div=div, iters=iters_of(dm),
                       host_ms=wall / k * 1e3, kernels=m.sharded_kernels())
    phase(f"13 {label}: {k} steps ({m.sharded_kernels()}), max|u_mesh - "
          f"u_one| {du / u_sc:.3e} of max|u|, max|div u| {div:.3e}, "
          f"iterations {iters_of(dm)}, {its} to one device's; "
          f"{wall / k * 1e3:.1f} host ms a step" + since())
    del m, mim_one
    phase(f"13 total {time.perf_counter() - t0:.1f} s")
    return launches, nums


# ---------------------------------------------------------------- phase 14
MG_COMPARE_CAP = 16
MG_PROFILE_CAP = 0
COUPLED_MESH_SHAPE = (16, 64, 128)


def radial_mg(model):
    """``model`` with its V-cycle rebuilt as the mesh rebuilds it (the line
    smoother on the radial axis alone, on the model's K4 wrapper): the
    single-device yardstick of the mesh's MG."""
    from dycoreplanet_tpu_torch.solvers.multigrid import PoissonMultigrid

    model.poisson_precond = PoissonMultigrid(
        model.geo, model.p_specs, dtype=model.torch_dtype,
        device=model.device, tridiag=model._tridiag, line_axes_allowed=(0,))
    return model


class RhsDtypes:
    """A K4 wrapper's stand-in that records the dtype of every rhs and
    passes the call on (the wrapper still launches and counts)."""

    def __init__(self, base):
        self.base = base
        self.dtypes = set()

    def __call__(self, lower, diag, upper, rhs):
        self.dtypes.add(rhs.dtype)
        return self.base(lower, diag, upper, rhs)


def check_sharded_mg_k4(dev, m):
    """One shard's radial line solve of the mesh's V-cycle at level 0
    (the shard's (nr, nl, no) coefficients and a seeded residual of its
    shape, as ``shard_operands`` passes them): K4 against its plain
    version (rtol = atol = 1e-5 x scale), nothing copied, the wrapper's
    time over 50 calls, the plain version's, the bound (5 values a cell:
    lower, diag, upper and the rhs read, x written)."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.ops import tridiag as k4

    mg = m._mesh.multigrid
    tk = k4.TridiagSolve()
    gen = torch.Generator(device=dev).manual_seed(21)
    r = torch.randn(mg.ops[0].local, generator=gen, device=dev)
    ops = mg.shard_operands(0, (0, 0), r)
    lay = k4.layout(*ops, pair=tk.pair)
    if lay.copied or ops[3] is not r:
        fail(f"14 (a) K4 sharded MG: copied {lay.copied}")
    want = tk.plain(*ops)
    sc = float(want.abs().max())
    err = check_k4("K4 tridiag sharded MG (radial)", tk, ops, want,
                   1e-5 * sc)
    moved = k4.values_moved(*ops)
    b_ms, b_by = bound_of(4 * moved, k4.OPS_PER_VALUE * r.numel())
    out = dict(max_abs_err=err, ms=time_ms(lambda: tk(*ops)),
               plain_ms=time_ms(lambda: tk.plain(*ops), reps=10),
               bound_ms=b_ms, bound_by=b_by, values_moved=moved,
               shard=tuple(r.shape), copies=tk.copies)
    if tk.copies:
        fail(f"14 (a) K4 sharded MG: the wrapper copied {tk.copies}")
    phase(f"14 (a) K4 tridiag, the sharded MG's radial lines at level 0 "
          f"(shard (0, 0) of {mg.mesh.shape['lat']}x{mg.mesh.shape['lon']}, "
          f"rhs {tuple(r.shape)}, columns {[s_ for s_, _ in lay.axes]}): max "
          f"abs err {err:.3e} (tol {1e-5 * sc:.3e}), 0 operands copied; "
          f"kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, "
          f"bound {b_ms * 1e3:.2f} us ({b_by}; {moved} values moved)")
    return out


def mesh_solve_phases(dev):
    """Phase 14: the multigrid and the coupled solves on the mesh at
    BENCH_SHAPE from the seeded flow, every shard on the one card: (a)
    `poisson solver = mg`, f32, one step on 2x2 and one on 2x4, the CG
    capped at MG_COMPARE_CAP on both sides: K4 A*B x
    line_solves_per_cycle x (CG iterations + 1) times exactly, K2o and
    K1o A*B times, the CG counts equal to one device's with the
    radial-only rebuild, u and T within 1e-5 of max|u|, max|div u|
    within twice one device's; one shard's K4 against its plain version; one V-cycle
    of the 2x4 step profiled (device ms, kernels, host launches, syncs,
    host ms) beside one device's; (b) the FEEC 3x3 with the flagship's
    physics on 2x4, one step from one device's first: the outer count
    against one device's, u within 1e-4 of max|u|, max|div u|, host ms,
    the device stream's elapsed ms, host syncs; (c) the shell's 2x2
    block FGMRES and Schur GMRES at COUPLED_MESH_SHAPE on 2x2, 2 steps
    each, against one device; (d) one bf16 MG step on 2x4, within 2^-7
    of one device's bf16 step (radial-only), every K4 rhs bf16. Returns
    ({path: launches}, the sharded K4 row's numbers)."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.parallel.mesh import (
        Mesh, shard_state, unshard_state)

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    launches, k4_row = {}, {}
    dt = BENCH_DT

    def steps(model, s, k):
        ds = []
        for _ in range(k):
            s, d = model.step(s, dt)
            d.cfl                       # the step's diagnostics copy
            ds.append(d)
        return s, ds

    def on_mesh(model, shape):
        A, B = shape
        return model.prepare_sharded(Mesh(np.array([[dev] * B] * A,
                                                   dtype=object),
                                          ("lat", "lon")))

    def mg(p):
        p.numerics.poisson_solver = "mg"
        return p

    def profile(label, m, st):
        """One step of m from st profiled, its host syncs and host ms."""
        prof = step_profile(lambda: m.step(st, dt)[1].cfl, 1)
        _, syncs = count_syncs(lambda: m.step(st, dt)[1].cfl)
        _, _, wall = drive(m, lambda: m.step(st, dt)[1].cfl)
        out = dict(device_ms=prof["device_ms_per_step"],
                   kernels=prof["kernels_per_step"],
                   host_launches=prof["host_launches_per_step"],
                   busy=prof["busy_share"], syncs=syncs, host_ms=wall * 1e3,
                   kernel_ms=prof["kernel_ms_per_step"])
        phase(f"14 {label} profiled step: {out['device_ms']:.3f} device ms "
              f"in {out['kernels']:.0f} kernels, {out['host_launches']:.0f} "
              f"host launches, {syncs} host syncs, {out['host_ms']:.1f} "
              f"host ms, busy {out['busy']:.3f}; hand kernels' device ms "
              f"{ {k: round(v, 4) for k, v in out['kernel_ms'].items()} }"
              + since())
        return out

    # ---- (a) poisson solver = mg on 2x2 and 2x4 -------------------------
    # relaxing along r alone the f32 MG-CG takes ~215 iterations a step
    # where one device's two-axis V-cycle takes 11 (~13 host s a step on
    # one device, ~74 on 2x2), and the step ends at max|div u| ~5.6e-4 on
    # one device too. So each mesh takes one step with the CG capped at
    # MG_COMPARE_CAP on both sides, equal counts, its divergence held to
    # twice one device's; the profile reads a 2x4 step capped at
    # MG_PROFILE_CAP (one V-cycle), as phase 8 (a) caps the FEEC prm's
    def capped(model, cap, fn):
        keep = model.params.numerics.max_cg_iters
        model.params.numerics.max_cg_iters = cap
        try:
            return fn()
        finally:
            model.params.numerics.max_cg_iters = keep

    one = radial_mg(BoussinesqModel(mg(bench_params(BENCH_SHAPE)),
                                    device=dev))
    s0 = seed_developed_flow(one)
    cap_one, _, w_one = drive(one, lambda: capped(
        one, MG_COMPARE_CAP, lambda: steps(one, s0, 1)))
    phase(f"14 (a) mg one device, radial-only V-cycle, CG capped at "
          f"{MG_COMPARE_CAP}: CG iterations {cap_one[1][0].poisson_iters}, "
          f"max|div u| {cap_one[1][0].div_norm:.3e}, {w_one * 1e3:.1f} host "
          f"ms a step" + since())
    for (A, B), cap in (((2, 2), MG_COMPARE_CAP),
                        (MAIN_MESH, MG_COMPARE_CAP)):
        label = f"(a) mg {A}x{B}, CG capped at {cap}"
        m = mesh_model(dev, (A, B), options=mg)
        mgs = m._mesh.multigrid
        if m.sharded_kernels()["poisson"] != "mg-cg" or mgs.line_axes != [0]:
            fail(f"14 {label}: {m.sharded_kernels()}, line axes "
                 f"{mgs.line_axes}")
        per_cycle = mgs.line_solves_per_cycle()
        st0 = shard_state(s0, m.geo, m._mesh.mesh)
        (sm, dm), counts, wall = drive(m, lambda: capped(
            m, cap, lambda: steps(m, st0, 1)))
        want_s, want_d = cap_one
        its, its_one = dm[0].poisson_iters, want_d[0].poisson_iters
        cycles = its + 1
        want = {**{k: 0 for k in counts}, "forcing_operands": A * B,
                "richardson_operands": A * B,
                "tridiag": A * B * per_cycle * cycles}
        if counts != want:
            fail(f"14 {label}: launches {counts}, expected {want}")
        du, u_sc, div = hold_mesh(
            label, unshard_state(sm), want_s, [dm[0].div_norm], tol=1e-5,
            div_tol=max(1e-4, 2 * want_d[0].div_norm), tag="14")
        if its != its_one:
            fail(f"14 {label}: CG iterations {its}, one device {its_one}")
        launches[f"mg_mesh_{A}x{B}"] = counts
        phase(f"14 {label}: 1 step, launches {counts} ({A * B} shards x "
              f"{per_cycle} line solves a V-cycle x {cycles} V-cycles), "
              f"max|u_mesh - u_one| {du / u_sc:.3e} of max|u|, max|div u| "
              f"{div:.3e} (one device {want_d[0].div_norm:.3e}), CG "
              f"iterations {its} (one device, radial-only, {its_one}); "
              f"{wall * 1e3:.1f} host ms a step, "
              f"{wall / cycles * 1e3:.1f} a V-cycle" + since())
        if (A, B) == MAIN_MESH:
            k4_row = check_sharded_mg_k4(dev, m)
            prof = capped(m, MG_PROFILE_CAP, lambda: profile(
                f"{label}, CG capped at {MG_PROFILE_CAP}", m, st0))
            k4_row.update(step=prof, per_cycle=per_cycle,
                          launches=counts["tridiag"],
                          in_step_ms=prof["kernel_ms"].get("tridiag", 0.0)
                          / (A * B * per_cycle * (MG_PROFILE_CAP + 1)))
        del m
    k4_row["one_device_step"] = capped(one, MG_PROFILE_CAP, lambda: profile(
        f"(a) mg one device (radial-only), CG capped at {MG_PROFILE_CAP}",
        one, s0))
    del one

    # ---- (d) one bf16 MG step on 2x4 ----------------------------------
    one_b = radial_mg(BoussinesqModel(mg(bench_params(BENCH_SHAPE, BF16)),
                                      device=dev))
    sb0 = seed_developed_flow(one_b)
    sb_one, db_one = one_b.step(sb0, dt)
    m = mesh_model(dev, MAIN_MESH, dtype=BF16, options=mg)
    rec = RhsDtypes(m._mesh.multigrid.tridiag)
    m._mesh.multigrid.tridiag = rec
    (sb, db), counts, _ = drive(m, lambda: m.step(
        shard_state(sb0, m.geo, m._mesh.mesh), dt))
    g = unshard_state(sb)
    worst = 0.0
    for name, x, y in zip(("u", "p", "T"), (g.u, g.p, g.T),
                          (sb_one.u, sb_one.p, sb_one.T)):
        if x.dtype != torch.bfloat16 or not bool(torch.isfinite(x).all()):
            fail(f"14 (d) bf16 mg: {name} {x.dtype}, finite "
                 f"{bool(torch.isfinite(x).all())}")
        rel = float((x.float() - y.float()).abs().max()
                    / y.float().abs().max())
        worst = max(worst, rel)
    if not worst <= 2.0 ** -7 or rec.dtypes != {torch.bfloat16}:
        fail(f"14 (d) bf16 mg: max rel diff {worst:.3e} (bound 2^-7), K4 "
             f"rhs dtypes {rec.dtypes}")
    if db.poisson_iters - db_one.poisson_iters not in (-1, 0, 1):
        fail(f"14 (d) bf16 mg: {db.poisson_iters} CG iterations, one "
             f"device {db_one.poisson_iters}")
    launches["bf16_mg_mesh_2x4"] = counts
    phase(f"14 (d) bf16 mg {MAIN_MESH[0]}x{MAIN_MESH[1]}: 1 step, launches "
          f"{counts}, every K4 rhs bf16, max rel diff to one device's "
          f"{worst:.3e} (bound 2^-7), CG iterations {db.poisson_iters} (one "
          f"device {db_one.poisson_iters}), max|div u| {db.div_norm:.3e} "
          f"(one device {db_one.div_norm:.3e})" + since())
    del m, one_b

    # ---- (b) the FEEC 3x3 with the flagship's physics on 2x4 ----------
    # from one device's first step (the seeded flow's own first step takes
    # ~70 outer iterations, the next ~14); the mesh step holds ~10^5
    # kernels, more than a profile reads within the phase's time: its host
    # ms and syncs, and the device stream's elapsed time between two events
    def feec(p):
        p.use_FEEC_solver = True
        return p

    one_f = BoussinesqModel(feec(bench_params(BENCH_SHAPE)), device=dev)
    sf1, _ = one_f.step(seed_developed_flow(one_f), dt)
    (sf_one, df_one), _, w_1 = drive(one_f, lambda: steps(one_f, sf1, 1))
    m = mesh_model(dev, MAIN_MESH, options=feec)
    if m.momentum_solver != "coupled" or m.sharded_kernels()["forcing"] \
            != "jnp":
        fail(f"14 (b) FEEC: {m.momentum_solver}, {m.sharded_kernels()}")
    stf = shard_state(sf1, m.geo, m._mesh.mesh)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_step():
        ev[0].record()
        out = steps(m, stf, 1)
        ev[1].record()
        return out

    (sm, dm), counts, wall = drive(m, timed_step)
    if any(counts.values()):
        fail(f"14 (b) FEEC: launches {counts}, expected none")
    label = f"(b) FEEC 3x3 {MAIN_MESH[0]}x{MAIN_MESH[1]}"
    du, u_sc, div = hold_mesh(label, unshard_state(sm), sf_one,
                              [d.div_norm for d in dm], tag="14")
    outer, outer_1 = dm[0].poisson_iters, df_one[0].poisson_iters
    if abs(outer - outer_1) > 1:
        fail(f"14 {label}: outer iterations {outer}, one device {outer_1}")
    _, syncs = count_syncs(lambda: m.step(stf, dt)[1].cfl)
    _, syncs_1 = count_syncs(lambda: one_f.step(sf1, dt)[1].cfl)
    torch.cuda.synchronize()
    launches["feec_mesh_2x4"] = counts
    phase(f"14 {label}: 1 step (flagship physics) from one device's "
          f"first, {outer} outer iterations (one device {outer_1}), "
          f"max|u_mesh - u_one| {du / u_sc:.3e} of max|u|, max|div u| "
          f"{div:.3e}, gate {dm[0].solver_ok}; {wall * 1e3:.1f} host ms a "
          f"step ({wall / outer * 1e3:.1f} an outer iteration), device "
          f"stream {ev[0].elapsed_time(ev[1]):.1f} ms, {syncs} host syncs; "
          f"one device {w_1 * 1e3:.1f} host ms, {syncs_1} syncs" + since())
    del m, one_f

    # ---- (c) the shell's 2x2 block FGMRES and Schur GMRES on 2x2 ------
    for key, schur in (("fgmres", False), ("schur", True)):
        def coupled(p, schur=schur):
            p.numerics.momentum_solver = "coupled"
            p.use_schur_complement_solver = schur
            return p

        one_c = BoussinesqModel(coupled(bench_params(COUPLED_MESH_SHAPE)),
                                device=dev)
        sc0 = seed_developed_flow(one_c)
        sc_one, dc_one = steps(one_c, sc0, 2)
        m = on_mesh(BoussinesqModel(coupled(bench_params(
            COUPLED_MESH_SHAPE)), device=dev), (2, 2))
        stc = shard_state(sc0, m.geo, m._mesh.mesh)
        (sm, dm), counts, wall = drive(m, lambda: steps(m, stc, 2))
        label = f"(c) coupled {key} 2x2 {COUPLED_MESH_SHAPE}"
        du, u_sc, div = hold_mesh(label, unshard_state(sm), sc_one,
                                  [d.div_norm for d in dm],
                                  div_tol=max(1e-4, 2 * max(
                                      d.div_norm for d in dc_one)),
                                  tag="14")
        outer = [d.poisson_iters for d in dm]
        outer_1 = [d.poisson_iters for d in dc_one]
        if any(abs(a - b) > 1 for a, b in zip(outer, outer_1)) or any(
                counts.values()):
            fail(f"14 {label}: outer iterations {outer}, one device "
                 f"{outer_1}, launches {counts}")
        launches[f"coupled_{key}_mesh_2x2"] = counts
        phase(f"14 {label}: 2 steps, outer iterations {outer} (one device "
              f"{outer_1}), max|u_mesh - u_one| {du / u_sc:.3e} of max|u|, "
              f"max|div u| {div:.3e}, gate {[d.solver_ok for d in dm]}; "
              f"{wall / 2 * 1e3:.1f} host ms a step" + since())
        del m, one_c
    phase(f"14 total {time.perf_counter() - t0:.1f} s")
    return launches, k4_row


# ---------------------------------------------------------------- phase 15
# the annulus, the 3D box and the 2D slab on their own meshes (("phi",),
# ("y", "x"), ("x",)), every shard on the one card: (a) the annulus prm at
# work size on GEO_PHI_SHARDS; (b) the box on GEO_BOX_MESH; (c) the
# mimetic personality on the three meshes; (d) poisson solver = mg
# (CG capped at GEO_MG_CAP on both sides); (e) f64 card vs CPU; (f) a
# sharded checkpoint round trip
GEO_PHI_SHARDS = (4, 8)
GEO_BOX_MESH = (2, 4)
GEO_RUN_STEPS = 5
GEO_STD_STEPS = 2
# the standard box's escalations in GEO_STD_STEPS steps at 128^3 in f32:
# every fast try misses its temperature gate by physics (ROADMAP.md Queue
# 3), so the first step escalates and the next run inside the CG window
# it opens: every step is a CG step
GEO_STD_ESCALATIONS = 1
GEO_MG_CAP = 8
# (b): the outer cap of the cube's FEEC 3x3 on both sides (its step from
# one device's first takes ~119 outer iterations, ~40 host s on 2x4)
GEO_FEEC_CAP = 32
# (c): the mimetic cases' sizes (`initial global refinement`, the slab's
# shape) and steps
GEO_MIM_REF = {"box": 6, "annulus": 6}
GEO_MIM_SLAB = (128, 512)
GEO_MIM_STEPS = 2
# (e): small f64 grids (annulus 16 x 192, box 16^3)
GEO_F64_REF = {"annulus": 4, "box": 4}


def geo_mesh(dev, geo, shards):
    """The geometry's mesh (parallel/mesh.py build_mesh's layout) of
    ``shards`` shards, every one on dev; a pair is the box's A x B."""
    import numpy as np
    from dycoreplanet_tpu_torch.parallel.mesh import Mesh, mesh_axes

    names = mesh_axes(geo)
    if len(names) == 1:
        return Mesh(np.array([dev] * shards, dtype=object), names)
    A, B = shards
    return Mesh(np.array([[dev] * B] * A, dtype=object), names)


def check_geo_mg_k4(dev, geo, p_specs, shards):
    """One shard's radial line solve of the annulus mesh's V-cycle at level
    0 (its (nr, no) coefficients, as ``shard_operands`` passes them, and a
    seeded residual of its shape), f32 and f64: K4 against its plain
    version (rtol = atol = 1e-5 x scale, f64 1e-12 x scale), nothing
    copied, the wrapper's time over 50 calls, the plain version's, the
    bound (5 values a cell: lower, diag, upper and the rhs read, x
    written). Returns {dtype: numbers}."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.ops import tridiag as k4
    from dycoreplanet_tpu_torch.solvers.multigrid import (
        PoissonMultigrid, ShardedPoissonMultigrid)

    out = {}
    mesh = geo_mesh(dev, geo, shards)
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        tk = k4.TridiagSolve()
        mg = ShardedPoissonMultigrid(PoissonMultigrid(
            geo, p_specs, dtype=dtype, device=dev, tridiag=tk,
            line_axes_allowed=(0,)), mesh)
        gen = torch.Generator(device=dev).manual_seed(22)
        r = torch.randn(mg.ops[0].local, generator=gen, device=dev,
                        dtype=dtype)
        ops = mg.shard_operands(0, (0, 0), r)
        lay = k4.layout(*ops, pair=tk.pair)
        if lay.copied or ops[3] is not r:
            fail(f"15 (d) K4 annulus mesh MG: copied {lay.copied}")
        want = tk.plain(*ops)
        sc = float(want.abs().max())
        name = str(dtype).replace("torch.", "")
        err = check_k4(f"K4 tridiag annulus mesh MG ({name})", tk, ops,
                       want, rel * sc)
        moved = k4.values_moved(*ops)
        b_ms, b_by = bound_of(r.element_size() * moved,
                              k4.OPS_PER_VALUE * r.numel())
        row = dict(max_abs_err=err, ms=time_ms(lambda: tk(*ops)),
                   plain_ms=time_ms(lambda: tk.plain(*ops), reps=10),
                   bound_ms=b_ms, bound_by=b_by, values_moved=moved,
                   shard=tuple(r.shape), copies=tk.copies)
        if tk.copies:
            fail(f"15 (d) K4 annulus mesh MG: the wrapper copied "
                 f"{tk.copies}")
        out[name] = row
        phase(f"15 (d) K4 tridiag, the annulus mesh's radial lines at "
              f"level 0, {name} (shard (0, 0) of {shards} phi shards, rhs "
              f"{tuple(r.shape)}, columns {[s_ for s_, _ in lay.axes]}): "
              f"max abs err {err:.3e} (tol {rel * sc:.3e}), 0 operands "
              f"copied; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {b_ms * 1e3:.2f} us "
              f"({b_by}; {moved} values moved)")
    return out


def geometry_mesh_phases(dev):
    """Phase 15: the annulus, the 3D box and the 2D slab on their own
    meshes, every shard on the one card. (a) The annulus prm at work size
    (f32) on 4 and 8 phi shards: GEO_RUN_STEPS steps through run, u and T
    within 1e-4 of one device's run, max|div u| <= 1e-4, escalations
    equal to one device's; one 8-shard step profiled (device ms, kernels,
    host launches, host syncs, host ms, busy share). (b) The box on
    GEO_BOX_MESH: the standard personality at 128^3, GEO_STD_STEPS steps
    through run, every step escalated as on one device, equal CG counts;
    the cube prm's FEEC 3x3 at 64^3, one step from one device's first,
    outer iterations within one of one device's. (c) The mimetic box,
    annulus and slab on their meshes, GEO_MIM_STEPS steps against one
    device. (d) `poisson solver = mg` on the annulus (8 shards) and the
    walled box (GEO_BOX_MESH), one step with the CG capped at GEO_MG_CAP
    on both sides (one device with the radial-only rebuild): K4 exactly
    shards x line solves a V-cycle x V-cycles (the box smooths by
    Jacobi: 0), one shard's K4 against its plain version in f32 and f64,
    nothing copied, one V-cycle's step profiled. (e) One f64 step of an annulus mesh and a box mesh
    on the card against the same on the CPU. (f) A sharded checkpoint of
    each round trip, bitwise. Returns ({path: launches}, the K4 row's
    numbers)."""
    import tempfile

    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.io import checkpoint as ck
    from dycoreplanet_tpu_torch.models import BoussinesqModel, make_model
    from dycoreplanet_tpu_torch.models.convert import (
        state_from_numpy, state_to_numpy)
    from dycoreplanet_tpu_torch.parallel.mesh import (
        shard_state, unshard_state)

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    launches, k4_row = {}, {}

    def on_mesh(model, shards):
        return model.prepare_sharded(geo_mesh(dev, model.geo, shards))

    def label_of(model):
        mesh = model._mesh.mesh
        if len(mesh.axis_names) == 1:
            return f"{mesh.grid[1]} {mesh.axis_names[0]} shards"
        return f"{mesh.grid[0]}x{mesh.grid[1]}"

    def steps(model, s, k, dt):
        ds = []
        for _ in range(k):
            s, d = model.step(s, dt)
            d.cfl
            ds.append(d)
        return s, ds

    def run_vs_one(tag, make, shards, n, div_tol=1e-4):
        """n steps through run on the mesh against one device's run:
        escalations equal, the states within 1e-4, the histories' CG
        counts returned."""
        one = make()
        (s1, h1), _, w1 = drive(one, lambda: one.run(max_steps=n))
        m = on_mesh(make(), shards)
        (sm, hm), counts, wm = drive(m, lambda: m.run(max_steps=n))
        label = f"{tag} {label_of(m)}"
        if m.escalations != one.escalations:
            fail(f"15 {label}: {m.escalations} escalation(s), one device "
                 f"{one.escalations}")
        du, u_sc, div = hold_mesh(label, unshard_state(sm), s1,
                                  [h["div_norm"] for h in hm],
                                  div_tol=div_tol, tag="15")
        return dict(m=m, one=one, counts=counts, du=du / u_sc, div=div,
                    host_ms=wm / n * 1e3, host_ms_one=w1 / n * 1e3,
                    its=[(h["poisson_iters"], h["temperature_iters"])
                         for h in hm],
                    its_one=[(h["poisson_iters"], h["temperature_iters"])
                             for h in h1], state=sm)

    # ---- (a) the annulus prm at work size on 4 and 8 phi shards --------
    for shards in GEO_PHI_SHARDS:
        r = run_vs_one("(a) annulus", lambda: BoussinesqModel(
            annulus_params(), device=dev), shards, GEO_RUN_STEPS)
        if any(r["counts"].values()):
            fail(f"15 (a) annulus {shards}: launches {r['counts']}")
        launches[f"annulus_mesh_{shards}"] = r["counts"]
        phase(f"15 (a) annulus {r['m'].geo.cell_shape} on "
              f"{label_of(r['m'])}: {GEO_RUN_STEPS} steps through run, "
              f"{r['m'].escalations} escalation(s) (one device "
              f"{r['one'].escalations}), max|u_mesh - u_one| "
              f"{r['du']:.3e} of max|u|, max|div u| {r['div']:.3e}, "
              f"Krylov (poisson, temperature) {r['its']} (one device "
              f"{r['its_one']}); {r['host_ms']:.1f} host ms a step (one "
              f"device {r['host_ms_one']:.1f}), launches {r['counts']}"
              + since())
        if shards == GEO_PHI_SHARDS[-1]:
            m, st = r["m"], r["state"]
            dt = m.params.time_step
            prof = step_profile(lambda: m.step(st, dt)[1].cfl, 1)
            _, syncs = count_syncs(lambda: m.step(st, dt)[1].cfl)
            _, _, wall = drive(m, lambda: m.step(st, dt)[1].cfl)
            one, s1 = r["one"], unshard_state(st)
            prof1 = step_profile(lambda: one.step(s1, dt)[1].cfl, 1)
            _, syncs1 = count_syncs(lambda: one.step(s1, dt)[1].cfl)
            phase(f"15 (a) annulus {shards} phi shards, one step profiled: "
                  f"{prof['device_ms_per_step']:.3f} device ms in "
                  f"{prof['kernels_per_step']:.0f} kernels, "
                  f"{prof['host_launches_per_step']:.0f} host launches, "
                  f"{syncs} host syncs, {wall * 1e3:.1f} host ms, busy "
                  f"{prof['busy_share']:.3f}; one device "
                  f"{prof1['device_ms_per_step']:.3f} device ms in "
                  f"{prof1['kernels_per_step']:.0f} kernels, {syncs1} "
                  f"syncs, busy {prof1['busy_share']:.3f}" + since())
        del r

    # ---- (b) the box on 2x4 --------------------------------------------
    r = run_vs_one("(b) box standard", lambda: BoussinesqModel(
        cube_params(CUBE_STD_REF, feec=False), device=dev), GEO_BOX_MESH,
        GEO_STD_STEPS)
    window = (r["m"]._strong_steps_left, r["one"]._strong_steps_left)
    if r["m"].escalations != GEO_STD_ESCALATIONS or window[0] != window[1]:
        fail(f"15 (b) box: {r['m'].escalations} escalation(s) in "
             f"{GEO_STD_STEPS} steps, expected {GEO_STD_ESCALATIONS}; CG "
             f"window left {window[0]}, one device {window[1]}")
    diff = same_iters("(b) box standard", r["its"], r["its_one"], tag="15")
    launches["box_std_mesh_2x4"] = r["counts"]
    phase(f"15 (b) box standard {r['m'].geo.cell_shape} on "
          f"{label_of(r['m'])}: {GEO_STD_STEPS} steps through run, "
          f"{r['m'].escalations} escalation(s) (one device "
          f"{r['one'].escalations}: the first step misses its f32 gate, "
          f"expected, the next runs in the CG window it opens; "
          f"{window[0]} strong steps left as one device), CG (poisson, "
          f"temperature) {r['its']} ({diff}), "
          f"max|u_mesh - u_one| {r['du']:.3e} of max|u|, max|div u| "
          f"{r['div']:.3e}; {r['host_ms']:.1f} host ms a step (one device "
          f"{r['host_ms_one']:.1f})" + since())
    del r

    one = BoussinesqModel(cube_params(CUBE_3X3_REF, schur=False,
                                      max_cg_iters=GEO_FEEC_CAP), device=dev)
    dt = one.params.time_step
    sf1, _ = one.step(one.initial_state(), dt)
    (sf_one, df_one), _, w1 = drive(one, lambda: steps(one, sf1, 1, dt))
    m = on_mesh(BoussinesqModel(cube_params(CUBE_3X3_REF, schur=False,
                                            max_cg_iters=GEO_FEEC_CAP),
                                device=dev), GEO_BOX_MESH)
    stf = shard_state(sf1, m.geo, m._mesh.mesh)
    ((sm, dm), counts, wall), syncs = count_syncs(
        lambda: drive(m, lambda: steps(m, stf, 1, dt)))
    label = f"(b) cube FEEC 3x3 {m.geo.cell_shape} {label_of(m)}"
    du, u_sc, div = hold_mesh(label, unshard_state(sm), sf_one,
                              [d.div_norm for d in dm], tag="15")
    outer, outer_1 = dm[0].poisson_iters, df_one[0].poisson_iters
    if abs(outer - outer_1) > 1 or any(counts.values()):
        fail(f"15 {label}: outer iterations {outer}, one device {outer_1}, "
             f"launches {counts}")
    launches["cube_feec_mesh_2x4"] = counts
    phase(f"15 {label}: 1 step from one device's first, {outer} outer "
          f"iterations (one device {outer_1}; the cap {GEO_FEEC_CAP} on "
          f"both), max|u_mesh - u_one| "
          f"{du / u_sc:.3e} of max|u|, max|div u| {div:.3e}, gate "
          f"{dm[0].solver_ok}; {wall * 1e3:.1f} host ms (one device "
          f"{w1 * 1e3:.1f}), {syncs} host syncs" + since())
    del m, one

    # ---- (c) the mimetic box, annulus and slab on their meshes --------
    for key, make, shards in (
            ("box", lambda: cube_params(GEO_MIM_REF["box"]), GEO_BOX_MESH),
            ("annulus", lambda: annulus_params(
                refinement=GEO_MIM_REF["annulus"]), GEO_PHI_SHARDS[-1]),
            ("slab", lambda: slab_params(GEO_MIM_SLAB), GEO_PHI_SHARDS[0])):
        if key == "slab":
            # the slab has no curl (no mimetic model, in both packages):
            # its standard personality with the SL transport
            def params(make=make):
                p = make()
                p.numerics.temperature_advection = "semi-lagrangian"
                return p
        else:
            def params(make=make):
                return mimetic(make())
        r = run_vs_one(f"(c) {key}", lambda: make_model(params(),
                                                        device=dev),
                       shards, GEO_MIM_STEPS, div_tol=1e-3)
        diff = same_iters(f"(c) {key}", r["its"], r["its_one"], tag="15")
        launches[f"mimetic_{key}_mesh"] = r["counts"]
        phase(f"15 (c) {type(r['m']).__name__} {key} "
              f"{r['m'].geo.cell_shape} on {label_of(r['m'])}: "
              f"{GEO_MIM_STEPS} steps through run, {r['m'].escalations} "
              f"escalation(s) (one device {r['one'].escalations}), Krylov "
              f"{r['its']} ({diff}), max|u_mesh - u_one| {r['du']:.3e} of "
              f"max|u|, max|div u| {r['div']:.3e}; {r['host_ms']:.1f} host "
              f"ms a step" + since())
        del r

    # ---- (d) poisson solver = mg on the annulus and the walled box ----
    for key, make, shards in (
            ("annulus", lambda: annulus_params(poisson_solver="mg"),
             GEO_PHI_SHARDS[-1]),
            ("box", lambda: cube_params(CUBE_3X3_REF, feec=False,
                                        poisson_solver="mg"),
             GEO_BOX_MESH)):
        one = radial_mg(BoussinesqModel(make(), device=dev))
        m = on_mesh(BoussinesqModel(make(), device=dev), shards)
        dt = one.params.time_step
        one.params.numerics.max_cg_iters = GEO_MG_CAP
        m.params.numerics.max_cg_iters = GEO_MG_CAP
        s0 = one.initial_state()
        (s_one, d_one), c_one, w1 = drive(one, lambda: steps(one, s0, 1, dt))
        st0 = shard_state(s0, m.geo, m._mesh.mesh)
        (sm, dm), counts, wall = drive(m, lambda: steps(m, st0, 1, dt))
        mgs = m._mesh.multigrid
        per_cycle = mgs.line_solves_per_cycle()
        n_shards = int(np.prod(m._mesh.mesh.grid))
        its, its_one = dm[0].poisson_iters, d_one[0].poisson_iters
        want = n_shards * per_cycle * (its + 1)
        if counts["tridiag"] != want or its != its_one:
            fail(f"15 (d) mg {key}: K4 {counts['tridiag']} launches, "
                 f"expected {n_shards} x {per_cycle} x {its + 1} = {want}; "
                 f"CG iterations {its}, one device {its_one}")
        label = f"(d) mg {key} {m.geo.cell_shape} {label_of(m)}"
        du, u_sc, div = hold_mesh(label, unshard_state(sm), s_one,
                                  [d.div_norm for d in dm], tol=1e-4,
                                  div_tol=max(1e-4, 2 * d_one[0].div_norm),
                                  tag="15")
        launches[f"mg_{key}_mesh"] = counts
        phase(f"15 {label}, CG capped at {GEO_MG_CAP}: launches {counts} "
              f"({n_shards} shards x {per_cycle} line solves a V-cycle "
              f"({mgs.smoother} smoother) x {its + 1} V-cycles), 0 copies "
              f"({m._tridiag.copies}), CG iterations {its} (one device "
              f"{its_one}, K4 {c_one['tridiag']}), max|u_mesh - u_one| "
              f"{du / u_sc:.3e} of max|u|, max|div u| {div:.3e}; "
              f"{wall * 1e3:.1f} host ms (one device {w1 * 1e3:.1f})"
              + since())
        if m._tridiag.copies:
            fail(f"15 {label}: K4 copied {m._tridiag.copies} operands")
        if key == "annulus":
            by_dtype = check_geo_mg_k4(dev, m.geo, m.p_specs, shards)
            # one V-cycle's step (the CG capped at 0): a whole step's
            # ~140,000 kernels take the profiler ~90 s to read
            m.params.numerics.max_cg_iters = 0
            prof = step_profile(lambda: m.step(st0, dt)[1].cfl, 1)
            in_step = prof["kernel_ms_per_step"].get("tridiag", 0.0) / (
                n_shards * per_cycle)
            k4_row = dict(by_dtype["float32"], by_dtype=by_dtype,
                          launches=counts["tridiag"], per_cycle=per_cycle,
                          shards=n_shards, in_step_ms=in_step,
                          step=dict(device_ms=prof["device_ms_per_step"],
                                    kernels=prof["kernels_per_step"],
                                    busy=prof["busy_share"]))
            phase(f"15 (d) mg annulus {shards} phi shards, one step with "
                  f"the CG capped at 0 (one V-cycle) profiled: "
                  f"{prof['device_ms_per_step']:.3f} device ms in "
                  f"{prof['kernels_per_step']:.0f} kernels, busy "
                  f"{prof['busy_share']:.3f}; K4 {in_step:.4f} ms a launch "
                  f"in the step" + since())
        del m, one

    # ---- (e) f64: the card against the CPU; (f) checkpoints ------------
    for key, make, shards in (
            ("annulus", lambda: annulus_params(
                "float64", refinement=GEO_F64_REF["annulus"]),
             GEO_PHI_SHARDS[-1]),
            ("box", lambda: cube_params(GEO_F64_REF["box"], "float64",
                                        feec=False), GEO_BOX_MESH)):
        cpu = BoussinesqModel(make(), device="cpu")
        cpu.prepare_sharded(geo_mesh("cpu", cpu.geo, shards))
        card = on_mesh(BoussinesqModel(make(), device=dev), shards)
        dt = cpu.params.time_step
        s_cpu = cpu.run(max_steps=1)[0]
        s_card = shard_state(state_from_numpy(
            card, *state_to_numpy(unshard_state(s_cpu))), card.geo,
            card._mesh.mesh)
        c1, dc = cpu.step(s_cpu, dt)
        g1, dg = card.step(s_card, dt)
        gc, gg = unshard_state(c1), unshard_state(g1)
        worst = 0.0
        for x, y in zip((gg.u, gg.p, gg.T) + tuple(gg.u_faces),
                        (gc.u, gc.p, gc.T) + tuple(gc.u_faces)):
            worst = max(worst, float((x.cpu() - y).abs().max()
                                     / y.abs().max().clamp_min(1e-300)))
        its_g = (dg.helmholtz_iters.tolist(), dg.poisson_iters,
                 dg.temperature_iters, dg.solver_ok)
        its_c = (dc.helmholtz_iters.tolist(), dc.poisson_iters,
                 dc.temperature_iters, dc.solver_ok)
        if its_g != its_c or not worst <= 1e-12:
            fail(f"15 (e) {key} mesh f64: the card (iterations {its_g}) vs "
                 f"the CPU ({its_c}): max rel diff {worst:.3e} (tol 1e-12)")
        phase(f"15 (e) {key} {card.geo.cell_shape} on "
              f"{label_of(card)}, f64: one step on the card vs the CPU's "
              f"mesh from the same state: iterations and verdict {its_g} "
              f"on both, max rel diff of each field's scale {worst:.3e} "
              f"(tol 1e-12)" + since())
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{key}_ck")
            ck.save_checkpoint_sharded(path, g1, {"case": key})
            back, meta = ck.load_checkpoint_sharded(
                path, geo=card.geo, mesh=card._mesh.mesh)
            fields = lambda s: [s.u, s.p, s.T, *s.u_faces]  # noqa: E731
            same = all(torch.equal(b[ab], t) for a_, b in zip(
                fields(g1), fields(back)) for ab, t in a_.items())
            if not same or back.time != g1.time or \
                    back.step_number != g1.step_number:
                fail(f"15 (f) {key}: the sharded checkpoint's restore is "
                     f"not bitwise")
            phase(f"15 (f) {key}: sharded checkpoint of {meta['n_shards']} "
                  f"shards restored onto the card's mesh bitwise (time "
                  f"{back.time}, step {back.step_number})")
        del cpu, card
    phase(f"15 total {time.perf_counter() - t0:.1f} s")
    return launches, k4_row


# ---------------------------------------------------------------- phase 16
# direct Helmholtz and the spectral CG on the mesh, every shard on the one
# card, f32 unless named: (a) the flagship with `helmholtz solver =
# direct` on DIRECT_MESH, (b) the annulus prm at 256 x 3072 direct on
# DIRECT_PHI_SHARDS phi shards, (c) the 128^3 box direct on DIRECT_MESH,
# (d) the stretched shell at the bench shape on DIRECT_MESH; (e) the comm
# ledger of one step of (a), (b), (d) and of the default DIRECT_MESH
# step; (f) f64 card vs CPU of each new sharded solver
DIRECT_MESH = (2, 4)
DIRECT_PHI_SHARDS = 8
DIRECT_STEPS = 5
DIRECT_BOX_STEPS = 2
DIRECT_STRETCHED_STEPS = 2


def ledger_text(summary, field_bytes):
    """A comm ledger's ops as "op count/bytes (per-shard fields)"."""
    return "; ".join(
        f"{op} {v['count']} / {v['bytes']} B ({v['bytes'] / field_bytes:.3f}"
        f" fields)" for op, v in summary.items() if v["count"]) or "none"


def direct_mesh_phases(dev):
    """Phase 16: direct Helmholtz and the spectral CG on the mesh. (a) The
    flagship (bench_params, 32 x 128 x 256, the seeded flow) with
    `helmholtz solver = direct` on DIRECT_MESH, DIRECT_STEPS steps through
    run against one device's run: escalations equal, u and T within 1e-4
    of max|u|, max|div u| <= 1e-4, K4 a step as on one device (2), K2o A*B
    a step, K1o and every single-device shell kernel 0; one step
    profiled (device ms, kernels, host launches, host syncs). (b) The
    annulus prm at 256 x 3072 direct on DIRECT_PHI_SHARDS phi shards, the
    same checks (no K2o on the annulus). (c) The standard 128^3 box
    direct on DIRECT_MESH, DIRECT_BOX_STEPS steps: K4 0 (matrix
    products). (d) The bench model on the stretched shell at 32 x 128 x
    256 on DIRECT_MESH, DIRECT_STRETCHED_STEPS steps from the seeded
    flow: each step's Poisson CG count equal to one device's or one apart
    (the knife edge of the sums' order, ROADMAP.md Queue 3: the
    difference printed), K4 the iterations + 1 a step; one step
    profiled. (e) The comm ledger (parallel/comm_analysis.py) of one step
    of (a), (b), (d) and of the default step on DIRECT_MESH: no
    all-gather and no all-to-all, the direct steps' and the stretched
    shell's all-reduce bytes printed. (f) f64 card against the CPU for
    each new sharded solver at a small size (the shell's and the box's on
    2 x 2, the annulus's on 8 phi shards, the spectral CG on 2 x 2 with an
    order-free right-hand side): within 1e-12 of the scale, equal CG
    counts, K4 once a solve (the CG's iterations + 1), nothing copied.
    Returns ({path: launches}, {name: numbers})."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_SHAPE, bench_params, seed_developed_flow, stretched_shell)
    from dycoreplanet_tpu_torch.parallel import comm_analysis as comm
    from dycoreplanet_tpu_torch.parallel.mesh import (
        shard_field, shard_state, unshard_field, unshard_state)
    from dycoreplanet_tpu_torch.solvers import spectral
    from dycoreplanet_tpu_torch.solvers.helmholtz import (
        make_sharded_helmholtz_solver)

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    launches, numbers, ledgers = {}, {}, {}

    def label_of(model):
        return label_of_mesh(model._mesh.mesh)

    def profile(m, st, dt):
        """One mesh step's device ms, kernels, host launches, host syncs
        and host ms."""
        prof = step_profile(lambda: m.step(st, dt)[1].cfl, 1)
        _, syncs = count_syncs(lambda: m.step(st, dt)[1].cfl)
        _, _, wall = drive(m, lambda: m.step(st, dt)[1].cfl)
        return dict(device_ms=prof["device_ms_per_step"],
                    kernels=prof["kernels_per_step"],
                    host_launches=prof["host_launches_per_step"],
                    syncs=syncs, host_ms=wall * 1e3,
                    busy=prof["busy_share"],
                    k4_ms=prof["kernel_ms_per_step"].get("tridiag", 0.0),
                    counts=prof["counts"])

    def prof_text(p):
        return (f"{p['device_ms']:.3f} device ms in {p['kernels']:.0f} "
                f"kernels (K4 {p['k4_ms']:.4f} ms), {p['host_launches']:.0f} "
                f"host launches, {p['syncs']} host syncs, {p['host_ms']:.1f} "
                f"host ms, busy {p['busy']:.3f}")

    def run_pair(tag, make, mesh_of, n, state_of=None, want=None):
        """n steps through run of one device and of its mesh from the same
        state: escalations equal, within 1e-4, K4 launches equal to one
        device's, every other wrapper as ``want`` (else 0). Returns (mesh
        model, its last state, numbers)."""
        one = make()
        m = make()
        m.prepare_sharded(mesh_of(m.geo))
        s0 = state_of(one) if state_of else one.initial_state()
        st0 = shard_state(s0, m.geo, m._mesh.mesh)
        (s1, h1), c1, w1 = drive(one, lambda: one.run(max_steps=n, state=s0))
        (sm, hm), cm, wm = drive(m, lambda: m.run(max_steps=n, state=st0))
        label = f"{tag} {m.geo.cell_shape} {label_of(m)}"
        if m.escalations != one.escalations:
            fail(f"16 {label}: {m.escalations} escalation(s), one device "
                 f"{one.escalations}")
        du, u_sc, div = hold_mesh(label, unshard_state(sm), s1,
                                  [h["div_norm"] for h in hm], tag="16")
        expect = {**{k: 0 for k in cm}, **(want or {}),
                  "tridiag": c1["tridiag"]}
        if cm != expect:
            fail(f"16 {label}: launches {cm}, expected {expect} (one "
                 f"device {c1})")
        its = [(h["poisson_iters"], h["temperature_iters"]) for h in hm]
        its1 = [(h["poisson_iters"], h["temperature_iters"]) for h in h1]
        if its != its1:
            fail(f"16 {label}: Krylov {its}, one device {its1}")
        r = dict(escalations=m.escalations, du=du / u_sc, div=div,
                 launches=cm, launches_one=c1, host_ms=wm / n * 1e3,
                 host_ms_one=w1 / n * 1e3, its=its)
        phase(f"16 {label}: {n} steps through run, {m.escalations} "
              f"escalation(s) (one device {one.escalations}), max|u_mesh - "
              f"u_one| {du / u_sc:.3e} of max|u|, max|div u| {div:.3e}, "
              f"launches {cm} (one device {c1}), Krylov (poisson, "
              f"temperature) {its}; {r['host_ms']:.1f} host ms a step (one "
              f"device {r['host_ms_one']:.1f})" + since())
        return m, sm, r

    # ---- (a) the flagship, direct, on DIRECT_MESH ----------------------
    A, B = DIRECT_MESH
    shell_mesh = lambda geo: geo_mesh(dev, geo, DIRECT_MESH)  # noqa: E731
    make_a = lambda: BoussinesqModel(direct_params(bench_params(  # noqa
        BENCH_SHAPE)), device=dev)
    m, st, r = run_pair("(a) flagship direct", make_a, shell_mesh,
                        DIRECT_STEPS, seed_developed_flow,
                        {"forcing_operands": A * B * DIRECT_STEPS})
    if r["launches"]["tridiag"] != 2 * DIRECT_STEPS:
        fail(f"16 (a): K4 {r['launches']['tridiag']} in {DIRECT_STEPS} "
             f"steps, expected {2 * DIRECT_STEPS}")
    dt = m.params.time_step
    r["profile"] = profile(m, st, dt)
    phase(f"16 (a) one direct {A}x{B} step profiled: "
          f"{prof_text(r['profile'])}; the profiler's hand kernels "
          f"{r['profile']['counts']}" + since())
    ledgers["flagship direct"] = (comm.step_comm_summary(m, st, dt),
                                  m.geo, m._mesh.mesh)
    launches[f"direct_mesh_{A}x{B}"] = r["launches"]
    numbers["flagship_direct"] = r
    del m, st

    # ---- (b) the annulus prm direct on DIRECT_PHI_SHARDS ---------------
    make_b = lambda: BoussinesqModel(annulus_params(  # noqa: E731
        helmholtz_solver="direct"), device=dev)
    m, st, r = run_pair("(b) annulus direct", make_b,
                        lambda geo: geo_mesh(dev, geo, DIRECT_PHI_SHARDS),
                        DIRECT_STEPS)
    dt = m.params.time_step
    r["profile"] = profile(m, st, dt)
    phase(f"16 (b) one annulus direct step profiled: "
          f"{prof_text(r['profile'])}" + since())
    ledgers["annulus direct"] = (comm.step_comm_summary(m, st, dt), m.geo,
                                 m._mesh.mesh)
    launches[f"annulus_direct_mesh_{DIRECT_PHI_SHARDS}"] = r["launches"]
    numbers["annulus_direct"] = r
    del m, st

    # ---- (c) the 128^3 box direct on DIRECT_MESH -----------------------
    make_c = lambda: BoussinesqModel(cube_params(  # noqa: E731
        CUBE_STD_REF, feec=False, helmholtz_solver="direct"), device=dev)
    m, st, r = run_pair("(c) box direct", make_c, shell_mesh,
                        DIRECT_BOX_STEPS)
    if r["launches"]["tridiag"]:
        fail(f"16 (c): K4 {r['launches']['tridiag']}, expected 0")
    launches[f"box_direct_mesh_{A}x{B}"] = r["launches"]
    numbers["box_direct"] = r
    del m, st

    # ---- (d) the stretched shell on DIRECT_MESH ------------------------
    geo_s = stretched_shell(BENCH_SHAPE)
    one = BoussinesqModel(bench_params(BENCH_SHAPE), geometry=geo_s,
                          device=dev)
    m = BoussinesqModel(bench_params(BENCH_SHAPE), geometry=geo_s,
                        device=dev).prepare_sharded(shell_mesh(geo_s))
    if type(m._mesh.poisson).__name__ != "ShardedShellPoissonSpectral":
        fail(f"16 (d): the mesh's Poisson solve {type(m._mesh.poisson)}")
    s1 = seed_developed_flow(one)
    sm = shard_state(s1, m.geo, m._mesh.mesh)
    dt = one.params.time_step
    its, its1, k4m, k4o, walls = [], [], [], [], []
    for _ in range(DIRECT_STRETCHED_STEPS):
        (s1, d1), c1, _ = drive(one, lambda: one.step(s1, dt))
        (sm, dm), cm, wm = drive(m, lambda: m.step(sm, dt))
        its.append(dm.poisson_iters)
        its1.append(d1.poisson_iters)
        k4m.append(cm["tridiag"])
        k4o.append(c1["tridiag"])
        walls.append(wm * 1e3)
    diff = [a - b for a, b in zip(its, its1)]
    if any(abs(x) > 1 for x in diff) or k4m != [i + 1 for i in its]:
        fail(f"16 (d) stretched: CG iterations {its}, one device {its1}; "
             f"K4 {k4m} (one device {k4o})")
    du, u_sc, div = hold_mesh("(d) stretched", unshard_state(sm), s1,
                              [float(dm.div_norm)], tag="16")
    prof_d = profile(m, sm, dt)
    r = dict(its=its, its_one=its1, diff=diff, k4=k4m, k4_one=k4o,
             du=du / u_sc, div=div, host_ms=walls, profile=prof_d)
    apart = ("equal" if not any(diff) else
             f"apart by {diff}: the knife edge of the sums' order, "
             f"ROADMAP.md Queue 3")
    phase(f"16 (d) stretched shell {geo_s.cell_shape} {A}x{B} "
          f"(ShardedShellPoissonSpectral): {DIRECT_STRETCHED_STEPS} steps, "
          f"Poisson CG iterations {its} (one device {its1}: {apart}), "
          f"K4 {k4m} (one device {k4o}), max|u_mesh - u_one| "
          f"{du / u_sc:.3e} of max|u|, max|div u| {div:.3e}, host ms "
          f"{[round(w, 1) for w in walls]}; one step profiled: "
          f"{prof_text(prof_d)}" + since())
    ledgers["stretched shell"] = (comm.step_comm_summary(m, sm, dt),
                                  m.geo, m._mesh.mesh)
    launches[f"stretched_shell_mesh_{A}x{B}"] = {"tridiag": sum(k4m)}
    numbers["stretched"] = r
    del m, one, sm, s1

    # ---- (e) the comm ledger -------------------------------------------
    md = mesh_model(dev, DIRECT_MESH)
    sd = shard_state(seed_developed_flow(md), md.geo, md._mesh.mesh)
    ledgers["default"] = (comm.step_comm_summary(md, sd, md.params.time_step),
                          md.geo, md._mesh.mesh)
    del md, sd
    numbers["ledgers"] = {}
    for name, (summary, geo, mesh) in ledgers.items():
        cells = int(np.prod(geo.cell_shape)) // int(np.prod(mesh.grid))
        field = 4 * cells
        if summary["all-gather"]["count"] or summary["all-to-all"]["count"]:
            fail(f"16 (e) {name}: {summary}")
        numbers["ledgers"][name] = dict(summary, per_shard_field_bytes=field)
        phase(f"16 (e) the comm ledger of one {name} step on "
              f"{label_of_mesh(mesh)}: {ledger_text(summary, field)}")

    # ---- (f) f64: each new sharded solver on the card vs the CPU --------
    worst = {}
    for kind, make_p, shards in (
            ("shell", lambda: direct_params(bench_params((8, 16, 32),
                                                         "float64")), (2, 2)),
            ("annulus", lambda: annulus_params(
                "float64", refinement=GEO_F64_REF["annulus"],
                helmholtz_solver="direct"), DIRECT_PHI_SHARDS),
            ("box", lambda: cube_params(GEO_F64_REF["box"], "float64",
                                        feec=False,
                                        helmholtz_solver="direct"), (2, 2))):
        cpu = BoussinesqModel(make_p(), device="cpu")
        card = BoussinesqModel(make_p(), device=dev)
        for attr, n_c in (("helmholtz_direct", cpu.geo.dim),
                          ("temperature_direct", 1)):
            b = torch.as_tensor(np.random.default_rng(4).standard_normal(
                (n_c,) + cpu.geo.cell_shape))
            mc = geo_mesh("cpu", cpu.geo, shards)
            want = unshard_field(make_sharded_helmholtz_solver(
                getattr(cpu, attr), mc).solve(shard_field(b, mc), 0.3))
            mg = geo_mesh(dev, card.geo, shards)
            tk = card._tridiag
            tk.launches = tk.copies = 0
            got = unshard_field(make_sharded_helmholtz_solver(
                getattr(card, attr), mg).solve(shard_field(b.to(dev), mg),
                                               0.3))
            err = float((got.cpu() - want).abs().max() / want.abs().max())
            k4_want = 0 if kind == "box" else 1
            if not err <= 1e-12 or tk.launches != k4_want or tk.copies:
                fail(f"16 (f) {kind} {attr} f64: card vs CPU {err:.3e} "
                     f"(tol 1e-12), K4 {tk.launches} (expected {k4_want}), "
                     f"copies {tk.copies}")
            worst[f"{kind} {attr}"] = err
    geo_f = stretched_shell((8, 16, 32))
    gen = torch.Generator().manual_seed(19)
    b = torch.randn(geo_f.cell_shape, generator=gen, dtype=torch.float64)
    b = b - b.mean()
    out = {}
    for d in ("cpu", dev):
        base = spectral.ShellPoissonSpectral(geo_f, dtype=np.float64,
                                             rtol=1e-11, maxiter=300,
                                             device=d)
        mesh = geo_mesh(d, geo_f, (2, 2))
        x, its_f = spectral.make_sharded_poisson_solver(base, mesh).solve(
            shard_field(b.to(d), mesh))
        out[str(d)] = (unshard_field(x).cpu(), its_f, base.tridiag)
    (xc, ic, _), (xg, ig, tk) = out["cpu"], out[str(dev)]
    err = float((xg - xc).abs().max() / xc.abs().max())
    if ig != ic or not err <= 1e-12 or tk.launches != ig + 1 or tk.copies:
        fail(f"16 (f) spectral CG f64: card {ig} iterations, CPU {ic}; "
             f"{err:.3e} (tol 1e-12); K4 {tk.launches} (expected "
             f"{ig + 1}), copies {tk.copies}")
    worst["stretched spectral CG"] = err
    numbers["f64"] = dict(worst, spectral_iterations=ig)
    phase(f"16 (f) f64 card vs CPU, each sharded solver (max rel diff of "
          f"the scale, tol 1e-12): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; the spectral CG {ig} iterations on both, K4 {ig + 1}, 0 "
            f"copies" + since())
    phase(f"16 total {time.perf_counter() - t0:.1f} s")
    return launches, numbers


def label_of_mesh(mesh):
    """A mesh as "A x B" or "B <axis> shards"."""
    if len(mesh.axis_names) == 1:
        return f"{mesh.grid[1]} {mesh.axis_names[0]} shards"
    return f"{mesh.grid[0]}x{mesh.grid[1]}"


# phase 17: the mesh across processes, its ranks run as
# scripts/torch_multihost_smoke.py (in the CLI pool, CLI_AHEAD, where the
# whole script runs)
PM_SCRIPT = os.path.join(HERE, "scripts", "torch_multihost_smoke.py")
PM_RANK_TIMEOUT = 300
# the host threads of each process of (b): five processes each build the
# annulus's lon DFT tables by a 3072 x 3072 SVD, whose BLAS threads would
# otherwise crowd the host's cores (~49 s a build beside (c) on the 8
# cores of an H100 machine, ~17 s with 2 threads a process); its
# single-controller reference runs with the same threads, which the
# tables follow at round-off
PM_B_THREADS = {k: "2" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                 "MKL_NUM_THREADS")}


def process_mesh_jobs(base, parts="bc"):
    """Phase 17's ranks as cli_runs jobs, each group writing under
    ``base``: (a) 2 gloo ranks sharing the card, the flagship (32 x 128 x
    256 f32, the seeded flow) on 2 x 2, 5 gated steps through run, one
    more profiled; (b) 4 gloo ranks, the annulus prm at 256 x 3072 with
    `helmholtz solver = direct` on 4 phi shards, 3 steps, and beside them
    one process running it on the single-controller mesh ("bref",
    ``--single``), all with PM_B_THREADS; (c) a one-rank NCCL world, the
    flagship on 2 x 2, its 5 steps; the groups of ``parts``. A job's
    label names its group second, and its argv holds the group's
    directory after "--out"."""
    jobs = []
    for part, world, backend, argv, env in (
            ("a", 2, "gloo", ["--check", "flagship", "--profile"], {}),
            ("b", 4, "gloo", ["--check", "annulus_direct", "--profile"],
             PM_B_THREADS),
            ("c", 1, "nccl", ["--check", "flagship"], {})):
        if part not in parts:
            continue
        out = os.path.join(base, f"ranks-17{part}")
        os.makedirs(out, exist_ok=True)
        for r in range(world):
            jobs.append((f"17 {part} rank {r}", None, [
                PM_SCRIPT, "--device", "cuda:0", "--backend", backend,
                "--init-method", f"file://{out}/rendezvous", "--timeout",
                str(PM_RANK_TIMEOUT), "--out", out] + argv,
                dict(env, RANK=str(r), WORLD_SIZE=str(world),
                     LOCAL_RANK="0")))
        if part == "b":
            ref = os.path.join(base, "ranks-17bref")
            jobs.append(("17 bref single", None, [
                PM_SCRIPT, "--single", "--device", "cuda:0", "--out",
                ref] + argv[:2], env))
    return jobs


def process_mesh_phases(dev):
    """Phase 17: the mesh across processes (parallel/dist.py; the ranks
    of process_mesh_jobs, all started after the kernels are built: (b)
    and (c) taken from CLI_AHEAD where they ran in the CLI pool, else run
    here, and (a) run here alone, so that its times are its own). (a) On
    each of the
    2 gloo ranks: 0 escalations, K2o and K1o each 2 x 5 times, host ms a
    step from the end of the first step, one more step's device ms,
    kernels and host syncs (profiler, sync debug mode), the messages and
    bytes it sent and received a step and its comm ledger of one step;
    the gathered state bitwise the single-controller 2 x 2 run's from the
    same state (run here, run_path of the script). (b) On each of the 4
    ranks: K4 twice a step (3 steps: 6), escalations as one process's,
    the state bitwise the single-controller 4-shard run's ("bref"). (c) The
    one-rank NCCL world's state after 5 steps bitwise the same
    single-controller run's, its sums all-gathered on the NCCL group
    (counted). Returns ({path: launches}, {name: numbers})."""
    import importlib.util

    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.parallel.mesh import build_mesh

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    spec = importlib.util.spec_from_file_location("torch_multihost_smoke",
                                                  PM_SCRIPT)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if "jax" in sys.modules or "dycoreplanet_tpu" in sys.modules:
        fail("17: the multihost smoke script imported JAX")
    base = CLI_AHEAD_DIR[0] if CLI_AHEAD_DIR else tempfile.mkdtemp()
    alone = process_mesh_jobs(base, "a")
    runs = cli_runs(alone, PM_RANK_TIMEOUT + 60)
    phase(f"17 (a) 2 gloo ranks sharing the card ran alone{since()}")
    pooled = process_mesh_jobs(base, "bc")
    ahead = [CLI_AHEAD.pop(label, None) for label, *_ in pooled]
    if any(r is None for r in ahead):
        ahead = cli_runs(pooled, PM_RANK_TIMEOUT + 60)
        phase(f"17 (b), (c) ran here{since()}")
    jobs, runs = alone + pooled, runs + ahead
    groups = {}
    for (label, _, argv, _), (rc, out, err) in zip(jobs, runs):
        if rc != 0:
            fail(f"17 ({label}) rc {rc}:\n{out[-2000:]}\n{err[-3000:]}")
        groups.setdefault(label.split()[1], argv[argv.index("--out") + 1])
    got, recs = {}, {}
    for part, out in groups.items():
        with np.load(os.path.join(out, "results.npz")) as f:
            got[part] = {k: f[k] for k in f.files}
        recs[part] = []
        r = 0
        while os.path.exists(os.path.join(out, f"rank{r}.json")):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                recs[part].append(json.load(f))
            r += 1
        if any(rec["imported_jax"] for rec in recs[part]):
            fail(f"17 ({part}): a rank imported JAX")
    ref_a, rec_ref = smoke.run_path(
        "flagship", dev, lambda geo: build_mesh(geo, [dev] * 4),
        profile=True)
    torch.cuda.synchronize()
    phase(f"17 the single-controller flagship 2x2 run on the card "
          f"({rec_ref['host_ms_per_step_after_first']:.1f} host ms a "
          f"step, {rec_ref['device_ms_one_step']:.2f} device ms, "
          f"{rec_ref['device_kernels_one_step']} kernels, "
          f"{rec_ref['host_syncs_one_step']} host syncs a step){since()}")
    ref_b = got["bref"]
    rec_refb = recs["bref"][0]["paths"]["annulus_direct"]

    def same(what, mine, ref, prefix):
        names = [k.split("/", 1)[1] for k in ref
                 if k.startswith(prefix + "/") and not k.endswith("rows")]
        for n in names:
            a, b = mine[f"{prefix}/{n}"], ref[f"{prefix}/{n}"]
            if not np.array_equal(a, b):
                fail(f"17 {what}: {n} differs from the single-controller "
                     f"mesh by {float(np.max(np.abs(a - b))):.3e}")
        return names

    launches, numbers = {}, {}
    # (a) 2 gloo ranks on the card, the flagship on 2 x 2
    names = same("(a) 2 gloo ranks", got["a"], ref_a, "flagship")
    n_steps = smoke.PATHS["flagship"][2]
    per_rank = []
    for rec in recs["a"]:
        p = rec["paths"]["flagship"]
        esc, lc = p["escalations_by_step"], p["launches"]
        if esc[-1] != 0:
            fail(f"17 (a) rank {rec['rank']}: {esc[-1]} escalation(s)")
        for w in ("forcing_operands", "richardson_operands"):
            if lc[w] != 2 * n_steps:
                fail(f"17 (a) rank {rec['rank']}: {w} launched {lc[w]} "
                     f"times, not 2 x {n_steps}")
        if p["ledger"] != rec_ref["ledger"]:
            fail(f"17 (a) rank {rec['rank']}: comm ledger {p['ledger']} "
                 f"against one process's {rec_ref['ledger']}")
        tr = p["transport"]
        row = dict(rank=rec["rank"], shards=p["shards"],
                   host_ms=p["host_ms_per_step_after_first"],
                   device_ms=p["device_ms_one_step"],
                   kernels=p["device_kernels_one_step"],
                   host_syncs=p["host_syncs_one_step"],
                   sent_per_step=tr["sent"] / n_steps,
                   received_per_step=tr["received"] / n_steps,
                   sent_bytes_per_step=tr["sent_bytes"] / n_steps,
                   received_bytes_per_step=tr["received_bytes"] / n_steps,
                   all_gathers_per_step=tr["all_gather"] / n_steps,
                   all_gather_bytes_per_step=(tr["all_gather_bytes"]
                                              / n_steps),
                   all_gather_received_bytes_per_step=(
                       tr["all_gather_received_bytes"] / n_steps),
                   launches={k: v for k, v in lc.items() if v})
        per_rank.append(row)
        launches[f"process_mesh_2x2_rank{rec['rank']}"] = lc
        led = p["ledger"]
        phase(f"17 (a) rank {rec['rank']}/2 (gloo, cuda:0, shards "
              f"{p['shards']}): 0 escalations, K2o {lc['forcing_operands']}"
              f" K1o {lc['richardson_operands']} in {n_steps} steps, "
              f"{row['host_ms']:.1f} host ms a step, "
              f"{row['device_ms']:.2f} device ms, {row['kernels']} kernels,"
              f" {row['host_syncs']} host syncs a step; a step "
              f"{row['sent_per_step']:.0f} messages sent and "
              f"{row['received_per_step']:.0f} received "
              f"({row['sent_bytes_per_step'] / 2 ** 20:.2f} MiB sent, "
              f"{row['received_bytes_per_step'] / 2 ** 20:.2f} MiB "
              f"received), {row['all_gathers_per_step']:.0f} all-gathers "
              f"({row['all_gather_bytes_per_step'] / 2 ** 20:.2f} MiB put "
              f"in, {row['all_gather_received_bytes_per_step'] / 2 ** 20:.2f}"
              f" MiB received); ledger of a step: "
              f"{led['collective-permute']['count']} "
              f"collective-permute, {led['all-reduce']['count']} "
              f"all-reduce, {led['all-gather']['count']} all-gather (as one "
              f"process)")
    phase(f"17 (a) the 2 ranks' gathered {names} bitwise the "
          f"single-controller 2x2 run's after {n_steps} steps{since()}")
    numbers["ranks_2x2"] = per_rank
    numbers["one_process_2x2"] = {
        k: rec_ref[k] for k in ("host_ms_per_step_after_first",
                                "device_ms_one_step",
                                "device_kernels_one_step",
                                "host_syncs_one_step", "ledger")}
    # (b) 4 gloo ranks, the annulus direct on 4 phi shards
    same("(b) 4 gloo ranks", got["b"], ref_b, "annulus_direct")
    nb = smoke.PATHS["annulus_direct"][2]
    for rec in recs["b"]:
        p = rec["paths"]["annulus_direct"]
        if p["launches"]["tridiag"] != 2 * nb:
            fail(f"17 (b) rank {rec['rank']}: K4 {p['launches']['tridiag']}"
                 f" launches, not 2 x {nb}")
        if p["escalations_by_step"] != rec_refb["escalations_by_step"]:
            fail(f"17 (b) rank {rec['rank']}: escalations "
                 f"{p['escalations_by_step']}, one process "
                 f"{rec_refb['escalations_by_step']}")
        launches[f"process_mesh_phi4_rank{rec['rank']}"] = p["launches"]
    hb = [rec["paths"]["annulus_direct"] for rec in recs["b"]]
    phase(f"17 (b) 4 gloo ranks, the annulus 256x3072 direct on 4 phi "
          f"shards, {nb} steps: K4 {[p['launches']['tridiag'] for p in hb]}"
          f" a rank, escalations {hb[0]['escalations_by_step'][-1]} (one "
          f"process {rec_refb['escalations_by_step'][-1]}), host ms a step "
          f"{[round(p['host_ms_per_step_after_first'], 1) for p in hb]}, "
          f"device ms {[round(p['device_ms_one_step'], 2) for p in hb]}; "
          f"the state bitwise the single-controller mesh's{since()}")
    numbers["ranks_phi4"] = [dict(
        rank=r, host_ms=p["host_ms_per_step_after_first"],
        device_ms=p["device_ms_one_step"], launches=p["launches"])
        for r, p in enumerate(hb)]
    # (c) a one-rank NCCL world
    (rec_c,) = recs["c"]
    pc = rec_c["paths"]["flagship"]
    if rec_c["backend"] != "nccl" or pc["transport"]["all_gather"] < 1:
        fail(f"17 (c): backend {rec_c['backend']}, "
             f"{pc['transport']['all_gather']} all-gathers")
    same("(c) one NCCL rank", got["c"], ref_a, "flagship")
    launches["process_mesh_nccl1"] = pc["launches"]
    phase(f"17 (c) a one-rank NCCL world, the flagship on 2x2 (4 shards "
          f"on the rank), {n_steps} steps: bitwise the single-controller "
          f"run's; {pc['transport']['all_gather']} all-gathers on the NCCL "
          f"group ({pc['transport']['all_gather'] / n_steps:.0f} a step). "
          f"NCCL moves between ranks were not run: this machine has one "
          f"card, and NCCL refuses two ranks of one communicator on one "
          f"GPU{since()}")
    numbers["nccl1"] = {"all_gathers": pc["transport"]["all_gather"],
                        "steps": n_steps}
    # where a rank's seconds go: its main (after the imports), the model's
    # build and the whole path
    secs = {part: [[round(rec["main_s"], 1)] + [
        round(p[k], 1) for p in rec["paths"].values()
        for k in ("build_s", "path_s")] for rec in rs]
        for part, rs in recs.items()}
    phase(f"17 each rank's seconds [main, build, path]: {secs}")
    numbers["rank_seconds"] = secs
    return launches, numbers


# ---------------------------------------------------------------- phase 18
SOAK_SCRIPT = os.path.join(HERE, "scripts", "torch_soak_production.py")
COMM_SCRIPT = os.path.join(HERE, "scripts", "torch_comm_bytes.py")
# (b): the 3D soak at the JAX script's own length
SOAK_3D_STEPS, SOAK_3D_CHUNK = 2000, 100
# (c): the 2D production soak cut from 2000 steps to two chunks of the
# JAX script's 100, the first at its fixed dt, the second adaptive: ~12 s
# with the resume's chunk on an H100 (PERF.md §6)
SOAK_2D_STEPS, SOAK_2D_CHUNK = 200, 100
# (b), (c): the steps of the one adaptive chunk profiled after each soak
SOAK_PROFILE_STEPS = 10
# (a), of each field's scale, from its readings on an H100 (PERF.md §6,
# PR 23): entry()'s card step (K1, K2, K5, the Poisson products on the
# card) against the CPU's (their plain versions), 5.04e-5 in p; its
# diagnosis: K2's rhs_u against its plain version's, 5.23e-6 (K2 forms
# the buoyancy as the Pallas kernel does, pallas_stencil.py:601-603,
# (1 - beta (T - T_ref)) - rho_background, which cancels where the
# buoyancy drives the flow; the plain version folds the constants as
# XLA does, and the divergence of u* carries the difference into p),
# the step with K1 and K5 launched (K2 plain) against the card's plain
# step, 3.2e-7, and the card's plain step against the CPU's, 6.1e-7
ENTRY_TOL = 1e-4
ENTRY_K2_TOL = 1e-5
ENTRY_K1K5_TOL = 2e-6
ENTRY_DEVICE_TOL = 5e-6


def comm_table_jobs():
    """Phase 18 (d)'s runs of scripts/torch_comm_bytes.py as cli_runs
    jobs: the shards on the card, and on the CPU (its torch and BLAS
    threads cut, PM_B_THREADS, beside the pool's other processes)."""
    return [("18 comm tables card", None, [COMM_SCRIPT]),
            ("18 comm tables cpu", None, [COMM_SCRIPT, "--device", "cpu"],
             PM_B_THREADS)]


def table_rows(text):
    """The markdown rows (header and rule included) of the script's
    output, in order."""
    return [ln for ln in text.splitlines() if ln.startswith("|")]


ENTRY_FIELDS = ("u", "p", "T", "uf0", "uf1", "uf2")


def state_fields(state):
    """A State's fields in ENTRY_FIELDS's order."""
    return (state.u, state.p, state.T) + tuple(state.u_faces)


def rel_gap(x, y) -> float:
    """max|x - y| over max|y|, on y's device."""
    return float((x.to(y.device) - y).abs().max()
                 / y.abs().max().clamp_min(1e-30))


def field_gaps(got, want):
    """{field: rel_gap} of two States."""
    return {name: rel_gap(x, y) for name, x, y in
            zip(ENTRY_FIELDS, state_fields(got), state_fields(want))}


class PlainCalls:
    """Stands in for a kernel wrapper: the calls named in ``calls`` take
    the wrapper's plain version (``name="plain method"``, ``__call__``
    for the wrapper's own call), whatever device their tensors lie on;
    every other attribute is the wrapper's."""

    def __init__(self, wrapper, **calls):
        self._wrapper = wrapper
        self._calls = calls

    def __getattr__(self, name):
        return getattr(self._wrapper, self._calls.get(name, name))

    def __call__(self, *args):
        return getattr(self._wrapper, self._calls["__call__"])(*args)


def plain_on_card(model, which):
    """Swap the model's wrappers named in ``which`` (of "K1", "K2",
    "K5") for their plain versions, which then run on the card."""
    if "K1" in which:
        model._richardson = PlainCalls(model._richardson, __call__="plain")
    if "K2" in which:
        model._forcing = PlainCalls(model._forcing, __call__="plain")
    if "K5" in which:
        model._proj = PlainCalls(model._proj, faces_div="plain",
                                 correct="correct_plain")


def poisson_tap(model):
    """Record the model's next Poisson solve: ({"rhs", "phi", "iters"},
    filled by the solve; the untapped solve)."""
    seen = {}
    solve = model._solve_pressure_poisson

    def tapped(rhs):
        out = solve(rhs)
        seen.update(rhs=rhs, phi=out[0], iters=int(out[1]))
        return out

    model._solve_pressure_poisson = tapped
    return seen, solve


def entry_diagnosis(entry, fn_c, s_c, dt):
    """Phase 18 (a)'s diagnosis of the card's gap to the CPU: entry()'s
    step on the card with its kernels, with K1, K2, and all three of K1,
    K2 and K5 in their plain versions, and on the CPU, each with its
    Poisson solve tapped; each against the CPU's (fields, the solve's
    right-hand side and solution, its iterations), the kernel step
    against the card's plain step, K2's rhs_u against its plain
    version's on entry()'s state, and the card's solve of the CPU's
    right-hand side against the CPU's solution. Fails where K2's rhs_u
    is more than ENTRY_K2_TOL of its scale from the plain version's,
    the step that launches K1 and K5 (K2 plain) more than
    ENTRY_K1K5_TOL from the card's plain step, or the card's plain step
    more than ENTRY_DEVICE_TOL from the CPU's. Prints the report;
    returns the CPU's State."""
    taps, outs = {}, {}
    for name, which in (("cpu", None), ("kernels", ()), ("K1 plain", ("K1",)),
                        ("K2 plain", ("K2",)),
                        ("all plain", ("K1", "K2", "K5"))):
        if which is None:
            f, s = fn_c, s_c
        else:
            f, (s, _) = entry()
            plain_on_card(f.model, which)
        if name == "kernels":
            k2, s_k = f.model._forcing, s
        taps[name], solve = poisson_tap(f.model)
        outs[name] = f(s, dt)
    cpu, tap_c, plain = outs["cpu"], taps["cpu"], outs["all plain"]
    lines = []
    for name in ("kernels", "K1 plain", "K2 plain", "all plain"):
        tap = taps[name]
        lines.append(
            f"{name} on the card vs the CPU: " + ", ".join(
                f"{k} {v:.3e}" for k, v in field_gaps(outs[name],
                                                      cpu).items())
            + f"; Poisson rhs {rel_gap(tap['rhs'], tap_c['rhs']):.3e}, phi "
            f"{rel_gap(tap['phi'], tap_c['phi']):.3e}, iterations "
            f"{tap['iters']} (CPU {tap_c['iters']})")
    args = (s_k.u, s_k.u_faces, s_k.T, s_k.p, dt)
    k2_gap = rel_gap(k2(*args)[0], k2.plain(*args)[0])
    kernel_gap = field_gaps(outs["kernels"], plain)
    k1k5_gap = field_gaps(outs["K2 plain"], plain)
    device_gap = field_gaps(plain, cpu)
    rhs_gap = rel_gap(taps["kernels"]["rhs"], taps["all plain"]["rhs"])
    phi_card = solve(tap_c["rhs"].to(taps["all plain"]["rhs"].device))[0]
    lines += [
        f"K2's rhs_u vs its plain version's on the card, of its scale: "
        f"{k2_gap:.3e} (tol {ENTRY_K2_TOL}); the step's Poisson rhs, "
        f"kernels vs plain on the card: {rhs_gap:.3e} "
        f"({rhs_gap / max(k2_gap, 1e-30):.0f}x K2's)",
        "the kernels vs the plain step, both on the card: " + ", ".join(
            f"{k} {v:.3e}" for k, v in kernel_gap.items()),
        "K1 and K5 launched, K2 plain, vs the plain step, both on the "
        "card: " + ", ".join(f"{k} {v:.3e}" for k, v in k1k5_gap.items())
        + f" (tol {ENTRY_K1K5_TOL})",
        f"the plain step on the card vs the CPU: max "
        f"{max(device_gap.values()):.3e} (tol {ENTRY_DEVICE_TOL})",
        f"the card's Poisson solve of the CPU's rhs vs the CPU's phi: "
        f"{rel_gap(phi_card, tap_c['phi']):.3e}"]
    for line in lines:
        print(f"  18 (a) {line}", flush=True)
    if not k2_gap <= ENTRY_K2_TOL:
        fail(f"18 (a) entry(): K2's rhs_u vs its plain version's: {k2_gap} "
             f"of its scale (tol {ENTRY_K2_TOL})")
    if not max(k1k5_gap.values()) <= ENTRY_K1K5_TOL:
        fail(f"18 (a) entry(): K1 and K5 launched vs the plain step on the "
             f"card: {k1k5_gap} (tol {ENTRY_K1K5_TOL})")
    if not max(device_gap.values()) <= ENTRY_DEVICE_TOL:
        fail(f"18 (a) entry(): the plain step on the card vs the CPU's: "
             f"{device_gap} (tol {ENTRY_DEVICE_TOL})")
    return cpu


def soak_entry_phases(dev):
    """Phase 18 (module docstring). Returns {path: launches}."""
    import importlib.util

    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import (
        device_launches)
    from dycoreplanet_tpu_torch.entry import entry

    t0 = time.perf_counter()
    since = lambda: f" [{time.perf_counter() - t0:.1f} s]"   # noqa: E731
    launches = {}
    # (a) entry()'s step on the card and on the CPU
    fn, (s0, dt) = entry()
    model = fn.model
    want = {"forcing": 1, "richardson": 1, "faces_div": 0, "correct": 1,
            "tridiag": 0}
    out, l_a, wall = drive(model, lambda: fn(s0, dt))
    if l_a != want:
        fail(f"18 (a) entry(): wrapper launches {l_a}, expected {want}")
    names = dict.fromkeys(SHELL_NAMES + ("tridiag",))
    _, counts = device_launches(lambda: fn(s0, dt), names)
    want_dev = {**dict.fromkeys(names, 0), **want}
    if counts != want_dev:
        fail(f"18 (a) entry(): the profiler counted {counts}, expected "
             f"{want_dev}")
    fn_c, (s_c, dt_c) = entry(device="cpu")
    if dt_c != dt:
        fail(f"18 (a) entry(): dt {dt!r} on the card, {dt_c!r} on the CPU")
    for name, x in zip(ENTRY_FIELDS, state_fields(out)):
        if not bool(torch.isfinite(x).all()):
            fail(f"18 (a) entry(): the card's {name} is not finite")
    worst = field_gaps(out, entry_diagnosis(entry, fn_c, s_c, dt))
    by_field = ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
    if not max(worst.values()) <= ENTRY_TOL:
        fail(f"18 (a) entry(): the card's step vs the CPU's, of each "
             f"field's scale: {by_field} (tol {ENTRY_TOL})")
    launches["entry"] = l_a
    phase(f"18 (a) entry(): fn(state, dt) at {model.geo.cell_shape} f32, "
          f"wrapper launches {l_a}, the profiler's {counts}; vs "
          f"entry(device='cpu'), of each field's scale: {by_field} (tol "
          f"{ENTRY_TOL}); {wall * 1e3:.1f} host ms (first call){since()}")

    spec = importlib.util.spec_from_file_location("torch_soak_production",
                                                  SOAK_SCRIPT)
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    if "jax" in sys.modules or "dycoreplanet_tpu" in sys.modules:
        fail("18: the soak script imported JAX")
    for part, steps, chunk, scale3d in (
            ("b", SOAK_3D_STEPS, SOAK_3D_CHUNK, True),
            ("c", SOAK_2D_STEPS, SOAK_2D_CHUNK, False)):
        t_part = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = soak.soak(steps, chunk, scale3d=scale3d, device=dev)
        secs = time.perf_counter() - t_part
        s = res["summary"]
        if not (s.get("ok") and s.get("bitwise_resume")):
            fail(f"18 ({part}) soak {steps} steps: {json.dumps(s)}")
        lk = {k: w.launches for k, w in res["model"].kernels().items()}
        # the 3D soak's fast steps run K2, K1 and K5 (and K3 only where
        # a chunk is redone with CG); the annulus builds no shell kernel
        if scale3d and not (lk["forcing"] == lk["correct"]
                            >= lk["richardson"] > 0):
            fail(f"18 ({part}) soak: wrapper launches {lk}")
        retries = sum("retrying chunk" in str(w.message) for w in caught)
        launches["soak_3d" if scale3d else "soak_2d"] = lk
        phase(f"18 ({part}) {s['config']} soak, {steps} steps in chunks of "
              f"{chunk}: ok, bitwise resume; {s['steps_per_sec']} steps/s "
              f"(first run), CFL {s['cfl_range']}, T {s['T_range_final']}, "
              f"max|u| {s['max_u_final']:.4f}, dt {s['dt_final']:.4g}, "
              f"div {s['div_final']:.3e}; {res['escalations']} "
              f"escalation(s) ({retries} chunk(s) redone with CG in both "
              f"runs); chunks {res['replays']} graph replays; wrapper "
              f"launches of both runs {lk}; {secs:.1f} s{since()}")
        # where an adaptive chunk's time goes: one more, short, profiled
        soaked = res["model"]
        prof = step_profile(lambda: soaked.multi_step(
            res["resumed"], s["dt_final"], SOAK_PROFILE_STEPS,
            collect_diagnostics=False, adaptive=True), SOAK_PROFILE_STEPS)
        phase(f"18 ({part}) one more adaptive chunk of {SOAK_PROFILE_STEPS} "
              f"steps profiled: "
              f"{prof['device_ms_per_step'] / prof['busy_share']:.3f} host "
              f"ms and {prof['device_ms_per_step']:.4f} device ms a step, "
              f"{prof['kernels_per_step']:.1f} kernels and "
              f"{prof['host_launches_per_step']:.1f} host launches a step, "
              f"busy share {prof['busy_share']:.3f}{since()}")
        del res, soaked

    # (d) the scaling tables, card and CPU, from phase 7's pool
    runs = run_clis(comm_table_jobs(), timeout=600)
    card, cpu = (table_rows(t) for t in runs)
    if not card or len(card) != len(cpu) or card != cpu:
        diff = [(a, b) for a, b in zip(card, cpu) if a != b]
        fail(f"18 (d) the card's scaling tables differ from the CPU's "
             f"({len(card)} / {len(cpu)} rows): {diff[:3]}")
    body = [ln for ln in card if not ln.startswith(("| devices", "|---"))]
    if len(body) != 8:
        fail(f"18 (d) expected 8 table rows, got {body}")
    phase(f"18 (d) scripts/torch_comm_bytes.py: the weak and strong tables "
          f"on the card and on the CPU equal, {len(body)} rows "
          f"(card {CLI_SECONDS.get('18 comm tables card', 0.0):.1f} s, CPU "
          f"{CLI_SECONDS.get('18 comm tables cpu', 0.0):.1f} s in the "
          f"pool){since()}")
    for ln in card:
        print(f"  {ln}", flush=True)
    return launches


def main() -> None:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    try:
        import dycoreplanet_tpu_torch
        from dycoreplanet_tpu_torch.diagnostics.device_time import (
            time_ms, wrapper_of)
        from dycoreplanet_tpu_torch.models import BoussinesqModel
        from dycoreplanet_tpu_torch.models.graphs import MAX_GRAPHS
        from dycoreplanet_tpu_torch.models.presets import (
            BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
        from dycoreplanet_tpu_torch.ops import forcing as k2
        from dycoreplanet_tpu_torch.ops import kernel_lib
        from dycoreplanet_tpu_torch.ops import projection as k3
        from dycoreplanet_tpu_torch.ops import richardson as k1
        from dycoreplanet_tpu_torch.ops import stencil as st
        from dycoreplanet_tpu_torch.ops import tridiag as k4
    except ImportError as exc:
        fail(f"the port's package is not importable next to this script "
             f"({exc})")
    pkg_dir = os.path.dirname(os.path.realpath(dycoreplanet_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != os.path.realpath(HERE):
        fail(f"the port's package was imported from {pkg_dir}, not from the "
             f"checkout beside this script ({HERE})")
    if "jax" in sys.modules or "dycoreplanet_tpu" in sys.modules:
        fail("the port imported JAX or the JAX package")

    # ---- 1. the card ---------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    phase(f"device {kind} (count {count})")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    # ---- 2. build ------------------------------------------------------
    secs = kernel_lib.build_all()
    phase(f"built {len(kernel_lib.SOURCES)} kernel sources in {secs:.1f} s")
    ptxas = {src: kernel_lib.ptxas_summary(src) for src in kernel_lib.SOURCES}
    for src, rows in ptxas.items():
        for r in rows:
            print(f"  ptxas {src} {r['kernel']}: {r['registers']} registers, "
                  f"{r['stack_bytes']} bytes stack frame, "
                  f"{r['spill_stores']}/{r['spill_loads']} bytes spill "
                  f"stores/loads, {r['smem_bytes']} bytes static smem",
                  flush=True)
    # the instances of K1 and K2 by their template arguments
    # (diagnostics/device_time.py wrapper_of: K1u's TRACK and K2m's
    # ADVECT_T false, K1o's and K2o's OPS true), each without spills
    by_wrapper = {}
    for src in ("richardson.cu", "forcing.cu"):
        for r in ptxas[src]:
            by_wrapper.setdefault(wrapper_of(r["kernel"]), []).append(r)
    # (f32, f64 and bf16 storage; K1u's two tile instances each)
    for wname, label, n_inst in (
            ("richardson_free", "K1u (TRACK = false)", 6),
            ("forcing_momentum", "K2m (ADVECT_T = false)", 3),
            ("richardson_operands", "K1o (OPS = true)", 3),
            ("forcing_operands", "K2o (OPS = true)", 3),
            ("forcing_momentum_operands",
             "K2mo (ADVECT_T = false, OPS = true)", 3)):
        rows = by_wrapper.get(wname, [])
        if len(rows) != n_inst:
            fail(f"expected {n_inst} {label} instances in ptxas's output, "
                 f"found {[r['kernel'] for r in rows]}")
        for r in rows:
            if r["spill_stores"] or r["spill_loads"]:
                fail(f"{label} instance {r['kernel']} spills")
        phase(f"{label} instances: " + "; ".join(
            f"{r['kernel']} {r['registers']} registers, "
            f"{r['spill_stores']}/{r['spill_loads']} bytes spill"
            for r in rows))
    k1u_ptxas, k2m_ptxas = (by_wrapper["richardson_free"],
                            by_wrapper["forcing_momentum"])

    # ---- 3. kernel checks ---------------------------------------------
    dev = torch.device("cuda")
    model = BoussinesqModel(bench_params(BENCH_SHAPE), device=dev)
    n_cells = model.geo.n_cells
    s0 = seed_developed_flow(model)
    dt = model._scalar(BENCH_DT)
    fk, rk, pk = model._forcing, model._richardson, model._proj
    report = []

    # K2: forcing + fused temperature transport
    args2 = (s0.u, s0.u_faces, s0.T, s0.p, dt)
    got = fk(*args2)
    want = fk.plain(*args2)
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()) for w in want)
    err2 = compare("K2 forcing", got, want, 0.0, 1e-5 * scale)
    ms, pms = time_ms(lambda: fk(*args2)), time_ms(lambda: fk.plain(*args2))
    b_ms, b_by = bound(n_cells, k2.FIELDS_MOVED, k2.OPS_PER_CELL)
    phase(f"K2 forcing: max abs err {err2:.3e} (tol {1e-5 * scale:.3e} = "
          f"1e-5 x scale), kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"bound {b_ms * 1e3:.1f} us ({b_by})")
    occ2 = fk.occupancy(torch.float32)
    report.append(dict(name="K2 forcing", route="cuda",
                       source="dycoreplanet_tpu_torch/csrc/forcing.cu",
                       replaces="dycoreplanet_tpu/ops/pallas_stencil.py:373",
                       max_abs_err=err2, ms=ms, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None,
                       blocks_per_sm=occ2,
                       ptxas=by_wrapper["forcing"]))

    # K2m: the forcing without the fused transport, as a
    # `temperature advection = semi-lagrangian` model runs it, on the same
    # flow; it returns rhs_u alone
    slmodel = BoussinesqModel(sl_params(bench_params(BENCH_SHAPE)),
                              device=dev)
    fm2 = slmodel._forcing
    gm = fm2(*args2)
    wm = fm2.plain(*args2)
    torch.cuda.synchronize()
    if not torch.is_tensor(gm) or fm2.advect_T:
        fail("K2m: expected rhs_u alone")
    sc_m = float(wm.abs().max())
    err2m = compare("K2m forcing_momentum", (gm,), (wm,), 0.0, 1e-5 * sc_m)
    # the same momentum forcing as K2's
    d_k2 = float((gm - got[0]).abs().max())
    ms, pms = time_ms(lambda: fm2(*args2)), time_ms(lambda: fm2.plain(*args2))
    b_ms, b_by = bound(n_cells, k2.MOMENTUM_FIELDS_MOVED,
                       k2.MOMENTUM_OPS_PER_CELL)
    occ2m = fm2.occupancy(torch.float32)
    phase(f"K2m forcing_momentum: max abs err {err2m:.3e} (tol "
          f"{1e-5 * sc_m:.3e} = 1e-5 x scale), against K2's rhs_u max "
          f"|diff| {d_k2:.3e}, kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
          f"{b_ms * 1e3:.1f} us ({b_by}); shared memory a block "
          f"{k2.shared_bytes(4, advect_T=False)} bytes (K2 "
          f"{k2.shared_bytes(4)}), resident blocks an SM {occ2m} (K2 {occ2})")
    k2m_row = dict(name="K2m forcing_momentum", route="cuda",
                   source="dycoreplanet_tpu_torch/csrc/forcing.cu",
                   replaces="dycoreplanet_tpu/ops/pallas_stencil.py:373",
                   variant="advect_T=False, dycoreplanet_tpu/ops/"
                           "pallas_stencil.py:499-514, 696-730",
                   max_abs_err=err2m, ms=ms, plain_ms=pms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, blocks_per_sm=occ2m,
                   ptxas=k2m_ptxas)
    report.append(k2m_row)

    # the semi-Lagrangian transport (PyTorch, no hand kernel) on the card
    # against the same function in f64 on the CPU, at the step's dt_T
    # (displacements of a few hundredths of a cell) and at 0.5 (up to
    # the clamp at 2 cells)
    from dycoreplanet_tpu_torch.diagnostics.device_time import (
        device_events, profiled)
    from dycoreplanet_tpu_torch.ops.semi_lagrangian import SemiLagrangian
    sl = slmodel._semi_lagrangian
    wall = slmodel.T_specs[0]
    sl_cpu = SemiLagrangian(slmodel.geo, [dataclasses.replace(
        wall, lo_value=wall.lo_value.cpu().double())] + slmodel.T_specs[1:])
    u64, T64 = s0.u.cpu().double(), s0.T.cpu().double()
    sl_err = []
    for dt_sl in (slmodel._dt_T(dt), 0.5):
        g_sl = sl(s0.u, s0.T, dt_sl)
        w_sl = sl_cpu(u64, T64, dt_sl)
        rel = float((g_sl.cpu().double() - w_sl).abs().max()
                    / w_sl.abs().max())
        if not rel <= 1e-5:
            fail(f"semi-Lagrangian transport (dt {dt_sl}): card vs f64 CPU "
                 f"rel diff {rel:.3e} > 1e-5")
        sl_err.append(rel)
    sl_args = (s0.u, s0.T, slmodel._dt_T(dt))
    sl_ms = time_ms(lambda: sl(*sl_args))
    _, sl_prof = profiled(lambda: sl(*sl_args))
    sl_kernels = len(device_events(sl_prof))
    phase(f"semi-Lagrangian transport at {BENCH_SHAPE} f32: card vs f64 CPU "
          f"rel diff {sl_err[0]:.3e} (dt_T) / {sl_err[1]:.3e} (dt 0.5) (tol "
          f"1e-5); {sl_ms:.4f} ms of device time and {sl_kernels} device "
          f"kernels a call (one a step and one a substep)")

    # K1: Richardson solves + projection head, on the K2 outputs
    rhs_u, T_adv = got
    kT = model._scalar(model.dtype.type(dt)
                       * model.dtype.type(model.one_over_Pe))
    rhs_T = model._vol_t * T_adv + kT * model._T_lap_offset_t
    args1 = (rhs_u, rhs_T, s0.T, dt)
    g1 = rk(*args1)
    w1 = rk.plain(*args1)
    torch.cuda.synchronize()
    pre = short_norms(rk, args1)
    err1, dn = check_k1("K1", g1, w1, pre, torch.float32)
    norms_k = [float(x) for x in g1[3]]
    norms_p = [float(x) for x in w1[3]]
    eps = float(torch.finfo(torch.float32).eps)
    gate = 16 * eps
    # the check fails a kernel whose residual norms were 0, or were left
    # un-updated by the last sweep (the plain norms one sweep short)
    faults = {"rn = 0": [0.0, norms_p[1], 0.0, norms_p[3]],
              "r not updated": [pre[0], norms_p[1], pre[1], norms_p[3]]}
    seen = []
    for what, bad in faults.items():
        ratios = norm_ratios(bad, w1[3], pre, eps)
        if not min(ratios) > 1.0:
            fail(f"K1 norm check passes a kernel with {what} ({ratios})")
        seen.append(f"{what}: u {ratios[0]:.3g}, T {ratios[1]:.3g}")
    phase(f"K1 norms (rn_u, bn_u, rn_T, bn_T): kernel {norms_k}, "
          f"plain {norms_p}, plain one sweep short (rn_u, rn_T) {list(pre)}; "
          f"max |d rn| {dn:.3g} x tol (0.1 rn + 2 eps |r_pre|); faulty "
          f"norms would read {'; '.join(seen)} x tol; gate margins u "
          f"{gate * norms_k[1] / max(norms_k[0], 1e-300):.3g}x, "
          f"T {gate * norms_k[3] / max(norms_k[2], 1e-300):.3g}x; "
          f"{len(rk.plan(torch.float32))} launch(es) a call")
    ms, pms = time_ms(lambda: rk(*args1)), time_ms(lambda: rk.plain(*args1))
    b_ms, b_by = bound(n_cells, k1.FIELDS_MOVED,
                       k1.ops_per_cell(rk.iters_u, rk.iters_T))
    phase(f"K1 richardson: max abs err {err1:.3e} (iterates/faces rtol=atol"
          f"=2e-6, rhs_phi rtol 1e-4 atol 2e-5 x scale), kernel {ms:.4f} ms,"
          f" plain {pms:.4f} ms, bound {b_ms * 1e3:.1f} us ({b_by})")
    report.append(dict(name="K1 richardson", route="cuda",
                       source="dycoreplanet_tpu_torch/csrc/richardson.cu",
                       replaces="dycoreplanet_tpu/ops/pallas_richardson.py:348",
                       max_abs_err=err1, ms=ms, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None,
                       ptxas=by_wrapper["richardson"]))

    # K1u: K1's residual-free variant, as the `residual check interval =
    # 4` model runs it between checks, on the same inputs
    imodel = BoussinesqModel(interval_params(bench_params(BENCH_SHAPE)),
                             device=dev)
    rku = imodel._richardson_free
    g1u = rku(*args1)
    w1u = rku.plain(*args1)
    torch.cuda.synchronize()
    err1u = check_k1u("K1u", g1u, w1u, torch.float32)
    # the variant leaves u*, T, the faces and rhs_phi as K1 has them
    k1u_bitwise = same_bits(g1, g1u)
    d_k1 = max(float((x - y).abs().max()) for x, y in zip(
        (g1[0], g1[1]) + tuple(g1[2]), (g1u[0], g1u[1]) + tuple(g1u[2])))
    ms, pms = time_ms(lambda: rku(*args1)), time_ms(lambda: rku.plain(*args1))
    b_ms, b_by = bound(n_cells, k1.FIELDS_MOVED,
                       k1.ops_per_cell(rku.iters_u, rku.iters_T, track=False))
    plan_u = rku.plan(torch.float32)
    phase(f"K1u richardson (residual-free): max abs err {err1u:.3e} "
          f"(iterates/faces rtol=atol=2e-6, rhs_phi rtol 1e-4 atol 2e-5 x "
          f"scale), norms {[float(x) for x in g1u[3]]} (sentinel -1, b "
          f"norms rtol 1e-5), against K1's kernel max |diff| {d_k1:.3e} "
          f"(bitwise {k1u_bitwise}); halo {plan_u[0].halo} (K1 "
          f"{rk.plan(torch.float32)[0].halo}), kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b_ms * 1e3:.1f} us ({b_by})")
    k1u_row = dict(name="K1u richardson_free", route="cuda",
                   source="dycoreplanet_tpu_torch/csrc/richardson.cu",
                   replaces="dycoreplanet_tpu/ops/pallas_richardson.py:348",
                   variant="track_residual=False, dycoreplanet_tpu/ops/"
                           "pallas_richardson.py:133-142, 332-337, 523-528",
                   max_abs_err=err1u, ms=ms, plain_ms=pms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, ptxas=k1u_ptxas)
    report.append(k1u_row)

    # K3: faces_div on the K1 iterate
    u_star = g1[0]
    g3 = pk.faces_div(u_star, dt)
    w3 = pk.plain(u_star, dt)
    torch.cuda.synchronize()
    err3 = compare("K3 faces", g3[:3], w3[:3], 2e-6, 2e-6)
    sc = float(w3[3].abs().max()) + 1e-30
    err3 = max(err3, compare("K3 rhs_raw", (g3[3],), (w3[3],), 1e-4,
                             2e-5 * sc))
    err3 = max(err3, compare("K3 sum", (g3[4] / n_cells,), (w3[4] / n_cells,),
                             1e-4, 2e-5 * sc))
    ms = time_ms(lambda: pk.faces_div(u_star, dt))
    pms = time_ms(lambda: pk.plain(u_star, dt))
    b_ms, b_by = bound(n_cells, k3.FIELDS_MOVED, k3.OPS_PER_CELL)
    phase(f"K3 faces_div: max abs err {err3:.3e} (faces rtol=atol=2e-6, "
          f"rhs rtol 1e-4 atol 2e-5 x scale), kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b_ms * 1e3:.1f} us ({b_by})")
    report.append(dict(name="K3 faces_div", route="cuda",
                       source="dycoreplanet_tpu_torch/csrc/projection.cu",
                       replaces="dycoreplanet_tpu/ops/pallas_stencil.py:842",
                       max_abs_err=err3, ms=ms, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None))

    # K5: the correction, on the K3 faces and the Poisson solution
    rhs_phi = g3[3] - g3[4] / float(n_cells)
    phi, _ = model.poisson_spectral.solve(rhs_phi)
    args5 = (u_star, g3[:3], phi, s0.p, dt, st.volume_mean(model.geo, phi))
    g5 = pk.correct(*args5)
    w5 = pk.correct_plain(*args5)
    torch.cuda.synchronize()
    err5 = compare("K5 correct", g5, w5, 2e-6, 2e-6)
    ms = time_ms(lambda: pk.correct(*args5))
    pms = time_ms(lambda: pk.correct_plain(*args5))
    b_ms, b_by = bound(n_cells, k3.CORRECT_FIELDS_MOVED,
                       k3.CORRECT_OPS_PER_CELL)
    phase(f"K5 correct: max abs err {err5:.3e} (rtol=atol=2e-6), kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms * 1e3:.1f} us "
          f"({b_by})")
    report.append(dict(name="K5 correct", route="cuda",
                       source="dycoreplanet_tpu_torch/csrc/projection.cu",
                       replaces="dycoreplanet_tpu/ops/pallas_stencil.py:920",
                       max_abs_err=err5, ms=ms, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None))

    # K4: the radial tridiagonal systems of the direct Helmholtz solves
    # of a `helmholtz solver = direct` model, from its K2 right-hand side,
    # as the solver passes them (lower and upper one value a row, diag
    # broadcast over the real/imaginary axis): no operand copied, lower[0]
    # and upper[n-1] never read (NaN there), the caller's operands left
    # bitwise unchanged
    dmodel = BoussinesqModel(direct_params(bench_params(BENCH_SHAPE)),
                             device=dev)
    ds0 = seed_developed_flow(dmodel)
    rhs_ud, T_advd = dmodel._forcing(ds0.u, ds0.u_faces, ds0.T, ds0.p, dt)
    coef = dmodel._scalar(dmodel.dtype.type(dt)
                          * dmodel.dtype.type(dmodel.one_over_Re))
    b_u = dmodel._vol_t[None] * rhs_ud
    tk = dmodel._tridiag
    k4_rows = {}
    for what, solver, b, c in (
            ("momentum", dmodel.helmholtz_direct, b_u, coef),
            ("temperature", dmodel.temperature_direct,
             (dmodel._vol_t * T_advd)[None], kT)):
        sys4 = solver.systems(b, c)
        n4, m4 = sys4[3].shape[0], sys4[3][0].numel()
        w4 = tk.plain(*sys4)
        sc = float(w4.abs().max())
        err4 = check_k4(f"K4 tridiag ({what})", tk, sys4, w4, 1e-5 * sc)
        if tk.copies:
            fail(f"K4 tridiag ({what}): the wrapper copied {tk.copies} "
                 f"operand(s) of the direct solver")
        ms = time_ms(lambda: tk(*sys4))
        pms = time_ms(lambda: tk.plain(*sys4))
        # the operands as passed and x
        b_ms, b_by = bound_of(4 * k4.values_moved(*sys4),
                              k4.OPS_PER_VALUE * n4 * m4)
        lay = k4.layout(*sys4, pair=tk.pair)
        phase(f"K4 tridiag, {what} systems (n {n4}, m {m4}; {lay.cols} "
              f"threads, pair {lay.pair}): max abs err {err4:.3e} "
              f"(rtol=atol=1e-5 x scale {sc:.3e}), kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, bound {b_ms * 1e3:.1f} us ({b_by}; "
              f"operands as passed), 0 operands copied")
        k4_rows[what] = dict(max_abs_err=err4, ms=ms, plain_ms=pms,
                             bound_ms=b_ms, bound_by=b_by)
    # any n (the staged kernel up to its limit, the general one above),
    # m not a multiple of 4, f32 and f64, the operands broadcast as the
    # direct solver passes them, scalar-per-row coefficients, full arrays
    err4c = check_k4_cases(dev)
    err4 = max([r["max_abs_err"] for r in k4_rows.values()] + [err4c])
    report.append(dict(name="K4 tridiag", route="cuda",
                       source="dycoreplanet_tpu_torch/csrc/tridiag.cu",
                       replaces="dycoreplanet_tpu/ops/pallas_kernels.py:59",
                       max_abs_err=err4, library_ms=None,
                       **{k: v for k, v in k4_rows["momentum"].items()
                          if k != "max_abs_err"},
                       by_system=k4_rows))
    # the whole direct solve: ||vol x - c L(x) - b|| / ||b||
    x_u = dmodel.helmholtz_direct.solve(b_u, coef)
    resid = dmodel._vol_t[None] * x_u - coef * torch.stack([
        st.weak_laplacian(dmodel.geo, x_u[c], dmodel.u_specs[c])
        for c in range(3)]) - b_u
    rel_res = float(resid.norm() / b_u.norm())
    if not rel_res <= 1e-5:
        fail(f"direct Helmholtz residual {rel_res:.3e} > 1e-5")
    phase(f"direct Helmholtz solve (momentum): relative residual "
          f"{rel_res:.3e} (tol 1e-5)")

    # K2 and K1 at the bench shape, a shape no tile divides and one
    # smaller than a tile, every iteration pair, f32 and f64
    for shape in (BENCH_SHAPE, (6, 20, 36), (4, 8, 16)):
        for dname in ("float32", "float64"):
            e2, e1, passes, nr, e1u, passes_u, bits = check_k1_k2(
                dev, shape, dname)
            report[0]["max_abs_err"] = max(report[0]["max_abs_err"], e2)
            report[1]["max_abs_err"] = max(report[1]["max_abs_err"], e1)
            k1u_row["max_abs_err"] = max(k1u_row["max_abs_err"], e1u)
            e2m = check_k2m(dev, shape, dname)
            k2m_row["max_abs_err"] = max(k2m_row["max_abs_err"], e2m)
            phase(f"K2 / K1 / K1u at {shape} {dname}: max abs err {e2:.3e} "
                  f"/ {e1:.3e} / {e1u:.3e} (iteration pairs {list(PAIRS)} "
                  f"and (3,3) in groups, launches a call K1 {passes}, K1u "
                  f"{passes_u}; worst residual norm {nr:.3g} x tol; K1u "
                  f"bitwise equal to K1: {bits}); K2m {e2m:.3e}")

    # the optional float64 instantiations of K3-K5, at a small grid: the
    # kernels and their plain versions then differ only by reassociation
    m64 = BoussinesqModel(bench_params((8, 16, 32), dtype="float64"),
                          device=dev)
    s64 = seed_developed_flow(m64)
    g, w = m64._proj.faces_div(s64.u, BENCH_DT), m64._proj.plain(s64.u,
                                                                 BENCH_DT)
    e64 = compare("K3 f64", g[:4], w[:4], 1e-12, 1e-12)
    a5 = (s64.u, g[:3], s64.T, s64.p, BENCH_DT,
          st.volume_mean(m64.geo, s64.T))
    e64 = max(e64, compare("K5 f64", m64._proj.correct(*a5),
                           m64._proj.correct_plain(*a5), 1e-12, 1e-12))
    d64 = BoussinesqModel(direct_params(bench_params((8, 16, 32),
                                                     dtype="float64")),
                          device=dev)
    sys64 = d64.helmholtz_direct.systems(
        d64._vol_t[None] * s64.u, d64._scalar(BENCH_DT * d64.one_over_Re))
    e64 = max(e64, compare("K4 f64", (d64._tridiag(*sys64),),
                           (d64._tridiag.plain(*sys64),), 1e-12, 1e-12))
    phase(f"f64 K3-K5 at (8, 16, 32): max abs err {e64:.3e} (tol 1e-12)")

    # ---- 4. main path --------------------------------------------------
    # two warm-up steps first: the first Poisson solve pays the BLAS
    # library's one-time set-up, which is not a per-step cost
    model.run(max_steps=2, state=s0)
    run_out = drive(model, lambda: model.run(max_steps=N_STEPS, state=s0))
    (s_end, hist), launches, wall = run_out
    if len(hist) != N_STEPS:
        fail(f"main path ran {len(hist)} steps, expected {N_STEPS}")
    if model.escalations != 0:
        fail(f"main path escalated {model.escalations} time(s)")
    for x in (s_end.u, s_end.p, s_end.T) + tuple(s_end.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail("main path produced non-finite fields")
    divs = [h["div_norm"] for h in hist]
    div_max = max(divs)
    if not div_max < 1e-4:
        fail(f"post-projection divergence {div_max:.3e} >= 1e-4")
    want_l = {"forcing": N_STEPS, "richardson": N_STEPS, "faces_div": 0,
              "correct": N_STEPS, "tridiag": 0}
    if launches != want_l:
        fail(f"main-path launches {launches}, expected {want_l}")
    ms_step = wall / N_STEPS * 1e3
    phase(f"main path: {N_STEPS} gated steps, 0 escalations, launches "
          f"{launches}, max|div u| first/last/max {divs[0]:.3e}/"
          f"{divs[-1]:.3e}/{div_max:.3e}, "
          f"max|u| {hist[-1]['max_velocity']:.4f}, {ms_step:.3f} ms/step "
          f"(host clock incl. the per-step diagnostics read), "
          f"{n_cells / (wall / N_STEPS):.4e} grid points/s")
    by_path = {name: {"main": n} for name, n in launches.items()}

    def record(label, counts):
        for name, n in counts.items():
            by_path.setdefault(name, {})[label] = n

    # ---- 4b. the main path as multi_step: one CUDA graph a chunk -------
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.multi_step(s0, BENCH_DT, N_STEPS)     # warm-up, capture, replay
    torch.cuda.synchronize()
    mem_peak = torch.cuda.max_memory_allocated()
    _, l_g, _, ms_graph, s_graph, _ = graph_vs_run(
        "main path", model, s0, want_l, run_out)
    replay_by_path = {name: {"graph": n} for name, n in l_g.items()}

    def record_replay(label, counts):
        for name, n in counts.items():
            replay_by_path.setdefault(name, {})[label] = n

    # without collected diagnostics: the last step's row, solver_ok the
    # AND over the chunk; the same state. Its graph is a second key: the
    # memory it adds is what one more kept graph costs
    graphs = model.chunk_graphs
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    model.multi_step(s0, BENCH_DT, N_STEPS, collect_diagnostics=False)
    torch.cuda.synchronize()
    mem2 = torch.cuda.memory_allocated()

    def no_diag():
        return model.multi_step(s0, BENCH_DT, N_STEPS,
                                collect_diagnostics=False)

    (s_nc, packed_nc, _), l_nc = replay_launches(
        "multi_step without diagnostics", model, no_diag, want_l)
    _, _, w_nc = drive(model, no_diag)
    if tuple(packed_nc.shape) != (1, 14) or float(packed_nc[0, 10]) != 1.0:
        fail(f"multi_step without diagnostics: packed {packed_nc.tolist()}")
    if rel_diff(s_nc, s_graph) > 1e-6:
        fail(f"multi_step without diagnostics: rel diff "
             f"{rel_diff(s_nc, s_graph):.3e} to the collecting chunk")
    # the graph cap: with one graph kept, a chunk of another length is
    # captured into the shared pool and both kept graphs are dropped, the
    # 20-step chunk is then captured anew and drops it, and so on; the
    # results stay the first graphs' (two chunks of 10 = one of 20)
    n_kept, graphs.max_graphs = len(graphs), 1
    caps = graphs.captures
    torch.cuda.synchronize()
    mem_kept = torch.cuda.memory_allocated()
    s_half, _, _ = model.multi_step(s0, BENCH_DT, N_STEPS // 2,
                                    collect_diagnostics=False)
    s_ev, _, _ = model.multi_step(s0, BENCH_DT, N_STEPS)
    s_two, _, _ = model.multi_step(s_half, BENCH_DT, N_STEPS // 2,
                                   collect_diagnostics=False)
    d_ev, d_two = rel_diff(s_ev, s_graph), rel_diff(s_two, s_graph)
    del s_half, s_ev, s_two          # the memory of the graphs alone
    torch.cuda.synchronize()
    mem_one = torch.cuda.memory_allocated()
    # dropped graphs' memory is reused, and a capture holds nothing
    # beyond its graph (PyTorch's per-stream cuBLAS workspace: one side
    # stream serves every capture)
    if (graphs.captures != caps + 3 or len(graphs) != 1
            or not d_ev <= 1e-6 or not d_two <= 1e-6
            or mem_one > mem_kept):
        fail(f"graph cap 1: {graphs.captures - caps} captures (expected 3), "
             f"{len(graphs)} kept, rel diff {d_ev:.3e} (recaptured) / "
             f"{d_two:.3e} (two chunks of {N_STEPS // 2}) to the first "
             f"graph's state, memory {(mem_one - mem_kept) / 2**20:+.1f} "
             f"MiB against {n_kept} kept")
    graphs.max_graphs = MAX_GRAPHS
    phase(f"main path as multi_step: {graphs.captures} graphs captured, "
          f"{graphs.replays} replays; without collected diagnostics "
          f"{w_nc / N_STEPS * 1e3:.4f} ms/step, device kernels {l_nc}, rel "
          f"diff {rel_diff(s_nc, s_graph):.3e} to the collecting chunk; peak "
          f"memory of the first chunk {mem_peak / 2**20:.1f} MiB "
          f"({(mem_peak - mem0) / 2**20:.1f} MiB above the "
          f"{mem0 / 2**20:.1f} MiB before it); the second graph (the "
          f"second of {n_kept} kept) added {(mem2 - mem1) / 2**20:.1f} MiB; "
          f"with 1 graph kept: 3 captures, rel diff {d_ev:.3e} recaptured, "
          f"{d_two:.3e} as two chunks of {N_STEPS // 2}, memory against "
          f"{n_kept} kept {(mem_one - mem_kept) / 2**20:+.1f} MiB; host "
          f"ms/step run {ms_step:.4f}, graph {ms_graph:.4f}")

    # ---- 5. escalated path --------------------------------------------
    s_fast, d_fast = model.step(s_end, BENCH_DT)
    before = {name: k.launches for name, k in model.kernels().items()}
    s_strong, d_strong = model.step_strong(s_end, BENCH_DT)
    torch.cuda.synchronize()
    after = {name: k.launches for name, k in model.kernels().items()}
    delta = {k: after[k] - before[k] for k in after}
    want_d = {"forcing": 1, "richardson": 0, "faces_div": 1, "correct": 1,
              "tridiag": 0}
    if delta != want_d:
        fail(f"step_strong launches {delta}, expected {want_d}")
    if not d_strong.solver_ok:
        fail("step_strong did not converge")
    rel = float((s_fast.u - s_strong.u).abs().max()
                / s_strong.u.abs().max())
    # fast (Richardson + direct Poisson) vs full CG: both meet the solver
    # tolerances, floored at 16 eps in f32; allow 100x that floor
    tol = 100 * 16 * float(torch.finfo(torch.float32).eps)
    if not rel <= tol:
        fail(f"step_strong vs fast step: rel |du| {rel:.3e} > {tol:.3e}")
    phase(f"escalated path: step_strong launches {delta}, poisson CG iters "
          f"{d_strong.poisson_iters}, rel |u_fast - u_strong| {rel:.3e} "
          f"(tol {tol:.3e})")

    for name, n in delta.items():
        by_path[name]["escalated"] = n

    # a forced miss inside a multi_step chunk: a fresh model whose
    # fast-diagonalization constant is corrupted, so that the Poisson
    # spot-check fails on the first step; the chunk (a graph) misses and
    # is redone with full CG from the original state
    fm = BoussinesqModel(bench_params(BENCH_SHAPE), device=dev)
    fm.poisson_spectral._inv_denom = 3.0 * fm.poisson_spectral._inv_denom
    fm.poisson_spectral.to(dev)
    sf = seed_developed_flow(fm)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        s_fm, rows_fm, _ = fm.multi_step(sf, BENCH_DT, 4)
    if fm.escalations != 1 or not warned:
        fail(f"forced miss: {fm.escalations} escalation(s), "
             f"{len(warned)} warning(s), expected 1 and 1")
    if fm.chunk_graphs is None or fm.chunk_graphs.replays != 1:
        fail("forced miss: the fast chunk did not run as a graph")
    if not bool((rows_fm[:, 10] == 1).all()):
        fail("forced miss: the CG chunk did not converge")
    w_fm = sf
    for _ in range(4):
        w_fm, _ = fm.step_strong(w_fm, BENCH_DT)
    rel_fm = rel_diff(s_fm, w_fm)
    if not rel_fm <= 1e-6:
        fail(f"forced miss: the CG chunk vs a step_strong loop: rel diff "
             f"{rel_fm:.3e} > 1e-6")
    phase(f"forced miss in a multi_step chunk of 4: 1 escalation, the chunk "
          f"redone with CG (poisson iters {rows_fm[:, 5].tolist()}), vs a "
          f"step_strong loop max rel diff {rel_fm:.3e}")
    del fm, sf, s_fm, w_fm

    # ---- 6. direct-Helmholtz path -------------------------------------
    dmodel.run(max_steps=2, state=ds0)
    drun = drive(dmodel, lambda: dmodel.run(max_steps=N_STEPS, state=ds0))
    (ds_end, dhist), dl, wall = drun
    if len(dhist) != N_STEPS:
        fail(f"direct path ran {len(dhist)} steps, expected {N_STEPS}")
    if dmodel.escalations != 0:
        fail(f"direct path escalated {dmodel.escalations} time(s)")
    for x in (ds_end.u, ds_end.p, ds_end.T) + tuple(ds_end.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail("direct path produced non-finite fields")
    ddivs = [h["div_norm"] for h in dhist]
    if not max(ddivs) < 1e-4:
        fail(f"direct path: post-projection divergence {max(ddivs):.3e} "
             ">= 1e-4")
    want_dl = {"forcing": N_STEPS, "faces_div": N_STEPS,
               "tridiag": 2 * N_STEPS, "correct": N_STEPS}
    if dl != want_dl:
        fail(f"direct-path launches {dl}, expected {want_dl}")
    if dmodel._tridiag.copies:
        fail(f"direct path: K4's wrapper copied {dmodel._tridiag.copies} "
             f"operand(s)")
    ms_step = wall / N_STEPS * 1e3
    phase(f"direct path: {N_STEPS} gated steps, 0 escalations, launches "
          f"{dl}, max|div u| first/last/max {ddivs[0]:.3e}/{ddivs[-1]:.3e}/"
          f"{max(ddivs):.3e}, max|u| {dhist[-1]['max_velocity']:.4f}, "
          f"{ms_step:.3f} ms/step (host clock incl. the per-step "
          f"diagnostics read), {n_cells / (wall / N_STEPS):.4e} grid "
          f"points/s")
    for name, n in dl.items():
        by_path.setdefault(name, {})["direct"] = n
    before = {name: k.launches for name, k in dmodel.kernels().items()}
    _, dd_strong = dmodel.step_strong(ds_end, BENCH_DT)
    torch.cuda.synchronize()
    delta = {name: k.launches - before[name]
             for name, k in dmodel.kernels().items()}
    want_d = {"forcing": 1, "faces_div": 1, "tridiag": 2, "correct": 1}
    if delta != want_d:
        fail(f"direct step_strong launches {delta}, expected {want_d}")
    if not dd_strong.solver_ok:
        fail("direct step_strong did not converge")
    # one direct step against the default model's full-CG step (the
    # escalated step of phase 5, helmholtz tol 1e-8), from one state
    s_direct, _ = dmodel.step(s_end, BENCH_DT)
    rel = float((s_direct.u - s_strong.u).abs().max()
                / s_strong.u.abs().max())
    if not rel <= tol:
        fail(f"direct step vs full-CG step: rel |du| {rel:.3e} > {tol:.3e}")
    phase(f"direct path: step_strong launches {delta}, poisson CG iters "
          f"{dd_strong.poisson_iters}; rel |u_direct - u_cg| {rel:.3e} "
          f"(tol {tol:.3e})")
    _, l_dg, _, _, _, _ = graph_vs_run("direct path", dmodel, ds0, want_dl,
                                       drun)
    record_replay("direct_graph", l_dg)

    # `residual check interval = 4`: K1 with its tracked residuals on
    # steps 0, 4, ..., K1u between them
    want_il = {"forcing": N_STEPS, "richardson": N_STEPS // 4,
               "richardson_free": N_STEPS - N_STEPS // 4, "faces_div": 0,
               "correct": N_STEPS, "tridiag": 0}
    l_ir, l_ig, _, _, _, irows = graph_vs_run(
        "residual check interval 4", imodel, s0, want_il)
    checked = np.arange(N_STEPS) % 4 == 0
    for slot, what in ((7, "helmholtz"), (9, "temperature")):
        if not ((irows[~checked, slot] == -1.0).all()
                and (irows[checked, slot] >= 0.0).all()):
            fail(f"residual check interval 4: {what} residuals "
                 f"{irows[:, slot].tolist()}, expected -1 on the unchecked "
                 f"steps only")
    phase(f"residual check interval 4: helmholtz residuals of the chunk "
          f"{irows[:, 7].tolist()} (-1: not checked)")
    record("interval", l_ir)
    record_replay("interval_graph", l_ig)

    # `NSE solver interval = 2`: every other step a temperature substep
    nmodel = BoussinesqModel(nse2_params(bench_params(BENCH_SHAPE)),
                             device=dev)
    half = N_STEPS // 2
    want_nl = {"forcing": half, "richardson": half, "faces_div": 0,
               "correct": half, "tridiag": 0}
    l_nr, l_ng, _, _, s_nse2, nrows = graph_vs_run(
        "NSE solver interval 2", nmodel, s0, want_nl)
    # the single-device states after 20 steps that phase 6d's mesh runs
    # are held against (a graph chunk's: run's to 1e-6, SL's bitwise)
    mesh_refs = {"nse2": s_nse2}
    if not (nrows[1::2, 5] == 0).all():
        fail("NSE solver interval 2: a temperature substep reports "
             "Poisson iterations")
    record("nse2", l_nr)
    record_replay("nse2_graph", l_ng)
    del nmodel

    # `temperature advection = semi-lagrangian`: K2m and the transport in
    # place of the fused K2, on the default path, the direct path and with
    # temperature substeps; the model has no fused K2 wrapper, and the
    # profiler counts none in the replay
    ss0 = seed_developed_flow(slmodel)
    want_sl = {"forcing_momentum": N_STEPS, "richardson": N_STEPS,
               "faces_div": 0, "correct": N_STEPS, "tridiag": 0}
    sl_paths = [("semi-Lagrangian", slmodel, want_sl, N_STEPS)]
    sdmodel = BoussinesqModel(sl_params(direct_params(bench_params(
        BENCH_SHAPE))), device=dev)
    sl_paths.append(("semi-Lagrangian direct", sdmodel,
                     {"forcing_momentum": N_STEPS, "faces_div": N_STEPS,
                      "tridiag": 2 * N_STEPS, "correct": N_STEPS}, N_STEPS))
    snmodel = BoussinesqModel(sl_params(nse2_params(bench_params(
        BENCH_SHAPE))), device=dev)
    sl_paths.append(("semi-Lagrangian NSE solver interval 2", snmodel,
                     {"forcing_momentum": half, "richardson": half,
                      "faces_div": 0, "correct": half, "tridiag": 0},
                     N_STEPS))
    for label, m_sl, want_s, n_sl in sl_paths:
        if "forcing" in m_sl.kernels():
            fail(f"{label}: the model has a fused K2 wrapper")
        m_sl.run(max_steps=2, state=ss0)
        sl_calls = m_sl._semi_lagrangian.calls
        run_sl = drive(m_sl, lambda: m_sl.run(max_steps=N_STEPS, state=ss0))
        sl_calls = m_sl._semi_lagrangian.calls - sl_calls
        if sl_calls != n_sl:
            fail(f"{label}: {sl_calls} semi-Lagrangian transports in "
                 f"{N_STEPS} steps, expected {n_sl}")
        l_sr, l_sg, ms_sr, ms_sg, s_sl, _ = graph_vs_run(
            label, m_sl, ss0, want_s, run_sl, bitwise=True)
        phase(f"{label}: the transport ran {sl_calls} times in {N_STEPS} "
              f"steps; wrapper launches {l_sr} and forcing 0 (no fused K2 "
              f"wrapper); the replay's device kernels {l_sg}")
        key = {"semi-Lagrangian": "sl", "semi-Lagrangian direct": "sl_direct",
               "semi-Lagrangian NSE solver interval 2": "sl_nse2"}[label]
        record(key, l_sr)
        record_replay(f"{key}_graph", l_sg)
        mesh_refs[key] = s_sl
    del sdmodel, snmodel

    # ---- 6b. the annulus ----------------------------------------------
    k4_annulus, a_paths, a_replays = annulus_phases(dev)
    k4_row = next(r for r in report if r["name"] == "K4 tridiag")
    k4_row["by_system"].update(k4_annulus)
    k4_row["max_abs_err"] = max([k4_row["max_abs_err"]] + [
        r["max_abs_err"] for r in k4_annulus.values()])
    for label, counts in a_paths.items():
        record(label, counts)
    for label, counts in a_replays.items():
        record_replay(label, counts)

    # ---- 6c. the mesh --------------------------------------------------
    mesh_launches, mesh_rows = mesh_phases(dev, s0, s_end, model)
    for label, counts in mesh_launches.items():
        record(label, counts)
    for name, wname, src, rep in (
            ("K2o forcing_operands", "forcing_operands", "forcing.cu",
             "dycoreplanet_tpu/ops/pallas_stencil.py:373"),
            ("K1o richardson_operands", "richardson_operands",
             "richardson.cu",
             "dycoreplanet_tpu/ops/pallas_richardson.py:348")):
        by_mesh = mesh_rows[name[:3]]
        main = by_mesh[f"mesh_{MAIN_MESH[0]}x{MAIN_MESH[1]}"]
        report.append(dict(
            name=name, route="cuda", source=f"dycoreplanet_tpu_torch/csrc/{src}",
            replaces=rep, variant="halo_mode=operands (per shard)",
            max_abs_err=max(r["max_abs_err"] for r in by_mesh.values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None, by_mesh=by_mesh, ptxas=by_wrapper[wname]))

    # ---- 6d. the SL transport and the temperature substeps on the mesh -
    sl_mesh_launches, k2mo_rows = mesh_sl_phases(dev, ss0, s0, mesh_refs,
                                                 slmodel)
    for label, counts in sl_mesh_launches.items():
        record(label, counts)
    main_sl = k2mo_rows[f"sl_mesh_{MAIN_MESH[0]}x{MAIN_MESH[1]}"]
    report.append(dict(
        name="K2mo forcing_momentum_operands", route="cuda",
        source="dycoreplanet_tpu_torch/csrc/forcing.cu",
        replaces="dycoreplanet_tpu/ops/pallas_stencil.py:373",
        variant="halo_mode=operands, advect_T=False (per shard), "
                "dycoreplanet_tpu/ops/pallas_stencil.py:116-131, 280-319, "
                "499-514, 696-730",
        max_abs_err=max(r["max_abs_err"] for r in k2mo_rows.values()),
        ms=main_sl["ms"], plain_ms=main_sl["plain_ms"],
        bound_ms=main_sl["bound_ms"], bound_by=main_sl["bound_by"],
        library_ms=None, by_mesh=k2mo_rows,
        ptxas=by_wrapper["forcing_momentum_operands"]))

    # ---- 7. CLI --------------------------------------------------------
    classic = os.path.join(HERE, "data",
                           "aqua_planet_shell_test_3d-classic.prm")
    with tempfile.TemporaryDirectory() as tmp:
        extra = {"direct": "subsection Numerics\n"
                           "  set helmholtz solver = direct\nend\n",
                 "fixed-dt": "subsection Boussinesq Model\n"
                             "  set adapt time step = false\n"
                             "  set final time = 10\nend\n"}
        sl = ("subsection Numerics\n"
              "  set temperature advection = semi-lagrangian\nend\n")
        extra["sl"] = sl
        extra["sl-fixed-dt"] = sl + extra["fixed-dt"]
        prms = {}
        for label, text in extra.items():
            prms[label] = os.path.join(tmp, f"classic-{label}.prm")
            with open(classic) as f, open(prms[label], "w") as g:
                # a subsection read again merges into the first one
                g.write(f.read() + "\n" + text)
        annulus = {name: os.path.join(HERE, "data", f"{name}.prm")
                   for name in ("aqua_planet", "aqua_planet_test_2d")}
        jobs = []
        for label, prm, chunk in (
                ("classic", classic, []), ("direct", prms["direct"], []),
                ("classic --chunk 4", classic, ["--chunk", "4"]),
                ("fixed dt --chunk 4", prms["fixed-dt"], ["--chunk", "4"]),
                ("semi-Lagrangian", prms["sl"], []),
                ("semi-Lagrangian fixed dt --chunk 4", prms["sl-fixed-dt"],
                 ["--chunk", "4"]),
                ("aqua_planet.prm", annulus["aqua_planet"], []),
                ("aqua_planet_test_2d.prm", annulus["aqua_planet_test_2d"],
                 []),
                ("aqua_planet_test_2d.prm --chunk 4",
                 annulus["aqua_planet_test_2d"], ["--chunk", "4"])):
            steps = "8" if chunk else ("5" if "aqua_planet" in label
                                       else "3")
            jobs.append((label, prm,
                         ["--max-steps", steps, "--no-output"] + chunk))
        # ---- 7b. the CLI with output at work size, its first run side
        # by side with the nine runs above and the CLI runs of phases
        # 8-10 that need nothing of their phase (CLI_AHEAD) ------------
        ahead_dir = tempfile.mkdtemp()
        atexit.register(shutil.rmtree, ahead_dir, True)
        CLI_AHEAD_DIR.append(ahead_dir)
        ahead = (feec_cli_jobs() + cube_cli_jobs(ahead_dir)
                 + mimetic_cli_jobs(ahead_dir)
                 + process_mesh_jobs(ahead_dir, "bc") + comm_table_jobs())
        _, side = cli_output_phase(tmp, jobs + ahead)
        slow = sorted(CLI_SECONDS.items(), key=lambda kv: -kv[1])[:6]
        phase(f"7 the pool's {len(jobs + ahead)} runs and 7b's, the "
              f"slowest: {[(k, round(v, 1)) for k, v in slow]}")
        for (label, *_), run in zip(ahead, side[len(jobs):]):
            CLI_AHEAD[label] = run
        for (label, _, _), (rc, out, err) in zip(jobs, side):
            if rc != 0:
                fail(f"CLI ({label}) rc {rc}:\n{out[-2000:]}\n"
                     f"{err[-2000:]}")
            div_lines = [ln.strip() for ln in out.splitlines()
                         if "Post-projection" in ln]
            phase(f"CLI ({label}) rc 0 ({len(div_lines)} step(s); last: "
                  f"{div_lines[-1] if div_lines else 'none'})")

    # ---- 8. the FEEC personality and the coupled solves ----------------
    feec_launches, feec_replays = feec_phases(dev)
    for label, counts in feec_launches.items():
        record(label, counts)
    for label, counts in feec_replays.items():
        record_replay(label, counts)

    # ---- 9. the cuboid and K4 in CuboidPoissonDirect's layout ----------
    cube_launches, cube_replays, k4_cube, cube_cells = cuboid_phases(dev)
    for label, counts in cube_launches.items():
        record(label, counts)
    for label, counts in cube_replays.items():
        record_replay(label, counts)

    # ---- 10. the mimetic personality and poisson solver = cg | mg ------
    mim_launches, k4_mg, k4_cycle, mim_cells = mimetic_phases(dev)
    for label, counts in mim_launches.items():
        record(label, counts)

    # ---- 11. the remaining Poisson solvers, SL on the 2D geometries,
    # Richardson momentum beside CG temperature -------------------------
    k4_solvers, rem_launches, rem_replays, rem_cells = remaining_phases(dev)
    for label, counts in rem_launches.items():
        record(label, counts)
    for label, counts in rem_replays.items():
        record_replay(label, counts)

    # ---- 12. bf16 on one device and on the mesh; the native VTK encoder
    bf16_rows, bf16_launches, bf16_replays = bf16_phases(dev, s_end)
    for label, counts in bf16_launches.items():
        record(label, counts)
    for label, counts in bf16_replays.items():
        record_replay(label, counts)
    k4_mg["bfloat16"] = bf16_rows["K4 MG"]

    # ---- 13. Krylov, escalation and the plain path on the mesh; the
    # mimetic personality on the mesh ------------------------------------
    cg_mesh_launches, _ = mesh_cg_phases(dev)
    for label, counts in cg_mesh_launches.items():
        record(label, counts)

    # ---- 14. the multigrid and the coupled solves on the mesh ----------
    solve_mesh_launches, k4_sh = mesh_solve_phases(dev)
    for label, counts in solve_mesh_launches.items():
        record(label, counts)

    # ---- 15. the annulus, the 3D box and the 2D slab on their meshes --
    geo_mesh_launches, k4_geo = geometry_mesh_phases(dev)
    for label, counts in geo_mesh_launches.items():
        record(label, counts)

    # ---- 16. direct Helmholtz and the spectral CG on the mesh; the comm
    # ledger ------------------------------------------------------------
    direct_launches, direct_numbers = direct_mesh_phases(dev)
    for label, counts in direct_launches.items():
        record(label, counts)

    # ---- 17. the mesh across processes ---------------------------------
    pm_launches, pm_numbers = process_mesh_phases(dev)
    for label, counts in pm_launches.items():
        record(label, counts)

    # ---- 18. entry(), the production soak and the scaling tables -------
    soak_launches = soak_entry_phases(dev)
    for label, counts in soak_launches.items():
        record(label, counts)

    # ---- 19. report ----------------------------------------------------
    # launches: the wrappers' count on the path the kernel serves (K1,
    # K2, K5: the main path; K3, K4: the direct path; K1u: interval
    # mode; K2m: the semi-Lagrangian path; K1o, K2o: the mesh 2 x 4; K2mo:
    # the SL mesh 2 x 4), and on every eager path (K4 also on the annulus
    # direct path and the coupled paths of phase 8; K1, K3, K5 on FEEC
    # projection); replay_launches_by_path: the
    # device kernels torch.profiler counted in one replay of each path's
    # 20-step graph
    main_mesh = f"mesh_{MAIN_MESH[0]}x{MAIN_MESH[1]}"
    own = {"richardson": "main", "forcing": "main", "correct": "main",
           "faces_div": "direct", "tridiag": "direct",
           "richardson_free": "interval", "forcing_momentum": "sl",
           "richardson_operands": main_mesh, "forcing_operands": main_mesh,
           "forcing_momentum_operands": f"sl_{main_mesh}"}
    # by_dtype["bfloat16"]: the bf16 form's numbers (phase 12), its
    # launches on the bf16 flagship's path where it runs there
    for r in report:
        name = r["name"].split()[1]
        r["launches"] = by_path[name][own[name]]
        r["launches_by_path"] = by_path[name]
        r["replay_launches_by_path"] = replay_by_path.get(name, {})
        b16 = bf16_rows.get(r["name"].split()[0])
        if b16 is not None:
            r.setdefault("by_dtype", {})["bfloat16"] = dict(
                b16, launches=by_path[name].get("bf16_main", 0))
    # K4 in CuboidPoissonDirect's layout (no model builds that solver):
    # launches through the solver's entry point in phase 9 (a), f32
    c32 = k4_cube["float32"]
    report.append(dict(
        name="K4 tridiag (CuboidPoissonDirect layout)", route="cuda",
        source="dycoreplanet_tpu_torch/csrc/tridiag.cu",
        replaces="dycoreplanet_tpu/ops/pallas_kernels.py:59",
        variant="CuboidPoissonDirect's operands, dycoreplanet_tpu/solvers/"
                "spectral.py:66-107: the rfft2's real and imaginary parts "
                "as the pair axis",
        launches=c32["launches"], max_abs_err=max(
            r["max_abs_err"] for r in k4_cube.values()),
        ms=c32["ms"], plain_ms=c32["plain_ms"], bound_ms=c32["bound_ms"],
        bound_by=c32["bound_by"], library_ms=None, by_dtype=k4_cube,
        launches_by_path={"CuboidPoissonDirect.solve": c32["launches"]},
        replay_launches_by_path={}, cells=cube_cells))
    # K4 in the multigrid line smoother's layout: launches on the shell's
    # `poisson solver = mg` path of phase 10 (d), in MG_STEPS steps; the
    # times of one level-0 launch of the periodic lon lines' 2-rhs form,
    # every line kind and dtype under by_dtype
    g32 = k4_mg["float32"]
    head = next(k for k in g32 if "periodic" in k)
    report.append(dict(
        name="K4 tridiag (PoissonMultigrid line layout)", route="cuda",
        source="dycoreplanet_tpu_torch/csrc/tridiag.cu",
        replaces="dycoreplanet_tpu/ops/pallas_kernels.py:59",
        variant="the multigrid line smoother's operands, dycoreplanet_tpu/"
                "solvers/multigrid.py:201-231: contiguous (n, ...) "
                "coefficients, the residual's moved-axis view, the periodic "
                f"Sherman-Morrison pair on axis 1; the times: level 0, {head}",
        launches=mim_launches["poisson_mg_shell"]["tridiag"],
        max_abs_err=max(r["max_abs_err"] for rows in k4_mg.values()
                        for r in rows.values()),
        ms=g32[head]["ms"], plain_ms=g32[head]["plain_ms"],
        bound_ms=g32[head]["bound_ms"], bound_by=g32[head]["bound_by"],
        library_ms=None, by_dtype=k4_mg, launches_per_vcycle=k4_cycle,
        launches_by_path={k: v["tridiag"] for k, v in mim_launches.items()
                          if k.startswith("poisson_mg")},
        replay_launches_by_path={}, cells=mim_cells))
    # K4 in the mesh's V-cycle (phase 14 (a)): every shard's radial lines
    # as they are; launches on the 2x4 mg path in one step, the
    # times of one shard's level-0 launch
    report.append(dict(
        name="K4 tridiag (sharded PoissonMultigrid radial lines)",
        route="cuda", source="dycoreplanet_tpu_torch/csrc/tridiag.cu",
        replaces="dycoreplanet_tpu/ops/pallas_kernels.py:59",
        variant="the mesh's V-cycle (line_axes_allowed=(0,), dycoreplanet_"
                "tpu/models/boussinesq.py:311-322): each shard's "
                "contiguous (nr, nl, no) coefficients and residual, one "
                "launch a shard a line solve; the times: level 0, shard "
                f"{k4_sh['shard']} of {MAIN_MESH[0]}x{MAIN_MESH[1]}",
        launches=k4_sh["launches"], max_abs_err=k4_sh["max_abs_err"],
        ms=k4_sh["ms"], plain_ms=k4_sh["plain_ms"],
        bound_ms=k4_sh["bound_ms"], bound_by=k4_sh["bound_by"],
        library_ms=None, in_step_ms=k4_sh["in_step_ms"],
        launches_per_vcycle_per_shard=k4_sh["per_cycle"],
        launches_by_path={k: v["tridiag"] for k, v in
                          solve_mesh_launches.items() if "mg" in k},
        replay_launches_by_path={}))
    # K4 in the annulus mesh's V-cycle (phase 15 (d)): every phi shard's
    # radial lines as they are; launches on the 8-shard mg path in one
    # step (CG capped at GEO_MG_CAP), the times of one shard's level-0
    # launch (f32; f64 under by_dtype)
    report.append(dict(
        name="K4 tridiag (sharded PoissonMultigrid radial lines, annulus)",
        route="cuda", source="dycoreplanet_tpu_torch/csrc/tridiag.cu",
        replaces="dycoreplanet_tpu/ops/pallas_kernels.py:59",
        variant="the annulus mesh's V-cycle (line_axes_allowed=(0,), "
                "dycoreplanet_tpu/models/boussinesq.py:311-322): each phi "
                "shard's contiguous (nr, no) coefficients and residual, one "
                "launch a shard a line solve; the times: level 0, shard "
                f"{k4_geo['shard']} of {k4_geo['shards']} phi shards",
        launches=k4_geo["launches"], max_abs_err=max(
            r["max_abs_err"] for r in k4_geo["by_dtype"].values()),
        ms=k4_geo["ms"], plain_ms=k4_geo["plain_ms"],
        bound_ms=k4_geo["bound_ms"], bound_by=k4_geo["bound_by"],
        library_ms=None, in_step_ms=k4_geo["in_step_ms"],
        by_dtype=k4_geo["by_dtype"],
        launches_per_vcycle_per_shard=k4_geo["per_cycle"],
        launches_by_path={k: v["tridiag"] for k, v in
                          geo_mesh_launches.items() if "mg" in k},
        replay_launches_by_path={}))
    # K4 in the layouts of the three remaining Poisson solvers (no model
    # builds the direct ones): launches through each solver's entry
    # point in one f32 solve at work size, phase 11 (a) (the spectral CG
    # on a stretched shell with its cap at SPECTRAL_MAXITER); the
    # spectral CG's also in the model's run on a stretched shell, (d)
    for solver, rows in k4_solvers.items():
        r32 = rows["float32"]
        paths = {f"{solver}.solve": r32["launches"]}
        if solver == "ShellPoissonSpectral":
            paths["stretched_shell"] = rem_launches["stretched_shell"][
                "tridiag"]
            mesh_path = f"stretched_shell_mesh_{DIRECT_MESH[0]}x" \
                        f"{DIRECT_MESH[1]}"
            paths[mesh_path] = direct_launches[mesh_path]["tridiag"]
        report.append(dict(
            name=f"K4 tridiag ({solver} layout)", route="cuda",
            source="dycoreplanet_tpu_torch/csrc/tridiag.cu",
            replaces="dycoreplanet_tpu/ops/pallas_kernels.py:59",
            variant=f"{solver}'s operands, {SOLVER_LINES[solver]}: "
                    f"{SOLVER_K4[solver]}",
            launches=r32["launches"], max_abs_err=max(
                r["max_abs_err"] for k, r in rows.items()
                if k != "card_vs_cpu"),
            ms=r32["ms"], plain_ms=r32["plain_ms"],
            bound_ms=r32["bound_ms"], bound_by=r32["bound_by"],
            library_ms=None, by_dtype=rows,
            launches_by_path=paths, replay_launches_by_path={},
            cells=rem_cells if solver == "ShellPoissonDirect" else {}))
    # K4 on the mesh's direct and spectral paths (phase 16): one launch a
    # solve on the one card, in one device's layout
    next(r for r in report if r["name"] == "K4 tridiag")[
        "mesh_direct"] = {k: v for k, v in direct_numbers.items()
                          if k not in ("ledgers", "f64")}
    # K2o and K1o on the process mesh (phase 17 (a)): each rank's numbers
    for r in report:
        if r["name"].split()[0] in ("K2o", "K1o"):
            r["process_mesh"] = pm_numbers["ranks_2x2"]
    phase(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
