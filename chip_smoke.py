#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ibamr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, as a check
    python3 chip_smoke.py --phases kernels     # build + kernel checks only

Phases, in order; any failure raises and the exit code is non-zero:

1. build   -- compile the four CUDA kernels from ``ibamr_tpu_torch/csrc``.
2. kernels -- at the flagship shapes (a real pack and a real per-tile
   bucketing of the 316x316 shell on the 256^3 grid) each kernel against
   its plain PyTorch version on the card, two kernel runs bitwise equal,
   and the times of the kernel, the plain version and one ``torch.bmm``
   yardstick beside the kernel's bound; every kernel writes or reads the
   grid itself, and the overlap-add and tile extraction they fold in are
   timed alone beside them; the packed spread also on a hot tile of
   40,000 markers. The same four rows at ``FLAG_DELTA`` (IB_6) on the
   flagship's own layouts at that support, the hot tile at IB_6 and at
   PIECEWISE_LINEAR, then every kernel at every delta of ``DELTAS`` (40
   instances) on a ``DELTA_GRID``^3 layout (the shell scaled, and uniform
   markers past every face): against its plain version within
   ``TOL_KERNEL`` (``TOL_DELTA`` for BSPLINE_5 and BSPLINE_6), bitwise run
   to run, with its device time, the plain version's and the yardstick's
   beside its bound; the kernel line lists every kernel at every delta.
3. parity  -- 3 midpoint steps of the 32^3 shell (16x16) on the GPU (the
   kernels) and on the CPU (the plain versions) from the same state, on
   the ``pallas_packed``, ``pallas``, ``hybrid_bf16``, ``hybrid_packed``,
   ``packed``, ``mxu``, ``mxu_bf16``, ``packed3`` and ``packed3_bf16``
   engines, each launching its own kernels and no other; a buffered and
   an exceeded overflow through each kernel engine, ``mxu`` and
   ``packed3`` against the CPU scatter oracle.
4. path    -- the flagship step, ``build_shell_example(n_cells=256,
   n_lat=316, n_lon=316, use_fast_interaction="pallas_packed")``, warmed
   up and timed; the kernel launch counts of exactly this run, and no
   tile extraction or overlap-add in it.
4b. deltas -- the flagship at ``FLAG_DELTA`` (IB_6): the ex4 driver,
   ``ib_explicit_ex4.run``, on ``input3d.northstar``'s database with
   ``IBMethod { delta_fcn = "IB_6"; transfer_engine = "pallas_packed" }``
   for ``DELTA_STEPS`` steps (3 ``packed_spread`` and 6 ``packed_interp``
   launches a step at IB_6, no tile extraction or overlap-add), the same
   steps on ``pallas`` through ``build_shell_example(kernel="IB_6")`` (3
   ``tile_spread`` + 6 ``tile_interp``) and on the torch-op ``packed``
   engine; each kernel run against ``packed`` within ``1e-6·max|X|`` and
   ``1e-4·max|u|``; ``DELTA_TIMED`` warm steps of each, ms/step in turns.
   Then every delta of ``DELTAS`` through ``pallas_packed`` and ``pallas``
   on the ``SWEEP`` shell (32^3), one step each against ``packed`` at that
   delta, with its launches.
5. hybrid  -- the flagship on ``hybrid_bf16`` and ``hybrid_packed`` (the
   ``packed_spread`` kernel, the interp in torch ops), warmed up and timed
   beside the path phase's ``pallas_packed``: the launches of exactly
   each run (``packed_spread`` alone), the refresh hits, and one step
   taken twice from the same state, bitwise equal.
5b. engines -- the flagship on ``mxu``, ``mxu_bf16``, ``packed3`` and
   ``packed3_bf16`` (the reference's XLA engines in torch ops): one step
   from the state the path phase reached against ``pallas_packed``'s step
   from it (f32 within the parity tolerances, bf16 within 2e-2 of the
   displacement and of max|u|), then warmed up and timed beside it, with
   the peak device memory of each leg and no hand-kernel launch.
6. driver  -- the ex4 driver, ``ibamr_tpu_torch.examples.ib_explicit_ex4
   .run``, on the committed ``input3d.northstar`` (256^3, 316x316 shell)
   with ``IBMethod.transfer_engine = "pallas"``: steps/s, the metrics log,
   the kernel launches of exactly this run, the checkpoint it wrote
   restored bitwise, and a restart from its mid-run checkpoint.
7. auto    -- the ex4 driver on the committed ``input3d.northstar`` and
   ``input3d`` as they are (no ``transfer_engine``; only the output
   directories and a short run overridden): the engine each resolves
   (``packed`` and ``scatter`` by the default rule), checked against the
   resolver, and its steps/s.
7b. tune   -- the autotuner, ``ibamr_tpu_torch.tune.runner.search``, at
   the reference's default key (16^3, an 8x16 shell) over its default
   engine menu, f32 and bf16 transforms, chunk lengths 1 and 4 (32
   trials, the kernel engines probed on the card first): no candidate
   pruned, no trial error, the ranking and the entry it would publish
   logged (none is written). ``shootout`` (run only when named) is the
   same search at the flagship key over every engine of the registry,
   its whole result logged as one JSON line.
8. ex0     -- the ex0 driver, ``ibamr_tpu_torch.examples.ib_explicit_ex0
   .run``, on the committed ``examples/IB/explicit/ex0/input2d`` as it is
   (64^2, 128 markers, 400 steps; the 2D path runs no hand kernel) in a
   temporary working directory: finite metrics, the area conserved to
   the reference's bound with the eccentricity falling, a restart from
   the step-200 checkpoint bitwise equal to the straight run, the first
   20 steps on the GPU against the CPU, and the steps/s of the restarted
   (warm) leg.
9. walls   -- the lid-driven cavity driver, ``ibamr_tpu_torch.examples.
   navier_stokes_cavity2d.run``, on the committed ``examples/
   navier_stokes/cavity2d/input2d`` as it is (64^2, PPM, no-slip walls
   and a moving lid, 6000 steps to t = 30, f32; the 2D path runs no hand
   kernel): the final centerline against Ghia et al. at the bounds of
   ``tests/test_ins_ppm_walls.py``, the divergence, the first 20 steps on
   the GPU against the CPU, and the warm steps/s.
10. open   -- the channel driver, ``navier_stokes_channel2d.run``, on the
   committed ``examples/navier_stokes/channel2d/input2d`` as it is (32x16,
   150 steps of the FGMRES + multigrid saddle solve, f32): the developed
   profile's error against Poiseuille, a constant outflow flux, the
   divergence, and the first ``OPEN_PARITY_STEPS`` on the GPU against the
   CPU (FGMRES restarts per step equal); then the cylinder driver,
   ``ib_explicit_cylinder2d.run``, on ``examples/IB/explicit/cylinder2d/
   input2d`` (128x64, 64 target markers, f32) with ``num_steps`` cut to
   ``CYL_STEPS``: finite drag and lift, the markers near their anchors,
   the viz files, the first ``OPEN_PARITY_STEPS`` on the GPU against the
   CPU, and the steps/s of each driver; and ``CYL_F64_STEPS`` of the cylinder at f64,
   past the step where the f32 example diverges in the reference and in
   the port. The solves (and the cavity's steps) replay as
   CUDA graphs; one leg of each checks them bitwise against eager. Then
   the filament driver, ``ib_explicit_filament2d.run``, on ``examples/
   IB/explicit/filament2d/input2d`` cut to ``FIL_STEPS`` f32 steps (at
   f32 every saddle solve exhausts its restarts, in the reference too)
   with its first steps against the CPU, and ``FIL_F64_STEPS`` of the
   same build at f64: the tail downstream of the anchor, the length
   within 5%.
11. ibfe3d -- the hand kernels on an FE cloud: ``IBFESurfaceMethod`` on
   a geodesic sphere membrane (4,098 nodes, 8,192 TRI3S facets, 24,576
   quadrature points, unified coupling) in a 128^3 periodic box, on
   ``pallas_packed`` and ``pallas``: one spread and one interp against
   the scatter oracle on the card (twice, bitwise), then 5 coupled
   midpoint steps against the same steps through the CPU's scatter
   oracle, with the launches of each step (3 spread, 6 interp).
12. ibfe   -- the IBFE 2D disc of ``tests/test_ibfe.py:195-240`` through
   the 2D ``mxu``, ``packed`` and ``packed3`` engines against the scatter
   oracle on the card (nodal and unified); the IBFE ex0 driver,
   ``ibfe_explicit_ex0.run``, on the committed
   ``examples/IBFE/explicit/ex0/input2d`` as it is (64^2, 8 rings, 400
   steps): finite metrics, the area drift within 2% at every
   logged step, the elastic energy falling, the first 20 steps on the
   GPU against the CPU and a warm leg; then the beam2d driver on
   ``examples/IBFE/explicit/beam2d/input2d`` as the filament above
   (``BEAM_STEPS`` f32 steps, an f64 leg of ``BEAM_F64_STEPS`` whose
   tip must bend downstream).
13. rigid  -- the CIB ex0 driver on the committed ``examples/CIB/ex0/
   input2d`` with its 40 steps cut to ``CIB_STEPS`` (U_y < 0 and the
   centroid falling at every step; the first steps at f64 against the
   CPU), the oscillating
   cylinder on ``examples/CIB/oscillating_cylinder/input2d`` (walled,
   f64) with its 80 steps cut to the first (fx and the CG's convergence
   against the reference's, |fy| < 0.05 |fx|), then that step with the
   markers cut to ``OSC_MARKERS`` (converged, GPU against CPU), and the eel2d driver on ``examples/
   ConstraintIB/eel2d/input2d`` cut to ``EEL_STEPS`` (swim_dx < 0 at
   the end, the first 20 steps against the CPU). The 2D structure
   paths run no hand kernel; a launch in them fails.
14. adv    -- the IB + advection-diffusion driver, ``adv_diff_ex0.run``, on
   the committed ``examples/adv_diff/ex0/input2d`` as it is (64^2, 128
   markers, 100 steps, upwind scalar, f32): the scalar's total against
   the time integral of the markers' sources, the area, the divergence,
   the first 20 steps on the GPU against the CPU (X, u and the scalar),
   and the warm steps/s.
15. amr    -- the AMR drivers on their committed inputs cut in steps:
   ``ib_explicit_ex0_amr.run`` (64^2, ``EX0_AMR_STEPS`` of 400, a regrid
   every 20) and ``ib_explicit_ex4_amr.run`` (64^3, ``EX4_AMR_STEPS`` of
   120, every 10): steps/s,
   FGMRES restarts per projection, the window origin of every chunk, the
   divergence under the solver's tolerance, the area or volume drift, and
   the first steps on the GPU against the CPU (cut to ``EX0_AMR_CPU_STEPS``
   and ``EX4_AMR_CPU_STEPS``, each past a regrid) with equal origins; the
   composite projection replayed as CUDA graphs bitwise equal to eager;
   then the moving-window scalar advance of ``DYN`` on GPU and CPU: equal
   origins at every regrid, the composite total conserved. Both paths run
   the scatter oracle: a hand-kernel launch fails.
16. mlamr  -- the L-level hierarchy: the ex4_amr shell (its committed
   input: 64^3, 576 markers, a 0.4 stream, f32) on a three-level
   ``MultiLevelIBINS``, each window sized by the input's ``tag_buffer`` at
   its level and placed by ``regrid_multilevel_ib``, dt the smaller of the
   input's and ``stable_dt(cfl=0.5)``, ``ML_STEPS`` steps with a regrid
   every ``ML_REGRID``, with the default preconditioner and with
   ``FACMultilevelPoisson`` through ``precond_factory``: steps/s, restarts
   per projection, the divergence under tol*max|u|/dx_finest, the box
   chain; the reduced hierarchy ``ML_PARITY`` on the card and the CPU
   (equal chains and restarts); ``MultiLevelAdvDiff`` with three levels
   on adv_diff ex0's 64^2 grid (the composite total) and
   ``MultiBoxDynamicAdvDiff`` with two windows, on both (equal origins).
17. implicit -- ``IBImplicitIntegrator`` on the committed ex0 membrane
   (f64): midpoint at 3x the input's dt and backward Euler at 14x,
   ``IMP1_STEPS`` steps each, Newton iterations per step, steps/s, the
   area drift, the first ``IMP1_CPU`` steps against the CPU (equal
   Newton counts); ``TwoLevelIBImplicit`` on the committed ex0_amr at 10x
   its dt with regrids; the IMP disc (128^2), the GIB twisted rod
   (64^3), the penalty membrane (64^2) and an ``InstrumentPanel`` on the
   cavity's flow (closed loops read ~0), each on the card and the CPU;
   the implicit step refusing the ``pallas_packed`` engine. Both phases
   run the scatter oracle: a hand-kernel launch fails.
18. multiphase -- two-phase variable-coefficient flow: the dam-break
   driver, ``multiphase_dam_break.run``, on the committed ``examples/
   multiphase/dam_break/input2d`` as it is (128x96, 600 f32 steps, walls,
   density ratio 1000): the bounds of ``tests/test_examples_r5.py:229-236``
   (a monotone surge front within a cell, the last front past 0.25 + 2
   dx, max|div u| below 1e-2, the volume drift below 1e-2 through that
   test's horizon t = 0.12, and the last drift within
   ``MP_DAM_DRIFT_RTOL`` of the reference's own committed run, which
   passes 1e-2 later), steps/s, CG iterations per step, the graphed
   projection bitwise against eager, and a restart leg at 48x32 (20 steps
   with a dump, then a restart to 40, bitwise equal to the straight run);
   the falling-drop driver on ``input2d`` and ``input2d.walled`` as they
   are (64^2, 300 steps): drift and divergence against ``MP_DROP_DRIFT``
   and ``MP_DROP_DIV``, warm steps/s, and the first ``MP_PARITY_STEPS`` at
   f64 on the card and the CPU (equal CG counts, fields within
   ``TOL_MP_F64``); then ``MP_LEG_STEPS`` f64 steps each, GPU against
   CPU, of the 3D walled drop, the VC membrane capsule, a Brinkman
   cylinder, the open-outlet wave tank, Smagorinsky and k-omega, a
   sheared Oldroyd-B fluid and the collocated Taylor-Green vortex, the
   stochastic forcing's moments on the card's draws and the k-omega
   channel (graphed chunks against the CPU loop). With ``breakdown``, one
   warm dam-break step: device time and kernels, idle share, ms per CG
   iteration, the reinitialization's cost and a fast-sweeping call's
   kernel count. No hand kernel runs.
19. resilience -- the supervised run loop: the flagship on
   ``pallas_packed`` under ``ResilientDriver`` (``RES_STEPS`` steps in
   chunks of ``RES_CHUNK``, a checkpoint every ``RES_RESTART`` through
   the async writer, the health probe, the flight recorder, the f64
   shadow audit every 2 chunks, the watchdog, a run ledger) with a
   recorded dt-gated NaN at step ``RES_NAN_STEP``: exactly one divergence
   incident rolled back to step 20, the run finite at step 40, no audit
   breach, ``driver/chunk`` spans and chunk boundaries in the ledger, the
   launches of exactly the stepped steps, and the incident's capsule
   replayed on the card bitwise (``reproduced``); the warm steps/s of the
   plain loop and of the supervised driver in turns, with the snapshot's
   and the ledger's shares; the four drills of ``ibamr_tpu_torch/tools/
   fault_injection.py`` on the card (rollback and checkpoint corruption,
   silent failures, bf16 -> f32 escalation and replay, and 8 lanes of the
   32^3 shell on ``pallas_packed`` with one poisoned lane); a
   ``profile_trace`` of 3 flagship steps named in the ledger; and
   ``entry()``'s step.
20. prof -- device-time attribution: ``PROF_CHUNKS`` chunks of
   ``PROF_CHUNK`` flagship steps (``pallas_packed``) of the supervised
   ``HierarchyDriver`` under ``profile_trace`` and a run ledger, the
   capture attributed by ``obs/deviceprof.py`` and the ``attribute`` /
   ``check`` / ``diff`` commands of ``ibamr_tpu_torch/tools/prof.py``:
   the summary valid, its total within ``TOL_PROF_TOTAL`` of the
   profiler's own kernel, memcpy and memset sum, ``driver/chunk`` at
   least ``PROF_CHUNK_SHARE`` of the attributed time, FFT time found,
   both packed kernels attributed, the census sidecar of one step joined
   into the roofline (achieved FFT GB/s), a clean self-diff.
21. io -- host I/O at the flagship's sizes: the markers as ``.vtp``, the
   pressure as a binary ``.vti``, the ``ibfe3d`` sphere as ``.vtu`` and a
   99,856-row vertex table through the native C++ library
   (``io/native.py``), each equal to the NumPy/stdlib path.
22. assim -- the assimilation tenant: the four-injector drill of
   ``tools/fault_injection.py`` at the reference's sizes (16^3, 6 lanes,
   6 cycles, f64, scatter oracle) and its ledger summarized by
   ``tools/obs.py``; then ``ASSIM_LANES`` lanes of the flagship at f32 on
   ``pallas_packed``, ``ASSIM_CYCLES`` cycles of ``ASSIM_SPC`` steps with
   the same injectors: every cycle recorded, exactly the injected
   observations rejected, the quarantined lane frozen bitwise, two cache
   entries (the observation piece a CUDA graph) and hits after them, and
   the first analysis against the CPU's f64 ESRF of the same forecast
   ensemble within an f32 bound scaled by the ensemble matrix's
   condition number.
23. serve -- the serving layer (``ibamr_tpu_torch/serve``): the contract
   drill of ``ibamr_tpu_torch/SERVE_CONTRACT.json`` (16^3, scatter, 2
   lanes, 3 steps) with its four structural numbers; one family at the
   flagship's sizes on ``pallas_packed`` (2 lanes, chunk 2) through
   ``cold_warm_drill``: a cold request of ``SERVE_STEPS`` steps and
   ``SERVE_WARM`` warm ones (2 cold builds, 0 warm builds, a cache hit per
   chunk, no new signature; cold and warm first-step seconds, warm p50
   and p99, lane steps/s, the pool's bytes beside
   ``torch.cuda.memory_allocated``), a batch with a poisoned lane
   (``perturb=inf``: quarantined, its neighbour ok), the cruise chunk's
   healthy lane bitwise equal beside the poisoned lane and beside
   padding, and 3 spread and 6 interp launches for every lane step; then
   the soak drill (four chaos injectors) and the elastic drill (mix
   shift, bytes squeeze into brownout, shrink, restart with zero fresh
   builds) at the port's ``SLO.json`` sizes, each ledger summarized by
   ``tools/obs.py`` and checked by ``tools/slo.py`` (the invariants gate;
   the CPU-calibrated latencies are reported).
24. grad -- reverse mode through the solver, no hand kernel: the
   flagship's adjoint on ``packed`` (f32, one step from rest first)
   through ``ibamr_tpu_torch/tools/microbench_grad.run``: primal and VJP
   milliseconds of the substep, the spread, the interp and the whole
   step, the substep's VJP at exactly twice the primal's FFT calls, the
   spread's backward adding no accumulating scatter, the whole step's
   gradient with the adjoint Functions against the same gradient under
   ``plain_autodiff_substep()`` + ``plain_autodiff_transfers()`` within
   ``TOL_GRAD_PLAIN`` of each leaf's max, bitwise run to run, and the
   peak memory of the primal, the custom and the plain VJP; the 32^3
   shell's f64 gradient on the card against the CPU's within
   ``TOL_GRAD_F64``; the design drill of ``tools/fault_injection.py``
   (eel gait, 24^2, f64) and the cantilever at its defaults for 3 Adam
   iterations, strictly descending; ``pallas_packed`` and ``pallas``
   refusing a force that requires grad. ``microbench`` (run only when
   named) runs ``tools/microbench_fluid.py`` and
   ``tools/microbench_transfer.py`` at the flagship, each result on one
   JSON line.
25. parallel -- the parallel layer (``ibamr_tpu_torch/parallel``), no
   hand kernel: the flagship on an 8-shard (4, 2) mesh of ``cuda:0``
   through the block-resident ``make_sharded_step`` (every grid array
   in per-shard blocks on the card, halo stencils, pencil-FFT solves,
   co-partitioned marker transfers), ``PAR_WARM`` warm and ``PAR_STEPS``
   timed steps, against the same steps of the unsharded ``scatter``
   step within ``1e-6·max|X|`` and ``1e-4·max|u|``, bitwise run to run,
   0 whole-grid layouts in the census of one step, ms/step of both
   beside the card's name and power limit; with several GPUs visible
   the flagship over one shard per GPU (with one, a line says the leg
   did not run); ``PencilFFT.project_divergence_free`` at 256^3 against
   ``solvers/fft.py``'s (``SpectralPlan``) projection; the flagship
   state saved as an 8-shard checkpoint and restored onto 4 shards and
   onto 1, bitwise (write and restore seconds, bytes per shard file);
   the ex4 driver's sharded branch on ``input3d.northstar``
   (``run(..., mesh=make_mesh(8))``, ``PAR_DRIVER_STEPS`` steps) against
   its own unsharded run within the same bounds;
   the sharded-checkpoint drill and the fleet drill with its lane-mesh
   leg (8 lanes on 8 shards, the healthy lanes bitwise the replicated
   fleet's) at the reference's drill sizes. ``gpus`` (run only when named,
   on a host with several GPUs): the flagship over one shard per GPU
   against the unsharded step, and the ex4 driver with no mesh given,
   which then shards over every GPU by itself, against the unsharded
   steps of its build.
26. analysis -- the analysis layer (``ibamr_tpu_torch/analysis``): the
   flagship step on ``pallas_packed``, ``pallas`` and ``packed`` (the
   ``auto`` pick) through the dispatch census (one step after a warm-up:
   aten ops, host syncs and device-to-host copies, the hand-kernel
   launches, 3 ``packed_spread`` + 6 ``packed_interp`` on
   ``pallas_packed``, 3 ``tile_spread`` + 6 ``tile_interp`` on
   ``pallas``) and the
   trace census of ``ANALYSIS_TRACE_STEPS`` profiled steps (kernels a
   step by class, device-to-host copies and syncs a step), the packed
   step's census against its ``solo_step_256`` budget; every light
   artifact of ``analysis/contracts.py`` on the card against the
   committed CPU budget (``ibamr_tpu_torch/GRAPH_BUDGETS.json``) metric
   for metric, and its device-to-host copies against the file's card
   counts exactly (as the flagship's on each engine), the launches and
   the CUDA-graph replays named; ``jit_lint`` clean over the package;
   ``utils/backend_guard.py`` finding the card (its probe subprocess in
   a thread beside the counts); last, alone on the card,
   ``tools/relay_watch.py`` making one capture of the three
   microbenchmarks at 16^3.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
raises before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and f32
# FLOP/s outside the tensor cores (the kernels use f32 FMA, no TF32).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def ops_per_marker(S: int) -> int:
    """f32 operations per live marker slot of one transfer at support S:
    3S weights of ~16 operations each, S^2 products wx*wy, and a
    multiply-add at each of the S^3 taps (336 at IB_4)."""
    return 3 * S * 16 + S * S + 2 * S ** 3


TOL_KERNEL = 1e-5        # max|kernel - plain| <= TOL_KERNEL * max|plain|
# the named isotropic deltas the kernels evaluate (ops/delta.CUDA_DELTAS)
DELTAS = ("PIECEWISE_LINEAR", "BSPLINE_2", "IB_3", "BSPLINE_3", "COSINE",
          "IB_4", "BSPLINE_4", "BSPLINE_5", "IB_6", "BSPLINE_6")
FLAG_DELTA = "IB_6"      # kernels and deltas phases: the flagship's other delta
HOT_TILE_DELTAS = ("IB_4", "IB_6", "PIECEWISE_LINEAR")
DELTA_GRID = 64          # kernels phase: every kernel at every delta on 64^3
DELTA_UNIFORM = 3000     # and uniform markers beside the scaled shell there
# The higher B-splines' truncated-power sums cancel to ~20 ulp of the
# weight; where the plain version's grid coordinate moves by an ulp from
# the kernel's (PyTorch divides a CUDA tensor by a Python scalar as a
# product with its rounded reciprocal: a cell size that is not a power of
# two), that comes back as f32 noise: 2.6e-5 of max|plain| for BSPLINE_6
# (tests/test_torch_cuda_kernels.py at nz = 40 on an H100 80GB HBM3 at
# 700 W, against 1e-5); BSPLINE_5 passed 1e-5 there and is given twice
# it for the same cause. Their stated tolerance.
TOL_DELTA = {"BSPLINE_5": 2e-5, "BSPLINE_6": 1e-4}
TOL_PARITY_X = 1e-6      # GPU vs CPU step, relative to max|X|
TOL_PARITY_U = 1e-4      # GPU vs CPU step, relative to max|u|
FLAGSHIP = dict(n_cells=256, n_lat=316, n_lon=316)
DT_FLAGSHIP = 5e-5       # bench.py's flagship timestep
WARMUP, STEPS = 3, 20    # flagship steps before and inside the timing
DRIVER_INPUT = "examples/IB/explicit/ex4/input3d.northstar"
DRIVER_STEPS = 20        # driver phase: steps, viz every 10, restart every 10
AUTO_INPUTS = ("examples/IB/explicit/ex4/input3d.northstar",
               "examples/IB/explicit/ex4/input3d")
AUTO_STEPS, AUTO_TIMED = 4, 5   # auto leg: driver steps, then timed steps
HOT_TILE_MARKERS = 40000  # the packed spread's hot-tile case
HYBRID_ENGINES = ("hybrid_bf16", "hybrid_packed")
# the reference's XLA engines in torch ops beside pallas_packed at the
# flagship (engines phase): no hand kernel; the bf16 ones within the
# reference suite's bf16 class of the f32 step
TORCH_OP_ENGINES = ("mxu", "mxu_bf16", "packed3", "packed3_bf16")
TOL_BF16 = 2e-2
TOL_DX_F32 = 1e-4   # engines phase: f32 step's displacement, rel. max|dX|
ENGINE_WARMUP, ENGINE_STEPS = 2, 10   # engines phase: steps before and in
# the timing (mxu runs ~0.37 s a step, device-bound)
# the tune phase's search: the reference's default key (16^3, an 8x16
# shell), its default engine menu, f32 and bf16 transforms, chunk lengths
# 1 and 4; the shootout phase runs it at the flagship over the registry
TUNE_KEY = dict(n_cells=16, n_lat=8, n_lon=16)
EX0_INPUT = "examples/IB/explicit/ex0/input2d"
EX0_RESTART = 200        # ex0: the checkpoint step restarted from
EX0_PARITY_STEPS = 20    # ex0: steps of the GPU-vs-CPU check
EX0_AREA_DRIFT = 0.02    # |area - area0| / area0: tests/test_ib_membrane.py
CAVITY_INPUT = "examples/navier_stokes/cavity2d/input2d"
# Ghia, Ghia & Shin (1982), Re = 100: u through the vertical centerline,
# and the bounds of tests/test_ins_ppm_walls.py (never widened)
GHIA_Y = np.array([0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531,
                   0.5000, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688,
                   0.9766])
GHIA_U = np.array([-0.03717, -0.04192, -0.04775, -0.06434, -0.10150,
                   -0.15662, -0.21090, -0.20581, -0.13641, 0.00332, 0.23151,
                   0.68717, 0.73722, 0.78871, 0.84123])
GHIA_PROFILE_TOL, GHIA_UMIN_TOL = 1.2e-2, 4e-3
CAVITY_DIV_BOUND = 1e-5   # the f32 run reaches max|div u| = 3.815e-06 on the CPU
WALLS_PARITY_STEPS = 20
WARM_STEPS = 200
CHANNEL_INPUT = "examples/navier_stokes/channel2d/input2d"
# the reference's channel driver prints "developed-profile error vs
# Poiseuille: 2.17e-02" after its 150 steps (JAX's 32-bit mode on the CPU:
# 0.021731913089752197, pinned by tests/test_torch_walls_drivers.py)
CHANNEL_PROFILE_ERR = 0.021731913089752197
CYL_INPUT = "examples/IB/explicit/cylinder2d/input2d"
# of the input's 2000: the reference's own example diverges after step
# ~110 (JAX 32-bit on the CPU; ROADMAP C), and the port with it
CYL_STEPS = 30            # cut from 100 to 60 to make room for the
# resilience phase, to 40 for the engines and tune phases, and to 30 for
# the analysis phase
CYL_F64_STEPS = 140       # the f64 leg: past where the f32 example diverges
# (~110-130 steps); cut from 200 (PR 13: 150) to make room for the
# multiphase and resilience phases
OPEN_PARITY_STEPS = 3     # cut from 10 (PR 13: 5) to make room for the
# multiphase and resilience phases; 3 still cross the 12-restart start
OPEN_DIV_BOUND = 1e-4     # f32 solver floor (tol 1e-5 relative)
TOL_OPEN_FIELDS = 1e-4    # GPU vs CPU after the f32 parity steps, rel. to max|.|
IBFE_EX0_INPUT = "examples/IBFE/explicit/ex0/input2d"
IBFE_PARITY_STEPS = 20    # ibfe: steps of the GPU-vs-CPU check
IBFE_WARM = 25            # ibfe: steps of the warm leg after them; cut
# from 100 to make room for the parallel phase, and from 50 for the
# analysis phase
IBFE_AREA_DRIFT = 0.02    # |area - area0| / area0: tests/test_ibfe.py:176
BEAM_INPUT = "examples/IBFE/explicit/beam2d/input2d"
BEAM_STEPS = 2            # of the input's 1500 (f32: 12 restarts a step;
# cut from 5 to make room for the multiphase phase)
BEAM_PARITY_STEPS = 1     # cut from 2 to make room for the resilience phase
BEAM_F64_STEPS = 25       # cut from 100 to make room for the parallel
# phase, and from 50 for the analysis phase's relay_watch capture
# the ibfe3d leg: a geodesic sphere membrane (4,098 nodes, 8,192 TRI3S
# facets, 24,576 quadrature points) pre-stretched in a 128^3 box
IBFE3D = dict(n_cells=128, radius=0.25, n_subdiv=5,
              stretch=(1.1, 1.0 / 1.1, 1.0), moduli=(1.0, 2.0), mu=0.05,
              dt=5e-4, seed=3)
IBFE3D_STEPS = 5
CIB_INPUT = "examples/CIB/ex0/input2d"
CIB_STEPS = 2             # of the input's 40 (8 s a step: 1,200 CG);
# cut from 10 to 6 to make room for the mlamr and implicit phases, and
# to 3 for the multiphase phase, and to 2 for the resilience phase
CIB_PARITY_STEPS = 1      # at f64, GPU vs CPU; cut from 2 for the
# resilience phase
TOL_RIGID_U = 1e-5        # max|U_gpu - U_cpu| / max|U|
OSC_INPUT = "examples/CIB/oscillating_cylinder/input2d"
# (fx, converged) of the input's first step (of 80): the first record of
# its main.py with JAX_ENABLE_X64=1 on the CPU. The step's CG stops at
# its 300 iterations of nested saddle solves, too slow for the port's
# eager CPU path, so the GPU-vs-CPU check runs with the markers cut to
# OSC_MARKERS, where the CG converges in 14
OSC_REF = (25.621520152268545, False)
OSC_MARKERS = 12
TOL_RIGID_FX = 1e-4       # |fx_gpu - fx_cpu| / |fx_cpu|
EEL_INPUT = "examples/ConstraintIB/eel2d/input2d"
EEL_STEPS = 200           # of the input's 2000 (the swimmer moves against
# the wave from step ~150 on); cut to 500 to make room for the resilience
# phase, to 300 for the engines and tune phases, and to 200 for the
# analysis phase
EEL_PARITY_STEPS = 10     # cut from 20 to make room for the parallel phase
FIL_INPUT = "examples/IB/explicit/filament2d/input2d"
FIL_STEPS = 2             # of the input's 4000 (f32: 12 restarts a step;
# cut from 5 to make room for the multiphase phase)
FIL_PARITY_STEPS = 1      # cut from 2 to make room for the resilience phase
FIL_F64_STEPS = 20        # cut from 100 to 50 and 30 to make room for the
# multiphase and resilience phases, and to 20 for the analysis phase
FIL_LENGTH_STEPS = 300
ADV_INPUT = "examples/adv_diff/ex0/input2d"
ADV_PARITY_STEPS = 20     # adv: steps of the GPU-vs-CPU check
ADV_WARM = 100            # adv: steps of the warm leg after the run
TOL_PARITY_Q = 1e-4       # GPU vs CPU scalar, relative to max|Q|
ADV_TOTAL_TOL = 1e-5      # |scalar total - N t| / (N t): f32 sums
ADV_DIV_BOUND = 1e-5      # the f32 run reaches max|div u| ~1e-7 on the CPU
EX0_AMR_INPUT = "examples/IB/explicit/ex0_amr/input2d"
EX4_AMR_INPUT = "examples/IB/explicit/ex4_amr/input3d"
# the card runs of the AMR drivers: the committed inputs' 400 and 120
# steps cut to make room for the analysis phase's relay_watch capture
# (ex0_amr's window still moves, at step 140)
EX0_AMR_STEPS = 200
EX4_AMR_STEPS = 60
# the CPU legs of the AMR drivers, cut in steps (each past a regrid)
EX0_AMR_CPU_STEPS = 21    # of 400: the regrid at step 20 and one step
EX4_AMR_CPU_STEPS = 11    # of 120: the regrid at step 10 and one step
AMR_WARM = 5              # amr: steps of the warm legs at the last window;
# cut from 20 to make room for the parallel phase, and from 10 for the
# analysis phase
# |volume drift| of the shell's radial-sample proxy, which moves ~2% as a
# taut shell settles: the bound of tests/test_amr_ins.py:197
AMR_VOLUME_DRIFT = 3e-2
# the moving-window advance of tests/test_amr_dynamic.py:122 (48^2, a
# 12^2 window, 64 steps with a regrid every 4), in f32
DYN = dict(n=48, box=12, kappa=1e-4, u0=0.7, threshold=0.03, steps=64,
           regrid=4)
DYN_TOTAL_TOL = 1e-5      # composite total, relative: f32 roundoff
# mlamr: the ex4_amr shell on three levels, each window sized by the
# input's tag_buffer at its level, a regrid every 10 steps
ML_STEPS = 40
ML_REGRID = 10
ML_WARM = 5               # warm steps after the run; cut from 10 to make
# room for the analysis phase
# mlamr's GPU-vs-CPU leg: 64^3 with three levels takes ~190 s a step on
# eight CPU cores, so the CPU leg runs the 3D set-up of
# tests/test_amr_ins_multilevel.py:274 (24^3 root, the 10x10 shell), f32,
# with 14^3 windows (the shell and its 3-cell margins need 13) and the
# level-2 window placed off center, so that it moves at the first regrid
ML_PARITY = dict(n=24, center=(0.5, 0.5, 0.5), shape=14,
                 boxes=((5, 5, 5), (5, 7, 7)), steps=4, regrid=2, dt=5e-4)
# mlamr's scalar legs: three levels on adv_diff ex0's grid (f32 total), and
# K = 2 windows at the size of tests/test_amr_multibox.py's regrid run
ML_ADV = dict(kappa=1e-3, steps=100, tol=1e-5)
MB = dict(n=48, box=14, kappa=2e-3, amp=0.25, threshold=0.02, steps=60,
          regrid=6, dt=2.5e-4)
# implicit: the ex0 membrane (f64), the first IMP1_CPU steps also on the CPU
IMP1_STEPS = 4            # cut from 20 to 10, 6 and 4 to make room for
# the multiphase, resilience and parallel phases
IMP1_CPU = 3
IMPLICIT_AREA_DRIFT = 0.02
# implicit: ex0_amr at 10x its dt, a regrid every 2 steps (f64)
IMP2 = dict(factor=10.0, steps=4, regrid=2)
# implicit: the structure models, each on the card and the CPU (f32)
IMPD = dict(n=128, steps=20, dt=5e-4)
# the rod's dt of tests/test_rods.py (5e-4) is past the explicit limit at
# 64^3: the energy grows 70x in 10 steps; half of it relaxes the twist
GIB = dict(n=64, steps=20, dt=2.5e-4)
PEN = dict(n=64, steps=20, dt=1e-3)
PANEL_STEPS = 200
PANEL_CLOSED_TOL = 1e-2   # |flux| of a closed loop / (max|u| x its length)
MP_DAM_INPUT = "examples/multiphase/dam_break/input2d"
MP_DROP_INPUTS = ("examples/multiphase/falling_drop/input2d",
                  "examples/multiphase/falling_drop/input2d.walled")
MP_WARM = 10              # multiphase: warm steps after each driver's run
# The dam break's volume drift: the bound 1e-2 of tests/test_examples_r5.py
# :235 is set on that test's 64x48 tank at t = 0.12; the committed 128x96
# input drifts past it later in the reference itself (JAX 32-bit on the
# CPU: 1.0789e-03 at t = 0.12, step 240; 3.769441711099415e-02 at step
# 600). So the bound holds through t = 0.12, and the last record is held
# to the reference's own within MP_DAM_DRIFT_RTOL.
MP_DAM_BOUND_T = 0.12
MP_DAM_REF_DRIFT = 3.769441711099415e-02
MP_DAM_DRIFT_RTOL = 0.05
MP_PARITY_STEPS = 5       # falling drop: f64 steps GPU vs CPU; cut from 10
# to make room for the parallel phase
MP_LEG_STEPS = 3          # the other multiphase legs: f64 steps each
MP_CHANNEL_ITERS = 1000   # the k-omega channel's iterations on each side;
# cut from 3000 to make room for the analysis phase
MP_DROP_DRIFT = 5e-2      # falling drop |V - V0| / V0 after 300 steps:
# the reference's own run reaches 2.53e-2 (input2d; tests/test_ins_vc_walls
# .py:137 bounds its walled drop by 5e-2)
MP_DROP_DIV = 1e-3        # falling drop max|div u|, f32 (cg_tol 1e-5)
TOL_MP_F64 = 1e-10        # f64 GPU vs CPU through CG at cg_tol 1e-10
DEVICE = "cuda"
# the TPU kernel each CUDA kernel replaces, and its source
KERNELS = {
    "packed_spread": ("ibamr_tpu_torch/csrc/packed_spread.cu",
                      "ibamr_tpu/ops/pallas_interaction.py:250"),
    "packed_interp": ("ibamr_tpu_torch/csrc/packed_interp.cu",
                      "ibamr_tpu/ops/pallas_interaction.py:314"),
    "tile_spread": ("ibamr_tpu_torch/csrc/tile_spread.cu",
                    "ibamr_tpu/ops/pallas_interaction.py:94"),
    "tile_interp": ("ibamr_tpu_torch/csrc/tile_interp.cu",
                    "ibamr_tpu/ops/pallas_interaction.py:195"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Device time of one call, from CUDA events over ``reps`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> None:
    from ibamr_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    kernel_build.load_all()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s "
        f"(nvcc: {kernel_build.build_report.get('seconds', 0.0):.2f} s, "
        f"built {kernel_build.build_report.get('built', [])})")
    for name, info in kernel_build.build_report.get("ptxas", {}).items():
        for line in info.splitlines():
            log(f"[build] {name}: {line.strip()}")


def _check_kernel(name: str, kernel, plain, library, nbytes: int,
                  ops: float, live=None, note: str = "",
                  tol=None) -> dict:
    """One kernel against its plain version on the same inputs: max
    abs error (on live slots where ``live`` is given: the engine weights
    the rest by 0), run-to-run bitwise equality, and the times of the
    kernel (its device time from the profiler, and CUDA events around
    back-to-back wrapper calls, which the host's launch rate can set for a
    short kernel), the plain version and the ``torch.bmm`` yardstick
    beside the bound of ``nbytes`` moved and ``ops`` operations, within
    ``tol`` (TOL_KERNEL when None) of max|plain|."""
    tol = TOL_KERNEL if tol is None else tol
    err, scale, bitwise = _compare(kernel, plain, live)
    ms = _device_ms(kernel, 20)[0]
    for _ in range(2):
        # a capture that recorded no device activity is retried; the
        # profiler has come back empty on the card now and then
        if ms > 0:
            break
        ms = _device_ms(kernel, 20)[0]
    calls_ms = time_ms(kernel, 50)
    if not ms > 0:
        log(f"[kernels] {name}: the profiler recorded no device time in "
            f"three captures; the kernel time is the CUDA events' over "
            f"back-to-back calls")
        ms = calls_ms
    plain_ms = time_ms(plain, 5)
    library_ms = time_ms(library, 10)
    bms, by = bound(nbytes, ops)
    log(f"[kernels] {name}: max|kernel-plain|"
        f"{' on live slots' if live is not None else ''}={err:.3e} "
        f"(tol {tol:g}*max|plain| = {tol * scale:.3e}) "
        f"bitwise run-to-run={bitwise} kernel_ms(profiler device)={ms:.4f} "
        f"(events over back-to-back calls {calls_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms(bmm, {note})="
        f"{library_ms:.4f} bound_ms={bms:.4f} ({by}, {nbytes} B)")
    if not (err <= tol * scale and bitwise):
        raise AssertionError(f"{name} disagrees with its plain version or "
                             "is not run-to-run bitwise")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def _compare(kernel, plain, live=None):
    """Max |kernel - plain| (on live slots where ``live`` is given), max
    |plain| and whether two kernel runs are bitwise equal."""
    k1, k2, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    diff, mag = (k1 - ref).abs(), ref.abs()
    if live is not None:
        diff, mag = diff * live, mag * live
    return float(diff.max()), float(mag.max()), bool(torch.equal(k1, k2))


def _touched_tiles(wx, wy, wz, live, tid, B, P, nz) -> torch.Tensor:
    """(B, P, nz) count of live slots whose support covers each tile
    entry (t, p, z)."""
    lw = live[:, None, :].to(wz.dtype)
    touched = torch.einsum("qam,qbm,qzm->qabz", (wx != 0) * lw,
                           (wy != 0).to(wz.dtype), (wz != 0).to(wz.dtype))
    per_tile = torch.zeros((B, P, nz), dtype=wz.dtype, device=wz.device)
    return per_tile.index_add_(0, tid.to(torch.int64),
                               touched.reshape(tid.shape[0], P, nz))


def phase_kernels() -> dict:
    """Each kernel against its plain version at the flagship shapes, at
    IB_4 and at FLAG_DELTA, then every kernel at every delta on a
    DELTA_GRID^3 layout."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.models.shell3d import make_spherical_shell
    from ibamr_tpu_torch.ops.interaction import _centering_offsets

    dev = torch.device(DEVICE)
    n = FLAGSHIP["n_cells"]
    grid = StaggeredGrid(n=(n,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    shell = make_spherical_shell(FLAGSHIP["n_lat"], FLAGSHIP["n_lon"], 0.25,
                                 (0.5, 0.5, 0.5), 1.0, 0.75, 1.2)
    X = torch.tensor(shell.vertices, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(0)
    offs = _centering_offsets(grid, 0)
    F = torch.randn(X.shape[0], generator=gen).to(dev)
    f = torch.randn(grid.n, generator=gen).to(dev)
    rows = _flagship_rows(grid, shell.vertices, X, F, f, offs, "IB_4")
    rows.update(_flagship_rows(grid, shell.vertices, X, F, f, offs,
                               FLAG_DELTA))
    for delta in HOT_TILE_DELTAS:
        check_hot_tile(grid, offs, delta)
    rows.update(_delta_rows())
    return rows


def _row_name(kernel: str, delta: str, small: bool = False) -> str:
    """A kernel line's name: the flagship's IB_4 rows keep the kernel's
    name; others carry the delta, and the DELTA_GRID^3 layout."""
    if small:
        return f"{kernel}[{delta},{DELTA_GRID}^3]"
    return kernel if delta == "IB_4" else f"{kernel}[{delta}]"


def _flagship_rows(grid, vertices, X, F, f, offs, delta) -> dict:
    """The four kernels at ``delta`` on the flagship's real pack and per-
    tile bucketing, each against its plain version and timed beside its
    bound and the ``torch.bmm`` yardstick; at IB_4 also the overlap-add
    and the tile extraction the kernels fold in, timed alone, and the
    IB_4 hot tile."""
    from ibamr_tpu_torch.models.shell3d import construct_transfer_engine
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops.delta import get_kernel
    from ibamr_tpu_torch.ops.interaction_fast import (_extract_tiles,
                                                      _overlap_add,
                                                      bucketed_channel)

    dev = X.device
    n = grid.n[0]
    ops = ops_per_marker(get_kernel(delta)[0])
    gen = torch.Generator().manual_seed(1)
    rows = {}

    # -- packed kernels, on a real pack ----------------------------------
    eng = construct_transfer_engine("pallas_packed", grid, vertices, delta,
                                    device=dev)
    b = eng.buckets(X)
    geom, table = eng.geom, eng.table
    Q, c = b.wb.shape
    live = b.wb != 0
    n_live = int(live.sum())
    B = math.prod(geom.nblk)
    P = geom.width[0] * geom.width[1]
    per_tile = torch.bincount(b.tile_of_chunk[live.any(1)].long(),
                              minlength=B)
    log(f"[kernels] {delta} flagship pack: N={X.shape[0]} Q={Q} c={c} B={B} "
        f"P={P} nz={n} live slots={n_live} occupied tiles="
        f"{int((per_tile > 0).sum())} max chunks per tile="
        f"{int(per_tile.max())} overflow={b.any_overflow}")
    coef = (bucketed_channel(b, F) * b.wb / grid.cell_volume).contiguous()
    T_in = _extract_tiles(geom, grid, f).contiguous()
    tid, Xb = b.tile_of_chunk, b.Xb
    wx, wy, wz = ci.tile_weights(geom, grid, offs, tid, Xb, delta)
    A = (wx[:, :, None, :] * wy[:, None, :, :]).reshape(Q, P, c)
    Wzc = (wz * coef[:, None, :]).transpose(1, 2).contiguous()
    # the spread stores the grid once and reads tid, every coef and the X
    # of the live slots (coef != 0) only
    rows[_row_name("packed_spread", delta)] = _check_kernel(
        _row_name("packed_spread", delta),
        lambda: ci.packed_spread(geom, grid, offs, tid, Xb, coef, delta,
                                 table),
        lambda: ci.packed_spread_plain(geom, grid, offs, tid, Xb, coef,
                                       delta),
        lambda: torch.bmm(A, Wzc),
        4 * (tid.numel() + coef.numel() + 3 * n_live + f.numel()),
        n_live * ops, note="product only", tol=TOL_DELTA.get(delta))
    del A, Wzc
    if delta == "IB_4":
        # what the two spread kernels fold in, alone at the flagship
        # shapes: the overlap-add of (B, P, nz) partials
        T_part = torch.randn((B, P, n), generator=gen).to(dev)
        fold_ms = time_ms(lambda: _overlap_add(geom, grid, T_part), 10)
        log(f"[kernels] folded into packed_spread and tile_spread, timed "
            f"alone: _overlap_add of ({B}, {P}, {n}) partials {fold_ms:.4f} "
            f"ms")
        del T_part
        extract_ms = time_ms(lambda: _extract_tiles(geom, grid, f), 10)
        log(f"[kernels] folded into packed_interp, timed alone: "
            f"_extract_tiles of a {n}^3 field into ({B}, {P}, {n}) tiles "
            f"{extract_ms:.4f} ms")
    # an interp reads the grid entries under the live supports once, the
    # X of every slot (it evaluates them all), tid, and writes (Q, c)
    touched = _touched_tiles(wx, wy, wz, live, tid, B, P, n)
    n_touched = int((_overlap_add(geom, grid, touched) != 0).sum())
    del touched
    Tq = T_in[tid.to(torch.int64)].contiguous()
    rows[_row_name("packed_interp", delta)] = _check_kernel(
        _row_name("packed_interp", delta),
        lambda: ci.packed_interp(geom, grid, offs, tid, Xb, f, delta, table),
        lambda: ci.packed_interp_plain(geom, grid, offs, tid, Xb, f, delta),
        lambda: torch.bmm(Tq, wz),
        4 * (tid.numel() + Xb.numel() + n_touched + Q * c),
        n_live * ops, tol=TOL_DELTA.get(delta),
        note=f"z-contraction only; {n_touched} grid entries touched")
    del Tq, wx, wy, wz

    # -- tile kernels, on the pallas engine's real per-tile bucketing ------
    eng = construct_transfer_engine("pallas", grid, vertices, delta,
                                    device=dev)
    b = eng.buckets(X)
    geom, table = eng.geom, eng.table
    cap = geom.cap
    P = geom.width[0] * geom.width[1]
    T_in = _extract_tiles(geom, grid, f).contiguous()
    live = b.wb != 0
    n_live = int(live.sum())
    n_over = int((b.slot_of_marker >= B * cap).sum())
    log(f"[kernels] {delta} flagship per-tile bucketing: N={X.shape[0]} "
        f"B={B} cap={cap} P={P} nz={n} live slots={n_live} (slot "
        f"utilization {n_live / (B * cap):.3f}) occupied tiles="
        f"{int(live.any(1).sum())} hottest tile "
        f"{int(live.sum(1).max())} overflow markers={n_over} "
        f"(buffer {b.o_idx.numel()}, exceeded={b.exceeded})")
    if B != 1024 or cap != 1024:
        raise AssertionError(f"expected B = cap = 1024, got {B}, {cap}")
    coef = (bucketed_channel(b, F) * b.wb / grid.cell_volume).contiguous()
    Xb, counts = b.Xb, b.counts
    tid = torch.arange(B, dtype=torch.int32, device=dev)
    wx, wy, wz = ci.tile_weights(geom, grid, offs, tid, Xb, delta)
    A = (wx[:, :, None, :] * wy[:, None, :, :]).reshape(B, P, cap)
    Wzc = (wz * coef[:, None, :]).transpose(1, 2).contiguous()
    # the kernel stores the grid once and reads the X and coef of the
    # filled slots (here all live) and the counts
    rows[_row_name("tile_spread", delta)] = _check_kernel(
        _row_name("tile_spread", delta),
        lambda: ci.tile_spread(geom, grid, offs, Xb, coef, counts, delta,
                               table),
        lambda: ci.tile_spread_plain(geom, grid, offs, Xb, coef, counts,
                                     delta),
        lambda: torch.bmm(A, Wzc),
        4 * (f.numel() + 4 * n_live + B),
        n_live * ops, note="product only", tol=TOL_DELTA.get(delta))
    del A, Wzc
    if delta == "IB_4":
        log(f"[kernels] folded into the tile kernels, timed alone: "
            f"_overlap_add of ({B}, {P}, {n}) partials {fold_ms:.4f} ms, "
            f"_extract_tiles of a {n}^3 field {extract_ms:.4f} ms")
    # an interp reads the grid entries under the live supports once
    touched = _touched_tiles(wx, wy, wz, live, tid, B, P, n)
    n_touched = int((_overlap_add(geom, grid, touched) != 0).sum())
    del touched
    rows[_row_name("tile_interp", delta)] = _check_kernel(
        _row_name("tile_interp", delta),
        lambda: ci.tile_interp(geom, grid, offs, Xb, f, counts, delta,
                               table),
        lambda: ci.tile_interp_plain(geom, grid, offs, Xb, f, counts,
                                     delta),
        lambda: torch.bmm(T_in, wz),
        4 * (3 * n_live + n_touched + B * cap + B),
        n_live * ops, live=live, tol=TOL_DELTA.get(delta),
        note=f"z-contraction only; {n_touched} grid entries touched")
    return rows


def _delta_rows() -> dict:
    """Every kernel at every delta of DELTAS on a DELTA_GRID^3 layout (the
    flagship's shell scaled to the grid, and uniform markers whose
    supports reach past every face): against its plain version, bitwise
    run to run, its device time from one profiler capture of the four
    kernels a delta, the plain version's and the ``torch.bmm``
    yardstick's beside its bound."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.models.shell3d import (construct_transfer_engine,
                                                make_spherical_shell)
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops.delta import get_kernel
    from ibamr_tpu_torch.ops.interaction import _centering_offsets
    from ibamr_tpu_torch.ops.interaction_fast import (_extract_tiles,
                                                      _overlap_add,
                                                      bucketed_channel)

    dev = torch.device(DEVICE)
    n = DELTA_GRID
    grid = StaggeredGrid(n=(n,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    lat = round(FLAGSHIP["n_lat"] * n / FLAGSHIP["n_cells"])
    shell = make_spherical_shell(lat, lat, 0.25, (0.5, 0.5, 0.5), 1.0, 0.75,
                                 1.2)
    rng = np.random.default_rng(4)
    verts = np.concatenate([shell.vertices,
                            rng.uniform(0, 1, (DELTA_UNIFORM, 3))])
    X = torch.tensor(verts, dtype=torch.float32, device=dev)
    F = torch.tensor(rng.standard_normal(X.shape[0]), dtype=torch.float32,
                     device=dev)
    f = torch.tensor(rng.standard_normal(grid.n), dtype=torch.float32,
                     device=dev)
    offs = _centering_offsets(grid, 0)
    rows = {}
    for delta in DELTAS:
        S = get_kernel(delta)[0]
        tol = TOL_DELTA.get(delta, TOL_KERNEL)
        pe = construct_transfer_engine("pallas_packed", grid, verts, delta,
                                       device=dev)
        te = construct_transfer_engine("pallas", grid, verts, delta,
                                       device=dev)
        pb, tb = pe.buckets(X), te.buckets(X)
        B = math.prod(pe.geom.nblk)
        P = pe.geom.width[0] * pe.geom.width[1]
        ptid, ttid = pb.tile_of_chunk, torch.arange(B, dtype=torch.int32,
                                                    device=dev)
        pc = (bucketed_channel(pb, F) * pb.wb / grid.cell_volume).contiguous()
        tc = (bucketed_channel(tb, F) * tb.wb / grid.cell_volume).contiguous()
        plive, tlive = pb.wb != 0, tb.wb != 0
        pw = ci.tile_weights(pe.geom, grid, offs, ptid, pb.Xb, delta)
        tw = ci.tile_weights(te.geom, grid, offs, ttid, tb.Xb, delta)
        touched = {k: int((_overlap_add(e.geom, grid, _touched_tiles(
            *w, lv, tid, B, P, n)) != 0).sum())
                   for k, e, w, lv, tid in (("packed", pe, pw, plive, ptid),
                                            ("tile", te, tw, tlive, ttid))}
        T_in = _extract_tiles(pe.geom, grid, f).contiguous()
        cases = {
            "packed_spread": (
                lambda: ci.packed_spread(pe.geom, grid, offs, ptid, pb.Xb,
                                         pc, delta, pe.table),
                lambda: ci.packed_spread_plain(pe.geom, grid, offs, ptid,
                                               pb.Xb, pc, delta),
                lambda: torch.bmm(
                    (pw[0][:, :, None] * pw[1][:, None]).reshape(
                        ptid.numel(), P, -1),
                    (pw[2] * pc[:, None]).transpose(1, 2)),
                4 * (ptid.numel() + pc.numel() + 3 * int(plive.sum())
                     + f.numel()), int(plive.sum()), None),
            "packed_interp": (
                lambda: ci.packed_interp(pe.geom, grid, offs, ptid, pb.Xb, f,
                                         delta, pe.table),
                lambda: ci.packed_interp_plain(pe.geom, grid, offs, ptid,
                                               pb.Xb, f, delta),
                lambda: torch.bmm(T_in[ptid.long()], pw[2]),
                4 * (ptid.numel() + pb.Xb.numel() + touched["packed"]
                     + pb.wb.numel()), int(plive.sum()), None),
            "tile_spread": (
                lambda: ci.tile_spread(te.geom, grid, offs, tb.Xb, tc,
                                       tb.counts, delta, te.table),
                lambda: ci.tile_spread_plain(te.geom, grid, offs, tb.Xb, tc,
                                             tb.counts, delta),
                lambda: torch.bmm(
                    (tw[0][:, :, None] * tw[1][:, None]).reshape(B, P, -1),
                    (tw[2] * tc[:, None]).transpose(1, 2)),
                4 * (f.numel() + 4 * int(tlive.sum()) + B),
                int(tlive.sum()), None),
            "tile_interp": (
                lambda: ci.tile_interp(te.geom, grid, offs, tb.Xb, f,
                                       tb.counts, delta, te.table),
                lambda: ci.tile_interp_plain(te.geom, grid, offs, tb.Xb, f,
                                             tb.counts, delta),
                lambda: torch.bmm(T_in, tw[2]),
                4 * (3 * int(tlive.sum()) + touched["tile"] + tb.wb.numel()
                     + B), int(tlive.sum()), tlive)}
        held = {}
        for name, (kern, plain, _, _, _, lv) in cases.items():
            err, scale, bitwise = _compare(kern, plain, lv)
            held[name] = err
            if not (err <= tol * scale and bitwise):
                raise AssertionError(
                    f"{name} at {delta} on the {n}^3 layout: max|kernel-"
                    f"plain|={err:.3e} against tol {tol:g}*max|plain| = "
                    f"{tol * scale:.3e}, bitwise run-to-run={bitwise}")
        dev_ms = _kernel_device_ms({k: v[0] for k, v in cases.items()}, 10)
        for name, (kern, plain, library, nbytes, n_live, _) in cases.items():
            ms = dev_ms.get(name) or time_ms(kern, 20)
            plain_ms, library_ms = time_ms(plain, 3), time_ms(library, 5)
            bms, by = bound(nbytes, n_live * ops_per_marker(S))
            rows[_row_name(name, delta, True)] = dict(
                max_abs_err=held[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms)
        log(f"[kernels] {delta} on {n}^3 ({X.shape[0]} markers, Q="
            f"{ptid.numel()}, cap={te.geom.cap}): max|kernel-plain| "
            + ", ".join(f"{k} {held[k]:.2e}" for k in cases)
            + f" (tol {tol:g}*max|plain|), bitwise run to run; device ms "
            + ", ".join(f"{k} {rows[_row_name(k, delta, True)]['ms']:.4f}"
                        for k in cases))
    return rows


def _kernel_device_ms(fns: dict, reps: int) -> dict:
    """Each hand kernel's device time a call, from one profiler capture of
    ``reps`` calls of every function of ``fns`` (name -> wrapper call);
    a name the capture did not record is missing."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = _self_device_us(e)
        for name in fns:
            if us > 0 and f"{name}_kernel" in e.key:
                out[name] = out.get(name, 0.0) + us / reps / 1e3
    return out


def check_hot_tile(grid, offs, delta: str = "IB_4") -> None:
    """The packed spread at ``delta`` on a pack whose one hot tile holds
    HOT_TILE_MARKERS markers (313 chunks of 128): the columns around it
    hold more 32-slot chunks than the kernel's chunk table and more than
    2^15 live slots, so they walk every chunk per slab and narrow their
    fixed point (by the delta's cut too). Kernel against plain, bitwise
    run to run."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops.delta import get_kernel
    from ibamr_tpu_torch.ops.interaction_fast import bucketed_channel
    from ibamr_tpu_torch.ops.interaction_packed import suggest_chunks

    rng = np.random.default_rng(2)
    N = HOT_TILE_MARKERS
    half = 0.5 * get_kernel(delta)[0]
    # stencil origins 8..14: one tile
    lo, hi = (8.0 + half) / grid.n[0], (14.0 + half) / grid.n[0]
    X = np.stack([rng.uniform(lo, hi, N), rng.uniform(lo, hi, N),
                  rng.uniform(0, 1, N)], axis=1).astype(np.float32)
    Q = suggest_chunks(grid, X, kernel=delta, tile=8, chunk=128, slack=1.3)
    eng = ci.PackedKernelInteraction(grid, kernel=delta, chunk=128,
                                     nchunks=Q, device=DEVICE)
    b = eng.buckets(torch.tensor(X, device=DEVICE))
    live = (b.wb != 0).any(1)
    tiles = b.tile_of_chunk[live].unique()
    F = torch.tensor(rng.standard_normal(N), dtype=torch.float32,
                     device=DEVICE)
    coef = (bucketed_channel(b, F) * b.wb / grid.cell_volume).contiguous()
    err, scale, bitwise = _compare(
        lambda: ci.packed_spread(eng.geom, grid, offs, b.tile_of_chunk,
                                 b.Xb, coef, delta, eng.table),
        lambda: ci.packed_spread_plain(eng.geom, grid, offs,
                                       b.tile_of_chunk, b.Xb, coef, delta))
    tol = TOL_DELTA.get(delta, TOL_KERNEL)
    log(f"[kernels] packed_spread hot tile at {delta}: {N} markers in tiles "
        f"{tiles.tolist()}, {int(live.sum())} live chunks of Q={Q}, "
        f"overflow={b.any_overflow}: max|kernel-plain|={err:.3e} (tol "
        f"{tol:g}*max|plain| = {tol * scale:.3e}) bitwise "
        f"run-to-run={bitwise}")
    if tiles.numel() != 1 or int(live.sum()) * 4 <= 1024 or b.any_overflow:
        raise AssertionError("the hot-tile case is not one tile of more "
                             "chunks than the kernel's table")
    if not (err <= tol * scale and bitwise):
        raise AssertionError("packed_spread disagrees with its plain "
                             "version on the hot tile or is not "
                             "run-to-run bitwise")


def _to(s, dev):
    """A state's tensors (nested named tuples) on ``dev``."""
    if isinstance(s, torch.Tensor):
        return s.to(dev)
    if isinstance(s, tuple):
        vals = [_to(v, dev) for v in s]
        return type(s)(*vals) if hasattr(s, "_fields") else tuple(vals)
    return s


# the kernels each engine launches (the packed, mxu and packed3 engines
# are the reference's XLA engines in torch ops: none; the hybrid engines
# interpolate with the packed one)
ENGINE_KERNELS = {"pallas_packed": ("packed_spread", "packed_interp"),
                  "pallas": ("tile_spread", "tile_interp"),
                  "hybrid_bf16": ("packed_spread",),
                  "hybrid_packed": ("packed_spread",),
                  "packed": (), "mxu": (), "mxu_bf16": (), "packed3": (),
                  "packed3_bf16": ()}


def phase_parity() -> None:
    """3 midpoint steps of the 32^3 shell: GPU (kernels) vs CPU (plain),
    on each engine, then the overflow fallbacks on the card."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    for engine, kernels in ENGINE_KERNELS.items():
        kw = dict(n_cells=32, n_lat=16, n_lon=16,
                  use_fast_interaction=engine, dtype=torch.float32)
        gpu, _ = build_shell_example(device=DEVICE, **kw)
        cpu, cs = build_shell_example(device="cpu", **kw)
        gs = _to(cs, DEVICE)
        before = dict(ci.LAUNCHES)
        for _ in range(3):
            gs, _ = gpu.step_with_stats(gs, 1e-3)
            cs, _ = cpu.step_with_stats(cs, 1e-3)
        torch.cuda.synchronize()
        ran = {k: ci.LAUNCHES[k] - before[k] for k in before}
        gX, cX = gs.X.cpu(), cs.X
        ex = float((gX - cX).abs().max() / cX.abs().max())
        eu = max(float((a.cpu() - b).abs().max() / b.abs().max())
                 for a, b in zip(gs.ins.u, cs.ins.u))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (gs.X, *gs.ins.u, gs.ins.p))
        log(f"[parity] {engine}: 32^3 shell 16x16, 3 midpoint steps "
            f"dt=1e-3, f32: max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol "
            f"{TOL_PARITY_X:g}) max_d |u_gpu-u_cpu|/max|u|={eu:.3e} (tol "
            f"{TOL_PARITY_U:g}) finite={finite} kernel launches={ran}")
        if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U and finite):
            raise AssertionError(f"GPU and CPU steps disagree on {engine}")
        if ran != {k: (ran[k] if k in kernels else 0) for k in ran} \
                or not all(ran[k] for k in kernels):
            raise AssertionError(f"the GPU step on {engine} did not launch "
                                 f"its kernels {kernels} alone")
    check_overflow()


def check_overflow() -> None:
    """Markers beyond the layout's capacity take the scatter fallback on
    the GPU (deterministic accumulation): for each kernel engine and the
    f32 torch-op engines (whose bf16 twins share the fallback) a buffered
    and an exceeded overflow, each twice (bitwise equal) and against the
    CPU scatter oracle."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.ops import interaction
    from ibamr_tpu_torch.ops.cuda_interaction import (PackedKernelInteraction,
                                                      TileKernelInteraction)
    from ibamr_tpu_torch.ops.interaction_fast import FastInteraction
    from ibamr_tpu_torch.ops.interaction_packed3 import PackedInteraction3

    grid = StaggeredGrid(n=(32,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.uniform(0, 1, (1500, 3)), dtype=torch.float32)
    F = torch.tensor(rng.standard_normal((1500, 3)), dtype=torch.float32)
    u = tuple(torch.tensor(rng.standard_normal(grid.n), dtype=torch.float32)
              for _ in range(3))
    f_ref = interaction.spread_vel(F, grid, X)
    U_ref = interaction.interpolate_vel(u, grid, X)
    Xd, Fd, ud = X.to(DEVICE), F.to(DEVICE), tuple(c.to(DEVICE) for c in u)
    engines = {
        "pallas_packed": lambda ocap: PackedKernelInteraction(
            grid, chunk=128, nchunks=4, overflow_cap=ocap, device=DEVICE),
        "pallas": lambda ocap: TileKernelInteraction(
            grid, cap=32, overflow_cap=ocap, device=DEVICE),
        "mxu": lambda ocap: FastInteraction(
            grid, cap=32, overflow_cap=ocap, device=DEVICE),
        "packed3": lambda ocap: PackedInteraction3(
            grid, tile_last=16, chunk=64, nchunks=4, overflow_cap=ocap,
            device=DEVICE)}
    for engine, make in engines.items():
        for ocap in (None, 64):
            eng = make(ocap)
            b = eng.buckets(Xd)
            f1, f2 = (eng.spread_vel(Fd, Xd, b=b) for _ in range(2))
            U1, U2 = (eng.interpolate_vel(ud, Xd, b=b) for _ in range(2))
            bitwise = (all(torch.equal(p, q) for p, q in zip(f1, f2))
                       and torch.equal(U1, U2))
            ef = max(float((a.cpu() - r).abs().max() / r.abs().max())
                     for a, r in zip(f1, f_ref))
            eU = float((U1.cpu() - U_ref).abs().max() / U_ref.abs().max())
            log(f"[parity] {engine} overflow (cap {b.o_idx.numel()}, "
                f"exceeded={b.exceeded}): spread vs CPU oracle {ef:.3e}, "
                f"interp {eU:.3e} (tol {TOL_KERNEL:g}), bitwise "
                f"run-to-run={bitwise}")
            if not (b.any_overflow and b.exceeded == (ocap is not None)):
                raise AssertionError("the overflow case did not overflow")
            if not (bitwise and ef <= TOL_KERNEL and eU <= TOL_KERNEL):
                raise AssertionError("the GPU overflow fallback is wrong "
                                     "or not run-to-run deterministic")


def phase_path(warmup: int, steps: int):
    """The flagship step on the packed-kernel engine; returns the launch
    counts of exactly this run, ms per step, the integrator and the state
    it reached."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    t0 = time.perf_counter()
    integ, state = build_shell_example(use_fast_interaction="pallas_packed",
                                       dtype=torch.float32, device=DEVICE,
                                       **FLAGSHIP)
    torch.cuda.synchronize()
    log(f"[path] built flagship in {time.perf_counter() - t0:.2f} s: "
        f"grid {integ.ins.grid.n}, {state.X.shape[0]} markers, "
        f"engine {integ.ib.engine_name}, Q={integ.ib.fast.nchunks}")
    X0 = state.X.clone()
    # the packed kernels write and read the grid themselves: count any
    # tile extraction or overlap-add
    folds, restore = _fold_counter()
    ci.reset_launch_counts()
    hits = []
    try:
        for _ in range(warmup):
            state, st = integ.step_with_stats(state, DT_FLAGSHIP)
            hits.append(st["refresh_hit"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, st = integ.step_with_stats(state, DT_FLAGSHIP)
            hits.append(st["refresh_hit"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = dict(ci.LAUNCHES)
    total = warmup + steps
    div = float(integ.ins.max_divergence(state.ins))
    umax = max(float(c.abs().max()) for c in state.ins.u)
    rel_div = div * integ.ins.grid.dx[0] / max(umax, 1e-30)
    disp = float((state.X - X0).abs().max())
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.X, *state.ins.u, state.ins.p))
    log(f"[path] {torch.cuda.get_device_name(0)}: {steps} timed steps "
        f"after {warmup} warm-up: {steps / wall:.3f} steps/s, "
        f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronized)")
    log(f"[path] refresh hits {sum(bool(h) for h in hits)}/{len(hits)}; "
        f"max|div u|={div:.3e} (max|u|={umax:.3e}, "
        f"max|div u|*dx/max|u|={rel_div:.3e}); "
        f"max|X-X0|={disp:.3e}; finite={finite}")
    log(f"[path] kernel launches in {total} steps: {launches} "
        f"(per step: packed_spread 3 = one per velocity component, "
        f"packed_interp 6 = two interps x 3 components); tile extractions "
        f"{len(folds['_extract_tiles'])}, overlap-adds "
        f"{len(folds['_overlap_add'])}")
    if not finite:
        raise AssertionError("flagship state is not finite")
    if rel_div > 1e-4:
        raise AssertionError("flagship velocity is not divergence-free")
    if launches != {**dict.fromkeys(KERNELS, 0), "packed_spread": 3 * total,
                    "packed_interp": 6 * total}:
        raise AssertionError(f"unexpected kernel launch counts {launches}")
    if folds["_extract_tiles"] or folds["_overlap_add"]:
        raise AssertionError("the pallas_packed step extracted or folded "
                             "tiles")
    return launches, 1e3 * wall / steps, integ, state


def _finite_div(integ, state):
    """Whether the state is finite, and max|div u| * dx / max|u|."""
    div = float(integ.ins.max_divergence(state.ins))
    umax = max(float(c.abs().max()) for c in state.ins.u)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.X, *state.ins.u, state.ins.p))
    return finite, div * integ.ins.grid.dx[0] / max(umax, 1e-30)


def phase_hybrid(path_ms: float, breakdown: bool = False) -> dict:
    """The flagship on each hybrid engine: WARMUP steps, then STEPS timed;
    the launches of exactly those steps (``packed_spread``, 3 per step,
    and no other kernel), the refresh hits, then one step taken twice
    from the state reached, bitwise equal. Returns the summed launches."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.utils.tree import flatten_with_path

    total = dict.fromkeys(KERNELS, 0)
    for engine in HYBRID_ENGINES:
        t0 = time.perf_counter()
        integ, state = build_shell_example(use_fast_interaction=engine,
                                           dtype=torch.float32,
                                           device=DEVICE, **FLAGSHIP)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ci.reset_launch_counts()
        hits = []
        for _ in range(WARMUP):
            state, st = integ.step_with_stats(state, DT_FLAGSHIP)
            hits.append(st["refresh_hit"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, st = integ.step_with_stats(state, DT_FLAGSHIP)
            hits.append(st["refresh_hit"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ci.LAUNCHES)
        one, two = (integ.step(state, DT_FLAGSHIP) for _ in range(2))
        bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(one), flatten_with_path(two)))
        finite, rel_div = _finite_div(integ, state)
        ms = 1e3 * wall / STEPS
        log(f"[hybrid] {engine} on {torch.cuda.get_device_name(0)}: built "
            f"in {build_s:.2f} s (Q={integ.ib.fast.nchunks}, interp "
            f"compute dtype {integ.ib.fast.compute_dtype}); {STEPS} timed "
            f"steps after {WARMUP} warm-up: {1e3 / ms:.3f} steps/s, "
            f"{ms:.3f} ms/step (host clock, synchronized) vs pallas_packed "
            f"{1e3 / path_ms:.3f} steps/s (path phase, same call)")
        log(f"[hybrid] {engine}: refresh hits {sum(bool(h) for h in hits)}/"
            f"{len(hits)}; kernel launches in {WARMUP + STEPS} steps "
            f"{launches} (per step: packed_spread 3, no interp kernel); one "
            f"step twice from the same state bitwise={bitwise}; finite="
            f"{finite}, max|div u|*dx/max|u|={rel_div:.3e}")
        want = {**dict.fromkeys(KERNELS, 0),
                "packed_spread": 3 * (WARMUP + STEPS)}
        if launches != want:
            raise AssertionError(f"{engine}: unexpected kernel launch "
                                 f"counts {launches}")
        if not (finite and bitwise and rel_div <= 1e-4):
            raise AssertionError(f"{engine}: state not finite, not "
                                 "divergence-free or not run-to-run bitwise")
        total = {k: total[k] + launches[k] for k in total}
        if breakdown:
            phase_breakdown(integ, state, ms, engine)
        del integ, state, one, two
    return total


def _rel_dev(a, b) -> float:
    """max|a - b| / max|b| of two tensors on the card."""
    return float((a - b).abs().max() / b.abs().max())


def phase_engines(path=None, breakdown: bool = False) -> None:
    """The flagship on each torch-op engine of ``TORCH_OP_ENGINES`` beside
    ``pallas_packed``: one step from the state the path phase reached
    against ``pallas_packed``'s step from it, the displacement and u
    (f32 engines within TOL_DX_F32 of max|dX| and TOL_PARITY_U of max|u|;
    bf16 engines within TOL_BF16 of both), then
    ENGINE_WARMUP steps and ENGINE_STEPS timed; no hand kernel may
    launch; the warm steps/s
    and the peak device memory of each leg. ``path`` is the path phase's
    ``(integ, state, ms)``; without it the phase builds and warms its
    own ``pallas_packed`` flagship."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    if path is None:
        integ, state = build_shell_example(
            use_fast_interaction="pallas_packed", dtype=torch.float32,
            device=DEVICE, **FLAGSHIP)
        for _ in range(WARMUP):
            state = integ.step(state, DT_FLAGSHIP)
        path = (integ, state, float("nan"))
    ref_integ, state, path_ms = path
    ref = ref_integ.step(state, DT_FLAGSHIP)
    torch.cuda.synchronize()
    dX_ref = ref.X - state.X
    # the f32 bound: TOL_DX_F32 of the displacement, plus one f32 spacing
    # at max|X|, to which each step's X is rounded on storage
    dx_frac = float(dX_ref.abs().max() / state.X.abs().max())
    tol_dx_f32 = TOL_DX_F32 + torch.finfo(torch.float32).eps / dx_frac
    for engine in TORCH_OP_ENGINES:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ci.reset_launch_counts()
        t0 = time.perf_counter()
        integ, _ = build_shell_example(use_fast_interaction=engine,
                                       dtype=torch.float32, device=DEVICE,
                                       **FLAGSHIP)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        fast = integ.ib.fast
        layout = (f"{fast.nchunks} chunks of {fast.geom.cap}, tiles "
                  f"{fast.geom.tile}" if hasattr(fast, "nchunks") else
                  f"{int(np.prod(fast.geom.nblk))} tiles of cap "
                  f"{fast.geom.cap}")
        one = integ.step(state, DT_FLAGSHIP)
        ex = _rel_dev(one.X - state.X, dX_ref)
        tol_x, tol_u = ((TOL_BF16, TOL_BF16) if engine.endswith("_bf16")
                        else (tol_dx_f32, TOL_PARITY_U))
        eu = max(_rel_dev(a, b) for a, b in zip(one.ins.u, ref.ins.u))
        st = one
        for _ in range(ENGINE_WARMUP):
            st = integ.step(st, DT_FLAGSHIP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ENGINE_STEPS):
            st = integ.step(st, DT_FLAGSHIP)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ENGINE_STEPS
        launches = dict(ci.LAUNCHES)
        finite, rel_div = _finite_div(integ, st)
        peak = torch.cuda.max_memory_allocated()
        log(f"[engines] {engine} on {torch.cuda.get_device_name(0)}: built "
            f"in {build_s:.2f} s ({layout}, compute dtype "
            f"{fast.compute_dtype}); one step from the path state vs "
            f"pallas_packed's: displacement {ex:.3e} (tol {tol_x:.3e}; "
            f"max|dX|/max|X| {dx_frac:.3e}, where {TOL_PARITY_X:g} of max|X| "
            f"is {TOL_PARITY_X / dx_frac:.3e}), max_d u "
            f"{eu:.3e} (tol {tol_u:g})")
        log(f"[engines] {engine}: {ENGINE_STEPS} timed steps after "
            f"{ENGINE_WARMUP} warm-up:"
            f" {1e3 / ms:.3f} steps/s, {ms:.3f} ms/step (host clock, "
            f"synchronized) vs pallas_packed {1e3 / path_ms:.3f} steps/s "
            f"(path phase, same call); peak device memory "
            f"{peak / 2**30:.3f} GiB (the path state and step held: "
            f"{base / 2**30:.3f} GiB); kernel launches {launches}; finite="
            f"{finite}, max|div u|*dx/max|u|={rel_div:.3e}")
        if any(launches.values()):
            raise AssertionError(f"{engine} launched a hand kernel: "
                                 f"{launches}")
        if not (ex <= tol_x and eu <= tol_u):
            raise AssertionError(f"{engine}'s step disagrees with "
                                 "pallas_packed's")
        if not (finite and rel_div <= 1e-4):
            raise AssertionError(f"{engine}: state not finite or not "
                                 "divergence-free")
        if breakdown:
            phase_breakdown(integ, st, ms, engine)
        del integ, fast, one, st
    del ref, dX_ref


def _search_log(label, res) -> None:
    """Each trial of a search and its ranking, on the log."""
    for t in res.trials:
        log(f"[{label}] trial {t.candidate.label():28s} "
            f"{t.steps_per_s:10.3f} steps/s {t.ms_per_step:10.3f} ms/step "
            f"warm-up {t.compile_s:.3f} s error={t.error}")
    for c, reason in res.pruned:
        log(f"[{label}] pruned {c.label()}: {reason}")
    d = res.to_dict()
    log(f"[{label}] ranking: " + ", ".join(
        f"{t.candidate.label()} {t.steps_per_s:.3f}"
        for t in res.ranking()))
    log(f"[{label}] winner {d['winner'] and d['winner']['engine']}, "
        f"runner-up {d['runner_up'] and d['runner_up']['engine']}, margin "
        f"{d['margin']}")


def phase_tune() -> dict:
    """The autotuner on the card: ``search`` at the reference's default
    key over its default engine menu (kernel engines probed on the card
    first), f32 and bf16 transforms, chunk lengths 1 and 4. Fails if the
    probe prunes a candidate or a trial errs. Returns the phase's
    kernel launches (the pallas_packed probe and trials)."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.tune.runner import db_entry_from_search, search
    from ibamr_tpu_torch.tune.space import DEFAULT_ENGINES

    ci.reset_launch_counts()
    t0 = time.perf_counter()
    res = search(**TUNE_KEY, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = dict(ci.LAUNCHES)
    _search_log("tune", res)
    entry = db_entry_from_search(
        res, platform="cuda", timestamp=time.strftime("%Y-%m-%d"),
        device_kind=torch.cuda.get_device_name(0),
        torch_version=torch.__version__)
    log(f"[tune] search of {len(res.trials)} trials at {TUNE_KEY} over "
        f"{DEFAULT_ENGINES} in {wall:.1f} s; kernel launches {launches}; "
        f"the entry it would publish (not written): {json.dumps(entry)}")
    if res.pruned or any(t.error for t in res.trials):
        raise AssertionError("tune: a candidate was pruned or a trial "
                             "failed")
    if len(res.trials) != 32 or not launches["packed_spread"]:
        raise AssertionError("tune: the search did not time every "
                             "candidate on the card")
    return launches


def phase_shootout() -> dict:
    """The logged shoot-out: ``search`` at the flagship key (256^3, the
    316x316 shell) over every engine of the registry, f32 and bf16
    transforms, chunk lengths 1 and 4; the whole result logged as one
    JSON line. Fails if a trial errs. Returns the phase's kernel
    launches."""
    from ibamr_tpu_torch.models.engine_resolver import RESOLVED_ENGINES
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.tune.runner import search

    ci.reset_launch_counts()
    t0 = time.perf_counter()
    res = search(**FLAGSHIP, engines=RESOLVED_ENGINES, dt=DT_FLAGSHIP,
                 device=DEVICE)
    wall = time.perf_counter() - t0
    launches = dict(ci.LAUNCHES)
    _search_log("shootout", res)
    log(f"[shootout] result {json.dumps(res.to_dict())}")
    log(f"[shootout] {len(res.trials)} trials at {FLAGSHIP} in {wall:.1f} "
        f"s; kernel launches {launches}")
    if any(t.error for t in res.trials) or res.pruned:
        raise AssertionError("shootout: a candidate was pruned or a trial "
                             "failed")
    return launches


def _ecc(X: torch.Tensor) -> float:
    """Largest over smallest distance of the markers from their mean."""
    r = torch.linalg.norm(X - X.mean(0), dim=1)
    return float(r.max() / r.min())


def phase_ex0(breakdown: bool = False) -> dict:
    """The ex0 driver on the committed input2d as it is, on the card, in a
    temporary working directory; returns the kernel launches of the run
    (none: the 2D path runs no hand kernel). With ``breakdown``, the
    profile of the step at the state the run reached."""
    from ibamr_tpu_torch.examples import ib_explicit_ex0
    from ibamr_tpu_torch.integrators.ib import advance_ib, polygon_area
    from ibamr_tpu_torch.models.membrane2d import build_membrane_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager
    from ibamr_tpu_torch.utils.tree import flatten_with_path

    db = parse_input_file(os.path.join(ROOT, EX0_INPUT))
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")
    main = db.get_database("Main")
    steps, dt = ins_db.get_int("num_steps"), ins_db.get_float("dt")
    _, s0 = build_membrane_example(input_db=db, device=DEVICE)
    area0, ecc0 = float(polygon_area(s0.X)), _ecc(s0.X)
    timer = TimerManager.instance()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            timer.reset()
            ci.reset_launch_counts()
            t0 = time.perf_counter()
            state = ib_explicit_ex0.run(db, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ci.LAUNCHES)
            run_s = timer.get("IB::advanceHierarchy").total
            with open(main.get_string("log_file")) as fh:
                records = [json.loads(ln) for ln in fh]
            rst = main.get_string("restart_dirname")
            ckpts = sorted(os.listdir(rst))
            viz = [f for f in os.listdir(main.get_string("viz_dirname"))
                   if f.endswith(".csv")]
            timer.reset()
            again = ib_explicit_ex0.run(db, device=DEVICE,
                                        restart=(rst, EX0_RESTART))
            torch.cuda.synchronize()
            warm_s = timer.get("IB::advanceHierarchy").total
        finally:
            os.chdir(cwd)
    restart_bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_path(again), flatten_with_path(state)))
    finite = all(isinstance(v, (int, float)) and math.isfinite(v)
                 for r in records for v in r.values())
    area1, ecc1 = records[-1]["area"], _ecc(state.X)
    drift = abs(area1 - area0) / area0
    # the first steps on the card against the CPU, from the same build
    gi, gs = build_membrane_example(input_db=db, device=DEVICE)
    ci_, cs = build_membrane_example(input_db=db, device="cpu")
    gs = advance_ib(gi, gs, dt, EX0_PARITY_STEPS)
    cs = advance_ib(ci_, cs, dt, EX0_PARITY_STEPS)
    ex = float((gs.X.cpu() - cs.X).abs().max() / cs.X.abs().max())
    eu = max(float((a.cpu() - b).abs().max() / b.abs().max())
             for a, b in zip(gs.ins.u, cs.ins.u))
    warm = steps - EX0_RESTART
    log(f"[ex0] {EX0_INPUT} on {torch.cuda.get_device_name(0)}: grid "
        f"{s0.ins.u[0].shape}, {s0.X.shape[0]} markers, {steps} steps of "
        f"dt={dt:g}, f32: {steps / run_s:.3f} steps/s over the run (first "
        f"chunk's set-up included), restarted leg of {warm} steps "
        f"{warm / warm_s:.3f} steps/s, {1e3 * warm_s / warm:.3f} ms/step "
        f"(warm chunks: host clock around each chunk and its synchronize); "
        f"whole run {wall:.2f} s with build, metrics, viz and checkpoints")
    for r in records:
        log(f"[ex0] metrics {json.dumps(r)}")
    log(f"[ex0] area {area0:.9g} -> {area1:.9g}: |drift|/area0={drift:.3e} "
        f"(bound {EX0_AREA_DRIFT}); eccentricity max r/min r {ecc0:.6f} -> "
        f"{ecc1:.6f}; marker CSVs {len(viz)}, restart files {ckpts}; restart "
        f"from step {EX0_RESTART} bitwise={restart_bitwise}; kernel "
        f"launches {launches}")
    log(f"[ex0] first {EX0_PARITY_STEPS} steps GPU vs CPU: "
        f"max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol {TOL_PARITY_X:g}) max_d "
        f"|u_gpu-u_cpu|/max|u|={eu:.3e} (tol {TOL_PARITY_U:g})")
    if not (finite and len(records) * main.get_int("viz_dump_interval")
            == steps and int(state.ins.k) == steps):
        raise AssertionError("ex0: metrics not finite or the run incomplete")
    if not (drift < EX0_AREA_DRIFT and ecc1 < ecc0):
        raise AssertionError("ex0: area not conserved or the ellipse did "
                             "not relax")
    if not restart_bitwise:
        raise AssertionError("ex0: the restarted run does not reach the "
                             "straight run's state bitwise")
    if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U):
        raise AssertionError("ex0: GPU and CPU steps disagree")
    if any(launches.values()):
        raise AssertionError(f"ex0: unexpected kernel launches {launches}")
    if breakdown:
        phase_breakdown(gi, state, 1e3 * warm_s / warm, "ex0", dt)
    return launches


def _in_tmp(fn):
    """``fn()`` in a temporary working directory (the drivers' output
    paths are relative); returns ``(fn(), {file name: text})`` of the
    JSONL logs and the names of everything written."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            out = fn()
            torch.cuda.synchronize()
            files = {}
            for root, _, names in os.walk("."):
                for name in names:
                    path = os.path.join(root, name)
                    files[os.path.relpath(path)] = (
                        open(path).read() if name.endswith(".jsonl")
                        else None)
        finally:
            os.chdir(cwd)
    return out, files


def _records(files, name):
    return [json.loads(ln) for ln in files[name].splitlines()]


def _rel(a, b) -> float:
    """max|a - b| / max|b| with ``a`` on the card and ``b`` on the CPU."""
    return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_walls(breakdown: bool = False) -> None:
    """The cavity driver on the committed input as it is, on the card, in
    a temporary working directory; the Ghia bounds, the divergence, the
    first steps against the CPU and the warm steps/s."""
    from ibamr_tpu_torch.examples import navier_stokes_cavity2d as cav
    from ibamr_tpu_torch.integrators.ins import advance
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    db = parse_input_file(os.path.join(ROOT, CAVITY_INPUT))
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    steps, dt = idb.get_int("num_steps"), idb.get_float("dt")
    timer = TimerManager.instance()
    timer.reset()
    state, files = _in_tmp(lambda: cav.run(db, device=DEVICE))
    run_s = timer.get("advance").total
    records = _records(files, db.get_database("Main").get_string(
        "log_jsonl"))
    integ, _ = cav.build(db, DEVICE)
    n = integ.grid.n
    # the graphed steps equal the eager loop of integ.step bitwise (and the
    # graph is captured before the warm timing)
    a = state
    for _ in range(5):
        a = integ.step(a, dt)
    b = advance(integ, state, dt, 5)
    graphed_bitwise = all(torch.equal(x, y)
                          for x, y in zip(a.u + (a.p,), b.u + (b.p,)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    advance(integ, state, dt, WARM_STEPS)
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0) / WARM_STEPS
    uc = np.asarray(records[-1]["centerline_u"])
    yc = (np.arange(n[1]) + 0.5) / n[1]
    ghia = float(np.max(np.abs(np.interp(GHIA_Y, yc, uc) - GHIA_U)))
    umin = float(uc.min())
    divs = [r["max_div"] for r in records if "max_div" in r]
    finite = all(bool(torch.isfinite(c).all()) for c in (*state.u, state.p))
    # the first steps on the card against the CPU, from the same build
    gi, gs = cav.build(db, DEVICE)
    ci_, cs = cav.build(db, "cpu")
    gs = advance(gi, gs, dt, WALLS_PARITY_STEPS)
    cs = advance(ci_, cs, dt, WALLS_PARITY_STEPS)
    eu = max(_rel(a, b) for a, b in zip(gs.u, cs.u))
    ep = _rel(gs.p, cs.p)
    log(f"[walls] {CAVITY_INPUT} on {torch.cuda.get_device_name(0)}: grid "
        f"{n}, PPM, lid U=1, {steps} steps of dt={dt:g} to t="
        f"{float(state.t):.4f}, f32: {steps / run_s:.3f} steps/s over the "
        f"run (metrics every {records[0]['step']} steps included), warm "
        f"{1e3 / warm_ms:.3f} steps/s, {warm_ms:.3f} ms/step ({WARM_STEPS} "
        f"steps from the end state, host clock and a synchronize; the step "
        f"replayed as a CUDA graph, 5 steps bitwise equal to eager: "
        f"{graphed_bitwise})")
    log(f"[walls] Ghia Re=100 centerline max|u - u_Ghia|={ghia:.4e} (bound "
        f"{GHIA_PROFILE_TOL}); u_min={umin:.5f}, |u_min + 0.21090|="
        f"{abs(umin + 0.21090):.4e} (bound {GHIA_UMIN_TOL}); max|div u| "
        f"per record {['%.3e' % v for v in divs]} (bound "
        f"{CAVITY_DIV_BOUND:g}); finite={finite}")
    log(f"[walls] first {WALLS_PARITY_STEPS} steps GPU vs CPU: max_d "
        f"|u_gpu-u_cpu|/max|u|={eu:.3e}, |p_gpu-p_cpu|/max|p|={ep:.3e} "
        f"(tol {TOL_PARITY_U:g})")
    if not (finite and len(records) == steps // records[0]["step"] + 1):
        raise AssertionError("walls: state not finite or run incomplete")
    if not (ghia < GHIA_PROFILE_TOL and abs(umin + 0.21090) < GHIA_UMIN_TOL):
        raise AssertionError("walls: the cavity misses the Ghia bounds")
    if not max(divs) < CAVITY_DIV_BOUND:
        raise AssertionError("walls: the velocity is not divergence-free")
    if not (eu <= TOL_PARITY_U and ep <= TOL_PARITY_U and graphed_bitwise):
        raise AssertionError("walls: GPU and CPU steps (or graphed and "
                             "eager ones) disagree")
    if breakdown:
        ins = integ
        u, p = state.u, state.p
        rhs = tuple(c / dt for c in u)
        ustar = ins.helmholtz_vel_solve(rhs, integ.grid.dx, 1.0 / dt,
                                        -0.5 * ins.mu)
        _, phi = ins.project(ustar, integ.grid.dx)
        stages = [
            ("convection", lambda: ins._convective(u, integ.grid.dx)),
            ("laplacian+grad", lambda: (ins.laplacian_vel(u, integ.grid.dx),
                                        ins.pressure_gradient(
                                            p, integ.grid.dx))),
            ("helmholtz", lambda: ins.helmholtz_vel_solve(
                rhs, integ.grid.dx, 1.0 / dt, -0.5 * ins.mu)),
            ("project", lambda: ins.project(ustar, integ.grid.dx)),
            ("p update", lambda: ins.laplacian_cc(phi, integ.grid.dx)),
        ]
        _stage_breakdown("walls", stages,
                         lambda: advance(integ, state, dt, 3), 3, warm_ms)


def phase_adv(breakdown: bool = False) -> None:
    """The IB + advection-diffusion driver on the committed input as it
    is, on the card, in a temporary working directory: the scalar's total
    against the time integral of the markers' sources, the area, the
    divergence, the first steps against the CPU and the warm steps/s."""
    from ibamr_tpu_torch.examples import adv_diff_ex0
    from ibamr_tpu_torch.integrators.ib import polygon_area
    from ibamr_tpu_torch.ops import interaction
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    db = parse_input_file(os.path.join(ROOT, ADV_INPUT))
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    steps, dt = idb.get_int("num_steps"), idb.get_float("dt")
    strength = db.get_database(
        "AdvDiffSemiImplicitHierarchyIntegrator").get_float(
        "source_strength")
    timer = TimerManager.instance()
    timer.reset()
    (state, ad), files = _in_tmp(lambda: adv_diff_ex0.run(db, device=DEVICE))
    run_s = timer.get("IBAdvDiff::advanceHierarchy").total
    records = _records(files, db.get_database("Main").get_string(
        "log_file"))
    coupled, s0, _ = adv_diff_ex0.build(db, DEVICE)
    area0 = float(polygon_area(s0.X))
    n_mk = s0.X.shape[0]
    warm, _ = _warm_steps_per_s(lambda st: coupled.step(*st, dt),
                                (state, ad), ADV_WARM)
    last = records[-1]
    src_total = n_mk * strength * last["t"]
    total_err = abs(last["scalar_total"] - src_total) / src_total
    drift = abs(last["area"] - area0) / area0
    divs = [r["max_div"] for r in records]
    finite = all(isinstance(v, (int, float)) and math.isfinite(v)
                 for r in records for v in r.values())
    # the first steps on the card against the CPU, from the same build
    cpu, cs, ca = adv_diff_ex0.build(db, "cpu")
    gs, ga = s0, coupled.adv.initialize()
    for _ in range(ADV_PARITY_STEPS):
        gs, ga = coupled.step(gs, ga, dt)
        cs, ca = cpu.step(cs, ca, dt)
    ex = _rel(gs.X, cs.X)
    eu = max(float((a.cpu() - b).abs().max()) for a, b in
             zip(gs.ins.u, cs.ins.u)) / max(float(b.abs().max())
                                             for b in cs.ins.u)
    eq = _rel(ga.Q[0], ca.Q[0])
    log(f"[adv] {ADV_INPUT} on {torch.cuda.get_device_name(0)}: grid "
        f"{tuple(s0.ins.u[0].shape)}, {n_mk} markers, {steps} steps of "
        f"dt={dt:g}, f32, upwind scalar: {steps / run_s:.3f} steps/s over "
        f"the run (first chunk's set-up included), warm {warm:.3f} steps/s "
        f"({ADV_WARM} steps from the end state, host clock and a "
        f"synchronize)")
    for r in records:
        log(f"[adv] metrics {json.dumps(r)}")
    log(f"[adv] scalar total {last['scalar_total']:.9g} against the "
        f"sources' integral {src_total:.9g}: {total_err:.3e} (bound "
        f"{ADV_TOTAL_TOL:g}); area {area0:.9g} -> {last['area']:.9g}, "
        f"drift {drift:.3e} (bound {EX0_AREA_DRIFT}); max|div u| per "
        f"record {['%.3e' % v for v in divs]} (bound {ADV_DIV_BOUND:g})")
    log(f"[adv] first {ADV_PARITY_STEPS} steps GPU vs CPU: max|X_gpu-X_cpu|"
        f"/max|X|={ex:.3e} (tol {TOL_PARITY_X:g}), max_d|u_gpu-u_cpu|/"
        f"max|u|={eu:.3e} (tol {TOL_PARITY_U:g}), max|Q_gpu-Q_cpu|/max|Q|"
        f"={eq:.3e} (tol {TOL_PARITY_Q:g})")
    if not (finite and len(records) * db.get_database("Main").get_int(
            "viz_dump_interval") == steps and int(ad.k) == steps):
        raise AssertionError("adv: metrics not finite or the run incomplete")
    if not (total_err <= ADV_TOTAL_TOL and drift < EX0_AREA_DRIFT
            and max(divs) < ADV_DIV_BOUND):
        raise AssertionError("adv: scalar not conserved, area drifted or "
                             "the velocity not divergence-free")
    if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U
            and eq <= TOL_PARITY_Q):
        raise AssertionError("adv: GPU and CPU steps disagree")
    if breakdown:
        integ, adv = coupled.integ, coupled.adv
        grid = integ.ins.grid
        src = interaction.spread(
            torch.full((n_mk,), strength, device=DEVICE), grid, state.X,
            centering="cell", kernel=integ.ib.kernel, weights=state.mask)

        def steps3():
            st = (state, ad)
            for _ in range(3):
                st = coupled.step(*st, dt)

        stages = [
            ("ib step", lambda: integ.step(state, dt)),
            ("source spread", lambda: interaction.spread(
                torch.full((n_mk,), strength, device=DEVICE), grid, state.X,
                centering="cell", kernel=integ.ib.kernel,
                weights=state.mask)),
            ("scalar step", lambda: adv.step(ad, dt, u=state.ins.u,
                                             sources=[src])),
        ]
        _stage_breakdown("adv", stages, steps3, 3, 1e3 / warm)


def _amr_driver_leg(label, mod, path, steps, cpu_steps, drift_key, its):
    """One AMR driver on its committed input cut to ``steps``, on the
    card, then its first ``cpu_steps`` on the card and on the CPU from
    fresh builds: returns (integ, state, records, run s, warm steps/s,
    restarts of the run, the parity errors, the CPU leg's origins)."""
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    db = parse_input_file(os.path.join(ROOT, path))
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    idb.put("num_steps", steps)
    dt = idb.get_float("dt")
    log_file = db.get_database("Main").get_string("log_file")
    timer = TimerManager.instance()
    timer.reset()
    del its[:]
    (integ, state), files = _in_tmp(lambda: mod.run(db, device=DEVICE))
    run_s = timer.get("IB::advanceHierarchy").total
    run_its = list(its)
    records = _records(files, log_file)
    warm, _ = _warm_steps_per_s(lambda s: integ.step(s, dt), state,
                                AMR_WARM)
    idb.put("num_steps", cpu_steps)
    (gi, gs), gfiles = _in_tmp(lambda: mod.run(db, device=DEVICE))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            ci_, cs = mod.run(db, device="cpu")
            crec = [json.loads(ln) for ln in open(log_file)]
        finally:
            os.chdir(cwd)
    grec = _records(gfiles, log_file)
    ex = _rel(gs.X, cs.X)
    scale = max(float(c.abs().max()) for c in cs.fluid.uf)
    eu = max(float((a.cpu() - b).abs().max()) for a, b in
             zip(gs.fluid.uf + gs.fluid.uc, cs.fluid.uf + cs.fluid.uc)) / scale
    origins = ([r["window_lo"] for r in grec], [r["window_lo"] for r in crec])
    return dict(integ=integ, state=state, records=records, run_s=run_s,
                warm=warm, its=run_its, ex=ex, eu=eu, origins=origins,
                full_origins=[r["window_lo"] for r in records[:len(crec)]],
                boxes=(gi.box, ci_.box), db=db, drift_key=drift_key,
                label=label)


def _dynamic_leg(device):
    """The moving-window advance of ``DYN`` on ``device`` in f32; returns
    (the origin after each regrid chunk, the final state, total drift,
    steps/s of the advance)."""
    from ibamr_tpu_torch.amr_dynamic import DynamicTwoLevelAdvDiff
    from ibamr_tpu_torch.grid import StaggeredGrid

    n = DYN["n"]
    grid = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    sim = DynamicTwoLevelAdvDiff(
        grid, (DYN["box"],) * 2, kappa=DYN["kappa"], scheme="upwind",
        u_fn=lambda c, d: torch.full_like(c[0], DYN["u0"] if d == 0
                                          else 0.0),
        tag_threshold=DYN["threshold"], dtype=torch.float32, device=device)
    state = sim.initialize(lambda c: torch.exp(
        -((c[0] - 0.3) ** 2 + (c[1] - 0.5) ** 2) / 0.07 ** 2))
    t0_total = float(sim.total(state))
    dt = 0.25 * grid.dx[0] / DYN["u0"] / 2
    los = [state.lo.tolist()]
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DYN["steps"] // DYN["regrid"]):
        state = sim.advance(state, dt, DYN["regrid"],
                            regrid_interval=DYN["regrid"])
        los.append(state.lo.tolist())
    if device != "cpu":
        torch.cuda.synchronize()
    rate = DYN["steps"] / (time.perf_counter() - t0)
    drift = abs(float(sim.total(state)) - t0_total) / abs(t0_total)
    return los, state, drift, rate, t0_total


def phase_amr(breakdown: bool = False) -> None:
    """The two AMR drivers on their committed inputs cut in steps, on the
    card (ex0_amr: ``EX0_AMR_STEPS`` of the 2D membrane's 400 in a
    stream, a regrid every 20; ex4_amr: ``EX4_AMR_STEPS`` of the 3D
    shell's 120, every 10), each with
    its first steps on the CPU; then the moving-window scalar advance of
    ``DYN`` on both. FGMRES restarts per projection, the window origins,
    the divergence under the solver tolerance, the area or volume drift,
    the scalar's composite total, and the warm steps/s."""
    from ibamr_tpu_torch import amr_ins
    from ibamr_tpu_torch.examples import (ib_explicit_ex0_amr,
                                          ib_explicit_ex4_amr)

    its = []
    project = _count_projections(amr_ins.CompositeProjection, its)
    try:
        legs = [_amr_driver_leg("ex0_amr", ib_explicit_ex0_amr,
                                EX0_AMR_INPUT, EX0_AMR_STEPS,
                                EX0_AMR_CPU_STEPS, "area_drift", its),
                _amr_driver_leg("ex4_amr", ib_explicit_ex4_amr,
                                EX4_AMR_INPUT, EX4_AMR_STEPS,
                                EX4_AMR_CPU_STEPS, "volume_drift", its)]
    finally:
        amr_ins.CompositeProjection.project = project
    ok = True
    for leg in legs:
        r, integ = leg["records"], leg["integ"]
        idb = leg["db"].get_database("INSStaggeredHierarchyIntegrator")
        steps = r[-1]["step"]
        proj = integ.core.proj
        speed = max(float(c.abs().max()) for c in leg["state"].fluid.uf)
        div_bound = proj.tol * speed / min(integ.core.dx_f)
        divs = [x["max_div"] for x in r]
        drifts = [abs(x[leg["drift_key"]]) for x in r]
        drift_bound = EX0_AREA_DRIFT if leg["drift_key"] == "area_drift" \
            else AMR_VOLUME_DRIFT
        moves = sum(a["window_lo"] != b["window_lo"]
                    for a, b in zip(r[:-1], r[1:]))
        finite = all(math.isfinite(v) for x in r for k, v in x.items()
                     if k != "window_lo")
        log(f"[amr] {leg['label']} on {torch.cuda.get_device_name(0)}: "
            f"coarse {integ.grid.n}, window {integ.box.shape} x2, "
            f"{leg['state'].X.shape[0]} markers, {steps} steps of dt="
            f"{idb.get_float('dt'):g}, f32: {steps / leg['run_s']:.3f} "
            f"steps/s over the run (regrids, metrics and viz included), "
            f"warm {leg['warm']:.3f} steps/s ({AMR_WARM} steps at the last "
            f"window, host clock and a synchronize); FGMRES restarts per "
            f"projection mean {np.mean(leg['its']):.3f} max "
            f"{max(leg['its'])} over {len(leg['its'])} projections "
            f"({steps} steps and the moved regrids)")
        log(f"[amr] {leg['label']} window origins per chunk "
            f"{[x['window_lo'] for x in r]} ({moves} moves); max|div u| "
            f"max {max(divs):.3e} (bound tol*max|u|/dx_f = "
            f"{div_bound:.3e}); |{leg['drift_key']}| max {max(drifts):.3e} "
            f"(bound {drift_bound})")
        log(f"[amr] {leg['label']} first {idb.get_int('num_steps')} "
            f"steps GPU vs CPU: origins {leg['origins'][0]} / "
            f"{leg['origins'][1]}, full run's {leg['full_origins']}; "
            f"max|X_gpu-X_cpu|/max|X|={leg['ex']:.3e} (tol "
            f"{TOL_PARITY_X:g}), max|u_gpu-u_cpu|/max|u|={leg['eu']:.3e} "
            f"(tol {TOL_PARITY_U:g})")
        ok &= (finite and max(divs) < div_bound
               and max(drifts) < drift_bound
               and leg["origins"][0] == leg["origins"][1]
               == leg["full_origins"]
               and leg["boxes"][0] == leg["boxes"][1]
               and leg["ex"] <= TOL_PARITY_X and leg["eu"] <= TOL_PARITY_U
               and int(leg["state"].fluid.k) == steps)
    glos, gst, gdrift, grate, total0 = _dynamic_leg(DEVICE)
    clos, cst, cdrift, crate, _ = _dynamic_leg("cpu")
    eq = _rel(gst.Qf, cst.Qf)
    log(f"[amr] DynamicTwoLevelAdvDiff {DYN['n']}^2, window "
        f"{DYN['box']}^2, {DYN['steps']} steps, regrid every "
        f"{DYN['regrid']}, f32: GPU {grate:.3f} steps/s, CPU {crate:.3f} "
        f"(regrids included); origins GPU {glos} CPU {clos}; composite "
        f"total {total0:.9g}, drift GPU {gdrift:.3e} CPU {cdrift:.3e} "
        f"(bound {DYN_TOTAL_TOL:g}); fine field GPU vs CPU {eq:.3e} (tol "
        f"{TOL_PARITY_Q:g})")
    ok &= (glos == clos and glos[-1][0] > glos[0][0]
           and gdrift <= DYN_TOTAL_TOL and eq <= TOL_PARITY_Q)
    bitwise = _graphed_projection_bitwise(legs[0])
    log(f"[amr] ex0_amr projection at the end state, operator and "
        f"preconditioner replayed as CUDA graphs, bitwise equal to the "
        f"eager flat operators with equal restarts: {bitwise}")
    ok &= bitwise
    if not ok:
        raise AssertionError("amr: a check failed (see the [amr] lines)")
    if breakdown:
        _amr_breakdown(legs[0])


# -- the L-level hierarchy (mlamr) --------------------------------------------

def _count_projections(cls, its):
    """Wrap ``cls.project`` to append each projection's restart count to
    ``its``; returns the original to restore."""
    project = cls.project

    def counted(self, *a, **k):
        out = project(self, *a, **k)
        its.append(self.last_solve_stats["iters"])
        return out

    cls.project = counted
    return project


def _ml_shell(device, fac: bool):
    """The ex4_amr shell (its committed input as it is: 64^3, 576 markers,
    a 0.4 stream, IB_4, f32) on a three-level ``MultiLevelIBINS``: each
    window sized by ``box_from_markers`` with the input's ``tag_buffer``
    at its level (level 1 is ex4_amr's own window) and placed by
    ``regrid_multilevel_ib``'s rule; the stream seeded on every level."""
    from ibamr_tpu_torch.amr_ins import box_from_markers
    from ibamr_tpu_torch.amr_ins_multilevel import MultiLevelIBINS
    from ibamr_tpu_torch.examples import ib_explicit_ex4_amr
    from ibamr_tpu_torch.solvers.fac import FACMultilevelPoisson
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    db = parse_input_file(os.path.join(ROOT, EX4_AMR_INPUT))
    pad = db.get_database("GriddingAlgorithm").get_int("tag_buffer")
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    u0 = db.get_database("Stream").get_float("u0")
    two, st2, _ = ib_explicit_ex4_amr.build(db, device)
    grid, X = two.grid, st2.X
    b1 = two.box
    b2 = box_from_markers(b1.fine_grid(grid), X.cpu().numpy(), pad=pad)
    factory = (lambda lv: FACMultilevelPoisson(
        lv, dtype=torch.float32, device=device).precondition) if fac \
        else None
    ml = MultiLevelIBINS(grid, [b1, b2], two.ib,
                         rho=idb.get_float("rho", 1.0), mu=idb.get_float("mu"),
                         proj_tol=two.core.proj.tol, precond_factory=factory,
                         device=device)
    state = ml.initialize(X, vel_fn=lambda d, mesh: (u0 if d == 0 else 0.0)
                          + 0.0 * mesh[0])
    dt = min(idb.get_float("dt"), float(ml.core.stable_dt(state.fluid,
                                                          cfl=0.5)))
    return ml, state, dt


def _ml_run(device, fac: bool, steps: int, regrid: int):
    """``_ml_shell`` advanced ``steps`` steps with a regrid every
    ``regrid``: (integ, state, dt, seconds, restarts per projection, the
    box chain after each chunk)."""
    from ibamr_tpu_torch import amr_ins_multilevel as aml

    its = []
    ml, state, dt = _ml_shell(device, fac)
    chain = [tuple(spec.box.lo for spec in ml.levels[1:])]
    orig = _count_projections(aml.MultiLevelCompositeProjection, its)
    try:
        _sync(device)
        t0 = time.perf_counter()
        ml, state = aml.advance_multilevel_ib_regridding(
            ml, state, dt, steps, regrid_interval=regrid,
            on_chunk=lambda i, s, done: chain.append(
                tuple(spec.box.lo for spec in i.levels[1:])))
        _sync(device)
        secs = time.perf_counter() - t0
    finally:
        aml.MultiLevelCompositeProjection.project = orig
    return ml, state, dt, secs, its, chain


def _sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def _ml_breakdown(ml, s, dt, warm):
    """The stages of one three-level IB step: interp, force, the spread
    restricted down the hierarchy, the predictor and the projection."""
    core, fl = ml.core, s.fluid
    uf = fl.us[-1]
    U = ml._interp(uf, s.X, s.mask)
    F = ml.ib.compute_force(s.X, U, fl.t)
    fs = ml._spread_forces(F, s.X, s.mask)
    stars = core._predict(fl.us, dt, fs=fs)
    stages = [
        ("interp", lambda: ml._interp(uf, s.X, s.mask)),
        ("force", lambda: ml.ib.compute_force(s.X, U, fl.t)),
        ("spread", lambda: ml._spread_forces(F, s.X, s.mask)),
        ("predictor", lambda: core._predict(fl.us, dt, fs=fs)),
        ("projection", lambda: core.proj.project(stars)),
    ]

    def steps3():
        st = s
        for _ in range(3):
            st = ml.step(st, dt)

    _stage_breakdown("mlamr", stages, steps3, 3, 1e3 / warm)


def _graphed_ml_projection_bitwise(ml, state) -> bool:
    """The L-level projection at ``state`` through the graphed operators
    against a fresh projection on the eager flat operators."""
    from ibamr_tpu_torch.amr_ins_multilevel import \
        MultiLevelCompositeProjection
    from ibamr_tpu_torch.solvers.krylov import flat_operators

    graphed = ml.core.proj
    eager = MultiLevelCompositeProjection(
        ml.levels, tol=graphed.tol, m=graphed.m, restarts=graphed.restarts,
        device=DEVICE)
    eager.flat_ops = lambda t: flat_operators(eager.operator,
                                              eager._precondition, t)
    a, ia = graphed.project(state.fluid.us)
    b, ib = eager.project(state.fluid.us)
    return ia == ib and all(torch.equal(x, y) for ua, ub in zip(a, b)
                            for x, y in zip(ua, ub))


def _ml_parity_leg(device):
    """The reduced hierarchy of the GPU-vs-CPU leg (``ML_PARITY``): the
    3D shell of tests/test_amr_ins_multilevel.py:274 on its 24^3 root, in
    a 0.4 stream, f32, with the window chain re-placed every ``regrid``
    steps: (state, restarts, chain)."""
    from ibamr_tpu_torch import amr_ins_multilevel as aml
    from ibamr_tpu_torch.amr import FineBox
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ib import IBMethod
    from ibamr_tpu_torch.models.shell3d import make_spherical_shell

    p = ML_PARITY
    g = StaggeredGrid(n=(p["n"],) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    s = make_spherical_shell(10, 10, 0.07, p["center"], 1.0,
                             rest_length_factor=0.8)
    ib = IBMethod(s.force_specs(dtype=torch.float32, device=device),
                  kernel="IB_4")
    boxes = [FineBox(lo=lo, shape=(p["shape"],) * 3) for lo in p["boxes"]]
    ml = aml.MultiLevelIBINS(g, boxes, ib, mu=0.05, proj_tol=3e-6,
                             device=device)
    st = ml.initialize(torch.tensor(s.vertices, dtype=torch.float32,
                                    device=device),
                       vel_fn=lambda d, mesh: (0.4 if d == 0 else 0.0)
                       + 0.0 * mesh[0])
    its, chain = [], []
    orig = _count_projections(aml.MultiLevelCompositeProjection, its)
    try:
        ml, st = aml.advance_multilevel_ib_regridding(
            ml, st, p["dt"], p["steps"], regrid_interval=p["regrid"],
            on_chunk=lambda i, s_, done: chain.append(
                tuple(spec.box.lo for spec in i.levels[1:])))
    finally:
        aml.MultiLevelCompositeProjection.project = orig
    return st, its, chain


def _ml_scalar(device):
    """``MultiLevelAdvDiff`` on adv_diff ex0's grid (``ML_ADV``), three
    levels, f32: (the final fields, the relative drift of the composite
    total, steps/s)."""
    from ibamr_tpu_torch.amr import FineBox
    from ibamr_tpu_torch.amr_multilevel import MultiLevelAdvDiff
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    geo = parse_input_file(os.path.join(ROOT, ADV_INPUT)).get_database(
        "CartesianGeometry")
    grid = StaggeredGrid(n=tuple(geo.get_int_array("n_cells")),
                         x_lo=tuple(geo.get_float_array("x_lo")),
                         x_up=tuple(geo.get_float_array("x_up")))
    n = grid.n[0]
    boxes = [FineBox(lo=(n // 4,) * 2, shape=(n // 2,) * 2)] * 2
    sim = MultiLevelAdvDiff(grid, boxes, kappa=ML_ADV["kappa"],
                            vel_fn=lambda m: (0.7 + 0.0 * m[0],
                                              0.3 + 0.0 * m[1]),
                            dtype=torch.float32, device=device)
    Q = sim.initialize(lambda c: torch.exp(
        -((c[0] - 0.4) ** 2 + (c[1] - 0.5) ** 2) / 0.02))
    t0 = float(sim.total(Q))
    dt = 0.2 * grid.dx[0]
    _sync(device)
    t = time.perf_counter()
    for _ in range(ML_ADV["steps"]):
        Q = sim.step(Q, dt)
    _sync(device)
    rate = ML_ADV["steps"] / (time.perf_counter() - t)
    return Q, abs(float(sim.total(Q)) - t0) / abs(t0), rate


def _multibox_leg(device):
    """``MultiBoxDynamicAdvDiff`` with K = 2 windows at the size of
    tests/test_amr_multibox.py's regrid-invariance run (``MB``), f32: the
    origins at every regrid, the final state, steps/s."""
    from ibamr_tpu_torch.amr_multibox import MultiBoxDynamicAdvDiff
    from ibamr_tpu_torch.grid import StaggeredGrid

    n = MB["n"]
    grid = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))

    def u_fn(c, d):
        return -MB["amp"] * torch.sin(2.0 * math.pi * c[0]) if d == 0 \
            else torch.zeros_like(c[0])

    sim = MultiBoxDynamicAdvDiff(grid, (MB["box"],) * 2, K=2,
                                 kappa=MB["kappa"], u_fn=u_fn,
                                 tag_threshold=MB["threshold"],
                                 dtype=torch.float32, device=device)
    st = sim.initialize(lambda c: sum(torch.exp(
        -((c[0] - x0) ** 2 + (c[1] - 0.5) ** 2) / 0.06 ** 2)
        for x0 in (0.35, 0.65)))
    t0 = float(sim.total(st))
    los = [st.lo.tolist()]
    _sync(device)
    t = time.perf_counter()
    for _ in range(MB["steps"] // MB["regrid"]):
        st = sim.advance(sim.regrid_state(st), MB["dt"], MB["regrid"])
        los.append(st.lo.tolist())
    _sync(device)
    rate = MB["steps"] / (time.perf_counter() - t)
    return los, st, abs(float(sim.total(st)) - t0) / abs(t0), rate


def phase_mlamr(breakdown: bool = False) -> None:
    """The L-level hierarchy: the ex4_amr shell on three levels on the
    card (``ML_STEPS`` steps, a regrid every ``ML_REGRID``) with the
    default preconditioner and with ``FACMultilevelPoisson`` through
    ``precond_factory``; the reduced hierarchy of ``ML_PARITY`` on the
    card and on the CPU; the three-level scalar advance and the two-window
    multi-box advance on both."""
    ok = True
    runs = {}
    for fac in (False, True):
        ml, st, dt, secs, its, chain = _ml_run(DEVICE, fac, ML_STEPS,
                                               ML_REGRID)
        fg = ml.finest_grid
        speed = max(float(c.abs().max()) for c in st.fluid.us[-1])
        div = float(ml.core.max_divergence(st.fluid))
        bound = ml.core.proj.tol * speed / min(fg.dx)
        warm, st = _warm_steps_per_s(lambda s: ml.step(s, dt), st, ML_WARM)
        name = "FACMultilevelPoisson" if fac else "FFT + fast-diag"
        runs[fac] = its
        log(f"[mlamr] ex4_amr shell on 3 levels, preconditioner {name}, "
            f"on {torch.cuda.get_device_name(0)}: root {ml.grid.n}, "
            f"windows {[spec.box.shape for spec in ml.levels[1:]]} "
            f"(finest {fg.n}, dx {fg.dx[0]:.6g}), {st.X.shape[0]} markers, "
            f"dt {dt:.6g} = min(input dt, stable_dt(cfl=0.5)), f32: "
            f"{ML_STEPS} steps in {secs:.3f} s ({ML_STEPS / secs:.3f} "
            f"steps/s, regrids included), warm {warm:.3f} steps/s "
            f"({ML_WARM} steps); FGMRES restarts per projection mean "
            f"{np.mean(its):.3f} max {max(its)} over {len(its)}; box chain "
            f"per chunk {chain}; max|div u| {div:.3e} (bound "
            f"tol*max|u|/dx_finest {bound:.3e})")
        ok &= (bool(torch.isfinite(st.X).all()) and div < bound
               and int(st.fluid.k) == ML_STEPS + ML_WARM)
        if breakdown and not fac:
            _ml_breakdown(ml, st, dt, warm)
        if not fac:
            bitwise = _graphed_ml_projection_bitwise(ml, st)
            log(f"[mlamr] L-level projection at the end state, operator "
                f"and preconditioner replayed as CUDA graphs, bitwise "
                f"equal to the eager flat operators with equal restarts: "
                f"{bitwise}")
            ok &= bitwise
        del ml, st
    gst, git, gch = _ml_parity_leg(DEVICE)
    cst, cit, cch = _ml_parity_leg("cpu")
    ex = _rel(gst.X, cst.X)
    scale = max(float(c.abs().max()) for u in cst.fluid.us for c in u)
    eu = max(float((a.cpu() - b).abs().max()) for ga, ca in
             zip(gst.fluid.us, cst.fluid.us) for a, b in zip(ga, ca)) / scale
    log(f"[mlamr] GPU vs CPU, {ML_PARITY['n']}^3 root with two "
        f"{ML_PARITY['shape']}^3 windows, {ML_PARITY['steps']} steps, "
        f"regrid every {ML_PARITY['regrid']}: chains {gch} / {cch}; restarts {git} / "
        f"{cit}; max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol {TOL_PARITY_X:g}), "
        f"max|u_gpu-u_cpu|/max|u|={eu:.3e} (tol {TOL_PARITY_U:g})")
    ok &= (gch == cch and git == cit and ex <= TOL_PARITY_X
           and eu <= TOL_PARITY_U)
    gQ, gdrift, grate = _ml_scalar(DEVICE)
    cQ, cdrift, crate = _ml_scalar("cpu")
    eq = max(_rel(a, b) for a, b in zip(gQ, cQ))
    log(f"[mlamr] MultiLevelAdvDiff 3 levels on adv_diff ex0's "
        f"{gQ[0].shape} grid, {ML_ADV['steps']} steps, f32: GPU {grate:.3f} "
        f"steps/s, CPU {crate:.3f}; composite total drift GPU {gdrift:.3e} "
        f"CPU {cdrift:.3e} (bound {ML_ADV['tol']:g}); GPU vs CPU {eq:.3e} "
        f"(tol {TOL_PARITY_Q:g})")
    ok &= gdrift <= ML_ADV["tol"] and eq <= TOL_PARITY_Q
    glos, gmb, gmd, gmr = _multibox_leg(DEVICE)
    clos, cmb, cmd, cmr = _multibox_leg("cpu")
    emb = _rel(gmb.Qf, cmb.Qf)
    log(f"[mlamr] MultiBoxDynamicAdvDiff K=2, {MB['n']}^2, windows "
        f"{MB['box']}^2, {MB['steps']} steps, regrid every {MB['regrid']}, "
        f"f32: GPU {gmr:.3f} steps/s, CPU {cmr:.3f}; origins GPU {glos} "
        f"CPU {clos}; total drift GPU {gmd:.3e} CPU {cmd:.3e}; windows GPU "
        f"vs CPU {emb:.3e}")
    ok &= (glos == clos and gmd <= ML_ADV["tol"] and emb <= TOL_PARITY_Q)
    if not ok:
        raise AssertionError("mlamr: a check failed (see the [mlamr] lines)")


# -- implicit coupling and the structure models (implicit) --------------------

def _ex0_implicit(device, scheme, factor, steps):
    """The committed ex0 membrane (64^2, 128 markers, scatter oracle) at
    f64 under ``IBImplicitIntegrator`` at ``factor`` x the input's dt:
    (state, Newton iterations per step, area drift, seconds, X after
    ``IMP1_CPU`` steps, the step function)."""
    from ibamr_tpu_torch.integrators.ib import polygon_area
    from ibamr_tpu_torch.integrators.ib_implicit import IBImplicitIntegrator
    from ibamr_tpu_torch.models.membrane2d import build_membrane_example
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    db = parse_input_file(os.path.join(ROOT, EX0_INPUT))
    dt = factor * db.get_database("INSStaggeredHierarchyIntegrator") \
        .get_float("dt")
    integ, st = build_membrane_example(input_db=db, dtype=torch.float64,
                                       device=device)
    imp = IBImplicitIntegrator(integ.ins, integ.ib, scheme=scheme)
    a0 = float(polygon_area(st.X))
    its, X_mark = [], None
    _sync(device)
    t = time.perf_counter()
    for k in range(steps):
        st = imp.step(st, dt)
        its.append(imp.last_solve_stats["iters"])
        if k + 1 == IMP1_CPU:
            X_mark = st.X.clone()
    _sync(device)
    secs = time.perf_counter() - t
    return (st, its, abs(float(polygon_area(st.X)) - a0) / a0, secs, X_mark,
            lambda s: imp.step(s, dt))


def _ex0_amr_implicit(device):
    """``TwoLevelIBImplicit`` (backward Euler, the class's projection
    settings) on the committed ex0_amr membrane and stream at 10x its dt,
    f64, with a regrid every ``IMP2["regrid"]`` steps: (integ, state,
    Newton iterations per step, the window after each chunk, seconds,
    dt)."""
    from ibamr_tpu_torch.amr_ins import box_from_markers
    from ibamr_tpu_torch.examples.ib_explicit_ex0_amr import add_stream
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators import ib_implicit as ii
    from ibamr_tpu_torch.integrators.ib import IBMethod
    from ibamr_tpu_torch.models.membrane2d import make_circle_membrane
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    db = parse_input_file(os.path.join(ROOT, EX0_AMR_INPUT))
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    mem = db.get_database("Membrane")
    geo = db.get_database("CartesianGeometry")
    grid = StaggeredGrid(n=tuple(geo.get_int_array("n_cells")),
                         x_lo=tuple(geo.get_float_array("x_lo")),
                         x_up=tuple(geo.get_float_array("x_up")))
    struct = make_circle_membrane(
        mem.get_int("num_markers"), mem.get_float("radius"),
        tuple(mem.get_float_array("center")),
        stiffness=mem.get_float("stiffness"),
        rest_length_factor=mem.get_float("rest_length_factor"),
        aspect=mem.get_float("aspect"))
    ib = IBMethod(struct.force_specs(dtype=torch.float64, device=device),
                  kernel="IB_4")
    box = box_from_markers(grid, struct.vertices, pad=db.get_database(
        "GriddingAlgorithm").get_int("tag_buffer"))
    imp = ii.TwoLevelIBImplicit(grid, box, ib, rho=idb.get_float("rho"),
                                mu=idb.get_float("mu"),
                                scheme="backward_euler", device=device)
    st = add_stream(imp.initialize(torch.tensor(
        struct.vertices, dtype=torch.float64, device=device)),
        db.get_database("Stream").get_float("u0"))
    dt = IMP2["factor"] * idb.get_float("dt")
    its, boxes = [], [imp.box.lo]

    def chunk(integ, s, dt_, n):
        for _ in range(n):
            s = integ.step(s, dt_)
            its.append(integ.last_solve_stats["iters"])
        return s

    _sync(device)
    t = time.perf_counter()
    imp, st = ii.advance_with_regrids(
        imp, st, dt, IMP2["steps"], IMP2["regrid"], chunk,
        ii.regrid_two_level_ib_implicit,
        on_chunk=lambda i, s, done: boxes.append(i.box.lo))
    _sync(device)
    return imp, st, its, boxes, time.perf_counter() - t, dt


def _imp_leg(device):
    """The IMP elastic disc of ``material_disc`` on 128^2 (``IMPD``), f32:
    (state, mean |det F - 1| before and after, seconds, max|u|)."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators import imp
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator

    n = IMPD["n"]
    g = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    X0, V0 = imp.material_disc(g, (0.5, 0.5), 0.15, points_per_cell=2,
                               dtype=torch.float32, device=device)
    integ = imp.IMPExplicitIntegrator(
        INSStaggeredIntegrator(g, mu=0.05, rho=1.0, device=device),
        imp.IMPMethod(V0, imp.NeoHookean(5.0, 5.0), device=device))
    st = integ.initialize(X0)
    st = st._replace(F=st.F @ torch.tensor([[1.1, 0.0], [0.0, 1.0]],
                                           device=device))
    j0 = float((integ.jacobians(st) - 1.0).abs().mean())
    _sync(device)
    t = time.perf_counter()
    for _ in range(IMPD["steps"]):
        st = integ.step(st, IMPD["dt"])
    _sync(device)
    return st, j0, float((integ.jacobians(st) - 1.0).abs().mean()), \
        time.perf_counter() - t, float(st.ins.u[0].abs().max())


def _gib_leg(device):
    """The twisted rod of tests/test_rods.py on 64^3 (``GIB``), f32:
    (state, energy before and after, seconds)."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators import gib
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
    from ibamr_tpu_torch.ops import rods

    n, L = 12, 0.4
    g = StaggeredGrid(n=(GIB["n"],) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    X, D = rods.straight_rod(n, L, origin=(0.5, 0.5, 0.3),
                             dtype=torch.float32, device=device)
    w = torch.zeros(n, 3, device=device)
    w[:, 2] = 3.0 * torch.arange(n, device=device) * L / (n - 1)
    idx = np.arange(n - 1)
    specs = rods.make_rods(idx, idx + 1, 0.05, 0.0, 5.0, L / (n - 1),
                           device=device)
    m = gib.GeneralizedIBMethod(INSStaggeredIntegrator(
        g, mu=0.1, convective_op_type="none", device=device), specs)
    st = m.initialize(X, rods.rotate_frames(D, w))
    e0 = float(m.energy(st))
    _sync(device)
    t = time.perf_counter()
    st = gib.advance_gib(m, st, GIB["dt"], GIB["steps"])
    _sync(device)
    return st, e0, float(m.energy(st)), time.perf_counter() - t


def _penalty_leg(device):
    """The massive membrane of tests/test_aux_ib.py on 64^2 (``PEN``), f32:
    (state, the mean height before and after, seconds)."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ib import IBMethod
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
    from ibamr_tpu_torch.integrators.penalty_ib import PenaltyIBIntegrator
    from ibamr_tpu_torch.models.membrane2d import make_circle_membrane

    n = PEN["n"]
    g = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    s = make_circle_membrane(48, 0.12, (0.5, 0.6), stiffness=2.0,
                             rest_length_factor=1.0)
    integ = PenaltyIBIntegrator(
        INSStaggeredIntegrator(g, mu=0.1, convective_op_type="none",
                               device=device),
        IBMethod(s.force_specs(device=device)), mass=np.full(48, 0.05),
        stiffness=200.0, gravity=(0.0, -1.0))
    st = integ.initialize(s.vertices)
    y0 = float(st.ib.X[:, 1].mean())
    _sync(device)
    t = time.perf_counter()
    for _ in range(PEN["steps"]):
        st = integ.step(st, PEN["dt"])
    _sync(device)
    return st, y0, float(st.ib.X[:, 1].mean()), time.perf_counter() - t


def _panel_leg(device):
    """An ``InstrumentPanel`` on the cavity's committed flow after
    ``PANEL_STEPS`` steps: three closed marker loops (circles) and one
    open chain across the centerline: (readings, max|u|, loop lengths)."""
    from ibamr_tpu_torch.examples import navier_stokes_cavity2d
    from ibamr_tpu_torch.instruments import InstrumentPanel, make_meters
    from ibamr_tpu_torch.integrators.ins import advance
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    db = parse_input_file(os.path.join(ROOT, CAVITY_INPUT))
    dt = db.get_database("INSStaggeredHierarchyIntegrator").get_float("dt")
    integ, st = navier_stokes_cavity2d.build(db, device)
    st = advance(integ, st, dt, PANEL_STEPS)
    loops, X, lengths = [], [], []
    for (cx, cy, r) in ((0.5, 0.65, 0.2), (0.3, 0.3, 0.12),
                        (0.7, 0.4, 0.15)):
        th = 2 * np.pi * np.arange(64) / 64
        loops.append(list(range(len(X), len(X) + 64)))
        X += list(zip(cx + r * np.cos(th), cy + r * np.sin(th)))
        lengths.append(2 * np.pi * r)
    loops.append(list(range(len(X), len(X) + 33)))
    X += [(0.5, y) for y in np.linspace(0.1, 0.9, 33)]
    meters = make_meters(loops, closed=[True, True, True, False],
                         device=device)
    panel = InstrumentPanel(integ.grid, meters)
    out = panel.readings(st.u, st.p, torch.tensor(
        np.asarray(X), dtype=torch.float32, device=device))
    speed = max(float(c.abs().max()) for c in st.u)
    return out, speed, lengths


def phase_implicit(breakdown: bool = False) -> None:
    """Implicit IB and the remaining structure models: the committed ex0
    membrane under ``IBImplicitIntegrator`` (midpoint at 3x the input's
    dt, backward Euler at 14x, ``IMP1_STEPS`` steps each, f64) on the card
    and its first ``IMP1_CPU`` steps on the CPU (equal Newton counts);
    ``TwoLevelIBImplicit`` on the committed ex0_amr at 10x its dt with
    regrids; the IMP disc, the GIB rod, the penalty membrane and an
    instrument panel on the cavity's flow, each on the card and the CPU;
    and the kernel engines refusing the implicit step."""
    from ibamr_tpu_torch.integrators.ib_implicit import IBImplicitIntegrator
    from ibamr_tpu_torch.models.shell3d import build_shell_example

    ok = True
    for scheme, factor in (("midpoint", 3.0), ("backward_euler", 14.0)):
        st, its, drift, secs, gX, step = _ex0_implicit(
            DEVICE, scheme, factor, IMP1_STEPS)
        cst, cits, _, csecs, _, _ = _ex0_implicit("cpu", scheme, factor,
                                                  IMP1_CPU)
        gits = its[:IMP1_CPU]
        ex = _rel(gX, cst.X)
        log(f"[implicit] ex0 membrane (64^2, 128 markers, f64), {scheme} at "
            f"{factor:g}x the input's dt: {IMP1_STEPS} steps at "
            f"{IMP1_STEPS / secs:.3f} steps/s on the card (CPU "
            f"{IMP1_CPU / csecs:.3f}); Newton iterations per step {its}; "
            f"area drift {drift:.3e} (bound {IMPLICIT_AREA_DRIFT:g}); first "
            f"{IMP1_CPU} steps GPU vs CPU: Newton {gits} / {cits}, "
            f"max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol {TOL_PARITY_X:g})")
        ok &= (bool(torch.isfinite(st.X).all())
               and drift < IMPLICIT_AREA_DRIFT and gits == cits
               and ex <= TOL_PARITY_X)
        if breakdown:
            _stage_breakdown(f"implicit ex0 {scheme}", [],
                             lambda: step(st), 1, 1e3 * secs / IMP1_STEPS)
    imp, st2, its2, boxes, secs2, dt2 = _ex0_amr_implicit(DEVICE)
    proj = imp._expl.core.proj
    log(f"[implicit] TwoLevelIBImplicit, ex0_amr (64^2 coarse, window "
        f"{imp.box.shape} x2, f64), backward Euler at {IMP2['factor']:g}x "
        f"the input's dt: {IMP2['steps']} steps at "
        f"{IMP2['steps'] / secs2:.3f} steps/s, a regrid every "
        f"{IMP2['regrid']}; Newton iterations per step {its2}; windows "
        f"{boxes}; last projection {proj.last_solve_stats}")
    ok &= bool(torch.isfinite(st2.X).all()) and all(
        i <= imp.newton_maxiter for i in its2)
    if breakdown:
        _stage_breakdown("implicit ex0_amr", [],
                         lambda: imp.step(st2, dt2), 1,
                         1e3 * secs2 / IMP2["steps"])
    for label, leg, check in (
            # the prestress drives a flow (tests/test_imp.py:100)
            ("IMP disc 128^2", _imp_leg,
             lambda r: r[4] > 1e-4 and bool(torch.isfinite(r[0].F).all())),
            ("GIB twisted rod 64^3", _gib_leg,
             lambda r: r[2] < r[1]),
            ("penalty membrane 64^2", _penalty_leg,
             lambda r: r[2] < r[1])):
        g, c = leg(DEVICE), leg("cpu")
        ex = _rel(g[0].X if hasattr(g[0], "X") else g[0].ib.X,
                  c[0].X if hasattr(c[0], "X") else c[0].ib.X)
        passed = check(g) and check(c) and ex <= TOL_PARITY_X
        log(f"[implicit] {label}, f32: {g[3]:.3f} s on the card, {c[3]:.3f} "
            f"s on the CPU; before/after {g[1]:.6g} -> {g[2]:.6g} (CPU "
            f"{c[2]:.6g}); max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol "
            f"{TOL_PARITY_X:g}); passed {passed}")
        ok &= passed
    gp, speed, lengths = _panel_leg(DEVICE)
    cp, _, _ = _panel_leg("cpu")
    closed = [abs(float(v)) / (speed * L) for v, L in
              zip(gp["flux"][:3], lengths)]
    ep = max(float((gp[k].cpu() - cp[k]).abs().max())
             / max(float(cp[k].abs().max()), 1e-30)
             for k in ("flux", "mean_pressure"))
    log(f"[implicit] InstrumentPanel on the cavity's flow after "
        f"{PANEL_STEPS} steps: fluxes {gp['flux'].tolist()}, mean "
        f"pressures {gp['mean_pressure'].tolist()}; closed loops |flux| / "
        f"(max|u| length) {closed} (bound {PANEL_CLOSED_TOL:g}); GPU vs CPU "
        f"{ep:.3e} (tol {TOL_PARITY_U:g})")
    ok &= max(closed) < PANEL_CLOSED_TOL and ep <= TOL_PARITY_U
    integ, st = build_shell_example(n_cells=32, n_lat=16, n_lon=16,
                                    use_fast_interaction="pallas_packed",
                                    device=DEVICE)
    try:
        IBImplicitIntegrator(integ.ins, integ.ib).step(st, 1e-3)
        refused = False
    except NotImplementedError as e:
        refused = "pallas_packed" in str(e)
        log(f"[implicit] IBImplicitIntegrator on the 32^3 shell's "
            f"pallas_packed engine: NotImplementedError ({e})")
    ok &= refused
    if not ok:
        raise AssertionError("implicit: a check failed (see the "
                             "[implicit] lines)")


def _rel64(a, b) -> float:
    """max|a - b| / max|b| over a tuple (or one tensor) of card tensors
    ``a`` against CPU tensors ``b``."""
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return max(_rel(x, y) for x, y in zip(a, b))


def _dam_break_leg(breakdown: bool):
    """The dam break on its committed input as it is, its four bounds,
    the warm steps/s, CG iterations per step, the graphed projection
    bitwise against eager, and the restart leg."""
    from ibamr_tpu_torch.examples import multiphase_dam_break as dam
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    path = os.path.join(ROOT, MP_DAM_INPUT)
    db = parse_input_file(path)
    vc = db.get_database("INSVCStaggeredHierarchyIntegrator")
    steps, dt = vc.get_int("num_steps"), vc.get_float("dt")
    timer = TimerManager.instance()
    timer.reset()
    (integ, st), files = _in_tmp(lambda: dam.run(db, device=DEVICE))
    run_s = timer.get("advance").total
    recs = _records(files, db.get_database("Main").get_string("log_jsonl"))
    its = integ.cg_iterations / integ.projections
    dx = integ.grid.dx[0]
    fronts = [r["front"] for r in recs]
    last = recs[-1]
    finite = all(math.isfinite(v) for r in recs for v in r.values())
    monotone = all(b >= a - dx for a, b in zip(fronts, fronts[1:]))
    early = max(r["volume_drift"] for r in recs
                if r["t"] <= MP_DAM_BOUND_T * (1 + 1e-6))
    drift_ref = abs(last["volume_drift"] - MP_DAM_REF_DRIFT) \
        / MP_DAM_REF_DRIFT
    bounds = (monotone and fronts[-1] > 0.25 + 2 * dx and early < 1e-2
              and drift_ref <= MP_DAM_DRIFT_RTOL
              and max(r["max_div"] for r in recs) < 1e-2)
    c0, p0 = integ.cg_iterations, integ.projections
    warm, st_w = _warm_steps_per_s(lambda s: integ.step(s, dt), st, MP_WARM)
    warm_its = (integ.cg_iterations - c0) / (integ.projections - p0)
    # the graphed projection against the eager pieces at the end state
    rho = integ.density(st_w.phi)
    u_star = tuple(c + 0.01 * torch.roll(c, 1, 1) for c in st_w.u)
    ug, pg = integ.project_vc(u_star, rho, dt)
    ig = integ.last_solve_stats["iters"]
    ue, pe = integ.project_with(
        integ.projection(rho, dt, graphed=False), u_star, dt)
    ie = integ.last_solve_stats["iters"]
    bitwise = ig == ie and all(torch.equal(a, b) for a, b in
                               zip(ug + (pg,), ue + (pe,)))
    log(f"[multiphase] dam break {MP_DAM_INPUT} as committed: grid "
        f"{integ.grid.n}, {steps} steps of dt={dt:g}, f32, walls on both "
        f"axes: {steps / run_s:.3f} steps/s over the run (graph captures "
        f"included), warm {warm:.3f} steps/s ({MP_WARM} steps from the end "
        f"state, host clock and a synchronize); CG iterations per step "
        f"{its:.2f} over the run, {warm_its:.2f} warm")
    for r in recs:
        log(f"[multiphase] dam metrics {json.dumps(r)}")
    log(f"[multiphase] dam bounds (tests/test_examples_r5.py:229-236): "
        f"fronts monotone within dx {monotone}, last front "
        f"{fronts[-1]:.6g} > {0.25 + 2 * dx:.6g}, volume drift through "
        f"t = {MP_DAM_BOUND_T:g} {early:.3e} < 1e-2, last volume drift "
        f"{last['volume_drift']:.6e} against the reference's committed run "
        f"{MP_DAM_REF_DRIFT:.6e}: {drift_ref:.3e} (tol "
        f"{MP_DAM_DRIFT_RTOL:g}), max|div u| over the records "
        f"{max(r['max_div'] for r in recs):.3e} < 1e-2: {bounds}; graphed "
        f"projection bitwise equal to eager with equal CG counts ({ig} / "
        f"{ie}): {bitwise}")
    rst = _dam_restart_leg(dam, path)
    if breakdown:
        _dam_breakdown(integ, st_w, dt, 1e3 / warm)
    return finite and bounds and bitwise and rst


def _dam_restart_leg(dam, path) -> bool:
    """``tests/test_examples_r5.py:393`` on the card: the tank at 48x32,
    20 steps with a dump, then ``restart`` to 40, against the straight
    40-step run, bitwise in front and volume drift."""
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    base = open(path).read()

    def cfg(tag, rdir, rint, steps):
        text = base
        for pat, rep in ((r"n\s*=\s*\d+\s*,\s*\d+", "n = 48, 32"),
                         (r"dt\s*=\s*[0-9.eE+-]+", "dt = 1.5e-3"),
                         (r"num_steps\s*=\s*\d+", f"num_steps = {steps}"),
                         (r'log_jsonl\s*=\s*"[^"]*"',
                          f'log_jsonl = "{tag}.jsonl"\n   restart_dirname = '
                          f'"{rdir}"\n   restart_interval = {rint}')):
            text, k = re.subn(pat, rep, text)
            if k != 1:
                raise AssertionError(f"multiphase: {pat!r} in {path}")
        with open(f"in_{tag}", "w") as f:
            f.write(text)
        return parse_input_file(f"in_{tag}")

    def runs():
        dam.run(cfg("a", "ra", 0, 40), device=DEVICE)
        dam.run(cfg("b", "rb", 20, 20), device=DEVICE)
        dam.run(cfg("c", "rb", 20, 40), device=DEVICE, restart=True)

    _, files = _in_tmp(runs)
    a, c = _records(files, "a.jsonl")[-1], _records(files, "c.jsonl")
    ok = ([r["step"] for r in c] == [40] and a["step"] == 40
          and a["front"] == c[-1]["front"]
          and a["volume_drift"] == c[-1]["volume_drift"])
    log(f"[multiphase] dam restart leg (48x32, 20 + restart to 40 against "
        f"40 straight): front {a['front']!r} / {c[-1]['front']!r}, volume "
        f"drift {a['volume_drift']!r} / {c[-1]['volume_drift']!r}: bitwise "
        f"{ok}")
    return ok


def _dam_breakdown(integ, st, dt, step_ms):
    """One warm dam-break step: device ms in how many kernels and the
    idle share; ms per CG iteration; the reinitialization's cost."""
    from ibamr_tpu_torch.physics import level_set as ls

    c0, p0 = integ.cg_iterations, integ.projections
    dev, kernels, _ = _device_ms(lambda: integ.step(st, dt), 3)
    its = (integ.cg_iterations - c0) / (integ.projections - p0)
    rho = integ.density(st.phi)
    proj = integ.projection(rho, dt)
    u_star = tuple(c + 0.01 * torch.roll(c, 1, 1) for c in st.u)
    host_p = _host_ms(lambda: integ.project_with(proj, u_star, dt), 3)
    pits = integ.last_solve_stats["iters"]
    dev_p, kern_p, _ = _device_ms(
        lambda: integ.project_with(proj, u_star, dt), 2)
    r = torch.ones_like(rho)
    host_m = _host_ms(lambda: proj.M(r), 20)
    dev_m, kern_m, _ = _device_ms(lambda: proj.M(r), 5)
    wa = integ.wall_axes
    reinit = lambda: ls.reinitialize(st.phi, integ.grid.dx,  # noqa: E731
                                     iters=20, wall_axes=wa)
    host_r = _host_ms(reinit, 5)
    dev_r, kern_r, _ = _device_ms(reinit, 2)
    log(f"[breakdown] multiphase dam whole step: device busy {dev:.3f} ms "
        f"in {kernels:.0f} kernels ({its:.2f} CG iterations), of "
        f"{step_ms:.3f} ms/step (warm leg): idle share "
        f"{1 - dev / step_ms:.3f}")
    log(f"[breakdown] multiphase dam projection: host {host_p:.3f} ms, "
        f"device busy {dev_p:.3f} ms in {kern_p:.0f} kernels for {pits} CG "
        f"iterations: {host_p / max(pits, 1):.3f} ms (host) / "
        f"{dev_p / max(pits, 1):.3f} ms (device) per iteration; one "
        f"graphed V-cycle {host_m:.3f} ms host, {dev_m:.3f} ms device in "
        f"{kern_m:.0f} kernels")
    log(f"[breakdown] multiphase dam reinitialization (20 iterations, "
        f"every {integ.reinit_interval} steps): host {host_r:.3f} ms, "
        f"device busy {dev_r:.3f} ms in {kern_r:.0f} kernels")
    # fast sweeping (not on the step): one launch group per slice of each
    # directional pass, 4 rounds of 2 * dim passes
    fsm = lambda: ls.fast_sweeping_distance(  # noqa: E731
        st.phi, integ.grid.dx, wall_axes=wa)
    host_f = _host_ms(fsm, 2)
    dev_f, kern_f, _ = _device_ms(fsm, 1)
    log(f"[breakdown] multiphase fast_sweeping_distance on the dam's "
        f"{integ.grid.n} level set (4 rounds of 4 passes, slice by slice): "
        f"host {host_f:.3f} ms, device busy {dev_f:.3f} ms in "
        f"{kern_f:.0f} kernels")


def _falling_drop_leg(inp: str) -> bool:
    """One falling-drop input as committed on the card (drift and
    divergence against the stated bounds, warm steps/s), then its first
    ``MP_PARITY_STEPS`` steps at f64 on the card and the CPU (CG counts
    equal, fields within ``TOL_MP_F64``)."""
    from ibamr_tpu_torch.examples import multiphase_falling_drop as fd
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    db = parse_input_file(os.path.join(ROOT, inp))
    vc = db.get_database("INSVCStaggeredHierarchyIntegrator")
    steps, dt = vc.get_int("num_steps"), vc.get_float("dt")
    timer = TimerManager.instance()
    timer.reset()
    (integ, st), files = _in_tmp(lambda: fd.run(db, device=DEVICE))
    run_s = timer.get("advance").total
    recs = _records(files, db.get_database("Main").get_string("log_jsonl"))
    its = integ.cg_iterations / integ.projections
    warm, _ = _warm_steps_per_s(lambda s: integ.step(s, dt), st, MP_WARM)
    last = recs[-1]
    finite = all(math.isfinite(v) for r in recs for v in r.values())
    bounds = (last["volume_drift"] < MP_DROP_DRIFT
              and max(r["max_div"] for r in recs) < MP_DROP_DIV)
    gi, gs = fd.build(db, DEVICE, torch.float64)
    ci, cs = fd.build(db, "cpu", torch.float64)
    g_its, c_its = [], []
    for _ in range(MP_PARITY_STEPS):
        gs, cs = gi.step(gs, dt), ci.step(cs, dt)
        g_its.append(gi.last_solve_stats["iters"])
        c_its.append(ci.last_solve_stats["iters"])
    err = _rel64(gs.u + (gs.p, gs.phi), cs.u + (cs.p, cs.phi))
    log(f"[multiphase] falling drop {inp} as committed: grid {integ.grid.n}, "
        f"walls {integ.wall_axes}, {steps} steps of dt={dt:g}, f32: "
        f"{steps / run_s:.3f} steps/s over the run, warm {warm:.3f} steps/s;"
        f" CG iterations per step {its:.2f}")
    for r in recs:
        log(f"[multiphase] drop metrics {json.dumps(r)}")
    log(f"[multiphase] drop bounds: volume drift {last['volume_drift']:.3e} "
        f"< {MP_DROP_DRIFT:g}, max|div u| over the records "
        f"{max(r['max_div'] for r in recs):.3e} < {MP_DROP_DIV:g}: {bounds};"
        f" first {MP_PARITY_STEPS} steps at f64 GPU vs CPU: CG "
        f"{g_its} / {c_its}, max over u, p, phi of max|gpu-cpu|/max|cpu| "
        f"{err:.3e} (tol {TOL_MP_F64:g})")
    return finite and bounds and g_its == c_its and err <= TOL_MP_F64


def _vc3d_leg(device):
    """The 3D closed tank of ``tests/test_ins_vc_walls.py:260`` (16^3, a
    heavy drop, walls on all axes), ``MP_LEG_STEPS`` steps at f64."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins_vc import (
        INSVCStaggeredIntegrator, advance_vc)

    n = 16
    g = StaggeredGrid(n=(n,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    xx = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(xx, xx, xx, indexing="ij")
    phi0 = 0.18 - np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.65) ** 2)
    integ = INSVCStaggeredIntegrator(
        g, rho0=1.0, rho1=10.0, mu0=0.01, mu1=0.02, gravity=(0.0, 0.0, -5.0),
        convective_op_type="upwind", reinit_interval=10, cg_tol=1e-10,
        wall_axes=(True, True, True), dtype=torch.float64, device=device)
    st = advance_vc(integ, integ.initialize(phi0), 1e-3, MP_LEG_STEPS)
    return st.u + (st.p, st.phi), integ.cg_iterations


def _vc_capsule_leg(device):
    """The membrane capsule of ``tests/test_vc_ib.py:21`` (48^2, a heavy
    drop in a closed tank inside a 64-marker membrane)."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ib import (IBExplicitIntegrator,
                                                IBMethod, advance_ib)
    from ibamr_tpu_torch.integrators.ins_vc import INSVCStaggeredIntegrator
    from ibamr_tpu_torch.models.membrane2d import make_circle_membrane

    n, r0, c0 = 48, 0.12, (0.5, 0.62)
    g = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    vc = INSVCStaggeredIntegrator(
        g, rho0=1.0, rho1=5.0, mu0=0.02, mu1=0.05, gravity=(0.0, -3.0),
        reinit_interval=10, cg_tol=1e-10, wall_axes=(True, True),
        dtype=torch.float64, device=device)
    xx = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(xx, xx, indexing="ij")
    phi0 = r0 - np.sqrt((X - c0[0]) ** 2 + (Y - c0[1]) ** 2)
    s = make_circle_membrane(64, r0, c0, stiffness=1.0)
    integ = IBExplicitIntegrator(vc, IBMethod(
        s.force_specs(dtype=torch.float64, device=device), kernel="IB_4"))
    st = integ.initialize(s.vertices, ins_state=vc.initialize(phi0))
    st = advance_ib(integ, st, 5e-4, MP_LEG_STEPS)
    return (st.X,) + st.ins.u + (st.ins.p, st.ins.phi), vc.cg_iterations


def _brinkman_leg(device):
    """The driven flow past a fixed Brinkman cylinder of
    ``tests/test_brinkman_waves.py:43`` (48^2)."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
    from ibamr_tpu_torch.physics import brinkman

    g = StaggeredGrid(n=(48, 48), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    ins = INSStaggeredIntegrator(g, mu=0.02, rho=1.0, dtype=torch.float64,
                                 device=device)
    body = brinkman.BrinkmanBody(brinkman.make_cylinder_sdf(0.12), eta=1e-3)
    bp = brinkman.BrinkmanPenalization(ins, [body])
    kw = dict(dtype=torch.float64, device=device)
    bsts = [brinkman.RigidBodyState(
        center=torch.tensor([0.5, 0.5], **kw), U=torch.zeros(2, **kw),
        theta=torch.zeros((), **kw), omega=torch.zeros((), **kw))]
    f = (0.2 * torch.ones(g.n, **kw), torch.zeros(g.n, **kw))
    st = ins.initialize()
    for _ in range(MP_LEG_STEPS):
        st, bsts, imp = bp.step(st, bsts, 2e-3, f=f)
    return st.u + (st.p, imp[0][0]), 0


def _wave_tank_leg(device):
    """The open-outlet wave train of ``tests/test_vc_open.py:115``
    (96x32; generation zone, damping beach, outlet)."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins_vc import INSVCStaggeredIntegrator
    from ibamr_tpu_torch.physics.waves import (StokesWave, apply_zone,
                                               make_zone, still_targets,
                                               wave_targets)

    n, L, H, still = (96, 32), 3.0, 1.0, 0.5
    kw = dict(dtype=torch.float64, device=device)
    g = StaggeredGrid(n=n, x_lo=(0.0, 0.0), x_up=(L, H))
    wave = StokesWave(amplitude=0.02, wavelength=1.0, still_level=still,
                      depth=still)
    vc = INSVCStaggeredIntegrator(
        g, rho0=100.0, rho1=1.0, mu0=1e-3, mu1=1e-5, gravity=(0.0, -9.81),
        wall_axes=(False, True), open_outlet=True, still_level=still,
        cg_tol=1e-10, **kw)
    gen = make_zone(g, 0.0, 0.8, "generation", "lo", **kw)
    damp = make_zone(g, 2.2, 3.0, "damping", "hi", **kw)
    zc = (np.arange(n[1]) + 0.5) * g.dx[1]
    st = vc.initialize(np.broadcast_to((zc - still)[None, :], n).copy())
    phi_s, u_s = still_targets(g, still, **kw)
    for _ in range(MP_LEG_STEPS):
        st = vc.step(st, 2.5e-3)
        phi_t, u_t = wave_targets(g, wave, st.t, **kw)
        phi, u = apply_zone(st.phi, st.u, gen, phi_t, u_t)
        phi, u = apply_zone(phi, u, damp, phi_s, u_s)
        st = st._replace(phi=phi, u=u)
    return st.u + (st.p, st.phi), vc.cg_iterations


def _turbulence_leg(device):
    """Smagorinsky LES and k-omega URANS on a walled 32^2 Taylor-Green
    channel (the VC machinery with walls: multigrid-preconditioned CG)."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.physics.turbulence import KOmegaINS, SmagorinskyINS

    n = 32
    g = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    x, xc = np.arange(n) / n, (np.arange(n) + 0.5) / n
    u0 = (2.0 * np.sin(2 * np.pi * x)[:, None] * np.cos(2 * np.pi * xc)[None],
          -2.0 * np.cos(2 * np.pi * xc)[:, None] * np.sin(2 * np.pi * x)[None])
    u0[1][:, 0] = 0.0
    kw = dict(wall_axes=(False, True), dtype=torch.float64, device=device)
    les = SmagorinskyINS(g, mu=1e-3, cs=0.3, **kw)
    rans = KOmegaINS(g, mu=1e-3, **kw)
    les._vc.cg_tol = rans._vc.cg_tol = 1e-10
    s1 = les.initialize(u0)
    s2, tk = rans.initialize(u0, k0=1e-3, omega0=2.0)
    for _ in range(MP_LEG_STEPS):
        s1 = les.step(s1, 2e-3)
        s2, tk = rans.step(s2, tk, 2e-3)
    return (s1.u + (s1.p,) + s2.u + (tk.k, tk.omega),
            les._vc.cg_iterations + rans._vc.cg_iterations)


def _oldroyd_leg(device):
    """A sheared periodic Oldroyd-B fluid (32^2): the conformation steps
    and the polymer force through the staggered INS's ``f=``."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
    from ibamr_tpu_torch.physics.complex_fluids import OldroydB

    n = 32
    g = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    kw = dict(dtype=torch.float64, device=device)
    model = OldroydB(g, mu_p=0.1, lam=0.3, **kw)
    ins = INSStaggeredIntegrator(g, mu=0.05, **kw)
    y = (np.arange(n) + 0.5) / n
    st = ins.initialize(u0_arrays=(
        np.broadcast_to(np.sin(2 * np.pi * y)[None, :], (n, n)).copy(),
        np.zeros((n, n))))
    C = model.initialize()
    for _ in range(MP_LEG_STEPS):
        st = ins.step(st, 2e-3, f=model.body_force(C))
        C = model.step(C, st.u, 2e-3)
    return st.u + (C,), 0


def _collocated_leg(device):
    """The collocated Taylor-Green vortex (32^2, centered)."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins_collocated import (
        INSCollocatedIntegrator, advance_collocated)

    n = 32
    g = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    c = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(c, c, indexing="ij")
    integ = INSCollocatedIntegrator(g, mu=0.01, dtype=torch.float64,
                                    device=device)
    st = integ.initialize(u0_arrays=(
        np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y),
        -np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)))
    st = advance_collocated(integ, st, 5e-3, MP_LEG_STEPS)
    return st.u + (st.p,), 0


def _stochastic_leg() -> bool:
    """Fluctuating-stress moments on the card's own draws (zero net
    momentum, variance ratio 4 between dt and 4 dt from one seed) and the
    normals-to-force map against the CPU on the same normals."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.ops.stochastic import StochasticStressForcing

    g = StaggeredGrid(n=(64, 64), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    fg = StochasticStressForcing(g, mu=0.1, kT=1.0, dtype=torch.float64,
                                 device=DEVICE)
    fc = StochasticStressForcing(g, mu=0.1, kT=1.0, dtype=torch.float64,
                                 device="cpu")

    def gen(seed):
        return torch.Generator(device=DEVICE).manual_seed(seed)

    f1, f2 = fg.sample(gen(1), 1e-3), fg.sample(gen(1), 4e-3)
    net = max(abs(float(torch.sum(c))) for c in f1)
    ratio = float(torch.var(f1[0]) / torch.var(f2[0]))
    Z = fc.normals(torch.Generator().manual_seed(3))
    err = _rel64(fg.force_from_normals([z.to(DEVICE) for z in Z], 1e-3),
                 fc.force_from_normals(Z, 1e-3))
    ok = net < 1e-8 and abs(ratio - 4.0) < 1e-6 and err <= 1e-12
    log(f"[multiphase] stochastic stress on the card's draws (64^2, f64): "
        f"max|sum f_d| {net:.3e} (bound 1e-8), var ratio dt/4dt {ratio!r} "
        f"(4 within 1e-6); the same normals GPU vs CPU {err:.3e} (tol "
        f"1e-12): {ok}")
    return ok


def _channel_komega_leg() -> bool:
    """The wall-resolved k-omega channel of ``tests/test_turbulence.py:148``
    (Re_tau 395, 80 cells), ``MP_CHANNEL_ITERS`` of its 30,000 iterations:
    the card's graphed chunks against the CPU loop."""
    from ibamr_tpu_torch.physics.turbulence import channel_komega

    t0 = time.perf_counter()
    pg = channel_komega(re_tau=395.0, n=80, iters=MP_CHANNEL_ITERS,
                        device=DEVICE)
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pc = channel_komega(re_tau=395.0, n=80, iters=MP_CHANNEL_ITERS,
                        device="cpu")
    c_s = time.perf_counter() - t0
    err = _rel64(tuple(pg), tuple(pc))
    log(f"[multiphase] channel_komega (Re_tau 395, 80 cells, "
        f"{MP_CHANNEL_ITERS} iterations, f64): {g_s:.3f} s on the card (chunks of 200 "
        f"iterations replayed as CUDA graphs), {c_s:.3f} s on the CPU; "
        f"max over the profiles of max|gpu-cpu|/max|cpu| {err:.3e} (tol "
        f"{TOL_MP_F64:g})")
    return err <= TOL_MP_F64


def phase_multiphase(breakdown: bool = False) -> None:
    """Two-phase variable-coefficient flow: the dam break and both falling
    drops on their committed inputs, then one f64 leg each of the 3D
    walled drop, the VC membrane capsule, a Brinkman cylinder, the
    open-outlet wave tank, Smagorinsky and k-omega, Oldroyd-B and the
    collocated Taylor-Green on the card against the CPU, the stochastic
    forcing's moments and the k-omega channel."""
    ok = _dam_break_leg(breakdown)
    for inp in MP_DROP_INPUTS:
        ok &= _falling_drop_leg(inp)
    for label, leg in (("3D walled drop 16^3", _vc3d_leg),
                       ("VC membrane capsule 48^2", _vc_capsule_leg),
                       ("Brinkman cylinder 48^2", _brinkman_leg),
                       ("open-outlet wave tank 96x32", _wave_tank_leg),
                       ("Smagorinsky + k-omega walled 32^2",
                        _turbulence_leg),
                       ("Oldroyd-B sheared 32^2", _oldroyd_leg),
                       ("collocated Taylor-Green 32^2", _collocated_leg)):
        t0 = time.perf_counter()
        (g, g_its), (c, c_its) = leg(DEVICE), leg("cpu")
        torch.cuda.synchronize()
        err = _rel64(g, c)
        passed = (err <= TOL_MP_F64 and g_its == c_its
                  and all(bool(torch.isfinite(x).all()) for x in g))
        log(f"[multiphase] {label}, {MP_LEG_STEPS} steps at f64: "
            f"max|gpu-cpu|/max|cpu| over the fields {err:.3e} (tol "
            f"{TOL_MP_F64:g}), CG iterations {g_its} / {c_its}, "
            f"{time.perf_counter() - t0:.3f} s for both: {passed}")
        ok &= passed
    ok &= _stochastic_leg()
    ok &= _channel_komega_leg()
    if not ok:
        raise AssertionError("multiphase: a check failed (see the "
                             "[multiphase] lines)")


def _graphed_projection_bitwise(leg) -> bool:
    """The composite projection at a leg's end state through the graphed
    operators against a fresh projection on the eager flat operators."""
    from ibamr_tpu_torch.amr_ins import CompositeProjection
    from ibamr_tpu_torch.solvers.krylov import flat_operators

    integ, fl = leg["integ"], leg["state"].fluid
    graphed = integ.core.proj
    eager = CompositeProjection(integ.grid, integ.box, tol=graphed.tol,
                                m=graphed.m, restarts=graphed.restarts,
                                device=DEVICE)
    eager.flat_ops = lambda t: flat_operators(eager.operator,
                                              eager._precondition, t)
    a = graphed.project(fl.uc, fl.uf)
    b = eager.project(fl.uc, fl.uf)
    return (graphed.last_solve_stats["iters"]
            == eager.last_solve_stats["iters"]) and all(
        torch.equal(x, y) for x, y in zip(a[0] + a[1] + a[2:],
                                          b[0] + b[1] + b[2:]))


def _amr_breakdown(leg):
    """The stages of one two-level IB step at the state the ex0_amr run
    reached: interp, force, spread, the two-level predictor and the
    composite projection."""
    integ, s = leg["integ"], leg["state"]
    dt = leg["db"].get_database(
        "INSStaggeredHierarchyIntegrator").get_float("dt")
    core, fl = integ.core, s.fluid
    U = integ._interp(fl.uf, s.X, s.mask)
    F = integ.ib.compute_force(s.X, U, fl.t)
    f_c, f_f = integ._spread_two_level(F, s.X, s.mask)
    stages = [
        ("interp", lambda: integ._interp(fl.uf, s.X, s.mask)),
        ("force", lambda: integ.ib.compute_force(s.X, U, fl.t)),
        ("spread", lambda: integ._spread_two_level(F, s.X, s.mask)),
        ("projection", lambda: core.proj.project(fl.uc, fl.uf)),
        ("fluid step", lambda: core.step(fl, dt, f_c=f_c, f_f=f_f)),
    ]

    def steps3():
        st = s
        for _ in range(3):
            st = integ.step(st, dt)

    _stage_breakdown("ex0_amr", stages, steps3, 3, 1e3 / leg["warm"])


def _stage_breakdown(label, stages, steps_fn, nsteps, step_ms):
    """Each stage alone (host clock around a synchronize and the
    profiler's device busy time), then whole steps: device busy, idle
    share and the top kernels."""
    for name, fn in stages:
        host = _host_ms(fn, 5)
        dev, kernels, _ = _device_ms(fn, 2)
        log(f"[breakdown] {label} {name:14s}: host {host:.3f} ms, device "
            f"busy {dev:.3f} ms in {kernels:.0f} kernels per call")
    dev, kernels, prof = _device_ms(steps_fn, 1)
    dev, kernels = dev / nsteps, kernels / nsteps
    log(f"[breakdown] {label} whole step: device busy {dev:.3f} ms in "
        f"{kernels:.0f} kernels, of {step_ms:.3f} ms/step (timed phase): "
        f"idle share {1 - dev / step_ms:.3f}")
    rows = sorted(prof.key_averages(), key=_self_device_us, reverse=True)
    for e in rows[:8]:
        us = _self_device_us(e)
        if us <= 0:
            break
        log(f"[breakdown] {label} kernel {e.key[:70]:70s} calls/step "
            f"{e.count / nsteps:7.1f} device {us / nsteps / 1e3:.3f} ms/step")


def _graphed_solve_bitwise(ins, state) -> bool:
    """The saddle solve at ``state``, its operator and preconditioner
    replayed as CUDA graphs, against FGMRES on the eager flat operators:
    the same restarts and bitwise the same fields."""
    from ibamr_tpu_torch.solvers.krylov import fgmres_flat, flat_operators

    s = ins.solver
    rhs = s.make_rhs(f_u=tuple(ins.alpha * c for c in state.u),
                     bdry=ins.bdry)
    x0 = (state.u, state.p)
    a = s.solve(rhs, x0=x0)
    b = fgmres_flat(*flat_operators(s.operator, s.precondition, rhs), rhs,
                    x0=x0, m=s.m, tol=s.tol, restarts=s.restarts)
    u, p = b.x
    if s.p_nullspace:
        p = p - torch.mean(p)
    return a.iters == b.iters and all(
        torch.equal(x, y) for x, y in zip(a.u + (a.p,), u + (p,)))


def _restarts(integ, state, steps, step):
    """``steps`` steps by ``step(state)``; returns the state and the
    FGMRES restarts of each step's saddle solve."""
    its = []
    for _ in range(steps):
        state = step(state)
        its.append(integ.solver.last_solve_stats["iters"])
    return state, its


def phase_open(breakdown: bool = False) -> None:
    """The channel driver on the committed input as it is, then the
    cylinder driver cut to ``CYL_STEPS``, each on the card in a temporary
    working directory, with their first steps against the CPU."""
    from ibamr_tpu_torch.examples import ib_explicit_cylinder2d as cyl
    from ibamr_tpu_torch.examples import navier_stokes_channel2d as chan
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    timer = TimerManager.instance()
    db = parse_input_file(os.path.join(ROOT, CHANNEL_INPUT))
    steps = db.get_database("INSOpenIntegrator").get_int("num_steps")
    timer.reset()
    state, files = _in_tmp(lambda: chan.run(db, device=DEVICE))
    run_s = timer.get("step").total
    records = _records(files, db.get_database("Main").get_string(
        "log_jsonl"))
    grid, _, _ = chan.build(db, "cpu")
    flux_in = float(chan.poiseuille(db).sum() * grid.dx[1])
    flux_err = max(abs(r["outflow_flux"] - flux_in) / flux_in
                   for r in records)
    divs = [r["max_div"] for r in records]
    err = chan.profile_error(db, state)
    vti = sorted(f for f in files if f.endswith(".vti"))
    _, gi, gs = chan.build(db, DEVICE)
    graphed_bitwise = _graphed_solve_bitwise(gi, state)
    _, ci_, cs = chan.build(db, "cpu")
    gs, g_its = _restarts(gi, gs, OPEN_PARITY_STEPS, gi.step)
    cs, c_its = _restarts(ci_, cs, OPEN_PARITY_STEPS, ci_.step)
    eu = max(_rel(a, b) for a, b in zip(gs.u, cs.u))
    ep = _rel(gs.p, cs.p)
    log(f"[open] {CHANNEL_INPUT} on {torch.cuda.get_device_name(0)}: grid "
        f"{grid.n}, {steps} steps, f32: {steps / run_s:.3f} steps/s, "
        f"{1e3 * run_s / steps:.3f} ms/step (host clock around each step; "
        f"one host read per FGMRES restart)")
    log(f"[open] developed-profile error vs Poiseuille: {err:.2e} ({err!r};"
        f" the reference driver's {CHANNEL_PROFILE_ERR!r}); outflow "
        f"flux {[r['outflow_flux'] for r in records]} vs inflow {flux_in:.8f}"
        f" (max rel. error {flux_err:.3e}); max|div u| {divs} (bound "
        f"{OPEN_DIV_BOUND:g}); viz {len(vti)} files; the saddle solve at "
        f"the end state with its operator and preconditioner replayed as "
        f"CUDA graphs bitwise equal to eager FGMRES: {graphed_bitwise}")
    log(f"[open] first {OPEN_PARITY_STEPS} steps GPU vs CPU: FGMRES restarts "
        f"per step GPU {g_its} CPU {c_its}; max_d |u_gpu-u_cpu|/max|u|="
        f"{eu:.3e}, |p_gpu-p_cpu|/max|p|={ep:.3e} (tol {TOL_OPEN_FIELDS:g})")
    if not (abs(err - CHANNEL_PROFILE_ERR) <= 1e-3 * CHANNEL_PROFILE_ERR
            and flux_err < 1e-5
            and max(divs) < OPEN_DIV_BOUND and len(vti) == len(records)):
        raise AssertionError("open: channel profile, flux, divergence or "
                             "viz files off")
    if g_its != c_its or not (eu <= TOL_OPEN_FIELDS and ep <= TOL_OPEN_FIELDS
                              and graphed_bitwise):
        raise AssertionError("open: channel GPU and CPU steps disagree")
    ch_ms = 1e3 * run_s / steps
    if breakdown:
        _open_breakdown("channel", gi, gs, ch_ms)

    db = parse_input_file(os.path.join(ROOT, CYL_INPUT))
    db.get_database("INSOpenIntegrator").put("num_steps", CYL_STEPS)
    D = db.get_database("Cylinder").get_float("diameter")
    timer.reset()
    st, files = _in_tmp(lambda: cyl.run(db, device=DEVICE))
    run_s = timer.get("advance").total
    records = _records(files, db.get_database("Main").get_string(
        "log_jsonl"))
    integ, s0 = cyl.build(db, DEVICE)
    drift = float((st.X - s0.X).norm(dim=1).max())
    finite = all(math.isfinite(r[k]) for r in records
                 for k in ("drag", "lift", "cd"))
    viz = sorted(os.path.basename(f) for f in files
                 if f.endswith((".vti", ".vtp", ".pvd")))
    every = db.get_database("Main").get_int("viz_dump_interval")
    dumps = sorted({min(k, CYL_STEPS)
                    for k in range(every, CYL_STEPS + every, every)})
    want = sorted([f"eul_{k:06d}.vti" for k in dumps]
                  + [f"lag_{k:06d}.vtp" for k in dumps]
                  + ["eulerian.pvd", "lagrangian.pvd"])
    gi, gs = cyl.build(db, DEVICE)
    ci_, cs = cyl.build(db, "cpu")
    gs, g_its = _restarts(gi.ins, gs, OPEN_PARITY_STEPS, gi.step)
    cs, c_its = _restarts(ci_.ins, cs, OPEN_PARITY_STEPS, ci_.step)
    ex = float((gs.X.cpu() - cs.X).abs().max() / cs.X.abs().max())
    eu = max(_rel(a, b) for a, b in zip(gs.fluid.u, cs.fluid.u))
    log(f"[open] {CYL_INPUT} (num_steps cut to {CYL_STEPS}) on "
        f"{torch.cuda.get_device_name(0)}: grid {integ.grid.n}, "
        f"{s0.X.shape[0]} markers, f32: {CYL_STEPS / run_s:.3f} steps/s, "
        f"{1e3 * run_s / CYL_STEPS:.3f} ms/step over the run")
    log(f"[open] cylinder metrics {records}; max|X - X0|={drift:.4e} (bound "
        f"0.2 D = {0.2 * D:g}); viz {viz}")
    log(f"[open] cylinder first {OPEN_PARITY_STEPS} steps GPU vs CPU: FGMRES "
        f"restarts GPU {g_its} CPU {c_its}; max|X_gpu-X_cpu|/max|X|={ex:.3e}"
        f" (tol {TOL_PARITY_X:g}), max_d |u_gpu-u_cpu|/max|u|={eu:.3e} "
        f"(tol {TOL_OPEN_FIELDS:g})")
    # the same build at f64 holds its markers past the f32 divergence
    from ibamr_tpu_torch.integrators.ib_open import advance_ib_open

    i64, s64 = cyl.build(db, DEVICE, dtype=torch.float64)
    X64 = s64.X
    t0 = time.perf_counter()
    s64 = advance_ib_open(i64, s64, CYL_F64_STEPS)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    drift64 = float((s64.X - X64).norm(dim=1).max())
    F64 = s64.F_net.cpu()
    log(f"[open] cylinder at f64, {CYL_F64_STEPS} steps: drag "
        f"{-float(F64[0]):.6f}, lift {-float(F64[1]):+.3e}, max|X - X0|="
        f"{drift64:.4e}, {CYL_F64_STEPS / f64_s:.3f} steps/s")
    if not (finite and drift < 0.2 * D and viz == want
            and bool(torch.isfinite(F64).all()) and drift64 < 0.2 * D):
        raise AssertionError("open: cylinder forces, markers or viz off")
    if not (ex <= TOL_PARITY_X and eu <= TOL_OPEN_FIELDS):
        raise AssertionError("open: cylinder GPU and CPU steps disagree")
    if breakdown:
        _open_breakdown("cylinder", gi, gs, 1e3 * run_s / CYL_STEPS)
    _filament_leg(breakdown)


def _open_breakdown(label, integ, state, step_ms):
    """Stages of one open-boundary step (IB transfers, convection, the
    right-hand side, one saddle solve, and inside it the operator, the
    preconditioner and its multigrid V-cycle), then whole steps."""
    ins = getattr(integ, "ins", integ)
    fluid = getattr(state, "fluid", state)
    s = ins.solver
    advect = (ins._advect_stabilized
              if ins.convective_op_type == "stabilized_ppm" else ins._advect)
    rhs = s.make_rhs(f_u=tuple(ins.alpha * c for c in fluid.u),
                     bdry=ins.bdry)
    x = (fluid.u, fluid.p)
    stages = [("advection", lambda: advect(fluid.u)),
              ("make_rhs", lambda: s.make_rhs(f_u=fluid.u, bdry=ins.bdry)),
              ("saddle solve", lambda: s.solve(rhs, x0=x)),
              ("operator", lambda: s.operator(x)),
              # one by one; the solve replays these kernels as a graph
              ("precondition", lambda: s.precondition(x)),
              ("vcycle", lambda: s.p_mg.vcycle(fluid.p, fluid.p))]
    if integ is not ins:
        grid, ib = integ.grid, integ.ib
        u_low = integ._to_lower(fluid.u)
        F = ib.compute_force(state.X, state.U, fluid.t)
        stages = [("interp", lambda: ib.interpolate_velocity(
                      u_low, grid, state.X, state.mask)),
                  ("spread", lambda: ib.spread_force(F, grid, state.X,
                                                     state.mask))] + stages

    def steps3():
        st = state
        for _ in range(3):
            st = integ.step(st)

    _stage_breakdown(label, stages, steps3, 3, step_ms)
    log(f"[breakdown] {label} restarts of the last solve: "
        f"{s.last_solve_stats}")


def _device_ms(fn, reps: int):
    """Device busy time of one call: the profiler's sum of kernel (self
    device) time over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    return (sum(map(_self_device_us, rows)) / reps / 1e3,
            sum(e.count for e in rows) / reps, prof)


def _self_device_us(e) -> float:
    """Self device time of a profiler row that is a device kernel (the
    rows of host ops repeat their kernels' time and are not counted)."""
    if not str(getattr(e, "device_type", "")).endswith("CUDA"):
        return 0.0
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_driver(steps: int):
    """The ex4 driver on the committed north-star input, on the ``pallas``
    engine; returns the kernel launch counts of exactly the driven run,
    ms per step of the warm restarted leg, the input database it ran and
    the state it reached."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops import stencils
    from ibamr_tpu_torch.utils.checkpoint import restore_checkpoint
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager
    from ibamr_tpu_torch.utils.tree import flatten_with_path

    db = parse_input_file(os.path.join(ROOT, DRIVER_INPUT))
    with tempfile.TemporaryDirectory() as tmp:
        main = db.get_database("Main")
        for key, val in (("log_file", os.path.join(tmp, "metrics.jsonl")),
                         ("viz_dirname", os.path.join(tmp, "viz")),
                         ("restart_dirname", os.path.join(tmp, "restart")),
                         ("viz_dump_interval", steps // 2),
                         ("restart_interval", steps // 2)):
            main.put(key, val)
        db.get_database("INSStaggeredHierarchyIntegrator").put("num_steps",
                                                               steps)
        db.get_database("IBMethod").put("transfer_engine", "pallas")
        geo = db.get_database("CartesianGeometry")
        shell = db.get_database("Shell")
        log(f"[driver] {DRIVER_INPUT}: grid {geo.get_int_array('n_cells')}, "
            f"shell {shell.get_int('n_lat')}x{shell.get_int('n_lon')}, "
            f"engine pallas, {steps} steps, viz and restart every "
            f"{steps // 2}")
        timer = TimerManager.instance()
        timer.reset()
        ci.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ib_explicit_ex4.run(db, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ci.LAUNCHES)
        adv = timer.get("IB::advanceHierarchy")
        run_s, chunks = adv.total, adv.count
        with open(main.get_string("log_file")) as fh:
            lines = fh.read().splitlines()
        for ln in lines:
            log(f"[driver] metrics {ln}")
        viz = sorted(os.listdir(main.get_string("viz_dirname")))
        rst = main.get_string("restart_dirname")
        ckpts = sorted(os.listdir(rst))
        saved, k, _ = restore_checkpoint(rst, state, step=steps)
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(saved), flatten_with_path(state)))
        # a restart from the mid-run checkpoint reaches the same state
        again = ib_explicit_ex4.run(db, device=DEVICE,
                                    restart=(rst, steps // 2))
        torch.cuda.synchronize()
        err_X = float((again.X - state.X).abs().max() / state.X.abs().max())
        restart_bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(again), flatten_with_path(state)))
        # the restarted leg runs on a warm process (the first chunk of the
        # run pays the phase's one-time CUDA/cuFFT set-up)
        step_ms = 1e3 * (adv.total - run_s) / (steps - steps // 2)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.X, *state.ins.u, state.ins.p))
    dx = tuple((hi - lo) / n for lo, hi, n in zip(
        geo.get_float_array("x_lo"), geo.get_float_array("x_up"),
        geo.get_int_array("n_cells")))
    umax = max(float(c.abs().max()) for c in state.ins.u)
    div = float(stencils.divergence(state.ins.u, dx).abs().max())
    rel_div = div * dx[0] / max(umax, 1e-30)
    log(f"[driver] {torch.cuda.get_device_name(0)}: run of {steps} steps in "
        f"{chunks} chunks: {steps / run_s:.3f} steps/s, "
        f"{1e3 * run_s / steps:.3f} ms/step with the first chunk's set-up; "
        f"restarted leg of {steps - steps // 2} steps: "
        f"{1e3 / step_ms:.3f} steps/s, {step_ms:.3f} ms/step (host clock "
        f"around each chunk and its synchronizing finite check); whole "
        f"run {wall:.2f} s with build, metrics, viz and checkpoints")
    log(f"[driver] metrics lines {len(lines)}, viz files {viz}, restart "
        f"files {ckpts}; checkpoint of step {k} restored bitwise={same}; "
        f"restart from step {steps // 2}: max|X-X_run|/max|X|={err_X:.3e} "
        f"bitwise={restart_bitwise}")
    log(f"[driver] final state finite={finite}, max|div u|*dx/max|u|="
        f"{rel_div:.3e} (max|u|={umax:.3e}); kernel launches {launches} "
        f"(per step: tile_spread 3, tile_interp 6)")
    if not finite:
        raise AssertionError("driver state is not finite")
    if rel_div > 1e-4:
        raise AssertionError("driver velocity is not divergence-free")
    if launches != {**dict.fromkeys(KERNELS, 0), "tile_spread": 3 * steps,
                    "tile_interp": 6 * steps}:
        raise AssertionError(f"unexpected kernel launch counts {launches}")
    if len(lines) != chunks or not same:
        raise AssertionError("the driver's metrics log or checkpoint is "
                             "wrong")
    if not restart_bitwise:
        raise AssertionError("the restarted run does not reach the state "
                             "of the uninterrupted run bitwise")
    return launches, step_ms, db, state


DELTA_STEPS = 4           # deltas: flagship steps at FLAG_DELTA on each engine
DELTA_TIMED = 10          # deltas: warm steps timed on each engine after them
SWEEP = dict(n_cells=32, n_lat=16, n_lon=16)   # deltas: the every-delta sweep


def _fold_counter():
    """Count every tile extraction and overlap-add (the kernel engines
    fold both into their kernels); returns ``(counts, restore)``."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops import interaction_fast

    folds = {"_extract_tiles": [], "_overlap_add": []}
    real = {name: getattr(interaction_fast, name) for name in folds}

    def counted(name):
        def fn(*args, **kwargs):
            folds[name].append(1)
            return real[name](*args, **kwargs)
        return fn

    for mod in (ci, interaction_fast):
        for name in folds:
            setattr(mod, name, counted(name))

    def restore():
        for mod in (ci, interaction_fast):
            for name in folds:
                setattr(mod, name, real[name])
    return folds, restore


def phase_deltas() -> dict:
    """The flagship at FLAG_DELTA: the ex4 driver on a copy of
    ``input3d.northstar``'s database with ``IBMethod { delta_fcn =
    FLAG_DELTA; transfer_engine = "pallas_packed" }`` for DELTA_STEPS
    steps, the same steps on ``pallas`` through ``build_shell_example(
    kernel=FLAG_DELTA)`` and on the torch-op ``packed`` engine at the same
    delta; each kernel run against ``packed`` within the GPU bands, with
    3 spread and 6 interp launches a step at FLAG_DELTA and no tile
    extraction or overlap-add; then DELTA_TIMED warm steps of each, timed
    in turns. Then every delta of DELTAS through both kernel engines on
    the SWEEP shell, one step each against ``packed`` at that delta.
    Returns the launches by (kernel, delta)."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    delta = FLAG_DELTA
    counts = dict.fromkeys(ci.DELTA_LAUNCHES, 0)

    def add_counts():
        for k, v in ci.DELTA_LAUNCHES.items():
            counts[k] += v

    db = parse_input_file(os.path.join(ROOT, DRIVER_INPUT))
    built = []
    real_build = ib_explicit_ex4.build_shell_example

    def spy(*args, **kwargs):
        built.append(real_build(*args, **kwargs))
        return built[-1]

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        main = db.get_database("Main")
        for key, val in (("log_file", os.path.join(tmp, "metrics.jsonl")),
                         ("viz_dirname", os.path.join(tmp, "viz")),
                         ("restart_dirname", os.path.join(tmp, "restart")),
                         ("viz_dump_interval", 0),
                         ("restart_interval", 0)):
            main.put(key, val)
        ins_db = db.get_database("INSStaggeredHierarchyIntegrator")
        ins_db.put("num_steps", DELTA_STEPS)
        ib_db = db.get_database("IBMethod")
        ib_db.put("delta_fcn", delta)
        ib_db.put("transfer_engine", "pallas_packed")
        if ins_db.get_float("dt") != DT_FLAGSHIP:
            raise AssertionError("the north-star input's dt is not the "
                                 "flagship's")
        folds, restore = _fold_counter()
        ci.reset_launch_counts()
        ib_explicit_ex4.build_shell_example = spy
        try:
            t0 = time.perf_counter()
            state = ib_explicit_ex4.run(db, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ib_explicit_ex4.build_shell_example = real_build
            restore()
        ran = {k: ci.DELTA_LAUNCHES[(k, delta)] for k in ci.LAUNCHES}
        add_counts()
        integ = built[0][0]
        log(f"[deltas] ex4 driver on {DRIVER_INPUT} with delta_fcn {delta}, "
            f"pallas_packed: {DELTA_STEPS} steps in {wall:.2f} s (build "
            f"included), engine {integ.ib.engine_name}, delta "
            f"{integ.ib.fast.kernel}, Q={integ.ib.fast.nchunks}; launches "
            f"{ran}; tile extractions {len(folds['_extract_tiles'])}, "
            f"overlap-adds {len(folds['_overlap_add'])}")
        if integ.ib.fast.kernel != delta or integ.ib.engine_name != \
                "pallas_packed":
            raise AssertionError("the driver did not build pallas_packed "
                                 f"at {delta}")
        if ran != {**dict.fromkeys(ran, 0),
                   "packed_spread": 3 * DELTA_STEPS,
                   "packed_interp": 6 * DELTA_STEPS} \
                or folds["_extract_tiles"] or folds["_overlap_add"] \
                or sum(ci.LAUNCHES.values()) != 9 * DELTA_STEPS:
            raise AssertionError(f"the {delta} driver run launched {ran} "
                                 "or folded tiles")
        runs["pallas_packed"] = (integ, state)

    for engine in ("pallas", "packed"):
        integ, state = build_shell_example(
            kernel=delta, use_fast_interaction=engine, dtype=torch.float32,
            device=DEVICE, **FLAGSHIP)
        folds, restore = _fold_counter()
        ci.reset_launch_counts()
        try:
            for _ in range(DELTA_STEPS):
                state, _ = integ.step_with_stats(state, DT_FLAGSHIP)
            torch.cuda.synchronize()
        finally:
            restore()
        ran = {k: ci.DELTA_LAUNCHES[(k, delta)] for k in ci.LAUNCHES}
        add_counts()
        want = ({**dict.fromkeys(ran, 0), "tile_spread": 3 * DELTA_STEPS,
                 "tile_interp": 6 * DELTA_STEPS} if engine == "pallas"
                else dict.fromkeys(ran, 0))
        log(f"[deltas] {engine} at {delta} (build_shell_example): "
            f"{DELTA_STEPS} steps, launches {ran}; tile extractions "
            f"{len(folds['_extract_tiles'])}, overlap-adds "
            f"{len(folds['_overlap_add'])}")
        if ran != want or sum(ci.LAUNCHES.values()) != sum(want.values()) \
                or (engine == "pallas" and (folds["_extract_tiles"]
                                            or folds["_overlap_add"])):
            raise AssertionError(f"{engine} at {delta} launched {ran} or "
                                 "folded tiles")
        runs[engine] = (integ, state)

    ref = runs["packed"][1]
    for engine in ("pallas_packed", "pallas"):
        s = runs[engine][1]
        ex = _rel_dev(s.X, ref.X)
        eu = max(_rel_dev(a, b) for a, b in zip(s.ins.u, ref.ins.u))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (s.X, *s.ins.u, s.ins.p))
        log(f"[deltas] {engine} against packed at {delta} after "
            f"{DELTA_STEPS} flagship steps: max|dX|/max|X|={ex:.3e} (tol "
            f"{TOL_PARITY_X:g}) max_d |du|/max|u|={eu:.3e} (tol "
            f"{TOL_PARITY_U:g}) finite={finite}")
        if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U and finite):
            raise AssertionError(f"{engine} at {delta} disagrees with "
                                 "packed")

    ci.reset_launch_counts()
    ms = {k: [] for k in runs}
    for k in list(runs) + list(reversed(list(runs))):
        integ, state = runs[k]
        ms[k].append(_host_ms(lambda: integ.step_with_stats(
            state, DT_FLAGSHIP), DELTA_TIMED // 2))
    add_counts()
    log(f"[deltas] {torch.cuda.get_device_name(0)} ({SMI_LINE[0]}), "
        f"flagship at {delta}, ms/step over {DELTA_TIMED} warm steps a "
        f"leg (two halves in turns): "
        + ", ".join(f"{k} {sum(v) / len(v):.3f} ({v[0]:.3f} / {v[1]:.3f})"
                    for k, v in ms.items()))
    del runs, ref

    # every delta through both kernel engines, one step on the sweep shell
    bad = []
    for d in DELTAS:
        states = {}
        for engine in ("pallas_packed", "pallas", "packed"):
            integ, state = build_shell_example(
                kernel=d, use_fast_interaction=engine, dtype=torch.float32,
                device=DEVICE, **SWEEP)
            ci.reset_launch_counts()
            state, _ = integ.step_with_stats(state, 1e-3)
            torch.cuda.synchronize()
            ran = {k: ci.DELTA_LAUNCHES[(k, d)] for k in ci.LAUNCHES}
            add_counts()
            want = {"pallas_packed": ("packed_spread", "packed_interp"),
                    "pallas": ("tile_spread", "tile_interp")}.get(engine, ())
            if ran != {k: (3 if k.endswith("spread") else 6) * (k in want)
                       for k in ran}:
                bad.append(f"{engine} at {d} launched {ran}")
            states[engine] = state
        ref = states["packed"]
        errs = []
        for engine in ("pallas_packed", "pallas"):
            s = states[engine]
            ex = _rel_dev(s.X, ref.X)
            eu = max(_rel_dev(a, b) for a, b in zip(s.ins.u, ref.ins.u))
            errs.append(f"{engine} {ex:.2e} / {eu:.2e}")
            if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U):
                bad.append(f"{engine} at {d}: X {ex:.3e}, u {eu:.3e}")
        log(f"[deltas] sweep {d}: one step of the {SWEEP['n_cells']}^3 "
            f"shell against packed, max|dX|/max|X| / max|du|/max|u|: "
            + ", ".join(errs))
    if bad:
        raise AssertionError("delta sweep: " + "; ".join(bad))
    return counts


def phase_auto(path_ms: float, breakdown: bool = False):
    """The ex4 driver on each committed input as it is (no
    ``transfer_engine``): the engine it resolves, checked against the
    resolver, the launches of exactly that run (none: the resolved
    engines run no hand kernel), its steps/s, then AUTO_TIMED steps of
    the built integrator timed alone beside the path phase's
    ``pallas_packed``; with ``breakdown``, the profile of the flagship's
    ``packed`` step."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.models.engine_resolver import resolve_engine
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops.delta import get_kernel
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    real_build = ib_explicit_ex4.build_shell_example
    for path in AUTO_INPUTS:
        db = parse_input_file(os.path.join(ROOT, path))
        if "transfer_engine" in db.get_database("IBMethod").keys():
            raise AssertionError(f"{path} names a transfer engine")
        geo = db.get_database("CartesianGeometry")
        shell = db.get_database("Shell")
        n = tuple(geo.get_int_array("n_cells"))
        markers = shell.get_int("n_lat") * shell.get_int("n_lon")
        want = resolve_engine(
            n, markers,
            get_kernel(db.get_database("IBMethod").get_string("delta_fcn"))[0],
            spectral_dtype=db.get_database(
                "INSStaggeredHierarchyIntegrator").get_string(
                    "spectral_dtype", "f32"),
            platform="cuda")
        built = []

        def spy(*args, **kwargs):
            built.append(real_build(*args, **kwargs))
            return built[-1]

        with tempfile.TemporaryDirectory() as tmp:
            main = db.get_database("Main")
            for key, val in (("log_file", os.path.join(tmp, "metrics.jsonl")),
                             ("viz_dirname", os.path.join(tmp, "viz")),
                             ("restart_dirname", os.path.join(tmp, "rst"))):
                main.put(key, val)
            db.get_database("INSStaggeredHierarchyIntegrator").put(
                "num_steps", AUTO_STEPS)
            timer = TimerManager.instance()
            timer.reset()
            ib_explicit_ex4.build_shell_example = spy
            ci.reset_launch_counts()
            try:
                state = ib_explicit_ex4.run(db, device=DEVICE)
                torch.cuda.synchronize()
            finally:
                ib_explicit_ex4.build_shell_example = real_build
            launches = dict(ci.LAUNCHES)
            adv = timer.get("IB::advanceHierarchy")
        integ = built[0][0]
        run_sps = AUTO_STEPS / adv.total
        dt = db.get_database("INSStaggeredHierarchyIntegrator").get_float(
            "dt")
        st = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AUTO_TIMED):
            st = integ.step(st, dt)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / AUTO_TIMED
        finite = all(bool(torch.isfinite(t).all())
                     for t in (st.X, *st.ins.u, st.ins.p))
        log(f"[auto] {path} (grid {n}, {markers} markers, no "
            f"transfer_engine): resolved {integ.ib.engine_name!r} "
            f"(resolve_engine on cuda: {want!r}); {AUTO_STEPS} driver steps "
            f"{run_sps:.3f} steps/s (first chunk's set-up included), then "
            f"{AUTO_TIMED} steps alone {1e3 / step_ms:.3f} steps/s, "
            f"{step_ms:.3f} ms/step; kernel launches {launches}; "
            f"finite={finite}")
        if want == "packed":
            log(f"[auto] shoot-out datum on "
                f"{torch.cuda.get_device_name(0)}: packed "
                f"{1e3 / step_ms:.3f} steps/s vs pallas_packed "
                f"{1e3 / path_ms:.3f} steps/s (path phase) at the flagship")
        if integ.ib.engine_name != want or int(state.ins.k) != AUTO_STEPS:
            raise AssertionError(f"{path} resolved {integ.ib.engine_name!r}"
                                 f", not {want!r}, or did not run")
        if any(launches.values()) or not finite:
            raise AssertionError(f"{path}: unexpected kernel launches "
                                 f"{launches} or a state that is not finite")
        if breakdown and want == "packed":
            phase_breakdown(integ, st, step_ms, "packed")


def _warm_steps_per_s(step, state, steps):
    """``steps`` more steps of ``step`` timed by the host clock around a
    synchronize; returns (steps/s, the state reached)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0), state


def _assert_no_launches(label, fn):
    """``fn()`` with the kernel counts reset; the 2D structure paths run no
    hand kernel, so any launch fails."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    ci.reset_launch_counts()
    out = fn()
    if any(ci.LAUNCHES.values()):
        raise AssertionError(f"{label}: unexpected kernel launches "
                             f"{dict(ci.LAUNCHES)}")
    return out


def _ibfe2d_engines() -> None:
    """The IBFE 2D disc of ``tests/test_ibfe.py:195-240`` (32^2, 4 rings,
    displaced; a seeded nodal force and MAC field) through the three 2D
    engines on the card, nodal and unified: one spread and one interp
    against the scatter oracle on the card within TOL_KERNEL."""
    from ibamr_tpu_torch.fe.fem import neo_hookean
    from ibamr_tpu_torch.fe.mesh import disc_mesh
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ibfe import IBFEMethod
    from ibamr_tpu_torch.ops.interaction_fast import FastInteraction
    from ibamr_tpu_torch.ops.interaction_packed import PackedInteraction
    from ibamr_tpu_torch.ops.interaction_packed3 import PackedInteraction3

    grid = StaggeredGrid(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    engines = {
        "mxu": FastInteraction(grid, tile=8, cap=64, device=DEVICE),
        "packed": PackedInteraction(grid, tile=8, chunk=64, nchunks=32,
                                    device=DEVICE),
        "packed3": PackedInteraction3(grid, tile=8, tile_last=8, chunk=64,
                                      nchunks=64, device=DEVICE)}
    mesh = disc_mesh(radius=0.15, center=(0.5, 0.5), n_rings=4)
    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    X = torch.tensor(mesh.nodes * 1.1 - 0.05, **f32)
    F = torch.tensor(rng.standard_normal(X.shape), **f32)
    u = tuple(torch.tensor(rng.standard_normal(grid.n), **f32)
              for _ in range(2))
    mask = torch.ones(X.shape[0], **f32)
    for coupling in ("nodal", "unified"):
        oracle = IBFEMethod(mesh, neo_hookean(1.0, 4.0), coupling=coupling,
                            **f32)
        f_ref = oracle.spread_force(F, grid, X, mask)
        U_ref = oracle.interpolate_velocity(u, grid, X, mask)
        for name, eng in engines.items():
            fe = IBFEMethod(mesh, neo_hookean(1.0, 4.0), coupling=coupling,
                            fast=eng, **f32)
            ctx = fe.prepare(X, mask)
            ef = max(_rel_dev(a, b) for a, b in zip(
                fe.spread_force(F, grid, X, mask, ctx=ctx), f_ref))
            eU = _rel_dev(fe.interpolate_velocity(u, grid, X, mask,
                                                  ctx=ctx), U_ref)
            log(f"[ibfe] 2D disc ({mesh.n_nodes} nodes, {coupling}) on the "
                f"{name} engine vs the scatter oracle on the card: spread "
                f"{ef:.3e}, interp {eU:.3e} (tol {TOL_KERNEL:g}; overflow "
                f"{ctx.any_overflow})")
            if not (ef <= TOL_KERNEL and eU <= TOL_KERNEL):
                raise AssertionError(f"ibfe: the 2D {name} engine disagrees "
                                     "with the scatter oracle")


def phase_ibfe(breakdown: bool = False) -> None:
    """The IBFE ex0 driver on the committed input as it is and the beam2d
    driver with ``num_steps`` cut to ``BEAM_STEPS``, each on the card in a
    temporary working directory, with their first steps against the CPU.
    The 2D FE transfers run on the scatter oracle: no hand kernel."""
    from ibamr_tpu_torch.examples import ibfe_explicit_beam2d as beam
    from ibamr_tpu_torch.examples import ibfe_explicit_ex0 as ex0
    from ibamr_tpu_torch.integrators.ib import advance_ib
    from ibamr_tpu_torch.models.fe_disc2d import build_fe_disc_example
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    _ibfe2d_engines()
    timer = TimerManager.instance()
    db = parse_input_file(os.path.join(ROOT, IBFE_EX0_INPUT))
    ts = db.get_database("TimeStepping")
    steps, dt = ts.get_int("num_steps"), ts.get_float("dt")
    timer.reset()
    state, files = _in_tmp(lambda: ex0.run(db, device=DEVICE))
    run_s = timer.get("IBFE::step").total
    records = _records(files, db.get_database("Main").get_string(
        "log_file"))
    npy = sorted(f for f in files if f.endswith(".npy"))
    finite = all(math.isfinite(r[k]) for r in records
                 for k in ("elastic_energy", "area", "area_drift"))
    drift = max(abs(r["area_drift"]) for r in records)
    e0, e1 = records[0]["elastic_energy"], records[-1]["elastic_energy"]
    gi, gs = build_fe_disc_example(input_db=db, device=DEVICE)
    ci_, cs = build_fe_disc_example(input_db=db, device="cpu")
    gs = advance_ib(gi, gs, dt, IBFE_PARITY_STEPS)
    cs = advance_ib(ci_, cs, dt, IBFE_PARITY_STEPS)
    ex = _rel(gs.X, cs.X)
    eu = max(_rel(a, b) for a, b in zip(gs.ins.u, cs.ins.u))
    warm, gs = _warm_steps_per_s(lambda s: gi.step(s, dt), gs, IBFE_WARM)
    fe = gi.ib
    log(f"[ibfe] {IBFE_EX0_INPUT} on {torch.cuda.get_device_name(0)}: grid "
        f"{gi.ins.grid.n}, {fe.mesh.n_nodes} nodes, {fe.mesh.n_elems} TRI3 "
        f"elements ({fe.tasm.wdV.numel()} quadrature points, "
        f"{fe.coupling} coupling), {steps} steps of dt={dt:g}, f32: "
        f"{steps / run_s:.3f} steps/s over the run, {1e3 * run_s / steps:.3f}"
        f" ms/step (host clock around each step and its synchronize); "
        f"warm leg of {IBFE_WARM} steps {warm:.3f} steps/s")
    log(f"[ibfe] ex0 metrics first {records[0]} last {records[-1]}; "
        f"max|area_drift| {drift:.3e} (bound {IBFE_AREA_DRIFT}); elastic "
        f"energy {e0:.6g} -> {e1:.6g}; node dumps {len(npy)}")
    log(f"[ibfe] ex0 first {IBFE_PARITY_STEPS} steps GPU vs CPU: "
        f"max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol {TOL_PARITY_X:g}) max_d "
        f"|u_gpu-u_cpu|/max|u|={eu:.3e} (tol {TOL_PARITY_U:g})")
    if not (finite and len(records) == steps // 10 + 1
            and int(state.ins.k) == steps):
        raise AssertionError("ibfe: ex0 metrics not finite or the run "
                             "incomplete")
    if not (drift < IBFE_AREA_DRIFT and e1 < e0):
        raise AssertionError("ibfe: ex0 area not conserved or the energy "
                             "did not fall")
    if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U):
        raise AssertionError("ibfe: ex0 GPU and CPU steps disagree")
    if breakdown:
        phase_breakdown(gi, gs, 1e3 / warm, "ibfe_ex0", dt)

    db = parse_input_file(os.path.join(ROOT, BEAM_INPUT))
    db.get_database("INSOpenIntegrator").put("num_steps", BEAM_STEPS)
    db.get_database("Main").put("log_interval", BEAM_STEPS)
    ok, ms = _open_f32_and_f64("beam2d", BEAM_INPUT, db, beam, BEAM_STEPS,
                               BEAM_F64_STEPS, BEAM_PARITY_STEPS,
                               breakdown)
    g64, s64, tip, X0 = ok
    defl = float(s64.X[tip, 0] - X0[tip, 0])
    E = float(g64.ib.energy(s64.X))
    log(f"[ibfe] beam2d at f64 after {BEAM_F64_STEPS} steps: tip deflection "
        f"{defl:+.6e} (downstream: > 0), tip y {float(s64.X[tip, 1]):.6f}, "
        f"elastic energy {E:.6e}")
    if not (defl > 0.0 and math.isfinite(E)):
        raise AssertionError("ibfe: the f64 beam did not bend downstream")


def _open_f32_and_f64(label, path, db, mod, steps, f64_steps, par_steps,
                      breakdown):
    """An open-boundary structure driver (beam2d, filament2d) on the card:
    the driver as the reference runs it (f32) for ``steps`` steps with
    the FGMRES restarts of its first ``par_steps`` equal on GPU and CPU,
    then ``f64_steps`` of the same build at f64, where the saddle solve
    converges (at f32 it exhausts its restarts every step, in the
    reference too: ROADMAP C), its first ``par_steps`` against the CPU. Returns ((integrator, state, tip, X0) of
    the f64 leg, ms per f32 step); ``tip`` is None for the filament."""
    from ibamr_tpu_torch.integrators.ib_open import advance_ib_open
    from ibamr_tpu_torch.utils.timers import TimerManager

    timer = TimerManager.instance()
    timer.reset()
    st, files = _in_tmp(lambda: mod.run(db, device=DEVICE))
    run_s = timer.get("advance").total
    records = _records(files, db.get_database("Main").get_string(
        "log_jsonl"))
    finite = all(math.isfinite(v) for r in records for v in r.values()) \
        and bool(torch.isfinite(st.X).all())

    def build(dev, dtype=torch.float32):
        out = mod.build(db, dev, dtype)
        return out if len(out) == 3 else (*out, None)

    gi, gs, _ = build(DEVICE)
    ci_, cs, _ = build("cpu")
    gs, g_its = _restarts(gi.ins, gs, par_steps, gi.step)
    cs, c_its = _restarts(ci_.ins, cs, par_steps, ci_.step)
    # the unconverged f32 solve leaves only roundoff in u (max ~1e-7):
    # the fields are held GPU against CPU on the f64 leg
    noise = max(float(c.abs().max()) for c in gs.fluid.u)
    ms = 1e3 * run_s / steps
    g64, s64, tip = build(DEVICE, torch.float64)
    c64, cs64, _ = build("cpu", torch.float64)
    X0 = s64.X
    s64, its64 = _restarts(g64.ins, s64, par_steps, g64.step)
    cs64, cits64 = _restarts(c64.ins, cs64, par_steps, c64.step)
    ex = _rel(s64.X, cs64.X)
    eu = max(_rel(a, b) for a, b in zip(s64.fluid.u, cs64.fluid.u))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s64 = advance_ib_open(g64, s64, f64_steps - par_steps)
    torch.cuda.synchronize()
    ms64 = 1e3 * (time.perf_counter() - t0) / (f64_steps - par_steps)
    log(f"[{label}] {path} (num_steps cut to {steps}) on "
        f"{torch.cuda.get_device_name(0)}: grid {gi.grid.n}, "
        f"{gs.X.shape[0]} nodes, f32: {1e3 / ms:.3f} steps/s, {ms:.3f} "
        f"ms/step over the run; metrics {records}")
    log(f"[{label}] f32 first {par_steps} steps: FGMRES restarts GPU "
        f"{g_its} CPU {c_its}; max|u| {noise:.3e}, inflow face max|u| "
        f"{float(gs.fluid.u[0][0].abs().max()):.3e} (the f32 solve does "
        f"not converge)")
    log(f"[{label}] f64 leg: {f64_steps} steps; first {par_steps} GPU vs "
        f"CPU: restarts GPU {its64} CPU {cits64}, max|X_gpu-X_cpu|/max|X|="
        f"{ex:.3e} (tol {TOL_PARITY_X:g}), max_d |u_gpu-u_cpu|/max|u|="
        f"{eu:.3e} (tol {TOL_OPEN_FIELDS:g}); {1e3 / ms64:.3f} steps/s "
        f"({ms64:.3f} ms/step after them); inflow face max|u| "
        f"{float(s64.fluid.u[0][0].abs().max()):.6f}")
    if not finite:
        raise AssertionError(f"{label}: the f32 run is not finite")
    if g_its != c_its or its64 != cits64 or not (
            ex <= TOL_PARITY_X and eu <= TOL_OPEN_FIELDS):
        raise AssertionError(f"{label}: GPU and CPU steps disagree")
    if breakdown:
        _open_breakdown(f"{label}_f64", g64, s64, ms64)
    return (g64, s64, tip, X0), ms


def _ibfe3d(engine: str, device):
    """The 3D FE membrane of the ``ibfe3d`` leg on ``device``: the
    integrator with ``engine`` (None: the scatter oracle), its state and
    the FE strategy."""
    from ibamr_tpu_torch.fe.surface import (neo_hookean_membrane,
                                            sphere_surface_mesh,
                                            surface_quad_positions)
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ib import IBExplicitIntegrator
    from ibamr_tpu_torch.integrators.ibfe import IBFESurfaceMethod
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
    from ibamr_tpu_torch.models.shell3d import construct_transfer_engine

    n = IBFE3D["n_cells"]
    grid = StaggeredGrid(n=(n,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    mesh = sphere_surface_mesh(center=(0.5,) * 3, radius=IBFE3D["radius"],
                               n_subdiv=IBFE3D["n_subdiv"])
    c = np.asarray((0.5,) * 3)
    X0 = c + (mesh.nodes - c) * np.asarray(IBFE3D["stretch"])
    W = neo_hookean_membrane(*IBFE3D["moduli"])
    plain = IBFESurfaceMethod(mesh, W, coupling="unified",
                              dtype=torch.float32, device=device)
    fast = None
    if engine is not None:
        xq = surface_quad_positions(plain.asm, torch.as_tensor(
            X0, dtype=torch.float32, device=device))
        fast = construct_transfer_engine(engine, grid, xq.cpu().numpy(),
                                         "IB_4", device=device)
    fe = IBFESurfaceMethod(mesh, W, coupling="unified", dtype=torch.float32,
                           fast=fast, device=device)
    ins = INSStaggeredIntegrator(grid, rho=1.0, mu=IBFE3D["mu"],
                                 dtype=torch.float32, device=device)
    integ = IBExplicitIntegrator(ins, fe)
    return integ, integ.initialize(X0), fe


def phase_ibfe3d(breakdown: bool = False) -> dict:
    """The hand kernels on an FE cloud: the TRI3S quadrature points of a
    geodesic sphere membrane in a 128^3 periodic box. For each kernel
    engine: one spread of a seeded nodal force and one interp of a seeded
    MAC field against the scatter oracle on the card (twice, bitwise),
    then ``IBFE3D_STEPS`` coupled midpoint steps on the GPU (kernels)
    against the same steps on the CPU through the scatter oracle, with the
    launches per step.
    Returns the launches of the coupled steps."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    rng = np.random.default_rng(IBFE3D["seed"])
    launches = dict.fromkeys(KERNELS, 0)
    oi, s_or, oracle = _ibfe3d(None, DEVICE)
    g = oi.ins.grid
    grid = g.n
    N = oracle.mesh.n_nodes
    F = torch.tensor(rng.standard_normal((N, 3)), dtype=torch.float32,
                     device=DEVICE)
    u = tuple(torch.tensor(rng.standard_normal(grid), dtype=torch.float32,
                           device=DEVICE) for _ in range(3))
    X, mask = s_or.X, s_or.mask
    f_ref = oracle.spread_force(F, g, X, mask)
    U_ref = oracle.interpolate_velocity(u, g, X, mask)
    nq = oracle.asm.wdA.numel()
    log(f"[ibfe3d] sphere_surface_mesh(n_subdiv={IBFE3D['n_subdiv']}, "
        f"radius={IBFE3D['radius']}): {N} nodes, {oracle.mesh.elems.shape[0]}"
        f" TRI3S facets, {nq} quadrature points (unified coupling), "
        f"stretched by {IBFE3D['stretch']}, neo_hookean_membrane"
        f"{IBFE3D['moduli']}, {grid} periodic grid, f32")
    # the CPU leg: the scatter oracle (the engines' plain versions
    # evaluate every slot's weights over its whole tile column, minutes
    # per 128^3 step on the CPU)
    ci_, cs, _ = _ibfe3d(None, "cpu")
    s_cpu0 = cs
    for _ in range(IBFE3D_STEPS):
        cs = ci_.step(cs, IBFE3D["dt"])
    for engine, kernels in (("pallas_packed", ("packed_spread",
                                               "packed_interp")),
                            ("pallas", ("tile_spread", "tile_interp"))):
        gi, gs, fe = _ibfe3d(engine, DEVICE)
        b = fe.prepare(gs.X, gs.mask)
        cap = (f"{fe.fast.nchunks} chunks of 128" if engine == "pallas_packed"
               else f"tile cap {b.Xb.shape[1]}")
        ci.reset_launch_counts()
        f1, f2 = (fe.spread_force(F, g, X, mask, ctx=b) for _ in range(2))
        U1, U2 = (fe.interpolate_velocity(u, g, X, mask, ctx=b)
                  for _ in range(2))
        torch.cuda.synchronize()
        once = dict(ci.LAUNCHES)
        ef = max(float((a - r).abs().max() / r.abs().max())
                 for a, r in zip(f1, f_ref))
        eU = float((U1 - U_ref).abs().max() / U_ref.abs().max())
        bitwise = (all(torch.equal(p, q) for p, q in zip(f1, f2))
                   and torch.equal(U1, U2))
        log(f"[ibfe3d] {engine} ({cap}; overflow {b.any_overflow}): spread "
            f"vs oracle max|.|/max|oracle| {ef:.3e}, interp {eU:.3e} (tol "
            f"{TOL_KERNEL:g}), bitwise run-to-run {bitwise}, launches of "
            f"two spreads and two interps {once}")
        if b.any_overflow:
            raise AssertionError(f"ibfe3d: the FE cloud overflows {engine}")
        if not (ef <= TOL_KERNEL and eU <= TOL_KERNEL and bitwise):
            raise AssertionError(f"ibfe3d: {engine} disagrees with the "
                                 "oracle or is not run-to-run bitwise")
        if not all(once[k] == 6 for k in kernels):
            raise AssertionError(f"ibfe3d: {engine} did not launch its "
                                 f"kernels {kernels}")
        gs = _to(s_cpu0, DEVICE)
        per_step = []
        ci.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(IBFE3D_STEPS):
            before = dict(ci.LAUNCHES)
            gs = gi.step(gs, IBFE3D["dt"])
            per_step.append({n: ci.LAUNCHES[n] - before[n] for n in before
                             if ci.LAUNCHES[n] != before[n]})
            if k == 0:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ran = dict(ci.LAUNCHES)
        launches = {k: launches[k] + ran[k] for k in launches}
        ex = _rel(gs.X, cs.X)
        eu = max(_rel(a, b_) for a, b_ in zip(gs.ins.u, cs.ins.u))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (gs.X, *gs.ins.u, gs.ins.p))
        ms = 1e3 * (t2 - t1) / (IBFE3D_STEPS - 1)
        log(f"[ibfe3d] {engine}: {IBFE3D_STEPS} midpoint steps dt="
            f"{IBFE3D['dt']:g}: {ms:.3f} ms/step after the first "
            f"({1e3 * (t1 - t0):.3f} ms); vs the CPU oracle: "
            f"max|X_gpu-X_cpu|/max|X|={ex:.3e} "
            f"(tol {TOL_PARITY_X:g}) max_d |u_gpu-u_cpu|/max|u|={eu:.3e} "
            f"(tol {TOL_PARITY_U:g}) finite={finite}; kernel launches per "
            f"step {per_step}")
        if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U and finite):
            raise AssertionError(f"ibfe3d: GPU and CPU steps disagree on "
                                 f"{engine}")
        want = {kernels[0]: 3, kernels[1]: 6}
        if any(p != want for p in per_step):
            raise AssertionError(f"ibfe3d: {engine} launched {per_step}, "
                                 f"not {want} per step")
        if breakdown:
            phase_breakdown(gi, gs, ms, f"ibfe3d_{engine}", IBFE3D["dt"])
    return launches


def phase_rigid(breakdown: bool = False) -> None:
    """The CIB ex0 driver on the committed input cut to ``CIB_STEPS``, the
    oscillating cylinder's committed input cut to its first constraint
    solves at f64, and the eel2d driver on the committed
    input, each on the card, with their first steps against the CPU.
    The rigid-body transfers run on the scatter oracle: no hand kernel."""
    from ibamr_tpu_torch.examples import cib_ex0
    from ibamr_tpu_torch.examples import cib_oscillating_cylinder as osc
    from ibamr_tpu_torch.examples import constraint_ib_eel2d as eel
    from ibamr_tpu_torch.integrators.cib import body_centroids
    from ibamr_tpu_torch.integrators.constraint_ib import \
        advance_constraint_ib
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    timer = TimerManager.instance()
    db = parse_input_file(os.path.join(ROOT, CIB_INPUT))
    db.get_database("TimeStepping").put("num_steps", CIB_STEPS)
    steps = db.get_database("TimeStepping").get_int("num_steps")
    dt = db.get_database("TimeStepping").get_float("dt")
    timer.reset()
    _, files = _in_tmp(lambda: cib_ex0.run(db, device=DEVICE))
    run_s = timer.get("CIB::step").total
    records = _records(files, db.get_database("Main").get_string(
        "log_file"))
    ys = [r["centroid"][1] for r in records]
    Uy = [r["U"][1] for r in records]
    iters = [r["cg_iters"] for r in records]
    conv = [r["cg_converged"] for r in records]
    finite = all(math.isfinite(v) for r in records
                 for v in r["U"] + r["centroid"])
    # GPU vs CPU: CIB_PARITY_STEPS steps at f64 (at f32 the CG ends on
    # the f32 floor, where roundoff sets the last digits of U)
    par = {}
    for dev in (DEVICE, "cpu"):
        m, X, bodies, FT = cib_ex0.build(db, dev, torch.float64)
        Us, its = [], []
        for _ in range(CIB_PARITY_STEPS):
            X, U, info = m.step(X, FT, dt)
            Us.append(U.cpu())
            its.append((info.max_iters, bool(info.converged)))
        par[dev] = (torch.stack(Us), its)
    eU = _rel(par[DEVICE][0], par["cpu"][0])
    n_cells = db.get_database("CartesianGeometry").get_int_array("n_cells")
    log(f"[rigid] {CIB_INPUT} (num_steps cut to {CIB_STEPS}) on "
        f"{torch.cuda.get_device_name(0)}: "
        f"{n_cells} periodic, "
        f"{db.get_database('Body').get_int('num_markers')} "
        f"markers, {steps} steps of dt={dt:g}, f32: {steps / run_s:.3f} "
        f"steps/s, {1e3 * run_s / steps:.3f} ms/step (3 CG solves per step,"
        f" {sum(iters) * 3 / run_s:.1f} CG iterations/s, one host read "
        f"each); CG iterations per step {sorted(set(iters))}, converged "
        f"{sorted(set(conv))} (the reference's: 400, False in both of "
        f"JAX's modes)")
    log(f"[rigid] cib_ex0 centroid y {ys[0]:.7f} -> {ys[-1]:.7f}, U_y "
        f"{min(Uy):.7f} .. {max(Uy):.7f}; first {CIB_PARITY_STEPS} steps at "
        f"f64 GPU vs CPU: max|U_gpu-U_cpu|/max|U|={eU:.3e} (tol "
        f"{TOL_RIGID_U:g}), CG (iterations, converged) GPU "
        f"{par[DEVICE][1]} CPU {par['cpu'][1]}")
    if not (finite and len(records) == steps and max(Uy) < 0.0
            and all(b < a for a, b in zip(ys, ys[1:]))):
        raise AssertionError("cib_ex0: not finite, incomplete, or the disc "
                             "did not fall at every step")
    if not (eU <= TOL_RIGID_U and par[DEVICE][1] == par["cpu"][1]):
        raise AssertionError("cib_ex0: GPU and CPU steps disagree")

    def osc_step1(db, dev):
        """The oscillation's first constraint solve: (fx, fy, CG
        iterations, converged, seconds)."""
        method, X = osc.build(db, dev)
        t, u, xoff = osc.phase(db, 0)
        Xk = X + torch.tensor([xoff, 0.0], dtype=X.dtype, device=X.device)
        U = torch.tensor([[u, 0.0, 0.0]], dtype=X.dtype, device=X.device)
        t0 = time.perf_counter()
        _, FT, info = method.solve_constraint(Xk, U)
        fx, fy, _ = FT[0].tolist()
        return (fx, fy, info.max_iters, bool(info.converged),
                time.perf_counter() - t0)

    db = parse_input_file(os.path.join(ROOT, OSC_INPUT))
    fx, fy, its, conv, sec = osc_step1(db, DEVICE)
    efx = abs(fx - OSC_REF[0]) / abs(OSC_REF[0])
    log(f"[rigid] {OSC_INPUT} (the committed body, its 80 steps cut to the "
        f"first, f64) on {torch.cuda.get_device_name(0)}: {sec:.3f} s per "
        f"constraint solve (walled: a saddle FGMRES in every CG iteration),"
        f" CG iterations {its}, converged {conv} (the reference's: "
        f"{OSC_REF[1]}); fx {fx!r} against the reference's {OSC_REF[0]!r}: "
        f"rel {efx:.3e} (tol {TOL_RIGID_FX:g}); |fy| {abs(fy):.3e} (bound "
        f"0.05 |fx| = {0.05 * abs(fx):.3e})")
    db.get_database("Body").put("n_markers", OSC_MARKERS)
    g12, c12 = (osc_step1(db, dev) for dev in (DEVICE, "cpu"))
    e12 = abs(g12[0] - c12[0]) / abs(c12[0])
    log(f"[rigid] oscillating cylinder, markers cut 48 -> {OSC_MARKERS}, "
        f"step 1 GPU vs CPU: fx {g12[0]!r} vs {c12[0]!r}, |dfx|/|fx|="
        f"{e12:.3e} (tol {TOL_RIGID_FX:g}); CG (iterations, converged) GPU "
        f"{g12[2:4]} CPU {c12[2:4]}; s per solve GPU {g12[4]:.3f} CPU "
        f"{c12[4]:.3f}")
    if not (conv == OSC_REF[1] and efx <= TOL_RIGID_FX
            and abs(fy) < 0.05 * abs(fx)):
        raise AssertionError("oscillating cylinder: the committed body's "
                             "solve disagrees with the reference's, or "
                             "the transverse force is large")
    if not (g12[3] and e12 <= TOL_RIGID_FX and g12[2:4] == c12[2:4]):
        raise AssertionError("oscillating cylinder: GPU and CPU disagree")
    osc_gpu = osc.build(db, DEVICE) if breakdown else None

    db = parse_input_file(os.path.join(ROOT, EEL_INPUT))
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    idb.put("num_steps", EEL_STEPS)
    steps, dt = idb.get_int("num_steps"), idb.get_float("dt")
    timer.reset()
    st, files = _in_tmp(lambda: eel.run(db, device=DEVICE))
    run_s = timer.get("advance").total
    records = _records(files, db.get_database("Main").get_string(
        "log_jsonl"))
    dxs = [r["swim_dx"] for r in records]
    finite = all(math.isfinite(v) for r in records for v in r["U_body"])
    gm, gs = eel.build(db, DEVICE)
    cm, cs = eel.build(db, "cpu")
    gs = advance_constraint_ib(gm, gs, dt, EEL_PARITY_STEPS)
    cs = advance_constraint_ib(cm, cs, dt, EEL_PARITY_STEPS)
    ex = _rel(gs.X, cs.X)
    eu = max(_rel(a, b) for a, b in zip(gs.ins.u, cs.ins.u))
    log(f"[rigid] {EEL_INPUT} on {torch.cuda.get_device_name(0)}: grid "
        f"{gm.ins.grid.n}, {st.X.shape[0]} markers, {steps} steps of "
        f"dt={dt:g}, f32: {steps / run_s:.3f} steps/s, "
        f"{1e3 * run_s / steps:.3f} ms/step over the run; swim_dx every "
        f"{db.get_database('Main').get_int('log_interval')} steps "
        f"{[round(v, 5) for v in dxs]}; final U_body "
        f"{records[-1]['U_body']}; centroid "
        f"{body_centroids(st.X, gm.bodies)[0].tolist()}")
    log(f"[rigid] eel2d first {EEL_PARITY_STEPS} steps GPU vs CPU: "
        f"max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol {TOL_PARITY_X:g}) max_d "
        f"|u_gpu-u_cpu|/max|u|={eu:.3e} (tol {TOL_PARITY_U:g})")
    if not (finite and dxs[-1] < 0.0 and int(st.ins.k) == steps):
        raise AssertionError("eel2d: not finite, incomplete, or the "
                             "swimmer did not move against the wave")
    if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U):
        raise AssertionError("eel2d: GPU and CPU steps disagree")
    if breakdown:
        _rigid_breakdown(*osc_gpu, gm, gs, dt, 1e3 * run_s / steps)


def _rigid_breakdown(cib_method, X, eel_method, eel_state, dt, eel_ms):
    """Stages of the walled mobility apply (one nested saddle solve) and
    of one eel step (fluid, interp, rigid projection, imposition,
    projection), then whole eel steps."""
    from ibamr_tpu_torch.integrators.constraint_ib import project_rigid
    from ibamr_tpu_torch.ops import interaction

    lam = torch.ones_like(X)
    _stage_breakdown("oscillating_cylinder", [
        ("mobility apply", lambda: cib_method.mobility_apply(X, lam))],
        lambda: cib_method.mobility_apply(X, lam), 1, float("nan"))
    m, s = eel_method, eel_state
    g = m.ins.grid
    U = interaction.interpolate_vel(s.ins.u, g, s.X)
    stages = [("fluid", lambda: m.ins.step(s.ins, dt)),
              ("interp", lambda: interaction.interpolate_vel(s.ins.u, g,
                                                             s.X)),
              ("project_rigid", lambda: project_rigid(s.X, m.bodies, U)),
              ("impose", lambda: m._impose(s.ins.u, s.X, U)),
              ("projection", lambda: m.ins.project(s.ins.u, g.dx))]

    def steps3():
        st = s
        for _ in range(3):
            st = m.step(st, dt)

    _stage_breakdown("eel2d", stages, steps3, 3, eel_ms)


def _filament_leg(breakdown: bool = False) -> None:
    """The filament2d driver cut to ``FIL_STEPS`` at f32 against the CPU,
    then ``FIL_F64_STEPS`` at f64 (finite, the tail downstream of the
    anchor), and the length held within 5% on the configuration of
    ``tests/test_examples_r5.py:78``, which sets that bound."""
    from ibamr_tpu_torch.examples import ib_explicit_filament2d as fil
    from ibamr_tpu_torch.integrators.ib_open import advance_ib_open
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    db = parse_input_file(os.path.join(ROOT, FIL_INPUT))
    db.get_database("INSOpenIntegrator").put("num_steps", FIL_STEPS)
    (g64, s64, _, X0), _ = _open_f32_and_f64(
        "open", FIL_INPUT, db, fil, FIL_STEPS, FIL_F64_STEPS,
        FIL_PARITY_STEPS, breakdown)

    def length(X):
        return float(torch.linalg.norm(X[1:] - X[:-1], dim=1).sum())

    L0, L1 = length(X0), length(s64.X)
    ax = db.get_database("Filament").get_float_array("anchor")[0]
    tail = s64.X[-1].tolist()
    # the length bound on the configuration of the test that sets it
    # (tests/test_examples_r5.py:78-120: 64x32, 24 markers, dt 2e-3,
    # tol 1e-8, 300 steps, f64; the reference measured +4.0% there)
    db.get_database("CartesianGeometry").put("n", [64, 32])
    idb = db.get_database("INSOpenIntegrator")
    for key, val in (("mu", 0.01), ("dt", 2e-3), ("tol", 1e-8),
                     ("convective_op_type", "upwind")):
        idb.put(key, val)
    db.get_database("Filament").put("n_markers", 24)
    t_integ, t_st = fil.build(db, DEVICE, torch.float64)
    T0 = t_st.X
    t_st = advance_ib_open(t_integ, t_st, FIL_LENGTH_STEPS)
    T1 = length(t_st.X) / length(T0) - 1.0
    log(f"[open] filament at f64 after {FIL_F64_STEPS} steps: tail {tail} "
        f"(anchor x {ax}), length {L0:.6f} -> {L1:.6f} "
        f"({(L1 - L0) / L0:+.3e}), drag {-float(s64.F_net[0]):.6f}; on the "
        f"configuration of tests/test_examples_r5.py:78 after "
        f"{FIL_LENGTH_STEPS} steps the length changes by {T1:+.4e} (bound "
        f"0 < . < 0.05; the reference: +4.0%)")
    if not (math.isfinite(L1) and tail[0] > ax and 0.0 < T1 < 0.05):
        raise AssertionError("open: filament not finite, the tail not "
                             "downstream, or the length not held")


def phase_breakdown(integ, state, step_ms: float, label: str,
                    dt: float = DT_FLAGSHIP) -> None:
    """Where a step's time goes: each stage of ``step_with_stats`` alone
    on the state a timed phase reached (host clock around a synchronize,
    and the profiler's device busy time), then the top kernels of whole
    steps and the device's idle share. An engine without a refresh
    buckets twice per step; the scatter oracle (no engine) buckets not at
    all."""
    ib, grid, s = integ.ib, integ.ins.grid, state
    ctx = ib.prepare(s.X, s.mask)
    U = ib.interpolate_velocity(s.ins.u, grid, s.X, s.mask, ctx=ctx)
    Xh = s.X + 0.5 * dt * U
    refresh = hasattr(ib, "refresh") and hasattr(ib.fast, "refresh")
    ctx_h = ib.refresh(ctx, Xh, s.mask)[0] if refresh else \
        ib.prepare(Xh, s.mask)
    F = ib.compute_force(Xh, U, s.ins.t)
    f = ib.spread_force(F, grid, Xh, s.mask, ctx=ctx_h)
    stages = [("pack", 1, lambda: ib.prepare(s.X, s.mask)),
              ("refresh", 1, lambda: ib.refresh(ctx, Xh, s.mask))] \
        if refresh else [("bucket", 2, lambda: ib.prepare(s.X, s.mask))] \
        if ib.fast is not None else []
    stages += [
        ("interp", 2, lambda: ib.interpolate_velocity(
            s.ins.u, grid, s.X, s.mask, ctx=ctx)),
        ("force", 1, lambda: ib.compute_force(Xh, U, s.ins.t)),
        ("spread", 1, lambda: ib.spread_force(F, grid, Xh, s.mask,
                                              ctx=ctx_h)),
        ("fluid", 1, lambda: integ.ins.step(s.ins, dt, f=f)),
    ]
    for name, per_step, fn in stages:
        host = _host_ms(fn, 10)
        dev, kernels, _ = _device_ms(fn, 3)
        log(f"[breakdown] {label} {name:8s} x{per_step}/step: host "
            f"{host:.3f} ms, "
            f"device busy {dev:.3f} ms in {kernels:.0f} kernels per call")

    def steps3():
        st = s
        for _ in range(3):
            st, _ = integ.step_with_stats(st, dt)

    dev, kernels, prof = _device_ms(steps3, 1)
    dev, kernels = dev / 3, kernels / 3
    log(f"[breakdown] {label} whole step: device busy {dev:.3f} ms in "
        f"{kernels:.0f} kernels, of {step_ms:.3f} ms/step (timed phase): "
        f"idle share {1 - dev / step_ms:.3f}")
    rows = sorted(prof.key_averages(), key=_self_device_us, reverse=True)
    for e in rows[:15]:
        us = _self_device_us(e)
        if us <= 0:
            break
        log(f"[breakdown] {label} kernel {e.key[:70]:70s} calls/step "
            f"{e.count / 3:6.1f} device {us / 3e3:.3f} ms/step")


RES_STEPS, RES_RESTART, RES_CHUNK = 40, 10, 5   # resilience: supervised run
RES_NAN_STEP = 23         # the dt-gated NaN lands in the chunk 20..25
RES_WARM = 20             # resilience: warm steps of each timing leg


def _supervised_flagship(tmp: str) -> dict:
    """The flagship on ``pallas_packed`` under the whole supervised run
    loop: ResilientDriver + HierarchyDriver with the health probe, the
    flight recorder, the f64 shadow audit every 2 chunks, the async
    checkpoint writer and the watchdog, under a run ledger, with a
    recorded dt-gated NaN in the fluid velocity at step 23. Then the
    incident's capsule replayed on the card."""
    from ibamr_tpu_torch import obs
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.solvers.escalation import ShadowAuditor
    from ibamr_tpu_torch.tools.fault_injection import (nan_injector_step,
                                                       recorded)
    from ibamr_tpu_torch.tools.replay import replay
    from ibamr_tpu_torch.utils.flight_recorder import (FlightRecorder,
                                                       factory_spec)
    from ibamr_tpu_torch.utils.health import HealthProbe
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver
    from ibamr_tpu_torch.utils.watchdog import RunWatchdog, read_heartbeat

    kwargs = dict(use_fast_interaction="pallas_packed", dtype="float32",
                  device=DEVICE, **FLAGSHIP)
    integ, st0 = build_shell_example(**dict(kwargs, dtype=torch.float32))
    dt0 = DT_FLAGSHIP
    cfg = RunConfig(dt=dt0, num_steps=RES_STEPS,
                    restart_interval=RES_RESTART, health_interval=RES_CHUNK)
    inj = dict(at_step=RES_NAN_STEP, leaf_path="u[0]", dt_gate=dt0 * 0.99,
               step_attr="ins.k")
    rec = FlightRecorder(capacity=4, spec=factory_spec(
        "ibamr_tpu_torch.models.shell3d", "build_shell_example", **kwargs))
    audit = ShadowAuditor(every=2)
    ckdir, ledger = os.path.join(tmp, "run"), os.path.join(tmp, "ledger.jsonl")
    with recorded("nan", **inj):
        drv = HierarchyDriver(integ, cfg,
                              step_fn=nan_injector_step(integ.step, **inj),
                              health_probe=HealthProbe.for_integrator(integ),
                              recorder=rec, shadow_audit=audit)
        sup = ResilientDriver(
            drv, ckdir, max_retries=2, dt_backoff=0.5, handle_signals=False,
            watchdog=RunWatchdog(heartbeat_path=ckdir, interval_s=0.5,
                                 min_stall_s=120.0))
        ci.reset_launch_counts()
        t0 = time.perf_counter()
        with obs.ledger(ledger, fingerprint=rec.fingerprint(drv)):
            out = sup.run(st0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = dict(ci.LAUNCHES)
    div = [r for r in sup.incidents if r["event"] == "divergence"]
    others = [r["event"] for r in sup.incidents if r["event"] != "divergence"]
    k = int(out.ins.k)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out.X, *out.ins.u, out.ins.p))
    recs = obs.read_ledger(ledger)
    spans = [r for r in recs if r["kind"] == "span"
             and r.get("name") == "driver/chunk"]
    bounds = [r for r in recs if r["kind"] == "counters"]
    hb = read_heartbeat(os.path.join(ckdir, "heartbeat.json"))
    # the failing attempt runs to the end of the chunk holding the NaN,
    # the capsule's post digest re-runs that chunk, the retry runs from
    # the step-20 checkpoint to the end
    fail_end = (RES_NAN_STEP // RES_CHUNK + 1) * RES_CHUNK
    steps_run = fail_end + RES_CHUNK + (RES_STEPS - 2 * RES_RESTART)
    log(f"[resilience] supervised flagship: {run_s:.2f} s for "
        f"{RES_STEPS} steps with one rollback ({steps_run} steps stepped, "
        f"the capsule's re-execution included); incidents "
        f"{[(r['event'], r.get('kind'), r.get('step'), r.get('rollback_step'), r.get('dt_after')) for r in sup.incidents]}; "
        f"final step {k}, finite={finite}; shadow audits "
        f"{[(a['step'], a['spectral_dtype'], round(a['drift'], 9)) for a in audit.history]}; "
        f"ledger: {len(recs)} records, {len(spans)} driver/chunk spans, "
        f"{len(bounds)} chunk boundaries; heartbeat step "
        f"{hb and hb.get('step')}; launches {launches}")
    t0 = time.perf_counter()
    cap = div[0]["replay"] if div else None
    ci.reset_launch_counts()
    res = replay(cap) if cap else {"verdict": None, "bitwise": False}
    replayed = dict(ci.LAUNCHES)
    log(f"[resilience] capsule {cap} replayed on the card in "
        f"{time.perf_counter() - t0:.2f} s: verdict {res['verdict']}, "
        f"bitwise {res['bitwise']}, launches {replayed}")
    ok = (len(div) == 1 and div[0]["rollback_step"] == 2 * RES_RESTART
          and not others and k == RES_STEPS and finite
          and audit.audits >= 1
          and all(a["drift"] <= audit.bound for a in audit.history)
          and spans and bounds and res["verdict"] == "reproduced"
          and res["bitwise"]
          and launches == {**dict.fromkeys(KERNELS, 0),
                           "packed_spread": 3 * steps_run,
                           "packed_interp": 6 * steps_run}
          and replayed["packed_spread"] == 3 * RES_CHUNK)
    if not ok:
        raise AssertionError("the supervised flagship run missed one of its "
                             "checks (see the log lines above)")
    return dict(integ=integ, state=out,
                launches={k: launches[k] + replayed[k] for k in launches})


def _supervised_speed(integ, state, tmp: str) -> None:
    """Warm steps/s of the flagship: a plain loop of steps, then the
    driver with one layer added at a time (chunks and their one read;
    the probe; the recorder; the audit every 2 chunks, i.e. supervised,
    under a ledger), in turns; the recorder's snapshot and the ledger's
    shares of the supervised wall."""
    from ibamr_tpu_torch import obs
    from ibamr_tpu_torch.solvers.escalation import ShadowAuditor
    from ibamr_tpu_torch.utils.flight_recorder import FlightRecorder
    from ibamr_tpu_torch.utils.health import HealthProbe
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)

    def plain():
        s = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RES_WARM):
            s = integ.step(s, DT_FLAGSHIP)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, {}

    def driven(layers, i):
        rec = FlightRecorder(capacity=4) if layers >= 3 else None
        drv = HierarchyDriver(
            integ, RunConfig(dt=DT_FLAGSHIP, num_steps=RES_WARM,
                             health_interval=RES_CHUNK),
            health_probe=(HealthProbe.for_integrator(integ)
                          if layers >= 2 else None),
            recorder=rec,
            shadow_audit=ShadowAuditor(2) if layers >= 4 else None)
        torch.cuda.synchronize()
        with obs.ledger(os.path.join(tmp, f"warm{layers}{i}.jsonl")) as led:
            t0 = time.perf_counter()
            drv.run(state)
            wall = time.perf_counter() - t0
        return wall, dict(snap=rec.overhead_s if rec else 0.0,
                          ledger=led.overhead_s, reads=drv.host_reads)

    legs = [("plain loop", plain)] + [
        (name, lambda i, k=k: driven(k, i)) for k, name in
        ((1, "driver (chunks, one read each)"), (2, "+ health probe"),
         (3, "+ flight recorder"), (4, "+ shadow audit = supervised"))]
    plain()
    walls = {name: [] for name, _ in legs}
    for i in range(2):
        for name, fn in (legs if i == 0 else legs[::-1]):
            wall, info = fn(i) if name != "plain loop" else fn()
            walls[name].append(wall)
            if info and info["reads"] != RES_WARM // RES_CHUNK:
                raise AssertionError("the driver read more than once a "
                                     "chunk")
            if name.endswith("supervised"):
                log(f"[resilience] supervised leg: snapshot host share "
                    f"{info['snap'] / wall:.5f}, ledger share "
                    f"{info['ledger'] / wall:.5f}, {info['reads']} host "
                    f"reads for {RES_WARM // RES_CHUNK} chunks")
    base = min(walls["plain loop"])
    for name, ws in walls.items():
        w = min(ws)
        log(f"[resilience] warm flagship, {name}: "
            f"{RES_WARM / w:.3f} steps/s (best of 2; {w / base:.4f}x the "
            f"plain loop's wall; walls {[round(x, 4) for x in ws]} s)")
    # the snapshot's device time: clones of the whole 256^3 state
    rec = FlightRecorder(capacity=1)
    ms = time_ms(lambda: rec.snapshot(state, step=0, dt=DT_FLAGSHIP,
                                      length=RES_CHUNK), 5)
    chunk_ms = 1e3 * min(walls["+ shadow audit = supervised"]) / (
        RES_WARM // RES_CHUNK)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (state.X, state.U, state.mask, *state.ins.u, state.ins.p,
                  *state.ins.n_prev))
    log(f"[resilience] one snapshot (clone of {nbytes} B on the card): "
        f"{ms:.4f} ms device, {ms / chunk_ms:.5f} of a warm supervised "
        f"chunk of {RES_CHUNK} steps ({chunk_ms:.3f} ms)")


def phase_resilience() -> dict:
    """The supervised run loop on the card: (a) the flagship supervised,
    with one injected divergence, rollback and bitwise capsule replay,
    and its warm steps/s beside the plain loop's; (b) the four drills
    (supervised recovery and checkpoint corruption, silent failures,
    bf16 -> f32 escalation and replay, the 8-lane fleet on
    ``pallas_packed`` with one poisoned lane); (c) a ``profile_trace``
    of 3 flagship steps named in the ledger; (d) ``entry()``'s step.
    Returns the launch counts of the whole phase."""
    from ibamr_tpu_torch import obs
    from ibamr_tpu_torch.entry import entry
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.tools import fault_injection as fi
    from ibamr_tpu_torch.utils.timers import profile_trace

    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for name in total:
            total[name] += counts[name]

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        flag = _supervised_flagship(tmp)
        add(flag["launches"])
        log(f"[resilience] (a) supervised flagship and its replay: "
            f"{time.perf_counter() - t0:.1f} s")
        ci.reset_launch_counts()
        _supervised_speed(flag["integ"], flag["state"], tmp)
        add(ci.LAUNCHES)

        ci.reset_launch_counts()
        prof_dir, ledger = os.path.join(tmp, "prof"), os.path.join(
            tmp, "prof.jsonl")
        s = flag["state"]
        with obs.ledger(ledger), profile_trace(prof_dir, stage="flagship"):
            for _ in range(3):
                s = flag["integ"].step(s, DT_FLAGSHIP)
        add(ci.LAUNCHES)
        named = [r for r in obs.read_ledger(ledger) if r["kind"] == "profile"]
        trace = named[0].get("trace") if named else None
        size = os.path.getsize(trace) if trace and os.path.exists(trace) else 0
        log(f"[resilience] (c) profile_trace of 3 flagship steps: {trace} "
            f"({size} B), named in the ledger: {bool(named)}")
        if not size:
            raise AssertionError("profile_trace wrote no trace")
        del flag, s
        torch.cuda.empty_cache()

        for name, fn, kw in (("run_smoke", fi.run_smoke, {}),
                             ("run_silent_smoke", fi.run_silent_smoke, {}),
                             ("run_replay_smoke", fi.run_replay_smoke, {}),
                             ("run_fleet_smoke", fi.run_fleet_smoke,
                              dict(dtype=torch.float32,
                                   engine="pallas_packed"))):
            t0 = time.perf_counter()
            ci.reset_launch_counts()
            res = fn(os.path.join(tmp, name), device=DEVICE, **kw)
            add(ci.LAUNCHES)
            summary = {k: v for k, v in res.items()
                       if k not in ("incidents", "state", "escalations")}
            log(f"[resilience] (b) {name} on the card: {summary} "
                f"({time.perf_counter() - t0:.1f} s; launches "
                f"{dict(ci.LAUNCHES)})")
            if name == "run_fleet_smoke":
                # the 7 healthy lanes' 8 steps each, over the supervised
                # run's wall (the poisoned lane's steps, the checkpoints,
                # the rollback and the capsule included)
                log(f"[resilience] fleet: {7 * 8 / res['fleet_wall_s']:.3f} "
                    f"healthy lane steps/s over the supervised run of 8 "
                    f"lanes of 32^3 ({res['fleet_wall_s']:.3f} s)")
                if not (ci.LAUNCHES["packed_spread"]
                        and ci.LAUNCHES["packed_interp"]):
                    raise AssertionError("the fleet drill did not run the "
                                         "packed kernels")

        fn, (st, dt) = entry()
        out = fn(st, dt)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (out.X, *out.ins.u, out.ins.p))
        log(f"[resilience] (d) entry() step of the 32^3 shell on "
            f"{out.X.device}: finite {finite}")
        if not finite or out.X.device.type != "cuda":
            raise AssertionError("entry()'s step is not finite on the card")
    log(f"[resilience] launches in the phase: {total}")
    return total


PROF_CHUNK, PROF_CHUNKS = 2, 3   # prof: steps a chunk, chunks captured
TOL_PROF_TOTAL = 0.01     # |total_device_s - profiler sum| / profiler sum
PROF_CHUNK_SHARE = 0.99   # driver/chunk's least share of attributed time
ASSIM_LANES, ASSIM_CYCLES, ASSIM_SPC = 6, 3, 2   # assim: full-width leg
ASSIM_RINGS = (79, 158)   # the two latitude-ring meters of the 316 x 316 shell
ASSIM_SIGMA = 1e-5        # sensor noise of the twin experiment (the drill's)
ASSIM_COLUMNS = 1 << 20   # state entries held against the CPU f64 ESRF
EPS_F32 = 2.0 ** -24
SMI_LINE = [""]           # the card's nvidia-smi name and power limit


def _profiler_device_s(prof) -> float:
    """Seconds of kernel, memcpy and memset device time the profiler
    itself sums for a capture (``key_averages``), without the
    ``gpu_user_annotation`` rows that overlap the kernels."""
    names = {e.key for e in prof.key_averages()
             if getattr(e, "is_user_annotation", False)}
    return sum(_self_device_us(e) for e in prof.key_averages()
               if e.key not in names) / 1e6


def phase_prof() -> dict:
    """Device-time attribution of the supervised flagship: PROF_CHUNKS
    chunks of PROF_CHUNK steps of ``HierarchyDriver`` under
    ``ResilientDriver`` and a run ledger, captured by ``profile_trace``;
    the port's ``deviceprof`` and ``tools/prof.py`` (``attribute``,
    ``check``, ``diff`` against itself) on the capture, the census
    sidecar of one step and the roofline join. Returns the launches."""
    from ibamr_tpu_torch import obs
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.obs import deviceprof
    from ibamr_tpu_torch.obs.roofline import census_sidecar, render_roofline
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.tools import prof as prof_cli
    from ibamr_tpu_torch.utils.health import HealthProbe
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver
    from ibamr_tpu_torch.utils.timers import profile_trace

    ci.reset_launch_counts()
    integ, state = build_shell_example(use_fast_interaction="pallas_packed",
                                       dtype=torch.float32, device=DEVICE,
                                       **FLAGSHIP)
    n = PROF_CHUNK * PROF_CHUNKS
    for _ in range(2):                       # builds, plans, layouts
        state = integ.step(state, DT_FLAGSHIP)
    torch.cuda.synchronize()
    warm = dict(ci.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        cap, ledger = os.path.join(tmp, "cap"), os.path.join(
            tmp, "ledger.jsonl")
        drv = HierarchyDriver(integ, RunConfig(
            dt=DT_FLAGSHIP, num_steps=n, health_interval=PROF_CHUNK,
            restart_interval=n), health_probe=HealthProbe.for_integrator(
                integ))
        ci.reset_launch_counts()
        t0 = time.perf_counter()
        with obs.ledger(ledger):
            with profile_trace(cap, stage="flagship") as prof:
                out = ResilientDriver(drv, os.path.join(tmp, "run"),
                                      handle_signals=False).run(state)
        wall = time.perf_counter() - t0
        launches = dict(ci.LAUNCHES)
        trace = os.path.join(cap, "trace.json")
        log(f"[prof] {n} supervised flagship steps captured in {wall:.2f} "
            f"s ({os.path.getsize(trace)} B of trace); launches {launches}")
        t0 = time.perf_counter()
        summary = deviceprof.attribute_capture(cap, ledger=ledger)
        attr_s = time.perf_counter() - t0
        probs = deviceprof.validate_summary(summary)
        total = summary["total_device_s"]
        ref = _profiler_device_s(prof)
        spans = summary["spans"]
        chunk_s = sum(v["device_s"] for k, v in spans.items()
                      if k.endswith("driver/chunk"))
        share = chunk_s / max(summary["attributed_s"], 1e-30)
        oc = summary["op_classes"]
        log(f"[prof] attributed in {attr_s:.2f} s: total_device_s {total:.6f} "
            f"s vs the profiler's own kernel+memcpy+memset sum {ref:.6f} s "
            f"({abs(total - ref) / max(ref, 1e-30):.2e} off); attributed "
            f"{summary['attributed_s']:.6f} + unattributed "
            f"{summary['unattributed_s']:.6f}; driver/chunk "
            f"{chunk_s:.6f} s = {share:.5f} of attributed, fraction "
            f"attributed {summary['fraction_attributed']}; op classes "
            f"{oc}; lanes {[(d['thread'], d['events']) for d in summary['lanes']]}")
        log(f"[prof] spans {json.dumps({k: v['device_s'] for k, v in spans.items()})}; "
            f"unattributed {json.dumps(summary['unattributed'])[:600]}")
        # every kernel of the capture by name, to find the packed ones
        events, _ = deviceprof.trace_device_events(
            deviceprof.load_trace(trace))
        full = deviceprof.attribute_events(
            events, deviceprof.spans_from_ledger(ledger), max_ops=10 ** 6)
        ops = {name: dev_s for k, v in full["spans"].items()
               if k.endswith("driver/chunk") for name, dev_s
               in v["ops"].items()}
        # the trace names a kernel with its signature
        packed = {k: sum(v for name, v in ops.items() if k in name)
                  for k in ("packed_spread_kernel", "packed_interp_kernel")}
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
        log(f"[prof] the packed kernels' attributed device time {packed}; "
            f"driver/chunk's top kernels "
            f"{[(name[:60], round(v, 6)) for name, v in top]}")
        rc_attr = prof_cli.main(["attribute", cap, "--ledger", ledger])
        rc_check = prof_cli.main(["check", cap])
        census = census_sidecar(lambda s: integ.step(s, DT_FLAGSHIP),
                                (out,), label="flagship", executions=n)
        torch.cuda.synchronize()
        # the warm-up's, the capture's and the census' launches
        launches = {k: warm[k] + ci.LAUNCHES[k] for k in warm}

        with open(os.path.join(cap, deviceprof.CENSUS_NAME), "w") as f:
            json.dump(census, f)
        joined = deviceprof.attribute_capture(cap, ledger=ledger)
        roof = joined["roofline"]
        fft = (roof or {}).get("fft") or {}
        for ln in render_roofline(roof):
            log(f"[prof] roofline {ln.strip()}")
        log(f"[prof] census of one step: {census['fft_ops']} transforms, "
            f"{census['fft_bytes']} B; {census['dot_count']} contractions; "
            f"achieved FFT {fft.get('achieved_gb_per_s')} GB/s of "
            f"{PEAK_BYTES_S / 1e9:.0f} GB/s on {SMI_LINE[0]}")
        deviceprof.write_summary(cap, joined)
        rc_diff = prof_cli.main(["diff", cap, cap])
        dev_recs = [r for r in obs.read_ledger(ledger)
                    if r["kind"] == "device_time"]
        ok = (not probs and total > 0
              and abs(total - ref) <= TOL_PROF_TOTAL * ref
              and abs(summary["attributed_s"] + summary["unattributed_s"]
                      - total) <= max(1e-6, 1e-4 * total)
              and share >= PROF_CHUNK_SHARE and oc["fft_s"] > 0
              and all(v > 0 for v in packed.values())
              and rc_attr == 0 and rc_check == 0 and rc_diff == 0
              and len(dev_recs) == 1 and fft.get("achieved_gb_per_s")
              and int(out.ins.k) == n + 2)
        if probs:
            log(f"[prof] INVALID summary: {probs}")
        if not ok:
            raise AssertionError("the prof phase missed one of its checks "
                                 "(see the log lines above)")
    return dict(launches=launches, integ=integ, state=out)


def phase_io(integ, state) -> None:
    """Host I/O at the flagship's sizes: the markers as ``.vtp``, the
    pressure as a binary ``.vti`` (base64 through the native encoder),
    the ``ibfe3d`` sphere as ``.vtu``, and a 99,856-row vertex table
    parsed by the native parser, each against the NumPy/stdlib path
    (the native library switched off) byte for byte or value for
    value, with both times."""
    from ibamr_tpu_torch.fe.surface import sphere_surface_mesh
    from ibamr_tpu_torch.io import native, structures, vtk

    X = state.X.detach().cpu().numpy()
    p = state.ins.p.detach().cpu().numpy()
    mesh = sphere_surface_mesh(center=(0.5,) * 3, radius=IBFE3D["radius"],
                               n_subdiv=IBFE3D["n_subdiv"])
    if native.get_lib() is None:
        raise AssertionError("the native host library did not build")
    with tempfile.TemporaryDirectory() as tmp:
        table = os.path.join(tmp, "flagship.vertex")
        with open(table, "w") as f:
            f.write(f"{X.shape[0]}\n")
            np.savetxt(f, X, fmt="%.17g")

        def writes(tag):
            t = {}
            t0 = time.perf_counter()
            a = vtk.write_vtp(os.path.join(tmp, f"{tag}.vtp"), X,
                              point_data={"X": X})
            t["vtp"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = vtk.write_vti(os.path.join(tmp, f"{tag}.vti"),
                              integ.ins.grid, {"p": p}, fmt="binary")
            t["vti"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            c = vtk.write_vtu(os.path.join(tmp, f"{tag}.vtu"), mesh.nodes,
                              mesh.elems, "TRI3",
                              point_data={"X": mesh.nodes})
            t["vtu"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rows = structures._read_table(table, 3, 3, "vertex")
            t["vertex"] = time.perf_counter() - t0
            files = [open(x, "rb").read() for x in (a, b, c)]
            return files, rows, t

        fn, rn, tn = writes("native")
        saved = (native._lib, native._tried)
        native._lib, native._tried = None, True   # the NumPy/stdlib path
        try:
            fp, rp, tp = writes("numpy")
        finally:
            native._lib, native._tried = saved
        same = [a == b for a, b in zip(fn, fp)]
        log(f"[io] native vs NumPy/stdlib: .vtp {len(fn[0])} B, .vti "
            f"{len(fn[1])} B, .vtu {len(fn[2])} B equal {same}; vertex "
            f"table {rn.shape} equal {np.array_equal(rn, rp)}, equal to "
            f"the markers {np.array_equal(rn, X.astype(np.float64))}; "
            f"seconds native {tn} NumPy {tp}")
        if not (all(same) and np.array_equal(rn, rp)
                and np.array_equal(rn, X.astype(np.float64))
                and rn.shape == (FLAGSHIP["n_lat"] * FLAGSHIP["n_lon"], 3)):
            raise AssertionError("a native I/O path disagrees with the NumPy "
                                 "path")


def _assim_drill(tmp: str) -> None:
    """The four-injector drill at the reference's sizes on the card, and
    the obs CLI's summary of its ledger."""
    from ibamr_tpu_torch.tools import fault_injection as fi
    from ibamr_tpu_torch.tools import obs as obs_cli

    t0 = time.perf_counter()
    res = fi.run_assim_smoke(os.path.join(tmp, "drill"), device=DEVICE)
    log(f"[assim] drill on the card ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(res)}")
    print("[assim] python -m ibamr_tpu_torch.tools.obs summary "
          f"{res['ledger']}", flush=True)
    if obs_cli.main(["summary", res["ledger"]]) != 0:
        raise AssertionError("obs summary of the drill's ledger failed")
    sys.stdout.flush()


def _assim_full_width(tmp: str) -> dict:
    """ASSIM_LANES lanes of the flagship (f32, ``pallas_packed``),
    ASSIM_CYCLES cycles of ASSIM_SPC steps under the supervisor with the
    drill's four injectors and two latitude-ring meters: one terminal
    ``assim_cycle`` record a cycle, QC rejecting exactly the injected
    triples, the quarantined lane's rows bitwise frozen through every
    later analysis, two cache entries and hits after them, and the first
    analysis against the plain f64 ESRF of the same forecast ensemble on
    the CPU. Returns the launches."""
    from ibamr_tpu_torch import assim, obs
    from ibamr_tpu_torch.assim import qc as aqc
    from ibamr_tpu_torch.instruments import InstrumentPanel, make_meters
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
    from ibamr_tpu_torch.tools import fault_injection as fi
    from ibamr_tpu_torch.utils.health import HealthProbe
    from ibamr_tpu_torch.utils.lanes import fleet_size, lane_slice
    from ibamr_tpu_torch.utils.tree import leaves

    B, spc, n_cyc = ASSIM_LANES, ASSIM_SPC, ASSIM_CYCLES
    BAD = B - 1
    t0 = time.perf_counter()
    ci.reset_launch_counts()
    integ, op, fleet0, batches, _ = fi.assim_shell_setup(
        B, n_cyc, spc, DT_FLAGSHIP, device=DEVICE, dtype=torch.float32,
        sigma=ASSIM_SIGMA, rings=ASSIM_RINGS,
        use_fast_interaction="pallas_packed", **FLAGSHIP)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    truth = dict(ci.LAUNCHES)                # the truth run's
    names = op.channel_names()
    source, injected = fi.armed_obs_source(
        batches, names, {"dropout": (0, 0), "outlier": (1, 1),
                         "stale": (2, 2)})
    member_inj = dict(at_step=spc + 1, lane=BAD, fleet_size=B,
                      leaf_path="u[0]", step_attr="ins.k")
    cache = ExecutableCache()
    cyc = assim.AssimilationCycle(
        integ, op, B, assim.AssimConfig(steps_per_cycle=spc,
                                        dt=DT_FLAGSHIP,
                                        qc=aqc.QCConfig(k_sigma=6.0)),
        probe=HealthProbe.for_integrator(integ), cache=cache,
        fleet_step_wrap=lambda s: fi.member_divergence_injector(
            s, **member_inj))
    seen = []
    run_analysis = cyc._run_analysis

    def watched(state, batch, cycle, step):
        alive = cyc.driver.lane_alive.copy()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_analysis(state, batch, cycle, step)
        torch.cuda.synchronize()
        rec = dict(cycle=cycle, alive=alive, ms=1e3 * (
            time.perf_counter() - t))
        if not alive[BAD]:
            rows = leaves(lane_slice(out, BAD))
            rec.update(rows=[x.clone() for x in rows], frozen=all(
                torch.equal(a, b) for a, b in zip(
                    leaves(lane_slice(state, BAD)), rows)))
        if not seen:
            rec.update(forecast=state, analysis=out, batch=batch)
        seen.append(rec)
        return out

    cyc._run_analysis = watched
    ledger = os.path.join(tmp, "full_ledger.jsonl")
    ci.reset_launch_counts()
    t0 = time.perf_counter()
    with obs.ledger(ledger):
        with fi.recorded("member_divergence", **member_inj):
            out = cyc.run(fleet0, batches, directory=os.path.join(tmp, "full"),
                          obs_source=source, max_retries=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fleet_launches = dict(ci.LAUNCHES)
    launches = {k: truth[k] + fleet_launches[k] for k in truth}
    records = obs.read_ledger(ledger)
    cyc_recs = [r for r in records if r.get("kind") == "assim_cycle"]
    rej = {(r["cycle"], r["instrument"], r["reason"])
           for r in records if r.get("kind") == "assim_qc_reject"}
    stats = cache.stats()
    modes = {cache.get(k).label: cache.get(k).mode for k in cache.keys()}
    dead = [r for r in seen if not r["alive"][BAD]]
    frozen = [r["frozen"] for r in dead]
    # each later analysis and the final state hold the same rows
    final_frozen = bool(dead) and all(
        torch.equal(a, b) for r in dead[1:] + [dict(rows=leaves(
            lane_slice(out, BAD)))] for a, b in zip(dead[0]["rows"],
                                                     r["rows"]))
    steps = B * spc * n_cyc
    log(f"[assim] full width: {B} lanes of the flagship, {n_cyc} cycles of "
        f"{spc} steps: set-up (build, truth run, fleet) {setup_s:.2f} s, "
        f"supervised run {run_s:.2f} s ({steps / run_s:.3f} lane steps/s "
        f"with checkpoints, QC and analyses); analysis ms "
        f"{[round(r['ms'], 3) for r in seen]}; cycles recorded "
        f"{sorted(r['cycle'] for r in cyc_recs)}; QC rejections "
        f"{sorted(rej)}; cache {stats}, modes {modes}; quarantined "
        f"{not cyc.driver.lane_alive[BAD]}, frozen through analyses "
        f"{frozen}; escalations {cyc.escalations}; launches of the "
        f"truth run {truth}, of the fleet {fleet_launches}")

    # the first analysis against the plain f64 ESRF on the CPU
    first = seen[0]
    fc, an, batch = first["forecast"], first["analysis"], first["batch"]
    pack, _, n = assim.state_packer(lane_slice(fc, 0))
    idx = torch.as_tensor(np.sort(np.random.default_rng(7).choice(
        n, ASSIM_COLUMNS, replace=False)), device=DEVICE)
    ens = torch.stack([pack(lane_slice(fc, i))[idx] for i in range(B)])
    ana_card = torch.stack([pack(lane_slice(an, i))[idx] for i in range(B)])
    ens64 = ens.double().cpu()
    cpu_panel = InstrumentPanel(integ.ins.grid, make_meters(
        [[r * FLAGSHIP["n_lon"] + j for j in range(FLAGSHIP["n_lon"])]
         for r in ASSIM_RINGS], closed=True, dtype=torch.float64,
        device="cpu"))
    cpu_op = assim.ObservationOperator(cpu_panel)

    def lane64(i):
        s = lane_slice(fc, i)
        return s._replace(X=s.X.double().cpu(), ins=s.ins._replace(
            u=tuple(c.double().cpu() for c in s.ins.u),
            p=s.ins.p.double().cpu()))

    obs64 = torch.stack([cpu_op(lane64(i)) for i in range(B)])
    rejected = {r["instrument"] for r in records
                if r.get("kind") == "assim_qc_reject"
                and r["cycle"] == first["cycle"]}
    om = torch.tensor([nm not in rejected for nm in names])
    alive = torch.as_tensor(first["alive"])
    y = torch.nan_to_num(torch.as_tensor(batch.values))
    ana64, diag = assim.esrf_analysis(
        ens64, obs64, y, torch.as_tensor(batch.r), alive, om,
        torch.tensor(1.0, dtype=torch.float64))
    _, Zx, neff = assim.masked_moments(ens64, alive)
    _, Zy, _ = assim.masked_moments(obs64, alive)
    rinv = om.double() / torch.as_tensor(batch.r)
    G = (neff - 1.0) * torch.eye(B, dtype=torch.float64) + (
        Zy * rinv[None, :]) @ Zy.T
    kappa = float(torch.linalg.cond(G))
    err = float((ana_card.double().cpu() - ana64).abs().max())
    scale_x = float(ens64.abs().max())
    scale_a = float(Zx.abs().max())
    bound = 16 * EPS_F32 * scale_x + 16 * kappa * EPS_F32 * scale_a
    log(f"[assim] first analysis (cycle {first['cycle']}) on {ASSIM_COLUMNS} "
        f"of {n} state entries against the CPU f64 ESRF of the same "
        f"forecast ensemble: max|card - f64| {err:.3e}, bound {bound:.3e} "
        f"(16 eps_f32 x max|x| {scale_x:.3e} + 16 kappa(G) eps_f32 x "
        f"max|anomaly| {scale_a:.3e}, kappa(G) {kappa:.3e}); update "
        f"max|ana - x| {float((ana64 - ens64).abs().max()):.3e}; f64 "
        f"innovation rms {float(diag.innov_rms):.3e}, spread "
        f"{float(diag.spread_f):.3e} -> {float(diag.spread_a):.3e}")
    ok = (sorted(r["cycle"] for r in cyc_recs) == list(range(n_cyc))
          and rej == injected and not cyc.driver.lane_alive[BAD]
          and frozen and all(frozen) and final_frozen
          and stats["misses"] == 2
          and stats["hits"] == 2 * len(seen) - 2
          and modes.get("assim_observe") == "graph"
          and modes.get("assim_analyze") == "eager"
          and err <= bound and fleet_size(out) == B
          and all(bool(torch.isfinite(t).all())
                  for i in range(B - 1) for t in leaves(lane_slice(out, i))
                  if t.is_floating_point()))
    if not ok:
        raise AssertionError("the full-width assimilation leg missed one of "
                             "its checks (see the log lines above)")
    return launches


def phase_assim() -> dict:
    """The assimilation tenant on the card: the drill at the reference's
    sizes (scatter oracle, no hand kernel) and the full-width leg on the
    flagship's ``pallas_packed``. Returns the launches."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    with tempfile.TemporaryDirectory() as tmp:
        ci.reset_launch_counts()
        _assim_drill(tmp)
        if any(ci.LAUNCHES.values()):
            raise AssertionError(f"the drill (scatter oracle) launched a "
                                 f"hand kernel: {ci.LAUNCHES}")
        launches = _assim_full_width(tmp)
    torch.cuda.empty_cache()
    return launches


SERVE_LANES = 2          # serve: lanes of the full-width bucket
SERVE_STEPS = 4          # serve: steps of each full-width request
SERVE_WARM = 8           # serve: warm requests after the cold one


def _serve_slo(flag: str, ledger: str, invariants) -> dict:
    """``tools/slo.py check <flag>`` on a drill's ledger: its report
    printed, its invariant SLIs gating (the latency ceilings are the
    CPU's and are reported, not gated, on the card)."""
    import contextlib
    import io

    from ibamr_tpu_torch.tools import slo

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = slo.main(["check", flag, "--ledger", ledger, "--json"])
    doc = json.loads(buf.getvalue())
    log(f"[serve] python -m ibamr_tpu_torch.tools.slo check {flag} --ledger "
        f"{os.path.basename(ledger)} (on {SMI_LINE[0]}): exit {rc}, SLIs "
        f"{json.dumps(doc['slis'], sort_keys=True)}; violated "
        f"{doc['violated']}")
    bad = {k: doc["slis"].get(k) for k, v in invariants.items()
           if doc["slis"].get(k) != v}
    if bad:
        raise AssertionError(f"the {flag} invariants broke on the card: "
                             f"{bad}")
    return doc["slis"]


def _serve_summary(ledger: str) -> None:
    from ibamr_tpu_torch.tools import obs as obs_cli

    print(f"[serve] python -m ibamr_tpu_torch.tools.obs summary {ledger}",
          flush=True)
    if obs_cli.main(["summary", ledger]) != 0:
        raise AssertionError(f"obs summary of {ledger} failed")
    sys.stdout.flush()


def _chunk_calls(steps: int, chunk: int) -> int:
    """Chunks the router runs for one request of ``steps`` steps: the
    length-1 ack, then cruise chunks, then length-1 tails."""
    calls, left, first = 0, steps, True
    while left > 0:
        n = chunk if not first and left >= chunk else 1
        left -= n
        calls += 1
        first = False
    return calls


def _serve_contract() -> None:
    """The contract drill of the port's SERVE_CONTRACT.json on the card:
    its four structural numbers must equal the contract's."""
    from ibamr_tpu_torch.serve.router import cold_warm_drill
    from ibamr_tpu_torch.tools import serve as serve_cli

    with open(serve_cli.CONTRACT_PATH) as f:
        doc = json.load(f)
    d = doc["drill"]
    out = cold_warm_drill(n_cells=d["n"], lanes=d["lanes"], steps=d["steps"],
                          engine=d["engine"], device=DEVICE)
    got = {k: out[k] for k in serve_cli.CONTRACT_METRICS}
    regressions, improvements = serve_cli.diff_contract(out,
                                                        doc["contract"])
    log(f"[serve] contract drill ({d['n']}^3, {out['engine']}, "
        f"{d['lanes']} lanes, {d['steps']} steps) on the card: {got}, cold "
        f"{out['cold_first_step_s']} s / warm {out['warm_first_step_s']} s "
        f"first step; regressions {regressions}, improvements "
        f"{improvements}")
    if got != doc["contract"] or regressions:
        raise AssertionError("the serve contract drill disagrees with "
                             "SERVE_CONTRACT.json on the card")


def _serve_full_width(tmp: str) -> dict:
    """One family at the flagship's sizes on ``pallas_packed``:
    ``cold_warm_drill`` with SERVE_WARM warm requests (2 cold builds, 0
    warm builds, a hit per chunk, no new signature), a batch with a
    poisoned lane (quarantined; its neighbour ends ok) and the cruise
    chunk's healthy lane bitwise the same beside the poisoned lane as
    beside padding. Returns the launches, which must be 3 spread and 6
    interp launches for every lane step the leg took."""
    from ibamr_tpu_torch import obs
    from ibamr_tpu_torch.integrators.ib import IBExplicitIntegrator
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
    from ibamr_tpu_torch.serve.router import (BucketSpec, ScenarioRequest,
                                              WarmPoolRouter,
                                              cold_warm_drill)
    from ibamr_tpu_torch.utils.lanes import lane_slice, pad_lanes, stack_lanes
    from ibamr_tpu_torch.utils.tree import leaves

    lane_steps = [0]
    step = IBExplicitIntegrator.step

    def counted(self, state, dt):
        lane_steps[0] += 1
        return step(self, state, dt)

    ledger = os.path.join(tmp, "full_width_ledger.jsonl")
    IBExplicitIntegrator.step = counted
    ci.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        with obs.ledger(ledger):
            out = cold_warm_drill(
                lanes=SERVE_LANES, steps=SERVE_STEPS, dt=DT_FLAGSHIP,
                engine="pallas_packed", warm_requests=SERVE_WARM,
                device=DEVICE, **FLAGSHIP)
            torch.cuda.synchronize()
            drill_s = time.perf_counter() - t0
            drill_steps = lane_steps[0]
            spec = BucketSpec(lanes=SERVE_LANES, engine="pallas_packed",
                              dt=DT_FLAGSHIP, **FLAGSHIP)
            router = WarmPoolRouter([spec], cache=ExecutableCache(),
                                    allow_dynamic=False, device=DEVICE)
            router.warm(spec)
            pool = router._pools[spec]
            alloc = torch.cuda.memory_allocated()

            def req(tag, **kw):
                return ScenarioRequest(tenant=tag, steps=SERVE_STEPS,
                                       dt=DT_FLAGSHIP,
                                       engine="pallas_packed", **kw,
                                       **FLAGSHIP)

            res = router.serve([req("healthy"),
                                req("poisoned", perturb=float("inf"))])
            good = pool.request_state(req("g"))
            bad = pool.request_state(req("b", perturb=float("inf")))
            dt = pool._dt_vec
            beside_bad, hb = pool.chunk(2)(stack_lanes([good, bad]), dt,
                                           np.array([True, True]))
            padded, _ = pad_lanes([good], SERVE_LANES)
            beside_pad, hp = pool.chunk(2)(padded, dt,
                                           np.array([True, False]))
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(
                leaves(lane_slice(beside_bad, 0)),
                leaves(lane_slice(beside_pad, 0))))
    finally:
        IBExplicitIntegrator.step = step
    launches = dict(ci.LAUNCHES)
    hist = out["histograms"].get('serve_request_seconds{path="warm"}')
    warm_steps = SERVE_WARM * SERVE_STEPS
    steps_per_s = warm_steps / hist["sum"] if hist else float("nan")
    by = {r.tenant: r for r in res}
    calls = _chunk_calls(SERVE_STEPS, 2)
    # the drill's pool warms its 1- and 2-step chunks on every lane,
    # then serves one lane a request
    want_steps = SERVE_LANES * 3 + (1 + SERVE_WARM) * SERVE_STEPS
    log(f"[serve] full width ({FLAGSHIP['n_cells']}^3, "
        f"{FLAGSHIP['n_lat']}x{FLAGSHIP['n_lon']} markers, f32, "
        f"pallas_packed, {SERVE_LANES} lanes, chunk 2) on {SMI_LINE[0]}: "
        f"cold first step {out['cold_first_step_s']} s, warm "
        f"{out['warm_first_step_s']} s (ratio {out['warm_over_cold']}); "
        f"warm p50 {out['warm_p50_s']} s, p99 {out['warm_p99_s']} s over "
        f"{out['warm_requests']} warm requests of {SERVE_STEPS} steps; "
        f"{steps_per_s:.3f} lane steps/s over the warm requests "
        f"(serve_request_seconds sum {hist['sum'] if hist else None} s); "
        f"builds cold {out['cold_compiles']} / warm {out['warm_compiles']}, "
        f"warm hits {out['warm_hits']} (chunk calls a request: {calls}), "
        f"new signatures {out['warm_new_trace_signatures']}; drill "
        f"{drill_s:.2f} s, {drill_steps} lane steps (expected "
        f"{want_steps})")
    log(f"[serve] full-width pool bytes {pool.resident_bytes} "
        f"({pool.resident_bytes / 2**30:.3f} GiB; the drill's pool "
        f"{out['pool_bytes']}) beside torch.cuda.memory_allocated {alloc} "
        f"({alloc / 2**30:.3f} GiB) with the pool warm; quarantine batch "
        f"{[(r.tenant, r.ok, r.quarantined, r.steps_done) for r in res]}; "
        f"cruise chunk health beside the poisoned lane {hb.tolist()}, "
        f"beside padding {hp.tolist()}, lane 0 bitwise equal {bitwise}; "
        f"launches {launches} over {lane_steps[0]} lane steps")
    _serve_summary(ledger)
    ok = (out["cold_compiles"] == 2 and out["warm_compiles"] == 0
          and out["warm_hits"] == calls
          and out["warm_new_trace_signatures"] == 0
          and out["cold_ok"] and out["warm_ok"]
          and out["engine"] == "pallas_packed"
          and drill_steps == want_steps
          and by["poisoned"].quarantined and not by["poisoned"].ok
          and by["healthy"].ok and not by["healthy"].quarantined
          and by["healthy"].steps_done == SERVE_STEPS
          and hb.tolist() == [1.0, 0.0] and hp.tolist()[0] == 1.0
          and bitwise
          and pool.resident_bytes > 0 and out["pool_bytes"] > 0
          and launches["packed_spread"] == 3 * lane_steps[0]
          and launches["packed_interp"] == 6 * lane_steps[0]
          and launches["tile_spread"] == 0 and launches["tile_interp"] == 0)
    del router, pool, beside_bad, beside_pad, padded, good, bad
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the full-width serving leg missed one of its "
                             "checks (see the log lines above)")
    return launches


def _serve_drills(tmp: str) -> None:
    """The soak and elastic drills at the port's SLO.json sizes on the
    card, then the SLO gate on their ledgers."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.tools import fault_injection as fi
    from ibamr_tpu_torch.tools import slo

    sizes = slo.load_contract()
    sk, el = sizes["soak"], sizes["elastic"]
    t0 = time.perf_counter()
    soak = fi.run_soak_smoke(os.path.join(tmp, "soak"),
                             duration_s=sk["duration_s"],
                             rate_rps=sk["rate_rps"],
                             time_scale=sk["time_scale"], device=DEVICE)
    log(f"[serve] soak drill ({sk['n']}^3, {sk['n_lat']}x{sk['n_lon']} "
        f"shell, {sk['lanes']} lanes, {sk['rate_rps']} rps, "
        f"{sk['burst_factor']}x burst, time scale {sk['time_scale']}; "
        f"four chaos injectors) on the card "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(soak)}")
    _serve_summary(soak["ledger"])
    _serve_slo("--soak", soak["ledger"], {"soak_lost_requests": 0})
    t0 = time.perf_counter()
    elastic = fi.run_elastic_smoke(os.path.join(tmp, "elastic"),
                                   duration_s=el["duration_s"],
                                   rate_rps=el["rate_rps"],
                                   time_scale=el["time_scale"],
                                   shift_frac=el["shift_frac"],
                                   device=DEVICE)
    log(f"[serve] elastic drill (mix shift at {el['shift_frac']}, bytes "
        f"squeeze, restart) on the card ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(elastic)}")
    _serve_summary(elastic["ledger"])
    _serve_slo("--elastic", elastic["ledger"],
               {"elastic_lost_requests": 0,
                "elastic_restart_fresh_compiles": 0})
    if any(ci.LAUNCHES.values()):
        raise AssertionError(f"the 8^3 drills (scatter oracle) launched a "
                             f"hand kernel: {ci.LAUNCHES}")


def phase_serve() -> dict:
    """The serving layer on the card: the contract drill, the full-width
    leg on the flagship's ``pallas_packed`` (the main path's launches)
    and the soak and elastic drills with their SLO gates. Returns the
    launches of the full-width leg."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    with tempfile.TemporaryDirectory() as tmp:
        ci.reset_launch_counts()
        _serve_contract()
        if any(ci.LAUNCHES.values()):
            raise AssertionError(f"the contract drill (scatter oracle) "
                                 f"launched a hand kernel: {ci.LAUNCHES}")
        launches = _serve_full_width(tmp)
        ci.reset_launch_counts()
        _serve_drills(tmp)
    torch.cuda.empty_cache()
    return launches


GRAD_REPS = 3             # grad: timed calls of each piece at the flagship
TOL_GRAD_PLAIN = 1e-4     # custom vs plain whole-step gradient, per leaf,
#                           relative to max|plain leaf| (f32)
TOL_GRAD_F64 = 1e-10      # card vs CPU whole-step gradient at f64, per leaf
GRAD_SHELL = dict(n_cells=32, n_lat=16, n_lon=16)
GRAD_DT = 1e-3            # grad: dt of the 32^3 card-vs-CPU leg
CANTILEVER_ITERS = 3


def _grad_flagship() -> dict:
    """The flagship's adjoint on ``packed`` through
    ``microbench_grad.run``: primal and VJP milliseconds of each piece,
    the FFT and scatter counts, the custom gradient against the plain one
    leaf by leaf, bitwise run to run, and the peak memory of each leg."""
    from ibamr_tpu_torch.tools import microbench_grad

    t0 = time.perf_counter()
    out = microbench_grad.run(n=FLAGSHIP["n_cells"], reps=GRAD_REPS,
                              dt=DT_FLAGSHIP, device=DEVICE, shell=FLAGSHIP,
                              plain=True, quiet=True)
    wall = time.perf_counter() - t0
    for piece in ("substep", "spread", "interp", "step"):
        log(f"[grad] {piece}: primal {out[f'{piece}_primal_ms']:.4f} ms, "
            f"VJP {out[f'{piece}_vjp_ms']:.4f} ms (x"
            f"{out[f'{piece}_grad_ratio']:.3f}); FFT calls "
            f"{out[f'{piece}_primal_fft_ops']}/{out[f'{piece}_vjp_fft_ops']},"
            f" scatters {out[f'{piece}_primal_scatter_ops']}/"
            f"{out[f'{piece}_vjp_scatter_ops']}, f64 widenings "
            f"{out[f'{piece}_primal_f64_widenings']}/"
            f"{out[f'{piece}_vjp_f64_widenings']} (primal/VJP; census "
            f"threads {out[f'{piece}_vjp_census_threads']})")
    log(f"[grad] whole step under plain_autodiff_*: "
        f"{out['step_vjp_plain_ms']:.4f} ms (x"
        f"{out['step_plain_grad_ratio']:.3f}), scatters "
        f"{out['step_vjp_plain_scatter_ops']}, FFT calls "
        f"{out['step_vjp_plain_fft_ops']}")
    log(f"[grad] peak device memory (MiB, max_memory_allocated): primal step "
        f"{out['step_primal_peak_mib']}, custom VJP "
        f"{out['step_vjp_peak_mib']}, plain VJP "
        f"{out['step_vjp_plain_peak_mib']}")
    dev = out["step_plain_rel_dev"]
    log(f"[grad] custom vs plain whole-step gradient, max|d|/max|plain| per "
        f"leaf (tol {TOL_GRAD_PLAIN:g}): {json.dumps(dev)}; max|plain| "
        f"{json.dumps(out['step_plain_max_abs'])}; bitwise run to run "
        f"{out['step_vjp_bitwise']}")
    log(f"[grad] flagship {FLAGSHIP} ({out['shell_markers']} markers) on "
        f"packed, f32, dt={DT_FLAGSHIP:g}, {GRAD_REPS} reps: {wall:.1f} s")
    ok = (out["substep_vjp_fft_ops"] == 2 * out["substep_primal_fft_ops"]
          and out["substep_primal_fft_ops"] > 0
          and out["spread_vjp_scatter_ops"]
          == out["spread_primal_scatter_ops"]
          and out["shell_markers"] == FLAGSHIP["n_lat"] * FLAGSHIP["n_lon"]
          and all(v <= TOL_GRAD_PLAIN for v in dev.values())
          and out["step_vjp_bitwise"])
    if not ok:
        raise AssertionError("the flagship's adjoint missed one of its "
                             "checks (see the [grad] lines above)")
    return out


def _grad_card_vs_cpu() -> float:
    """The whole step's gradient on the 32^3 shell at f64 on the card and
    on the CPU from the same state (one step from rest on the CPU)."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.tools.microbench_grad import step_grads

    kw = dict(use_fast_interaction="packed", dtype=torch.float64,
              **GRAD_SHELL)
    cpu, cs = build_shell_example(device="cpu", **kw)
    cs = cpu.step(cs, GRAD_DT)
    gpu, _ = build_shell_example(device=DEVICE, **kw)
    gg = step_grads(gpu, _to(cs, DEVICE), GRAD_DT)
    cg = step_grads(cpu, cs, GRAD_DT)
    devs = [float((a.cpu() - b).abs().max())
            / max(float(b.abs().max()), 1e-300) for a, b in zip(gg, cg)]
    log(f"[grad] {GRAD_SHELL} on packed at f64, dt={GRAD_DT:g}: whole-step "
        f"gradient card vs CPU, max|d|/max|cpu| per leaf (u, p, n_prev, X) "
        f"{[f'{d:.3e}' for d in devs]} (tol {TOL_GRAD_F64:g})")
    if not all(d <= TOL_GRAD_F64 for d in devs):
        raise AssertionError("the card's f64 gradient disagrees with the "
                             "CPU's")
    return max(devs)


def _grad_drills() -> None:
    """The design drill on the card, its ledger summarized by
    ``tools/obs.py``, and the cantilever at its defaults."""
    from ibamr_tpu_torch.design import DesignLoop, build_cantilever_problem
    from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
    from ibamr_tpu_torch.tools import fault_injection as fi

    from ibamr_tpu_torch.tools import obs as obs_cli

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = fi.run_design_smoke(tmp, device=DEVICE)
        log(f"[grad] design drill (eel 24^2, 17 markers, 10 steps, f64) on "
            f"the card ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(res)}")
        log(f"[grad] python -m ibamr_tpu_torch.tools.obs summary "
            f"{res['ledger']}")
        if obs_cli.main(["summary", res["ledger"]]) != 0:
            raise AssertionError("obs summary of the design ledger failed")
        sys.stdout.flush()
    t0 = time.perf_counter()
    obj, p0 = build_cantilever_problem(device=DEVICE)
    loop = DesignLoop(obj, p0, lr=0.05, cache=ExecutableCache(),
                      label="cantilever")
    hist = loop.run(CANTILEVER_ITERS).history
    objs = [h.objective for h in hist]
    log(f"[grad] cantilever (32^2, 8x2 quads, 10 steps, f32, remat full) "
        f"{CANTILEVER_ITERS} Adam iterations: objectives {objs}, grad norms "
        f"{[h.grad_norm for h in hist]}, walls (s) "
        f"{[round(h.wall_s, 4) for h in hist]} (the first holds the "
        f"build's warm-up iterate), misses/hits "
        f"{[(h.cache_misses, h.cache_hits) for h in hist]} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(b < a for a, b in zip(objs, objs[1:])):
        raise AssertionError(f"the cantilever's objective did not strictly "
                             f"decrease: {objs}")


def _grad_refusals() -> None:
    """``pallas_packed`` and ``pallas`` spreads refuse a force that
    requires grad (no launch)."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example

    for engine in ("pallas_packed", "pallas"):
        integ, st = build_shell_example(use_fast_interaction=engine,
                                        dtype=torch.float32, device=DEVICE,
                                        **GRAD_SHELL)
        F = torch.ones_like(st.X).requires_grad_(True)
        try:
            integ.ib.fast.spread_vel(F, st.X)
        except NotImplementedError as e:
            log(f"[grad] {engine} refuses autograd: {e}")
            continue
        raise AssertionError(f"{engine} spread a force that requires grad")


def phase_grad() -> dict:
    """Reverse mode on the card: the flagship's adjoint on ``packed``,
    the f64 gradient against the CPU's, the design drill and the
    cantilever, and the kernel engines refusing autograd. No hand kernel
    runs."""
    out = _grad_flagship()
    torch.cuda.empty_cache()
    _grad_card_vs_cpu()
    _grad_drills()
    _grad_refusals()
    torch.cuda.empty_cache()
    return out


PAR_SHARDS = 8            # parallel: shards of the flagship's (4, 2) mesh
PAR_WARM, PAR_STEPS = 3, 5  # parallel: warm and timed steps of each path
PAR_DRIVER_STEPS = 4      # parallel: the ex4 driver's sharded branch, steps
TOL_PAR_PROJ = 1e-5       # pencil vs SpectralPlan projection, rel. max|ref|
# the pinned form's ms/step (whole grid on cuda:0, cut and assembled at
# every seam), from an earlier run of this phase on an NVIDIA H100 80GB
# HBM3 at 700.00 W: quoted beside the block-resident figure, not compared
PAR_PINNED_MS = 111.945


def _par_compare(a, ref):
    """max|dX|/max|X| and max_d |du|/max|u| of a sharded state (blocks
    assembled at this edge) against an unsharded one."""
    from ibamr_tpu_torch.parallel.mesh import unshard_state

    w = unshard_state(a)
    dX = float((w.X - ref.X).abs().max() / ref.X.abs().max())
    umax = max(float(c.abs().max()) for c in ref.ins.u)
    du = max(float((x - y).abs().max()) for x, y in zip(w.ins.u,
                                                         ref.ins.u)) / umax
    return dX, du


def _par_flagship(mesh) -> dict:
    """The flagship through the block-resident ``make_sharded_step`` on
    ``mesh`` against the unsharded ``scatter`` step from the same state,
    twice for the bits; every grid array in blocks on the card, and the
    census of one step counts its whole-grid layouts (0)."""
    from ibamr_tpu_torch.analysis.graph_census import graph_census
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.parallel import workload
    from ibamr_tpu_torch.parallel.mesh import make_sharded_step, place_state
    from ibamr_tpu_torch.parallel.spmd import Blocks
    from ibamr_tpu_torch.utils.tree import leaves

    integ, st0 = build_shell_example(use_fast_interaction="scatter",
                                     dtype=torch.float32, device=DEVICE,
                                     **FLAGSHIP)
    grid = integ.ins.grid

    def run(step, s):
        for _ in range(PAR_WARM):
            s = step(s, DT_FLAGSHIP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAR_STEPS):
            s = step(s, DT_FLAGSHIP)
        torch.cuda.synchronize()
        return s, (time.perf_counter() - t0) * 1e3 / PAR_STEPS

    ref, ref_ms = run(integ.step, st0)
    sstep = make_sharded_step(integ, mesh)
    if (sstep.integ.ib.engine_name != "sharded"
            or sstep.integ.ins.fused_stokes is not None):
        raise AssertionError("the sharded step did not swap in the "
                             "co-partitioned transfers and pencil solves")
    a, sh_ms = run(sstep, place_state(st0, grid, mesh))
    b, _ = run(sstep, place_state(st0, grid, mesh))
    bitwise = all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    dev_type = torch.device(DEVICE).type
    blocks = [x for x in leaves(a.ins) if isinstance(x, Blocks)]
    resident = (len(blocks) == 2 * grid.dim + 1
                and all(x.mesh is mesh for x in blocks))
    on_card = all(blk.device.type == dev_type for x in blocks
                  for blk in x.blocks) and all(
        x.device.type == dev_type for x in leaves(a))
    cen = graph_census(lambda s: sstep(s, DT_FLAGSHIP), (a,))
    dX, du = _par_compare(a, ref)
    eng = sstep.integ.ib.engine(a.X.shape[0])
    bk = eng.buckets(a.X, a.mask)
    counts = workload.shard_marker_counts(a.X.cpu().numpy(), grid,
                                          eng.sizes)
    log(f"[parallel] {SMI_LINE[0]}: flagship {FLAGSHIP} "
        f"({st0.X.shape[0]} markers), f32, dt={DT_FLAGSHIP:g}, {PAR_WARM} "
        f"warm + {PAR_STEPS} timed steps: block-resident on "
        f"{dict(mesh.shape)} shards of {mesh.first_device} {sh_ms:.3f} "
        f"ms/step, unsharded scatter {ref_ms:.3f} ms/step (x"
        f"{sh_ms / ref_ms:.3f}); the pinned form (whole grid on cuda:0) "
        f"took {PAR_PINNED_MS} ms/step in an earlier run (another call); "
        f"markers per shard {counts.ravel().tolist()} (cap "
        f"{eng.cap}, overflow {bk.overflow})")
    log(f"[parallel] census of one block-resident step: whole-grid "
        f"layouts {cen['whole_grid_layouts']}, ppermute "
        f"{cen['ppermute_prims']} ({cen['ppermute_bytes']} B), all_to_all "
        f"{cen['all_to_all_prims']} ({cen['all_to_all_bytes']} B), aten "
        f"ops {cen['aten_ops']}, host syncs {cen['host_syncs']}")
    log(f"[parallel] sharded vs unsharded after {PAR_WARM + PAR_STEPS} "
        f"steps: max|dX|/max|X|={dX:.3e} (tol {TOL_PARITY_X:g}), "
        f"max_d |du|/max|u|={du:.3e} (tol {TOL_PARITY_U:g}); bitwise run "
        f"to run {bitwise}; {len(blocks)} grid arrays in blocks of "
        f"{mesh.size} shards {resident}, every block and leaf on the card "
        f"{on_card}")
    if not (dX <= TOL_PARITY_X and du <= TOL_PARITY_U and bitwise
            and resident and on_card and cen["whole_grid_layouts"] == 0):
        raise AssertionError("the sharded flagship missed one of its "
                             "checks (see the [parallel] lines above)")
    return dict(integ=integ, state=a, sh_ms=sh_ms, ref_ms=ref_ms,
                step=sstep, st0=st0, ref=ref)


def _par_gpus(out) -> None:
    """The flagship over one shard per visible GPU, when several are
    visible, against the unsharded step; with one, a line says so."""
    from ibamr_tpu_torch.parallel.mesh import (make_mesh, make_sharded_step,
                                               place_state)

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[parallel] {n} GPU visible: the leg over several GPUs did "
            f"not run (nothing was measured across cards)")
        return
    mesh = make_mesh(n, device=DEVICE)
    sstep = make_sharded_step(out["integ"], mesh)
    s = place_state(out["st0"], out["integ"].ins.grid, mesh)
    def sync():
        for k in range(n):
            torch.cuda.synchronize(k)

    for _ in range(PAR_WARM):
        s = sstep(s, DT_FLAGSHIP)
    sync()
    t0 = time.perf_counter()
    for _ in range(PAR_STEPS):
        s = sstep(s, DT_FLAGSHIP)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / PAR_STEPS
    dX, du = _par_compare(s, out["ref"])
    devs = sorted({str(b.device) for b in s.ins.u[0].blocks})
    log(f"[parallel] flagship over {dict(mesh.shape)} shards on {devs}: "
        f"{ms:.3f} ms/step; vs unsharded max|dX|/max|X|={dX:.3e}, "
        f"max_d |du|/max|u|={du:.3e}")
    if not (dX <= TOL_PARITY_X and du <= TOL_PARITY_U and len(devs) == n):
        raise AssertionError("the flagship over several GPUs missed a "
                             "check")


def phase_gpus() -> None:
    """Run only when named, on a host with several GPUs: the
    block-resident flagship over one shard per visible GPU against the
    unsharded ``scatter`` step (``_par_gpus``), then the ex4 driver on
    the north-star input with no mesh given, which shards over every
    visible GPU by itself, against the unsharded steps of the same
    build."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.parallel.spmd import Blocks
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    n = torch.cuda.device_count()
    integ, st0 = build_shell_example(use_fast_interaction="scatter",
                                     dtype=torch.float32, device=DEVICE,
                                     **FLAGSHIP)
    ref = st0
    for _ in range(PAR_WARM):
        ref = integ.step(ref, DT_FLAGSHIP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_STEPS):
        ref = integ.step(ref, DT_FLAGSHIP)
    torch.cuda.synchronize()
    log(f"[gpus] {SMI_LINE[0].splitlines()[0]} x{n}: the unsharded scatter "
        f"flagship on cuda:0 "
        f"{(time.perf_counter() - t0) * 1e3 / PAR_STEPS:.3f} ms/step "
        f"({PAR_WARM} warm + {PAR_STEPS} timed steps)")
    _par_gpus(dict(integ=integ, st0=st0, ref=ref))
    del integ, st0, ref
    torch.cuda.empty_cache()
    if n < 2:
        return
    steps = PAR_DRIVER_STEPS
    db = parse_input_file(os.path.join(ROOT, DRIVER_INPUT))
    with tempfile.TemporaryDirectory() as tmp:
        main = db.get_database("Main")
        for key, val in (("log_file", os.path.join(tmp, "metrics.jsonl")),
                         ("viz_dirname", os.path.join(tmp, "viz")),
                         ("restart_dirname", os.path.join(tmp, "restart")),
                         ("viz_dump_interval", steps),
                         ("restart_interval", 0)):
            main.put(key, val)
        db.get_database("INSStaggeredHierarchyIntegrator").put(
            "num_steps", steps)
        t0 = time.perf_counter()
        st = ib_explicit_ex4.run(db, device=DEVICE)
        for k in range(n):
            torch.cuda.synchronize(k)
        wall = time.perf_counter() - t0
    integ, ref = build_shell_example(input_db=db, dtype=torch.float32,
                                     device=DEVICE)
    for _ in range(steps):
        ref = integ.step(ref, DT_FLAGSHIP)
    dX, du = _par_compare(st, ref)
    u0 = st.ins.u[0]
    devs = (sorted({str(b.device) for b in u0.blocks})
            if isinstance(u0, Blocks) else [])
    log(f"[gpus] ex4 driver with no mesh on {n} GPUs, {DRIVER_INPUT}, "
        f"{steps} steps in {wall:.1f} s (build included): blocks on "
        f"{devs}; vs the unsharded steps max|dX|/max|X|={dX:.3e}, "
        f"max_d |du|/max|u|={du:.3e}")
    if not (len(devs) == n and dX <= TOL_PARITY_X and du <= TOL_PARITY_U):
        raise AssertionError("the ex4 driver did not shard over every GPU "
                             "or missed a bound")


def _par_driver(tmp: str) -> None:
    """The ex4 driver's sharded branch on the north-star input
    (``run(..., mesh=make_mesh(8))``: the resolved engine's transfers
    swapped for the co-partitioned ones) against its own unsharded run
    of the same database: records, viz files and the final state; the
    sharded run's checkpoint (assembled from the blocks) restores into
    blocks bitwise."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.parallel.mesh import make_mesh, unshard_state
    from ibamr_tpu_torch.parallel.spmd import Blocks
    from ibamr_tpu_torch.utils.checkpoint import restore_checkpoint
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager
    from ibamr_tpu_torch.utils.tree import leaves

    steps = PAR_DRIVER_STEPS
    runs = {}
    for name in ("sharded", "unsharded"):
        db = parse_input_file(os.path.join(ROOT, DRIVER_INPUT))
        main = db.get_database("Main")
        d = os.path.join(tmp, f"ex4_{name}")
        for key, val in (("log_file", os.path.join(d, "metrics.jsonl")),
                         ("viz_dirname", os.path.join(d, "viz")),
                         ("restart_dirname", os.path.join(d, "restart")),
                         ("viz_dump_interval", steps // 2),
                         ("restart_interval",
                          steps if name == "sharded" else 0)):
            main.put(key, val)
        db.get_database("INSStaggeredHierarchyIntegrator").put(
            "num_steps", steps)
        timer = TimerManager.instance()
        timer.reset()
        mesh = (make_mesh(PAR_SHARDS, max_axes=2, device=DEVICE)
                if name == "sharded" else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = ib_explicit_ex4.run(db, device=DEVICE, mesh=mesh)
        torch.cuda.synchronize()
        adv = timer.get("IB::advanceHierarchy")
        with open(main.get_string("log_file")) as fh:
            recs = [json.loads(ln) for ln in fh.read().splitlines()]
        same = None
        if name == "sharded":
            ck, _, _ = restore_checkpoint(
                main.get_string("restart_dirname"), st, step=steps)
            same = (isinstance(ck.ins.u[0], Blocks)
                    and all(torch.equal(x, y)
                            for x, y in zip(leaves(ck), leaves(st))))
        runs[name] = dict(state=st, recs=recs, wall=time.perf_counter() - t0,
                          ms=1e3 * adv.total / steps, ckpt=same,
                          viz=sorted(os.listdir(main.get_string(
                              "viz_dirname"))))
    sh, un = runs["sharded"], runs["unsharded"]
    dX, du = _par_compare(sh["state"], un["state"])
    resident = isinstance(sh["state"].ins.u[0], Blocks)
    dke = max(abs(a["ke"] - b["ke"]) / abs(b["ke"])
              for a, b in zip(sh["recs"], un["recs"]))
    log(f"[parallel] ex4 driver, {DRIVER_INPUT}, {steps} steps: sharded "
        f"branch on {PAR_SHARDS} shards of {DEVICE} {sh['ms']:.3f} "
        f"ms/step with the first chunk's set-up ({sh['wall']:.1f} s whole "
        f"run), unsharded {un['ms']:.3f} ms/step ({un['wall']:.1f} s); "
        f"max|dX|/max|X|={dX:.3e}, max_d |du|/max|u|={du:.3e}, records "
        f"{[r['step'] for r in sh['recs']]} vs "
        f"{[r['step'] for r in un['recs']]}, max rel. KE difference "
        f"{dke:.3e}; viz {sh['viz']}; checkpoint restored bitwise "
        f"{sh['ckpt']} (into blocks {resident})")
    finite = all(bool(torch.isfinite(t).all()) for t in leaves(
        unshard_state(sh["state"])) if t.is_floating_point())
    if not (dX <= TOL_PARITY_X and du <= TOL_PARITY_U and resident
            and finite and sh["ckpt"] and sh["viz"] == un["viz"]
            and [r["step"] for r in sh["recs"]]
            == [r["step"] for r in un["recs"]]):
        raise AssertionError("the ex4 driver's sharded branch missed a "
                             "check")


def _par_breakdown(sstep, state, step_ms: float) -> None:
    """Where the sharded step's time goes: each stage alone on the state
    the timed leg reached (host clock around a synchronize, and the
    profiler's device busy time), then the whole step's device time and
    the top host ops by self CPU time."""
    integ, s, dt = sstep.integ, state, DT_FLAGSHIP
    ib, grid = integ.ib, integ.ins.grid
    ctx = ib.prepare(s.X, s.mask)
    U = ib.interpolate_velocity(s.ins.u, grid, s.X, s.mask, ctx=ctx)
    F = ib.compute_force(s.X, U, s.ins.t)
    f = ib.spread_force(F, grid, s.X, s.mask, ctx=ctx)
    stages = [("bucket", 2, lambda: ib.prepare(s.X, s.mask)),
              ("interp", 2, lambda: ib.interpolate_velocity(
                  s.ins.u, grid, s.X, s.mask, ctx=ctx)),
              ("spread", 1, lambda: ib.spread_force(F, grid, s.X, s.mask,
                                                    ctx=ctx)),
              ("fluid", 1, lambda: integ.ins.step(s.ins, dt, f=f))]
    for name, per_step, fn in stages:
        host = _host_ms(fn, 3)
        dev, kernels, _ = _device_ms(fn, 1)
        log(f"[parallel] breakdown {name:7s} x{per_step}/step: host "
            f"{host:.3f} ms, device busy {dev:.3f} ms in {kernels:.0f} "
            f"kernels per call")
    dev, kernels, prof = _device_ms(lambda: sstep(s, dt), 1)
    log(f"[parallel] breakdown whole sharded step: device busy {dev:.3f} "
        f"ms in {kernels:.0f} kernels of {step_ms:.3f} ms/step: idle share "
        f"{1 - dev / step_ms:.3f}")
    rows = sorted(prof.key_averages(),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in rows[:12]:
        log(f"[parallel] breakdown host op {e.key[:60]:60s} calls "
            f"{e.count:6d} self CPU {e.self_cpu_time_total / 1e3:.3f} ms")


def _par_projection(mesh, grid) -> float:
    """``PencilFFT.project_divergence_free`` at the flagship's grid
    against ``solvers/fft.py``'s (``SpectralPlan``) projection."""
    from ibamr_tpu_torch.ops import stencils
    from ibamr_tpu_torch.parallel.fftpar import PencilFFT
    from ibamr_tpu_torch.solvers import fft

    gen = torch.Generator(device=DEVICE).manual_seed(19)
    u = tuple(torch.randn(grid.n, generator=gen, device=DEVICE)
              for _ in range(grid.dim))
    pencil = PencilFFT(grid, mesh)
    got, _ = pencil.project_divergence_free(u, grid.dx)
    want, _ = fft.project_divergence_free(u, grid.dx)
    dev = max(float((g - w).abs().max()) / float(w.abs().max())
              for g, w in zip(got, want))
    div = float(stencils.divergence(got, grid.dx).abs().max())
    p_ms = _host_ms(lambda: pencil.project_divergence_free(u, grid.dx), 5)
    s_ms = _host_ms(lambda: fft.project_divergence_free(u, grid.dx), 5)
    log(f"[parallel] projection at {grid.n} on {dict(mesh.shape)} shards: "
        f"pencil vs SpectralPlan max|d|/max|ref|={dev:.3e} (tol "
        f"{TOL_PAR_PROJ:g}), max|div u| after the pencil's {div:.3e}; "
        f"{p_ms:.3f} ms pencil, {s_ms:.3f} ms SpectralPlan (host clock "
        f"around a synchronize, 5 calls)")
    if not dev <= TOL_PAR_PROJ:
        raise AssertionError("the pencil projection disagrees with "
                             "SpectralPlan's")
    return dev


def _par_checkpoint(integ, state, mesh, tmp: str) -> None:
    """The flagship state as an 8-shard checkpoint, restored onto 4
    shards and onto 1, bitwise."""
    from ibamr_tpu_torch.parallel.mesh import (make_mesh, place_state,
                                               unshard_state)
    from ibamr_tpu_torch.utils import checkpoint_sharded as cs
    from ibamr_tpu_torch.utils.tree import leaves, tree_map

    grid = integ.ins.grid
    placed = place_state(state, grid, mesh)
    d = os.path.join(tmp, "sharded_ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdir = cs.save_sharded_checkpoint(d, placed, 8, mesh=mesh)
    write_s = time.perf_counter() - t0
    sizes = [os.path.getsize(os.path.join(sdir, f))
             for f in sorted(os.listdir(sdir)) if f.startswith("shard-")]
    if not cs.verify_sharded_checkpoint(d, 8) or len(sizes) != mesh.size:
        raise AssertionError("the flagship's sharded checkpoint did not "
                             "verify")
    out = []
    for n in (4, 1):
        m = make_mesh(n, max_axes=2, device=DEVICE)
        tmpl = place_state(tree_map(torch.zeros_like, state), grid, m)
        t0 = time.perf_counter()
        got, step, _ = cs.restore_sharded(d, tmpl, step=8)
        torch.cuda.synchronize()
        rs = time.perf_counter() - t0
        same = all(torch.equal(x, y) for x, y in zip(
            leaves(unshard_state(got)), leaves(unshard_state(state))))
        lay = got.ins.u[0].sharding
        out.append((n, rs, same and lay.mesh.size == n
                    and got.X.device.type == torch.device(DEVICE).type))
    log(f"[parallel] flagship state as an {mesh.size}-shard checkpoint: "
        f"write {write_s:.3f} s, bytes per shard file {sizes} (total "
        f"{sum(sizes)}); restore onto 4 shards {out[0][1]:.3f} s bitwise "
        f"{out[0][2]}, onto 1 {out[1][1]:.3f} s bitwise {out[1][2]} "
        f"(warm page cache)")
    if not all(ok for _, _, ok in out):
        raise AssertionError("the 8 -> 4 -> 1 restore was not bitwise")


def phase_parallel(breakdown: bool = False) -> dict:
    """The parallel layer on the card: the sharded flagship, the pencil
    projection, the sharded checkpoint of the flagship's state, the
    sharded-checkpoint drill and the lane-mesh fleet. No hand kernel
    runs (the transfers are the sharded scatter's)."""
    from ibamr_tpu_torch.parallel.mesh import make_mesh
    from ibamr_tpu_torch.tools import fault_injection as fi

    mesh = make_mesh(PAR_SHARDS, max_axes=2, device=DEVICE)
    out = _par_flagship(mesh)
    if breakdown:
        _par_breakdown(out["step"], out["state"], out["sh_ms"])
    _par_gpus(out)
    _par_projection(mesh, out["integ"].ins.grid)
    with tempfile.TemporaryDirectory() as tmp:
        _par_checkpoint(out["integ"], out["state"], mesh, tmp)
        for key in ("state", "st0", "ref"):
            del out[key]
        torch.cuda.empty_cache()
        _par_driver(tmp)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = fi.run_sharded_smoke(os.path.join(tmp, "drill"),
                                   device=DEVICE)
        log(f"[parallel] sharded-checkpoint drill on the card "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(res)}")
        t0 = time.perf_counter()
        fl = fi.run_fleet_smoke(os.path.join(tmp, "fleet"), device=DEVICE,
                                engine="scatter", mesh_shards=PAR_SHARDS)
        log(f"[parallel] fleet drill (32^3 shell, 8 lanes, f64, scatter) "
            f"with its lane-mesh leg on the card "
            f"({time.perf_counter() - t0:.1f} s): replicated "
            f"{fl['fleet_wall_s']:.3f} s, lane mesh {json.dumps(fl['mesh_leg'])}; "
            f"incidents {[r['event'] for r in fl['incidents']]}, replay "
            f"{fl['replay_verdict']}")
    torch.cuda.empty_cache()
    return out


def phase_microbench() -> None:
    """The fluid and transfer microbenchmarks at the flagship size, each
    result on one ``[microbench]`` JSON line (run only when named)."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.tools import microbench_fluid, microbench_transfer

    n = FLAGSHIP["n_cells"]
    fluid = microbench_fluid.run(n=n, device=DEVICE, quiet=True)
    log(f"[microbench] fluid {json.dumps(fluid)}")
    torch.cuda.empty_cache()
    ci.reset_launch_counts()
    transfer = microbench_transfer.run(n=n, device=DEVICE, quiet=True)
    log(f"[microbench] transfer {json.dumps(transfer)}; kernel launches "
        f"{dict(ci.LAUNCHES)}")
    torch.cuda.empty_cache()


ANALYSIS_TRACE_STEPS = 2  # analysis: profiled flagship steps per engine
# the flagship's hand-kernel launches a step on each kernel engine (the
# kernel table's launches/step)
ANALYSIS_KERNELS = {"pallas_packed": {"packed_spread": 3, "packed_interp": 6},
                    "pallas": {"tile_spread": 3, "tile_interp": 6},
                    "packed": {}}


def _card_copies(cen: dict) -> dict:
    """The card-only counts of a census (``contracts.CARD_METRICS``)."""
    from ibamr_tpu_torch.analysis.contracts import CARD_METRICS

    return {m: int(cen[m]) for m in CARD_METRICS}


def _card_vs_budget(cen: dict, budget: dict, card):
    """Metric-by-metric comparison of an artifact's card census with its
    committed CPU budget and its committed card counts (``card``, the
    budgets file's ``card`` entry, None if it has none). Returns
    (mismatches, named differences). The device-to-host copies run no op
    on the CPU: they must equal the card entry exactly, and are then
    taken out of ``host_syncs`` for the CPU comparison. The hand-kernel
    launches (``custom_calls``) are named; where the artifact replays
    CUDA graphs on the card, their ops bypass the dispatcher, so each
    ceiling may only be lower."""
    from ibamr_tpu_torch.analysis.graph_census import BUDGET_MIN_METRICS

    bad = {}
    copies = _card_copies(cen)
    if copies != card:
        bad["card"] = (copies, card)
    got = dict(cen)
    got["host_syncs"] -= cen["host_copies"]
    got["host_syncs_in_chunk"] -= cen["host_copies_in_chunk"]
    named = {k: v for k, v in copies.items() if v}
    if cen["custom_calls"]:
        named["custom_calls"] = cen["custom_calls"]
    graphed = cen["graph_replays"] > 0
    if graphed:
        named["graph_replays"] = cen["graph_replays"]
    for m, bound in budget.items():
        if m == "custom_calls":
            continue
        v = int(got[m])
        ok = (v <= bound if graphed and m not in BUDGET_MIN_METRICS
              else v == bound)
        if not ok:
            bad[m] = (v, bound)
    return bad, named


def _analysis_light(card: dict):
    """Every light artifact of the registry on the card: its dispatch
    census against the committed CPU budget and card counts
    (``_card_vs_budget``). Returns the measured card counts and the
    artifacts that differ."""
    from ibamr_tpu_torch.analysis import contracts as C

    budgets = C.load_budgets()
    failed, seen = [], {}
    t0 = time.perf_counter()
    for name, art in C.ARTIFACTS.items():
        if art.heavy or not art.ported:
            continue
        t1 = time.perf_counter()
        cen = C.measure_census(name, DEVICE)
        seen[name] = _card_copies(cen)
        bad, named = _card_vs_budget(cen, budgets[name], card.get(name))
        log(f"[analysis] {name} on {DEVICE}: "
            f"{'equals' if not bad else 'DIFFERS FROM'} the budgets"
            f"{(' ' + json.dumps(bad)) if bad else ''}; named differences "
            f"{json.dumps(named)}; {cen['aten_ops']} aten ops "
            f"({time.perf_counter() - t1:.2f} s)")
        if bad:
            failed.append(name)
    log(f"[analysis] {len(budgets)} budgets, light artifacts on the card "
        f"in {time.perf_counter() - t0:.1f} s; differing: {failed}")
    torch.cuda.empty_cache()
    return seen, failed


def _analysis_flagship(engine: str) -> dict:
    """The flagship step on ``engine``: its dispatch census (one step
    after a warm-up) and its trace census (``ANALYSIS_TRACE_STEPS``
    profiled steps): kernels by class, device-to-host copies and syncs
    per step, and the hand-kernel launches of exactly these steps."""
    from ibamr_tpu_torch.analysis import contracts as C
    from ibamr_tpu_torch.analysis import graph_census as gc
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    with torch.no_grad():
        fn, args, _ = C.build_artifact(
            "solo_step_256", DEVICE, engine=engine, n=FLAGSHIP["n_cells"],
            n_lat=FLAGSHIP["n_lat"], n_lon=FLAGSHIP["n_lon"])
        ci.reset_launch_counts()
        fn(*args)                                   # warm caches
        cen = gc.graph_census(fn, args)
        tr = gc.profile_census(lambda: fn(*args),
                               steps=ANALYSIS_TRACE_STEPS, warmup=0)
        ran = dict(ci.LAUNCHES)
    metrics = gc.budget_metrics(cen)
    # the CPU's counting: a device-to-host copy runs no op there
    metrics["host_syncs"] -= cen["host_copies"]
    log(f"[analysis] flagship {FLAGSHIP} on {engine}: {cen['aten_ops']} "
        f"aten ops a step, dispatch census {json.dumps(metrics)}; "
        f"host syncs {cen['host_syncs']} ({cen['host_copies']} "
        f"device-to-host copies); hand kernels "
        f"{json.dumps(cen['custom_call_kernels'])}")
    log(f"[analysis] flagship on {engine}, trace of {ANALYSIS_TRACE_STEPS} "
        f"steps: {tr['kernels']:g} kernels a step "
        f"{json.dumps(tr['kernels_by_class'])}, {tr['d2h_copies']:g} "
        f"device-to-host copies and {tr['syncs']:g} syncs a step, "
        f"{tr['device_ms']:.3f} device ms a step "
        f"({SMI_LINE[0]})")
    want = ANALYSIS_KERNELS[engine]
    kern = {k: v for k, v in cen["custom_call_kernels"].items() if v}
    traced = {k: tr["kernels_by_class"].get(k, 0)
              for k in gc.HAND_KERNELS if tr["kernels_by_class"].get(k)}
    if kern != want or traced != want or cen["custom_calls"] != sum(
            want.values()):
        raise AssertionError(
            f"analysis: the flagship on {engine} launched {kern} (dispatch) "
            f"/ {traced} (trace) hand kernels a step, expected {want}")
    del fn, args
    torch.cuda.empty_cache()
    return dict(metrics=metrics, trace=tr, ran=ran, card=_card_copies(cen))


def _analysis_relay_watch() -> None:
    """``tools/relay_watch.py`` making one capture at its smallest sizes
    (a probe and three microbenchmark processes at 16^3, ~60 s on an
    H100), alone on the card: nothing else runs while it does. Its
    process group is killed if it outlives its time limit."""
    import shutil
    import signal

    tmp = tempfile.mkdtemp(prefix="relay_watch-")
    out = os.path.join(tmp, "capture.json")
    log_path = os.path.join(tmp, "watch.log")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ibamr_tpu_torch.tools.relay_watch",
         "--interval", "5", "--max-hours", "0.1", "--probe-timeout", "120",
         "--leg-timeout", "300", "--n", "16", "--n-lat", "8", "--reps",
         "1", "--out", out, "--log", log_path],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        with open(log_path) as f:
            wlog = f.read().strip().splitlines()
        cap = None
        if os.path.exists(out):
            with open(out) as f:
                cap = json.load(f)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[analysis] relay_watch took {time.perf_counter() - t0:.1f} s")
    for line in wlog:
        log(f"[analysis] relay_watch log: {line[:300]}")
    if cap is None:
        raise AssertionError("analysis: relay_watch made no capture")
    legs = {k: v.get("device") for k, v in cap["legs"].items()}
    log(f"[analysis] relay_watch (n=16): probe '{cap['probe']}', legs "
        f"{legs}")
    if sorted(legs) != sorted(("microbench_transfer", "microbench_fluid",
                               "microbench_grad")) \
            or set(legs.values()) != {"cuda"}:
        raise AssertionError("analysis: relay_watch's capture is "
                             "incomplete")


def phase_analysis() -> dict:
    """The analysis layer on the card: the flagship's census on each
    engine of ``ANALYSIS_KERNELS`` (its trace is timed: nothing else
    runs beside it); then every light artifact's census against the
    committed CPU budget and card counts, and ``jit_lint`` clean over
    the package (counts only), while ``init_backend_with_retry`` (its
    probe subprocess in a thread) and ``auto_backend`` find the card;
    last, ``relay_watch``'s capture, alone. Returns the launches."""
    import threading

    from ibamr_tpu_torch.analysis import contracts as C
    from ibamr_tpu_torch.analysis.jit_lint import lint_paths
    from ibamr_tpu_torch.utils import backend_guard

    card = C.load_card_counts()
    seen = {}
    ran = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    for engine in ANALYSIS_KERNELS:
        res = _analysis_flagship(engine)
        ran = {k: ran[k] + res["ran"][k] for k in ran}
        seen[f"solo_step_256:{engine}"] = res["card"]
        if engine == "packed":
            budget = C.load_budgets().get("solo_step_256")
            log(f"[analysis] solo_step_256 (packed) budget metrics "
                f"{json.dumps(res['metrics'])}")
            bad = {m: (res["metrics"][m], b)
                   for m, b in (budget or {}).items()
                   if m != "custom_calls" and res["metrics"][m] != b}
            if budget is None or bad:
                raise AssertionError(f"analysis: solo_step_256 differs "
                                     f"from its budget {bad}")
    log(f"[analysis] flagship censuses: {time.perf_counter() - t0:.1f} s")

    guard = {}

    def init():
        try:
            guard["init"] = backend_guard.init_backend_with_retry(
                retries=2, delay=1.0)
        except Exception as e:  # noqa: BLE001 - re-raised below
            guard["error"] = e

    probe = threading.Thread(target=init)
    probe.start()
    try:
        light, failed = _analysis_light(card)
        failed += [k for k, v in seen.items() if v != card.get(k)]
        seen.update(light)
        log(f"[analysis] card counts {json.dumps(seen, sort_keys=True)}")
        if failed:
            raise AssertionError(f"analysis: the card's census differs "
                                 f"from the budgets for {failed}")
        report = lint_paths([os.path.join(ROOT, "ibamr_tpu_torch")])
        stale = [w for w in report["waivers"]
                 if not (w["used"] and w["reason"])]
        log(f"[analysis] jit_lint: {report['files_scanned']} files, "
            f"{report['active_findings']} findings, "
            f"{len(report['waivers'])} waivers, {len(stale)} stale or bare")
        if report["active_findings"] or stale:
            raise AssertionError("analysis: jit_lint is not clean")
    finally:
        probe.join()
    if "error" in guard:
        raise guard["error"]
    name, line = guard["init"]
    dev = backend_guard.auto_backend()
    log(f"[analysis] init_backend_with_retry: {name}; probe '{line}'; "
        f"auto_backend -> {dev}")
    if (name != torch.cuda.get_device_name(0) or name not in line
            or dev.type != "cuda"):
        raise AssertionError("analysis: the backend guard did not find "
                             "the card")
    _analysis_relay_watch()
    return ran


class _PhaseClock:
    """Seconds of each phase, logged as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        log(f"[time] {name}: {now - self.t:.1f} s")
        self.t = now


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,parity,path,deltas,hybrid,engines,"
                    "driver,auto,tune,ex0,ibfe3d,walls,open,ibfe,rigid,adv,"
                    "amr,mlamr,implicit,multiphase,resilience,prof,io,"
                    "assim,serve,grad,parallel,analysis",
                    help="comma-separated subset of kernels,parity,path,"
                    "deltas,hybrid,engines,driver,auto,tune,ex0,ibfe3d,"
                    "walls,open,"
                    "ibfe,rigid,adv,amr,mlamr,implicit,multiphase,"
                    "resilience,prof,io,assim,serve,grad,parallel,"
                    "analysis and the "
                    "shootout, gpus "
                    "and microbench, which run only when "
                    "named (add 'breakdown' for a profile of the step of "
                    "each that runs, the flagship's auto leg included; "
                    "hybrid and engines read the path phase's time, and "
                    "engines steps from its state)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(f"[device] {smi.stdout.strip()}")
    SMI_LINE[0] = smi.stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    clock = _PhaseClock()
    phase_build()
    rows = phase_kernels() if "kernels" in phases else {}
    clock.lap("build, kernels")
    if "parity" in phases:
        phase_parity()
        clock.lap("parity")
    launches = dict.fromkeys(KERNELS, 0)
    path_ms = float("nan")
    path = None
    if "path" in phases:
        ran, path_ms, integ, state = phase_path(WARMUP, STEPS)
        launches = {k: launches[k] + ran[k] for k in launches}
        if "breakdown" in phases:
            phase_breakdown(integ, state, path_ms, "pallas_packed")
        if "engines" in phases:
            path = (integ, state, path_ms)
        del integ, state
        clock.lap("path")
    delta_launches = {}
    if "deltas" in phases:
        delta_launches = phase_deltas()
        clock.lap("deltas")
    if "hybrid" in phases:
        ran = phase_hybrid(path_ms, "breakdown" in phases)
        launches = {k: launches[k] + ran[k] for k in launches}
        clock.lap("hybrid")
    if "engines" in phases:
        phase_engines(path, "breakdown" in phases)
        del path
        clock.lap("engines")
    if "driver" in phases:
        ran, step_ms, db, state = phase_driver(DRIVER_STEPS)
        launches = {k: launches[k] + ran[k] for k in launches}
        if "breakdown" in phases:
            from ibamr_tpu_torch.models.shell3d import build_shell_example

            # built as ib_explicit_ex4.run builds it, from the same database
            integ, _ = build_shell_example(input_db=db, dtype=torch.float32,
                                           device=DEVICE)
            phase_breakdown(integ, state, step_ms, "pallas")
        clock.lap("driver")
    if "auto" in phases:
        phase_auto(path_ms, "breakdown" in phases)
        clock.lap("auto")
    for name, fn in (("tune", phase_tune), ("shootout", phase_shootout)):
        if name in phases:
            ran = fn()
            launches = {k: launches[k] + ran[k] for k in launches}
            clock.lap(name)
    if "ex0" in phases:
        ran = phase_ex0("breakdown" in phases)
        launches = {k: launches[k] + ran[k] for k in launches}
        clock.lap("ex0")
    if "ibfe3d" in phases:
        ran = phase_ibfe3d("breakdown" in phases)
        launches = {k: launches[k] + ran[k] for k in launches}
        clock.lap("ibfe3d")
    # the 2D drivers and the AMR paths (the scatter oracle) run no hand
    # kernel: any launch in them fails
    for name, fn in (("walls", phase_walls), ("open", phase_open),
                     ("ibfe", phase_ibfe), ("rigid", phase_rigid),
                     ("adv", phase_adv), ("amr", phase_amr),
                     ("mlamr", phase_mlamr), ("implicit", phase_implicit),
                     ("multiphase", phase_multiphase)):
        if name in phases:
            _assert_no_launches(name, lambda: fn("breakdown" in phases))
            clock.lap(name)
    if "resilience" in phases:
        ran = phase_resilience()
        launches = {k: launches[k] + ran[k] for k in launches}
        clock.lap("resilience")
    flag = None
    if "prof" in phases:
        flag = phase_prof()
        launches = {k: launches[k] + flag["launches"][k] for k in launches}
        clock.lap("prof")
    if "io" in phases:
        if flag is None:
            from ibamr_tpu_torch.models.shell3d import build_shell_example

            integ, state = build_shell_example(
                use_fast_interaction="pallas_packed", dtype=torch.float32,
                device=DEVICE, **FLAGSHIP)
            flag = dict(integ=integ, state=state)
        phase_io(flag["integ"], flag["state"])
        clock.lap("io")
    del flag
    torch.cuda.empty_cache()
    if "assim" in phases:
        ran = phase_assim()
        launches = {k: launches[k] + ran[k] for k in launches}
        clock.lap("assim")
    if "serve" in phases:
        ran = phase_serve()
        launches = {k: launches[k] + ran[k] for k in launches}
        clock.lap("serve")
    if "grad" in phases:
        _assert_no_launches("grad", phase_grad)
        clock.lap("grad")
    if "parallel" in phases:
        _assert_no_launches("parallel",
                            lambda: phase_parallel("breakdown" in phases))
        clock.lap("parallel")
    if "analysis" in phases:
        ran = phase_analysis()
        launches = {k: launches[k] + ran[k] for k in launches}
        clock.lap("analysis")
    if "gpus" in phases:
        _assert_no_launches("gpus", phase_gpus)
        clock.lap("gpus")
    if "microbench" in phases:
        phase_microbench()
        clock.lap("microbench")

    # a row's launches: the IB_4 phases' and the deltas phase's of its
    # kernel at its delta
    table = []
    for name, v in rows.items():
        k = name.split("[")[0]
        d = name[len(k) + 1:].split(",")[0].rstrip("]") or "IB_4"
        table.append(dict(
            name=name, route="cuda", source=KERNELS[k][0],
            replaces=KERNELS[k][1],
            launches=(launches[k] if d == "IB_4" else 0)
            + delta_launches.get((k, d), 0), **v))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
