#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cfd2_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit; build every CUDA kernel from
   ``cfd2_tpu_torch/csrc`` (one ``nvcc`` per source, all started together)
   and the native mesh library (``make -C native``), without which the
   unstructured meshes of phases 6-7 cannot be generated in minutes;
2. hold each kernel against its plain PyTorch version on the card (max-abs
   error <= 1e-5 on O(1) random data; the gather and the fused
   prolongation exact): the two RB-GS kernels on small grids and on every
   level grid of the 589x1765 multigrid hierarchy, the leg in its four
   unfused forms and, against the plain leg composed with the plain grid
   transfers, in its two fused forms, the half-sweep into a new tensor and
   in place, and the half-sweep path's restricted residual
   (``rbgs_residual``, also to a coarse grid a row short); the leg in every
   form and the half-sweep timed on every level grid beside their byte
   bounds, the restricted residual at 589x1765 beside its bound and its
   plain version; the three banded kernels on square and
   rectangular index maps (K = 1, 3, 9, 17; the gather at C = 1, 2, 6 and
   the run-time C = 3, the fused prolongation at alpha 1 and 1.5; every
   product form of the solver and one that is not, a capped K = 9 map),
   compared and timed at M = 403,584, K = 3 beside their byte bounds: the
   gather at C = 6 and 1 and the fused prolongation of the first two coarse
   levels, the dot in all five forms, at a coarse level's shape and at a
   restriction's, and beside the library's sparse CSR product; the sweeps
   (C = 2, 8 sweeps) at 403,584 x 3 and 600,000 x 6 (resident form; the
   latter beside the per-sweep chain of mom2 dots it replaces, bit-equal)
   and 2,400,000 x 6 (streamed form), under both flushes beside their
   read-once bounds with their launch plans, and their grid barrier; the
   four stencil kernels of ``csrc/stencil.cu`` (the coupled matvec, the
   Jacobi momentum predict, the Schur right-hand side, the pressure
   gradient) bit-equal to their plain versions on grids from 7x19 to
   589x1765 (sweeps 1-14, with and without halo rows), timed at 589x1765
   under both flushes beside their read-once bounds, their plain versions
   and, but for the predict, the library's CSR product of the same
   function (A x of the assembled 3N x 3N matrix, G z_p, r_p - D z); the
   predict also bit for bit and timed at 834x2500 with 12 sweeps (the 2M
   case's) and as one launch per sweep, its row-sharded form; the host's
   time per wrapper call;
3. drive the main path: the 996,558-cell channel-obstacle mesh
   (min_cell=0.0017, 589x1765 grid), ``CoupledSolver`` with the structured
   multigrid (precond_type=1, fgmres_max_restarts=5), started from
   ``bench_developed_1m.npz``: the four stencil kernels held bit for bit
   against their plain versions on the solver's own assembled system, then
   3 untimed healing steps and 3 timed steps: ``rbgs_leg`` 14 times per
   FGMRES iteration, ``coupled_spmv`` once per matvec (the iterations' and
   the true residuals'), ``schur_rhs`` and ``pressure_gradient`` once and
   ``momentum_jacobi`` twice per FGMRES iteration, and the timed
   steps' FGMRES iterations those recorded since the RB-GS kernels took
   the JAX package's rounding (90, 58, 23; 90, 57, 28 before, with the
   stencils as eager PyTorch too: bit-equal kernels keep them);
4. the half-sweep path (CFD2_PALLAS=1) at full width: phase 3's solver
   restarted from its state after healing for 2 steps, with the outer
   iterations of phase 3's first two timed steps and their FGMRES
   iterations within 2 per outer; 28 half-sweeps and 7 restricted
   residuals (one per level's down leg) per FGMRES iteration and the
   stencil kernels at phase 3's rates;
5. one step of a ~5k-cell mesh on the card (kernels) and on the CPU (plain
   versions): equal outer iterations, u within 1e-4 * max|u|;
6. the unstructured main path: the 403,491-cell Delaunay channel-obstacle
   mesh (min_cell=0.003), aggregation AMG (precond_type=1), 3 steps from
   rest; before stepping, each banded kernel is held against its plain
   version on the solver's own maps (the mesh's and every coarse level's);
   all three banded kernels must be launched; steps 0-1 held to the round's
   bound against the JAX package's from-rest record and step 2 against its
   step from the card's own step-2 state (``--save-step2-input`` writes
   that state; ``cfd2_tpu_torch/data/delaunay_403k_step2_card.npz`` is the
   committed one, and the card's state is logged against it); after
   stepping, one V-cycle under the profiler must prolong through one fused
   launch per level, two device kernels per level fewer than the gather,
   product and sum;
7. the slot-capped path: the 115,505-cell Voronoi mesh (min_cell=0.004,
   ``bd_k == 8``), its maps held the same way, 2 steps from rest;
8. one step of a ~5k-cell Delaunay mesh on the card and on the CPU: equal
   outer iterations, u within 1e-4 * max|u|;
9. the solver's options and other entry points: on phase 3's developed 1M
   state after healing (restored before each run), one step with each
   option of ``OPTION_RUNS``, two host-mode steps (outer counts within 1 of
   phase 3's first two timed steps), two steps recycling the Krylov basis
   across steps, two ``multi_step_adaptive`` steps, a checkpoint round trip
   (a fresh solver loaded from it steps bit for bit as the original), and
   the presolve on a from-rest first step beside the same step without it;
   on phase 6's Delaunay solver one step with the bf16 basis and recycling
   (all three banded kernels launched); on the ~5k-cell meshes of phases 5
   and 8 every option for one step on the card and on the CPU (equal outer
   counts, u within 1e-4 * max|u|).  Each structured run on the card must
   launch ``rbgs_leg``; per run it logs outers, FGMRES iterations per
   outer, wall time and launches;
10. the generic-mesh paths: (a) the refined quadtree mesh 0.0025/0.005
   (132,080 cells on the multilevel layout, levels 400x1200 and 200x600 =
   600,000 device cells) from rest as bench_sweep.py starts its refined
   rows, with the fine-grid-embedded multigrid, 3 steps, after holding the
   banded kernels on its maps and ``rbgs_leg`` (every form, as in phase 2)
   on each grid of its fine-grid multigrid: ``rbgs_leg`` (2 per fine level
   per FGMRES iteration), ``banded_dot`` and ``banded_gather`` must be
   launched, and ``banded_jacobi_sweeps`` twice per FGMRES iteration with
   no per-sweep momentum dot (a map without a slot cap takes the one call
   above the JAX package's 12 MiB rule); then the first step again from
   rest with the momentum predict patched back to one dot per sweep: equal
   outer and FGMRES counts, max|du|/max|u| logged;
   (b) block-Jacobi (precond_type=2, fgmres_max_restarts=1) for one step on
   phase 3's developed 1M state and on phase 6's Delaunay solver (whose
   gather must launch ``banded_gather``); (c) card against CPU, one step
   each: the multilevel 0.01/0.04 mesh (8,817 cells; it also launches
   ``banded_jacobi_sweeps``), block-Jacobi and Chebyshev on the ~5k-cell
   cut-cell mesh, the aggregation AMG on the ~5k-cell Delaunay mesh with
   its banded map removed, the 75-cell channel too small for the structured
   multigrid, and one SIMPLE step: equal outer counts (block-Jacobi: or one
   apart where the later exit's last outer took 0 iterations), u within
   1e-4 * max|u|.  Per run it logs outers, FGMRES iterations per outer,
   host reads, wall time and launches;
11. the application layer: (a) ``python -m cfd2_tpu_torch.app`` as a
   subprocess at full width (the 996,558-cell channel smoothed as the app
   smooths it, the structured layout asserted, ``--precond 1``, 5 steps
   from the app's inlet-column start with adaptive dt, Cd/Cl each step):
   ``rbgs_leg`` launched 14 times per FGMRES iteration, every field
   finite; (b) one app step inside ``ProfilingStats.trace``, whose Chrome
   trace must name ``rbgs_leg``; (c) Cd/Cl of the developed 1M state on
   the card against the same formula in float64 on the host (each within
   1e-4 relative); (d) ``sweep_step`` over two viscosities on that state,
   each case equal to its single step (same outers, u within 1e-6); (e) the
   app on a Delaunay mesh (0.01, 3 steps): all three banded kernels
   launched; (f) the live server on a small mesh: the step advances and
   pause freezes it (a frame is fetched where matplotlib imports).  (c)
   and (d) take phase 3's state, or load it when phase 3 did not run;
12. the row-sharded paths (``cfd2_tpu_torch/parallel/spatial.py``) on 4
   ranks sharing the card through ``parallel/launch.py``'s ``run_ranks``,
   with the gloo transport, CUDA tensors staged through host memory (the
   transport is printed): (a) at full width, the main path's mesh encoded
   with ``pad_rows_to=4`` (589 -> 592 rows, 148 per rank), precond_type=1,
   started from ``bench_developed_1m.npz`` (padded with solid rows) healed
   by 3 one-process steps, as phase 3 runs it (the first healing step is
   also run in one process with and without the ranks' reduction order):
   one ``step`` and two ``multi_step_adaptive`` steps (CFL 0.5, h 0.0017), each
   against one process on the same padded mesh in the same call: equal outer
   counts, u within 1e-4 * max|u|, dt within 1e-9, ``rbgs_leg`` launched on
   every rank and, in the step, the four stencil kernels on every rank at
   their rates (the momentum predict in 8 launches per call there: the
   ranks exchange the iterate's edge rows between sweeps); per rank FGMRES
   iterations, exchanges and all-reduces per
   FGMRES iteration, bytes per exchange, walls; (b) ``banded_spmv_sharded``
   on phase 6's Delaunay mesh (403,584 device cells in 4 ranges of 100,896,
   halo = ``banded_bandwidth``) within 1e-5 * scale of ``ellsys.spmv`` on
   the card, and a sharded FGMRES solve (restart 20, 3 restarts, tol 1e-5):
   finite, > 0 iterations, ``banded_dot`` launched on every rank; (c)
   ``sweep_step`` of 4 viscosities on (a)'s start state, one case per rank
   (``shard_batch`` over the cases), each case bit-equal to its one-process
   step; (d) a distributed checkpoint of (a)'s stepped row-sharded state
   written by the 4 ranks and loaded here: bit-equal to the gathered state
   and to the ``.npz`` written from it; (e) the 4,636-cell mesh sharded over
   4 ranks on the card and over 4 ranks on the CPU: equal outer counts;
   and which gloo collectives take CUDA tensors (logged); (f) in (a)'s
   spawned group, from (a)'s start state restored before each run, every
   option of the sharded step (``SHARD_OPTION_RUNS``: the bf16 basis, the
   bf16 preconditioner, the mixed phase, the ADI predict, recycling across
   outers, Anderson mixing, two steps recycling across steps through
   ``step(..., krylov=)``, one step under ``CFD2_PALLAS=1`` and block-Jacobi
   cut to 10 outers by ``n_outer_correctors=1`` and to one restart cycle an
   outer), each against the same run in one process (taken while the ranks
   run) and beside a one-rank control (one process, the norms
   summed as the ranks sum them): equal counts on every rank; with one
   process's outer and FGMRES counts u within 1e-4 * max|u| (the run
   recycling across steps within ``RECYCLE_BOUND`` * max|u|), and where a
   solve or the outer loop ended on another iteration outers within 1,
   FGMRES iterations within 2 per outer and u within 5e-3 * max|u|;
   ``rbgs_leg`` launched on every rank of every run through the structured
   multigrid with ``CFD2_PALLAS`` unset, and under ``CFD2_PALLAS=1``
   ``rbgs_half_sweep`` and ``rbgs_residual`` on every rank at the
   one-process run's launches per FGMRES iteration; and the ADI
   preconditioner and the V-cycle (unset and ``CFD2_PALLAS=1``) applied
   once at full width, bit-equal to one process on every rank's rows; (g)
   every option of (f) and one ``simple_step`` on (e)'s mesh over 4 ranks on
   the card and on the CPU: equal outer counts. The mesh is built once here
   and the ranks get its encoded arrays through a file; four CUDA contexts
   time-share the card and every halo crosses the host, so the walls show
   correctness work, not speed;
13. the developed full-size cases of ``cfd2_tpu_torch/tools/
   developed_cases.py``, set up from its table (their meshes generated by
   ``tools/mesh_cache.py`` in background processes from the end of phase 1,
   into ``.bench_cache``): (a) ``structured_2m_developed``, the 1,998,381-cell
   channel (834x2500 grid) from ``bench_developed_2m.npz``, 3 heal steps and
   3 counted ones, 12 momentum sweeps: the stencil kernels held bit for bit
   on its assembled system (the predict at 12 sweeps, the most one launch
   runs) and the legs on its level grids, then ``momentum_jacobi`` in one
   launch per predict, ``rbgs_leg`` 16 per FGMRES iteration and the other
   stencil kernels at their rates (asserted); (b) ``delaunay_1m_developed``
   (1,004,266 cells, uncapped map) and (c) ``voronoi_893k_developed``
   (892,916 cells, ``bd_k`` 8 above the 12 MiB rule), both from the committed
   states of ``cfd2_tpu_torch/data``: the banded kernels held on the solver's
   maps, then 3 and 2 counted steps, with ``banded_jacobi_sweeps`` twice per
   FGMRES iteration on (b) and none on (c), whose predict runs one momentum
   dot per sweep (asserted); (d) ``refined_cutcell_130k_developed`` (the
   refined cut-cell mesh 0.0015 / 0.006, 129,663 cells on the banded
   layout, uncapped) from its committed state, 3 counted steps as (b);
   every field finite; each counted step held to
   the round's bound (equal outers, FGMRES iterations within 2 per outer)
   against ``cfd2_tpu_torch/data/fullsize_counts.json``'s JAX record where it
   has the step, and logged beside its port-CPU record (phases 6 and 10(a)
   hold theirs to the record's ``delaunay_403k_rest`` and
   ``refined_132k_rest`` the same way); (e) ``make_developed_unstructured``
   itself for 3 heal steps on (d)'s mesh, into ``.phase13`` (removed
   after);
14. the physics-validation path of ``cfd2_tpu_torch/tools/``: (a)
   Schäfer–Turek 2D-2 at D/h = 20 (35,804 cells on 82x440; parabolic inlet,
   BDF2, ``dt_old`` pinned) from rest through ``validate_turek``'s chunk
   loop for one 200-step chunk, every step's Cd and Cl finite, after the
   stencil kernels are held bit for bit on its assembled system and the
   legs on its level grids: ``rbgs_leg`` twice per smoothed level per
   FGMRES iteration and the four stencil kernels at their rates (asserted);
   (b) 3 Turek steps from ``cfd2_tpu_torch/data/turek_window_0.005.npz``,
   the state the card's full run saved at the start of its measurement
   window, held against the JAX package's steps from it
   (``cfd2_tpu_torch/data/validation_counts.json``, written by
   ``tests/torch_validation_counts.py``): the counts to the round's bound,
   max|u| within 1e-4 and max|p| within 1e-3 of the record's after each
   step; (c) the water backwards step (32,500 smoothed cells on the 100x350
   structured layout, asserted) through ``stiff_water.run``, 50 steps, each
   outer residual finite and below 1e10, the kernels held and counted as in
   (a), steps 0-2 held to the JAX package's record as in (b) and max|u|
   within 1e-3 (relative) of ``STIFF_X64.json``'s 0.386558; (d) the 32x32
   lid-driven cavity of ``tests/test_physics.py`` (set up by
   ``tests/torch_physics_cases.py``) for 100 steps with the JAX test's
   configuration and with ``precond_type=1`` (``rbgs_leg`` launched), each
   on the card and on the CPU: the centreline within 0.06 of Ghia et al.
   (1982), equal step counts, u within 1e-4 * max|u|; (e)
   ``measure_strouhal`` from ``bench_developed_1m.npz`` cut to 20 heal
   steps and one force sample: finite, and its Cd within 5e-3 (relative) of
   the JAX package's at the same cut (the same record);
15. the solver tools of ``cfd2_tpu_torch/tools/`` (the JAX package's
   ``tools/`` of the same names), each with every kernel's launch count
   zeroed just before and read just after: (a) ``live_demo_1m`` on the
   996,558-cell channel, 3 steps through the live server, then
   ``control?inlet=1.2`` read back from the solver's params (no frame: no
   matplotlib on the card's machine); (b) ``iters_1m`` (3 host-mode steps
   from rest on phase 3's mesh) and ``prof_step_iters`` (2 on phase 6's
   Delaunay mesh): their per-outer ladders, ``rbgs_leg``, ``banded_dot``
   and ``banded_jacobi_sweeps`` launched; (c) ``prof_precond`` at 1M (7
   variants) and ``prof_amg_variants`` at 403k (8 variants, with the
   V-cycle's contraction); (d) ``bf16_smoke`` at 0.005 (the four bf16
   combinations, 2 timed steps each); (e) ``probe_cavity`` at its defaults
   on the card and on the CPU (in a process of its own, at the same time):
   the Ghia error within 0.06 on the card and within 1e-3 of the CPU's;
   (f) ``stiff_water_x64`` (the water step with float64 norms, 50 steps):
   finite, max|u| within 1e-3 (relative) of ``STIFF_X64.json``'s; (g) the
   row-sharded aggregation fallback (``tests/torch_spatial_ranks.FALLBACK``:
   the 0.05 channel with the aggregation hierarchy, the 0.25 channel with
   none) on 4 gloo ranks sharing the card against one process on the card:
   equal counts, u within 1e-5, the replicated V-cycle's all-gathers and
   banded kernels.
16. the profiling tools of ``cfd2_tpu_torch/tools/`` (the JAX package's
   ``tools/prof_*.py`` and ``probe_bf16.py``), each in process with every
   kernel's launch count zeroed just before and read just after, each
   phase of a tool timed as host wall to a synchronisation beside the
   device's busy time: (a) ``prof_developed`` on ``bench_developed_1m.npz``
   at 0.0017 (its first three timed steps take phase 3's counts); (b)
   ``prof_outer`` from rest at 0.0017; (c) ``prof_banded2`` and (d)
   ``prof_banded`` on phase 6's 403,491-cell Delaunay mesh (the solve of
   (c) converges); (e) ``prof_refined_developed`` at its default, the
   developed refined cut-cell state (phase 13(d)'s mesh); (f)
   ``prof_fgmres`` at 0.0017
   (``fgmres30`` runs 30 iterations); (g) ``prof_fgmres_loop`` (exactly 30
   and 50 iterations); (h) ``prof_trace`` (one traced host-mode step); (i)
   ``prof_layout`` and (j) ``probe_bf16`` at 589x1765.  Every part whose
   path runs a hand kernel launched it.

The phases run in the order of ``RUN_ORDER``: 14 after 5, while phase 6's
mesh is made in the background, and 13 after 15, by when its Voronoi mesh,
the slowest, is made too.  Work that needs no other phase's result runs
beside the card's: the CPU halves of 14(d) and 15(e) in spawned processes,
phase 11's two app subprocesses together, 12(a)'s one-process references
while the ranks run, and 12(e)'s groups all at once.  Their walls are logged,
never compared.

Then a ``# KNOWN OPEN:`` line for each step that a phase logs beside a JAX
record without holding it there and that misses the record's bound (phase
10(a)'s step 2), the kernels' JSON line, the script's total wall and the
result line are printed.

``--phases 1,2`` runs only the listed phases (for bring-up: ``1,3,9`` runs
phase 9 on the 1M state alone, leaving out its Delaunay run); the result
line is printed only when every phase ran.

``--tree PATH`` runs phases 1 and 2 on the ``cfd2_tpu_torch`` of another
checkout of this repository unpacked inside this one (for example the parent
commit, ``git archive`` into a directory that ``.gitignore`` lists): its
kernels and wrappers, this script's inputs, loops and timers, so that two
commits are timed the same way on the same card in one call.  What that
checkout's wrappers do not offer (the fused legs, ``dot_form``) is left out;
where it has no fused prolongation, its gather, product and sum are timed in
its place, and its flat-layout half-sweep gets the planes moved to (n, 4)
outside the timed call.

``--export-forces PATH`` makes phase 11(c) also write what the force
formula reads of its state to ``PATH`` (``.npz``): the four face tensors of
the obstacle mask, the wall faces with their owner cells' geometry, u, p and
grad_p, the port's mask and its Cd/Cl.  ``tests/torch_forces_crosscheck.py``
reads it with the JAX package's ``utils/forces.py`` on a CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import inspect
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
MAIN_GRID = (589, 1765)
MAIN_CELLS = 996_558
DELAUNAY_MIN_CELL, DELAUNAY_CELLS = 0.003, 403_491
# Aggregates per coarse level of the Delaunay mesh's two-pass hierarchy.
DELAUNAY_LEVELS = (59_490, 5_227, 550, 112, 62)
VORONOI_MIN_CELL, VORONOI_CELLS = 0.004, 115_505
BANDED_SRC = "cfd2_tpu_torch/csrc/banded.cu"
BANDED_PALLAS = "cfd2_tpu/ops/banded_gather.py"
# Phase 10: the refined quadtree mesh on the multilevel layout.
MULTILEVEL_CELL, MULTILEVEL_CELLS = (0.0025, 0.005), 132_080
MULTILEVEL_GRIDS = ((400, 1200), (200, 600))
ALL_PHASES = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16}
RUN_ORDER = (1, 2, 3, 4, 5, 14, 6, 7, 8, 9, 10, 11, 12, 15, 13, 16)
# Phase 11: the app at full width (the main path's mesh, smoothed as the
# app smooths it) and on a Delaunay mesh, as subprocesses of the CLI.
APP_MAIN = ("--geometry", "channel", "--cell-size", "0.0017", "--precond",
            "1", "--steps", "5", "--forces", "--profile", "--log-every", "1")
APP_DELAUNAY = ("--geometry", "channel", "--cell-size", "0.01",
                "--mesh-type", "delaunay", "--precond", "1", "--steps", "3",
                "--profile", "--log-every", "1")
SWEEP_VISCOSITIES = (0.01, 0.005)
# Phase 12: the row-sharded paths on 4 ranks sharing the card.
SHARD_WORLD = 4
SHARD_GRID = (592, 1765)
SHARD_VISCOSITIES = (0.0025, 0.005, 0.01, 0.02)
SHARD_SMALL_CELL, SHARD_SMALL_CELLS = 0.025, 4636
# The ranks' inputs (a few hundred MiB), removed when the phase ends.
SHARD_DIR = ROOT / ".phase12"
# 12(f)-(g): (label, SolverConfig overrides, steps, CFD2_PALLAS) of each
# option on the row-sharded step.  Block-Jacobi hits its 250-iteration cap
# in every outer at this size (20 outers, 23.3 s in one process on an
# H100): n_outer_correctors=1 cuts it to the loop's floor of 10 outers.
SHARD_OPTION_RUNS = (
    ("fgmres_basis_bf16", dict(fgmres_basis_bf16=True), 1, None),
    ("precond_bf16", dict(precond_bf16=True), 1, None),
    ("fgmres_mixed_phase", dict(fgmres_mixed_phase=True), 1, None),
    ("precond_mom_adi=1", dict(precond_mom_adi=1), 1, None),
    ("fgmres_recycle=1", dict(fgmres_recycle=1), 1, None),
    ("anderson_depth=2", dict(anderson_depth=2), 1, None),
    ("fgmres_recycle=2", dict(fgmres_recycle=2), 2, None),
    ("CFD2_PALLAS=1", {}, 1, "1"),
    ("precond_type=2", dict(precond_type=2, n_outer_correctors=1,
                            fgmres_max_restarts=1), 1, None),
)
# Phase 9: one step of each SolverConfig option on the developed 1M state
# and on the small meshes (the Delaunay ones take those that act on the
# banded path, as in the JAX package).
OPTION_RUNS = (
    ("fgmres_basis_bf16", dict(fgmres_basis_bf16=True)),
    ("precond_bf16", dict(precond_bf16=True)),
    ("fgmres_mixed_phase", dict(fgmres_mixed_phase=True)),
    ("precond_mom_adi=1", dict(precond_mom_adi=1)),
    ("fgmres_incycle_window=5", dict(fgmres_incycle_window=5)),
    ("extrapolate_guess", dict(extrapolate_guess=True)),
    ("adaptive_linear_tol", dict(adaptive_linear_tol=True)),
    ("fgmres_recycle=1", dict(fgmres_recycle=1)),
    ("anderson_depth=2", dict(anderson_depth=2)),
    ("fgmres_f64_norms", dict(fgmres_f64_norms=True)),
)
STRUCTURED_ONLY = ("precond_bf16", "fgmres_mixed_phase", "precond_mom_adi=1")


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def level_grids(ny, nx, min_coarse=100):
    """The smoothed grids of the structured hierarchy (2x2 coarsening down
    to <= min_coarse cells, which get the dense solve)."""
    grids = []
    while ny * nx > min_coarse:
        grids.append((ny, nx))
        ny, nx = coarse_of((ny, nx))
    return grids, (ny, nx)


def cuda_time_ms(fn, reps=50, flush="write"):
    """Mean device time of ``fn`` per call in ms, from CUDA events around
    each call.  Before every call the 50 MB L2 cache is flushed (the solver
    finds its level-0 planes cold: FGMRES streams the basis between
    applications) by a pass over a 1 GiB buffer, which also keeps the device
    busy for some hundred microseconds, so that the host has enqueued the
    start event, the call and the end event before the device reaches them.
    Without that lead the interval between the events is the host's time to
    enqueue the call, not the kernel's.

    ``flush="write"`` zeroes the buffer.  It is the timer of every ``ms`` in
    the kernels' JSON line and of every time printed without another word,
    in this and in the earlier rounds of the port.  The cache is then full
    of the buffer's dirty lines, whose write-back the timed kernel's loads
    wait for: 5-7 us at these sizes that are none of the kernel's bytes.
    ``flush="read"`` reads the buffer (a reduction) and leaves clean lines;
    phase 2 prints its times beside the others for every kernel.
    Either way the interval holds the launch itself and the two event
    records, about 6 us: the times of grids of a few hundred cells show
    that floor."""
    import torch
    buf = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    wipe = {"read": buf.max, "write": buf.zero_}[flush]
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        wipe()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def host_us(fn, reps=200, batches=5):
    """Host time to enqueue ``fn`` once, in microseconds: the fastest of
    ``batches`` batches of ``reps`` calls (the host's cores are shared, and a
    mean takes in whatever else ran), with no synchronisation inside a batch
    (the kernels are small enough not to fill the queue)."""
    import torch
    for _ in range(10):
        fn()
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / reps * 1e6


def both_flushes_ms(fn, reps=30):
    """``fn`` timed under the write flush and under the read flush."""
    return (cuda_time_ms(fn, reps), cuda_time_ms(fn, reps, flush="read"))


def coarse_of(grid):
    ny, nx = grid
    return (ny + 1) // 2, (nx + 1) // 2


def bound_ms(n_bytes, n_flops):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_flops / F32_FLOPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ----------------------------------------------------------------------


def _ptxas_summary(out, fragment):
    """``name<template arguments>: registers, spill bytes`` of each kernel
    whose mangled name holds ``fragment``, from ``-Xptxas -v`` output."""
    import re
    rows, name = [], None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None or fragment not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} spill bytes"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            short = re.search(fragment + r"\w*?(?=I)", name)
            args = re.findall(r"Li(\d+)E", name)
            label = (short.group(0) if short else name) + f"<{','.join(args)}>"
            rows.append(f"{label} {m.group(1)} registers, {spills}")
            name = None
    return rows


def phase_build_native():
    """The native mesh library, which the background meshes need."""
    # The native mesh library: Poisson-disk sampling and the greedy
    # aggregation scan.  Their pure-Python fallbacks would not finish the
    # 400k-cell mesh in minutes, so a failed build fails here, at once.
    from cfd2_tpu_torch.mesh import native
    t0 = time.time()
    # Always rebuilt: the library is compiled for the machine it is built on.
    how = native.build(rebuild=True)   # raises with the compiler's output
    check(native.available(), "native/libmeshkern.so built but did not load")
    log(f"phase 1: native mesh library {how} in {time.time() - t0:.1f} s "
        "(sampler: native meshkern_poisson_disk; aggregation: native "
        "meshkern_amg_aggregate)")


def phase_build_kernels():
    """Every kernel library of cfd2_tpu_torch/csrc, built and loaded."""
    from cfd2_tpu_torch.ops import _build
    t0 = time.time()
    outs = _build.build_all(extra_flags=("-Xptxas", "-v"))
    for name, out in outs.items():
        log(f"# nvcc csrc/{name}.cu:\n{out.strip()}")
    if "banded" in outs:
        log("phase 1: ptxas, sweeps kernels: "
            + "; ".join(_ptxas_summary(outs["banded"], "jacobi_sweeps")))
    if "stencil" in outs:
        log("phase 1: ptxas, streamed predict: "
            + "; ".join(_ptxas_summary(outs["stencil"], "momentum_stream")))
    for name in _build.SIGNATURES:
        _build.load(name)
    log(f"phase 1: built {sorted(_build.SIGNATURES)} in "
        f"{time.time() - t0:.1f} s")


def _grid_system(ny, nx, seed, device):
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return (t(rng.uniform(1, 2, (ny, nx))),
            t(rng.standard_normal((4, ny, nx)) * 0.1),
            t(rng.standard_normal((ny, nx))),
            t(rng.standard_normal((ny, nx))))


# The product forms of banded_dot that the solver uses, each a kernel
# instantiation of its own: name -> (operands, planes, prods).  Stated here
# and not read from the package: the script also times checkouts (--tree)
# whose wrapper names no forms, and holds the package's choice against this
# list (``dot_form``).
DOT_FORMS = {
    "spmv": (3, 6, (((0, 0), (1, 2)), ((0, 1), (2, 2)),
                    ((3, 0), (4, 1), (5, 2)))),
    "mom2": (2, 1, (((0, 0),), ((0, 1),))),
    "schur_rhs": (2, 2, (((0, 0), (1, 1)),)),
    "grad": (1, 2, (((0, 0),), ((1, 0),))),
    "scalar": (1, 1, (((0, 0),),)),
}
# A list the solver never passes: it takes the kernel's generic instantiation.
DOT_OTHER = (2, 2, (((1, 0), (0, 1)), ((1, 1),)))


def _band_map(M, n_src, K, seed, device, spread=640):
    """An (M, K) int32 index map with each row's sources sorted and within
    ``spread`` of the row's own position (the shape of a band-ordered
    mesh's neighbor map, or of an aggregate's member list)."""
    import torch
    rng = np.random.default_rng(seed)
    centre = (np.arange(M) * (n_src / M)).astype(np.int64)[:, None]
    idx = centre + rng.integers(-spread, spread + 1, (M, K))
    idx = np.sort(np.clip(idx, 0, n_src - 1), axis=1)
    return torch.as_tensor(idx.astype(np.int32), device=device)


def _rand(shape, seed, device, scale=1.0):
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32),
        device=device)


def _maxerr(got, ref):
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def _check_banded_errs(err_g, err_d, err_s):
    check(err_g == 0.0, f"banded_gather is not exact: {err_g:.3e}")
    check(err_d <= TOL, f"banded_dot disagrees with its plain version: "
          f"{err_d:.3e}")
    check(err_s <= TOL, f"banded_jacobi_sweeps disagrees with its plain "
          f"version: {err_s:.3e}")


def _dot_csr(offs, idx, prods, n_x, n_src):
    """The products of one banded_dot call as a sparse CSR matrix of
    (len(prods) * M, n_x * n_src): applied to the stacked operands it gives
    the stacked outputs."""
    import torch
    M, K = idx.shape
    row = torch.arange(M, device=idx.device)[:, None].expand(M, K)
    rows, cols, vals = [], [], []
    for j, pairs in enumerate(prods):
        for (oi, ci) in pairs:
            rows.append((row + j * M).reshape(-1))
            cols.append((idx.long() + ci * n_src).reshape(-1))
            vals.append(offs[oi].reshape(-1))
    A = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (len(prods) * M, n_x * n_src)).coalesce()
    return A.to_sparse_csr()


def _prolong_add(bk, base, x, idx, alpha):
    """The fused prolongation of the aggregation V-cycle; in a ``--tree``
    of an earlier round, which has none, the gather, product and sum that
    its V-cycle ran."""
    if hasattr(bk, "banded_prolong_add"):
        return bk.banded_prolong_add(base, x, idx, alpha)
    return base + alpha * bk.banded_gather(x, idx)[:, 0]


def phase_banded_kernels(results):
    """The three banded kernels against their plain versions on the card,
    then their times at the Delaunay main path's shape."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk

    before = dict(bk.LAUNCHES)
    dev = "cuda"
    # (M, n_src, K): square maps, the K = 1 prolongation map, restriction
    # member lists (rectangular, wide), a polygonal-mesh K = 9 map.
    maps = [(5000, 5000, 1), (5000, 5000, 3), (4096, 4096, 9),
            (5000, 700, 1), (700, 5000, 17), (131, 131, 11)]
    err_g = err_d = err_s = 0.0
    n_cases = 0
    for mi, (M, n_src, K) in enumerate(maps):
        idx = _band_map(M, n_src, K, mi, dev, spread=min(640, n_src))
        for C in (None, 2, 6, 3):   # 3 takes the kernel's run-time width
            x = _rand((n_src,) if C is None else (n_src, C), 10 + mi, dev)
            err_g = max(err_g, _maxerr([bk.banded_gather(x, idx)],
                                       [bk.banded_gather_ref(x, idx)]))
            n_cases += 1
        # C = 1 through a view of the map that starts one index in (not
        # 16-byte aligned: one index per thread instead of four).
        flat = torch.cat([idx.reshape(-1)[:1], idx.reshape(-1)])
        view = flat[1:].view(M, K)
        x = _rand((n_src,), 10 + mi, dev)
        err_g = max(err_g, _maxerr([bk.banded_gather(x, view)],
                                   [bk.banded_gather_ref(x, view)]))
        n_cases += 1
        if K == 1:
            base = _rand((M,), 15 + mi, dev)
            x = _rand((n_src,), 16 + mi, dev)
            for alpha in (1.0, 1.5):
                err_g = max(err_g, _maxerr(
                    [_prolong_add(bk, base, x, idx, alpha)],
                    [base + alpha * x[idx[:, 0].long()]]))
                n_cases += 1
        for n_x, n_off, prods in (*DOT_FORMS.values(), DOT_OTHER):
            xs = [_rand((n_src,), 20 + c, dev) for c in range(n_x)]
            offs = [_rand((M, K), 30 + p, dev, 0.3) for p in range(n_off)]
            err_d = max(err_d, _maxerr(bk.banded_dot(xs, offs, idx, prods),
                                       bk.banded_dot_ref(xs, offs, idx,
                                                         prods)))
            n_cases += 1
        if M == n_src:
            rs = [_rand((M,), 40 + c, dev) for c in range(2)]
            dinv = 1.0 / (1.0 + _rand((M,), 50, dev).abs())
            off = _rand((M, K), 51, dev, 0.5 / K)
            for sweeps in (1, 3, 8):
                for cap in ((None, 8) if K > 8 else (None,)):
                    got = bk.banded_jacobi_sweeps(rs, dinv, off, idx, sweeps,
                                                  k_cap=cap)
                    ref = bk.banded_jacobi_sweeps_ref(rs, dinv, off, idx,
                                                      sweeps, k_cap=cap)
                    err_s = max(err_s, _maxerr(got, ref))
                    n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: banded kernels, {n_cases} cases on {len(maps)} maps; "
        f"max-abs error gather {err_g:.3e}, dot {err_d:.3e}, sweeps "
        f"{err_s:.3e} (tolerance {TOL:g})")
    _check_banded_errs(err_g, err_d, err_s)

    # Times at the Delaunay main path's shape: N_dev = 403,584, K = 3.
    n = M = ((DELAUNAY_CELLS + 127) // 128) * 128
    K = 3
    idx = _band_map(M, n, K, 7, dev)
    idx_long = idx.long()
    B = 4
    # gather, C = 6: the packed (u, p, d_p, grad_p) gather of prepare.
    x6 = _rand((n, 6), 60, dev)
    err_g = max(err_g, _maxerr([bk.banded_gather(x6, idx)],
                               [bk.banded_gather_ref(x6, idx)]))
    g_ms, g_read = both_flushes_ms(lambda: bk.banded_gather(x6, idx), 50)
    g_plain = cuda_time_ms(lambda: bk.banded_gather_ref(x6, idx))
    g_lib = cuda_time_ms(lambda: x6[idx_long])
    g_bound, g_by = bound_ms(B * (M * K + M * K * 6 + n * 6), 0)
    # The gather at the shapes the path launches (under both flushes):
    # C = 6 and C = 1 at the mesh's map, and the fused prolongation of the
    # first two coarse levels through a K = 1 map of aggregates.
    gather_rows = []
    for C in (6, 1):
        x = x6 if C == 6 else _rand((n,), 62, dev)
        ms, ms_read = both_flushes_ms(lambda: bk.banded_gather(x, idx))
        bnd, _ = bound_ms(B * (M * K + M * K * C + n * C), 0)
        gather_rows.append(f"gather {M}x{K} C={C} {ms:.4f} / {ms_read:.4f}"
                           f" / {bnd:.4f}")
    for mf, nc in ((M, DELAUNAY_LEVELS[0]),
                   (DELAUNAY_LEVELS[0], DELAUNAY_LEVELS[1])):
        agg = _band_map(mf, nc, 1, 63, dev, spread=4)
        base, xc = _rand((mf,), 64, dev), _rand((nc,), 65, dev)
        err_g = max(err_g, _maxerr(
            [_prolong_add(bk, base, xc, agg, 1.0)],
            [base + xc[agg[:, 0].long()]]))
        ms, ms_read = both_flushes_ms(
            lambda: _prolong_add(bk, base, xc, agg, 1.0))
        eager, _ = both_flushes_ms(
            lambda: base + 1.0 * bk.banded_gather(xc, agg)[:, 0])
        bnd, _ = bound_ms(B * (3 * mf + nc), 2 * mf)
        gather_rows.append(
            f"prolongation {mf}<-{nc} {ms:.4f} / {ms_read:.4f} / {bnd:.4f} "
            f"(gather, product and sum as three launches {eager:.4f})")
    # dot, the coupled matvec: 6 planes, 3 operands, 3 outputs.
    n_x, n_off, prods = DOT_FORMS["spmv"]
    xs = [_rand((n,), 61 + c, dev) for c in range(n_x)]
    offs = [_rand((M, K), 64 + p, dev, 0.3) for p in range(n_off)]
    d_ref = bk.banded_dot_ref(xs, offs, idx, prods)
    err_d = max(err_d, _maxerr(bk.banded_dot(xs, offs, idx, prods), d_ref))
    d_ms, d_read = both_flushes_ms(
        lambda: bk.banded_dot(xs, offs, idx, prods), 50)
    d_plain = cuda_time_ms(lambda: bk.banded_dot_ref(xs, offs, idx, prods))
    # The library's call for the same function: the products as one sparse
    # CSR matrix (3M x 3n for the matvec, M x n for the scalar form) applied
    # to the stacked operands.  Built once, outside the timed call; used
    # nowhere in the solver.
    A3, A1 = _dot_csr(offs, idx, prods, n_x, n), \
        _dot_csr(offs[:1], idx, DOT_FORMS["scalar"][2], 1, n)
    x3 = torch.cat(xs)
    err_lib = _maxerr([torch.mv(A3, x3)], [torch.cat(d_ref)])
    check(err_lib <= TOL, f"the sparse-matrix product disagrees with "
          f"banded_dot's plain version: {err_lib:.3e}")
    d_lib = cuda_time_ms(lambda: torch.mv(A3, x3))
    d1_lib = cuda_time_ms(lambda: torch.mv(A1, xs[0]))
    n_mul = sum(len(p) for p in prods)
    d_bound, d_by = bound_ms(
        B * (M * K + n_off * M * K + n_x * n + len(prods) * M),
        2 * n_mul * M * K)
    # Every form at this shape, then the scalar form (every AMG level's
    # operator and restriction) at the first coarse level's shapes, whose
    # rows reach a few dozen cells either way.
    form_rows = []

    def time_form(label, n_x, n_off, prods, xs, offs, idx):
        M, K = idx.shape
        got = bk.banded_dot(xs[:n_x], offs[:n_off], idx, prods)
        err = _maxerr(got, bk.banded_dot_ref(xs[:n_x], offs[:n_off], idx,
                                             prods))
        ms, ms_read = both_flushes_ms(
            lambda: bk.banded_dot(xs[:n_x], offs[:n_off], idx, prods))
        bnd, _ = bound_ms(
            B * (M * K + n_off * M * K + n_x * xs[0].shape[0]
                 + len(prods) * M),
            2 * sum(len(p) for p in prods) * M * K)
        form_rows.append((label, ms, ms_read, bnd))
        return err

    named = hasattr(bk, "dot_form")   # not in a --tree of an earlier round
    for name, (f_x, f_off, f_prods) in DOT_FORMS.items():
        check(not named or bk.dot_form(f_prods, f_x, f_off) == name,
              f"banded_dot does not pick the {name} instantiation")
        err_d = max(err_d, time_form(f"{name} {M}x{K}", f_x, f_off, f_prods,
                                     xs, offs, idx))
    check(not named or bk.dot_form(DOT_OTHER[2], *DOT_OTHER[:2]) == "generic",
          "an unknown product list must take the generic instantiation")
    one = DOT_FORMS["scalar"][2]
    n1, k1, kr = DELAUNAY_LEVELS[0], 9, 16
    for label, mc, nc, kc in ((f"scalar {n1}x{k1}", n1, n1, k1),
                              (f"restriction {n1}x{kr}<-{n}", n1, n, kr)):
        err_d = max(err_d, time_form(
            label, 1, 1, one, [_rand((nc,), 90, dev)],
            [_rand((mc, kc), 91, dev, 0.3)],
            _band_map(mc, nc, kc, 9, dev, spread=48)))
    d1_ms = dict((r[0], r[1]) for r in form_rows)[f"scalar {M}x{K}"]
    d1_bound, _ = bound_ms(B * (M * K + M * K + n + M), 2 * M * K)
    # sweeps: C = 2, 8 sweeps (the momentum predict), at the Delaunay
    # path's shape, at the multilevel path's beside the per-sweep chain it
    # replaces there, and at one that takes the streamed form.
    s_rows, err_big, s_main = _time_sweeps(bk, idx)
    err_s = max(err_s, err_big)
    # Host cost of one wrapper call (checks, output allocation, ctypes) at
    # a size where the kernels take a few microseconds.
    sm = _band_map(4096, 4096, K, 8, dev)
    sx = [_rand((4096,), 80 + c, dev) for c in range(3)]
    so = [_rand((4096, K), 83 + p, dev) for p in range(6)]
    h_g = host_us(lambda: bk.banded_gather(sx[0], sm))
    h_d1 = host_us(lambda: bk.banded_dot(sx[:1], so[:1], sm,
                                         DOT_FORMS["scalar"][2]))
    h_d = host_us(lambda: bk.banded_dot(sx, so, sm, prods))
    h_s = host_us(lambda: bk.banded_jacobi_sweeps(sx[:2], sx[2], so[0], sm,
                                                  8))
    h_add = host_us(lambda: sx[0] + sx[1])
    log(f"phase 2: host time per call: banded_gather {h_g:.1f} us, "
        f"banded_dot scalar {h_d1:.1f} us / matvec {h_d:.1f} us, "
        f"banded_jacobi_sweeps {h_s:.1f} us; one eager torch add "
        f"{h_add:.1f} us (ratios {h_g / h_add:.2f}, {h_d1 / h_add:.2f}, "
        f"{h_d / h_add:.2f}, {h_s / h_add:.2f})")
    bk.LAUNCHES.update(before)
    log(f"phase 2: at M={M}, K={K}: max-abs error gather {err_g:.3e}, dot "
        f"{err_d:.3e}, sweeps {err_s:.3e}; sparse-matrix product against "
        f"the plain dot {err_lib:.3e}")
    _check_banded_errs(err_g, err_d, err_s)
    rows = (("banded_gather", f"{BANDED_PALLAS}:378", err_g, g_ms, g_plain,
             g_bound, g_by, g_lib, g_read),
            ("banded_dot", f"{BANDED_PALLAS}:378", err_d, d_ms, d_plain,
             d_bound, d_by, d_lib, d_read),
            ("banded_jacobi_sweeps", f"{BANDED_PALLAS}:534", err_s,
             *s_main[:4], None, s_main[4]))
    for name, rep, err, ms, plain, bnd, by, lib, ms_read in rows:
        results[name] = dict(
            name=name, route="cuda", source=BANDED_SRC, replaces=rep,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bnd, bound_by=by, library_ms=lib,
            ms_read_flush=ms_read)
    log(f"phase 2: banded_gather at M={M}, K={K}, C=6: {g_ms:.4f} ms, bound "
        f"{g_bound:.4f} ms ({g_by}), plain {g_plain:.4f} ms, indexing call "
        f"{g_lib:.4f} ms")
    log("phase 2: banded_gather by shape, ms / ms under the read flush / "
        "bound ms: " + "; ".join(gather_rows))
    log(f"phase 2: banded_dot (matvec: 6 planes, 3 operands, 3 outputs): "
        f"{d_ms:.4f} ms, bound {d_bound:.4f} ms ({d_by}), plain "
        f"{d_plain:.4f} ms, sparse CSR product {d_lib:.4f} ms; scalar form "
        f"{d1_ms:.4f} ms, bound {d1_bound:.4f} ms, sparse CSR product "
        f"{d1_lib:.4f} ms")
    log("phase 2: banded_dot by form, ms / ms under the read flush / bound "
        "ms: " + "; ".join(f"{label} {ms:.4f} / {rd:.4f} / {bnd:.4f}"
                           for label, ms, rd, bnd in form_rows))
    for row in s_rows:
        log("phase 2: banded_jacobi_sweeps (C=2, 8 sweeps) " + row)


# The sweeps kernel's shapes in phase 2: (n, K) of the Delaunay path, the
# multilevel path, and the next multilevel size, whose rows do not fit on
# chip (the streamed form).
SWEEPS_SHAPES = ((None, 3), (600_000, 6), (2_400_000, 6))


def _sweeps_chain(bk, rs, dinv, off, idx, sweeps):
    """The per-sweep loop of ellsys._momentum_solve for C = 2: a mom2 dot
    and the eager updates per sweep."""
    z = [dinv * r for r in rs]
    for _ in range(sweeps - 1):
        su, sv = bk.banded_dot(z, (off,), idx, (((0, 0),), ((0, 1),)))
        z = [dinv * (rs[0] - su), dinv * (rs[1] - sv)]
    return z


def _time_sweeps(bk, main_idx):
    """banded_jacobi_sweeps against its plain version and timed at
    SWEEPS_SHAPES (the first at ``main_idx``'s), with its read-once bound,
    its launch plan, the timer's floor and the cost of its grid barrier.
    Returns the lines to log, the largest error, and (ms, plain ms, bound
    ms, bound_by) at the first shape."""
    import torch
    dev = main_idx.device
    C, sweeps, B = 2, 8, 4
    planned = hasattr(bk, "device_sweeps_plan")   # not in an earlier --tree
    rows, err_s, main = [], 0.0, None
    for n, K in SWEEPS_SHAPES:
        idx = main_idx if n is None else _band_map(n, n, K, 74, dev)
        n = idx.shape[0]
        rs = [_rand((n,), 70 + c, dev) for c in range(C)]
        dinv = 1.0 / (1.0 + _rand((n,), 72, dev).abs())
        off = _rand((n, K), 73, dev, 0.1)
        call = lambda: bk.banded_jacobi_sweeps(rs, dinv, off, idx, sweeps)
        got = call()
        err = _maxerr(got, bk.banded_jacobi_sweeps_ref(rs, dinv, off, idx,
                                                       sweeps))
        err_s = max(err_s, err)
        ms, ms_read = both_flushes_ms(call)
        plain = cuda_time_ms(lambda: bk.banded_jacobi_sweeps_ref(
            rs, dinv, off, idx, sweeps))
        # Read once: idx and off (n*K each), dinv, the C right-hand sides;
        # written once: the C results.
        bnd, by = bound_ms(B * (2 * n * K + n + 2 * C * n),
                           (sweeps - 1) * (2 * C * n * K + 2 * C * n) + C * n)
        line = (f"at {n}x{K}: {ms:.4f} ms, {ms_read:.4f} ms under the read "
                f"flush, read-once bound {bnd:.4f} ms ({by}), plain "
                f"{plain:.4f} ms, max-abs error {err:.3e}")
        if planned:
            plan = bk.device_sweeps_plan(dev, n, K, C, K)
            line += (f"; {plan.form} form, {plan.blocks} blocks of "
                     f"{plan.rows_per_block} rows, {plan.smem_bytes} bytes "
                     f"of shared memory per block, {plan.rows_per_thread} "
                     "rows per thread in registers")
        if K == 6 and n == 600_000:
            chain = _sweeps_chain(bk, rs, dinv, off, idx, sweeps)
            same = all(torch.equal(g, w) for g, w in zip(got, chain))
            c_ms, c_read = both_flushes_ms(
                lambda: _sweeps_chain(bk, rs, dinv, off, idx, sweeps))
            line += (f"; the per-sweep chain it replaces on the multilevel "
                     f"path (7 mom2 dots and their eager updates) {c_ms:.4f} "
                     f"ms, {c_read:.4f} ms under the read flush, results "
                     f"bit-equal {same}")
            if planned:
                check(same, "the one-call sweeps differ from the per-sweep "
                      "chain's bits")
        rows.append(line)
        if main is None:
            main = (ms, plain, bnd, by, ms_read)
    # The grid barrier: the same launch over one row per thread of the
    # largest resident grid with no slots (k_cap = 0: z = dinv*r each
    # sweep), 8 sweeps against 1; and the timer's floor, one row.
    n = torch.cuda.get_device_properties(dev).multi_processor_count * 1024
    idx = _band_map(n, n, 3, 75, dev)
    rs = [_rand((n,), 76 + c, dev) for c in range(C)]
    dinv, off = _rand((n,), 78, dev), _rand((n, 3), 79, dev)
    t = {sw: cuda_time_ms(lambda: bk.banded_jacobi_sweeps(
             rs, dinv, off, idx, sw, k_cap=0), flush="read")
         for sw in (1, 8)}
    one = [rs[0][:1], rs[1][:1]]
    floor = cuda_time_ms(lambda: bk.banded_jacobi_sweeps(
        one, dinv[:1], off[:1], idx[:1], 1, k_cap=0), flush="read")
    rows.append(f"barrier: {n} rows, no slots, read flush: 1 sweep "
                f"{t[1]:.4f} ms, 8 sweeps {t[8]:.4f} ms: "
                f"{(t[8] - t[1]) / 7 * 1e3:.2f} us per sweep of barrier and "
                f"{n * C * 8 / 1e6:.1f} MB of z; timer floor (one row, one "
                f"sweep) {floor:.4f} ms")
    return rows, err_s, main


# The forms of rbgs_leg: name -> planes moved per fine cell (x, diag, 4 off
# and b read; x written; then r written, or a quarter plane of coarse
# right-hand side written, or a quarter plane of coarse x read).
LEG_FORMS = {"smooth": 8.0, "residual": 9.0, "restrict": 8.25,
             "prolong": 8.25}


def _leg(sk, form, x, diag2, off2, b, xc, plain=False):
    """One leg in ``form`` through the kernel, or (``plain``) through
    rbgs_leg_ref composed with the plain restrict2 / prolong2."""
    coarse = coarse_of(x.shape)
    if plain:
        xin = x + sk.prolong2(xc, x.shape) if form == "prolong" else x
        out = sk.rbgs_leg_ref(xin, diag2, off2, b, 1,
                              form in ("residual", "restrict"))
        if form == "restrict":
            out = (out[0], sk.restrict2(out[1], coarse))
    else:
        kw = {"smooth": {}, "residual": {"residual": True},
              "restrict": {"restrict_to": coarse},
              "prolong": {"add_prolong": xc}}[form]
        out = sk.rbgs_leg(x, diag2, off2, b, **kw)
    return out if isinstance(out, tuple) else (out,)


def _half_sweep_call(sk, x, diag2, off2, b, parity):
    """A no-argument call of the tree's half-sweep on (ny, nx) planes, and
    of its plain version.  Earlier rounds' wrappers (``--tree``) take the
    flat layout with ``off`` (n, 4): the planes are moved there outside the
    timed call."""
    if "grid_shape" not in inspect.signature(sk.rbgs_half_sweep).parameters:
        args = (x, diag2, off2, b, parity)
        return (lambda: sk.rbgs_half_sweep(*args),
                lambda: sk.rbgs_half_sweep_ref(*args))
    ny, nx = x.shape
    args = (x.reshape(-1), diag2.reshape(-1),
            off2.reshape(4, -1).T.contiguous(), b.reshape(-1), parity,
            (ny, nx))
    return (lambda: sk.rbgs_half_sweep(*args).reshape(ny, nx),
            lambda: sk.rbgs_half_sweep_ref(*args).reshape(ny, nx))


def _leg_forms(sk):
    """(fused, planar, forms) of the tree's wrappers: the fused forms are
    not in a --tree of an earlier round, nor is the planar half-sweep."""
    fused = "restrict_to" in inspect.signature(sk.rbgs_leg).parameters
    planar = "grid_shape" not in inspect.signature(
        sk.rbgs_half_sweep).parameters
    forms = [f for f in LEG_FORMS if fused or f in ("smooth", "residual")]
    return fused, planar, forms


def _leg_tol(sk):
    """The RB-GS kernels' bound against their plain versions.  Both share
    one arithmetic (nvcc's and XLA's contracted multiply-adds, restrict2's
    order of the block sums): max-abs 0.  A --tree of an earlier round,
    whose plain versions rounded every product apart, keeps TOL."""
    return 0.0 if hasattr(sk, "smoother_sigma") else TOL


def _hold_legs(phase, sk, cases):
    """rbgs_leg (sweeps 1 and 2, with and without residual), its fused
    forms and rbgs_half_sweep against their plain versions on random
    systems at each (ny, nx) of ``cases``; logs and checks the max-abs
    errors and returns them (leg, fused, half-sweep).  The caller takes
    the launches made here off the counts."""
    import torch
    _, planar, forms = _leg_forms(sk)
    tol = _leg_tol(sk)
    err_leg = err_fused = err_half = 0.0
    for ci, (ny, nx) in enumerate(cases):
        diag2, off2, x, b = _grid_system(ny, nx, ci, "cuda")
        xc = _rand(coarse_of((ny, nx)), 200 + ci, "cuda")
        for sweeps in (1, 2):
            for residual in (True, False):
                got = sk.rbgs_leg(x, diag2, off2, b, sweeps, residual)
                ref = sk.rbgs_leg_ref(x, diag2, off2, b, sweeps, residual)
                got = got if residual else (got,)
                ref = ref if residual else (ref,)
                err_leg = max(err_leg, _maxerr(got, ref))
        for form in forms[2:]:
            err_fused = max(err_fused, _maxerr(
                _leg(sk, form, x, diag2, off2, b, xc),
                _leg(sk, form, x, diag2, off2, b, xc, plain=True)))
        if hasattr(sk, "rbgs_residual"):   # not in a --tree before it
            for coarse in (coarse_of((ny, nx)), (ny // 2, (nx + 1) // 2)):
                err_half = max(err_half, _maxerr(
                    (sk.rbgs_residual(x, diag2, off2, b, coarse),),
                    (sk.rbgs_residual_ref(x, diag2, off2, b, coarse),)))
        for parity in (0, 1):
            call, plain = _half_sweep_call(sk, x, diag2, off2, b, parity)
            ref = plain()
            err_half = max(err_half, float((call() - ref).abs().max()))
            if planar:   # in place: the second half-sweep of a pair
                xi = x.clone()
                sk.rbgs_half_sweep(xi, diag2, off2, b, parity, in_place=True)
                err_half = max(err_half, float((xi - ref).abs().max()))
    torch.cuda.synchronize()
    log(f"phase {phase}: {len(cases)} grids "
        + ", ".join(f"{ny}x{nx}" for ny, nx in cases)
        + f"; max-abs error leg {err_leg:.3e} (sweeps 1 and 2, with and "
        f"without residual), fused legs {err_fused:.3e} (restricted "
        f"residual, prolongation added), half-sweep and its restricted "
        f"residual {err_half:.3e} (tolerance {tol:g})")
    check(err_leg <= tol, f"rbgs_leg disagrees with its plain version: "
          f"{err_leg:.3e}")
    check(err_fused <= tol, f"a fused form of rbgs_leg disagrees with the "
          f"plain leg and grid transfer: {err_fused:.3e}")
    check(err_half <= tol, f"rbgs_half_sweep or rbgs_residual disagrees "
          f"with its plain version: {err_half:.3e}")
    return err_leg, err_fused, err_half


def phase_kernels(results):
    """Each kernel against its plain version on the card; times at the
    main paths' shapes."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk

    fused, planar, forms = _leg_forms(sk)
    grids, _ = level_grids(*MAIN_GRID)
    cases = [(37, 53), (16, 24), (300, 128)] + grids
    before = dict(sk.LAUNCHES)
    err_leg, err_fused, err_half = _hold_legs(2, sk, cases)

    # The leg on every level grid of the main path, in every form, beside
    # the form's byte bound.  Flops per cell: 2 half-sweeps x 9 on half the
    # cells + 1 reciprocal + 10 for the residual.  Then the half-sweep on
    # the same grids: 7 planes read, x written; half the cells do 10 flops.
    per_cycle = half_cycle = 0.0
    half_rows = []
    for ny, nx in grids:
        diag2, off2, x, b = _grid_system(ny, nx, 99, "cuda")
        xc = _rand(coarse_of((ny, nx)), 98, "cuda")
        cells = []
        for form in forms:
            ms, ms_read = both_flushes_ms(
                lambda: _leg(sk, form, x, diag2, off2, b, xc))
            bnd, _ = bound_ms(LEG_FORMS[form] * 4 * ny * nx, 20 * ny * nx)
            cells.append(f"{form} {ms:.4f} / {ms_read:.4f} / {bnd:.4f}")
            if form in forms[-2:]:
                per_cycle += ms
        log(f"phase 2: rbgs_leg at {ny}x{nx}, ms / ms under the read flush "
            "/ bound ms: " + "; ".join(cells))
        call, _ = _half_sweep_call(sk, x, diag2, off2, b, 0)
        ms, ms_read = both_flushes_ms(call)
        bnd, _ = bound_ms(8 * 4 * ny * nx, 5 * ny * nx)
        row = f"{ny}x{nx} {ms:.4f} / {ms_read:.4f}"
        if planar:   # the second half-sweep of a pair, in place
            xi = x.clone()
            ip, ip_read = both_flushes_ms(lambda: sk.rbgs_half_sweep(
                xi, diag2, off2, b, 1, in_place=True))
            row += f" (in place {ip:.4f} / {ip_read:.4f})"
            ms = (ms + ip) / 2
        half_rows.append(f"{row} / {bnd:.4f}")
        half_cycle += 4 * ms
    log("phase 2: rbgs_half_sweep, ms / ms under the read flush / bound ms: "
        + "; ".join(half_rows) + f"; over one V-cycle (2 into a new tensor "
        f"and 2 in place per level) {half_cycle:.4f} ms")
    tiny = _grid_system(2, 2, 95, "cuda")
    floor = cuda_time_ms(lambda: sk.rbgs_leg(tiny[2], tiny[0], tiny[1],
                                             tiny[3]), reps=30)
    log(f"phase 2: rbgs_leg over one V-cycle ({forms[-2]} and {forms[-1]} "
        f"leg on each of {len(grids)} levels): {per_cycle:.4f} ms; the timer's "
        f"floor (one launch on a 2x2 grid between the events): "
        f"{floor:.4f} ms")

    ny, nx = MAIN_GRID
    n = ny * nx
    diag2, off2, x, b = _grid_system(ny, nx, 99, "cuda")
    xc = _rand(coarse_of((ny, nx)), 98, "cuda")
    # The main path's down leg at its finest grid: the fused form.
    down = "restrict" if fused else "residual"
    leg_ms, leg_read = both_flushes_ms(
        lambda: _leg(sk, down, x, diag2, off2, b, xc), 50)
    leg_plain = cuda_time_ms(
        lambda: _leg(sk, down, x, diag2, off2, b, xc, plain=True))
    leg_bound, leg_by = bound_ms(LEG_FORMS[down] * 4 * n, 20 * n)
    res_ms = cuda_time_ms(lambda: sk.rbgs_leg(x, diag2, off2, b, 1, True))
    res_bound, _ = bound_ms(LEG_FORMS["residual"] * 4 * n, 20 * n)
    half_call, half_ref = _half_sweep_call(sk, x, diag2, off2, b, 0)
    half_ms, half_read = both_flushes_ms(half_call, 50)
    half_plain = cuda_time_ms(half_ref)
    # The timing inputs themselves, held as _hold_legs holds its grids.
    err_main = _maxerr(_leg(sk, down, x, diag2, off2, b, xc),
                       _leg(sk, down, x, diag2, off2, b, xc, plain=True))
    err_half_main = float((half_call() - half_ref()).abs().max())
    torch.cuda.synchronize()
    log(f"phase 2: on the {ny}x{nx} timing inputs max-abs error {down} leg "
        f"{err_main:.3e}, half-sweep {err_half_main:.3e} (tolerance "
        f"{_leg_tol(sk):g})")
    check(err_main <= _leg_tol(sk) and err_half_main <= _leg_tol(sk),
          f"on the timing inputs rbgs_leg errs {err_main:.3e} and "
          f"rbgs_half_sweep {err_half_main:.3e}")
    err_leg, err_half = max(err_leg, err_main), max(err_half, err_half_main)
    # Reads x, diag, off (4 planes), b; writes x.  Half the cells do 10
    # flops.
    half_bound, half_by = bound_ms(8 * 4 * n, 5 * n)
    if hasattr(sk, "rbgs_residual"):
        _time_residual(results, sk, x, diag2, off2, b)
    # Host cost of one wrapper call at a size where the kernels take a few
    # microseconds.
    sd, so, sx, sb = _grid_system(37, 111, 97, "cuda")
    sc = _rand(coarse_of((37, 111)), 96, "cuda")
    h_leg = {form: host_us(lambda: _leg(sk, form, sx, sd, so, sb, sc))
             for form in forms}
    h_half = host_us(_half_sweep_call(sk, sx, sd, so, sb, 0)[0])
    h_add = host_us(lambda: sx + sb)
    log("phase 2: host time per call: rbgs_leg "
        + ", ".join(f"{form} {us:.1f} us" for form, us in h_leg.items())
        + f"; rbgs_half_sweep {h_half:.1f} us; one eager torch add "
        f"{h_add:.1f} us (ratios "
        + ", ".join(f"{us / h_add:.2f}" for us in h_leg.values())
        + f"; {h_half / h_add:.2f})")
    # Launches made for these comparisons are not the main path's.
    sk.LAUNCHES.update(before)
    results["rbgs_leg"] = dict(
        name="rbgs_leg", route="cuda", source="cfd2_tpu_torch/csrc/rbgs.cu",
        replaces="cfd2_tpu/ops/pallas_stencil.py:264", launches=0,
        max_abs_err=max(err_leg, err_fused), ms=leg_ms, plain_ms=leg_plain,
        bound_ms=leg_bound, bound_by=leg_by, library_ms=None,
        ms_read_flush=leg_read)
    results["rbgs_half_sweep"] = dict(
        name="rbgs_half_sweep", route="cuda",
        source="cfd2_tpu_torch/csrc/rbgs.cu",
        replaces="cfd2_tpu/ops/pallas_stencil.py:97", launches=0,
        max_abs_err=err_half, ms=half_ms, plain_ms=half_plain,
        bound_ms=half_bound, bound_by=half_by, library_ms=None,
        ms_read_flush=half_read)
    log(f"phase 2: rbgs_leg at {ny}x{nx}, down leg (sweeps=1, form "
        f"{down}): {leg_ms:.4f} ms, bound {leg_bound:.4f} ms ({leg_by}), "
        f"plain version {leg_plain:.4f} ms; unfused with residual "
        f"{res_ms:.4f} ms, bound {res_bound:.4f} ms")
    log(f"phase 2: rbgs_half_sweep at {ny}x{nx}: {half_ms:.4f} ms, bound "
        f"{half_bound:.4f} ms ({half_by}), plain {half_plain:.4f} ms")
    if hasattr(sk, "coupled_spmv"):    # not in a --tree before the stencils
        phase_stencil_kernels(results)
    phase_banded_kernels(results)


def _time_residual(results, sk, x, diag2, off2, b):
    """rbgs_residual at the main path's finest grid: max-abs against its
    plain version on the timing inputs, its time under both flushes beside
    its byte bound (x, diag, 4 off and b read, a quarter plane written;
    per cell 10 flops of residual and 3/4 of an add) and the plain
    version's time.  The launches made here are taken off by the caller."""
    import torch
    ny, nx = x.shape
    n = ny * nx
    coarse = coarse_of((ny, nx))
    call = lambda: sk.rbgs_residual(x, diag2, off2, b, coarse)
    plain = lambda: sk.rbgs_residual_ref(x, diag2, off2, b, coarse)
    err = _maxerr((call(),), (plain(),))
    torch.cuda.synchronize()
    check(err <= _leg_tol(sk), f"rbgs_residual on the timing inputs errs "
          f"{err:.3e}")
    ms, ms_read = both_flushes_ms(call, 50)
    plain_ms = cuda_time_ms(plain)
    bnd, by = bound_ms((7 + 0.25) * 4 * n, 10.75 * n)
    results["rbgs_residual"] = dict(
        name="rbgs_residual", route="cuda",
        source="cfd2_tpu_torch/csrc/rbgs.cu",
        replaces="none: the residual and restriction around "
        "cfd2_tpu/ops/pallas_stencil.py:97 (XLA's in the JAX package)",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
        bound_by=by, library_ms=None, ms_read_flush=ms_read)
    log(f"phase 2: rbgs_residual at {ny}x{nx} -> {coarse}: max-abs "
        f"{err:.3e}; {ms:.4f} ms / {ms_read:.4f} ms under the read flush, "
        f"bound {bnd:.4f} ms ({by}, {bnd / ms:.1%} of it), plain "
        f"{plain_ms:.4f} ms")


# The stencil kernels of csrc/stencil.cu: name -> the function the JAX
# package leaves to XLA (file:line).
STENCIL_SRC = "cfd2_tpu_torch/csrc/stencil.cu"
STENCIL_REPLACES = {
    "coupled_spmv": "cfd2_tpu/ops/stencil_system.py:196",
    "momentum_jacobi": "cfd2_tpu/ops/stencil_system.py:213",
    "schur_rhs": "cfd2_tpu/ops/stencil_system.py:337",
    "pressure_gradient": "cfd2_tpu/ops/stencil_system.py:345",
}
STENCIL_GRIDS = ((7, 19), (37, 53), (300, 128), MAIN_GRID)
# Phase 3's timed steps' FGMRES iterations on an H100 since the RB-GS
# kernels round as XLA rounds the JAX package's smoother (contracted
# multiply-adds, restrict2's order of the block sums).  Before, in every
# recorded run, with the stencils as eager PyTorch or as their bit-equal
# kernels: 90, 57, 28.
TIMED_LIN = (90, 58, 23)


def _tests_module(name):
    """A helper module of tests/ that imports no JAX (torch, numpy and the
    port at most), shared with the CPU tests."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    return importlib.import_module(name)


def _stencil_cases():
    """tests/torch_spatial_ranks.py, which makes the seeded random stencil
    systems and the four wrappers' calls that tests/test_torch_cuda.py
    holds too."""
    return _tests_module("torch_spatial_ranks")


def _hold_stencils(phase, sk, cases):
    """The four stencil kernels against their plain versions, bit for bit:
    ``cases`` is a list of (label, planes, sweeps); each with and without
    halo rows (made up of the block's own rows, so that they differ from
    the clamp).  Returns {kernel: max-abs error}; the caller takes the
    launches made here off the counts."""
    import torch
    cc = _stencil_cases()
    errs = {name: 0.0 for name in STENCIL_REPLACES}
    unequal = []
    for label, p, sweeps in cases:
        for halo in (None, cc.made_up_halo):
            got = cc.stencil_calls(p, halo, sweeps)
            ref = cc.stencil_calls(p, halo, sweeps, plain=True)
            for key in got:
                a, b = got[key](), ref[key]()
                name = key.split()[0]
                errs[name] = max(errs[name], float((a - b).abs().max()))
                if not torch.equal(a, b):
                    unequal.append(f"{label} {key} halo={halo is not None}")
    torch.cuda.synchronize()
    log(f"phase {phase}: stencil kernels against their plain versions on "
        + ", ".join(label for label, _, _ in cases) + " (with and without "
        "halo rows): max-abs error "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; bit-equal: " + ("all" if not unequal else
                             f"NOT {unequal[:6]}"))
    check(not unequal, f"stencil kernels differ from their plain versions "
          f"(tolerance: bit-equal): {unequal[:6]}")
    return errs


# Blocks of the coupled operator, (output plane, input plane, diagonal,
# off-diagonal block): all of A = [[A_uu, G_u], [A_vv, G_v], [D_u, D_v,
# A_pp]] (coupled_spmv), G (pressure_gradient: the (u, v) rows' p column)
# and D (schur_rhs: the p row's (u, v) columns), each in its own numbering.
CSR_BLOCKS = {
    "coupled_spmv": ((3, 3), ((0, 0, "diag_u2", "off_mom"),
                              (0, 2, "diag_up2", "off_up"),
                              (1, 1, "diag_u2", "off_mom"),
                              (1, 2, "diag_vp2", "off_vp"),
                              (2, 0, "diag_pu2", "off_pu"),
                              (2, 1, "diag_pv2", "off_pv"),
                              (2, 2, "diag_pp2", "off_pp"))),
    "pressure_gradient": ((2, 1), ((0, 0, "diag_up2", "off_up"),
                                   (1, 0, "diag_vp2", "off_vp"))),
    "schur_rhs": ((1, 2), ((0, 0, "diag_pu2", "off_pu"),
                           (0, 1, "diag_pv2", "off_pv"))),
}


def _csr(p, name):
    """The blocks ``CSR_BLOCKS[name]`` of the coupled operator of planes
    ``p`` as one sparse CSR matrix of flattened planes, edge-clamped
    neighbours summed into their own column: the library call's operand
    (cuSPARSE through torch.mv / torch.addmv)."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    (n_out, n_in), blocks = CSR_BLOCKS[name]
    ny, nx = p["zp"].shape
    n = ny * nx
    idx = torch.arange(n, device="cuda").view(ny, nx)
    nbr = [t.reshape(-1) for t in sk.edge_shifts(idx)]
    own = idx.reshape(-1)
    rows, cols, vals = [], [], []
    for out_c, in_c, diag, off in blocks:
        for col, val in zip([own] + nbr, [p[diag]] + list(p[off])):
            rows.append(out_c * n + own)
            cols.append(in_c * n + col)
            vals.append(val.reshape(-1))
    a = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                             torch.cat(cols)]),
                                torch.cat(vals), (n_out * n, n_in * n))
    return a.coalesce().to_sparse_csr()


def _library_calls(p):
    """{kernel: one PyTorch call of the same function on planes ``p``}: the
    CSR products y = A x, G z_p and r_p - D z (torch.addmv, alpha -1)."""
    import torch
    ny, nx = p["zp"].shape
    a, g, d = (_csr(p, k) for k in ("coupled_spmv", "pressure_gradient",
                                    "schur_rhs"))
    x, zp, z = (p[k].reshape(-1) for k in ("x", "zp", "z"))
    rp = p["r"][2].reshape(-1)
    return {"coupled_spmv": lambda: torch.mv(a, x).view(3, ny, nx),
            "pressure_gradient": lambda: torch.mv(g, zp).view(2, ny, nx),
            "schur_rhs": lambda: torch.addmv(rp, d, z, alpha=-1).view(ny, nx)
            }, sum(m._nnz() for m in (a, g, d))


def _stencil_bounds(ny, nx, sweeps):
    """{kernel: (bytes, flops)}: each input read once and each output
    written once, in float32, and the operations these inputs need."""
    n = ny * nx
    return {"coupled_spmv": (36 * 4 * n, 67 * n),
            "momentum_jacobi": (9 * 4 * n, (2 + 18 * (sweeps - 1)) * n),
            "schur_rhs": (14 * 4 * n, 20 * n),
            "pressure_gradient": (13 * 4 * n, 18 * n)}


def _momentum_plan_note(sk, ny, nx, sweeps):
    """The streamed predict's plan on this card, where the wrapper has one
    (a ``--tree`` checkout may not)."""
    import torch
    if not hasattr(sk, "device_momentum_plan"):
        return "no plan (that checkout's temporal tiles)"
    plan = sk.device_momentum_plan(torch.device("cuda"), ny, nx, sweeps)
    return (f"{plan.bands} bands of {plan.band_cols} columns x "
            f"{plan.row_blocks} blocks of {plan.tile_rows} rows, "
            f"{plan.cells_per_output:.3f} cells updated per output cell")


def _momentum_2m(sk, cc):
    """The 2M developed case's predict (12 sweeps on 834x2500, one launch):
    bit-equal to its plain version, timed under both flushes beside its
    bound and the plain version.  Returns the keys it adds to the kernel's
    JSON entry."""
    import torch
    (ny, nx), sweeps = DEVELOPED_2M_GRID, 12
    p = cc.stencil_tensors((ny, nx), 29, "cuda")
    key = f"momentum_jacobi {sweeps}"
    call = cc.stencil_calls(p, sweeps=(sweeps,))[key]
    plain = cc.stencil_calls(p, sweeps=(sweeps,), plain=True)[key]
    got, ref = call(), plain()
    err = float((got - ref).abs().max())
    check(torch.equal(got, ref), f"momentum_jacobi at {ny}x{nx}, {sweeps} "
          f"sweeps, differs from its plain version: max-abs {err:.3e}")
    del got, ref
    ms, ms_read = both_flushes_ms(call)
    plain_ms = cuda_time_ms(plain, reps=10)
    bnd, by = bound_ms(*_stencil_bounds(ny, nx, sweeps)["momentum_jacobi"])
    log(f"phase 2: momentum_jacobi at {ny}x{nx}, {sweeps} sweeps "
        f"({_momentum_plan_note(sk, ny, nx, sweeps)}): bit-equal; "
        f"{ms:.4f} ms / {ms_read:.4f} ms under the read flush / bound "
        f"{bnd:.4f} ({by}, {bnd / ms:.1%} of it) / plain {plain_ms:.4f}")
    tag = f"{ny}x{nx}_{sweeps}"
    return {f"ms_{tag}": ms, f"ms_read_flush_{tag}": ms_read,
            f"bound_ms_{tag}": bnd, f"plain_ms_{tag}": plain_ms}


def phase_stencil_kernels(results):
    """Phase 2's part for csrc/stencil.cu: each kernel bit-equal to its
    plain version on small grids and at 589x1765 (sweeps 1-14, with and
    without halo rows), timed there under both flushes beside its bound,
    its plain version and the library's CSR product of the same function
    (none for the predict's sweeps)."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk

    cc = _stencil_cases()
    before = dict(sk.LAUNCHES)
    cases = [(f"{ny}x{nx}", cc.stencil_tensors((ny, nx), 7 + i, "cuda"),
              tuple(range(1, 15)) if ny * nx < 100_000 else (1, 2, 8, 12, 14))
             for i, (ny, nx) in enumerate(STENCIL_GRIDS)]
    errs = _hold_stencils(2, sk, cases)
    ny, nx = MAIN_GRID
    p = cases[-1][1]
    mom_2m = _momentum_2m(sk, cc)
    sweeps = 8
    calls = cc.stencil_calls(p, sweeps=(sweeps,))
    plain = cc.stencil_calls(p, sweeps=(sweeps,), plain=True)
    bounds = _stencil_bounds(ny, nx, sweeps)
    t0 = time.time()
    library, nnz = _library_calls(p)
    lib_err = {}
    for name, lib in library.items():
        got, ref = lib(), calls[name]()
        lib_err[name] = float((got - ref).abs().max())
        # Another order of sums (edge neighbours summed into one column,
        # cuSPARSE's row order): within 1e-5 of the largest magnitude.
        check(lib_err[name] <= 1e-5 * float(ref.abs().max()),
              f"the library's CSR product differs from {name}: max-abs "
              f"{lib_err[name]:.3e}")
    log(f"phase 2: A, G and D as CSR matrices ({nnz} nonzeros) in "
        f"{time.time() - t0:.1f} s; the library calls against the kernels, "
        "max-abs (another order of sums): "
        + ", ".join(f"{k} {v:.3e}" for k, v in lib_err.items()))
    rows = []
    for name in STENCIL_REPLACES:
        key = name if name != "momentum_jacobi" else f"{name} {sweeps}"
        ms, ms_read = both_flushes_ms(calls[key])
        plain_ms = cuda_time_ms(plain[key], reps=20)
        lib_ms = (cuda_time_ms(library[name]) if name in library else None)
        bnd, by = bound_ms(*bounds[name])
        rows.append(f"{name} {ms:.4f} / {ms_read:.4f} / {bnd:.4f} ({by}) / "
                    f"plain {plain_ms:.4f}"
                    + ("" if lib_ms is None else f" / CSR {lib_ms:.4f}"))
        results[name] = dict(
            name=name, route="cuda", source=STENCIL_SRC,
            replaces=STENCIL_REPLACES[name], launches=0,
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bnd,
            bound_by=by, library_ms=lib_ms, ms_read_flush=ms_read)
    results["momentum_jacobi"].update(mom_2m)
    del library
    n_launch = sk.momentum_launches(sweeps, False)
    log(f"phase 2: stencil kernels at {ny}x{nx} (momentum_jacobi {sweeps} "
        f"sweeps, {n_launch} launch{'es' if n_launch > 1 else ''}: "
        f"{_momentum_plan_note(sk, ny, nx, sweeps)}), ms / ms "
        "under the read flush / read-once bound ms / plain ms / library ms: "
        + "; ".join(rows))
    # The per-sweep launches (the seed, then one launch per sweep: the
    # row-sharded form), here with the block's own edge rows as its halo.
    r2, dinv, off = p["r"][:2], p["diag_u_inv2"], p["off_mom"]
    own = lambda z: (z[:, :1].contiguous(), z[:, -1:].contiguous())
    per = lambda: sk.momentum_jacobi(r2, dinv, off, sweeps, halo=own)
    check(torch.equal(per(), calls[f"momentum_jacobi {sweeps}"]()),
          "the per-sweep launches differ from the one-launch predict")
    p_ms, p_read = both_flushes_ms(per)
    one = cc.stencil_calls(p, sweeps=(1,))["momentum_jacobi 1"]
    m1, m1_read = both_flushes_ms(one)
    log(f"phase 2: momentum_jacobi {sweeps} sweeps as {sweeps} per-sweep "
        f"launches (the row-sharded form) {p_ms:.4f} / {p_read:.4f} ms, "
        f"bit-equal to the one-launch predict; 1 sweep (the seed alone) "
        f"{m1:.4f} / {m1_read:.4f} ms")
    sp_ = cc.stencil_tensors((37, 111), 5, "cuda")
    h_k = {k: host_us(c) for k, c in cc.stencil_calls(sp_).items()}
    h_p = {k: host_us(c, reps=50) for k, c in
           cc.stencil_calls(sp_, plain=True).items()}
    log("phase 2: host time per call, kernel / plain version: "
        + ", ".join(f"{k} {h_k[k]:.1f} / {h_p[k]:.1f} us" for k in h_k))
    sk.LAUNCHES.update(before)


def _channel(min_cell):
    from cfd2_tpu_torch import ChannelWithObstacle, generate_cut_cell_mesh
    geo = ChannelWithObstacle(length=3.0, height=1.0,
                              obstacle_center=(1.0, 0.5),
                              obstacle_radius=0.2)
    return generate_cut_cell_mesh(geo, min_cell, min_cell, 1.2, (3.0, 1.0))


def _solver(mesh, min_cell, device, **config):
    """CoupledSolver set up as bench.py sets it up, started from rest."""
    from dataclasses import replace
    from cfd2_tpu_torch import CoupledSolver
    s = CoupledSolver(mesh, device=device)
    s.set_dt(min(0.002, 0.4 * min_cell))
    s.set_viscosity(0.01)
    s.set_density(1.0)
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5, **config)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < min_cell * 2, 0] = 1.0
    s.set_u(u0)
    return s


def _finite(s):
    import torch
    return bool(torch.isfinite(s.state.u).all()) and \
        bool(torch.isfinite(s.state.p).all())


def _main_steps(s, ctx, n):
    """Phase 3's 3 healing and 3 timed steps, the launch counts zeroed just
    before; returns the FGMRES iterations of all six and the timed steps'
    (outers, FGMRES iterations)."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.runtime import host_reads
    sk.reset_launches()
    lin_total = 0
    timed = []
    for i in range(6):
        if i == 3:   # the developed state phase 4 starts from
            ctx["main"] = dict(solver=s, state=s.state, params=s.params,
                               timed=timed)
        host_reads.reset()
        before = dict(sk.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        outer = int(s.state.outer_iters)
        lins = int(s.state.linear_iters_total)
        lin_total += lins
        step_launch = {k: v - before[k] for k, v in sk.LAUNCHES.items()}
        kind = "heal" if i < 3 else "timed"
        if i >= 3:
            timed.append((outer, lins))
        log(f"phase 3: {kind} step {i}: wall {wall:.4f} s, outer_iters "
            f"{outer}, linear_iters_total {lins}, cell-updates/s "
            f"{n / wall:.1f}, host reads {host_reads.COUNT['reads']}, "
            f"launches {step_launch}")
        check(_finite(s), f"non-finite fields after step {i}")
    return lin_total, timed


# The kernels that only the half-sweep path (CFD2_PALLAS=1) launches; its
# main-path run is phase 4.
HALF_SWEEP_PATH = ("rbgs_half_sweep", "rbgs_residual")


def phase_main(results, ctx):
    import torch
    from cfd2_tpu_torch.convert import load_developed_state
    from cfd2_tpu_torch.ops import stencil_kernels as sk

    t0 = time.time()
    mesh = _channel(0.0017)
    log(f"phase 3: mesh {mesh.num_cells} cells in {time.time() - t0:.1f} s")
    check(mesh.num_cells == MAIN_CELLS, f"mesh has {mesh.num_cells} cells")
    t0 = time.time()
    s = _solver(mesh, 0.0017, None)
    check(tuple(s.mesh.grid_shape) == MAIN_GRID,
          f"grid {s.mesh.grid_shape} != {MAIN_GRID}")
    amg = s._get_amg()
    grids, coarsest = level_grids(*MAIN_GRID)
    check(len(amg.levels) == len(grids)
          and tuple(amg.levels[-1].grid) == coarsest,
          "hierarchy does not match the expected level grids")
    ctx["rest"] = (s.state, s.params)   # phase 9's presolve step
    meta = load_developed_state(s, ROOT / "bench_developed_1m.npz")
    torch.cuda.synchronize()
    log(f"phase 3: solver set-up {time.time() - t0:.1f} s; "
        f"{len(grids)} smoothed levels, coarsest {coarsest}; "
        f"viscosity {meta['viscosity']}")

    ctx["main_mesh"] = mesh             # phase 12 encodes it again, padded
    n = mesh.num_cells
    ms = s.config.mom_sweeps(s.mesh.total_cells)
    _hold_on_assembled_system(results, s, ms)
    with _counting_matvecs() as matvecs:
        lin_total, timed = _main_steps(s, ctx, n)
    counts = dict(sk.LAUNCHES)
    leg = counts["rbgs_leg"]
    for name, cnt in counts.items():
        if name in results and name not in HALF_SWEEP_PATH:
            results[name]["launches"] = cnt
    _path_launches(results, "structured (phase 3)",
                   {k: v for k, v in counts.items()
                    if k not in HALF_SWEEP_PATH})
    check(all(counts.get(k, 0) == 0 for k in HALF_SWEEP_PATH),
          f"a half-sweep path kernel ran on the leg path: {counts}")
    check(leg > 0, "rbgs_leg was never launched on the main path")
    per_apply = 2 * len(grids)
    check(leg == per_apply * lin_total,
          f"rbgs_leg launches {leg} != {per_apply} per preconditioner "
          f"application x {lin_total} applications")
    log(f"phase 3: rbgs_leg launches {leg} = {per_apply} per V-cycle x "
        f"{lin_total} FGMRES iterations; rbgs_half_sweep "
        f"{counts['rbgs_half_sweep']}")
    _check_stencil_rates(3, counts, lin_total, ms, False, matvecs[0])
    lins = tuple(lin for _, lin in timed)
    log(f"phase 3: timed steps' outers {[o for o, _ in timed]} and FGMRES "
        f"iterations {list(lins)}; recorded: FGMRES iterations "
        f"{list(TIMED_LIN)}")
    check(lins == TIMED_LIN, f"timed FGMRES iterations {lins} != the "
          f"recorded {TIMED_LIN}: a kernel changed the path's arithmetic")


def _check_stencil_rates(phase, counts, lin, ms, sharded, matvecs=None):
    """The stencil kernels' launches on a structured run of ``lin`` FGMRES
    iterations (one preconditioner application each): per application one
    Schur right-hand side, one gradient and two momentum predicts of
    ``momentum_launches(ms)`` launches; one matvec per ``matvecs`` call
    (the iterations' and the true residuals')."""
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    per = max(lin, 1)
    mom = 2 * sk.momentum_launches(ms, sharded) * lin
    log(f"phase {phase}: stencil kernels per FGMRES iteration: "
        + ", ".join(f"{k} {counts[k] / per:.2f}" for k in STENCIL_REPLACES)
        + f", rbgs_leg {counts['rbgs_leg'] / per:.2f}; hand kernels "
        f"{sum(counts.values()) / per:.2f} per iteration")
    for name in STENCIL_REPLACES:
        check(counts[name] > 0, f"{name} was never launched on the path")
    check(counts["schur_rhs"] == lin and counts["pressure_gradient"] == lin,
          f"schur_rhs {counts['schur_rhs']} / pressure_gradient "
          f"{counts['pressure_gradient']} launches != one per FGMRES "
          f"iteration ({lin})")
    check(counts["momentum_jacobi"] == mom,
          f"momentum_jacobi launches {counts['momentum_jacobi']} != 2 x "
          f"{sk.momentum_launches(ms, sharded)} per FGMRES iteration "
          f"({mom})")
    if matvecs is not None:
        check(counts["coupled_spmv"] == matvecs and matvecs > lin,
              f"coupled_spmv launches {counts['coupled_spmv']}, matvecs "
              f"{matvecs}, FGMRES iterations {lin}")
        log(f"phase {phase}: coupled_spmv {matvecs} = {lin} FGMRES "
            f"iterations + {matvecs - lin} true residuals")


def _hold_on_assembled_system(results, s, ms, phase=3):
    """Phases 3 and 13, before stepping: the four stencil kernels bit-equal
    to their plain versions on the solver's own system, assembled from its
    developed state (the predicts at the path's ``ms`` sweeps and at 1)."""
    import torch
    from cfd2_tpu_torch.models.assembly import assemble_stencil, prepare
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    ss = assemble_stencil(s.mesh, prepare(s.mesh, s.state, s.params,
                                          s.config), s.params, s.config)
    cc = _stencil_cases()
    p = {k: getattr(ss, k) for k in cc.OFF_NAMES + cc.DIAG_NAMES
         + ("diag_u_inv2",)}
    ny, nx = ss.grid
    g = torch.Generator(device="cuda").manual_seed(31)
    p.update({k: torch.randn(*shape, generator=g, device="cuda")
              for k, shape in (("x", (3, ny, nx)), ("r", (3, ny, nx)),
                               ("z", (2, ny, nx)), ("zp", (ny, nx)))})
    before = dict(sk.LAUNCHES)
    errs = _hold_stencils(phase, sk, [("the assembled system", p, (1, ms))])
    sk.LAUNCHES.update(before)
    for name, err in errs.items():
        if name in results:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)


def phase_half_sweep(results, ctx):
    """The half-sweep path (CFD2_PALLAS=1) at full width: phase 3's solver
    restarted from its state after healing, 2 steps, beside phase 3's first
    two timed steps."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.runtime import host_reads

    check("main" in ctx, "phase 4 steps phase 3's developed state: run "
          "phase 3 with it")
    main = ctx["main"]
    s = main["solver"]
    s.state, s.params = main["state"], main["params"]
    grids, _ = level_grids(*MAIN_GRID)
    old = os.environ.get("CFD2_PALLAS")
    os.environ["CFD2_PALLAS"] = "1"
    try:
        sk.reset_launches()
        lin_total = 0
        for i, (outer3, lins3) in enumerate(main["timed"][:2]):
            host_reads.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            outer = int(s.state.outer_iters)
            lins = int(s.state.linear_iters_total)
            lin_total += lins
            log(f"phase 4: step {i} with CFD2_PALLAS=1: wall {wall:.4f} s, "
                f"outer_iters {outer}, linear_iters_total {lins}, "
                f"cell-updates/s {MAIN_CELLS / wall:.1f}, host reads "
                f"{host_reads.COUNT['reads']} (phase 3's timed step {i}: "
                f"outer_iters {outer3}, linear_iters_total {lins3})")
            check(_finite(s), "non-finite fields on the half-sweep path")
            check(outer == outer3, f"step {i}: {outer} outer iterations on "
                  f"the half-sweep path, {outer3} on the leg path")
            check(abs(lins - lins3) <= 2 * outer,
                  f"step {i}: {lins} FGMRES iterations on the half-sweep "
                  f"path, {lins3} on the leg path (more than 2 per outer "
                  "apart)")
        counts = dict(sk.LAUNCHES)
    finally:
        if old is None:
            os.environ.pop("CFD2_PALLAS")
        else:
            os.environ["CFD2_PALLAS"] = old
    for name in HALF_SWEEP_PATH:
        if name in results:
            results[name]["launches"] = counts[name]
    _path_launches(results, "half-sweep (phase 4)",
                   {k: v for k, v in counts.items() if k != "rbgs_leg"})
    per_apply = 2 * 2 * len(grids)   # 2 half-sweeps x 2 smooths per level
    log(f"phase 4: {MAIN_CELLS} cells, launches {counts} over {lin_total} "
        f"FGMRES iterations ({per_apply} half-sweeps per V-cycle)")
    if "coupled_spmv" in counts:
        _check_stencil_rates(4, counts, lin_total,
                             s.config.mom_sweeps(s.mesh.total_cells), False)
    check(counts["rbgs_half_sweep"] == per_apply * lin_total,
          f"rbgs_half_sweep launches {counts['rbgs_half_sweep']} != "
          f"{per_apply} per V-cycle x {lin_total} FGMRES iterations")
    check(counts["rbgs_residual"] == len(grids) * lin_total,
          f"rbgs_residual launches {counts['rbgs_residual']} != one per "
          f"level's down leg ({len(grids)}) x {lin_total} FGMRES iterations")
    check(counts["rbgs_leg"] == 0, "rbgs_leg ran on the CFD2_PALLAS=1 path")


def phase_cpu_match():
    mesh = _channel(0.025)
    runs = {}
    for dev in ("cuda", "cpu"):
        s = _solver(mesh, 0.025, dev)
        s.step()
        runs[dev] = (int(s.state.outer_iters), s.get_u())
    (o_gpu, u_gpu), (o_cpu, u_cpu) = runs["cuda"], runs["cpu"]
    scale = float(np.abs(u_cpu).max())
    err = float(np.abs(u_gpu - u_cpu).max())
    log(f"phase 5: {mesh.num_cells} cells, outer_iters card {o_gpu} / cpu "
        f"{o_cpu}, max|u_card - u_cpu| {err:.3e} (limit "
        f"{1e-4 * scale:.3e})")
    check(o_gpu == o_cpu, "outer iteration counts differ")
    check(np.isfinite(u_gpu).all() and err <= 1e-4 * scale,
          "card and CPU velocities disagree")


def _obstacle_geo():
    from cfd2_tpu_torch import ChannelWithObstacle
    return ChannelWithObstacle(length=3.0, height=1.0,
                               obstacle_center=(1.0, 0.5),
                               obstacle_radius=0.2)


def _unstructured_solver(mesh, min_cell, device):
    """CoupledSolver set up as bench_sweep.py sets up its from-rest
    unstructured and refined cases: dt = min(0.002, 0.4 h), precond_type=1
    (the aggregation AMG, or the embedded multigrid on a multilevel mesh),
    the inlet column at u = 1."""
    from cfd2_tpu_torch import CoupledSolver
    s = CoupledSolver(mesh, device=device)
    s.set_dt(min(0.002, 0.4 * min_cell))
    s.set_precond_type(1)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < min_cell * 2, 0] = 1.0
    s.set_u(u0)
    return s


def _hold_on_solver_maps(phase, s, results):
    """Each banded wrapper against its plain version on the index maps this
    solver steps with, at their own shapes, with random data: the mesh's
    ``ck_neighbor`` (every gather width, every product form, the sweeps with
    the mesh's slot cap), and per coarse level its ELL map, the Galerkin
    grouping map, the restriction member lists and the K = 1 prolongation
    map.  Folds the errors into ``results``; the launches made here are
    taken off the counts again."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk

    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.ops.amg import AmgHierarchy, MultilevelAmg
    before = dict(bk.LAUNCHES)
    dm, hier = s.mesh, s._get_amg()
    if isinstance(hier, MultilevelAmg):
        # The embedded multigrid's V-cycle runs rbgs_leg on every grid of
        # its structured levels but the coarsest, which it solves directly:
        # hold the leg there.  It has no ELL levels.
        fine = hier.fine.levels
        grids = [fine[0].fine_grid] + [lvl.grid for lvl in fine[:-1]]
        leg_before = dict(sk.LAUNCHES)
        err_leg, err_fused, _ = _hold_legs(phase, sk, grids)
        sk.LAUNCHES.update(leg_before)
        if "rbgs_leg" in results:
            results["rbgs_leg"]["max_abs_err"] = max(
                results["rbgs_leg"]["max_abs_err"], err_leg, err_fused)
    levels = hier.levels if isinstance(hier, AmgHierarchy) else ()
    dev = dm.ck_neighbor.device
    n, K = dm.ck_neighbor.shape
    err = {"banded_gather": 0.0, "banded_dot": 0.0,
           "banded_jacobi_sweeps": 0.0}
    shapes = []

    def hold(name, got, ref):
        err[name] = max(err[name], _maxerr(got, ref))

    def gather(x, idx):
        hold("banded_gather", [bk.banded_gather(x, idx)],
             [bk.banded_gather_ref(x, idx)])
        shapes.append(f"gather {tuple(idx.shape)}<-{tuple(x.shape)}")

    def dot(xs, offs, idx, prods):
        hold("banded_dot", bk.banded_dot(xs, offs, idx, prods),
             bk.banded_dot_ref(xs, offs, idx, prods))

    for C in (None, 2, 6):
        x = _rand((n,) if C is None else (n, C), 110, dev)
        hold("banded_gather", [dm.gather(x)],
             [bk.banded_gather_ref(x, dm.ck_neighbor)])
    shapes.append(f"gather ({n}, {K}) C=1,2,6")
    for n_x, n_off, prods in DOT_FORMS.values():
        xs = [_rand((n,), 120 + c, dev) for c in range(n_x)]
        offs = [_rand((n, K), 130 + p, dev, 0.3) for p in range(n_off)]
        hold("banded_dot", dm.banded_dot(xs, offs, prods),
             bk.banded_dot_ref(xs, offs, dm.ck_neighbor, prods))
    shapes.append(f"dot ({n}, {K}) x {len(DOT_FORMS)} forms")
    rs = [_rand((n,), 140 + c, dev) for c in range(2)]
    dinv = 1.0 / (1.0 + _rand((n,), 142, dev).abs())
    off = _rand((n, K), 143, dev, 0.5 / K)
    for sweeps in (1, 3, 8):
        hold("banded_jacobi_sweeps",
             dm.banded_jacobi_sweeps(rs, dinv, off, sweeps),
             bk.banded_jacobi_sweeps_ref(rs, dinv, off, dm.ck_neighbor,
                                         sweeps, k_cap=dm.bd_k))
    shapes.append(f"sweeps ({n}, {K}) k_cap={dm.bd_k}")

    n_fine, k_fine = n, K
    one = DOT_FORMS["scalar"][2]
    for li, lvl in enumerate(levels):
        x_c = _rand((lvl.n,), 150 + li, dev)
        r_f = _rand((n_fine,), 160 + li, dev)
        dot((x_c,), (_rand((lvl.n, lvl.k), 170 + li, dev, 0.3),),
            lvl.ell_neighbor, one)
        dot((r_f,), (lvl.members_mask,), lvl.members, one)
        shapes.append(f"dot {tuple(lvl.ell_neighbor.shape)}, restriction "
                      f"{tuple(lvl.members.shape)}<-({n_fine},)")
        gather(x_c, lvl.agg)
        gather(_rand((n_fine * (k_fine + 1),), 180 + li, dev),
               lvl.rap_order)
        base = _rand((n_fine,), 190 + li, dev)
        for alpha in (1.0, 1.5):
            hold("banded_gather",
                 [bk.banded_prolong_add(base, x_c, lvl.agg, alpha)],
                 [base + alpha * x_c[lvl.agg[:, 0].long()]])
        shapes.append(f"prolongation {tuple(lvl.agg.shape)}<-({lvl.n},)")
        n_fine, k_fine = lvl.n, lvl.k
    torch.cuda.synchronize()
    bk.LAUNCHES.update(before)
    log(f"phase {phase}: kernels against plain versions on the solver's "
        f"maps: max-abs error gather {err['banded_gather']:.3e}, dot "
        f"{err['banded_dot']:.3e}, sweeps "
        f"{err['banded_jacobi_sweeps']:.3e} (tolerance {TOL:g}); "
        + "; ".join(shapes))
    _check_banded_errs(err["banded_gather"], err["banded_dot"],
                       err["banded_jacobi_sweeps"])
    for name, e in err.items():
        if name in results:
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], e)


def _v_cycle_kernels(s):
    """One aggregation V-cycle on the solver's hierarchy, with random level
    values, under the profiler: as the solver runs it, then with each
    level's prolongation done as the gather, product and sum of the earlier
    rounds.  Returns the device kernels of each, by name, the
    ``banded_gather`` count of the first, and whether the two agree bit for
    bit."""
    import torch
    from cfd2_tpu_torch.ops import amg
    from cfd2_tpu_torch.ops import banded_kernels as bk

    dm, hier = s.mesh, s._get_amg()
    n = dm.num_cells
    rng = np.random.default_rng(200)
    mask = dm.ck_mask.cpu().numpy() > 0
    p_off = np.where(mask, -(0.5 + rng.random(mask.shape)), 0.0)
    p_diag = -p_off.sum(axis=1) + 0.05 + 0.05 * rng.random(n)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")
    lv = amg.compute_level_values(hier, t(p_diag), t(p_off))
    b = t(rng.standard_normal(n))
    x0 = b / lv[0][0]
    fused = bk.banded_prolong_add

    def eager(base, x, idx, alpha):
        return base + alpha * bk.banded_gather(x, idx)[:, 0]

    def kernels(prolong):
        bk.banded_prolong_add = prolong
        try:
            amg.v_cycle(hier, lv, dm, b, x0, **s.config.cycle_opts())
            torch.cuda.synchronize()
            before = bk.LAUNCHES["banded_gather"]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                x = amg.v_cycle(hier, lv, dm, b, x0,
                                **s.config.cycle_opts())
                torch.cuda.synchronize()
            counted = bk.LAUNCHES["banded_gather"] - before
        finally:
            bk.banded_prolong_add = fused
        names = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
        return names, counted, x

    saved = dict(bk.LAUNCHES)
    (k_fused, counted, x_f), (k_eager, _, x_e) = kernels(fused), kernels(eager)
    bk.LAUNCHES.update(saved)
    return k_fused, k_eager, counted, torch.equal(x_f, x_e)


def _check_prolongation(phase, s):
    """The V-cycle prolongs through the fused kernel: one launch per level,
    counted under banded_gather, and two fewer device kernels per level
    than the gather, product and sum, with the same bits."""
    import torch
    L = len(s._get_amg().levels)
    # The process's first profiler session starts CUPTI, and a session has
    # been seen to miss one kernel record (a V-cycle one kernel short, its
    # bits equal): one session is spent first, and the pair is taken again,
    # up to three times, until its totals differ by exactly 2 per level.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    for attempt in range(1, 4):
        k_fused, k_eager, counted, same = _v_cycle_kernels(s)
        n_f, n_e = sum(k_fused.values()), sum(k_eager.values())
        if n_e - n_f == 2 * L:
            break
        log(f"phase {phase}: profile pair {attempt}: {n_f} and {n_e} "
            f"device kernels, {n_e - n_f} apart, not {2 * L}")
    n_prol = sum(c for k, c in k_fused.items() if "prolong_add" in k)
    n_gath = sum(c for k, c in k_fused.items() if "banded_gather" in k)
    log(f"phase {phase}: one V-cycle ({L} coarse levels): {n_f} device "
        f"kernels, {n_prol} fused prolongations, {n_gath} gathers, "
        f"{counted} counted under banded_gather; with the gather, product "
        f"and sum: {n_e} kernels; results bit-equal: {same}")
    diff = {k: k_eager.get(k, 0) - k_fused.get(k, 0)
            for k in sorted(set(k_eager) | set(k_fused))
            if k_eager.get(k, 0) != k_fused.get(k, 0)}
    log(f"phase {phase}: device kernels by name, the gather, product and "
        f"sum less the fused form: {diff}")
    check(n_prol == L and n_gath == 0 and counted == L,
          f"the V-cycle did not prolong through one fused launch per level")
    check(n_e - n_f == 2 * L, f"the fused prolongation saves {n_e - n_f} "
          f"device kernels per V-cycle, not 2 per level ({2 * L})")
    check(same, "the fused prolongation changes the V-cycle's bits")
    return L


def _check_sweeps_records(phase, s, calls=3):
    """One banded_jacobi_sweeps call (C = 2, 8 sweeps, on the solver's map)
    is one device kernel: the profiler's kernel records over ``calls``
    calls.  As in _check_prolongation, a session that misses a record is
    taken again, up to three times."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk
    dm = s.mesh
    n, K = dm.ck_neighbor.shape
    rs = [_rand((n,), 80 + c, "cuda") for c in range(2)]
    dinv = 1.0 / (1.0 + _rand((n,), 82, "cuda").abs())
    off = _rand((n, K), 83, "cuda", 0.1)
    call = lambda: dm.banded_jacobi_sweeps(rs, dinv, off, 8)
    saved = dict(bk.LAUNCHES)
    call()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        names = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
        if sum(names.values()) == calls:
            break
        log(f"phase {phase}: sweeps profile {attempt}: {names}")
    bk.LAUNCHES.update(saved)
    log(f"phase {phase}: {calls} banded_jacobi_sweeps calls on the solver's "
        f"map: device kernels {names}")
    check(sum(names.values()) == calls
          and all("jacobi_sweeps" in k for k in names),
          f"{calls} sweeps calls ran {sum(names.values())} device kernels, "
          "not one each")


def _drive_unstructured(phase, s, n_cells, n_steps, before_step=None):
    """Step ``s`` with the launch counts zeroed just before; returns the
    counts read just after, the FGMRES iterations taken and per step the
    outers and FGMRES iterations.  ``before_step(i)`` is called before step
    ``i``, outside the timed span."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.runtime import host_reads
    from cfd2_tpu_torch.tools import developed_cases as dc

    bk.reset_launches()
    sk.reset_launches()
    lin_total = 0
    rows = []
    for i in range(n_steps):
        if before_step is not None:
            before_step(i)
        host_reads.reset()
        before = dict(bk.LAUNCHES)
        its, restore = dc.record_solves()
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            s.step()
            torch.cuda.synchronize()
        finally:
            restore()
        wall = time.perf_counter() - t
        outer = int(s.state.outer_iters)
        lins = int(s.state.linear_iters_total)
        lin_total += lins
        rows.append((outer, lins))
        step_launch = {k: v - before[k] for k, v in bk.LAUNCHES.items()}
        log(f"phase {phase}: step {i}: wall {wall:.4f} s, outer_iters "
            f"{outer}, linear_iters_total {lins} {its}, cell-updates/s "
            f"{n_cells / wall:.1f}, host reads {host_reads.COUNT['reads']}, "
            f"launches {step_launch}")
        check(_finite(s), f"non-finite fields after step {i}")
    counts = dict(bk.LAUNCHES)
    for name, cnt in counts.items():
        check(cnt > 0, f"{name} was never launched on this path")
    check(counts["banded_jacobi_sweeps"] == 2 * lin_total,
          f"banded_jacobi_sweeps calls {counts['banded_jacobi_sweeps']} != "
          f"2 per preconditioner application x {lin_total} FGMRES "
          "iterations")
    check(sum(sk.LAUNCHES.values()) == 0,
          "a structured-path kernel ran on an unstructured mesh")
    log(f"phase {phase}: {lin_total} FGMRES iterations; per iteration "
        f"{counts['banded_dot'] / lin_total:.2f} banded_dot, "
        f"{counts['banded_gather'] / lin_total:.2f} banded_gather, "
        f"{counts['banded_jacobi_sweeps'] / lin_total:.2f} "
        "banded_jacobi_sweeps calls")
    return counts, lin_total, rows


def _step2_input(s, ctx, case, phase):
    """Before a case's step 2: write the state the step reads into the
    directory ``--save-step2-input`` names, and log how far it lies from the
    committed one."""
    from cfd2_tpu_torch.tools import developed_cases as dc
    if ctx.get("save_step2_input"):
        out = dc.card_step2_path(case, ctx["save_step2_input"])
        out.parent.mkdir(parents=True, exist_ok=True)
        dc.save_step_input(s, out, case=case, step=2, card=card_line(),
                           source=f"chip_smoke.py phase {phase}")
        log(f"phase {phase}: step 2's input written to {out}")
    ref_path = dc.card_step2_path(case)
    if not ref_path.exists():
        return
    ref, _ = dc.read_step_input(ref_path)
    diffs = {f: float(np.abs(s.mesh.to_host_order(getattr(s.state, f))
                             .cpu().numpy() - a).max())
             for f, a in ref.items()}
    log(f"phase {phase}: step 2's input against the committed "
        f"{ref_path.name}: max-abs difference {diffs}")


def phase_delaunay(results, ctx):
    import torch
    from cfd2_tpu_torch.tools import mesh_cache

    t0 = time.time()
    _wait_mesh(ctx, "phase 6")
    mesh = mesh_cache.get_mesh("delaunay", DELAUNAY_MIN_CELL)
    log(f"phase 6: Delaunay mesh {mesh.num_cells} cells in "
        f"{time.time() - t0:.1f} s (made in the background since phase 1)")
    check(mesh.num_cells == DELAUNAY_CELLS,
          f"mesh has {mesh.num_cells} cells, expected {DELAUNAY_CELLS}")
    t0 = time.time()
    s = _unstructured_solver(mesh, DELAUNAY_MIN_CELL, None)
    dm = s.mesh
    check(dm.banded and not dm.structured and dm.bd_k is None,
          f"layout: banded {dm.banded}, bd_k {dm.bd_k}")
    check(dm.banded_sweeps_fit(2), "the one-call sweeps rule must hold here")
    amg = s._get_amg()
    sizes = tuple(lvl.n for lvl in amg.levels)
    torch.cuda.synchronize()
    log(f"phase 6: N_dev {dm.num_cells}, K {dm.max_faces}; encode + "
        f"hierarchy {time.time() - t0:.1f} s; coarse levels {sizes}")
    check(sizes == DELAUNAY_LEVELS,
          f"hierarchy levels {sizes} != {DELAUNAY_LEVELS}")
    _hold_on_solver_maps(6, s, results)
    counts, lin_total, rows = _drive_unstructured(
        6, s, mesh.num_cells, 3,
        lambda i: (_step2_input(s, ctx, "delaunay_403k_rest", 6) if i == 2
                   else None))
    # Steps 0-1 against the from-rest record; step 2 against the JAX
    # package's step from the card's own step-2 state, which took the
    # card's 7 outers and 232 FGMRES iterations to its 242: the step's gap
    # to the from-rest record is roundoff carried in from steps 0-1.
    case = "delaunay_403k_rest"
    _beside_record(6, case, rows[:2], enforce=True)
    _beside_record(6, case, rows[2:], first=2)
    _beside_record(6, case, rows[2:], enforce=True, first=2,
                   suffix="_from_card_step2")
    ctx["delaunay"] = s
    for name, cnt in counts.items():
        if name in results:
            results[name]["launches"] = cnt
    _path_launches(results, "Delaunay (phase 6)", counts)
    L = _check_prolongation(6, s)
    _check_sweeps_records(6, s)
    # Of the steps' gathers, L per FGMRES iteration are the V-cycle's
    # prolongations; the rest are the assembly's and the Galerkin sums'.
    rest = counts["banded_gather"] - L * lin_total
    log(f"phase 6: banded_gather {counts['banded_gather']} = {L} fused "
        f"prolongations x {lin_total} FGMRES iterations + {rest} assembly "
        f"and Galerkin gathers ({counts['banded_gather'] / lin_total:.2f} "
        "per iteration)")
    check(0 <= rest < lin_total, "banded_gather launches do not split into "
          f"{L} per FGMRES iteration and the assembly's")


def phase_voronoi(results, ctx):
    import torch
    from cfd2_tpu_torch.tools import mesh_cache

    t0 = time.time()
    _wait_mesh(ctx, "phase 7")
    mesh = mesh_cache.get_mesh("voronoi", VORONOI_MIN_CELL)
    log(f"phase 7: Voronoi mesh {mesh.num_cells} cells in "
        f"{time.time() - t0:.1f} s")
    check(mesh.num_cells == VORONOI_CELLS,
          f"mesh has {mesh.num_cells} cells, expected {VORONOI_CELLS}")
    s = _unstructured_solver(mesh, VORONOI_MIN_CELL, None)
    dm = s.mesh
    torch.cuda.synchronize()
    log(f"phase 7: N_dev {dm.num_cells}, K {dm.max_faces}, bd_k {dm.bd_k}, "
        f"coarse levels {tuple(lvl.n for lvl in s._get_amg().levels)}")
    check(dm.banded and dm.bd_k == 8, f"expected the slot cap 8, got "
          f"banded {dm.banded}, bd_k {dm.bd_k}")
    _hold_on_solver_maps(7, s, results)
    _drive_unstructured(7, s, mesh.num_cells, 2)


def phase_delaunay_cpu_match():
    from cfd2_tpu_torch import generate_delaunay_mesh
    mesh = generate_delaunay_mesh(_obstacle_geo(), 0.025, 0.025, 1.2,
                                  (3.0, 1.0))
    runs = {}
    for dev in ("cuda", "cpu"):
        s = _unstructured_solver(mesh, 0.025, dev)
        s.step()
        runs[dev] = (int(s.state.outer_iters),
                     int(s.state.linear_iters_total), s.get_u())
    (o_gpu, l_gpu, u_gpu), (o_cpu, l_cpu, u_cpu) = runs["cuda"], runs["cpu"]
    scale = float(np.abs(u_cpu).max())
    err = float(np.abs(u_gpu - u_cpu).max())
    log(f"phase 8: {mesh.num_cells} Delaunay cells, outer_iters card {o_gpu} "
        f"/ cpu {o_cpu}, linear iterations {l_gpu} / {l_cpu}, "
        f"max|u_card - u_cpu| {err:.3e} (limit {1e-4 * scale:.3e})")
    check(o_gpu == o_cpu, "outer iteration counts differ")
    check(np.isfinite(u_gpu).all() and err <= 1e-4 * scale,
          "card and CPU velocities disagree")


# ----------------------------------------------------------------------
# Phase 9: the options and the other entry points.


def _outer_slack(opts) -> int:
    """Outer-count slack of card against CPU: 2 with Anderson mixing, whose
    later outers extrapolate differences at the linear solves' rtol (the
    CPU parity tests measured the same against the JAX package), else 0."""
    return 2 if opts.get("anderson_depth") else 0


def _timed_steps(s, n, mode="fused", step=None):
    """``n`` steps of ``s`` (or of ``step()``) with the launch counts zeroed
    just before and read just after; returns the rows (outers, FGMRES
    iterations per outer, wall s, host reads) and the counts."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.runtime import host_reads
    from cfd2_tpu_torch.tools import developed_cases as dc
    rows = []
    sk.reset_launches()
    bk.reset_launches()
    for _ in range(n):
        its, restore = dc.record_solves()
        host_reads.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            if step is None:
                s.step(mode=mode)
            else:
                step()
            torch.cuda.synchronize()
        finally:
            restore()
        rows.append((int(s.state.outer_iters), its,
                     time.perf_counter() - t, host_reads.COUNT["reads"]))
        check(_finite(s), "non-finite fields")
    return rows, {**sk.LAUNCHES, **bk.LAUNCHES}


def _log_run(label, rows, counts, phase=9):
    for i, (outer, its, wall, reads) in enumerate(rows):
        log(f"phase {phase}: {label} step {i}: outer_iters {outer}, FGMRES "
            f"iterations {sum(its)} per outer {its}, wall {wall:.4f} s, "
            f"host reads {reads}")
    log(f"phase {phase}: {label} launches {counts}")


def _options_card_vs_cpu(make, label, opts, mode="fused", structured=True):
    """One step of a fresh small-mesh solver with ``opts`` on the card and
    on the CPU (``make(device)``): outer counts equal (within the Anderson
    slack), u within 1e-4 * max|u|, and the path's kernels launched on the
    card.  Returns (outers card, outers cpu, max|du|, limit)."""
    from dataclasses import replace
    runs = {}
    for dev in ("cuda", "cpu"):
        s = make(dev)
        s.config = replace(s.config, **opts)
        if dev == "cuda":
            rows, counts = _timed_steps(s, 1, mode=mode)
        else:
            s.step(mode=mode)
        runs[dev] = (int(s.state.outer_iters), s.get_u())
    (o_gpu, u_gpu), (o_cpu, u_cpu) = runs["cuda"], runs["cpu"]
    limit = 1e-4 * float(np.abs(u_cpu).max())
    err = float(np.abs(u_gpu - u_cpu).max())
    names = (("rbgs_leg",) if structured else
             ("banded_gather", "banded_dot", "banded_jacobi_sweeps"))
    check(all(counts[k] > 0 for k in names),
          f"{label}: {names} not all launched on the card: {counts}")
    check(abs(o_gpu - o_cpu) <= _outer_slack(opts),
          f"{label}: outer iterations card {o_gpu}, cpu {o_cpu}")
    check(np.isfinite(u_gpu).all() and err <= limit,
          f"{label}: card and CPU velocities disagree: {err:.3e} > "
          f"{limit:.3e}")
    return o_gpu, o_cpu, err, limit


def _small_solvers():
    from cfd2_tpu_torch import generate_delaunay_mesh
    channel = _channel(0.025)
    delaunay = generate_delaunay_mesh(_obstacle_geo(), 0.025, 0.025, 1.2,
                                      (3.0, 1.0))
    return ((lambda dev: _solver(channel, 0.025, dev), True),
            (lambda dev: _unstructured_solver(delaunay, 0.025, dev), False))


def _small_option_runs(structured):
    runs = [(label, opts, "fused") for label, opts in OPTION_RUNS
            if structured or label not in STRUCTURED_ONLY]
    runs.append(("host mode", {}, "host"))
    if structured:
        runs.append(("presolve_pressure_iters=8",
                     dict(presolve_pressure_iters=8), "fused"))
    return runs


def phase_options(ctx):
    import tempfile
    from dataclasses import replace
    import torch
    from cfd2_tpu_torch import CoupledSolver
    from cfd2_tpu_torch.models.coupled import multi_step_adaptive

    check("main" in ctx, "phase 9 steps phase 3's developed state: run "
          "phase 3 with it")
    main = ctx["main"]
    s = main["solver"]
    base = s.config

    def restore(state=None, params=None, **opts):
        s.state = main["state"] if state is None else state
        s.params = main["params"] if params is None else params
        s.config = replace(base, **opts)
        s._krylov = None

    def run(label, n=1, mode="fused", step=None):
        rows, counts = _timed_steps(s, n, mode=mode, step=step)
        _log_run(label, rows, counts)
        check(counts["rbgs_leg"] > 0, f"{label}: rbgs_leg never launched")
        return rows

    log(f"phase 9: options on the developed {MAIN_CELLS}-cell state "
        f"(phase 3's timed steps: {main['timed']})")
    for label, opts in (("default", {}),) + OPTION_RUNS:
        restore(**opts)
        run(label)
    restore()
    for i, (outer, *_) in enumerate(run("host mode", 2, mode="host")):
        outer3 = main["timed"][i][0]
        check(abs(outer - outer3) <= 1, f"host-mode step {i}: {outer} "
              f"outer iterations, phase 3's timed step {i}: {outer3}")
    restore(fgmres_recycle=2)
    run("fgmres_recycle=2 (across steps)", 2)
    check(s._krylov is not None, "no Krylov basis crossed the steps")
    restore()

    def adaptive():
        s.state, s.params, _ = multi_step_adaptive(
            s.mesh, s.state, s.params, s.config, 1, min_cell_size=0.0017,
            amg=s._get_amg())

    run("multi_step_adaptive", 2, step=adaptive)
    log(f"phase 9: multi_step_adaptive dt {float(s.params.dt):.6g}, "
        f"dt_old {float(s.params.dt_old):.6g}")

    # Checkpoint round trip: a fresh solver (sharing the hierarchy, which
    # depends on the mesh alone) loaded from the file steps bit for bit as
    # the one that wrote it.
    restore()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        s.save_checkpoint(Path(tmp) / "ck.npz")
        fresh = CoupledSolver(s.host_mesh, config=s.config)
        fresh._amg = s._get_amg()
        fresh.load_checkpoint(Path(tmp) / "ck.npz")
    log(f"phase 9: checkpoint saved and loaded into a fresh solver in "
        f"{time.time() - t0:.1f} s")
    s.step()
    fresh.step()
    same = all(torch.equal(getattr(fresh.state, f), getattr(s.state, f))
               for f in ("u", "p", "outer_iters", "linear_iters_total"))
    log(f"phase 9: checkpoint step: outer_iters {int(s.state.outer_iters)} "
        f"/ {int(fresh.state.outer_iters)}, bit-equal {same}")
    check(same, "the solver loaded from the checkpoint stepped otherwise")
    del fresh

    # The presolve gate trips only far from the attractor: a from-rest
    # first step, with and without it.
    first = {}
    for iters in (0, 8):
        restore(*ctx["rest"], presolve_pressure_iters=iters)
        rows = run(f"from rest, presolve_pressure_iters={iters}")
        first[iters] = rows[0][1][0]
    log(f"phase 9: from-rest first outer's FGMRES iterations: "
        f"{first[0]} without the presolve, {first[8]} with it")
    restore()

    if "delaunay" in ctx:
        d = ctx["delaunay"]
        d.config = replace(d.config, fgmres_basis_bf16=True,
                           fgmres_recycle=1)
        rows, counts = _timed_steps(d, 1)
        _log_run("Delaunay fgmres_basis_bf16 + fgmres_recycle=1", rows,
                 counts)
        for name in ("banded_gather", "banded_dot", "banded_jacobi_sweeps"):
            check(counts[name] > 0, f"{name} never launched on the "
                  "Delaunay options step")
    else:
        log("phase 9: phase 6 did not run: no Delaunay options step")

    for make, structured in _small_solvers():
        kind = "cut-cell" if structured else "Delaunay"
        for label, opts, mode in _small_option_runs(structured):
            o_gpu, o_cpu, err, limit = _options_card_vs_cpu(
                make, f"{kind} {label}", opts, mode, structured)
            log(f"phase 9: {kind} ~5k cells, {label}: outer_iters card "
                f"{o_gpu} / cpu {o_cpu}, max|u_card - u_cpu| {err:.3e} "
                f"(limit {limit:.3e})")


# ----------------------------------------------------------------------
# Phase 10: the generic-mesh paths.


def _path_launches(results, path, counts):
    """Record one path's launches beside the kernels' main-path counts."""
    for name, cnt in counts.items():
        if name in results:
            results[name].setdefault("launches_by_path", {})[path] = cnt


def _refined(min_cell, max_cell):
    from cfd2_tpu_torch import generate_cut_cell_mesh
    return generate_cut_cell_mesh(_obstacle_geo(), min_cell, max_cell, 1.2,
                                  (3.0, 1.0))


def phase_multilevel(results, ctx):
    """10(a): the refined quadtree mesh on the multilevel layout."""
    import torch
    from cfd2_tpu_torch.ops.amg import MultilevelAmg

    h, h_max = MULTILEVEL_CELL
    t0 = time.time()
    mesh = _refined(h, h_max)
    log(f"phase 10a: refined mesh {h}/{h_max}: {mesh.num_cells} cells in "
        f"{time.time() - t0:.1f} s")
    check(mesh.num_cells == MULTILEVEL_CELLS,
          f"mesh has {mesh.num_cells} cells, expected {MULTILEVEL_CELLS}")
    t0 = time.time()
    s = _unstructured_solver(mesh, h, None)
    dm = s.mesh
    hier = s._get_amg()
    torch.cuda.synchronize()
    log(f"phase 10a: levels {dm.ml_levels}, N_dev {dm.num_cells}, K "
        f"{dm.max_faces}, banded {dm.banded}, hanging-face pairs "
        f"{dm.ml_pair_cell_a.numel()}; encode + hierarchy "
        f"{time.time() - t0:.1f} s; fine-grid multigrid "
        f"{[lvl.grid for lvl in hier.fine.levels]}")
    check(dm.multilevel and dm.banded and dm.ml_levels == MULTILEVEL_GRIDS,
          f"layout: multilevel {dm.multilevel}, banded {dm.banded}, "
          f"levels {dm.ml_levels}")
    check(isinstance(hier, MultilevelAmg), f"hierarchy {type(hier)}")
    check(not dm.banded_sweeps_fit(2) and dm.bd_k is None,
          "600,000 device cells lie above the JAX package's 12 MiB rule, on "
          "a map without a slot cap")
    _hold_on_solver_maps("10a", s, results)
    rest = (s.state, s.params)
    with _counting_mom_dots() as mom_dots:
        rows, counts = _timed_steps(s, 1)
        u_first = s.get_u()
        runs = [_timed_steps(s, 1)]
        _step2_input(s, ctx, "refined_132k_rest", "10a")
        runs.append(_timed_steps(s, 1))
    for more, more_counts in runs:
        rows += more
        counts = {k: counts[k] + more_counts[k] for k in counts}
    _log_run("multilevel", rows, counts, phase="10a")
    # Steps 0-1 are held to the JAX record; step 2 is logged beside it and
    # beside the JAX package's step from the card's own step-2 state, and a
    # miss is reported as known open at the end of the run: its solves end
    # at the float32 floor, and the card's slot sums round apart from the
    # reference's (ROADMAP Queue 3, open check 1).
    steps = [(o, sum(its)) for o, its, _, _ in rows]
    case = "refined_132k_rest"
    _beside_record("10a", case, steps[:2], enforce=True)
    for suffix in ("", "_from_card_step2"):
        missed = _beside_record("10a", case, steps[2:], first=2,
                                suffix=suffix)
        if missed:
            ctx.setdefault("known_open", []).append(
                f"phase 10a: {case} steps {missed} card "
                f"{[steps[i] for i in missed]} (outers, FGMRES iterations) "
                f"miss the bound of the JAX record jax{suffix} (ROADMAP "
                "Queue 3, open check 1)")
    lin_total = sum(sum(its) for _, its, _, _ in rows)
    per_apply = 2 * len(hier.fine.levels)
    for name in ("rbgs_leg", "banded_dot", "banded_gather"):
        check(counts[name] > 0, f"{name} was never launched on the "
              "multilevel path")
    check(counts["banded_jacobi_sweeps"] == 2 * lin_total,
          f"banded_jacobi_sweeps calls {counts['banded_jacobi_sweeps']} != "
          f"2 per preconditioner application x {lin_total} FGMRES "
          "iterations (a map without a slot cap takes the one call)")
    check(mom_dots[0] == 0, f"{mom_dots[0]} per-sweep momentum dots ran")
    check(counts["rbgs_leg"] == per_apply * lin_total,
          f"rbgs_leg launches {counts['rbgs_leg']} != {per_apply} per "
          f"V-cycle x {lin_total} FGMRES iterations")
    log(f"phase 10a: {lin_total} FGMRES iterations; per iteration "
        + ", ".join(f"{counts[k] / lin_total:.2f} {k}"
                    for k in ("rbgs_leg", "banded_dot", "banded_gather",
                              "banded_jacobi_sweeps"))
        + f"; per-sweep momentum dots {mom_dots[0]}")
    _path_launches(results, "multilevel (phase 10a)", counts)

    # The first step again from rest, with the momentum predict put back to
    # one mom2 dot per sweep (what the 12 MiB rule gave this mesh before).
    from cfd2_tpu_torch.ops import ellsys
    s.state, s.params = rest
    s._krylov = None
    one_call = ellsys._momentum_solve
    ellsys._momentum_solve = _per_sweep_momentum_solve
    try:
        with _counting_mom_dots() as mom_dots:
            loop_rows, loop_counts = _timed_steps(s, 1)
    finally:
        ellsys._momentum_solve = one_call
    _log_run("multilevel, per-sweep momentum dots", loop_rows, loop_counts,
             phase="10a")
    u_loop = s.get_u()
    rel = float(np.abs(u_loop - u_first).max() / np.abs(u_first).max())
    (o1, its1, w1, _), (o2, its2, w2, _) = rows[0], loop_rows[0]
    log(f"phase 10a: first step, one-call sweeps against per-sweep dots: "
        f"outer_iters {o1} / {o2}, FGMRES iterations {its1} / {its2}, wall "
        f"{w1:.4f} / {w2:.4f} s, banded_dot {counts['banded_dot']} over 3 "
        f"steps / {loop_counts['banded_dot']} over 1, per-sweep momentum "
        f"dots 0 / {mom_dots[0]}, max|du|/max|u| {rel:.3e}")
    check(mom_dots[0] > 0 and loop_counts["banded_jacobi_sweeps"] == 0,
          "the per-sweep step did not take the per-sweep dots")
    check((o1, its1) == (o2, its2), "the one-call sweeps changed the first "
          "step's iteration counts")


def _per_sweep_momentum_solve(es, mesh, r_u, r_v, sweeps):
    """ellsys._momentum_solve's per-sweep loop, at any size."""
    from cfd2_tpu_torch.ops import ellsys
    z_u, z_v = es.diag_u_inv * r_u, es.diag_u_inv * r_v
    for _ in range(sweeps - 1):
        su, sv = ellsys._mom_dot2(es, mesh, z_u, z_v)
        z_u = es.diag_u_inv * (r_u - su)
        z_v = es.diag_u_inv * (r_v - sv)
    return z_u, z_v


@contextlib.contextmanager
def _counting_calls(module, name):
    """Counts the calls of ``module.name`` (``module`` imported by its
    dotted name) while entered, in the one-element list it yields."""
    import importlib
    mod = importlib.import_module(module)
    orig, n = getattr(mod, name), [0]

    def counted(*a, **k):
        n[0] += 1
        return orig(*a, **k)

    setattr(mod, name, counted)
    try:
        yield n
    finally:
        setattr(mod, name, orig)


def _counting_mom_dots():
    """Counts the per-sweep momentum dots (ellsys._mom_dot2)."""
    return _counting_calls("cfd2_tpu_torch.ops.ellsys", "_mom_dot2")


def _counting_matvecs():
    """Counts the structured solves' matvecs (the FGMRES iterations' and
    the true residuals'), apart from the kernel's own launch count."""
    return _counting_calls("cfd2_tpu_torch.ops.stencil_system",
                           "spmv_planar")


def phase_block(results, ctx):
    """10(b): block-Jacobi at full width on phase 3's developed state and
    on phase 6's Delaunay solver."""
    from dataclasses import replace

    runs = []
    if "main" in ctx:
        main = ctx["main"]
        runs.append(("developed 1M", main["solver"], main["state"],
                     main["params"], ()))
    else:
        log("phase 10b: phase 3 did not run: no block-Jacobi step at 1M")
    if "delaunay" in ctx:
        d = ctx["delaunay"]
        runs.append(("Delaunay 403k", d, d.state, d.params,
                     ("banded_gather",)))
    else:
        log("phase 10b: phase 6 did not run: no Delaunay block-Jacobi step")
    for label, s, state, params, kernels in runs:
        base = s.config
        s.state, s.params, s._krylov = state, params, None
        # One restart cycle (50 iterations) an outer: neither step
        # converges at full width within 5 either, and the launches are
        # what is checked.
        s.config = replace(base, precond_type=2, fgmres_max_restarts=1,
                           fgmres_basis_bf16=False, fgmres_recycle=0)
        try:
            rows, counts = _timed_steps(s, 1)
        finally:
            s.config = base
            s.state, s.params = state, params
        _log_run(f"{label} block-Jacobi", rows, counts, phase="10b")
        for name in kernels:
            check(counts[name] > 0, f"{name} was never launched on the "
                  f"{label} block path")
        if kernels:
            _path_launches(results, f"{label} block-Jacobi (phase 10b)",
                           {k: counts[k] for k in kernels})


def _unbanded(s, mesh, min_cell):
    """``s`` on its mesh with the banded map removed (the block path of a
    generic mesh without one), restarted from the inlet column."""
    from dataclasses import replace
    from cfd2_tpu_torch.runtime.state import initial_state
    s.mesh = replace(s.mesh, banded=False, bd_k=None)
    s.state = initial_state(s.mesh)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < min_cell * 2, 0] = 1.0
    s.set_u(u0)
    return s


def _generic_runs():
    """The 10(c) cases: (label, make(device), kernels the card must
    launch, block-Jacobi)."""
    from dataclasses import replace
    from cfd2_tpu_torch import generate_delaunay_mesh
    refined = _refined(0.01, 0.04)
    channel = _channel(0.025)
    tiny = _channel(0.2)
    delaunay = generate_delaunay_mesh(_obstacle_geo(), 0.025, 0.025, 1.2,
                                      (3.0, 1.0))

    def cut(mesh, h, precond):
        def make(dev):
            s = _solver(mesh, h, dev)
            s.config = replace(s.config, precond_type=precond)
            return s
        return make

    return (
        (f"multilevel 0.01/0.04 ({refined.num_cells} cells) AMG",
         lambda dev: _unstructured_solver(refined, 0.01, dev),
         ("rbgs_leg", "banded_gather", "banded_dot", "banded_jacobi_sweeps"),
         False),
        (f"cut-cell ({channel.num_cells} cells) block-Jacobi",
         cut(channel, 0.025, 2), (), True),
        (f"cut-cell ({channel.num_cells} cells) Chebyshev",
         cut(channel, 0.025, 0), (), False),
        (f"Delaunay without banded map ({delaunay.num_cells} cells) AMG",
         lambda dev: _unbanded(_unstructured_solver(delaunay, 0.025, dev),
                               delaunay, 0.025),
         ("banded_gather", "banded_dot"), False),
        (f"channel 0.2 ({tiny.num_cells} cells, no structured multigrid) "
         "AMG", cut(tiny, 0.2, 1), (), False),
    ), channel


def _generic_card_vs_cpu(label, make, kernels, block_jacobi):
    """One step of ``make(device)`` on the card and on the CPU: equal outer
    counts (block-Jacobi may exit one outer later on an unchanged state:
    the later exit's last solve then took 0 iterations), u within
    1e-4 * max|u|, ``kernels`` launched on the card."""
    runs = {}
    for dev in ("cuda", "cpu"):
        s = make(dev)
        if dev == "cuda":
            rows, counts = _timed_steps(s, 1)
            _log_run(label, rows, counts, phase="10c")
        else:
            s.step()
        runs[dev] = (int(s.state.outer_iters), int(s.state.linear_iters),
                     s.get_u())
    (o_gpu, l_gpu, u_gpu), (o_cpu, l_cpu, u_cpu) = runs["cuda"], runs["cpu"]
    limit = 1e-4 * float(np.abs(u_cpu).max())
    err = float(np.abs(u_gpu - u_cpu).max())
    log(f"phase 10c: {label}: outer_iters card {o_gpu} / cpu {o_cpu}, "
        f"max|u_card - u_cpu| {err:.3e} (limit {limit:.3e})")
    for name in kernels:
        check(counts[name] > 0, f"{label}: {name} never launched")
    noop = block_jacobi and abs(o_gpu - o_cpu) == 1 and (
        l_gpu if o_gpu > o_cpu else l_cpu) == 0
    check(o_gpu == o_cpu or noop,
          f"{label}: outer iterations card {o_gpu}, cpu {o_cpu}")
    check(np.isfinite(u_gpu).all() and err <= limit,
          f"{label}: card and CPU velocities disagree")


def _simple_card_vs_cpu(channel):
    """One SIMPLE step of the cut-cell channel on the card and on the CPU:
    equal corrector counts, u within 1e-4 * max|u|."""
    from cfd2_tpu_torch.models.pressure_poisson import simple_step
    out = {}
    for dev in ("cuda", "cpu"):
        s = _solver(channel, 0.025, dev)
        t0 = time.perf_counter()
        st = simple_step(s.mesh, s.state, s.params, s.config)
        out[dev] = (int(st.outer_iters), int(st.linear_iters_total),
                    s.mesh.to_host_order(st.u).cpu().numpy(),
                    time.perf_counter() - t0)
    (o_gpu, l_gpu, u_gpu, w_gpu), (o_cpu, l_cpu, u_cpu, _) = (out["cuda"],
                                                              out["cpu"])
    limit = 1e-4 * float(np.abs(u_cpu).max())
    err = float(np.abs(u_gpu - u_cpu).max())
    log(f"phase 10c: SIMPLE step ({channel.num_cells} cells): correctors "
        f"{o_gpu} / {o_cpu}, Krylov iterations card {l_gpu} / cpu {l_cpu}, "
        f"wall on the card {w_gpu:.4f} s, max|u_card - u_cpu| {err:.3e} "
        f"(limit {limit:.3e})")
    check(o_gpu == o_cpu, "SIMPLE corrector counts differ")
    check(np.isfinite(u_gpu).all() and err <= limit,
          "SIMPLE step: card and CPU velocities disagree")


def phase_generic_cpu_match():
    """10(c): the generic-mesh paths on the card against the CPU."""
    cases, channel = _generic_runs()
    for case in cases:
        _generic_card_vs_cpu(*case)
    _simple_card_vs_cpu(channel)


def phase_generic(results, ctx):
    for part, fn in (("a", lambda: phase_multilevel(results, ctx)),
                     ("b", lambda: phase_block(results, ctx)),
                     ("c", phase_generic_cpu_match)):
        t0 = time.time()
        fn()
        log(f"# phase 10{part} done in {time.time() - t0:.1f} s")


# ----------------------------------------------------------------------
# Phase 11: the application layer.


def _start_app(args):
    """``python -m cfd2_tpu_torch.app --device cuda ARGS`` started as a
    subprocess of this checkout (it reuses phase 1's kernel build), its
    output going to temporary files: (process, stdout, stderr, start)."""
    import tempfile
    cmd = [sys.executable, "-m", "cfd2_tpu_torch.app", "--device", "cuda",
           *args]
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    return (subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err),
            out, err, time.time())


def _stop_app(app):
    proc, out, err, _ = app
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    out.close()
    err.close()


def _run_app(label, app, timeout=600):
    """The app ``app`` of :func:`_start_app` run to its end; returns its
    parsed output: the mesh and layout lines, one dict per step line, the
    kernel launches, host reads, the final-state line and the profiling
    report."""
    import re
    proc, out, err, t0 = app
    proc.wait(timeout=max(timeout - (time.time() - t0), 1))
    wall = time.time() - t0
    out.seek(0)
    err.seek(0)
    text, stderr = out.read(), err.read()
    check(proc.returncode == 0,
          f"{label}: the app exited {proc.returncode}:\n"
          f"{text[-3000:]}\n{stderr[-3000:]}")
    num = r"([-+0-9.eE]+|nan|inf)"
    steps = []
    for m in re.finditer(
            rf"^step (\d+): t={num} dt={num} outer=(\d+)"
            rf"(?: Cd={num} Cl={num})? fgmres=(\d+) wall={num}s "
            rf"host_reads=(\d+)$", text, re.M):
        i, t, dt, outer, cd, cl, lin, w, reads = m.groups()
        steps.append(dict(step=int(i), t=float(t), dt=float(dt),
                          outer=int(outer), lin=int(lin), wall=float(w),
                          reads=int(reads),
                          cd=None if cd is None else float(cd),
                          cl=None if cl is None else float(cl)))
    get = lambda pat: re.search(pat, text, re.M)
    mesh, layout = get(r"^mesh: (\d+) cells"), get(r"layout: (.+) \(")
    launches, reads = get(r"^kernel launches: (.+)$"), \
        get(r"^host reads: (\d+)$")
    final = get(r"^final state: .* finite=(True|False)$")
    check(all((mesh, layout, launches, reads, final)) and steps,
          f"{label}: unexpected app output:\n{text[-3000:]}")
    report = text[text.index("=== Profiling Report ==="):].splitlines()
    return dict(cells=int(mesh.group(1)), layout=layout.group(1),
                steps=steps, launches=json.loads(launches.group(1)),
                reads=int(reads.group(1)), final=final.group(0),
                finite=final.group(1) == "True", report=report, wall=wall,
                stderr=stderr)


def _log_app(part, label, run):
    log(f"phase 11{part}: {label}: {run['cells']} cells, layout "
        f"{run['layout']}, subprocess wall {run['wall']:.1f} s")
    for st in run["steps"]:
        forces = ("" if st["cd"] is None else
                  f", Cd {st['cd']:.3f}, Cl {st['cl']:+.3f}")
        log(f"phase 11{part}: step {st['step']}: dt {st['dt']:.4e}, outers "
            f"{st['outer']}, FGMRES iterations {st['lin']}, wall "
            f"{st['wall']:.4f} s, host reads {st['reads']}{forces}")
    log(f"phase 11{part}: launches {run['launches']}, host reads "
        f"{run['reads']}; {run['final']}")
    top = [ln for ln in run["report"] if ln.strip()][:9]
    log(f"phase 11{part}: profiling report (top lines):\n  "
        + "\n  ".join(top))


def phase_app_main(results, app):
    """11(a): the app at full width: the 996,558-cell channel smoothed as
    the app smooths it, from the app's inlet-column start, AMG."""
    run = _run_app("app", app)
    _log_app("a", "the app at full width", run)
    grids, _ = level_grids(*MAIN_GRID)
    check(run["cells"] == MAIN_CELLS, f"app mesh has {run['cells']} cells")
    check(run["layout"] == f"structured {MAIN_GRID[0]}x{MAIN_GRID[1]}",
          f"the app's mesh took the {run['layout']} layout")
    check(len(run["steps"]) == 5, f"{len(run['steps'])} step lines")
    check(run["finite"], "non-finite fields after the app's steps")
    check(all(np.isfinite([st["cd"], st["cl"]]).all()
              for st in run["steps"]), "non-finite Cd/Cl")
    lin = sum(st["lin"] for st in run["steps"])
    leg = run["launches"]["rbgs_leg"]
    per_apply = 2 * len(grids)
    check(leg > 0, "rbgs_leg was never launched on the app's path")
    check(leg == per_apply * lin,
          f"rbgs_leg launches {leg} != {per_apply} per V-cycle x {lin} "
          "FGMRES iterations")
    _path_launches(results, "app (phase 11)",
                   {k: v for k, v in run["launches"].items() if v})
    log(f"phase 11a: rbgs_leg launches {leg} = {per_apply} per V-cycle x "
        f"{lin} FGMRES iterations")


def phase_app_trace():
    """11(b): one app step inside ``ProfilingStats.trace``; the Chrome
    trace must name the rbgs_leg kernel."""
    import tempfile
    import torch
    from cfd2_tpu_torch.app import Simulation
    sim = Simulation(geometry="channel", cell_size=0.01, precond=1)
    check(sim.solver.mesh.structured, "the 0.01 app mesh is not structured")
    sim.run(1)                                   # warm-up
    with tempfile.TemporaryDirectory() as logdir:
        t0 = time.perf_counter()
        with sim.profiling.trace(logdir):
            sim.run(1)
        wall = time.perf_counter() - t0
        path = Path(logdir) / "trace.json"
        size = path.stat().st_size
        trace = json.loads(path.read_text())
    kernels = [e["name"] for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    legs = [k for k in kernels if "rbgs_leg" in k]
    log(f"phase 11b: one app step of {sim.mesh.num_cells} cells traced in "
        f"{wall:.2f} s: trace.json {size} bytes, {len(kernels)} device "
        f"kernel events, {len(legs)} of rbgs_leg ({sorted(set(legs))}); "
        f"{int(sim.solver.state.linear_iters_total)} FGMRES iterations")
    check(legs, "the trace names no rbgs_leg kernel")
    torch.cuda.synchronize()


def _developed(ctx):
    """Phase 3's solver with its state after healing, or (phase 3 not run)
    a fresh one loaded with the developed state."""
    if "main" in ctx:
        m = ctx["main"]
        return m["solver"], m["state"], m["params"]
    from cfd2_tpu_torch.convert import load_developed_state
    s = _solver(_channel(0.0017), 0.0017, None)
    load_developed_state(s, ROOT / "bench_developed_1m.npz")
    return s, s.state, s.params


def _forces_f64(dm, state, params, mask, u_ref, d_ref):
    """body_force's formula in float64 numpy from the same tensors, copied
    to the host: the reference for the card's (Cd, Cl)."""
    g = lambda t: t.detach().cpu().numpy().astype(np.float64)
    own = dm.f_owner.cpu().numpy().astype(np.int64)
    w = np.asarray(mask, np.float64)
    nx, ny, A = g(dm.f_nx), g(dm.f_ny), g(dm.f_area)
    dx = g(dm.f_cx) - g(dm.c_cx)[own]
    dy = g(dm.f_cy) - g(dm.c_cy)[own]
    gp = g(state.grad_p)[own]
    p_f = g(state.p)[own] + gp[:, 0] * dx + gp[:, 1] * dy
    u = g(state.u)[own]
    un = u[:, 0] * nx + u[:, 1] * ny
    d = np.maximum(np.abs(dx * nx + dy * ny), 1e-12)
    mu, rho = float(params.viscosity), float(params.density)
    fx = np.sum(w * p_f * nx * A) + np.sum(w * mu * (u[:, 0] - un * nx)
                                           / d * A)
    fy = np.sum(w * p_f * ny * A) + np.sum(w * mu * (u[:, 1] - un * ny)
                                           / d * A)
    q = 0.5 * rho * u_ref ** 2 * d_ref
    return fx / q, fy / q


def phase_app_forces(ctx):
    """11(c): Cd/Cl of the developed 1M state on the card against the same
    formula in float64 on the host: each within 1e-4 relative."""
    import torch
    from cfd2_tpu_torch.utils.forces import force_coefficients, \
        obstacle_face_mask
    s, state, params = _developed(ctx)
    mask = obstacle_face_mask(s.mesh)
    t0 = time.perf_counter()
    cd, cl = force_coefficients(s.mesh, state, params, mask, u_ref=1.0,
                                d_ref=0.4)
    card = torch.stack([cd, cl]).cpu().numpy().astype(np.float64)
    wall = time.perf_counter() - t0
    host = np.array(_forces_f64(s.mesh, state, params, mask, 1.0, 0.4))
    err = float(np.abs(card - host).max())
    limit = 1e-4 * float(np.abs(host).min())
    log(f"phase 11c: developed {MAIN_CELLS}-cell state, {int(mask.sum())} "
        f"obstacle faces: card Cd {card[0]:.7f} Cl {card[1]:+.7f} "
        f"({wall * 1e3:.2f} ms with the mask upload and the read), host "
        f"float64 Cd {host[0]:.7f} Cl {host[1]:+.7f}, max|diff| {err:.3e} "
        f"(limit {limit:.3e})")
    check(np.isfinite(card).all() and err <= limit,
          "card and host force coefficients disagree")
    if ctx.get("export_forces"):
        _export_forces(ctx["export_forces"], s.mesh, state, params, mask,
                       card)


def _export_forces(path, dm, state, params, mask, card):
    """What body_force reads, for a reading by the JAX package: the obstacle
    mask's four face tensors in full, and the wall faces (the only faces a
    mask can select) with their owner cells' geometry and fields."""
    from cfd2_tpu_torch.mesh.structs import BOUNDARY_WALL
    g = lambda t: t.detach().cpu().numpy()
    fb = g(dm.f_boundary)
    wall = np.flatnonzero(fb == BOUNDARY_WALL)
    own = g(dm.f_owner)[wall]
    cells, own_c = np.unique(own, return_inverse=True)
    pick = lambda t: g(t)[cells]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, f_boundary=fb.astype(np.int8), f_cx=g(dm.f_cx),
        f_cy=g(dm.f_cy), f_area=g(dm.f_area), wall=wall,
        wall_owner=own_c, wall_nx=g(dm.f_nx)[wall],
        wall_ny=g(dm.f_ny)[wall], cell_ids=cells, c_cx=pick(dm.c_cx),
        c_cy=pick(dm.c_cy), c_vol=pick(dm.c_vol), u=pick(state.u),
        p=pick(state.p), grad_p=pick(state.grad_p),
        viscosity=g(params.viscosity), density=g(params.density),
        port_mask_faces=np.flatnonzero(mask), port_cd_cl=card)
    log(f"phase 11c: wrote {path} ({path.stat().st_size / 2**20:.1f} MiB; "
        f"{len(wall)} wall faces, {len(cells)} owner cells)")


def phase_app_sweep(ctx):
    """11(d): sweep_step over two viscosities on the developed 1M state;
    each case equals a single step of that case (same outers, u within
    1e-6)."""
    from dataclasses import fields, replace
    import torch
    from cfd2_tpu_torch.models.coupled import step
    from cfd2_tpu_torch.ops import banded_kernels as bk
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.parallel.batch import (batched_params, shard_batch,
                                               sweep_step)
    from cfd2_tpu_torch.runtime.state import SolverState
    s, state, params = _developed(ctx)
    amg = s._get_amg()
    B = len(SWEEP_VISCOSITIES)
    bstate = SolverState(**{f.name: torch.stack([getattr(state, f.name)] * B)
                            for f in fields(SolverState)})
    bstate = shard_batch(bstate, [s.device])
    bparams = batched_params(params, {"viscosity": SWEEP_VISCOSITIES})
    sk.reset_launches()
    bk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep_step(s.mesh, bstate, bparams, s.config, amg=amg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    leg = sk.LAUNCHES["rbgs_leg"]
    for i, nu in enumerate(SWEEP_VISCOSITIES):
        ref = step(s.mesh, state, replace(params, viscosity=torch.tensor(
            nu, dtype=torch.float32, device=s.device)), s.config, amg)
        err = float((out.u[i] - ref.u).abs().max())
        o_b, o_s = int(out.outer_iters[i]), int(ref.outer_iters)
        log(f"phase 11d: viscosity {nu}: batched case outers {o_b}, FGMRES "
            f"iterations {int(out.linear_iters_total[i])}; single step "
            f"outers {o_s}, FGMRES iterations "
            f"{int(ref.linear_iters_total)}; max|du| {err:.3e}")
        check(o_b == o_s, f"viscosity {nu}: batched case {o_b} outers, "
              f"single step {o_s}")
        check(err <= 1e-6 and bool(torch.isfinite(out.u[i]).all()),
              f"viscosity {nu}: batched case and single step differ by "
              f"{err:.3e}")
    log(f"phase 11d: sweep_step of {B} cases in {wall:.3f} s, rbgs_leg "
        f"launches {leg}")
    check(leg > 0, "the sweep launched no rbgs_leg")
    check(float((out.u[0] - out.u[1]).abs().max()) > 0,
          "the two viscosities gave the same field")


def phase_app_delaunay(results, app):
    """11(e): the app on a Delaunay mesh: the three banded kernels."""
    run = _run_app("app on a Delaunay mesh", app)
    _log_app("e", "the app on a Delaunay mesh", run)
    check(run["layout"] == "generic (banded)",
          f"the Delaunay app mesh took the {run['layout']} layout")
    check(run["finite"], "non-finite fields after the Delaunay app steps")
    for name in ("banded_gather", "banded_dot", "banded_jacobi_sweeps"):
        check(run["launches"][name] > 0,
              f"{name} never launched on the Delaunay app path")
    _path_launches(results, "app Delaunay (phase 11e)",
                   {k: v for k, v in run["launches"].items() if v})


def phase_app_live():
    """11(f): the live server on a small mesh: the step advances, pause
    freezes it; a frame only where matplotlib imports."""
    import importlib.util
    import urllib.request
    from cfd2_tpu_torch.app import Simulation
    from cfd2_tpu_torch.viz.live_server import LiveServer

    def get(url):
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.read()

    def status():
        return json.loads(get(base + "status"))

    sim = Simulation(geometry="channel", cell_size=0.02, precond=1)
    server = LiveServer(sim, port=0).start()
    base = server.url
    try:
        deadline, st = time.time() + 60, status()
        while st["step"] < 3 and time.time() < deadline:
            time.sleep(0.2)
            st = status()
        check(st["step"] >= 3, f"the live solver did not advance: {st}")
        get(base + "control?pause")
        time.sleep(0.5)
        s1 = status()
        time.sleep(1.0)
        s2 = status()
        check(s1["paused"] and s2["step"] == s1["step"],
              f"pause did not freeze the step: {s1['step']} -> "
              f"{s2['step']}")
        if importlib.util.find_spec("matplotlib") is None:
            frame = "matplotlib does not import here: no frame fetched"
        else:
            png = get(base + "frame.png")
            check(png[:4] == b"\x89PNG", "the frame is not a PNG")
            frame = f"frame.png {len(png)} bytes"
        log(f"phase 11f: live server on {sim.mesh.num_cells} cells: step "
            f"{st['step']} (t={st['time']:.4f}, outers "
            f"{st['outer_iters']}, Cd {st['cd']}) then paused at "
            f"{s1['step']} = {s2['step']} a second later; {frame}")
    finally:
        server.stop()
    check(not server.worker.is_alive(), "the live solver thread still runs")


def phase_app(results, ctx):
    # The two app runs of (a) and (e) start together, beside the in-process
    # parts: their walls are logged and compared with nothing.
    apps = {"a": _start_app(APP_MAIN), "e": _start_app(APP_DELAUNAY)}
    try:
        for part, fn in (("a", lambda: phase_app_main(results, apps["a"])),
                         ("b", phase_app_trace),
                         ("c", lambda: phase_app_forces(ctx)),
                         ("d", lambda: phase_app_sweep(ctx)),
                         ("e", lambda: phase_app_delaunay(results,
                                                          apps["e"])),
                         ("f", phase_app_live)):
            t0 = time.time()
            fn()
            log(f"# phase 11{part} done in {time.time() - t0:.1f} s")
    finally:
        for app in apps.values():
            _stop_app(app)


# ----------------------------------------------------------------------
# Phase 12: the row-sharded paths.  The rank functions live at module level:
# the spawned ranks import this script by its path and look them up by name.


def _moved(tree, device):
    """``tree`` (a dataclass, tuple, list or dict of tensors, nested) with
    every tensor on ``device``."""
    import dataclasses
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _moved(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)
            if getattr(tree, f.name) is not None and f.name != "amg_host"})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_moved(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    return tree


def _timed(fn):
    """``fn()`` with the launch, exchange and read counts zeroed just
    before and read just after: (result, wall s, rbgs_leg launches,
    banded_dot launches, exchange and collective counts, host reads)."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.parallel import spatial as sp
    from cfd2_tpu_torch.runtime import host_reads
    sk.reset_launches()
    bk.reset_launches()
    sp.reset_counts()
    host_reads.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t, sk.LAUNCHES["rbgs_leg"],
            bk.LAUNCHES["banded_dot"], dict(sp.COUNT),
            host_reads.COUNT["reads"])


def _option_steps(mesh, state, params, config, amg, opts, steps,
                  pallas=None, simple=False):
    """``steps`` steps of ``config`` with ``opts`` from ``state`` (one
    process or one rank alike): fgmres_recycle >= 2 carries the Krylov
    basis through ``step(..., krylov=)``, ``pallas`` sets CFD2_PALLAS for
    these steps only, ``simple`` steps ``simple_step``; the hierarchy goes
    to precond_type=1 only.  Returns (state, outers, FGMRES iterations per
    step)."""
    from dataclasses import replace
    from cfd2_tpu_torch.models.coupled import _basis_init, step
    from cfd2_tpu_torch.models.pressure_poisson import simple_step
    cfg = replace(config, **opts)
    a = amg if cfg.precond_type == 1 else None
    outer, lin = [], []

    def run():
        kry = (_basis_init(mesh, state, cfg, a) if cfg.fgmres_recycle >= 2
               else None)
        s = state
        for _ in range(steps):
            if simple:
                s = simple_step(mesh, s, params, cfg)
            elif kry is not None:
                s, kry = step(mesh, s, params, cfg, a, kry)
            else:
                s = step(mesh, s, params, cfg, a)
            outer.append(int(s.outer_iters))
            lin.append(int(s.linear_iters_total))
        return s

    return _at_level(pallas, run), outer, lin


def _full_width_operators(mesh, state, params, config, amg, decomp=None):
    """The operators the options put on the sharded path, applied once to
    the same random planes (made from a seed on the whole grid; a rank
    takes its rows) of the start state's assembled system: the Schur
    preconditioner with the ADI predict, and the V-cycle under CFD2_PALLAS
    unset and 1.  Host arrays of this process's rows: the ranks' must be
    one process's bits (no sum is involved)."""
    import torch
    from cfd2_tpu_torch.models.assembly import assemble_stencil, prepare
    from cfd2_tpu_torch.ops import stencil_system as st
    ss = assemble_stencil(mesh, prepare(mesh, state, params, config), params,
                          config)
    g = torch.Generator(device="cpu").manual_seed(9)
    ny = mesh.grid_shape[0] * (1 if decomp is None else decomp.world)
    x = torch.randn((3, ny, mesh.grid_shape[1]), generator=g)
    if decomp is not None:
        x = decomp.own_rows(x, dim=1)
    x = x.to(mesh.device).contiguous()
    out = {}
    for label, pallas, adi in (("ADI preconditioner", None, 1),
                               ("V-cycle", None, 0),
                               ("V-cycle, CFD2_PALLAS=1", "1", 0)):
        def apply():
            ps = st.make_pressure_solve2(amg, ss)
            if not adi:
                return ps(x[2])
            return st.schur_precond_planar(
                ss, x, config.precond_omega,
                config.pressure_sweeps(mesh.total_cells), pressure_solve=ps,
                mom_adi=adi)
        out[label] = _at_level(pallas, apply).cpu().numpy()
    return out


def _at_level(pallas, fn):
    """``fn()`` with CFD2_PALLAS set to ``pallas`` (None: as it is),
    restored after."""
    import os
    old = os.environ.get("CFD2_PALLAS")
    if pallas is not None:
        os.environ["CFD2_PALLAS"] = pallas
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("CFD2_PALLAS", None)
        else:
            os.environ["CFD2_PALLAS"] = old


def _timed_option(mesh, state, params, config, amg, opts, steps, pallas):
    """:func:`_option_steps` under :func:`_timed`'s zeroed counts, as host
    data: u, outers and FGMRES iterations per step, wall, both RB-GS
    kernels' launches, the exchange and collective counts."""
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    (s, outer, lin), wall, leg, _, counts, _ = _timed(
        lambda: _option_steps(mesh, state, params, config, amg, opts, steps,
                              pallas))
    return dict(u=s.u.cpu().numpy(), outer=outer, lin=lin, wall=wall,
                leg=leg, half=sk.LAUNCHES["rbgs_half_sweep"],
                resid=sk.LAUNCHES["rbgs_residual"], counts=counts)


def _p12_rank(rank, world, device, path):
    """12(a, c, d) on one rank: the padded 1M mesh's rows of this rank, one
    step and two adaptive steps, the distributed checkpoint of the stepped
    state, and this rank's case of the viscosity sweep."""
    import pickle
    from dataclasses import replace
    import torch
    from cfd2_tpu_torch.models.coupled import multi_step_adaptive, step
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.ops.amg import split_level
    from cfd2_tpu_torch.parallel import spatial as sp
    from cfd2_tpu_torch.parallel.batch import (batched_params, gather_batch,
                                               shard_batch, sweep_step)
    from cfd2_tpu_torch.runtime.checkpoint import (save_checkpoint,
                                                   save_checkpoint_dcp)
    from cfd2_tpu_torch.runtime.state import SolverState
    # The ranks start while this script's own process may hold
    # CFD2_PALLAS=1 for one of its references: each run sets its own.
    os.environ.pop("CFD2_PALLAS", None)
    with open(path / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    dm, amg, state0, params, config = (inp[k] for k in (
        "mesh", "amg", "state", "params", "config"))
    ny, nx = dm.grid_shape
    decomp = sp.RowDecomposition(ny, nx, transport="gloo", device=device)
    mesh = sp.shard_mesh(dm, decomp)
    state = sp.shard_state(dm, state0, decomp)
    amg_r = sp.shard_cellwise(amg, dm.num_cells, decomp)
    params_r = sp.shard_cellwise(params, dm.num_cells, decomp)
    out = dict(transport=decomp.describe(), rows=(decomp.r0, decomp.r1),
               split=split_level(amg, decomp))

    s1, wall, leg, _, counts, reads = _timed(
        lambda: step(mesh, state, params_r, config, amg_r))
    out["step"] = dict(u=s1.u.cpu().numpy(), outer=int(s1.outer_iters),
                       lin=int(s1.linear_iters_total), wall=wall, leg=leg,
                       counts=counts, reads=reads,
                       launches=dict(sk.LAUNCHES))
    for kind, dt0 in (("adaptive", None), ("adaptive, dt capped", 1e-4)):
        p0 = params_r if dt0 is None else replace(
            params_r, dt=torch.full_like(params_r.dt, dt0))
        (s2, _, m2), wall, leg, _, counts, reads = _timed(
            lambda: multi_step_adaptive(mesh, state, p0, config, 2, 0.5,
                                        0.0017, amg_r))
        out[kind] = dict(u=s2.u.cpu().numpy(), dt=m2["dt"].cpu().numpy(),
                         max_vel=m2["max_vel"].cpu().numpy(),
                         outer=m2["outer_iters"].cpu().numpy(),
                         wall=wall, leg=leg, counts=counts, reads=reads)

    # 12(f): every option from the same start, in this group (the mesh is
    # loaded once).
    out["options"] = {
        label: _timed_option(mesh, state, params_r, config, amg_r, opts,
                             steps, pallas)
        for label, opts, steps, pallas in SHARD_OPTION_RUNS}
    out["operators"] = _full_width_operators(mesh, state, params_r, config,
                                             amg_r, decomp)

    t = time.perf_counter()
    save_checkpoint_dcp(path / "ck", s1, params_r, decomp)
    whole = sp.gather_cellwise(s1, decomp)
    if rank == 0:
        save_checkpoint(path / "gathered.npz", whole, params_r)
    out["checkpoint_s"] = time.perf_counter() - t

    # 12(c): the cases of a viscosity sweep over the ranks, one each, each
    # stepped with the rank's own copy of the whole mesh.
    cases = sp.RowDecomposition(world, 1, transport="gloo", device=device)
    dmd, amgd = _moved(dm, device), _moved(amg, device)
    s0 = _moved(state0, device)
    bstate = SolverState(**{k: torch.stack([v] * world)
                            for k, v in vars(s0).items()})
    bparams = batched_params(_moved(params, device),
                             {"viscosity": SHARD_VISCOSITIES})
    mine = shard_batch(bstate, cases)
    (sw, wall, leg, _, _, _) = _timed(lambda: sweep_step(
        dmd, mine, shard_batch(bparams, cases), config, amgd))
    both = gather_batch(sw, cases)
    out["sweep"] = dict(u=both.u.cpu().numpy() if rank == 0 else None,
                        outer=both.outer_iters.cpu().numpy(),
                        lin=both.linear_iters_total.cpu().numpy(),
                        local=mine.u.shape[0], wall=wall, leg=leg)
    return out


def _p12_banded_rank(rank, world, device, path):
    """12(b) on one rank: its range of the Delaunay mesh's cells."""
    import pickle
    import torch
    from cfd2_tpu_torch.ops.fgmres import fgmres_solve
    from cfd2_tpu_torch.parallel import spatial as sp
    with open(path / "banded.pkl", "rb") as f:
        inp = pickle.load(f)
    nb, es, x, b, halo = (inp[k] for k in ("mesh", "es", "x", "b", "halo"))
    N = nb.num_cells
    decomp = sp.RowDecomposition(N, 1, transport="gloo", device=device)
    es_r = sp.shard_cellwise(es, N, decomp)
    loc = sp.local_banded_map(nb, decomp, halo)
    own = lambda v: v[:, decomp.cells].to(device).contiguous()
    mv = lambda v: sp.banded_spmv_sharded(es_r, loc, v, decomp, halo)
    y, wall_mv, _, dots_mv, _, _ = _timed(lambda: mv(own(x)))
    dinv = torch.stack([es_r.diag_u_inv, es_r.diag_u_inv, es_r.diag_p_inv])
    res, wall, _, dots, counts, reads = _timed(lambda: fgmres_solve(
        mv, lambda r: r * dinv, own(b), torch.zeros_like(own(b)),
        restart=20, max_restarts=3, tol=1e-5, reduce=decomp.all_reduce_sum))
    return dict(y=y.cpu().numpy(), cells=(decomp.cells.start,
                                          decomp.cells.stop),
                finite=bool(torch.isfinite(res.x).all()),
                iterations=res.iterations, dots=dots_mv + dots,
                wall_mv=wall_mv, wall=wall, counts=counts, reads=reads,
                transport=decomp.describe())


def _p12_small_rank(rank, world, device, host_mesh, u0):
    """12(e) and (g) on one rank: one step of the 4,636-cell mesh,
    row-sharded, and every option of (f) and one ``simple_step`` from the
    same start (outers and FGMRES iterations per step of each)."""
    from cfd2_tpu_torch.models.coupled import step
    from cfd2_tpu_torch.ops.amg import build_hierarchy_for_mesh
    from cfd2_tpu_torch.parallel import spatial as sp
    from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
    from cfd2_tpu_torch.runtime.state import (SolverConfig, SolverParams,
                                              initial_state)
    dm = encode_mesh(host_mesh, device="cpu", pad_rows_to=world)
    amg = build_hierarchy_for_mesh(dm)
    ny, nx = dm.grid_shape
    decomp = sp.RowDecomposition(ny, nx, transport="gloo", device=device)
    mesh = sp.shard_mesh(dm, decomp)
    state = sp.shard_state(dm, initial_state(dm, u0=u0), decomp)
    params = SolverParams.default(dt=0.001, device=device)
    config = SolverConfig(precond_type=1)
    amg = sp.shard_cellwise(amg, dm.num_cells, decomp)
    out = step(mesh, state, params, config, amg)
    options = {}
    for label, opts, steps, pallas in SHARD_OPTION_RUNS + (
            ("simple_step", {}, 1, None),):
        _, outer, lin = _option_steps(mesh, state, params, config, amg, opts,
                                      steps, pallas,
                                      simple=label == "simple_step")
        options[label] = (outer, lin)
    return dict(u=out.u.cpu().numpy(), outer=int(out.outer_iters),
                lin=int(out.linear_iters_total), options=options)


def _p12_gloo_probe(rank, world, device, op):
    """One gloo collective on a small CUDA tensor of each of 2 ranks: its
    result as rank 0 sees it."""
    import torch
    import torch.distributed as dist
    t = torch.full((4,), float(rank + 1), device=device)
    if op == "all_reduce":
        dist.all_reduce(t)
        return t[0].item()
    if op == "broadcast":
        dist.broadcast(t, 0)
        return t[0].item()
    if op == "all_gather":
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return [p[0].item() for p in parts]
    x = torch.empty_like(t)
    for req in (dist.isend(t, 1 - rank), dist.irecv(x, 1 - rank)):
        req.wait()
    return x[0].item()


def _failure_summary(msg: str) -> str:
    """A ``run_ranks`` error in one line: each exit code, and each
    traceback's last line."""
    parts = []
    for block in msg.split("\nrank ")[1:]:
        lines = [ln.strip() for ln in block.splitlines() if ln.strip()]
        parts.append("rank " + (lines[0] if "exited" in lines[0]
                                else f"{lines[0]} {lines[-1]}"))
    return " | ".join(parts)


def _gloo_cuda_probe(op: str) -> str:
    """Whether the gloo collective ``op`` takes CUDA tensors here, in a
    group of its own (a rank that aborts takes only its own op down)."""
    from cfd2_tpu_torch.parallel.launch import run_ranks
    try:
        got = run_ranks(_p12_gloo_probe, 2, device="cuda", timeout=150,
                        args=(op,), collective_timeout=90)[0]
        return f"ok, {got}"
    except RuntimeError as e:
        return f"fails: {_failure_summary(str(e))}"[:300]


def _padded_developed(dm, path):
    """``bench_developed_1m.npz`` on the padded grid (its rows, then solid
    rows), masked and loaded as ``convert.load_developed_state`` loads it:
    (state, meta)."""
    from dataclasses import replace
    import torch
    from cfd2_tpu_torch.runtime.state import initial_state
    with np.load(path) as d:
        meta = json.loads(str(d["meta"]))
        u = d["u"].astype(np.float32)
        p = d["p"].astype(np.float32)
    ny, nx = dm.grid_shape
    check(tuple(meta["grid"]) == (u.shape[0], nx) and u.shape[0] <= ny,
          f"checkpoint grid {meta['grid']} does not pad to {dm.grid_shape}")
    pad = ny - u.shape[0]
    u = np.concatenate([u, np.zeros((pad, nx, 2), np.float32)])
    p = np.concatenate([p, np.zeros((pad, nx), np.float32)])
    valid = dm.c_valid
    u = torch.as_tensor(u.reshape(-1, 2), device=dm.device) * valid[:, None]
    p = torch.as_tensor(p.reshape(-1), device=dm.device) * valid
    st = initial_state(dm)
    return replace(st, u=u, u_old=u, u_old_old=u, prev_u=u, p=p), meta


def _rank_line(part, rank, lin, counts, wall, leg=None):
    per = max(lin, 1)
    ex = counts["exchanges"]
    sides = (rank > 0) + (rank < SHARD_WORLD - 1)
    line = (f"phase 12{part}: rank {rank}: FGMRES iterations {lin}, per "
            f"iteration {ex / per:.2f} exchanges, "
            f"{counts['allreduces'] / per:.2f} all-reduces, "
            f"{counts['allgathers'] / per:.2f} all-gathers; "
            f"{counts['exchange_bytes'] / max(ex * sides, 1):.0f} bytes "
            f"sent to each neighbour per exchange; wall {wall:.3f} s")
    if leg is not None:
        line += f"; rbgs_leg {leg} ({leg / per:.2f} per iteration)"
    log(line)


def phase_sharded_main(results, ctx, path):
    """12(a, c, d)."""
    import pickle
    import shutil
    import torch
    from dataclasses import replace
    from cfd2_tpu_torch.models.coupled import multi_step_adaptive, step
    from cfd2_tpu_torch.ops.amg import build_hierarchy_for_mesh
    from cfd2_tpu_torch.parallel import spatial as sp
    from cfd2_tpu_torch.parallel.launch import run_ranks
    from cfd2_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                   load_checkpoint_dcp)
    from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
    from cfd2_tpu_torch.runtime.state import (STATE_FIELDS, SolverConfig,
                                              SolverParams)

    t0 = time.time()
    mesh = ctx["main_mesh"] if "main_mesh" in ctx else _channel(0.0017)
    dm = encode_mesh(mesh, pad_rows_to=SHARD_WORLD)
    check(tuple(dm.grid_shape) == SHARD_GRID,
          f"padded grid {dm.grid_shape} != {SHARD_GRID}")
    amg = build_hierarchy_for_mesh(dm)
    loaded, meta = _padded_developed(dm, ROOT / "bench_developed_1m.npz")
    params = SolverParams.default(dt=min(0.002, 0.4 * 0.0017),
                                  viscosity=meta["viscosity"])
    config = SolverConfig(precond_type=1, fgmres_max_restarts=5)
    torch.cuda.synchronize()
    log(f"phase 12a: padded mesh {dm.grid_shape} ({dm.num_cells} device "
        f"cells, {mesh.num_cells} fluid) and hierarchy "
        f"{[tuple(l.grid) for l in amg.levels]} in {time.time() - t0:.1f} s")

    # The reduction order alone, in one process: the first healing step of
    # the state as loaded (20 outers, the cap: it does not converge) with a
    # one-rank decomposition, whose norms and dots are summed as the ranks
    # sum them, against the same step without one.
    one_rank = sp.RowDecomposition(*dm.grid_shape, transport="gloo",
                                   device=dm.device)
    plain = step(dm, loaded, params, config, amg)
    ordered = step(sp.shard_mesh(dm, one_rank),
                   sp.shard_state(dm, loaded, one_rank), params, config,
                   sp.shard_cellwise(amg, dm.num_cells, one_rank))
    log(f"phase 12a: the as-loaded state's first healing step, one process: "
        f"outers {int(plain.outer_iters)} / {int(ordered.outer_iters)}, "
        f"FGMRES iterations {int(plain.linear_iters_total)} / "
        f"{int(ordered.linear_iters_total)} without / with the ranks' "
        f"reduction order; max|du| "
        f"{float((plain.u - ordered.u).abs().max()):.3e} (max|u| "
        f"{float(plain.u.abs().max()):.4f})")
    # The start: the state as phase 3 runs it, after 3 healing steps.
    state0 = plain
    for _ in range(2):
        state0 = step(dm, state0, params, config, amg)
    log(f"phase 12a: healed in 3 one-process steps; the last took "
        f"{int(state0.outer_iters)} outers, "
        f"{int(state0.linear_iters_total)} FGMRES iterations")

    t0 = time.time()
    with open(path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(mesh=_moved(dm, "cpu"), amg=_moved(amg, "cpu"),
                         state=_moved(state0, "cpu"),
                         params=_moved(params, "cpu"), config=config), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    log(f"phase 12a: rank inputs written in {time.time() - t0:.1f} s "
        f"({(path / 'inputs.pkl').stat().st_size / 2**20:.0f} MiB)")
    # The ranks run while this process takes the references they are held
    # to; its walls, taken beside the ranks' work on the card, are logged
    # and compared with nothing.
    t_ranks = time.time()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, _p12_rank, SHARD_WORLD, device="cuda",
                            timeout=900, args=(path,),
                            collective_timeout=300)
        one, wall1, leg1, _, _, _ = _timed(
            lambda: step(dm, state0, params, config, amg))
        # Two adaptive runs: from the step's dt, where dt = 0.5 h / max|u|
        # decides each step, and from dt 1e-4, where the 1.2x growth limit
        # decides both, the regime of the JAX package's sharded test
        # (tests/test_structured.py:162-209).
        adaptive = {}
        for kind, dt0 in (("adaptive", None), ("adaptive, dt capped", 1e-4)):
            p0 = params if dt0 is None else replace(
                params, dt=torch.full_like(params.dt, dt0))
            (one2, _, m1), wall2, _, _, _, _ = _timed(
                lambda: multi_step_adaptive(dm, state0, p0, config, 2, 0.5,
                                            0.0017, amg))
            adaptive[kind] = (one2, m1)
        refs = [step(dm, state0, replace(params, viscosity=torch.tensor(
            nu, dtype=torch.float32, device=dm.device)), config, amg)
            for nu in SHARD_VISCOSITIES]
        t0 = time.time()
        opt_refs = {label: _timed_option(dm, state0, params, config, amg, opts,
                                         steps, pallas)
                    for label, opts, steps, pallas in SHARD_OPTION_RUNS}
        log(f"phase 12f: one process, every option in "
            f"{time.time() - t0:.1f} s: " + "; ".join(
                f"{k}: outers {r['outer']}, FGMRES iterations {r['lin']}, "
                f"wall {r['wall']:.3f} s" for k, r in opt_refs.items()))
        # The control: each option in one process with a one-rank
        # decomposition, which changes nothing but how the norms are summed.
        ctl = [sp.shard_mesh(dm, one_rank),
               sp.shard_state(dm, state0, one_rank),
               sp.shard_cellwise(params, dm.num_cells, one_rank), config,
               sp.shard_cellwise(amg, dm.num_cells, one_rank)]
        controls = {label: _timed_option(*ctl, opts, steps, pallas)
                    for label, opts, steps, pallas in SHARD_OPTION_RUNS}
        ops_ref = _full_width_operators(dm, state0, params, config, amg)
        log(f"phase 12a: one process: step outers {int(one.outer_iters)}, "
            f"FGMRES iterations {int(one.linear_iters_total)}, wall "
            f"{wall1:.3f} s, rbgs_leg {leg1}; " + "; ".join(
                f"{k}: outers {m['outer_iters'].tolist()}, dt "
                f"{m['dt'].tolist()}" for k, (_, m) in adaptive.items()))
        res = ranks.result()
    log(f"phase 12a: {SHARD_WORLD} ranks in {time.time() - t_ranks:.1f} s "
        f"(spawn and set-up included); transport: {res[0]['transport']}; "
        f"V-cycle levels below {res[0]['split']} sharded")

    refs_a = [("step", one.u.cpu().numpy(), [int(one.outer_iters)])] + [
        (k, o.u.cpu().numpy(), m["outer_iters"].tolist())
        for k, (o, m) in adaptive.items()]
    for kind, ref_u, ref_outer in refs_a:
        u = np.concatenate([r[kind]["u"] for r in res])
        scale = float(np.abs(ref_u).max())
        err = float(np.abs(u - ref_u).max())
        for k, r in enumerate(res):
            rr = r[kind]
            outer = [rr["outer"]] if kind == "step" else rr["outer"].tolist()
            # The adaptive metrics carry no FGMRES count: one V-cycle (two
            # legs per level) per FGMRES iteration gives it.
            lin = rr["lin"] if kind == "step" else \
                rr["leg"] // (2 * len(amg.levels))
            _rank_line("a", k, lin, rr["counts"], rr["wall"], rr["leg"])
            check(outer == ref_outer, f"{kind}: rank {k} outers {outer}, "
                  f"one process {ref_outer}")
            check(rr["leg"] > 0, f"{kind}: rbgs_leg never launched on rank "
                  f"{k}")
        log(f"phase 12a: {kind}: outers {ref_outer} on every rank and in "
            f"one process; max|du| {err:.3e} (max|u| {scale:.4f})")
        check(np.isfinite(u).all() and err <= 1e-4 * scale,
              f"{kind}: sharded u differs by {err:.3e}")
    for kind, (_, m1) in adaptive.items():
        dt1, mv1 = m1["dt"].cpu().numpy(), m1["max_vel"].cpu().numpy()
        dterr = max(float(np.abs(r[kind]["dt"] - dt1).max()) for r in res)
        mverr = max(float(np.abs(r[kind]["max_vel"] - mv1).max())
                    for r in res)
        log(f"phase 12a: {kind}: dt {res[0][kind]['dt'].tolist()}, max "
            f"diff {dterr:.3e}; max|u| before each step "
            f"{res[0][kind]['max_vel'].tolist()}, max diff {mverr:.3e}")
        if kind == "adaptive":
            # dt = 0.5 h / max|u|: the first from the same start state,
            # each later one as far apart as the max|u| it reads, and each
            # of the two rounded to float32 (half a unit in the last place
            # of dt each).
            ulp = float(np.spacing(dt1.astype(np.float32)).max())
            check(dterr <= float((dt1 * mverr / mv1).max()) * 1.01 + ulp
                  and all(r[kind]["dt"][0] == dt1[0] for r in res),
                  f"{kind}: dt differs by {dterr:.3e}, more than max|u| "
                  "explains")
        else:
            check(dterr <= 1e-9, f"{kind}: dt differs by {dterr:.3e}")
    legs = [r["step"]["leg"] for r in res]
    launches = [r["step"]["launches"] for r in res]
    _path_launches(results, "row-sharded 1M step, 4 ranks (phase 12a)",
                   {k: sum(c[k] for c in launches) for k in launches[0]
                    if k not in HALF_SWEEP_PATH})
    log(f"phase 12a: rbgs_leg per rank {legs} in the step (one process "
        f"{leg1})")
    ms = config.mom_sweeps(dm.total_cells)
    for k, r in enumerate(res):
        _check_stencil_rates(f"12a rank {k}", r["step"]["launches"],
                             r["step"]["lin"], ms, True)

    # 12(c): the sweep, one case per rank.
    sweep = res[0]["sweep"]
    for k, r in enumerate(res):
        check(r["sweep"]["local"] == 1, f"rank {k} stepped "
              f"{r['sweep']['local']} cases")
        check(r["sweep"]["leg"] > 0, f"the sweep launched no rbgs_leg on "
              f"rank {k}")
    for i, (nu, ref) in enumerate(zip(SHARD_VISCOSITIES, refs)):
        same = np.array_equal(sweep["u"][i], ref.u.cpu().numpy())
        err = float(np.abs(sweep["u"][i] - ref.u.cpu().numpy()).max())
        log(f"phase 12c: viscosity {nu}: rank {i}'s case outers "
            f"{int(sweep['outer'][i])}, FGMRES iterations "
            f"{int(sweep['lin'][i])}, rbgs_leg {res[i]['sweep']['leg']}, "
            f"wall {res[i]['sweep']['wall']:.3f} s; "
            f"one process outers {int(ref.outer_iters)}; bit-equal {same} "
            f"(max|du| {err:.3e})")
        check(same and int(sweep["outer"][i]) == int(ref.outer_iters),
              f"viscosity {nu}: the rank's case differs from one process")

    # 12(d): the distributed checkpoint of the stepped sharded state.
    t0 = time.time()
    ck, ck_p = load_checkpoint_dcp(path / "ck")
    npz, npz_p = load_checkpoint(path / "gathered.npz")
    u_all = np.concatenate([r["step"]["u"] for r in res])
    for f in STATE_FIELDS:
        check(torch.equal(getattr(ck, f), getattr(npz, f)),
              f"checkpoint field {f} differs from the gathered .npz")
    check(np.array_equal(ck.u.cpu().numpy(), u_all),
          "the checkpoint's u differs from the ranks' rows")
    check(all(torch.equal(getattr(ck_p, f), getattr(npz_p, f))
              for f in vars(ck_p)), "checkpoint params differ")
    log(f"phase 12d: checkpoint written by {SHARD_WORLD} ranks in "
        f"{max(r['checkpoint_s'] for r in res):.2f} s, loaded here in "
        f"{time.time() - t0:.2f} s: every field bit-equal to the gathered "
        f".npz and u to the ranks' rows")
    shutil.rmtree(path / "ck", ignore_errors=True)

    _check_sharded_options(results, res, opt_refs, controls, ops_ref,
                           config)


# 12(f)'s bound on u, relative to max|u|, for the run that recycles the
# Krylov basis across two steps when it takes one process's counts.  Set
# from the readings on the H100: the one-rank control 1.9e-4 and the 4
# ranks 2.0e-4 of max|u| (6.0e-5 and 8.3e-5 before the RB-GS kernels took
# the JAX package's rounding); below the 5e-3 of solves that end apart.
RECYCLE_BOUND = 5e-4


def _check_sharded_options(results, res, refs, controls, ops_ref, config):
    """12(f): the operators the options add, bit-equal to one process on
    the ranks' rows; each option's run on every rank against one process,
    beside the one-rank control's distance from it.  A run that takes one
    process's outers and FGMRES iterations (the same solves, the sums in
    another order) is held to u within 1e-4 * max|u|; a run whose outer
    loop or a solve ended on another iteration (an exit that roundoff
    decides) is a different converged answer, held to the port's bound for
    two runs whose solves take different paths to the same tolerance
    (tests/torch_parity.py BF16: outers within 1 per step, FGMRES
    iterations within 2 per outer, u within 5e-3 * max|u|).  A run that
    recycles the Krylov basis across steps (``fgmres_recycle=2``) at equal
    counts is held to RECYCLE_BOUND * max|u|: its second step starts from a
    guess built from the first step's basis, whose bits the sums' order
    decides, so its u lies further from one process's than a single
    step's.  Every option is checked and logged before the failures are
    raised."""
    from dataclasses import replace
    legs = halves = resids = 0
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    for name, ref in ops_ref.items():
        got = np.concatenate([r["operators"][name] for r in res],
                             axis=ref.ndim - 2)
        same = np.array_equal(got, ref)
        log(f"phase 12f: {name} at full width on the ranks' rows: bit-equal "
            f"to one process {same} (max|d| "
            f"{float(np.abs(got - ref).max()):.3e})")
        check(same, f"{name}: the ranks' rows differ from one process")

    for label, opts, _, pallas in SHARD_OPTION_RUNS:
        ref = refs[label]
        u = np.concatenate([r["options"][label]["u"] for r in res])
        scale = float(np.abs(ref["u"]).max())
        err = float(np.abs(u - ref["u"]).max())
        ctl = controls[label]
        ctl_err = float(np.abs(ctl["u"] - ref["u"]).max())
        log(f"phase 12f: {label}: the one-rank control: outers "
            f"{ctl['outer']}, FGMRES iterations {ctl['lin']}, max|du| "
            f"{ctl_err:.3e} from one process")
        multigrid = replace(config, **opts).precond_type == 1
        for k, r in enumerate(res):
            rr = r["options"][label]
            _rank_line(f"f, {label}", k, sum(rr["lin"]), rr["counts"],
                       rr["wall"], rr["leg"] if multigrid and not pallas
                       else None)
            check(rr["outer"] == res[0]["options"][label]["outer"],
                  f"{label}: rank {k} outers {rr['outer']}, rank 0 "
                  f"{res[0]['options'][label]['outer']}")
            if multigrid and pallas is None:
                check(rr["leg"] > 0, f"{label}: rbgs_leg never launched on "
                      f"rank {k}")
            if pallas == "1":
                # Launches per FGMRES iteration as in one process.
                check(rr["half"] > 0 and rr["half"] * sum(ref["lin"])
                      == ref["half"] * sum(rr["lin"]),
                      f"{label}: rank {k} rbgs_half_sweep {rr['half']} over "
                      f"{sum(rr['lin'])} iterations, one process "
                      f"{ref['half']} over {sum(ref['lin'])}")
                check(rr["resid"] > 0 and rr["resid"] * sum(ref["lin"])
                      == ref["resid"] * sum(rr["lin"]),
                      f"{label}: rank {k} rbgs_residual {rr['resid']} over "
                      f"{sum(rr['lin'])} iterations, one process "
                      f"{ref['resid']} over {sum(ref['lin'])}")
                log(f"phase 12f, {label}: rank {k}: rbgs_half_sweep "
                    f"{rr['half']} ({rr['half'] / max(sum(rr['lin']), 1):.2f}"
                    f" per iteration; one process {ref['half']}, "
                    f"{ref['half'] / max(sum(ref['lin']), 1):.2f}), "
                    f"rbgs_residual {rr['resid']} (one process "
                    f"{ref['resid']})")
            legs += rr["leg"]
            halves += rr["half"]
            resids += rr["resid"]
        lins = [r["options"][label]["lin"] for r in res]
        outer = res[0]["options"][label]["outer"]
        wall = max(r["options"][label]["wall"] for r in res)
        same = outer == ref["outer"] and lins[0] == ref["lin"]
        bound = ((RECYCLE_BOUND if replace(config, **opts).fgmres_recycle
                  >= 2 else 1e-4) if same else 5e-3)
        log(f"phase 12f: {label}: outers {outer} on every rank, "
            f"{ref['outer']} in one process; FGMRES iterations {lins[0]} "
            f"(one process {ref['lin']}); wall {wall:.3f} s (one process "
            f"{ref['wall']:.3f} s); max|du| {err:.3e} (max|u| {scale:.4f}, "
            f"{err / scale:.2e} of it; bound {bound:g}: "
            f"{'the same solves' if same else 'solves end apart'})")
        check(len({tuple(v) for v in lins}) == 1,
              f"{label}: the ranks took different FGMRES counts {lins}")
        if not same:
            check(len(outer) == len(ref["outer"]) and all(
                abs(a - b) <= 1 for a, b in zip(outer, ref["outer"]))
                and all(abs(a - b) <= 2 * o for a, b, o in
                        zip(lins[0], ref["lin"], ref["outer"])),
                f"{label}: outers {outer} / {ref['outer']}, FGMRES "
                f"iterations {lins[0]} / {ref['lin']} apart")
        check(np.isfinite(u).all() and err <= bound * scale,
              f"{label}: sharded u differs by {err:.3e}")
    _path_launches(results, "row-sharded options at full width, 4 ranks "
                   "(phase 12f)",
                   {"rbgs_leg": legs, "rbgs_half_sweep": halves,
                    "rbgs_residual": resids})
    if failures:
        raise PhaseError("; ".join(failures))


def phase_sharded_banded(results, ctx, path):
    """12(b)."""
    import pickle
    import types
    import torch
    from cfd2_tpu_torch import generate_delaunay_mesh
    from cfd2_tpu_torch.models.assembly import assemble_ell, prepare
    from cfd2_tpu_torch.ops import ellsys as el
    from cfd2_tpu_torch.ops.fgmres import fgmres_solve
    from cfd2_tpu_torch.parallel.launch import run_ranks
    from cfd2_tpu_torch.parallel.spatial import banded_bandwidth

    s = ctx.get("delaunay")
    if s is None:
        mesh = generate_delaunay_mesh(_obstacle_geo(), DELAUNAY_MIN_CELL,
                                      DELAUNAY_MIN_CELL, 1.2, (3.0, 1.0))
        s = _unstructured_solver(mesh, DELAUNAY_MIN_CELL, None)
    dm = s.mesh
    state = prepare(dm, s.state, s.params, s.config)
    es = assemble_ell(dm, state, s.params, s.config)
    halo = banded_bandwidth(dm)
    N = dm.num_cells
    check(N % SHARD_WORLD == 0 and halo <= N // SHARD_WORLD,
          f"N_dev {N}, halo {halo}: not 4 ranges with one exchange")
    g = torch.Generator(device="cpu").manual_seed(12)
    x = torch.randn(3, N, generator=g)
    b = torch.randn(3, N, generator=g)
    y_ref = el.spmv(es, dm, x.to(dm.device)).cpu().numpy()
    dinv = torch.stack([es.diag_u_inv, es.diag_u_inv, es.diag_p_inv])
    one = fgmres_solve(lambda v: el.spmv(es, dm, v), lambda r: r * dinv,
                       b.to(dm.device), torch.zeros_like(b, device=dm.device),
                       restart=20, max_restarts=3, tol=1e-5)
    with open(path / "banded.pkl", "wb") as f:
        pickle.dump(dict(mesh=types.SimpleNamespace(
            num_cells=N, ck_neighbor=dm.ck_neighbor.cpu()),
            es=_moved(es, "cpu"), x=x, b=b, halo=halo), f,
            protocol=pickle.HIGHEST_PROTOCOL)
    t0 = time.time()
    res = run_ranks(_p12_banded_rank, SHARD_WORLD, device="cuda",
                    timeout=600, args=(path,), collective_timeout=300)
    y = np.concatenate([r["y"] for r in res], axis=1)
    scale = max(float(np.abs(y_ref).max()), 1.0)
    err = float(np.abs(y - y_ref).max())
    log(f"phase 12b: {SHARD_WORLD} ranks in {time.time() - t0:.1f} s; "
        f"{N} cells in ranges of {N // SHARD_WORLD}, halo {halo} cells; "
        f"transport: {res[0]['transport']}; SpMV max err {err:.3e} (scale "
        f"{scale:.3e}); one-range FGMRES {one.iterations} iterations")
    check(err <= 1e-5 * scale, f"sharded SpMV differs by {err:.3e}")
    its = {r["iterations"] for r in res}
    check(len(its) == 1, f"the ranks took different iteration counts {its}")
    for k, r in enumerate(res):
        _rank_line("b", k, r["iterations"], r["counts"], r["wall"])
        log(f"phase 12b: rank {k}: banded_dot {r['dots']}, SpMV wall "
            f"{r['wall_mv'] * 1e3:.2f} ms, host reads {r['reads']}")
        check(r["finite"] and r["iterations"] > 0,
              f"rank {k}: FGMRES x finite {r['finite']}, iterations "
              f"{r['iterations']}")
        check(r["dots"] > 0, f"banded_dot never launched on rank {k}")
    _path_launches(results, "banded sharded SpMV + FGMRES, 4 ranks "
                   "(phase 12b)", {"banded_dot": sum(r["dots"] for r in res)})


def phase_sharded_small():
    """12(e): the 4,636-cell mesh over 4 ranks on the card and on the CPU;
    and, at the same time, which gloo collectives take CUDA tensors (the
    reason the decomposition stages them through host memory), logged."""
    from cfd2_tpu_torch.parallel.launch import run_ranks
    mesh = _channel(SHARD_SMALL_CELL)
    check(mesh.num_cells == SHARD_SMALL_CELLS,
          f"mesh has {mesh.num_cells} cells")
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < SHARD_SMALL_CELL, 0] = 1.0
    # The probes' groups and the two groups of ranks run at once.
    with ThreadPoolExecutor(6) as pool:
        probes = {op: pool.submit(_gloo_cuda_probe, op) for op in
                  ("all_reduce", "broadcast", "all_gather", "isend/irecv")}
        runs = {dev: pool.submit(run_ranks, _p12_small_rank, SHARD_WORLD,
                                 device=dev, timeout=300, args=(mesh, u0))
                for dev in ("cuda", "cpu")}
        probes = {op: f.result() for op, f in probes.items()}
        runs = {dev: f.result() for dev, f in runs.items()}
    log("phase 12e: gloo with CUDA tensors, 2 ranks: " + "; ".join(
        f"{k} {v}" for k, v in probes.items()))
    outers = {dev: [r["outer"] for r in rs] for dev, rs in runs.items()}
    lins = {dev: [r["lin"] for r in rs] for dev, rs in runs.items()}
    err = float(np.abs(np.concatenate([r["u"] for r in runs["cuda"]])
                       - np.concatenate([r["u"] for r in runs["cpu"]])).max())
    log(f"phase 12e: {SHARD_SMALL_CELLS} cells over {SHARD_WORLD} ranks: "
        f"outers card {outers['cuda']}, CPU {outers['cpu']}; FGMRES "
        f"iterations card {lins['cuda']}, CPU {lins['cpu']}; max|du| "
        f"{err:.3e}")
    check(len(set(outers["cuda"] + outers["cpu"])) == 1,
          "card and CPU ranks took different outer counts")
    # 12(g): every option, card ranks against CPU ranks: equal counts on
    # every rank of a device, outers across the devices within phase 9's
    # slack (Anderson's later outers extrapolate rtol-sized differences).
    opts_of = {label: opts for label, opts, _, _ in SHARD_OPTION_RUNS}
    for label in runs["cuda"][0]["options"]:
        got = {dev: [r["options"][label] for r in rs]
               for dev, rs in runs.items()}
        log(f"phase 12g: {label}: outers card {got['cuda'][0][0]}, CPU "
            f"{got['cpu'][0][0]}; FGMRES or Krylov iterations card "
            f"{got['cuda'][0][1]}, CPU {got['cpu'][0][1]}")
        for dev, rs in got.items():
            check(all(r == rs[0] for r in rs), f"{label}: the {dev} ranks "
                  f"took different counts {rs}")
        card, cpu = got["cuda"][0][0], got["cpu"][0][0]
        slack = _outer_slack(opts_of.get(label, {}))
        check(len(card) == len(cpu) and all(
            abs(a - b) <= slack for a, b in zip(card, cpu)),
              f"{label}: card and CPU ranks took outers {card} / {cpu}")


def phase_sharded(results, ctx):
    import shutil
    path = SHARD_DIR
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    failed = []
    try:
        for part, fn in (("a, c, d, f",
                          lambda: phase_sharded_main(results, ctx, path)),
                         ("b", lambda: phase_sharded_banded(results, ctx,
                                                            path)),
                         ("e, g", phase_sharded_small)):
            t0 = time.time()
            try:
                fn()
            except PhaseError as e:     # the other parts still run
                log(f"phase 12{part} FAILED: {e}")
                failed.append(f"12{part}: {e}")
            log(f"# phase 12{part} done in {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if failed:
        raise PhaseError(" | ".join(failed))


# ----------------------------------------------------------------------
# Phase 13: the developed full-size cases of tools/developed_cases.py.

DEVELOPED_CASES = ("structured_2m_developed", "delaunay_1m_developed",
                   "voronoi_893k_developed")
DEVELOPED_2M_GRID = (834, 2500)
COUNTS_RECORD = ROOT / "cfd2_tpu_torch" / "data" / "fullsize_counts.json"
# The heal tool run on the card: its heal steps, and where it writes.
HEAL_STEPS_ON_CARD = 3
HEAL_DIR = ROOT / ".phase13"


def _record_steps(case, package, record=None):
    """The counted steps of ``case`` that ``tests/torch_fullsize_parity.py``
    recorded for ``package`` (``jax``, ``port_cpu``, or either of them
    ``_from_card_step<N>``: one step from the card's saved state), or [];
    ``record``: another file of that form than ``COUNTS_RECORD``
    (``VALIDATION_COUNTS``)."""
    record = COUNTS_RECORD if record is None else record
    if not record.exists():
        return []
    entry = json.loads(record.read_text())["cases"].get(case, {}).get(package)
    return entry["steps"] if entry else []


def _within_round_bound(card, ref):
    """The round's bound on one step: equal outers, FGMRES iterations in
    all within 2 per outer.  ``card`` and ``ref``: (outers, iterations)."""
    return card[0] == ref[0] and abs(card[1] - ref[1]) <= 2 * ref[0]


def _beside_record(phase, case, rows, enforce=False, first=0, suffix="",
                   record=None):
    """Log the card's (outers, FGMRES iterations) per step beside the
    record's JAX and port-CPU steps of ``case``; with ``enforce``, check
    the round's bound on every step the JAX record holds.  ``rows`` are
    the case's steps from ``first`` on, and ``suffix`` picks the records
    (``_from_card_step2``: the step from the card's saved state, whose
    record holds that one step).  Returns the steps that miss it."""
    jax_rows = _record_steps(case, "jax" + suffix, record)
    cpu_rows = _record_steps(case, "port_cpu" + suffix, record)
    if suffix:
        jax_rows, cpu_rows = [None] * first + jax_rows, [None] * first + cpu_rows

    def fmt(r):
        return (f"{r['outers']} outers, {sum(r['its'])} it {r['its']}"
                if r else "not recorded")

    missed = []
    for i, (outer, lin) in enumerate(rows, first):
        j = jax_rows[i] if i < len(jax_rows) else None
        c = cpu_rows[i] if i < len(cpu_rows) else None
        verdict = "no JAX record"
        if j is not None:
            ok = _within_round_bound((outer, lin),
                                     (j["outers"], sum(j["its"])))
            verdict = "within the bound" if ok else "MISSES the bound"
            if not ok:
                missed.append(i)
        log(f"phase {phase}: {case}{suffix} step {i}: card {outer} outers, "
            f"{lin} it; JAX (CPU) {fmt(j)}; port (CPU) {fmt(c)}: {verdict} "
            "(equal outers, iterations within 2 per outer)")
    if enforce:
        check(not missed, f"{case}{suffix}: steps {missed} miss the round's "
              "bound against the JAX package's record")
    return missed


# The meshes that background processes make while the card runs earlier
# phases: phase 6's and 7's (the same generator and arguments as
# mesh_cache.get_mesh's, so the same cells) and phase 13's.
BACKGROUND_MESHES = {6: ("delaunay", DELAUNAY_MIN_CELL),
                     7: ("voronoi", VORONOI_MIN_CELL)}


def _start_meshes(ctx, phases):
    """The meshes of the ``phases`` that need them (6, 7, 13), generated
    into ``.bench_cache`` by ``tools/mesh_cache.py`` in one background
    process each (host work), while the card runs the earlier phases:
    started by phase 1 once the native library is built."""
    from cfd2_tpu_torch.tools import developed_cases as dc
    from cfd2_tpu_torch.tools import mesh_cache
    wanted = {f"phase {num}": BACKGROUND_MESHES[num]
              for num in phases & set(BACKGROUND_MESHES)}
    if 13 in phases:
        wanted.update({name: (dc.CASES[name].mesh_type,
                              dc.CASES[name].min_cell)
                       for name in DEVELOPED_CASES})
    procs = {}
    for name, (mesh_type, size) in wanted.items():
        if os.path.exists(mesh_cache.mesh_path(mesh_type, size)):
            continue
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "cfd2_tpu_torch.tools.mesh_cache",
             mesh_type, str(size)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.time())
    ctx["mesh_procs"] = procs


def _stop_meshes(ctx):
    for proc, _ in ctx.get("mesh_procs", {}).values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _wait_mesh(ctx, name):
    proc, t0 = ctx.get("mesh_procs", {}).pop(name, (None, None))
    if proc is None:
        return
    out, _ = proc.communicate()
    log(f"{name} mesh generated in the background, "
        f"{time.time() - t0:.1f} s after it started: "
        + " | ".join(out.strip().splitlines()[-2:]))
    check(proc.returncode == 0, f"the {name} mesh failed: {out[-2000:]}")


def _developed_solver(ctx, name):
    """The case's solver on the card, set up from the case table; logs the
    set-up's wall and layout.  Returns (case, host mesh, solver)."""
    import torch
    from cfd2_tpu_torch.tools import developed_cases as dc
    case = dc.CASES[name]
    _wait_mesh(ctx, name)
    t0 = time.time()
    mesh = dc.case_mesh(case)
    t_mesh = time.time() - t0
    check(mesh.num_cells == case.cells,
          f"{name}: mesh has {mesh.num_cells} cells, expected {case.cells}")
    s, meta = dc.make_solver(case, mesh=mesh)
    hier = s._get_amg()
    torch.cuda.synchronize()
    dm = s.mesh
    levels = ([lvl.grid for lvl in hier.levels] if dm.structured
              else [lvl.n for lvl in hier.levels])
    log(f"phase 13: {name}: set-up {time.time() - t0:.1f} s (mesh load "
        f"{t_mesh:.1f} s; encode, hierarchy, state); {mesh.num_cells} "
        f"cells, N_dev {dm.num_cells}, K {dm.max_faces}, bd_k {dm.bd_k}, "
        f"levels {levels}; state time {float(s.state.time):.6f} s, dt "
        f"{float(s.params.dt):.6g}, viscosity "
        f"{float(s.params.viscosity):.6g}"
        + (f", probe_v amplitude {meta['probe_v_amplitude']:.4f}"
           if meta else ""))
    return case, mesh, s


def _developed_steps(s, case):
    """The case's uncounted heal steps, then its counted steps with the
    launch counts zeroed just before and read just after; logs each
    step's wall and returns (rows, counts, momentum dots, matvecs)."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.tools import developed_cases as dc

    def run(n, kind):
        try:
            rows = dc.run_steps(s, n)
        except FloatingPointError as e:
            raise PhaseError(f"{case.name}: {e}") from e
        for i, r in enumerate(rows):
            log(f"phase 13: {case.name} {kind} step {i}: wall "
                f"{r['wall_s']:.4f} s, outers {r['outers']}, FGMRES "
                f"iterations {sum(r['its'])} per outer {r['its']}, max|u| "
                f"{r['max_u']:.4f}, max|p| {r['max_p']:.4f}, cell-updates/s "
                f"{case.cells / r['wall_s']:.1f}")
        return rows

    run(case.heal_steps, "heal")
    with _counting_matvecs() as matvecs, _counting_mom_dots() as mom_dots:
        torch.cuda.synchronize()
        sk.reset_launches()
        bk.reset_launches()
        rows = run(case.steps, "counted")
        counts = {**sk.LAUNCHES, **bk.LAUNCHES}
    return rows, counts, mom_dots[0], matvecs[0]


def _p13_structured(results, ctx):
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    case, _, s = _developed_solver(ctx, "structured_2m_developed")
    check(tuple(s.mesh.grid_shape) == DEVELOPED_2M_GRID,
          f"grid {s.mesh.grid_shape} != {DEVELOPED_2M_GRID}")
    grids, coarsest = level_grids(*DEVELOPED_2M_GRID)
    amg = s._get_amg()
    check(len(amg.levels) == len(grids)
          and tuple(amg.levels[-1].grid) == coarsest,
          "hierarchy does not match the expected level grids")
    ms = s.config.mom_sweeps(s.mesh.total_cells)
    check(ms == sk.TILE_MAX_SWEEPS == 12
          and sk.momentum_launches(ms, False) == 1,
          f"{ms} momentum sweeps: expected the most one launch runs (12)")
    _hold_on_assembled_system(results, s, ms, phase=13)
    before = dict(sk.LAUNCHES)
    err_leg, err_fused, _ = _hold_legs(13, sk, grids)
    sk.LAUNCHES.update(before)
    if "rbgs_leg" in results:
        results["rbgs_leg"]["max_abs_err"] = max(
            results["rbgs_leg"]["max_abs_err"], err_leg, err_fused)
    rows, counts, _, matvecs = _developed_steps(s, case)
    lin = sum(sum(r["its"]) for r in rows)
    per_apply = 2 * len(grids)
    check(counts["rbgs_leg"] == per_apply * lin,
          f"rbgs_leg launches {counts['rbgs_leg']} != {per_apply} per "
          f"V-cycle x {lin} FGMRES iterations")
    _check_stencil_rates(13, counts, lin, ms, False, matvecs)
    log(f"phase 13: {case.name}: momentum_jacobi {counts['momentum_jacobi']}"
        f" = 2 predicts of {ms} sweeps in one launch each x {lin} FGMRES "
        f"iterations; rbgs_leg {counts['rbgs_leg']} = {per_apply} x {lin}")
    _path_launches(results, f"{case.name} (phase 13)",
                   {k: v for k, v in counts.items() if v})
    _beside_record(13, case.name, [(r["outers"], sum(r["its"]))
                                   for r in rows], enforce=True)


def _p13_banded(results, ctx, name):
    import torch
    case, mesh, s = _developed_solver(ctx, name)
    dm = s.mesh
    capped = name.startswith("voronoi")
    ms = s.config.mom_sweeps(dm.total_cells)
    if capped:
        check(dm.banded and dm.bd_k == 8 and not dm.banded_sweeps_fit(2),
              f"{name}: expected a slot-capped map above the 12 MiB rule, "
              f"got banded {dm.banded}, bd_k {dm.bd_k}")
    else:
        check(dm.banded and not dm.structured and dm.bd_k is None,
              f"{name}: expected an uncapped banded map, got banded "
              f"{dm.banded}, bd_k {dm.bd_k}")
    _hold_on_solver_maps(13, s, results)
    rows, counts, mom_dots, _ = _developed_steps(s, case)
    lin = sum(sum(r["its"]) for r in rows)
    for k in ("banded_gather", "banded_dot"):
        check(counts[k] > 0, f"{name}: {k} was never launched")
    check(sum(counts[k] for k in STENCIL_REPLACES) + counts["rbgs_leg"]
          == 0, f"{name}: a structured-path kernel ran on a banded mesh")
    if capped:
        check(counts["banded_jacobi_sweeps"] == 0
              and mom_dots == 2 * (ms - 1) * lin,
              f"{name}: banded_jacobi_sweeps {counts['banded_jacobi_sweeps']}"
              f", per-sweep momentum dots {mom_dots} != 2 x {ms - 1} per "
              f"FGMRES iteration x {lin}")
    else:
        check(counts["banded_jacobi_sweeps"] == 2 * lin and mom_dots == 0,
              f"{name}: banded_jacobi_sweeps {counts['banded_jacobi_sweeps']}"
              f" != 2 per FGMRES iteration x {lin} (per-sweep dots "
              f"{mom_dots})")
    log(f"phase 13: {name}: {lin} FGMRES iterations; per iteration "
        + ", ".join(f"{counts[k] / max(lin, 1):.2f} {k}"
                    for k in ("banded_dot", "banded_gather",
                              "banded_jacobi_sweeps"))
        + f"; per-sweep momentum dots {mom_dots} ({ms} sweeps a predict)")
    _path_launches(results, f"{name} (phase 13)",
                   {k: v for k, v in counts.items() if v})
    _beside_record(13, name, [(r["outers"], sum(r["its"])) for r in rows],
                   enforce=True)
    del s
    torch.cuda.empty_cache()
    return mesh


def phase_developed(results, ctx):
    """13: the four developed full-size cases on the card, set up from
    the case table; then the heal tool itself for a few steps on the
    refined cut-cell mesh."""
    import shutil
    import torch
    from cfd2_tpu_torch.tools import make_developed_unstructured as mdu
    _p13_structured(results, ctx)
    torch.cuda.empty_cache()
    _p13_banded(results, ctx, "delaunay_1m_developed")
    _p13_banded(results, ctx, "voronoi_893k_developed")
    mesh = _p13_banded(results, ctx, "refined_cutcell_130k_developed")
    ctx["refined_cutcell_mesh"] = mesh    # phase 16(e)
    t0 = time.time()
    try:
        meta = mdu.make("cutcell", 0.0015, HEAL_STEPS_ON_CARD, 0.006,
                        mesh=mesh,
                        out=HEAL_DIR / "developed_cutcell_0.0015-0.006.npz",
                        log=lambda m: log(f"phase 13: heal tool: {m}"))
    finally:
        shutil.rmtree(HEAL_DIR, ignore_errors=True)
    log(f"phase 13: make_developed_unstructured, {HEAL_STEPS_ON_CARD} heal "
        f"steps on {meta['cells']} cells: {time.time() - t0:.1f} s in all "
        f"(heal {meta['heal_wall_s']:.1f} s), max|u| {meta['max_u']:.4f}, "
        f"solver time {meta['solver_time']:.6f} s, on {meta['device']}")
    check(meta["device"] == torch.cuda.get_device_name(0),
          "the heal tool did not run on the card")



# ----------------------------------------------------------------------
# Phase 14: the physics-validation path (cfd2_tpu_torch/tools/).

VALIDATION_COUNTS = ROOT / "cfd2_tpu_torch" / "data" / "validation_counts.json"
TUREK_H, TUREK_CELLS, TUREK_GRID = 0.005, 35_804, (82, 440)
WATER_CELLS, WATER_GRID = 32_500, (100, 350)
WATER_STEPS = 50
# STIFF_X64.json: the JAX package's 50 steps in float64 on a CPU.  The JAX
# package's own float32 run on a TPU (STIFF_TPU.json, 0.386665) lies 2.8e-4
# of it away; an f32 run is held within 1e-3 of it.
WATER_X64_MAX_VEL, WATER_REL = 0.3865579664707184, 1e-3
# The CPU parity tests' field bounds (tests/torch_parity.py), here on the
# card's max|u| and max|p| after each step against the JAX package's.
STATE_U_REL, STATE_P_REL = 1e-4, 1e-3
# (e): the one force sample of the cut Strouhal measurement against the JAX
# package's at the same cut (record case "strouhal_cut": 22.5703).  In the
# heal's transient this Cd moves with the solver's float32 sums far more
# than the fields do: the port's CPU path gave 22.6143 before its FGMRES
# norms were summed in cascade and 22.5700 after, the card 22.5926 (9.9e-4
# off).  The bound is 5e-3; a wrong restriction or heal moves Cd by far more
# (the developed wake's mean Cd is 3.64).
STROUHAL_HEAL, STROUHAL_CD_REL = 20, 5e-3


def _hold_validation_counts(case, rows):
    """Each of ``rows`` (``developed_cases.run_steps``' dicts) held against
    the JAX package's record of ``case`` in ``VALIDATION_COUNTS``, which must
    hold every step: the outers and FGMRES iterations to the round's bound,
    max|u| within ``STATE_U_REL`` and max|p| within ``STATE_P_REL`` of the
    record's."""
    jax_rows = _record_steps(case, "jax", VALIDATION_COUNTS)
    check(len(jax_rows) >= len(rows), f"{case}: the JAX record holds "
          f"{len(jax_rows)} steps of {len(rows)}")
    _beside_record(14, case, [(r["outers"], sum(r["its"])) for r in rows],
                   enforce=True, record=VALIDATION_COUNTS)
    for i, (r, j) in enumerate(zip(rows, jax_rows)):
        du, dp = abs(r["max_u"] - j["max_u"]), abs(r["max_p"] - j["max_p"])
        lu, lp = STATE_U_REL * j["max_u"], STATE_P_REL * j["max_p"]
        log(f"phase 14: {case} step {i}: card max|u| {r['max_u']:.7g}, max|p| "
            f"{r['max_p']:.7g}; JAX (CPU) {j['max_u']:.7g}, {j['max_p']:.7g}: "
            f"off by {du:.3e} (limit {lu:.3e}) and {dp:.3e} (limit {lp:.3e})")
        check(du <= lu and dp <= lp, f"{case} step {i}: the card's max|u| or "
              "max|p| is off the JAX package's")


def _structured_path(results, s, label):
    """Before a structured run: the solver's layout checked, the legs held
    on its level grids and the stencil kernels on its assembled system.
    Returns (smoothed level grids, momentum sweeps)."""
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    check(s.mesh.structured, f"{label}: not on the structured layout")
    grids, _ = level_grids(*s.mesh.grid_shape)
    amg = s._get_amg()
    check(len(amg.levels) == len(grids),
          f"{label}: {len(amg.levels)} levels, expected {len(grids)}")
    ms = s.config.mom_sweeps(s.mesh.total_cells)
    _hold_on_assembled_system(results, s, ms, phase=14)
    before = dict(sk.LAUNCHES)
    err_leg, err_fused, _ = _hold_legs(14, sk, grids)
    sk.LAUNCHES.update(before)
    if "rbgs_leg" in results:
        results["rbgs_leg"]["max_abs_err"] = max(
            results["rbgs_leg"]["max_abs_err"], err_leg, err_fused)
    return grids, ms


def _check_structured_launches(results, label, counts, lin, grids, ms,
                               matvecs):
    """``rbgs_leg`` twice per smoothed level per FGMRES iteration and the
    four stencil kernels at their rates (asserted); recorded by path."""
    per_apply = 2 * len(grids)
    check(counts["rbgs_leg"] == per_apply * lin and lin > 0,
          f"{label}: rbgs_leg launches {counts['rbgs_leg']} != {per_apply} "
          f"per V-cycle x {lin} FGMRES iterations")
    _check_stencil_rates(14, counts, lin, ms, False, matvecs)
    log(f"phase 14: {label}: rbgs_leg {counts['rbgs_leg']} = {per_apply} x "
        f"{lin} FGMRES iterations")
    _path_launches(results, f"{label} (phase 14)",
                   {k: v for k, v in counts.items() if v})


def _p14_turek(results, ctx):
    """(a) Schäfer–Turek at D/h = 20 from rest, the tool's chunk loop for
    one 200-step chunk."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.tools import developed_cases as dc
    from cfd2_tpu_torch.tools import validate_turek as vt
    from cfd2_tpu_torch.utils.forces import obstacle_face_mask
    t0 = time.time()
    mesh = vt.make_mesh(TUREK_H)
    check(mesh.num_cells == TUREK_CELLS,
          f"Turek mesh has {mesh.num_cells} cells, expected {TUREK_CELLS}")
    s = vt.make_solver(mesh, TUREK_H)
    check(tuple(s.mesh.grid_shape) == TUREK_GRID,
          f"Turek grid {s.mesh.grid_shape} != {TUREK_GRID}")
    grids, ms = _structured_path(results, s, "Turek")
    log(f"phase 14: (a) Turek D/h 20: {mesh.num_cells} cells on "
        f"{s.mesh.grid_shape}, levels {grids}, set-up and checks "
        f"{time.time() - t0:.1f} s")
    mask = obstacle_face_mask(s.mesh)
    out = torch.empty((vt.CHUNK, 2), dtype=torch.float32, device=s.device)
    its, restore = dc.record_solves()
    try:
        with _counting_matvecs() as matvecs:
            torch.cuda.synchronize()
            sk.reset_launches()
            t0 = time.perf_counter()
            f = vt.run_chunk(s, mask, vt.CHUNK, out)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(sk.LAUNCHES)
    finally:
        restore()
    lin = sum(its)
    log(f"phase 14: (a) {vt.CHUNK} steps in {wall:.2f} s "
        f"({1e3 * wall / vt.CHUNK:.2f} ms a step), t = "
        f"{float(s.state.time):.4f} s, {len(its)} outers, {lin} FGMRES "
        f"iterations; Cd {f[-1, 0]:.4f}, Cl {f[-1, 1]:+.4e} at the end, "
        f"should_stop {s.should_stop}")
    check(np.isfinite(f).all() and f.shape == (vt.CHUNK, 2),
          "a step's Cd or Cl is not finite")
    check(_finite(s), "Turek fields are not finite")
    _check_structured_launches(results, "Turek D/h 20 from rest", counts,
                               lin, grids, ms, matvecs[0])
    ctx["turek_mesh"] = mesh


def _p14_turek_window(ctx):
    """(b) 3 Turek steps from the state the card's full run saved at the
    start of its measurement window, held to the JAX package's steps from
    the same state."""
    from cfd2_tpu_torch.tools import developed_cases as dc
    from cfd2_tpu_torch.tools import validate_turek as vt
    mesh = ctx.get("turek_mesh") or vt.make_mesh(TUREK_H)
    state = vt.window_path(TUREK_H)
    s = vt.make_solver(mesh, TUREK_H)
    meta = dc.load_step_input(s, state)
    t0 = time.perf_counter()
    rows = dc.run_steps(s, 3)
    log(f"phase 14: (b) Turek from {state.name} (t = {meta['time']:.4f} s, "
        f"step {meta.get('step')} of the run on {meta.get('card')}): 3 steps "
        f"in {time.perf_counter() - t0:.2f} s")
    _hold_validation_counts("turek_window", rows)


def _p14_water(results):
    """(c) The water backwards step at full size, 50 steps."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.tools import stiff_water as sw
    t0 = time.time()
    mesh = sw.make_mesh(0.01)
    check(mesh.num_cells == WATER_CELLS,
          f"water mesh has {mesh.num_cells} cells, expected {WATER_CELLS}")
    s = sw.make_solver(mesh)
    check(s.mesh.structured and tuple(s.mesh.grid_shape) == WATER_GRID,
          f"the smoothed water mesh is not on the {WATER_GRID} structured "
          f"layout: grid {s.mesh.grid_shape}")
    grids, ms = _structured_path(results, s, "water")
    log(f"phase 14: (c) water step: {mesh.num_cells} cells, smoothed, on "
        f"the structured layout {s.mesh.grid_shape}, levels {grids}; set-up "
        f"and checks {time.time() - t0:.1f} s")
    with _counting_matvecs() as matvecs:
        torch.cuda.synchronize()
        sk.reset_launches()
        t0 = time.perf_counter()
        # The tool raises on a residual that is not finite or not < 1e10.
        row = sw.run(steps=WATER_STEPS, out=None, solver=s,
                     log=lambda m: log(f"phase 14: (c) {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sk.LAUNCHES)
    rows = row["per_step"]
    lin = sum(sum(r["its"]) for r in rows)
    check(row["finite"], "water fields are not finite")
    max_vel = row["max_vel"]
    rel = abs(max_vel - WATER_X64_MAX_VEL) / WATER_X64_MAX_VEL
    log(f"phase 14: (c) {WATER_STEPS} steps in {wall:.2f} s, outers "
        f"{[r['outers'] for r in rows]}, FGMRES iterations {lin}; max outer "
        f"residual {row['max_outer_residual_u']:.4e}; max|u| {max_vel:.6f} "
        f"against STIFF_X64.json's {WATER_X64_MAX_VEL:.6f}: {rel:.3e} "
        f"relative (limit {WATER_REL:g})")
    check(rel <= WATER_REL, "the water step's max|u| is off STIFF_X64.json")
    _check_structured_launches(results, "water step", counts, lin, grids,
                               ms, matvecs[0])
    _hold_validation_counts("stiff_water", rows[:3])


def _cavity_run(device, precond_type):
    """The lid-driven cavity of tests/test_physics.py (tests/
    torch_physics_cases.py: 32 x 32, Re 100, dt 0.1, 100 steps or until
    should_stop): (u in host order, steps, the centreline error against
    Ghia, the solver)."""
    from cfd2_tpu_torch import (CoupledSolver, RectangularChannel,
                                generate_cut_cell_mesh)
    from cfd2_tpu_torch.mesh import retag_lid_cavity
    pc = _tests_module("torch_physics_cases")
    mesh, s = pc.cavity(CoupledSolver, RectangularChannel,
                        generate_cut_cell_mesh, retag_lid_cavity,
                        precond_type, device=device)
    n = 0
    for n in range(1, pc.CAVITY_STEPS + 1):
        s.step()
        if s.should_stop:
            break
    u = s.get_u()
    return u, n, pc.centreline_error(mesh, u)[0], s


def _cpu_pool(n):
    """``n`` spawned processes for CPU references that run beside the
    card's work (each imports this script by its path)."""
    import multiprocessing
    return ProcessPoolExecutor(n, multiprocessing.get_context("spawn"))


def _cavity_cpu(precond_type):
    """:func:`_cavity_run` on the CPU, less the solver."""
    return _cavity_run("cpu", precond_type)[:3]


def _p14_cavity(results):
    """(d) The cavity with the JAX test's configuration and with
    precond_type=1, card against Ghia and against the CPU (the CPU's runs
    in processes of their own, beside the card's)."""
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    pc = _tests_module("torch_physics_cases")
    with _cpu_pool(2) as pool:
        cpu = {p: pool.submit(_cavity_cpu, p) for p in (None, 1)}
        for precond in (None, 1):
            _p14_cavity_pair(results, pc, sk, precond, cpu[precond])


def _p14_cavity_pair(results, pc, sk, precond, cpu):
    """One configuration of (d) on the card, beside the future ``cpu`` of
    :func:`_cavity_cpu`."""
    label = ("the JAX test's configuration" if precond is None
             else "precond_type=1")
    sk.reset_launches()
    t0 = time.perf_counter()
    u_card, n_card, err_card, s = _cavity_run("cuda", precond)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in sk.LAUNCHES.items() if v}
    u_cpu, n_cpu, err_cpu = cpu.result()
    scale = float(np.abs(u_cpu).max())
    diff = float(np.abs(u_card - u_cpu).max())
    log(f"phase 14: (d) cavity {pc.CAVITY_N}x{pc.CAVITY_N}, {label}: "
        f"card {n_card} steps in {wall:.2f} s, Ghia error {err_card:.4f} "
        f"(bound {pc.GHIA_BOUND}); CPU {n_cpu} steps, Ghia error "
        f"{err_cpu:.4f}; max|u_card - u_cpu| {diff:.3e} (limit "
        f"{1e-4 * scale:.3e}); launches {counts}")
    check(np.isfinite(u_card).all(), "cavity fields are not finite")
    check(err_card < pc.GHIA_BOUND,
          f"cavity ({label}): centreline error {err_card:.4f} against "
          f"Ghia >= {pc.GHIA_BOUND}")
    check(n_card == n_cpu and diff <= 1e-4 * scale,
          f"cavity ({label}): card and CPU disagree")
    if precond == 1:
        check(counts.get("rbgs_leg", 0) > 0,
              "cavity with precond_type=1: rbgs_leg never launched")
    _path_launches(results, f"cavity, {label} (phase 14)", counts)


def _p14_strouhal():
    """(e) measure_strouhal from bench_developed_1m.npz, 20 heal steps and
    one force batch (a span under one batch's time), its one Cd held to
    the JAX package's at the same cut."""
    from cfd2_tpu_torch.tools import measure_strouhal as ms
    t0 = time.time()
    out = ms.run(ROOT / "bench_developed_1m.npz", heal_steps=STROUHAL_HEAL,
                 t_span=1e-9, log=lambda m: log(f"phase 14: (e) {m}"))
    log(f"phase 14: (e) measure_strouhal in {time.time() - t0:.1f} s: "
        f"{json.dumps(out)}")
    check(np.isfinite([out["St"], out["Cd_mean"], out["Cl_amp"]]).all()
          and out["samples"] == 1, "measure_strouhal gave no finite forces")
    rec = json.loads(VALIDATION_COUNTS.read_text())["cases"]["strouhal_cut"]
    j = rec["jax"]
    check(j["heal_steps"] == STROUHAL_HEAL and j["cells"] == out["cells"],
          "the strouhal_cut record is of another cut")
    d, lim = abs(out["Cd_mean"] - j["Cd"]), STROUHAL_CD_REL * abs(j["Cd"])
    log(f"phase 14: (e) Cd {out['Cd_mean']} against the JAX package's "
        f"{j['Cd']:.6g} (port CPU {rec['port_cpu']['Cd']}) at the same cut: "
        f"off by {d:.3e} (limit {lim:.3e})")
    check(d <= lim, "measure_strouhal's Cd is off the JAX package's")


def phase_validation(results, ctx):
    """14: the physics-validation tools of cfd2_tpu_torch/tools on the
    card (Turek from rest and from its developed state, the water step,
    the cavity, the Strouhal measurement)."""
    for part in (lambda: _p14_turek(results, ctx),
                 lambda: _p14_turek_window(ctx),
                 lambda: _p14_water(results),
                 lambda: _p14_cavity(results), _p14_strouhal):
        t0 = time.time()
        part()
        log(f"phase 14: part done in {time.time() - t0:.1f} s")


# ----------------------------------------------------------------------
# Phase 15: the solver tools of cfd2_tpu_torch/tools on the card.

# (e) the cavity probe's bound and the card's distance from the CPU run.
CAVITY_PROBE_BOUND, CAVITY_PROBE_CPU = 0.06, 1e-3
TOOLS_BF16_CELL = 0.005
LIVE_INLET = 1.2


def _tool_run(results, part, path, need, fn, phase=15):
    """``fn()`` with every kernel's launch count at 0 just before and read
    just after: each kernel of ``need`` must have launched; the counts go
    beside the kernels' main-path counts.  Returns fn's result."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    torch.cuda.synchronize()
    sk.reset_launches()
    bk.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in {**sk.LAUNCHES, **bk.LAUNCHES}.items() if v}
    log(f"phase {phase}: ({part}) {path}: {wall:.1f} s, launches {counts}")
    for name in need:
        check(counts.get(name, 0) > 0, f"{path}: {name} never launched")
    _path_launches(results, f"{path} (phase {phase})", counts)
    return out


def _p15_live(results):
    """(a) live_demo_1m on the 996,558-cell channel: 3 steps, then
    control?inlet=1.2 read back from the solver's params (no frame: the
    card's machine has no matplotlib; the tool fetches one where it has)."""
    from cfd2_tpu_torch.tools import live_demo_1m
    res = _tool_run(results, "a", "live_demo_1m", ("rbgs_leg",),
                    lambda: live_demo_1m.run(
                        cell=0.0017, steps=3, wait=600, inlet=LIVE_INLET,
                        log=lambda m: log(f"phase 15: (a) {m}")))
    check(res["cells"] == MAIN_CELLS, f"live demo on {res['cells']} cells")
    check(res["steps"] >= 3, "the live solver did not take 3 steps")
    check(abs(res["inlet"] - LIVE_INLET) < 1e-6,
          f"control?inlet={LIVE_INLET} read back as {res['inlet']}")


def _delaunay_mesh(ctx):
    """Phase 6's 403,491-cell Delaunay mesh, or the same mesh made here
    (once)."""
    from cfd2_tpu_torch.tools import probes
    if "delaunay" in ctx:
        return ctx["delaunay"].host_mesh
    if "delaunay_mesh" not in ctx:
        mesh = probes.channel_mesh(DELAUNAY_MIN_CELL, "delaunay")
        check(mesh.num_cells == DELAUNAY_CELLS,
              f"Delaunay mesh has {mesh.num_cells} cells")
        ctx["delaunay_mesh"] = mesh
    return ctx["delaunay_mesh"]


def _main_mesh(ctx):
    """Phase 3's 996,558-cell channel, or the same mesh made here."""
    return ctx.get("main_mesh") or _channel(0.0017)


def _p15_ladders(results, ctx):
    """(b) iters_1m (3 host steps from rest at 0.0017) and prof_step_iters
    (the 403k Delaunay mesh, 2 steps): their per-outer ladders."""
    from cfd2_tpu_torch.tools import iters_1m, prof_step_iters
    for k in ("IT_CELL", "IT_STEPS", "IT_EXTRAP", "IT_INCYCLE", "CFD2_CHEB",
              "CFD2_OC", "CFD2_MS", "CFD2_RESTART", "CFD2_AGGP",
              "CFD2_VCYCLES", "CFD2_MAXCELL"):
        os.environ.pop(k, None)
    lad = _tool_run(results, "b", "iters_1m", ("rbgs_leg",),
                    lambda: iters_1m.run(
                        cell=0.0017, steps=3, mesh=_main_mesh(ctx),
                        log=lambda m: log(f"phase 15: (b) {m}")))
    log(f"phase 15: (b) iters_1m ladders {lad}")
    check(len(lad) == 3 and all(lad) and sum(lad[0]) > 0,
          f"iters_1m ladders {lad}")
    lad = _tool_run(results, "b", "prof_step_iters",
                    ("banded_dot", "banded_jacobi_sweeps"),
                    lambda: prof_step_iters.run(
                        DELAUNAY_MIN_CELL, "delaunay", 2,
                        mesh=_delaunay_mesh(ctx),
                        log=lambda m: log(f"phase 15: (b) {m}")))
    log(f"phase 15: (b) prof_step_iters ladders {lad}")
    check(len(lad) == 2 and all(lad) and sum(lad[0]) > 0,
          f"prof_step_iters ladders {lad}")


def _p15_precond(results, ctx):
    """(c) prof_precond at 1M (2 warm steps) and prof_amg_variants on the
    403k Delaunay mesh: every variant's iterations."""
    from cfd2_tpu_torch.tools import prof_amg_variants, prof_precond
    got = _tool_run(results, "c", "prof_precond", ("rbgs_leg",),
                    lambda: prof_precond.run(
                        0.0017, 2, mesh=_main_mesh(ctx),
                        log=lambda m: log(f"phase 15: (c) {m}")))
    check(list(got) == [v[0] for v in prof_precond.VARIANTS]
          and all(np.isfinite(r["residual"]) for r in got.values()),
          f"prof_precond: {got}")
    got = _tool_run(results, "c", "prof_amg_variants",
                    ("banded_dot", "banded_gather"),
                    lambda: prof_amg_variants.run(
                        DELAUNAY_MIN_CELL, "delaunay",
                        mesh=_delaunay_mesh(ctx),
                        log=lambda m: log(f"phase 15: (c) {m}")))
    check(list(got) == [v[0] for v in prof_amg_variants.VARIANTS]
          and all(r["iterations"] > 0 and np.isfinite(r["contraction"])
                  for r in got.values()),
          f"prof_amg_variants: {got}")


def _p15_bf16(results):
    """(d) bf16_smoke at 0.005: the four combinations' outers, 2 timed
    steps each (the tool's default is 5)."""
    from cfd2_tpu_torch.tools import bf16_smoke
    os.environ.pop("SMOKE_VARIANTS", None)
    got = _tool_run(results, "d", "bf16_smoke", ("rbgs_leg",),
                    lambda: bf16_smoke.run(
                        size=TOOLS_BF16_CELL, timed=2,
                        log=lambda m: log(f"phase 15: (d) {m}")))
    check(list(got) == [v[0] for v in bf16_smoke.VARIANTS]
          and all(len(r["outers"]) == 2 for r in got.values()),
          f"bf16_smoke: {got}")


def _probe_cavity_cpu():
    """probe_cavity at its defaults on the CPU, quietly."""
    from cfd2_tpu_torch.tools import probe_cavity
    return probe_cavity.run(device="cpu", log=lambda m: None)


def _p15_cavity(results):
    """(e) probe_cavity at its defaults (h 1/48, dt 0.25, 80 steps; the
    default Chebyshev pressure block, so the stencil kernels but no leg) on
    the card and on the CPU: the Ghia error within the bound on the card
    and within 1e-3 of the CPU's (the steady-state stop within a step),
    the CPU's run in a process of its own beside the card's."""
    from cfd2_tpu_torch.tools import probe_cavity
    with _cpu_pool(1) as pool:
        cpu = pool.submit(_probe_cavity_cpu)
        card = _tool_run(results, "e", "probe_cavity",
                         ("coupled_spmv", "momentum_jacobi"),
                         lambda: probe_cavity.run(
                             log=lambda m: log(f"phase 15: (e) {m}")))
        cpu = cpu.result()
    d = abs(card["max_err"] - cpu["max_err"])
    log(f"phase 15: (e) cavity {card['cells']} cells, {card['steps']} steps: "
        f"Ghia max error card {card['max_err']:.6f}, CPU "
        f"{cpu['max_err']:.6f} ({cpu['steps']} steps): {d:.3e} apart "
        f"(limit {CAVITY_PROBE_CPU:g})")
    check(np.isfinite(card["ui"]).all()
          and card["max_err"] <= CAVITY_PROBE_BOUND,
          f"cavity probe: Ghia error {card['max_err']:.4f}")
    # The steps may differ by one: the steady-state stop trips on a
    # threshold that roundoff moves.
    check(abs(card["steps"] - cpu["steps"]) <= 1 and d <= CAVITY_PROBE_CPU,
          "cavity probe: card and CPU disagree")


def _p15_water_x64(results):
    """(f) stiff_water_x64 at its defaults (h 0.01, 50 steps, float64
    norms): finite, max|u| beside STIFF_X64.json's."""
    from cfd2_tpu_torch.tools import stiff_water_x64
    rec = _tool_run(results, "f", "stiff_water_x64", ("rbgs_leg",),
                    lambda: stiff_water_x64.run(
                        out=None, log=lambda m: log(f"phase 15: (f) {m}")))
    rel = abs(rec["max_vel"] - WATER_X64_MAX_VEL) / WATER_X64_MAX_VEL
    log(f"phase 15: (f) {rec['cells']} cells, {rec['steps']} steps, outers "
        f"{[r['outers'] for r in rec['per_step']]}; max|u| "
        f"{rec['max_vel']:.6f} against STIFF_X64.json's "
        f"{WATER_X64_MAX_VEL:.6f}: {rel:.3e} relative (limit {WATER_REL:g})")
    check(rec["finite"] and rec["f64_norms_active"],
          "the float64-norm water step is not finite")
    check(rel <= WATER_REL, "the float64-norm water step's max|u| is off "
          "STIFF_X64.json")


def _p15_fallback(results):
    """(g) the aggregation fallback row-sharded: 4 ranks sharing the card
    (gloo) against one process on the card, for both of
    tests/torch_spatial_ranks.FALLBACK's grids: equal counts on every rank
    and with one process, u within 1e-5."""
    from cfd2_tpu_torch.parallel.launch import run_ranks
    ranks = _tests_module("torch_spatial_ranks")

    def channel(h):
        mesh = _channel(h)
        u0 = np.zeros((mesh.num_cells, 2))
        u0[mesh.cell_cx < h, 0] = 1.0
        return mesh, u0

    cases = ranks.fallback_cases(channel)
    # Each step zeroes the counts itself and returns them: the aggregation
    # V-cycle launches banded_dot and the fused prolongation; without a
    # hierarchy the block path's Chebyshev relaxation launches none.
    one = {n: ranks.fallback_step(c[0], "cuda", *c[1:], group=False)
           for n, c in cases.items()}
    counts = {k: v for k, v in one["aggregation"]["launches"].items() if v}
    log(f"phase 15: (g) aggregation fallback, one process: launches "
        f"{counts}")
    for name in ("banded_dot", "banded_gather"):
        check(counts.get(name, 0) > 0,
              f"aggregation fallback: {name} never launched")
    _path_launches(results, "aggregation fallback, one process (phase 15)",
                   counts)
    res = run_ranks(ranks.fallback_steps_over, SHARD_WORLD, device="cuda",
                    timeout=600, args=((SHARD_WORLD,), cases))
    for name in cases:
        rs = [r[SHARD_WORLD][name] for r in res]
        u = np.concatenate([r["u"] for r in rs])
        err = float(np.abs(u - one[name]["u"]).max())
        log(f"phase 15: (g) {name} (levels {one[name]['levels']}): one "
            f"process {one[name]['outer']} outers, {one[name]['lin']} FGMRES "
            f"iterations; {SHARD_WORLD} ranks {[r['outer'] for r in rs]} / "
            f"{[r['lin'] for r in rs]}; max|du| {err:.3e}; all-gathers per "
            f"iteration {rs[0]['counts']['per_iteration']['allgathers']:.2f}"
            f"; rank 0 launches "
            f"{ {k: v for k, v in rs[0]['launches'].items() if v} }")
        check(all(r["outer"] == one[name]["outer"]
                  and r["lin"] == one[name]["lin"] for r in rs),
              f"fallback {name}: the ranks' counts differ from one process")
        check(err <= 1e-5, f"fallback {name}: u off one process by {err}")
        if one[name]["levels"]:
            check(rs[0]["counts"]["allgathers"] > 0
                  and rs[0]["launches"]["banded_dot"] > 0,
                  f"fallback {name}: the replicated V-cycle did not run")


def phase_tools(results, ctx):
    """15: the solver tools of cfd2_tpu_torch/tools on the card (the live
    demo, the ladders, the preconditioner probes, the bf16 smoke, the cavity
    probe, the float64-norm water step) and the sharded aggregation
    fallback."""
    failed = []
    for part, fn in (("a", lambda: _p15_live(results)),
                     ("b", lambda: _p15_ladders(results, ctx)),
                     ("c", lambda: _p15_precond(results, ctx)),
                     ("d", lambda: _p15_bf16(results)),
                     ("e", lambda: _p15_cavity(results)),
                     ("f", lambda: _p15_water_x64(results)),
                     ("g", lambda: _p15_fallback(results))):
        t0 = time.time()
        try:
            fn()
        except PhaseError as e:     # the other parts still run
            log(f"phase 15({part}) FAILED: {e}")
            failed.append(f"15({part}): {e}")
        log(f"# phase 15({part}) done in {time.time() - t0:.1f} s")
    if failed:
        raise PhaseError(" | ".join(failed))


# ----------------------------------------------------------------------
# Phase 16: the profiling tools of cfd2_tpu_torch/tools.

STRUCTURED_KERNELS = ("rbgs_leg", "coupled_spmv", "momentum_jacobi",
                      "schur_rhs", "pressure_gradient")
BANDED_KERNELS = ("banded_gather", "banded_dot", "banded_jacobi_sweeps")


def _p16_log(part):
    return lambda m: log(f"phase 16: ({part}) {m}")


def _p16_main_mesh(ctx):
    """Phase 3's 996,558-cell channel, or the same mesh made here once."""
    if "main_mesh" not in ctx:
        ctx["main_mesh"] = _channel(0.0017)
    return ctx["main_mesh"]


def _p16_developed(results, ctx):
    """(a) prof_developed on bench_developed_1m.npz at 0.0017 (3 heal and
    5 timed steps, a verbose host-mode step, the phases): its first three
    timed steps take phase 3's three timed steps' counts."""
    from cfd2_tpu_torch.tools import prof_developed
    got = _tool_run(results, "a", "prof_developed", STRUCTURED_KERNELS,
                    lambda: prof_developed.run(
                        mesh=_p16_main_mesh(ctx), log=_p16_log("a")),
                    phase=16)
    lins = tuple(lin for _, lin, _ in got["steps"][:3])
    outers = [o for o, _, _ in got["steps"][:3]]
    want = [o for o, _ in ctx["main"]["timed"]] if "main" in ctx else None
    log(f"phase 16: (a) timed steps {got['steps']}; phase 3's timed outers "
        f"{want}, FGMRES iterations {list(TIMED_LIN)}; host-mode "
        f"ladder {got['ladder']}")
    check(lins == TIMED_LIN, f"prof_developed's first timed steps took "
          f"{lins} FGMRES iterations, phase 3's {TIMED_LIN}")
    check(want is None or outers == want, f"prof_developed's first timed "
          f"outers {outers} != phase 3's {want}")
    check(got["ladder"] and got["solves"], "prof_developed: no ladder or "
          "solve")


def _p16_outer(results, ctx):
    """(b) prof_outer at 0.0017 from rest (2 fused steps)."""
    from cfd2_tpu_torch.tools import prof_outer
    for k in ("PROF_VCYCLES", "PROF_MOM", "PROF_BF16"):
        os.environ.pop(k, None)
    got = _tool_run(results, "b", "prof_outer", STRUCTURED_KERNELS,
                    lambda: prof_outer.run(0.0017, 2,
                                           mesh=_p16_main_mesh(ctx),
                                           log=_p16_log("b")), phase=16)
    check(all(np.isfinite(r) for _, _, r in got["solves"].values()),
          f"prof_outer: {got['solves']}")


def _p16_banded2(results, ctx):
    """(c) prof_banded2 on the 403,491-cell Delaunay mesh, one fused step
    (the tool's default is 3): its solve ends converged."""
    from cfd2_tpu_torch.tools import prof_banded2
    got = _tool_run(results, "c", "prof_banded2", BANDED_KERNELS,
                    lambda: prof_banded2.run(
                        DELAUNAY_MIN_CELL, "delaunay", steps=1,
                        mesh=_delaunay_mesh(ctx), log=_p16_log("c")),
                    phase=16)
    log(f"phase 16: (c) solve {got['solve']}, step outers {got['outers']}")
    check(got["solve"][1], f"prof_banded2's solve did not converge: "
          f"{got['solve']}")


def _p16_banded(results, ctx):
    """(d) prof_banded (the block-ELL system) on the same mesh."""
    from cfd2_tpu_torch.tools import prof_banded
    got = _tool_run(results, "d", "prof_banded",
                    ("banded_gather", "banded_dot"),
                    lambda: prof_banded.run(
                        DELAUNAY_MIN_CELL, "delaunay",
                        mesh=_delaunay_mesh(ctx), log=_p16_log("d")),
                    phase=16)
    log(f"phase 16: (d) solves {got['solves']}")
    check(all(it > 0 for it, _ in got["solves"].values()),
          f"prof_banded: {got['solves']}")


def _p16_refined_developed(results, ctx):
    """(e) prof_refined_developed at its default, the JAX tool's: the
    developed refined cut-cell state 0.0015 / 0.006 (phase 13's mesh)."""
    from cfd2_tpu_torch.tools import prof_refined_developed
    got = _tool_run(results, "e", "prof_refined_developed", BANDED_KERNELS,
                    lambda: prof_refined_developed.run(
                        mesh=ctx.get("refined_cutcell_mesh"),
                        log=_p16_log("e")), phase=16)
    log(f"phase 16: (e) {got['cells']} cells, outers {got['outers']}, "
        f"solve {got['solve']}")
    check(got["cells"] == 129_663 and got["solve"][1],
          f"prof_refined_developed: {got['cells']} cells, solve "
          f"{got['solve']}")


def _p16_fgmres(results, ctx):
    """(f) prof_fgmres at 0.0017: fgmres30 runs its 30 iterations."""
    from cfd2_tpu_torch.tools import prof_fgmres
    got = _tool_run(results, "f", "prof_fgmres", STRUCTURED_KERNELS,
                    lambda: prof_fgmres.run(0.0017,
                                            mesh=_p16_main_mesh(ctx),
                                            log=_p16_log("f")), phase=16)
    check(got["iterations"]["fgmres30"] == 30,
          f"prof_fgmres: {got['iterations']}")


def _p16_fgmres_loop(results):
    """(g) the bare FGMRES loop: exactly 30 and 50 iterations."""
    from cfd2_tpu_torch.tools import prof_fgmres_loop
    got = _tool_run(results, "g", "prof_fgmres_loop", (),
                    lambda: prof_fgmres_loop.run(log=_p16_log("g")),
                    phase=16)
    its = {m: r["iterations"] for m, r in got.items()}
    check(its == {30: 30, 50: 50}, f"the bare loop ran {its} iterations")


def _p16_trace(results, ctx):
    """(h) prof_trace: 2 warm host-mode steps from rest, 1 traced."""
    from cfd2_tpu_torch.tools import prof_trace
    got = _tool_run(results, "h", "prof_trace", STRUCTURED_KERNELS,
                    lambda: prof_trace.run(0.0017, 1,
                                           mesh=_p16_main_mesh(ctx),
                                           log=_p16_log("h")), phase=16)
    check(got["busy_s"] and got["busy_s"] > 0 and any(
        "rbgs_leg" in g for g in got["by_group"]),
        "prof_trace saw no rbgs_leg kernel on the device")


def _p16_layout(results):
    """(i) prof_layout at 589x1765: the flat and tiled Gram-Schmidt forms
    agree."""
    import torch
    from cfd2_tpu_torch.tools import prof_layout
    got = _tool_run(results, "i", "prof_layout", (),
                    lambda: prof_layout.run(log=_p16_log("i")), phase=16)
    a, b = got["cgs_flat"][1], got["cgs_tiled"][1]
    check(bool(torch.allclose(a, b, rtol=1e-3, atol=1e-2)),
          f"cgs_flat and cgs_tiled differ by {float((a - b).abs().max())}")


def _p16_bf16(results):
    """(j) probe_bf16 at 589x1765: the float32 momentum solve is the
    momentum_jacobi kernel."""
    from cfd2_tpu_torch.tools import probe_bf16
    _tool_run(results, "j", "probe_bf16", ("momentum_jacobi",),
              lambda: probe_bf16.run(log=_p16_log("j")), phase=16)


def phase_profiling(results, ctx):
    """16: the profiling tools of cfd2_tpu_torch/tools on the card, each in
    process at the size its part names, with each hand kernel on its path
    launched."""
    import torch
    failed = []
    for part, fn in (("a", lambda: _p16_developed(results, ctx)),
                     ("b", lambda: _p16_outer(results, ctx)),
                     ("c", lambda: _p16_banded2(results, ctx)),
                     ("d", lambda: _p16_banded(results, ctx)),
                     ("e", lambda: _p16_refined_developed(results, ctx)),
                     ("f", lambda: _p16_fgmres(results, ctx)),
                     ("g", lambda: _p16_fgmres_loop(results)),
                     ("h", lambda: _p16_trace(results, ctx)),
                     ("i", lambda: _p16_layout(results)),
                     ("j", lambda: _p16_bf16(results))):
        t0 = time.time()
        try:
            fn()
        except PhaseError as e:     # the other parts still run
            log(f"phase 16({part}) FAILED: {e}")
            failed.append(f"16({part}): {e}")
        torch.cuda.empty_cache()
        log(f"# phase 16({part}) done in {time.time() - t0:.1f} s")
    if failed:
        raise PhaseError(" | ".join(failed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--export-forces", metavar="PATH",
                    help="phase 11(c) also writes what the force formula "
                    "reads of its state to PATH (.npz)")
    ap.add_argument("--save-step2-input", metavar="DIR",
                    help="phases 6 and 10(a) write the state their case's "
                    "step 2 starts from into DIR (<case>_step2_card.npz, "
                    "host order)")
    ap.add_argument("--tree", metavar="PATH",
                    help="run phases 1 and 2 on the cfd2_tpu_torch of "
                    "another checkout, unpacked inside this one")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if args.tree is not None:
        tree = Path(args.tree).resolve()
        if ROOT not in tree.parents \
                or not (tree / "cfd2_tpu_torch").is_dir():
            print(f"chip_smoke: --tree {args.tree} is not a checkout inside "
                  f"{ROOT}", file=sys.stderr)
            return 2
        sys.path.insert(0, str(tree))
        phases &= {1, 2}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 basis dots

    log(card_line())
    results, ctx = {}, {"export_forces": args.export_forces,
                        "save_step2_input": args.save_step2_input}
    t_all = time.time()
    def phase_build():
        phase_build_native()
        _start_meshes(ctx, phases)
        phase_build_kernels()

    # Run in RUN_ORDER: phase 14 needs no mesh of the background processes
    # and runs while phase 6's is made; phase 13 runs after 15, by when
    # its Voronoi mesh, the slowest of them, is made too.
    steps = dict([(1, phase_build),
                  (2, lambda: phase_kernels(results)),
                  (3, lambda: phase_main(results, ctx)),
                  (4, lambda: phase_half_sweep(results, ctx)),
                  (5, phase_cpu_match),
                  (6, lambda: phase_delaunay(results, ctx)),
                  (7, lambda: phase_voronoi(results, ctx)),
                  (8, phase_delaunay_cpu_match),
                  (9, lambda: phase_options(ctx)),
                  (10, lambda: phase_generic(results, ctx)),
                  (11, lambda: phase_app(results, ctx)),
                  (12, lambda: phase_sharded(results, ctx)),
                  (13, lambda: phase_developed(results, ctx)),
                  (14, lambda: phase_validation(results, ctx)),
                  (15, lambda: phase_tools(results, ctx)),
                  (16, lambda: phase_profiling(results, ctx))])
    try:
        if 13 in phases and 1 not in phases:
            # Phase 13's meshes need the native library, built for this
            # machine.
            from cfd2_tpu_torch.mesh import native
            native.build(rebuild=True)
        for num in RUN_ORDER:
            if num in phases:
                t0 = time.time()
                steps[num]()
                log(f"# phase {num} done in {time.time() - t0:.1f} s")
    finally:
        _stop_meshes(ctx)
    for item in ctx.get("known_open", []):
        log(f"# KNOWN OPEN: {item}")
    if results:
        print(json.dumps({"kernels": list(results.values())}), flush=True)
    log(f"# all phases in {time.time() - t_all:.1f} s")
    if phases != ALL_PHASES:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
