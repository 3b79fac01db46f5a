#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cfd2_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit; build every CUDA kernel from
   ``cfd2_tpu_torch/csrc`` (one ``nvcc`` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card (max-abs
   error <= 1e-5 on O(1) random data) on small grids and on every level grid
   of the 589x1765 multigrid hierarchy, and time both at 589x1765;
3. drive the main path: the 996,558-cell channel-obstacle mesh
   (min_cell=0.0017, 589x1765 grid), ``CoupledSolver`` with the structured
   multigrid (precond_type=1, fgmres_max_restarts=5), started from
   ``bench_developed_1m.npz``: 3 untimed healing steps, then 3 timed steps;
4. the half-sweep path (CFD2_PALLAS=1) on a ~30k-cell mesh for 2 steps;
5. one step of a ~5k-cell mesh on the card (kernels) and on the CPU (plain
   versions): equal outer iterations, u within 1e-4 * max|u|;
6. print the kernels' JSON line, then the result line.

``--phases 1,2`` runs only the listed phases (for bring-up); the result line
is printed only when every phase ran.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
MAIN_GRID = (589, 1765)
MAIN_CELLS = 996_558


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
        ny, nx = (ny + 1) // 2, (nx + 1) // 2
    return grids, (ny, nx)


def cuda_time_ms(fn, reps=50):
    """Mean device time of ``fn`` per call in ms, from CUDA events around
    each call, with the 50 MB L2 cache flushed before every call (the
    V-cycle finds its level-0 planes cold: FGMRES streams the basis between
    applications)."""
    import torch
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def bound_ms(n_bytes, n_flops):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_flops / F32_FLOPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ----------------------------------------------------------------------


def phase_build():
    from cfd2_tpu_torch.ops import _build
    t0 = time.time()
    outs = _build.build_all(extra_flags=("-Xptxas", "-v"))
    for name, out in outs.items():
        log(f"# nvcc csrc/{name}.cu:\n{out.strip()}")
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


def phase_kernels(results):
    """Each kernel against its plain version on the card; times at the
    main path's finest grid."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk

    grids, _ = level_grids(*MAIN_GRID)
    cases = [(37, 53), (16, 24), (300, 128)] + grids
    err_leg = err_half = 0.0
    before = dict(sk.LAUNCHES)
    for ci, (ny, nx) in enumerate(cases):
        diag2, off2, x, b = _grid_system(ny, nx, ci, "cuda")
        for sweeps in (1, 2):
            for residual in (True, False):
                got = sk.rbgs_leg(x, diag2, off2, b, sweeps, residual)
                ref = sk.rbgs_leg_ref(x, diag2, off2, b, sweeps, residual)
                got = got if residual else (got,)
                ref = ref if residual else (ref,)
                for g, r in zip(got, ref):
                    err_leg = max(err_leg, float((g - r).abs().max()))
        off_flat = off2.reshape(4, -1).T.contiguous()
        for parity in (0, 1):
            args = (x.reshape(-1), diag2.reshape(-1), off_flat,
                    b.reshape(-1), parity, (ny, nx))
            got = sk.rbgs_half_sweep(*args)
            ref = sk.rbgs_half_sweep_ref(*args)
            err_half = max(err_half, float((got - ref).abs().max()))
    torch.cuda.synchronize()
    log(f"phase 2: {len(cases)} grids; max-abs error leg {err_leg:.3e}, "
        f"half-sweep {err_half:.3e} (tolerance {TOL:g})")
    check(err_leg <= TOL, f"rbgs_leg disagrees with its plain version: "
          f"{err_leg:.3e}")
    check(err_half <= TOL, f"rbgs_half_sweep disagrees with its plain "
          f"version: {err_half:.3e}")

    ny, nx = MAIN_GRID
    n = ny * nx
    diag2, off2, x, b = _grid_system(ny, nx, 99, "cuda")
    leg_ms = cuda_time_ms(lambda: sk.rbgs_leg(x, diag2, off2, b, 1, True))
    leg_plain = cuda_time_ms(
        lambda: sk.rbgs_leg_ref(x, diag2, off2, b, 1, True))
    # Down leg at sweeps=1: reads x, diag, 4 off planes, b; writes x, r.
    # Flops per cell: 2 half-sweeps x 9 on half the cells + 1 reciprocal +
    # 10 for the residual.
    leg_bound, leg_by = bound_ms(9 * 4 * n, 20 * n)
    off_flat = off2.reshape(4, -1).T.contiguous()
    hargs = (x.reshape(-1), diag2.reshape(-1), off_flat, b.reshape(-1), 0,
             (ny, nx))
    half_ms = cuda_time_ms(lambda: sk.rbgs_half_sweep(*hargs))
    half_plain = cuda_time_ms(lambda: sk.rbgs_half_sweep_ref(*hargs))
    # Reads x, diag, off (n, 4), b; writes x.  Half the cells do 10 flops.
    half_bound, half_by = bound_ms(8 * 4 * n, 5 * n)
    # Launches made for these comparisons are not the main path's.
    sk.LAUNCHES.update(before)
    results["rbgs_leg"] = dict(
        name="rbgs_leg", route="cuda", source="cfd2_tpu_torch/csrc/rbgs.cu",
        replaces="cfd2_tpu/ops/pallas_stencil.py:264", launches=0,
        max_abs_err=err_leg, ms=leg_ms, plain_ms=leg_plain,
        bound_ms=leg_bound, bound_by=leg_by, library_ms=None)
    results["rbgs_half_sweep"] = dict(
        name="rbgs_half_sweep", route="cuda",
        source="cfd2_tpu_torch/csrc/rbgs.cu",
        replaces="cfd2_tpu/ops/pallas_stencil.py:97", launches=0,
        max_abs_err=err_half, ms=half_ms, plain_ms=half_plain,
        bound_ms=half_bound, bound_by=half_by, library_ms=None)
    log(f"phase 2: rbgs_leg at {ny}x{nx} (sweeps=1, residual): "
        f"{leg_ms:.4f} ms, bound {leg_bound:.4f} ms ({leg_by}), plain "
        f"{leg_plain:.4f} ms")
    log(f"phase 2: rbgs_half_sweep at {ny}x{nx}: {half_ms:.4f} ms, bound "
        f"{half_bound:.4f} ms ({half_by}), plain {half_plain:.4f} ms")


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


def phase_main(results):
    import torch
    from cfd2_tpu_torch.convert import load_developed_state
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.runtime import host_reads

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
    meta = load_developed_state(s, ROOT / "bench_developed_1m.npz")
    torch.cuda.synchronize()
    log(f"phase 3: solver set-up {time.time() - t0:.1f} s; "
        f"{len(grids)} smoothed levels, coarsest {coarsest}; "
        f"viscosity {meta['viscosity']}")

    n = mesh.num_cells
    sk.reset_launches()
    lin_total = 0
    for i in range(6):
        host_reads.reset()
        before = dict(sk.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = s.state
        outer = int(st.outer_iters)
        lins = int(st.linear_iters_total)
        lin_total += lins
        step_launch = {k: v - before[k] for k, v in sk.LAUNCHES.items()}
        kind = "heal" if i < 3 else "timed"
        log(f"phase 3: {kind} step {i}: wall {wall:.4f} s, outer_iters "
            f"{outer}, linear_iters_total {lins}, cell-updates/s "
            f"{n / wall:.1f}, host reads {host_reads.COUNT['reads']}, "
            f"launches {step_launch}")
        check(_finite(s), f"non-finite fields after step {i}")
    leg = sk.LAUNCHES["rbgs_leg"]
    results["rbgs_leg"]["launches"] = leg
    check(leg > 0, "rbgs_leg was never launched on the main path")
    per_apply = 2 * len(grids)
    check(leg == per_apply * lin_total,
          f"rbgs_leg launches {leg} != {per_apply} per preconditioner "
          f"application x {lin_total} applications")
    log(f"phase 3: rbgs_leg launches {leg} = {per_apply} per V-cycle x "
        f"{lin_total} FGMRES iterations; rbgs_half_sweep "
        f"{sk.LAUNCHES['rbgs_half_sweep']}")


def phase_half_sweep(results):
    from cfd2_tpu_torch.ops import stencil_kernels as sk

    mesh = _channel(0.01)
    s = _solver(mesh, 0.01, None)
    old = os.environ.get("CFD2_PALLAS")
    os.environ["CFD2_PALLAS"] = "1"
    try:
        sk.reset_launches()
        for _ in range(2):
            s.step()
        counts = dict(sk.LAUNCHES)
    finally:
        if old is None:
            os.environ.pop("CFD2_PALLAS")
        else:
            os.environ["CFD2_PALLAS"] = old
    results["rbgs_half_sweep"]["launches"] = counts["rbgs_half_sweep"]
    log(f"phase 4: {mesh.num_cells} cells, 2 steps with CFD2_PALLAS=1: "
        f"outer_iters {int(s.state.outer_iters)}, launches {counts}")
    check(counts["rbgs_half_sweep"] > 0,
          "rbgs_half_sweep was never launched on the CFD2_PALLAS=1 path")
    check(counts["rbgs_leg"] == 0, "rbgs_leg ran on the CFD2_PALLAS=1 path")
    check(_finite(s), "non-finite fields on the half-sweep path")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 basis dots

    log(card_line())
    results = {}
    t_all = time.time()
    steps = [(1, phase_build), (2, lambda: phase_kernels(results)),
             (3, lambda: phase_main(results)),
             (4, lambda: phase_half_sweep(results)),
             (5, phase_cpu_match)]
    for num, fn in steps:
        if num in phases:
            t0 = time.time()
            fn()
            log(f"# phase {num} done in {time.time() - t0:.1f} s")
    log(f"# all phases in {time.time() - t_all:.1f} s")
    if results:
        print(json.dumps({"kernels": list(results.values())}), flush=True)
    if phases != {1, 2, 3, 4, 5}:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
