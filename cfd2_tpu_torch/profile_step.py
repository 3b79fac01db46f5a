"""Where one main-path step's time goes on the GPU.

Builds a main path as ``chip_smoke.py`` does, then traces ``--steps`` steps
with ``torch.profiler``.  ``--mesh cutcell`` (default): the 996,558-cell
channel mesh, structured multigrid, the developed state from
``bench_developed_1m.npz``, 3 untimed healing steps.  ``--mesh delaunay`` /
``--mesh voronoi``: the unstructured banded path from rest at ``--min-cell``
(default 0.003: the 403,491-cell Delaunay mesh), aggregation AMG, 2 untimed
warm-up steps; ``--mesh refined``: the refined quadtree mesh from
``--min-cell`` to ``--max-cell`` (the multilevel layout at 0.0025 / 0.005),
from rest the same way.  ``--case NAME``: a case of
``tools/developed_cases.py`` (for example ``delaunay_1m_developed``), set up
from its table, after its uncounted heal steps (at least one warm-up
step).  Prints:

* per step: wall time, outer and FGMRES iterations, host reads, launches;
* device busy time (the union of kernel intervals) against wall time, i.e.
  the device's idle share;
* device time per kernel name, largest first, grouped by what issues it.

Run from the repository root on a machine with a CUDA device:

    python -m cfd2_tpu_torch.profile_step [--steps 2]
    python -m cfd2_tpu_torch.profile_step --mesh delaunay --min-cell 0.003
    python -m cfd2_tpu_torch.profile_step --mesh refined --min-cell 0.0025 \
        --max-cell 0.005
    python -m cfd2_tpu_torch.profile_step --case structured_2m_developed
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from . import (ChannelWithObstacle, CoupledSolver, generate_cut_cell_mesh,
               generate_delaunay_mesh, generate_voronoi_mesh)
from .convert import load_developed_state
from .ops import banded_kernels as bk
from .ops import stencil_kernels as sk
from .runtime import host_reads
from .tools import developed_cases as dc

ROOT = Path(__file__).resolve().parent.parent
MIN_CELL = 0.0017   # the main path's mesh: 996,558 cells on 589x1765

# Kernel-name fragments -> the code that issues them.
_GROUPS = (
    ("coupled_spmv_kernel", "coupled_spmv (CUDA, matvec)"),
    ("momentum_stream_kernel", "momentum_jacobi (CUDA, momentum predict)"),
    ("momentum_kernel", "momentum_jacobi (CUDA, momentum predict)"),
    ("schur_rhs_kernel", "schur_rhs (CUDA)"),
    ("pressure_gradient_kernel", "pressure_gradient (CUDA)"),
    ("rbgs_leg_kernel", "rbgs_leg (CUDA, V-cycle smoother)"),
    ("rbgs_leg_staged_kernel", "rbgs_leg (CUDA, V-cycle smoother)"),
    ("rbgs_half_sweep", "rbgs_half_sweep (CUDA)"),
    ("banded_gather_kernel", "banded_gather (CUDA)"),
    ("banded_prolong_add_kernel",
     "banded_gather (CUDA, fused V-cycle prolongation)"),
    ("banded_dot_kernel", "banded_dot (CUDA)"),
    ("jacobi_sweeps", "banded_jacobi_sweeps (CUDA, one launch)"),
    ("index", "indexing (field IO in host order, views)"),
    ("gemv", "Gram-Schmidt / solution update (gemv)"),
    ("gemm", "Gram-Schmidt / solution update (gemm)"),
    ("dot_kernel", "Gram-Schmidt / solution update (gemv)"),
    ("CatArrayBatchedCopy", "edge-clamped shifts (torch.cat)"),
    ("reduce_kernel", "reductions (norms, max-diffs, slot sums)"),
    ("getrs", "coarsest dense LU solve"),
    ("getrf", "coarsest dense LU factor"),
    ("trsm", "coarsest dense LU solve"),
    ("laswp", "coarsest dense LU solve"),
    ("elementwise", "elementwise stencil arithmetic"),
    ("copy", "copies"),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for frag, label in _GROUPS:
        if frag.lower() in low:
            return label
    return "other"


def busy_us(events) -> float:
    """Union length of [start, end) device intervals, in microseconds."""
    return union_length((e.time_range.start, e.time_range.end)
                        for e in events)


def union_length(intervals) -> float:
    """Union length of [start, end) intervals, in their unit."""
    iv = sorted(intervals)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _structured_main_path(geo):
    mesh = generate_cut_cell_mesh(geo, MIN_CELL, MIN_CELL, 1.2, (3.0, 1.0))
    s = CoupledSolver(mesh)
    s.set_dt(min(0.002, 0.4 * MIN_CELL))
    s.set_viscosity(0.01)
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5)
    load_developed_state(s, ROOT / "bench_developed_1m.npz")
    return mesh, s, 3


def _unstructured_main_path(geo, kind, min_cell, max_cell):
    gen = {"delaunay": generate_delaunay_mesh,
           "voronoi": generate_voronoi_mesh,
           "refined": generate_cut_cell_mesh}[kind]
    mesh = gen(geo, min_cell, max_cell, 1.2, (3.0, 1.0))
    s = CoupledSolver(mesh)
    s.set_dt(min(0.002, 0.4 * min_cell))
    s.set_precond_type(1)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < min_cell * 2, 0] = 1.0
    s.set_u(u0)
    return mesh, s, 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--mesh", choices=("cutcell", "delaunay", "voronoi",
                                       "refined"), default="cutcell")
    ap.add_argument("--min-cell", type=float, default=0.003,
                    help="cell size of the unstructured meshes")
    ap.add_argument("--max-cell", type=float, default=None,
                    help="largest cell size (default --min-cell)")
    ap.add_argument("--case", choices=sorted(dc.CASES), default=None,
                    help="a full-size case of tools/developed_cases.py "
                    "(overrides --mesh)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)

    geo = ChannelWithObstacle(length=3.0, height=1.0,
                              obstacle_center=(1.0, 0.5), obstacle_radius=0.2)
    if args.case is not None:
        case = dc.CASES[args.case]
        mesh = dc.case_mesh(case)
        s, _ = dc.make_solver(case, mesh=mesh)
        warm = max(case.heal_steps, 1)
        args.mesh = args.case
    elif args.mesh == "cutcell":
        mesh, s, warm = _structured_main_path(geo)
    else:
        mesh, s, warm = _unstructured_main_path(
            geo, args.mesh, args.min_cell, args.max_cell or args.min_cell)
    print(f"{args.mesh}: {mesh.num_cells} cells, N_dev {s.mesh.num_cells}, "
          f"K {s.mesh.max_faces}", flush=True)
    for _ in range(warm):
        s.step()
    torch.cuda.synchronize()

    n = mesh.num_cells
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    rows = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            host_reads.reset()
            sk.reset_launches()
            bk.reset_launches()
            t = time.perf_counter()
            s.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            rows.append(dict(wall_s=wall,
                             outer_iters=int(s.state.outer_iters),
                             linear_iters_total=int(
                                 s.state.linear_iters_total),
                             host_reads=host_reads.COUNT["reads"],
                             launches={**sk.LAUNCHES, **bk.LAUNCHES}))
        window = time.perf_counter() - t0
    for i, r in enumerate(rows):
        r["cell_updates_per_s"] = n / r["wall_s"]
        print(f"step {i}: {json.dumps(r)}", flush=True)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us(kernels) * 1e-6
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    by_group = defaultdict(lambda: [0.0, 0])
    for name, (us, cnt) in by_name.items():
        g = by_group[kernel_group(name)]
        g[0] += us
        g[1] += cnt
    n_lin = sum(r["linear_iters_total"] for r in rows)
    print(f"window {window:.4f} s over {args.steps} steps, "
          f"{len(kernels)} kernels ({len(kernels) / max(n_lin, 1):.1f} per "
          f"FGMRES iteration), device busy {busy:.4f} s, idle share "
          f"{1 - busy / window:.4f}", flush=True)
    print("device time by group (ms, launches):")
    for label, (us, cnt) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3:10.3f} ms {cnt:8d}  {label}")
    print("top kernels (ms, launches, mean us):")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    for name, (us, cnt) in top:
        print(f"  {us / 1e3:10.3f} ms {cnt:8d} {us / cnt:9.2f}  {name[:110]}")
    summary = dict(window_s=window, device_busy_s=busy,
                   idle_share=1 - busy / window, kernels=len(kernels),
                   steps=rows, cells=n,
                   device=torch.cuda.get_device_name(0))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
