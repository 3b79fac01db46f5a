"""Per-phase breakdown of a developed-state step on the banded path.

The port's counterpart of the JAX package's
``tools/prof_refined_developed.py``.  A developed step of an unstructured
mesh takes a few outers of 0-2 FGMRES iterations each, yet an outer costs
several times the structured path's; this tool pins down where a near-empty
outer's time goes: 3 heal steps and 5 timed fused steps (their outers),
then ``prepare``, ``assemble_ell``, the Galerkin level values, the coarsest
dense LU, 10 V-cycles, 10 preconditioner applications, 10 SpMVs and the
FGMRES solve from the developed state's own guess (5 calls: the per-outer
solve's cost when it exits at iteration 0-2).

The developed state is the one ``make_developed_unstructured`` writes
(``cfd2_tpu_torch/data/developed_<type>_<size>[-<max_cell>].npz``), loaded
by ``convert.load_developed_unstructured`` as ``chip_smoke.py`` phase 13
loads it: the state's time is the heal's end, so the inlet ramp carries on
(the JAX tool started it again at 0).  The repository holds the Delaunay
0.0019, Voronoi 0.00143 and refined cut-cell 0.0015 / 0.006 states (the
last the JAX tool's default, 129,663 cells on the banded layout in both
packages); another size raises until ``make_developed_unstructured`` has
made its state.  Each phase is timed by :func:`.probes.time_phase` (the
host's wall to a ``torch.cuda.synchronize()`` beside the device's busy
time, and the hand kernels' launches); nothing is subtracted.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.prof_refined_developed [type] [size] \\
        [max_cell] [--device cpu]
    python -m cfd2_tpu_torch.tools.prof_refined_developed delaunay 0.0019 0
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import torch

from . import probes
from .make_developed_unstructured import developed_path
from .prof_banded2 import banded_phases, loop


def developed_solver(mesh_type: str, size: float, max_cell: float, device,
                     mesh=None, state=None):
    """The heal's configuration (aggregation AMG, 5 restarts) on the
    developed state of (``mesh_type``, ``size``, ``max_cell``), or of the
    file ``state``; returns (solver, meta)."""
    from ..convert import load_developed_unstructured
    from ..models.coupled import CoupledSolver
    from .mesh_cache import get_mesh
    path = state or developed_path(mesh_type, size, max_cell)
    if not path.exists():
        raise FileNotFoundError(
            f"no developed state {path}: make it with python -m "
            "cfd2_tpu_torch.tools.make_developed_unstructured "
            f"{mesh_type} {size}" + (f" {max_cell}" if max_cell else ""))
    if mesh is None:
        mesh = get_mesh(mesh_type, size, max_cell=max_cell)
    s = CoupledSolver(mesh, device=device)
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5, stop_count=10**9)
    meta = load_developed_unstructured(s, path)
    s.set_dt(meta["dt"])
    return s, meta


def run(mesh_type: str = "cutcell", size: float = 0.0015,
        max_cell: float = 0.006, device=None, mesh=None, state=None,
        heal: int = 3, n_meas: int = 5, log=print) -> dict:
    """The tool's phases (see the module docstring); returns the rows, the
    timed steps' outers and the solve's (iterations, converged).
    ``mesh``: the host mesh, if the caller has it (else the cache's);
    ``state``: another developed state file."""
    from pathlib import Path

    from ..ops import ellsys as el
    from ..ops.amg import make_pressure_solve
    from ..ops.fgmres import fgmres_solve
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    s, meta = developed_solver(mesh_type, size, max_cell, device, mesh,
                               None if state is None else Path(state))
    dm = s.mesh
    hier = s._get_amg()
    log(f"# developed {mesh_type} {size}/{max_cell}: "
        f"{s.host_mesh.num_cells} cells K={dm.max_faces} on {device}")
    log(f"# AMG levels: {[lv.n for lv in hier.levels]}")
    t0 = time.time()
    for _ in range(heal):
        s.step()
    probes.sync(device)
    log(f"# heal: {time.time() - t0:.1f}s")
    outers = []
    t0 = time.perf_counter()
    for _ in range(n_meas):
        s.step()
        outers.append(int(s.state.outer_iters))
    probes.sync(device)
    wall = (time.perf_counter() - t0) / max(n_meas, 1)
    log(f"fused step: {wall * 1e3:.1f} ms outers={outers}")

    config, params = s.config, s.params
    state_p, es, rows = banded_phases(s, log)

    def phase(label, fn, n=3, per=10):
        out, row = probes.time_phase(label, fn, device, reps=n, per=per,
                                     log=log)
        rows.append(row)
        return out

    n_sweeps = config.pressure_sweeps(dm.num_cells)
    ps = make_pressure_solve(hier, dm, es,
                             coeff=params.density * state_p.d_p,
                             cycle_opts=config.cycle_opts())
    x = s.state.u[:, 0].contiguous()
    r3 = torch.stack([x, x * 0.5, x * 0.25], dim=0)
    ms_n = config.precond_mom_sweeps if config.precond_mom_sweeps > 0 else 8
    phase("v-cycle (x10, per call)", lambda: loop(ps, x))
    phase(f"precond m{ms_n} (x10, per call)", lambda: loop(
        lambda r: el.schur_precond(es, dm, r, config.precond_omega,
                                   n_sweeps, pressure_solve=ps,
                                   mom_sweeps=ms_n), r3))
    phase("spmv (x10, per call)", lambda: loop(
        lambda r: el.spmv(es, dm, r), r3))
    x0 = torch.cat([state_p.u, state_p.p[:, None]], dim=1).T.contiguous()
    rhs = es.rhs.T.contiguous()
    res = phase("fgmres-from-developed-guess", lambda: fgmres_solve(
        lambda xx: el.spmv(es, dm, xx),
        lambda rr: el.schur_precond(es, dm, rr, config.precond_omega,
                                    n_sweeps, pressure_solve=ps,
                                    mom_sweeps=ms_n),
        rhs, x0, restart=config.fgmres_restart,
        max_restarts=config.fgmres_max_restarts, tol=config.fgmres_tol,
        abstol=config.fgmres_abstol,
        stagnation_tol=config.fgmres_stagnation_tol,
        stagnation_limit=config.fgmres_stagnation_limit), n=5, per=1)
    it = int(res.iterations)
    log(f"fgmres-from-developed-guess: iters={it} "
        f"conv={bool(res.converged)}")
    return dict(phases=rows, outers=outers, solve=(it, bool(res.converged)),
                cells=s.host_mesh.num_cells)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mesh_type", nargs="?", default="cutcell",
                    choices=("cutcell", "delaunay", "voronoi"))
    ap.add_argument("size", nargs="?", type=float, default=0.0015)
    ap.add_argument("max_cell", nargs="?", type=float, default=0.006)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.mesh_type, a.size, a.max_cell, a.device,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
