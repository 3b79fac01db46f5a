"""The FGMRES solve's pieces, each timed as its own unit.

The port's counterpart of the JAX package's ``tools/prof_fgmres.py``, on the
channel from rest at ``min_cell`` (0.0017: 996,558 cells on 589x1765) with
the default ``SolverConfig``:

* ``launch`` / ``stream``: y = x + 1 on an (8, 128) tensor (the floor of one
  timed launch) and on (64, n) and (256, n) float32; the rate, bytes read
  and written over the device's busy time, is the card's measured memory
  rate, printed beside the 3.35 TB/s that PERF.md's bounds take;
* ``assemble`` / ``st_assemble``: the block-ELL and the stencil assembly;
* ``matvec`` / ``st_matvec``: ``block_spmv`` and the stencil system's
  (N, 3) SpMV;
* ``precond`` / ``st_precond``: the Schur preconditioner of the block
  system and of the stencil system, each with the structured V-cycle as its
  pressure solve (levels coarsened in every call, as the JAX tool's did);
* ``vcycle``: ``coarsen`` (level values and coarsest LU, once per
  assembly), ``vapply`` (one V-cycle) and ``pc_apply`` (the Schur
  preconditioner around it);
* ``cgs``: one classical Gram-Schmidt step as ``ops/fgmres.py`` takes it
  (the dots of the live rows ``V[:j+1]`` with w, then w minus their
  projection) at j = 8, 25 and 45, and over all m + 1 rows;
* ``fgmres30``: the solver's own assemble-and-solve with 30 forced
  iterations (tol 1e-12, restart 30, one cycle) and ``fgmres30id`` the same
  with the identity preconditioner: the per-iteration cost inside the loop.

Each is timed by :func:`.probes.time_phase`: the host's wall to a
``torch.cuda.synchronize()`` beside the device's busy time (the idle
share) and the hand kernels' launches per call.  ``only`` (the second
argument, comma-separated) picks pieces.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.prof_fgmres [min_cell] [pieces] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from . import probes
from .prof_layout import busy_or_wall

PIECES = ("stream", "assemble", "matvec", "precond", "vcycle", "cgs",
          "fgmres30", "fgmres30id")
HBM_TBS = 3.35   # the H100's memory rate that PERF.md's bounds take


def cgs_step(V, w, j: int):
    """One classical Gram-Schmidt step of ``ops/fgmres.py`` over the live
    rows ``V[:j+1]``: their dots with ``w`` and ``w`` minus the
    projection."""
    from ..ops.fgmres import _dots
    Vj = V[:j + 1]
    d = _dots(Vj, w)
    return d, w - torch.mv(Vj.T, d)


def run(min_cell: float = 0.0017, only=None, device=None, mesh=None,
        log=print) -> dict:
    """The pieces of ``only`` (default all; see the module docstring);
    returns the rows by piece and the two solves' iterations."""
    from ..models.assembly import assemble_coupled, assemble_stencil, prepare
    from ..models.coupled import _assemble_and_solve
    from ..ops import stencil_system as st
    from ..ops.amg import (_coarse_factors, build_hierarchy_for_mesh,
                           compute_structured_level_values2,
                           structured_v_cycle)
    from ..ops.blockell import block_spmv
    from ..ops.fgmres import fgmres_solve
    from ..ops.schur import schur_preconditioner
    from ..runtime.device_mesh import encode_mesh, resolve_device
    from ..runtime.state import SolverConfig, SolverParams, initial_state
    device = resolve_device(device)
    only = set(PIECES if only is None else only)
    unknown = only - set(PIECES)
    if unknown:
        raise ValueError(f"unknown pieces {sorted(unknown)}; pieces are "
                         f"{', '.join(PIECES)}")
    t0 = time.time()
    if mesh is None:
        mesh = probes.channel_mesh(min_cell)
    dm = encode_mesh(mesh, device)
    n = dm.num_cells
    log(f"# mesh {mesh.num_cells} cells -> device {n} (grid "
        f"{dm.grid_shape}) on {device} in {time.time() - t0:.1f}s")
    config = SolverConfig()
    params = SolverParams.default(dt=min(0.002, 0.4 * min_cell),
                                  device=device)
    u0 = np.zeros((mesh.num_cells, 2), np.float32)
    u0[mesh.cell_cx < min_cell * 2, 0] = 1.0
    state = prepare(dm, initial_state(dm, u0=u0), params, config)
    sys_ = assemble_coupled(dm, state, params, config)
    ss = assemble_stencil(dm, state, params, config)
    hier = build_hierarchy_for_mesh(dm)
    n_sweeps = config.pressure_sweeps(n)
    x3 = torch.cat([state.u, state.p[:, None]], dim=1)
    rows, iters = {}, {}

    def phase(label, fn, reps=10, warmup=2, prof_reps=None):
        out, row = probes.time_phase(label, fn, device, reps=reps,
                                     warmup=warmup, prof_reps=prof_reps,
                                     log=log)
        rows[label] = row
        return out

    if "stream" in only:
        tiny = torch.zeros((8, 128), device=device)
        phase("launch", lambda: tiny + 1.0, reps=20)
        for mult in (64, 256):
            big = torch.zeros((mult, n), device=device)
            phase(f"stream{mult}", lambda: big + 1.0)
            rate = (big.numel() * 4 * 2 / busy_or_wall(rows[f"stream{mult}"])
                    * 1e3 / 1e9)
            rows[f"stream{mult}"]["gbs"] = rate
            log(f"stream{mult}: {rate:.0f} GB/s read + write over the "
                f"device's busy time (the wall where that was not measured; "
                f"{HBM_TBS * 1e3:.0f} GB/s in PERF.md's bounds)")
    if "assemble" in only:
        phase("assemble", lambda: assemble_coupled(dm, state, params,
                                                   config), reps=5)
        phase("st_assemble", lambda: assemble_stencil(dm, state, params,
                                                      config), reps=5)
    if "matvec" in only:
        phase("matvec", lambda: block_spmv(sys_, dm, x3))
        phase("st_matvec", lambda: st.spmv(ss, x3))

    def grid_solve(ps2):
        """An (N,) pressure solve from one taking (ny, nx) grids."""
        return lambda rhs: ps2(rhs.reshape(ss.grid)).reshape(-1)

    if "precond" in only:
        phase("precond", lambda: schur_preconditioner(
            sys_, dm, x3, config.precond_omega, n_sweeps,
            pressure_solve=grid_solve(st.make_pressure_solve2(hier, ss))))
        phase("st_precond", lambda: st.schur_precond(
            ss, x3, config.precond_omega, n_sweeps,
            pressure_solve=st.make_pressure_solve2(hier, ss)))
    if "vcycle" in only:
        def coarsen():
            lv2 = compute_structured_level_values2(hier, ss.P_diag2,
                                                   ss.P_off2)
            return lv2, _coarse_factors(hier, lv2)
        lv2, fac = phase("coarsen", coarsen, reps=5)
        r = state.p.reshape(-1)
        phase("vapply", lambda: structured_v_cycle(
            hier, lv2, r, torch.zeros_like(r), coarse_factors=fac))

        def ps(rhs2):
            return structured_v_cycle(
                hier, lv2, rhs2.reshape(-1),
                (ss.diag_p_inv2 * rhs2).reshape(-1),
                coarse_factors=fac).reshape(ss.grid)
        phase("pc_apply", lambda: st.schur_precond(
            ss, x3, config.precond_omega, n_sweeps, pressure_solve=ps))
    if "cgs" in only:
        m = config.fgmres_restart
        D = n * 3
        V = torch.full((m + 1, D), 0.001, device=device)
        w0 = x3.reshape(-1) + 0.0
        for j in (8, 25, 45, m):
            label = "cgs full" if j == m else f"cgs j={j}"
            phase(label, lambda: cgs_step(V, w0, j))
            rows[label]["gbs"] = (2 * (j + 1) * D * 4
                                  / busy_or_wall(rows[label]) * 1e3 / 1e9)
        log("cgs effective GB/s over the device's busy time (the wall where "
            "that was not measured; the live rows read twice): " + ", ".join(
            f"{k} {v['gbs']:.0f}" for k, v in rows.items()
            if k.startswith("cgs")))
    if "fgmres30" in only:
        cfg30 = replace(config, fgmres_tol=1e-12, fgmres_abstol=1e-12,
                        fgmres_max_restarts=1, fgmres_restart=30)
        r30 = phase("fgmres30", lambda: _assemble_and_solve(
            dm, state, params, cfg30, hier, n_sweeps, None), reps=1,
            warmup=1)
        iters["fgmres30"] = int(r30.iterations)
    if "fgmres30id" in only:
        def solve30id():
            ss_ = assemble_stencil(dm, state, params, config)
            x0 = torch.cat([state.u, state.p[:, None]], dim=1)
            return fgmres_solve(lambda x: st.spmv(ss_, x), lambda r: r,
                                ss_.rhs, x0, restart=30, max_restarts=1,
                                tol=1e-12, abstol=1e-12)
        rid = phase("fgmres30id", solve30id, reps=3, warmup=1, prof_reps=1)
        iters["fgmres30id"] = int(rid.iterations)
    for k, it in iters.items():
        row = rows[k]
        log(f"{k}: {it} iterations -> {row['wall_ms'] / max(it, 1):.3f} "
            "ms/iteration wall" + ("" if row["device_ms"] is None else
                                   f", {row['device_ms'] / max(it, 1):.3f} "
                                   "device"))
    return dict(phases=rows, iterations=iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("min_cell", nargs="?", type=float, default=0.0017)
    ap.add_argument("only", nargs="?", default=None,
                    help="comma-separated pieces: " + ",".join(PIECES))
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.min_cell, None if a.only is None else a.only.split(","),
        a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
