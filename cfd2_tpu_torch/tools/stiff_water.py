"""Water on the backwards step: the reference's stiffest regression, on the
port.

The counterpart of the JAX package's ``tools/stiff_water_tpu.py``, with the
configuration of the reference's ``reproduce_divergence.rs``: the backwards
step 3.5 x 1.0 (inlet height 0.5, step at x = 0.5) meshed at h = 0.01 and
smoothed (``mesh.smooth(geo, 0.3, 50)``: 32,500 cells, still on the 100 x 350
structured layout), rho = 1000, nu = 0.001, dt = 0.001, alpha_u = 0.7,
alpha_p = 0.3, the multigrid pressure block (``precond_type=1``), u = (0.1, 0)
everywhere; 50 steps, each asserting a finite outer residual below 1e10, in
float32 as the reference's GPU runs it.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.stiff_water [h] [steps] [--device cpu]

Writes ``cfd2_tpu_torch/data/stiff_water_card.json`` (the card's name and
power limit in it).  ``STIFF_X64.json`` (the JAX package in float64 on a
CPU) has max|u| 0.386558 after the 50 steps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from .records import DATA, card_line

OUT = DATA / "stiff_water_card.json"


def make_mesh(h: float):
    from ..mesh import BackwardsStep, generate_cut_cell_mesh
    geo = BackwardsStep(length=3.5, height_inlet=0.5, height_outlet=1.0,
                        step_x=0.5)
    mesh = generate_cut_cell_mesh(geo, h, h, 1.2, (3.5, 1.0))
    mesh.smooth(geo, 0.3, 50)
    return mesh


def make_solver(mesh, device=None):
    from ..models.coupled import CoupledSolver
    s = CoupledSolver(mesh, device=device)
    s.set_dt(0.001)
    s.set_density(1000.0)
    s.set_viscosity(0.001)
    s.set_alpha_u(0.7)
    s.set_alpha_p(0.3)
    s.set_precond_type(1)
    s.set_u(np.full((mesh.num_cells, 2), [0.1, 0.0]))
    return s


def run(h: float = 0.01, steps: int = 50, device=None, out=OUT,
        log=print, solver=None) -> dict:
    """The stiff case; returns (and writes to ``out``) its record, with
    each step's outers, FGMRES iterations per outer, max|u|, max|p| and
    outer residual (``per_step``).  ``solver``: one :func:`make_solver` set
    up on ``make_mesh(h)``, stepped in place (else one is made on
    ``device``)."""
    from ..runtime.device_mesh import resolve_device
    from .developed_cases import run_steps
    t0 = time.time()
    if solver is None:
        device = resolve_device(device)
        s = make_solver(make_mesh(h), device)
    else:
        s, device = solver, solver.device
    mesh = s.host_mesh
    layout = (f"structured {tuple(s.mesh.grid_shape)}" if s.mesh.grid_shape
              else "banded" if s.mesh.banded else "generic")
    log(f"# mesh h={h}: {mesh.num_cells} cells, layout {layout} "
        f"({time.time() - t0:.0f}s) on {device}")
    t0 = time.time()
    rows = []
    for i in range(steps):
        row = run_steps(s, 1)[0]     # raises on fields that are not finite
        r = float(s.state.outer_residual_u)
        if not np.isfinite(r):
            raise FloatingPointError(f"NaN residual at step {i}")
        if r >= 1e10:
            raise FloatingPointError(f"residual blow-up at step {i}: {r}")
        row["outer_residual_u"] = r
        rows.append(row)
        if (i + 1) % 10 == 0:
            log(f"# step {i + 1}/{steps}  resid_u={r:.3e}  "
                f"({time.time() - t0:.0f}s)")
    u = s.get_u()
    rec = {"case": "water backwards-step (reproduce_divergence.rs config)",
           "device": str(device), "card": card_line(device), "h": h,
           "cells": int(mesh.num_cells), "layout": layout, "steps": steps,
           "density": 1000.0, "viscosity": 0.001, "dtype": "float32",
           "finite": all(r["finite"] for r in rows),
           "max_outer_residual_u": max(
               (r["outer_residual_u"] for r in rows), default=0.0),
           "max_vel": float(np.linalg.norm(u, axis=1).max()),
           "wall_s": round(time.time() - t0, 1), "per_step": rows}
    log(json.dumps({k: v for k, v in rec.items() if k != "per_step"}))
    return write_record(rec, out)


def write_record(rec: dict, out) -> dict:
    """Write ``rec`` to ``out`` as indented JSON (nothing when ``out`` is
    None); returns ``rec``."""
    if out:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1) + "\n")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("h", nargs="?", type=float, default=0.01)
    ap.add_argument("steps", nargs="?", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.h, a.steps, a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
