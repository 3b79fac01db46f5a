"""Probe: the lid-driven cavity at Re = 100 against Ghia et al. (1982),
Table I, at a free resolution, dt and step count.

The port's counterpart of the JAX package's ``tools/probe_cavity.py`` (the
tool that tuned ``tests/test_physics.py::test_lid_driven_cavity``): the
unit square meshed at h, the top wall moving at 1, viscosity 0.01, density
1, no inlet ramp; u through the vertical centreline x = 0.5 (the two cell
columns straddling it averaged per row) interpolated at Ghia's points.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.probe_cavity [h] [dt] [steps] \\
        [--device cpu]

(defaults 1/48, 0.25, 80).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# Ghia, Ghia & Shin (1982), Re=100: u through the geometric centre x=0.5.
GHIA_Y = np.array([0.0547, 0.1016, 0.1719, 0.2813, 0.4531, 0.5000,
                   0.6172, 0.7344, 0.8516, 0.9531, 0.9766])
GHIA_U = np.array([-0.03717, -0.06434, -0.10150, -0.15662, -0.21090,
                   -0.20581, -0.13641, 0.00332, 0.23151, 0.68717, 0.84123])


def make_solver(h: float, dt: float, device=None):
    """The cavity's host mesh and its solver on ``device``."""
    from ..mesh import (RectangularChannel, generate_cut_cell_mesh,
                        retag_lid_cavity)
    from ..models.coupled import CoupledSolver
    mesh = generate_cut_cell_mesh(RectangularChannel(length=1.0, height=1.0),
                                  h, h, 1.2, (1.0, 1.0))
    retag_lid_cavity(mesh, (1.0, 1.0))
    s = CoupledSolver(mesh, device=device)
    s.set_viscosity(0.01)   # Re = U*L/nu = 100
    s.set_density(1.0)
    s.set_inlet_velocity(1.0)
    s.set_ramp_time(0.0)
    s.set_dt(dt)
    return mesh, s


def centreline(mesh, u, h: float) -> np.ndarray:
    """u at Ghia's points: the cell columns within 0.75 h of x = 0.5
    averaged per grid row, then interpolated linearly in y."""
    col = np.abs(mesh.cell_cx - 0.5) < 0.75 * h
    yr = np.round(mesh.cell_cy[col] / h - 0.5).astype(int)
    rows = np.unique(yr)
    y = np.array([mesh.cell_cy[col][yr == j].mean() for j in rows])
    ux = np.array([u[col, 0][yr == j].mean() for j in rows])
    return np.interp(GHIA_Y, y, ux)


def run(h: float = 1.0 / 48, dt: float = 0.25, steps: int = 80, device=None,
        log=print) -> dict:
    """The probe: cells, the steps taken (fewer where the solver stops),
    u at Ghia's points, the max and rms error against Ghia, the wall."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    mesh, s = make_solver(h, dt, device)
    log(f"cells={mesh.num_cells} on {device}")
    t0 = time.time()
    taken = steps
    for i in range(steps):
        s.step()
        if s.should_stop:
            log(f"should_stop at {i}")
            taken = i + 1
            break
        if (i + 1) % 20 == 0:
            u = s.get_u()
            log(f"step {i + 1}  t={time.time() - t0:.1f}s  "
                f"max|u|={np.abs(u).max():.4f}")
    ui = centreline(mesh, s.get_u(), h)
    err = np.abs(ui - GHIA_U)
    for yy, g, m in zip(GHIA_Y, GHIA_U, ui):
        log(f"y={yy:.4f}  ghia={g:+.5f}  ours={m:+.5f}  d={m - g:+.5f}")
    wall = time.time() - t0
    log(f"max_err={err.max():.4f}  rms={np.sqrt((err ** 2).mean()):.4f}  "
        f"wall={wall:.1f}s")
    return dict(cells=int(mesh.num_cells), steps=taken, ui=ui,
                max_err=float(err.max()),
                rms=float(np.sqrt((err ** 2).mean())), wall_s=wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("h", nargs="?", type=float, default=1.0 / 48)
    ap.add_argument("dt", nargs="?", type=float, default=0.25)
    ap.add_argument("steps", nargs="?", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.h, a.dt, a.steps, a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
