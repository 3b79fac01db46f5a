"""Schäfer–Turek 2D-2 on the port: Cd_max, Cl_max and St of the unsteady
cylinder benchmark against the published intervals.

The counterpart of the JAX package's ``tools/validate_turek.py``, with its
configuration (Schäfer & Turek 1996, case 2D-2): the 2.2 x 0.41 channel with
a D = 0.1 cylinder at (0.2, 0.2), the parabolic inlet 6 y (H - y) / H^2
(mean 1, peak 1.5) through ``set_inlet_profile``, nu = 0.001, rho = 1, so
Re = 100; a 0.5 s inlet ramp, second-order upwind (scheme 1), BDF2, the
multigrid pressure block (``precond_type=1``), and dt = h / 6 with
``dt_old`` pinned to dt (the JAX tool's scan bypasses the ``dt_old``
rotation of ``CoupledSolver.step``; :func:`run_chunk` calls the module-level
``step`` for the same reason).  ``stop_count`` keeps its default: a run that
freezes in the symmetric start-up gives St = 0.

Per step the force on the cylinder, ``body_force / q``, is written into a
preallocated (n, 2) device tensor, read by the host once per 200-step chunk.
Published intervals: Cd_max [3.22, 3.24], Cl_max [0.99, 1.01] (the JAX tool
checks [0.98, 1.02]), St [0.295, 0.305].

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.validate_turek [h] [t_end] [t_measure] \\
        [scheme] [h_from] [--device cpu]

    h          uniform cell size (0.005: D/h = 20, 35,804 cells)
    t_end      simulated seconds (30; the start-up takes ~15-20 s)
    t_measure  measurement window at the end (6 s, ~18 periods)
    scheme     0 upwind / 1 second-order upwind / 2 QUICK
    h_from     warm start from ``.bench_cache/turek_torch_{h_from}.npz``
               (the JAX tool's ``turek_{h}.npz`` has the same format):
               linear scattered-data interpolation of u and p at this mesh's
               cell centres, nearest-neighbour where outside the hull

Appends one row to ``cfd2_tpu_torch/data/turek_card.jsonl`` (the card's name
and power limit in it); saves the developed field to
``.bench_cache/turek_torch_{h}.npz`` in the JAX tool's format (f16 u and p,
cx, cy, t), and the state at the start of the measurement window to
``cfd2_tpu_torch/data/turek_window_{h}.npz``
(``developed_cases.save_step_input``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from .mesh_cache import CACHE
from .records import DATA, append_row, card_line

H = 0.41          # channel height
L = 2.2           # channel length
D = 0.1           # cylinder diameter
CENTER = (0.2, 0.2)
U_BAR = 1.0       # mean inlet velocity (the coefficients' reference)
NU = 0.001
RAMP = 0.5
INTERVALS = {"cd_max": (3.22, 3.24), "cl_max": (0.98, 1.02),
             "st": (0.295, 0.305)}
CHUNK = 200
RECORD = DATA / "turek_card.jsonl"


def cache_path(h: float) -> Path:
    """The port's developed field of the rung at ``h``."""
    return CACHE / f"turek_torch_{h}.npz"


def window_path(h: float) -> Path:
    return DATA / f"turek_window_{h}.npz"


def inlet_profile(x, y):
    """The benchmark's parabola normalised to mean 1 (peak 1.5 = U_m)."""
    return 6.0 * y * (H - y) / H ** 2


def make_mesh(h: float):
    from ..mesh import ChannelWithObstacle, generate_cut_cell_mesh
    geo = ChannelWithObstacle(length=L, height=H, obstacle_center=CENTER,
                              obstacle_radius=D / 2.0)
    return generate_cut_cell_mesh(geo, h, h, 1.2, (L, H))


def make_solver(mesh, h: float, scheme: int = 1, device=None):
    """A CoupledSolver in the benchmark's configuration, at rest."""
    from ..models.coupled import CoupledSolver
    from ..runtime.state import TIME_BDF2
    s = CoupledSolver(mesh, device=device)
    s.set_viscosity(NU)
    s.set_density(1.0)
    s.set_inlet_velocity(U_BAR)
    s.set_inlet_profile(inlet_profile)
    s.set_ramp_time(RAMP)
    s.set_scheme(scheme)
    s.set_time_scheme(TIME_BDF2)
    s.set_precond_type(1)
    s.set_dt(h / 6.0)   # peak cell velocity ~2.1: CFL ~0.35
    s.params = replace(s.params, dt_old=s.params.dt)
    return s


def interpolate(src_xy: np.ndarray, vals: np.ndarray,
                tgt_xy: np.ndarray) -> np.ndarray:
    """Linear scattered-data interpolation of ``vals`` (at ``src_xy``) at
    ``tgt_xy``, the nearest source value outside the source's hull."""
    from scipy.interpolate import griddata
    vals = vals.astype(np.float32)
    lin = griddata(src_xy, vals, tgt_xy, method="linear")
    near = griddata(src_xy, vals, tgt_xy, method="nearest")
    return np.where(np.isfinite(lin), lin, near)


def warm_start(s, mesh, path) -> float:
    """Start ``s`` from a saved developed field (either package's rung
    file): u and p interpolated at ``mesh``'s cell centres, the history set
    to u, the inlet at full strength.  Returns the source's time."""
    with np.load(path) as src:
        pts = np.stack([src["cx"], src["cy"]], axis=1)
        u, p, t = src["u"], src["p"], float(src["t"])
    tgt = np.stack([np.asarray(mesh.cell_cx), np.asarray(mesh.cell_cy)],
                   axis=1)
    s.set_u(np.stack([interpolate(pts, u[:, 0], tgt),
                      interpolate(pts, u[:, 1], tgt)], axis=1))
    s.set_p(interpolate(pts, p, tgt))
    s.initialize_history()
    s.set_ramp_time(1e-9)
    return t


def force_scale() -> float:
    """q: the dynamic pressure times D."""
    return 0.5 * 1.0 * U_BAR ** 2 * D


def run_chunk(s, mask, n: int, out):
    """``n`` steps of ``s`` through the module-level ``step`` (none once
    ``should_stop`` is set), ``body_force / q`` after each into the first
    ``n`` rows of ``out`` ((CHUNK, 2) on the solver's device); ``dt_old``
    stays pinned.  Returns the forces as a host array of their own (one
    read; on the CPU ``out`` itself would be shared)."""
    from ..models.coupled import step
    from ..runtime.host_reads import read
    from ..utils.forces import body_force
    q = force_scale()
    amg = s._get_amg()
    for i in range(n):
        if not bool(read(s.state.should_stop)):
            s.state = step(s.mesh, s.state, s.params, s.config, amg)
        out[i] = body_force(s.mesh, s.state, s.params, mask) / q
    return out[:n].cpu().numpy().copy()


def summary(cd: np.ndarray, cl: np.ndarray, dt: float, n_meas: int) -> dict:
    """Cd_max, Cd_mean, Cl_max, Cl_min and St over the last ``n_meas``
    samples, and whether each lies in the published interval."""
    from ..utils.forces import strouhal_number
    cdm, clm = cd[-n_meas:], cl[-n_meas:]
    st = strouhal_number(clm, np.full(len(clm), dt), u_ref=U_BAR, d_ref=D)
    vals = {"cd_max": float(cdm.max()), "cl_max": float(clm.max()),
            "st": float(st)}
    return {"cd_max": round(vals["cd_max"], 4),
            "cd_mean": round(float(cdm.mean()), 4),
            "cl_max": round(vals["cl_max"], 4),
            "cl_min": round(float(clm.min()), 4),
            "st": round(vals["st"], 4),
            "published": {k: list(v) for k, v in INTERVALS.items()},
            "in_interval": {k: bool(lo <= vals[k] <= hi)
                            for k, (lo, hi) in INTERVALS.items()}}


def save_field(path, s, mesh):
    """The developed field in the JAX tool's rung format."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, u=s.get_u().astype(np.float16),
                        p=s.get_p().astype(np.float16),
                        cx=np.asarray(mesh.cell_cx),
                        cy=np.asarray(mesh.cell_cy),
                        t=np.float32(float(s.state.time)))


def run(h=0.005, t_end=30.0, t_meas=6.0, scheme=1, h_from=None,
        device=None, log=print) -> dict:
    """The benchmark at cell size ``h``; returns the record's row."""
    import torch
    from ..runtime.device_mesh import resolve_device
    from ..utils.forces import obstacle_face_mask
    from .developed_cases import save_step_input
    device = resolve_device(device)
    t0 = time.time()
    mesh = make_mesh(h)
    log(f"# turek mesh h={h}: {mesh.num_cells} cells, D/h={D / h:.0f} "
        f"({time.time() - t0:.0f}s)")
    s = make_solver(mesh, h, scheme, device)
    log(f"# layout: {'structured ' + str(s.mesh.grid_shape) if s.mesh.grid_shape else 'not structured'}"
        f", device {device}")
    dt = h / 6.0
    if h_from is not None:
        t_src = warm_start(s, mesh, cache_path(h_from))
        log(f"# warm start from {cache_path(h_from).name} (t={t_src:.1f}s)")
    mask = obstacle_face_mask(s.mesh)
    n_total = int(round(t_end / dt))
    n_meas = int(round(t_meas / dt))
    out = torch.empty((CHUNK, 2), dtype=torch.float32, device=device)
    cd, cl, done = [], [], 0
    t0 = time.time()
    while done < n_total:
        if done == n_total - n_meas:
            save_step_input(s, window_path(h), source=f"validate_turek h={h}",
                            card=card_line(device), step=done)
        # A chunk ends where the measurement window starts.
        stop = n_total - n_meas if done < n_total - n_meas else n_total
        n = min(CHUNK, stop - done)
        f = run_chunk(s, mask, n, out)
        if not np.isfinite(f).all():
            raise FloatingPointError(f"diverged in steps {done}-{done + n}")
        cd.extend(f[:, 0].tolist())
        cl.extend(f[:, 1].tolist())
        done += n
        log(f"# t={float(s.state.time):6.2f}  Cd={f[-1, 0]:.4f}  "
            f"Cl={f[-1, 1]:+.4f}  ({time.time() - t0:.0f}s wall)")
    wall = time.time() - t0
    row = {"benchmark": "schaefer-turek-2d2", "h": h,
           "cells": int(mesh.num_cells), "d_over_h": round(D / h, 1),
           "scheme": scheme, "dt": dt, "t_end": t_end, "t_measure": t_meas,
           **summary(np.array(cd), np.array(cl), dt, n_meas),
           "steps": n_total, "wall_s": round(wall, 1),
           "stopped": bool(s.should_stop), "device": str(device),
           "card": card_line(device)}
    if h_from is not None:
        row["warm_start_from_h"] = h_from
    log(json.dumps(row))
    append_row(RECORD, row)
    save_field(cache_path(h), s, mesh)
    log(f"# saved {cache_path(h).name}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("h", nargs="?", type=float, default=0.005)
    ap.add_argument("t_end", nargs="?", type=float, default=30.0)
    ap.add_argument("t_measure", nargs="?", type=float, default=6.0)
    ap.add_argument("scheme", nargs="?", type=int, default=1)
    ap.add_argument("h_from", nargs="?", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.h, a.t_end, a.t_measure, a.scheme, a.h_from, a.device,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
