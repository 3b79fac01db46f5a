"""Make a developed vortex-shedding state at the north-star size (1M cells)
on the port, by a grid cascade.

The counterpart of the JAX package's ``tools/make_developed.py``, with its
configuration: the 3 x 1 channel with the r = 0.2 obstacle, Re = 160
(nu = 0.0025), the multigrid pressure block, ``fgmres_max_restarts=5`` and
``stop_count=10**9`` (the symmetric pre-shedding wake would otherwise read
as steady and freeze the run), adaptive steps at CFL 0.4 in batches of 50.
The flow develops where steps are cheap and is carried to each finer grid
by bilinear prolongation of (u, p), then healed:

    0.0136 (15k cells, 2000 steps)
    -> 0.0068 (62k): perturbed wake, developed to t = 25 s
    -> 0.0034 (250k, 300 steps)
    -> 0.0017 (1M, 250 steps)

Each level is cached as ``.bench_cache/torch_developed_{size}.npz`` (never the
JAX tool's ``developed_{size}.npz``, which that tool would load as its own
and skip the level); a cached level is loaded instead of run again.  The
result is written to ``cfd2_tpu_torch/data/developed_1m_card.npz`` in the
format of ``bench_developed_1m.npz`` (f16 u (ny, nx, 2) and p (ny, nx), h,
meta with the wake probe's v amplitude, and the card and each level's wall).

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.make_developed [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from .make_developed_unstructured import bilerp
from .mesh_cache import CACHE, channel
from .records import DATA, card_line

OUT = DATA / "developed_1m_card.npz"
VISCOSITY = 0.0025        # Re = U D / nu = 160: sheds despite the channel
DENSITY = 1.0
T_DEVELOP = 25.0          # physical seconds at the development level
DEVELOP_SIZE = 0.0068
HEAL_STEPS = {0.0136: 2000, 0.0034: 300, 0.0017: 250}
SIZES = (0.0136, 0.0068, 0.0034, 0.0017)
PROBE_XY = (1.8, 0.6)     # wake probe, downstream of the obstacle
CFL = 0.4
BATCH = 50


def level_path(size: float) -> Path:
    return CACHE / f"torch_developed_{size}.npz"


def make_solver(min_cell: float, device=None, log=print):
    """A CoupledSolver on the channel's cut-cell mesh at ``min_cell``, in
    the cascade's configuration, at rest."""
    from ..mesh import generate_cut_cell_mesh
    from ..models.coupled import CoupledSolver
    t0 = time.time()
    mesh = generate_cut_cell_mesh(channel(), min_cell, min_cell, 1.2,
                                  (3.0, 1.0))
    log(f"# mesh {min_cell}: {mesh.num_cells} cells "
        f"({time.time() - t0:.0f}s)")
    s = CoupledSolver(mesh, device=device)
    s.set_viscosity(VISCOSITY)
    s.set_density(DENSITY)
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5, stop_count=10**9)
    s.set_dt(min(2e-4, 0.3 * min_cell))
    return s


def _cell_centres(s):
    """Device-order cell centres and the fluid mask, on the host."""
    m = s.mesh
    return (m.c_cx.cpu().numpy(), m.c_cy.cpu().numpy(),
            m.c_valid.cpu().numpy() > 0)


def _set_u(s, u: np.ndarray):
    """Device-order u as the state's u and its history."""
    import torch
    ut = torch.as_tensor(u, dtype=torch.float32, device=s.device)
    s.state = replace(s.state, u=ut, u_old=ut, u_old_old=ut, prev_u=ut)


def perturb_wake(s):
    """Seed wake asymmetry so shedding does not wait on roundoff."""
    cx, cy, valid = _cell_centres(s)
    bump = 0.15 * np.exp(-((cx - 1.35) ** 2 + (cy - 0.55) ** 2) / 0.12 ** 2)
    u = s.state.u.cpu().numpy().copy()
    u[:, 1] += bump * valid
    _set_u(s, u)


def grid_fields(s):
    """(ny, nx, 2) u and (ny, nx) p grids, and the spacing h."""
    ny, nx = s.mesh.grid_shape
    u = s.state.u.cpu().numpy().reshape(ny, nx, 2)
    p = s.state.p.cpu().numpy().reshape(ny, nx)
    return u, p, 3.0 / nx   # uniform grid over the 3 x 1 channel


def prolong_into(s, u_c, p_c, h_c):
    """Set ``s``'s state from coarse grids, bilinear at its cell centres."""
    import torch
    cx, cy, valid = _cell_centres(s)
    _set_u(s, bilerp(u_c, cx, cy, h_c) * valid[:, None])
    s.state = replace(s.state, p=torch.as_tensor(
        bilerp(p_c, cx, cy, h_c) * valid, dtype=torch.float32,
        device=s.device))


def probe_index(s) -> int:
    """The device cell nearest the wake probe."""
    cx, cy, valid = _cell_centres(s)
    d2 = (cx - PROBE_XY[0]) ** 2 + (cy - PROBE_XY[1]) ** 2
    d2[~valid] = np.inf
    return int(np.argmin(d2))


def run_steps(s, n: int, min_cell: float, batch: int = BATCH, label="",
              log=print) -> list:
    """``n`` adaptive-dt steps (``multi_step_adaptive``, CFL 0.4) in
    batches; returns the wake probe's v, one sample per batch."""
    from ..models.coupled import multi_step_adaptive
    pi = probe_index(s)
    series, done, t0 = [], 0, time.time()
    amg = s._get_amg()
    while done < n:
        k = min(batch, n - done)
        s.state, s.params, _ = multi_step_adaptive(
            s.mesh, s.state, s.params, s.config, k, target_cfl=CFL,
            min_cell_size=min_cell, amg=amg)
        done += k
        uy = float(s.state.u[pi, 1])
        series.append(uy)
        if not np.isfinite(uy):
            raise FloatingPointError(f"{label}: diverged at step {done}")
        log(f"#   {label} step {done}/{n} t={float(s.state.time):.2f} "
            f"dt={float(s.params.dt):.1e} probe_v={uy:+.3f} "
            f"({time.time() - t0:.0f}s)")
    return series


def probe_amplitude(series) -> float:
    """Peak-to-peak probe v over the last 40 samples."""
    tail = np.array(series[-40:])
    return float(tail.max() - tail.min()) if len(tail) else 0.0


def write_state(path, u, p, h, meta: dict):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, u=u.astype(np.float16),
                        p=p.astype(np.float16), h=np.float32(h),
                        meta=json.dumps(meta))


def run(device=None, out=OUT, sizes=SIZES, heal_steps=None,
        log=print) -> dict:
    """The cascade over ``sizes`` (the last one's state is the result);
    returns the written meta."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    heal_steps = HEAL_STEPS if heal_steps is None else heal_steps
    CACHE.mkdir(parents=True, exist_ok=True)
    u_c = p_c = h_c = None
    t_c, series_all, levels = 0.0, [], []
    for size in sizes:
        ck = level_path(size)
        if ck.exists():
            with np.load(ck) as d:
                u_c, p_c = d["u"].astype(np.float32), d["p"].astype(np.float32)
                h_c, t_c = float(d["h"]), float(d["t"])
            log(f"# level {size}: cached (t={t_c:.2f})")
            levels.append({"size": size, "cached": True, "t": t_c})
            continue
        t0 = time.time()
        s = make_solver(size, device, log)
        if u_c is not None:
            prolong_into(s, u_c, p_c, h_c)
        steps = 0
        if size == DEVELOP_SIZE:
            # Develop: march until several shedding periods have passed.
            perturb_wake(s)
            stall = 0
            while float(s.state.time) < T_DEVELOP and stall < 3:
                t_before = float(s.state.time)
                series_all += run_steps(s, 600, size, label=f"L{size}",
                                        log=log)
                steps += 600
                stall = stall + 1 if float(s.state.time) <= t_before else 0
        else:
            steps = heal_steps[size]
            series_all += run_steps(s, steps, size, label=f"L{size}",
                                    log=log)
        u_c, p_c, h_c = grid_fields(s)
        t_c = float(s.state.time)
        np.savez_compressed(ck, u=u_c.astype(np.float16),
                            p=p_c.astype(np.float16), h=h_c, t=t_c)
        levels.append({"size": size, "cells": int(s.host_mesh.num_cells),
                       "steps": steps, "t": t_c,
                       "wall_s": round(time.time() - t0, 1)})
        log(f"# level {size} done: t={t_c:.2f} "
            f"({time.time() - t0:.0f}s)")
    amp = probe_amplitude(series_all)
    meta = dict(viscosity=VISCOSITY, density=DENSITY, time=t_c,
                grid=[int(x) for x in u_c.shape[:2]], probe_v_amplitude=amp,
                probe_xy=list(PROBE_XY), levels=levels, device=str(device),
                card=card_line(device))
    write_state(out, u_c, p_c, h_c, meta)
    log(f"# wrote {out}: grid={meta['grid']} t={t_c:.2f} "
        f"probe_v_amplitude={amp:.3f}")
    if amp < 0.05:
        log("# WARNING: wake probe amplitude small: the state may not be "
            "shedding yet")
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    ap.add_argument("--out", default=str(OUT))
    a = ap.parse_args(argv)
    run(a.device, a.out, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
