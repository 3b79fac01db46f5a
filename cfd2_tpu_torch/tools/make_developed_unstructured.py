"""Make a developed vortex-shedding state on an unstructured mesh.

The counterpart of the JAX package's ``tools/make_developed_unstructured.py``,
with its configuration: the structured developed street of
``bench_developed_1m.npz`` (Re 160, h 0.0017) is sampled bilinearly at the
target mesh's cell centres, then healed with real solver steps on the target
mesh (the aggregation AMG, ``fgmres_max_restarts=5``, dt = min(2e-4,
0.25 h), 200 steps by default) while a wake probe at (1.8, 0.6) is read
every 10 steps.  As in the JAX tool the solver starts at time 0, so the heal
runs the inlet ramp (``ramp_time`` 0.1 s) from 0; the state's end time is
written beside the fields as ``solver_time`` so that a loader carries the
ramp on from there (``convert.load_developed_unstructured``).  The meta's
``time`` keeps the JAX tool's meaning (the source's time plus the heal).

Usage (on the GPU; it raises without one):

    python -m cfd2_tpu_torch.tools.make_developed_unstructured \\
        delaunay 0.0019 [heal_steps] [max_cell]

Writes ``cfd2_tpu_torch/data/developed_{type}_{size}.npz`` (f16 fields in
host mesh order, and the meta JSON).  :func:`make` takes another device and
output file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from .mesh_cache import ROOT, get_mesh

DATA = Path(__file__).resolve().parent.parent / "data"
SRC = ROOT / "bench_developed_1m.npz"
PROBE_XY = (1.8, 0.6)
HEAL_STEPS = 200


def developed_path(mesh_type: str, size: float, max_cell: float = 0.0) -> Path:
    tag = f"{size}" if not max_cell else f"{size}-{max_cell}"
    return DATA / f"developed_{mesh_type}_{tag}.npz"


def bilerp(field, x, y, h):
    """Sample an (ny, nx[, C]) cell-center grid field at continuous (x, y)
    (cell centers at (i+0.5)h)."""
    ny, nx = field.shape[:2]
    gi = np.clip(x / h - 0.5, 0.0, nx - 1.0)
    gj = np.clip(y / h - 0.5, 0.0, ny - 1.0)
    i0 = np.clip(np.floor(gi).astype(int), 0, nx - 2)
    j0 = np.clip(np.floor(gj).astype(int), 0, ny - 2)
    fx = (gi - i0)[..., None] if field.ndim == 3 else (gi - i0)
    fy = (gj - j0)[..., None] if field.ndim == 3 else (gj - j0)
    f00 = field[j0, i0]
    f01 = field[j0, i0 + 1]
    f10 = field[j0 + 1, i0]
    f11 = field[j0 + 1, i0 + 1]
    return ((1 - fy) * ((1 - fx) * f00 + fx * f01)
            + fy * ((1 - fx) * f10 + fx * f11))


def load_source(path=SRC):
    """(u, p, h, meta) of a structured developed state: u (ny, nx, 2) and
    p (ny, nx) as float32."""
    with np.load(path) as d:
        meta = json.loads(str(d["meta"]))
        return (d["u"].astype(np.float32), d["p"].astype(np.float32),
                float(d["h"]), meta)


def heal_dt(size: float) -> float:
    return min(2e-4, 0.25 * size)


def healing_solver(mesh, size: float, src_meta: dict, device=None):
    """A CoupledSolver on ``mesh`` in the heal's configuration, at rest."""
    from ..models.coupled import CoupledSolver
    s = CoupledSolver(mesh, device=device)
    s.set_viscosity(src_meta["viscosity"])
    s.set_density(src_meta.get("density", 1.0))
    s.set_precond_type(1)   # aggregation AMG
    s.config = replace(s.config, fgmres_max_restarts=5, stop_count=10**9)
    s.set_dt(heal_dt(size))
    return s


def prolong(s, mesh, u_g, p_g, h):
    """The grid state sampled at ``mesh``'s cell centres, set on ``s``."""
    s.set_u(bilerp(u_g, mesh.cell_cx, mesh.cell_cy, h))
    s.set_p(bilerp(p_g, mesh.cell_cx, mesh.cell_cy, h))
    s.initialize_history()


def probe_cell(mesh) -> int:
    """The wake probe's cell (host order)."""
    return int(np.argmin((mesh.cell_cx - PROBE_XY[0]) ** 2
                         + (mesh.cell_cy - PROBE_XY[1]) ** 2))


def heal(s, mesh, steps: int, log=print) -> dict:
    """``steps`` steps of ``s``; the probe's v read after the first step and
    every 10th, each read asserting finite fields.  Returns the heal's
    record: per step the outers and FGMRES iterations, the probe series,
    its amplitude, max|u| and the wall."""
    probe = probe_cell(mesh)
    series, max_u, counts = [], None, []
    t0 = time.time()
    for i in range(steps):
        s.step(mode="fused")
        counts.append((int(s.state.outer_iters),
                       int(s.state.linear_iters_total)))
        if (i + 1) % 10 == 0 or i == 0:
            u = s.get_u()
            assert np.isfinite(u).all(), f"diverged at heal step {i}"
            series.append(float(u[probe, 1]))
            max_u = float(np.abs(u).max())
            log(f"# heal {i+1}/{steps}  max|u|={max_u:.3f} "
                f"probe_v={series[-1]:+.3f}  ({time.time()-t0:.0f}s)")
    amp = float(np.max(series) - np.min(series)) if series else 0.0
    return dict(counts=counts, probe_v_series=series, probe_v_amplitude=amp,
                max_u=max_u, heal_wall_s=time.time() - t0)


def write_state(out, s, meta: dict):
    u, p = s.get_u(), s.get_p()
    assert np.isfinite(u).all() and np.isfinite(p).all(), "non-finite state"
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, u=u.astype(np.float16),
                        p=p.astype(np.float16), meta=json.dumps(meta))


def make(mesh_type: str, size: float, heal_steps: int = HEAL_STEPS,
         max_cell: float = 0.0, device=None, out=None, mesh=None,
         log=print) -> dict:
    """Prolong, heal and write one developed state; returns its meta.
    ``mesh``: the host mesh, if the caller has it (else the cache's)."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)   # raises before minutes of meshing
    u_g, p_g, h_src, src_meta = load_source()
    log(f"# source grid {u_g.shape[:2]} h={h_src:.5f} "
        f"t={src_meta['time']:.2f} nu={src_meta['viscosity']}")
    if mesh is None:
        mesh = get_mesh(mesh_type, size, max_cell=max_cell)
    s = healing_solver(mesh, size, src_meta, device)
    prolong(s, mesh, u_g, p_g, h_src)
    rec = heal(s, mesh, heal_steps, log)
    dt = heal_dt(size)
    meta = {"viscosity": src_meta["viscosity"], "density": 1.0,
            "mesh_type": mesh_type, "size": size, "max_cell": max_cell,
            "cells": mesh.num_cells,
            "time": src_meta["time"] + heal_steps * dt, "dt": dt,
            "heal_steps": heal_steps,
            "probe_v_amplitude": rec["probe_v_amplitude"],
            "probe_xy": list(PROBE_XY),
            "solver_time": float(s.state.time),
            "probe_v_series": rec["probe_v_series"], "max_u": rec["max_u"],
            "heal_wall_s": rec["heal_wall_s"], "heal_counts": rec["counts"],
            "device": str(s.device)}
    if s.device.type == "cuda":
        import torch
        meta["device"] = torch.cuda.get_device_name(s.device)
    out = out or developed_path(mesh_type, size, max_cell)
    write_state(out, s, meta)
    log(f"# wrote {out}: {mesh.num_cells} cells, probe_v amplitude "
        f"{rec['probe_v_amplitude']:.3f}, solver time "
        f"{meta['solver_time']:.6f} s")
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mesh_type", nargs="?", default="delaunay",
                    choices=("delaunay", "voronoi", "cutcell"))
    ap.add_argument("size", nargs="?", type=float, default=0.0019)
    ap.add_argument("heal_steps", nargs="?", type=int, default=HEAL_STEPS)
    ap.add_argument("max_cell", nargs="?", type=float, default=0.0)
    a = ap.parse_args(argv)
    make(a.mesh_type, a.size, a.heal_steps, a.max_cell,
         log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
