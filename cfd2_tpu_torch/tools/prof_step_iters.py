"""Per-outer linear-iteration ladder of real host-mode steps on an
unstructured (or cut-cell) channel: the in-step numbers the end-to-end
throughput follows.

The port's counterpart of the JAX package's ``tools/prof_step_iters.py``,
with its arguments and environment: ``min_cell`` (0.005), the mesh type
(``delaunay``, ``voronoi`` or ``cutcell``), the steps (4) and ``max_cell``
(or ``CFD2_MAXCELL``: a refined cut-cell mesh); ``CFD2_CHEB``
(``precond_cheb``), ``CFD2_OC`` (``precond_overcorrect``), ``CFD2_MS``
(``precond_mom_sweeps``), ``CFD2_RESTART`` (``fgmres_restart``),
``CFD2_AGGP`` (``amg_agg_passes``), ``CFD2_VCYCLES``
(``precond_vcycles``).

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.prof_step_iters [min_cell] \\
        [delaunay|voronoi|cutcell] [steps] [max_cell] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import probes


def env_config() -> dict:
    """The SolverConfig overrides the environment asks for."""
    rst = int(os.environ.get("CFD2_RESTART", "0"))
    cfg = dict(precond_cheb=int(os.environ.get("CFD2_CHEB", "0")),
               precond_overcorrect=float(os.environ.get("CFD2_OC", "1.0")),
               precond_mom_sweeps=int(os.environ.get("CFD2_MS", "0")),
               amg_agg_passes=int(os.environ.get("CFD2_AGGP", "0")),
               precond_vcycles=int(os.environ.get("CFD2_VCYCLES", "0")))
    if rst:
        cfg["fgmres_restart"] = rst
    return cfg


def run(size: float = 0.005, mesh_type: str = "delaunay", steps: int = 4,
        max_cell: float | None = None, device=None, mesh=None,
        log=print) -> list:
    """The ladders of ``steps`` host-mode steps from rest: one list of
    per-outer FGMRES iterations per step.  ``mesh``: the channel's host
    mesh, made here when None."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    if max_cell is None:
        max_cell = float(os.environ.get("CFD2_MAXCELL", "0"))
    if mesh is None:
        mesh = probes.channel_mesh(size, mesh_type, max_cell)
    cfg = env_config()
    s = probes.channel_solver(mesh, size, device, **cfg)
    levels = [lv.n for lv in getattr(s._get_amg(), "levels", ())]
    log(f"# {mesh_type} {size}: {mesh.num_cells} cells on {device} "
        + " ".join(f"{k}={v}" for k, v in cfg.items())
        + f" levels={levels}")
    ladders = []
    for i in range(steps):
        t0 = time.time()
        ladders.append(probes.ladder_step(s, log))
        probes.sync(device)
        log(f"step {i}: {time.time() - t0:.2f}s "
            f"outers={int(s.state.outer_iters)}")
    return ladders


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("min_cell", nargs="?", type=float, default=0.005)
    ap.add_argument("mesh_type", nargs="?", default="delaunay",
                    choices=("delaunay", "voronoi", "cutcell"))
    ap.add_argument("steps", nargs="?", type=int, default=4)
    ap.add_argument("max_cell", nargs="?", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.min_cell, a.mesh_type, a.steps, a.max_cell, a.device,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
