"""Per-outer linear-iteration ladder of real host-mode steps on the 1M
structured channel: how many FGMRES iterations each outer corrector burns
at the reference's strict tolerance.

The port's counterpart of the JAX package's ``tools/iters_1m.py``, with its
environment: ``IT_CELL`` (cell size, 0.0017: 996,558 cells), ``IT_STEPS``
(3), ``IT_EXTRAP=1`` (``extrapolate_guess``), ``IT_INCYCLE``
(``fgmres_incycle_window``); 5 FGMRES restarts at most.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.iters_1m [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import probes


def run(cell: float | None = None, steps: int | None = None, device=None,
        mesh=None, log=print) -> list:
    """The ladders of ``steps`` host-mode steps from rest (``cell`` and
    ``steps`` default to the environment's): one list of per-outer FGMRES
    iterations per step.  ``mesh``: the channel's host mesh at ``cell``,
    made here when None."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    cell = float(os.environ.get("IT_CELL", "0.0017")) if cell is None \
        else cell
    steps = int(os.environ.get("IT_STEPS", "3")) if steps is None else steps
    if mesh is None:
        mesh = probes.channel_mesh(cell)
    s = probes.channel_solver(
        mesh, cell, device, fgmres_max_restarts=5,
        extrapolate_guess=os.environ.get("IT_EXTRAP") == "1",
        fgmres_incycle_window=int(os.environ.get("IT_INCYCLE", "0")))
    log(f"# {mesh.num_cells} cells on {device}")
    ladders = []
    for i in range(steps):
        t0 = time.time()
        ladders.append(probes.ladder_step(s, log))
        probes.sync(device)
        log(f"# step {i}: {time.time() - t0:.2f}s")
    return ladders


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(device=a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
