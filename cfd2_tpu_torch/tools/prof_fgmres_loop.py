"""The bare FGMRES loop at the main path's planar shapes.

The port's counterpart of the JAX package's ``tools/prof_fgmres_loop.py``:
``ops/fgmres.py``'s ``fgmres_solve`` on a seeded (3, 589, 1765) right-hand
side with a trivial matvec (x * 1.0001 + 0.0001 * roll(x, 1, -1)) and
preconditioner (r * 0.999), restart 30 and 50, one cycle, tolerances 1e-30
(so every cycle runs to its end).  What is measured is the loop itself: the
Gram-Schmidt products, the basis writes, the Givens rotations on the host
and the loop's host reads.

Each cycle is timed by :func:`.probes.time_phase`: the host's wall to a
``torch.cuda.synchronize()`` beside the device's busy time.  Their
difference over the iterations is the host's cost of one Arnoldi iteration
(the device idles while the host runs it), which CUDA graphs of an
iteration would remove (ROADMAP Queue 1 item 3.2).

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.prof_fgmres_loop [ny nx] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import probes

RESTARTS = (30, 50)


def operators():
    """The JAX tool's trivial matvec and preconditioner."""
    def mv(x):
        return x * 1.0001 + 0.0001 * torch.roll(x, 1, dims=-1)

    def pc(r):
        return r * 0.999
    return mv, pc


def rhs(ny: int, nx: int, device) -> torch.Tensor:
    """The seeded right-hand side (numpy's generator, seed 0)."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.standard_normal((3, ny, nx)),
                           dtype=torch.float32, device=device)


def run(ny: int = 589, nx: int = 1765, device=None, restarts=RESTARTS,
        log=print) -> dict:
    """One cycle of each restart length; returns restart -> the row of
    :func:`.probes.time_phase` with ``iterations`` and, on the card,
    ``host_us_per_iteration`` (wall minus device busy time, per
    iteration)."""
    from ..ops.fgmres import fgmres_solve
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    b = rhs(ny, nx, device)
    mv, pc = operators()
    out = {}
    for m in restarts:
        res, row = probes.time_phase(
            f"{m}-iteration cycle", lambda: fgmres_solve(
                mv, pc, b, torch.zeros_like(b), restart=m, max_restarts=1,
                tol=1e-30, abstol=1e-30), device, log=log)
        it = int(res.iterations)
        row["iterations"] = it
        line = (f"{m}-iteration cycle: {row['wall_ms']:.1f} ms, iters={it}, "
                f"{row['wall_ms'] / max(it, 1):.3f} ms/iter wall")
        if row["device_ms"] is not None:
            host = (row["wall_ms"] - row["device_ms"]) / max(it, 1) * 1e3
            row["host_us_per_iteration"] = host
            line += (f", {row['device_ms'] / max(it, 1):.3f} ms/iter device"
                     f", host {host:.1f} us/iter")
        log(line)
        out[m] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ny", nargs="?", type=int, default=589)
    ap.add_argument("nx", nargs="?", type=int, default=1765)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.ny, a.nx, a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
