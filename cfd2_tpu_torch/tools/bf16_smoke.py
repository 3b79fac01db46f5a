"""The four bf16 combinations of the coupled solve on the structured channel
from rest: each variant's outers per step and its throughput.

The port's counterpart of the JAX package's ``tools/bf16_smoke.py``, with
its environment: ``SMOKE_CELL`` (0.005) and ``SMOKE_VARIANTS`` (a comma
list of ``f32``, ``basis16``, ``pc16``, ``both16``).  Per variant a solver
from rest (5 FGMRES restarts at most) takes a first step, a second, and
then 5 timed ones, each synchronised with the device.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.bf16_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import probes

VARIANTS = (("f32", dict(fgmres_basis_bf16=False, precond_bf16=False)),
            ("basis16", dict(fgmres_basis_bf16=True, precond_bf16=False)),
            ("pc16", dict(fgmres_basis_bf16=False, precond_bf16=True)),
            ("both16", dict(fgmres_basis_bf16=True, precond_bf16=True)))


def run(size: float | None = None, variants=None, timed: int = 5,
        device=None, mesh=None, log=print) -> dict:
    """Every variant (``SMOKE_VARIANTS`` by default, else all): name ->
    outers of each timed step, cells x steps per second.  ``mesh``: the
    channel's host mesh at ``size``, made here when None."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    if size is None:
        size = float(os.environ.get("SMOKE_CELL", "0.005"))
    if variants is None:
        sel = os.environ.get("SMOKE_VARIANTS")
        variants = [v for v in VARIANTS
                    if not sel or v[0] in sel.split(",")]
    if mesh is None:
        mesh = probes.channel_mesh(size)
    log(f"cells {mesh.num_cells} on {device}")
    out = {}
    for tag, kw in variants:
        s = probes.channel_solver(mesh, size, device, fgmres_max_restarts=5,
                                  **kw)
        t0 = time.time()
        s.step()
        probes.sync(device)
        log(f"{tag}: first step {time.time() - t0:.1f}s")
        s.step()
        outers = []
        probes.sync(device)
        t0 = time.time()
        for _ in range(timed):
            s.step()
            outers.append(int(s.state.outer_iters))
        probes.sync(device)
        el = time.time() - t0
        if not np.isfinite(s.get_u()).all():
            raise FloatingPointError(f"{tag}: u is not finite")
        rate = mesh.num_cells * timed / el
        out[tag] = dict(outers=outers, cells_per_s=rate, seconds=el)
        log(f"{tag}: {timed} steps {el:.3f}s -> {rate:.0f} c-u/s, "
            f"outers={outers}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(device=a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
