"""Water on the backwards step with float64 norm accumulation.

The port's counterpart of the JAX package's ``tools/stiff_water_x64.py``:
the case of :mod:`.stiff_water` (``reproduce_divergence.rs``'s
configuration at h = 0.01, 50 steps) with ``fgmres_f64_norms=True``.  rho =
1000 squares into the residual norms, the regime the option exists for.
The JAX package accumulates those norms in float64 only under
``jax_enable_x64`` (so its tool runs on an x64 CPU backend); the port
accumulates them in float64 on every device, the card included, and keeps
the fields in float32.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.stiff_water_x64 [h] [steps] [--device cpu]

Writes ``cfd2_tpu_torch/data/stiff_water_x64_card.json`` (the card's name
and power limit in it), never the JAX tool's ``STIFF_X64.json`` (max|u|
0.386558 after the 50 steps there).
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

from . import stiff_water as sw
from .records import DATA

OUT = DATA / "stiff_water_x64_card.json"


def make_solver(mesh, device=None):
    """:func:`.stiff_water.make_solver` with the norms in float64."""
    s = sw.make_solver(mesh, device)
    s.config = replace(s.config, fgmres_f64_norms=True)
    return s


def run(h: float = 0.01, steps: int = 50, device=None, out=OUT,
        log=print, solver=None) -> dict:
    """:func:`.stiff_water.run` on :func:`make_solver`'s solver (or on
    ``solver``, one set up by it); the record says ``f64_norms_active``."""
    from ..runtime.device_mesh import resolve_device
    if solver is None:
        solver = make_solver(sw.make_mesh(h), resolve_device(device))
    if not solver.config.fgmres_f64_norms:
        raise ValueError("the solver's norms are not float64: "
                         "set it up with make_solver")
    rec = sw.run(h, steps, out=None, log=log, solver=solver)
    rec["f64_norms_active"] = True
    return sw.write_record(rec, out)


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
