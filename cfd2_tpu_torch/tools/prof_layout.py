"""Layout costs and the Gram-Schmidt forms at the main path's shapes.

The port's counterpart of the JAX package's ``tools/prof_layout.py``.  On a
TPU that tool measured the relayouts between the flat T(1024) and the tiled
T(8,128) layouts that a flattened FGMRES forced on every iteration.  On the
card a flat <-> planar reshape of a contiguous tensor is a view and moves no
byte (``reshape_p2f`` / ``reshape_f2p`` below time the add that follows
it).  What the port does copy is timed instead: ``ops/stencil_system.py``'s
``to_planar`` ((N, 3) interleaved -> (3, ny, nx) planes, once per solve)
and the copy that makes ``from_planar``'s transposed view contiguous.  On
(3, ny, nx) planes (default 589 x 1765) and a basis of m + 1 = 51 rows:

* ``launch``: one add on a single element (the floor of a timed call);
* ``add_flat`` / ``add_planar``: y = x + 1 on the (D,) and (3, ny, nx)
  forms (D = 3 ny nx), with the rate;
* ``cgs_flat``: the (ch, D) @ (D,) product that ``ops/fgmres.py`` issues
  (ch = 9 live rows) against ``cgs_tiled``, a multiply-reduce over
  (ch, 3, ny, nx); ``proj_flat`` / ``proj_tiled``: the projection side
  (d @ V and the multiply-sum over rows);
* ``rowupd_flat`` / ``rowupd_tiled``: writing one basis row;
* ``stencil_pl`` / ``stencil_flat``: a 5-point stencil on the planes, and
  on the flat vector through both reshapes.

Each is timed by :func:`.probes.time_phase` (the host's wall to a
``torch.cuda.synchronize()`` beside the device's busy time).

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.prof_layout [ny nx] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import probes

M, CH = 50, 9   # basis rows - 1, live rows of the chunk


def stencil(a: torch.Tensor) -> torch.Tensor:
    """2 a - (E + W + N + S) / 2 on (3, ny, nx) planes, edges clamped."""
    from ..ops.stencil_kernels import edge_shifts
    e, w, n, s = edge_shifts(a)
    return a * 2.0 - 0.5 * (e + w + n + s)


def inputs(ny: int, nx: int, device, seed: int = 0) -> dict:
    """The seeded operands: planes xp and the same numbers flat (xf), the
    basis in both forms (Vf (M+1, D) and Vp (M+1, 3, ny, nx), the same
    numbers), CH projection weights d and an (N, 3) interleaved vector x3.
    The flat and tiled forms of an operation thus compute the same
    function."""
    rng = np.random.default_rng(seed)
    D = 3 * ny * nx
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=device)
    Vf, xp = t(M + 1, D), t(3, ny, nx)
    return dict(xp=xp, xf=xp.reshape(D).clone(), Vf=Vf,
                Vp=Vf.reshape(M + 1, 3, ny, nx).clone(), d=t(CH),
                x3=t(ny * nx, 3))


def forms(ny: int, nx: int, ops: dict) -> dict:
    """Each measured operation as a no-argument call (the name's order is
    the printed order)."""
    from ..ops import stencil_system as st
    D = 3 * ny * nx
    xp, xf, Vf, Vp, d, x3 = (ops[k] for k in ("xp", "xf", "Vf", "Vp", "d",
                                               "x3"))

    class _Grid:   # what to_planar / from_planar read of a system
        grid = (ny, nx)

    return {
        "launch": lambda: xp[0, 0] + 1.0,
        "reshape_p2f": lambda: xp.reshape(D) + 1.0,
        "reshape_f2p": lambda: xf.reshape(3, ny, nx) + 1.0,
        "to_planar": lambda: st.to_planar(_Grid, x3),
        "from_planar_copy": lambda: st.from_planar(_Grid, xp).contiguous(),
        "add_flat": lambda: xf + 1.0,
        "add_planar": lambda: xp + 1.0,
        "cgs_flat": lambda: torch.mv(Vf[:CH], xf),
        "cgs_tiled": lambda: torch.sum(Vp[:CH] * xp[None], dim=(1, 2, 3)),
        "proj_flat": lambda: d @ Vf[:CH],
        "proj_tiled": lambda: torch.sum(d[:, None, None, None] * Vp[:CH],
                                        dim=0),
        "rowupd_flat": lambda: Vf[3].copy_(xf),
        "rowupd_tiled": lambda: Vp[3].copy_(xp),
        "stencil_pl": lambda: stencil(xp),
        "stencil_flat": lambda: stencil(xf.reshape(3, ny, nx)).reshape(D),
    }


def run(ny: int = 589, nx: int = 1765, device=None, log=print) -> dict:
    """Every form of :func:`forms` timed; returns name -> (row, output)."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    D = 3 * ny * nx
    out = {}
    for name, fn in forms(ny, nx, inputs(ny, nx, device)).items():
        res, row = probes.time_phase(name, fn, device, reps=20, warmup=3,
                                     log=log)
        out[name] = (row, res)
    moved = {"add_flat": 2 * D * 4, "add_planar": 2 * D * 4,
             "cgs_flat": (CH * D + D) * 4, "cgs_tiled": (CH * D + D) * 4}
    log("bytes over the device's busy time (the wall where that was not "
        "measured), GB/s: " + ", ".join(
            f"{k} {b / busy_or_wall(out[k][0]) * 1e3 / 1e9:.0f}"
            for k, b in moved.items()))
    return out


def busy_or_wall(row: dict) -> float:
    """A row's device busy time in ms, or its wall where that was not
    measured (on the CPU, or where the profile lost kernel records)."""
    dev = row["device_ms"]
    return dev if dev else row["wall_ms"]


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
