"""The bf16 levers at the main path's planar shapes, f32 against bf16.

The port's counterpart of the JAX package's ``tools/probe_bf16.py``, on
seeded (ny, nx) planes (default 589 x 1765), each operation repeated 20
times with one synchronisation at the end (the times are per repetition):

* ``momentum m8``: the 8-sweep Jacobi momentum solve of both components.
  In float32 it is the ``momentum_jacobi`` kernel (one launch); in bf16 it
  is its plain version (``momentum_jacobi_ref``), where
  ``ops/stencil_system.py``'s ``_kernels`` routes the bf16 preconditioner;
* ``CGS 24-row``: the Gram-Schmidt pass of 24 basis rows of (3, ny, nx)
  (their dots with w, then the projection), the basis in float32 and in
  bf16 (w float32), as plain tensor products;
* ``pressure sweep``: a Jacobi sweep x <- dinv (r - sum_s P[s] shift_s(x))
  of the 5-point stencil, plain in both dtypes.

Each is timed by :func:`.probes.time_phase` (the host's wall to a
``torch.cuda.synchronize()`` beside the device's busy time).

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.probe_bf16 [ny nx] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import probes

REPS, ROWS = 20, 24


def inputs(ny: int, nx: int, device) -> dict:
    """The JAX tool's operands from numpy's generator (seed 0), drawn in
    its order: off, dinv, r_u, r_v, the basis V, w, the pressure planes
    P."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s),
                                   dtype=torch.float32, device=device)
    off = f(4, ny, nx) * 0.1
    dinv = f(ny, nx) * 0.01 + 1.0
    r_u, r_v = f(ny, nx), f(ny, nx)
    V, w = f(ROWS, 3, ny, nx), f(3, ny, nx)
    P = f(4, ny, nx) * 0.1
    return dict(off=off, dinv=dinv, r=torch.stack([r_u, r_v]), V=V, w=w, P=P)


def mom_loop(dinv, off, r, kernel: bool):
    """REPS 8-sweep momentum solves, each seeded from the last's u."""
    from ..ops import stencil_kernels as sk
    fn = sk.momentum_jacobi if kernel else sk.momentum_jacobi_ref
    z = r
    for _ in range(REPS):
        z = fn(torch.stack([r[0] + z[0] * 1e-30, r[1]]), dinv, off, 8)
    return z


def cgs_loop(V, w):
    """REPS Gram-Schmidt passes over the ROWS basis rows (V may be bf16:
    each product is taken in float32)."""
    for _ in range(REPS):
        d = torch.sum(V * w[None], dim=(1, 2, 3))
        proj = torch.sum(d[:, None, None, None] * V, dim=0)
        w = w - proj * 1e-30
    return w


def sweep_loop(P, dinv, r):
    """REPS Jacobi sweeps of the 5-point stencil from x = r."""
    from ..ops.stencil_kernels import dot4, edge_shifts
    x = r
    for _ in range(REPS):
        x = dinv * (r - dot4(P, edge_shifts(x)))
    return x


def run(ny: int = 589, nx: int = 1765, device=None, log=print) -> dict:
    """Every lever in both dtypes; returns label -> (row, output)."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    a = inputs(ny, nx, device)
    bf = {k: v.to(torch.bfloat16) for k, v in a.items()}
    cases = {
        "momentum m8 f32": lambda: mom_loop(a["dinv"], a["off"], a["r"],
                                            True),
        "momentum m8 bf16": lambda: mom_loop(bf["dinv"], bf["off"],
                                             bf["r"], False),
        f"CGS {ROWS}-row f32": lambda: cgs_loop(a["V"], a["w"]),
        f"CGS {ROWS}-row bf16V": lambda: cgs_loop(bf["V"], a["w"]),
        "pressure sweep f32": lambda: sweep_loop(a["P"], a["dinv"],
                                                 a["r"][0]),
        "pressure sweep bf16": lambda: sweep_loop(bf["P"], bf["dinv"],
                                                  bf["r"][0]),
    }
    out = {}
    for label, fn in cases.items():
        res, row = probes.time_phase(label, fn, device, reps=1, per=REPS,
                                     log=log)
        out[label] = (row, res)
    for lever in ("momentum m8", f"CGS {ROWS}-row", "pressure sweep"):
        f32 = out[f"{lever} f32"][0]["wall_ms"]
        b16 = next(v[0]["wall_ms"] for k, v in out.items()
                   if k.startswith(lever) and "bf16" in k)
        log(f"{lever}: bf16 / f32 wall {b16 / f32:.2f}")
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
