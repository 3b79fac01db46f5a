"""Time the forms of the streamed momentum predict side by side on the card.

``csrc/stencil.cu``'s ``momentum_stream_kernel`` takes 128 threads a block
and, up to 8 sweeps, a register ring loaded ahead in a step loop unrolled
over the ring's period; above 8, cp.async staging and a rolled loop.  This
tool builds ``tools/momentum_forms.cu`` (the candidate forms, with 128 and
256 threads, and the cp.async form with its barrier, its shared-memory
exchange or its loads taken out) and times each at the two shapes the
structured path gives the predict (589x1765 at 8 sweeps, 834x2500 at 12),
beside the committed wrapper, under the same L2 write flush as
``chip_smoke.py``.  Each row is planned as ``stencil_kernels.momentum_plan``
plans the kernel, at the occupancy the card reports for the form; the kept
forms are held bit for bit against ``momentum_jacobi_ref``.

    python -m cfd2_tpu_torch.tools.momentum_forms

Needs a CUDA device and nvcc; prints one line per form and shape, then one
JSON object with every time.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "momentum_forms.cu"
SHAPES = (((589, 1765), 8), ((834, 2500), 12))
# (form, threads, drop, label); drop > 0 gives wrong results, by design.
FORMS = ((0, 256, 0, "256 threads, register ring, unrolled"),
         (1, 256, 0, "256 threads, cp.async, unrolled"),
         (2, 256, 0, "256 threads, cp.async, rolled"),
         (0, 128, 0, "128 threads, register ring, unrolled"),
         (1, 128, 0, "128 threads, cp.async, unrolled"),
         (2, 128, 0, "128 threads, cp.async, rolled"),
         (1, 256, 1, "256 cp.async unrolled, no barrier"),
         (1, 256, 2, "256 cp.async unrolled, no E/W exchange"),
         (1, 256, 4, "256 cp.async unrolled, no loads"),
         (1, 256, 7, "256 cp.async unrolled, none of the three"))


def build() -> ctypes.CDLL:
    from ..ops import _build
    target = _build.BUILD_DIR / "libmomentum_forms.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(target), str(SOURCE)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{out.stderr}")
    print(f"built {SOURCE.name} in {time.time() - t0:.1f} s", flush=True)
    lib = ctypes.CDLL(str(target))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.momentum_form.argtypes = [I, I, I, I, P, P, P, P, I, I, I, P, P]
    lib.momentum_form.restype = I
    return lib


def planes(grid, seed: int, device):
    """A seeded momentum block: r (2, ny, nx), D^-1 and off (4, ny, nx),
    drawn as tests/torch_spatial_ranks.stencil_planes draws them."""
    import torch
    ny, nx = grid
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    off = t(rng.standard_normal((4, ny, nx)) * 0.1)
    dinv = t(1.0 / rng.uniform(1.0, 2.0, (ny, nx)).astype(np.float32))
    r = t(rng.standard_normal((2, ny, nx)))
    return r, dinv, off


def event_ms(fn, reps: int = 30) -> float:
    """Mean ms of single calls, each after zeroing a 1 GiB buffer (the L2
    write flush of chip_smoke.cuda_time_ms)."""
    import torch
    flush = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def main(argv=None) -> int:
    import torch
    from ..ops import stencil_kernels as sk
    if not torch.cuda.is_available():
        print("momentum_forms: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for (ny, nx), sweeps in SHAPES:
        r, dinv, off = planes((ny, nx), 29, "cuda")
        ref = sk.momentum_jacobi_ref(r, dinv, off, sweeps)
        out = torch.empty_like(r)
        shape = f"{ny}x{nx}_{sweeps}"
        for form, threads, drop, label in FORMS:
            occ = ctypes.c_int(0)
            err = lib.momentum_form(form, threads, drop, sweeps, None, None,
                                    None, None, ny, nx, 1, None,
                                    ctypes.addressof(occ))
            if err or occ.value < 1:
                raise RuntimeError(f"{label}: occupancy query failed ({err})")
            h = sweeps - 1
            bands = -(-nx // (threads - 2 * h))
            tile_rows = -(-ny // max(1, min(ny, n_sm * occ.value // bands)))

            def call():
                e = lib.momentum_form(form, threads, drop, sweeps,
                                      r.data_ptr(), dinv.data_ptr(),
                                      off.data_ptr(), out.data_ptr(), ny, nx,
                                      tile_rows, stream, None)
                if e:
                    raise RuntimeError(f"{label}: launch failed ({e})")

            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            equal = bool(torch.equal(out, ref))
            if drop == 0 and not equal:
                raise RuntimeError(f"{label} at {shape} differs from "
                                   "momentum_jacobi_ref")
            ms = event_ms(call)
            rows[f"{label} @ {shape}"] = ms
            print(f"{shape}: {label}: {occ.value} blocks/SM, {bands} bands "
                  f"of {threads - 2 * h} columns x rows of {tile_rows}: "
                  f"{ms:.4f} ms, bit-equal {equal}", flush=True)
        ms = event_ms(lambda: sk.momentum_jacobi(r, dinv, off, sweeps))
        rows[f"committed wrapper @ {shape}"] = ms
        print(f"{shape}: the committed wrapper: {ms:.4f} ms", flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "momentum_forms_ms": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
