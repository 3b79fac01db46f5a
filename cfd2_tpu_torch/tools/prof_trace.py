"""A kernel-level trace of host-mode steps of the structured path.

The port's counterpart of the JAX package's ``tools/prof_trace.py``: the
channel from rest at ``min_cell`` (0.0017: 996,558 cells; restarts 5), 2
warm host-mode steps, then ``n_steps`` host-mode steps traced with
``runtime/profiling.trace`` (``torch.profiler``; its Chrome trace goes to
the port's own temporary directory, ``cfd2_tpu_torch_trace`` under the
system's, never the JAX tool's ``/tmp/cfd2_trace``).  Device kernel time is
summed by kernel name and by ``profile_step``'s groups (what issues the
kernel), with the device's busy time against the traced wall.  On the CPU
there is no device and the host's operators are summed instead.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.prof_trace [min_cell] [n_steps] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict

import torch

from . import probes


def run(min_cell: float = 0.0017, n_steps: int = 1, device=None, mesh=None,
        logdir=None, log=print) -> dict:
    """The trace (see the module docstring); returns the traced steps'
    outers, the wall, the device busy time (None on the CPU), time and
    count by kernel name and by group.  ``logdir``: where the trace is
    written (default ``runtime/profiling.trace``'s)."""
    from ..profile_step import busy_us, kernel_group
    from ..runtime.device_mesh import resolve_device
    from ..runtime.profiling import ProfilingStats
    device = resolve_device(device)
    t0 = time.time()
    if mesh is None:
        mesh = probes.channel_mesh(min_cell)
    s = probes.channel_solver(mesh, min_cell, device, fgmres_max_restarts=5)
    log(f"# mesh {s.mesh.num_cells} on {device} in {time.time() - t0:.0f}s")
    warm_outers = []
    for _ in range(2):
        s.step(mode="host")
        warm_outers.append(int(s.state.outer_iters))
    probes.sync(device)
    log(f"# warm done ({time.time() - t0:.0f}s), outers {warm_outers}; "
        f"tracing {n_steps} steps")
    outers = []
    t0 = time.perf_counter()
    with ProfilingStats().trace(logdir, device) as prof:
        for _ in range(n_steps):
            s.step(mode="host")
            outers.append(int(s.state.outer_iters))
    wall = time.perf_counter() - t0
    log(f"# traced wall: {wall:.3f}s, outers {outers}")
    on_card = device.type == "cuda"
    kind = (torch.autograd.DeviceType.CUDA if on_card
            else torch.autograd.DeviceType.CPU)
    evs = [e for e in prof.events() if e.device_type == kind]
    busy = busy_us(evs) * 1e-6 if on_card else None
    by_name = defaultdict(lambda: [0.0, 0])
    for e in evs:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    by_group = defaultdict(lambda: [0.0, 0])
    for name, (ms, cnt) in by_name.items():
        g = by_group[kernel_group(name)]
        g[0] += ms
        g[1] += cnt
    total = sum(v[0] for v in by_name.values())
    what = "device kernels" if on_card else "host operators (no device)"
    log(f"# {what}: {total:.1f} ms over {wall * 1e3:.0f} ms wall "
        f"({len(by_name)} names)"
        + ("" if busy is None else f", busy {busy * 1e3:.1f} ms, idle share "
           f"{1 - busy / wall:.4f}"))
    if on_card:
        for label, (ms, cnt) in sorted(by_group.items(),
                                       key=lambda kv: -kv[1][0]):
            log(f"{ms:9.2f} ms  x{cnt:<6d} {label}")
    for name, (ms, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:40]:
        log(f"{ms:9.2f} ms  x{cnt:<6d} {ms / max(cnt, 1):8.4f} ms/call  "
            f"{name[:110]}")
    return dict(warm_outers=warm_outers, outers=outers, wall_s=wall,
                busy_s=busy, by_name=dict(by_name), by_group=dict(by_group))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("min_cell", nargs="?", type=float, default=0.0017)
    ap.add_argument("n_steps", nargs="?", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.min_cell, a.n_steps, a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
