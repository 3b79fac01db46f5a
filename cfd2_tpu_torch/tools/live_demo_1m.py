"""Drive the live viewer on the 1M-cell channel: start the server, let the
solver step, read ``/status``, fetch a rendered frame, apply a mid-run
control and check that the solver took it.

The port's counterpart of the JAX package's ``tools/live_demo_1m.py``, with
its environment: ``LIVE_CELL`` (0.0017: 996,558 cells) and ``LIVE_WAIT``
(seconds to wait for 3 steps, 900).  The frame is fetched only where
matplotlib imports (the renderer needs it), and written only to ``--out``:
a path under a directory the repository's ``.gitignore`` lists, such as
``.bench_cache/``.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.live_demo_1m [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import urllib.request
from pathlib import Path


def get(url: str, timeout: float = 600) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def run(cell: float | None = None, device=None, out=None, steps: int = 3,
        wait: float | None = None, inlet: float = 1.2, log=print) -> dict:
    """The demo: the server steps the solver until ``steps`` steps are done
    (or ``wait`` s pass: an error), then the frame (where matplotlib
    imports; written to ``out`` when given) and the inlet control.
    Returns the cells, the steps seen, the frame's bytes and seconds (None
    without matplotlib) and the inlet the solver reads back."""
    from ..app import Simulation
    from ..viz.live_server import LiveServer
    cell = float(os.environ.get("LIVE_CELL", "0.0017")) if cell is None \
        else cell
    wait = float(os.environ.get("LIVE_WAIT", "900")) if wait is None \
        else wait
    t0 = time.time()
    sim = Simulation(geometry="channel", mesh_type="cutcell", cell_size=cell,
                     precond=1, dt0=min(0.002, 0.4 * cell), device=device)
    log(f"# mesh {sim.mesh.num_cells} cells ({time.time() - t0:.0f}s) on "
        f"{sim.device}; structured={sim.solver.mesh.structured}")
    server = LiveServer(sim, port=0).start()
    base = server.url
    try:
        deadline = time.time() + wait
        while True:
            s = json.loads(get(base + "status"))
            log(f"# step {s['step']} busy={s['busy']} t={s['time']:.5f}")
            if s["step"] >= steps or time.time() > deadline:
                break
            time.sleep(0.5)
        if s["step"] < steps:
            raise RuntimeError(f"the solver did not advance {steps} steps "
                               f"in {wait} s: {s}")
        frame_bytes = frame_s = None
        if importlib.util.find_spec("matplotlib") is None:
            log("# matplotlib does not import here: no frame fetched")
        else:
            t1 = time.time()
            png = get(base + "frame.png?field=mag")
            frame_s = time.time() - t1
            if png[:4] != b"\x89PNG":
                raise RuntimeError("the frame is not a PNG")
            frame_bytes = len(png)
            if out is not None:
                out = Path(out)
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_bytes(png)
            log(f"# frame rendered in {frame_s:.2f}s -> {out} "
                f"({frame_bytes} bytes)")
        # The mid-run control against the live solver.
        get(base + f"control?inlet={inlet}")
        got = float(sim.solver.params.inlet_velocity)
        if abs(got - inlet) > 1e-6:
            raise RuntimeError(f"control?inlet={inlet}: the solver reads "
                               f"{got}")
        log(f"# mid-run inlet control OK ({got})")
        res = dict(cells=int(sim.mesh.num_cells), steps=int(s["step"]),
                   frame_bytes=frame_bytes, frame_seconds=frame_s,
                   inlet=got, device=str(sim.device))
        log(json.dumps(res))
        return res
    finally:
        server.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the frame here (a gitignored directory)")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(device=a.device, out=a.out, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
