"""Extend the developed cascade one level finer: 2M cells, on the port.

The counterpart of the JAX package's ``tools/make_developed_2m.py``: the 1M
developed state (by default the port cascade's
``cfd2_tpu_torch/data/developed_1m_card.npz``; ``--source`` names another,
such as ``bench_developed_1m.npz``) is prolonged bilinearly onto the
h = 0.0012 mesh (1,998,381 cells on 834 x 2500) and healed with 220 adaptive
steps in :mod:`.make_developed`'s configuration, so that the fine grid grows
its own wake.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.make_developed_2m [--heal-steps N] \\
        [--source PATH] [--out PATH] [--device cpu]

Writes ``.bench_cache/torch_developed_2m.npz`` (7 MB, not committed) in the
format of ``bench_developed_2m.npz`` and prints its meta.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import make_developed as md
from .mesh_cache import CACHE
from .records import card_line

OUT = CACHE / "torch_developed_2m.npz"
SIZE = 0.0012
HEAL_STEPS = 220


def run(source=md.OUT, out=OUT, heal_steps: int = HEAL_STEPS,
        size: float = SIZE, device=None, log=print) -> dict:
    """Prolong ``source`` onto the ``size`` mesh, heal, write ``out``;
    returns the written meta."""
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    with np.load(source) as d:
        u_c, p_c = d["u"].astype(np.float32), d["p"].astype(np.float32)
        h_c, meta_c = float(d["h"]), json.loads(str(d["meta"]))
    log(f"# source {source}: grid={u_c.shape[:2]} h={h_c:.5f} "
        f"amp={meta_c['probe_v_amplitude']:.3f}")
    t0 = time.time()
    s = md.make_solver(size, device, log)
    s.set_viscosity(meta_c["viscosity"])
    md.prolong_into(s, u_c, p_c, h_c)
    series = md.run_steps(s, heal_steps, size, label=f"L{size}", log=log)
    u_f, p_f, h_f = md.grid_fields(s)
    amp = md.probe_amplitude(series)
    meta = dict(viscosity=meta_c["viscosity"], density=meta_c["density"],
                time=float(s.state.time), grid=[int(x) for x in u_f.shape[:2]],
                probe_v_amplitude=amp, probe_xy=list(md.PROBE_XY),
                cells=int(s.host_mesh.num_cells), heal_steps=heal_steps,
                source=str(source), wall_s=round(time.time() - t0, 1),
                device=str(device), card=card_line(device))
    md.write_state(out, u_f, p_f, h_f, meta)
    log(json.dumps(meta))
    if amp < 0.05:
        log("# WARNING: wake probe amplitude small: the state may not be "
            "shedding yet")
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heal-steps", type=int, default=HEAL_STEPS)
    ap.add_argument("--source", default=str(md.OUT))
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.source, a.out, a.heal_steps, device=a.device,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
