"""The Strouhal number and force coefficients of a developed vortex street,
on the port.

The counterpart of the JAX package's ``tools/measure_strouhal.py``: a
structured developed state (by default the port cascade's
``cfd2_tpu_torch/data/developed_1m_card.npz``; ``bench_developed_1m.npz`` is
read by naming it) is restricted bilinearly onto the 0.0068 mesh (62k cells)
where steps are cheap, healed for 150 adaptive steps (CFL 0.4, the cascade's
configuration of :mod:`.make_developed`), then stepped over an 8 s span with
Cd and Cl read every 10 steps (``utils/forces.force_coefficients``, D = 0.4,
U = 1).  St comes from the mean period between up-crossings of Cl
(``strouhal_number``); a steady or degenerate state gives St = 0.

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.measure_strouhal [size] [t_span] \\
        [--checkpoint PATH] [--heal-steps N] [--batch N] [--device cpu]

Prints one JSON line: St, Cd_mean, Cl_amp, Re, cells, span, samples and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import make_developed as md
from .records import card_line

SIZE = 0.0068
T_SPAN = 8.0
HEAL_STEPS = 150
BATCH = 10


def run(checkpoint=md.OUT, size: float = SIZE, t_span: float = T_SPAN,
        heal_steps: int = HEAL_STEPS, batch: int = BATCH, device=None,
        log=print) -> dict:
    """Restrict, heal and measure; returns the printed record.  The span
    always takes at least one batch: a ``t_span`` under one batch's time
    gives one force sample."""
    from ..models.coupled import multi_step_adaptive
    from ..runtime.device_mesh import resolve_device
    from ..utils.forces import (force_coefficients, obstacle_face_mask,
                                strouhal_number)
    device = resolve_device(device)
    with np.load(checkpoint) as d:
        meta = json.loads(str(d["meta"]))
        u_c, p_c = d["u"].astype(np.float32), d["p"].astype(np.float32)
        h_c = float(d["h"])
    s = md.make_solver(size, device, log)
    s.set_viscosity(meta["viscosity"])
    md.prolong_into(s, u_c, p_c, h_c)
    w = obstacle_face_mask(s.mesh)
    amg = s._get_amg()

    def steps(n):
        s.state, s.params, _ = multi_step_adaptive(
            s.mesh, s.state, s.params, s.config, n, target_cfl=md.CFL,
            min_cell_size=size, amg=amg)

    t0 = time.time()
    steps(heal_steps)
    log(f"# healed {heal_steps} steps to t={float(s.state.time):.2f} "
        f"({time.time() - t0:.0f}s)")
    times, cds, cls = [], [], []
    t_start = float(s.state.time)
    t0 = time.time()
    while float(s.state.time) - t_start < t_span:
        steps(batch)
        cd, cl = force_coefficients(s.mesh, s.state, s.params, w,
                                    u_ref=1.0, d_ref=0.4)
        times.append(float(s.state.time))
        cds.append(float(cd))
        cls.append(float(cl))
        if len(times) % 50 == 0:
            log(f"#  t={times[-1]:.2f} Cd={cds[-1]:.3f} Cl={cls[-1]:+.3f} "
                f"({time.time() - t0:.0f}s)")
        if not np.isfinite(cds[-1]):
            raise FloatingPointError("diverged")
    times, cls_a = np.array(times), np.array(cls)
    step0 = times[1] - times[0] if len(times) > 1 else 0.0
    dts = np.diff(times, prepend=times[0] - step0)
    st = strouhal_number(cls_a, dts, u_ref=1.0, d_ref=0.4)
    tail = cls_a[len(cls_a) // 3:]
    out = {"St": round(st, 4),
           "Cd_mean": round(float(np.mean(cds[len(cds) // 3:])), 4),
           "Cl_amp": round(float(tail.max() - tail.min()) / 2, 4),
           "Re": round(0.4 / meta["viscosity"]),
           "cells": int(s.mesh.num_host_cells),
           "t_span": round(float(times[-1] - times[0]), 2),
           "samples": len(times), "heal_steps": heal_steps,
           "checkpoint": str(checkpoint), "wall_s": round(time.time() - t0, 1),
           "device": str(device), "card": card_line(device)}
    log(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", nargs="?", type=float, default=SIZE)
    ap.add_argument("t_span", nargs="?", type=float, default=T_SPAN)
    ap.add_argument("--checkpoint", default=str(md.OUT))
    ap.add_argument("--heal-steps", type=int, default=HEAL_STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.checkpoint, a.size, a.t_span, a.heal_steps, a.batch,
        device=a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
