"""What the solver-probing tools share (``iters_1m``, ``prof_step_iters``,
``prof_precond``, ``prof_amg_variants``, ``bf16_smoke`` and the profiling
tools ``prof_*``, ``probe_bf16``): the obstacle channel of the JAX package's
same tools (3 x 1, a cylinder of radius 0.2 at (1, 0.5), growth 1.2)
started from rest with the inlet column at 1, a host-mode step whose
per-outer FGMRES iterations are read off its verbose lines, the clock of
the device the solver runs on, and the per-phase timer of the profiling
tools (:func:`time_phase`)."""

from __future__ import annotations

import contextlib
import io
import re
import time
from dataclasses import replace

import numpy as np

_LIN = re.compile(r"lin_it=(\d+)")


def channel_mesh(size: float, mesh_type: str = "cutcell",
                 max_cell: float = 0.0):
    """The tools' channel at ``size`` (``max_cell`` > size: a refined
    cut-cell mesh growing to it) as a host Mesh."""
    from ..mesh import (ChannelWithObstacle, generate_cut_cell_mesh,
                        generate_delaunay_mesh, generate_voronoi_mesh)
    gen = {"cutcell": generate_cut_cell_mesh,
           "delaunay": generate_delaunay_mesh,
           "voronoi": generate_voronoi_mesh}[mesh_type]
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return gen(geo, size, max(max_cell, size), 1.2, (3.0, 1.0))


def channel_solver(mesh, size: float, device=None, **config):
    """The tools' solver on ``mesh``: dt min(0.002, 0.4 size), viscosity
    0.01, density 1, ``precond_type=1``, the ``config`` overrides, u zero
    but 1 in the inlet column (cell centres below x = 2 size)."""
    from ..models.coupled import CoupledSolver
    s = CoupledSolver(mesh, device=device)
    s.set_dt(min(0.002, 0.4 * size))
    s.set_viscosity(0.01)
    s.set_density(1.0)
    s.set_precond_type(1)
    if config:
        s.config = replace(s.config, **config)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 2 * size, 0] = 1.0
    s.set_u(u0)
    return s


def ladder(lines) -> list:
    """The per-outer FGMRES iterations of ``step_host(..., verbose=True)``'s
    lines (either package prints ``lin_it=N`` once per outer)."""
    return [int(m.group(1)) for m in map(_LIN.search, lines) if m]


def ladder_step(s, log=print) -> list:
    """One host-mode step of solver ``s`` with its verbose per-outer lines,
    each passed to ``log``; returns the step's FGMRES iterations per
    outer."""
    from ..models.coupled import step_host
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s.state = step_host(s.mesh, s.state, s.params, s.config,
                            s._get_amg(), verbose=True)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(line)
    return ladder(lines)


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host clock around the call times the work and not its enqueue."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def hand_launches() -> dict:
    """Every hand kernel's launches since the wrappers' last reset."""
    from ..ops import banded_kernels as bk
    from ..ops import stencil_kernels as sk
    return {**sk.LAUNCHES, **bk.LAUNCHES}


def time_phase(label: str, fn, device, reps: int = 1, warmup: int = 1,
               per: int = 1, prof_reps=None, log=print):
    """Time ``fn()`` as one phase of a profiling tool, on the solver's
    device.  After ``warmup`` calls:

    * ``reps`` calls bare, for the host's wall time: from the first call to
      the end of a ``torch.cuda.synchronize()`` after the last, and the
      hand kernels' launches (the wrappers' counters);
    * on CUDA, ``prof_reps`` calls (default ``reps``) under
      ``torch.profiler`` for the device's busy time (the union of the
      kernel intervals, as ``profile_step`` counts it) and the number of
      kernels of every kind.  Phases of ~1e5 kernels take one call
      here.

    The idle share is 1 - busy / wall (the two passes are separate runs:
    a phase that keeps the device busy throughout may show a share a
    little under 0).  Every number is per call of ``fn`` and divided by
    ``per`` (``fn`` repeats the phase ``per`` times, as the JAX tools'
    ``fori_loop`` bodies did).  Nothing is subtracted from the wall.  On
    the CPU there is no device time (None).  On the card the profiler
    drops kernel records in some sessions (short ones most); where it
    recorded fewer kernels than the bare pass launched hand kernels, the
    device time is not measured (None, ``lost`` true).  Returns (the last
    call's output, the row), and logs the row."""
    import torch
    from ..profile_step import union_length
    device = torch.device(device)
    out = None
    for _ in range(warmup):
        out = fn()
    sync(device)
    before = hand_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(device)
    wall = (time.perf_counter() - t0) / (reps * per)
    n = reps * per
    launches = {k: (v - before[k]) / n for k, v in hand_launches().items()
                if v != before[k]}
    busy = kernels = None
    lost = False
    if device.type == "cuda":
        pr = reps if prof_reps is None else prof_reps
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)     # the session settles before the phase
            for _ in range(pr):
                out = fn()
            sync(device)
        # The profiler's raw records: building its event tree for ~1e5
        # kernels took the host longer than the phase.
        cuda = torch.autograd.DeviceType.CUDA
        iv = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
        kernels = len(iv) / (pr * per)
        lost = kernels == 0 or kernels < sum(launches.values())
        if not lost:
            busy = union_length(iv) * 1e-9 / (pr * per)
    row = dict(phase=label, wall_ms=wall * 1e3,
               device_ms=None if busy is None else busy * 1e3,
               idle=None if busy is None else 1.0 - busy / wall,
               kernels=kernels, launches=launches, lost=lost)
    log(phase_line(row))
    return out, row


def phase_line(row: dict) -> str:
    """One row of :func:`time_phase` as a line of text."""
    line = f"{row['phase']:28s} wall {row['wall_ms']:10.3f} ms"
    if row["device_ms"] is not None:
        line += (f"  device {row['device_ms']:10.3f} ms  idle "
                 f"{row['idle']:.4f}  kernels {row['kernels']:8.1f}")
    elif row["lost"]:
        line += (f"  device not measured (the profile kept "
                 f"{row['kernels']:.1f} kernels a call)")
    if row["launches"]:
        line += "  hand " + ", ".join(f"{k} {v:g}" for k, v in
                                      sorted(row["launches"].items()))
    return line
