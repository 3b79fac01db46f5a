"""What the solver-probing tools share (``iters_1m``, ``prof_step_iters``,
``prof_precond``, ``prof_amg_variants``, ``bf16_smoke``): the obstacle
channel of the JAX package's same tools (3 x 1, a cylinder of radius 0.2 at
(1, 0.5), growth 1.2) started from rest with the inlet column at 1, a
host-mode step whose per-outer FGMRES iterations are read off its verbose
lines, and the clock of the device the solver runs on."""

from __future__ import annotations

import contextlib
import io
import re
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
