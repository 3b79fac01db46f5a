"""Solver state carried into the port from arrays.

* :func:`state_from_arrays` / :func:`params_from_arrays` build the port's
  :class:`SolverState` / :class:`SolverParams` on a device from the JAX
  package's fields as numpy arrays (field name -> array, device cell order).
  The caller does the unpacking (``np.asarray(getattr(jax_state, f))``), so
  this package never touches JAX.
* :func:`load_developed_state` loads a developed-flow checkpoint such as
  ``bench_developed_1m.npz`` into a :class:`CoupledSolver`, as the JAX
  package's ``bench.py`` does.
"""

from __future__ import annotations

import json
from dataclasses import replace

import numpy as np
import torch

from .runtime.state import (PARAMS_FIELDS, STATE_FIELDS, SolverParams,
                            SolverState)

_INT_FIELDS = ("degenerate_count", "steady_count", "outer_iters",
               "linear_iters", "linear_iters_total")


def _as_tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name == "should_stop":
        a = a.astype(bool)
    elif name in _INT_FIELDS:
        a = a.astype(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def _missing(arrays, names):
    lost = [f for f in names if f not in arrays]
    if lost:
        raise KeyError(f"missing fields: {', '.join(lost)}")


def state_from_arrays(arrays: dict, device) -> SolverState:
    """SolverState on ``device`` from a dict of every SolverState field as a
    numpy array, in device cell order (both packages lay a mesh out
    identically: the (ny, nx) grid, or the generic band order)."""
    _missing(arrays, STATE_FIELDS)
    return SolverState(**{f: _as_tensor(f, arrays[f], device)
                          for f in STATE_FIELDS})


def params_from_arrays(arrays: dict, device) -> SolverParams:
    """SolverParams on ``device`` from a dict of every SolverParams field."""
    _missing(arrays, PARAMS_FIELDS)
    return SolverParams(**{f: _as_tensor(f, arrays[f], device)
                           for f in PARAMS_FIELDS})


def load_developed_state(solver, path) -> dict:
    """Load a developed-flow checkpoint (keys ``u`` (ny, nx, 2), ``p``
    (ny, nx), ``meta`` JSON) into ``solver``: u and p masked to the fluid
    cells, the history fields set to u, and the viscosity taken from
    ``meta``.  Returns ``meta``.  Raises if the checkpoint's grid is not the
    solver's."""
    with np.load(path) as d:
        meta = json.loads(str(d["meta"]))
        u = d["u"].astype(np.float32)
        p = d["p"].astype(np.float32)
    mesh = solver.mesh
    if tuple(meta["grid"]) != tuple(mesh.grid_shape):
        raise ValueError(f"checkpoint grid {meta['grid']} != mesh grid "
                         f"{mesh.grid_shape}")
    ny, nx = mesh.grid_shape
    valid = mesh.c_valid
    u = torch.as_tensor(u.reshape(ny * nx, 2), device=solver.device) \
        * valid[:, None]
    p = torch.as_tensor(p.reshape(ny * nx), device=solver.device) * valid
    solver.state = replace(solver.state, u=u, u_old=u, u_old_old=u,
                           prev_u=u, p=p)
    solver.set_viscosity(meta["viscosity"])
    return meta
