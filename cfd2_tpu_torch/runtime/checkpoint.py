"""Checkpoint / resume of solver state.

Port of the ``.npz`` pair of ``cfd2_tpu.runtime.checkpoint``: the full
:class:`SolverState` and :class:`SolverParams` round-trip through one
``.npz`` with keys ``state.<field>`` / ``params.<field>``, so a checkpoint
written by either package loads in the other (both lay a mesh's cells out
the same way on the device).
"""

from __future__ import annotations

import numpy as np

from ..convert import params_from_arrays, state_from_arrays
from .device_mesh import resolve_device
from .state import PARAMS_FIELDS, STATE_FIELDS, SolverParams, SolverState


def save_checkpoint(path, state: SolverState,
                    params: SolverParams | None = None) -> None:
    """Write state (and params) to an ``.npz`` file."""
    arrs = {f"state.{f}": getattr(state, f).detach().cpu().numpy()
            for f in STATE_FIELDS}
    if params is not None:
        arrs.update({f"params.{f}": getattr(params, f).detach().cpu().numpy()
                     for f in PARAMS_FIELDS})
    np.savez_compressed(path, **arrs)


def load_checkpoint(path, device=None):
    """Read ``(state, params | None)`` from an ``.npz`` file onto ``device``
    (None means CUDA, see device_mesh.resolve_device).  A checkpoint written
    before ``linear_iters_total`` existed gets 0 there."""
    device = resolve_device(device)
    scopes = {"state": {}, "params": {}}
    with np.load(path) as data:
        for key in data.files:
            scope, name = key.split(".", 1)
            scopes[scope][name] = data[key]
    skw, pkw = scopes["state"], scopes["params"]
    skw.setdefault("linear_iters_total", np.int32(0))
    state = state_from_arrays(skw, device)
    params = params_from_arrays(pkw, device) if pkw else None
    return state, params
