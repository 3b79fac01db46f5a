"""Checkpoint / resume of solver state.

Port of ``cfd2_tpu.runtime.checkpoint``:

* the ``.npz`` pair: the full :class:`SolverState` and :class:`SolverParams`
  round-trip through one ``.npz`` with keys ``state.<field>`` /
  ``params.<field>``, so a checkpoint written by either package loads in
  the other (both lay a mesh's cells out the same way on the device);
* the distributed pair (the counterparts of the JAX package's
  ``save_checkpoint_orbax`` / ``load_checkpoint_orbax``):
  :func:`save_checkpoint_dcp` writes the same fields as a
  ``torch.distributed.checkpoint`` directory, every rank of a row-sharded
  state writing its own rows, and :func:`load_checkpoint_dcp` reads it into
  any number of ranks, or into one process with no group.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _payload(state: SolverState, params: SolverParams | None) -> dict:
    out = {f"state.{f}": getattr(state, f) for f in STATE_FIELDS}
    if params is not None:
        out.update({f"params.{f}": getattr(params, f) for f in PARAMS_FIELDS})
    return out


def _row_mesh(decomp):
    """A 1-D device mesh over the decomposition's group, and the device
    type its shards live on: the host under gloo (the rows are staged
    there, as the halos are), the card under NCCL."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    kind = "cpu" if decomp.transport == "gloo" else decomp.device.type
    return DeviceMesh.from_group(decomp.group or dist.group.WORLD, kind), kind


def _unpack(sd: dict, device):
    scopes = {"state": {}, "params": {}}
    for key, t in sd.items():
        scope, name = key.split(".", 1)
        scopes[scope][name] = t.detach().cpu().numpy()
    state = state_from_arrays(scopes["state"], device)
    params = (params_from_arrays(scopes["params"], device)
              if scopes["params"] else None)
    return state, params


def save_checkpoint_dcp(path, state: SolverState,
                        params: SolverParams | None = None,
                        decomp=None) -> None:
    """Write state (and params) as a ``torch.distributed.checkpoint``
    directory at ``path``, keys as in the ``.npz`` pair.

    ``decomp``: the state is one rank's rows of a row-sharded mesh
    (parallel/spatial.py) and every rank of the group calls this: each
    cell-sized field goes in as a ``DTensor`` sharded along its rows
    (``Shard(0)``) on a 1-D device mesh of the group, every other field as
    a plain tensor (written once).  None: one process writes everything."""
    import torch.distributed.checkpoint as dcp
    payload = _payload(state, params)
    if decomp is None:
        dcp.save({k: v.detach().cpu() for k, v in payload.items()},
                 checkpoint_id=str(path), no_dist=True)
        return
    from torch.distributed.tensor import DTensor, Shard
    mesh, kind = _row_mesh(decomp)
    rows = decomp.block * decomp.row_size
    sd = {}
    for k, v in payload.items():
        v = v.detach().to(kind)
        if v.dim() >= 1 and v.shape[0] == rows:
            v = DTensor.from_local(v.contiguous(), mesh, [Shard(0)],
                                   run_check=False)
        sd[k] = v
    dcp.save(sd, checkpoint_id=str(path),
             process_group=decomp.group)


def load_checkpoint_dcp(path, decomp=None, device=None):
    """Read ``(state, params | None)`` from a :func:`save_checkpoint_dcp`
    directory, whatever world size wrote it.  ``decomp`` None: one process
    (no group needed) reads the whole state onto ``device`` (None means
    CUDA).  With ``decomp`` every rank of its group calls this and gets its
    own rows of the cell-sized fields (and every other field) on the
    decomposition's device."""
    import torch.distributed.checkpoint as dcp
    meta = dcp.FileSystemReader(str(path)).read_metadata()
    shapes = {k: (tuple(m.size), m.properties.dtype)
              for k, m in meta.state_dict_metadata.items()}
    if decomp is None:
        device = resolve_device(device)
        sd = {k: torch.empty(shape, dtype=dt) for k, (shape, dt)
              in shapes.items()}
        dcp.load(sd, checkpoint_id=str(path), no_dist=True)
        return _unpack(sd, device)
    from torch.distributed.tensor import DTensor, Shard
    mesh, kind = _row_mesh(decomp)
    whole = decomp.rows * decomp.row_size
    sd = {}
    for k, (shape, dt) in shapes.items():
        if len(shape) >= 1 and shape[0] == whole:
            local = torch.empty((shape[0] // decomp.world,) + shape[1:],
                                dtype=dt, device=kind)
            sd[k] = DTensor.from_local(local, mesh, [Shard(0)],
                                       run_check=False)
        else:
            sd[k] = torch.empty(shape, dtype=dt, device=kind)
    dcp.load(sd, checkpoint_id=str(path), process_group=decomp.group)
    return _unpack({k: v.to_local() if isinstance(v, DTensor) else v
                    for k, v in sd.items()}, decomp.device)
