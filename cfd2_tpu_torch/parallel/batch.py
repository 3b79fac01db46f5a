"""Batches of independent simulations on one mesh.

Port of ``cfd2_tpu.parallel.batch``: B cases of the same mesh — ensemble
runs, parameter sweeps.  A batched state is a :class:`SolverState` whose
tensors carry a leading B axis (a scalar field becomes a (B,) tensor); a
parameter sweep is a :class:`SolverParams` whose swept fields are (B,)
tensors.

The JAX package vmaps its step, and under vmap each case's loop carry
freezes once that case's loop ends, so every case equals its own single
step.  A step here has data-dependent loops and host reads, which torch
cannot vmap.  So the B cases run one after another: a case is sliced out,
stepped by :func:`..models.coupled.step` and written back.  Each case is
exactly its own single step; this is not a speed feature.

:func:`shard_batch` places a batched state on its device.  One mesh lives
on one device, so in one process the batch must lie on the mesh's device
(on one H100 that is ``cuda:0``).  Over several devices the cases are split
over ``torch.distributed`` ranks (parallel/launch.py): given a
:class:`~.spatial.RowDecomposition` of the B cases, :func:`shard_batch`
gives each rank its own contiguous share, which it steps on its device with
its own copy of the mesh (no collective: the cases are independent), and
:func:`gather_batch` brings every case back to every rank.

Unlike the JAX functions, the stepping functions take the multigrid
hierarchy as an optional ``amg`` (the JAX ones step without one, which
with ``precond_type=1`` selects the Chebyshev pressure relaxation, as
``amg=None`` does here).
"""

from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch

from ..models.coupled import multi_step, step
from ..runtime.state import SolverParams, SolverState, initial_state
from .spatial import RowDecomposition


def _case(bstate: SolverState, i: int) -> SolverState:
    return SolverState(**{f.name: getattr(bstate, f.name)[i]
                          for f in fields(SolverState)})


def _stack(states: list) -> SolverState:
    return SolverState(**{f.name: torch.stack([getattr(s, f.name)
                                               for s in states])
                          for f in fields(SolverState)})


def _case_params(bparams: SolverParams, i: int, batch: int) -> SolverParams:
    """Case ``i``'s parameters: a (B,) field gives its i-th value, a 0-d
    field is shared."""
    out = {}
    for f in fields(SolverParams):
        v = getattr(bparams, f.name)
        if v.ndim >= 1:
            if v.shape[0] != batch:
                raise ValueError(f"params.{f.name} has {v.shape[0]} cases, "
                                 f"the batch {batch}")
            v = v[i]
        out[f.name] = v
    return SolverParams(**out)


def _per_case(mesh, bstate: SolverState, fn) -> SolverState:
    """``fn(i, case) -> state`` over every case, stacked back into a
    batched state; the batch must lie on the mesh's device."""
    where = mesh.c_valid.device          # indexed ("cuda:0", not "cuda")
    if bstate.u.device != where:
        raise ValueError(f"the batch lies on {bstate.u.device}, the mesh on "
                         f"{where}: one mesh steps the cases of its own "
                         "device")
    return _stack([fn(i, _case(bstate, i))
                   for i in range(bstate.u.shape[0])])


def batched_initial_state(mesh, batch: int, u0=None, p0=None) -> SolverState:
    """Stack B initial states along a leading batch axis."""
    one = initial_state(mesh, u0=u0, p0=p0)
    return _stack([one] * batch)


def shard_batch(bstate, devices):
    """Place a batched state (or batched params) on ``devices``:

    * a list of one device, which takes every case;
    * a :class:`~.spatial.RowDecomposition` of the B cases over the ranks
      of a group: this rank's cases (a (B, ...) field cut to them, a 0-d
      field copied, as the JAX package shards ``x.ndim >= 1``) on the
      rank's device."""
    if isinstance(devices, RowDecomposition):
        d = devices
        cases = {getattr(bstate, f.name).shape[0] for f in fields(bstate)
                 if getattr(bstate, f.name).ndim >= 1}
        if cases - {d.rows}:
            raise ValueError(f"{sorted(cases)} cases, the decomposition "
                             f"covers {d.rows}")
        return type(bstate)(**{
            f.name: (v[d.r0:d.r1] if v.ndim >= 1 else v).to(d.device)
            for f in fields(bstate) for v in [getattr(bstate, f.name)]})
    devices = [torch.device(d) for d in devices]
    if len(devices) != 1:
        raise ValueError(f"{len(devices)} devices: one process places a "
                         "batch on one device; over several devices the "
                         "cases are split over ranks (pass a "
                         "RowDecomposition of the cases)")
    return SolverState(**{f.name: getattr(bstate, f.name).to(devices[0])
                          for f in fields(SolverState)})


def gather_batch(bstate, decomp: RowDecomposition):
    """Every case of a batch split by :func:`shard_batch` over ``decomp``,
    on every rank (one all-gather per field)."""
    return type(bstate)(**{
        f.name: (decomp.all_gather_rows(v) if v.ndim >= 1 else v)
        for f in fields(bstate) for v in [getattr(bstate, f.name)]})


def batched_step(mesh, bstate: SolverState, params: SolverParams, config,
                 amg=None):
    """One timestep for every case in the batch (same mesh, shared
    params)."""
    return _per_case(mesh, bstate,
                     lambda i, s: step(mesh, s, params, config, amg))


def batched_multi_step(mesh, bstate: SolverState, params: SolverParams,
                       config, num_steps: int, amg=None):
    """N steps of :func:`..models.coupled.multi_step` for every case;
    returns (bstate, metrics) with each metric a (B, num_steps) tensor."""
    rows = []

    def run(i, s):
        s, metrics = multi_step(mesh, s, params, config, num_steps, amg)
        rows.append(metrics)
        return s

    out = _per_case(mesh, bstate, run)
    metrics = {k: torch.stack([r[k] for r in rows]) for k in rows[0]} \
        if rows and rows[0] else {}
    return out, metrics


def batched_params(params: SolverParams, overrides: dict) -> SolverParams:
    """``params`` with selected fields overridden by per-case values —
    parameter sweeps (e.g. a batch of viscosities); the other fields stay
    shared."""
    dev = params.dt.device
    return replace(params, **{k: torch.as_tensor(np.asarray(v, np.float32),
                                                 device=dev)
                              for k, v in overrides.items()})


def sweep_step(mesh, bstate: SolverState, bparams: SolverParams, config,
               amg=None):
    """Like :func:`batched_step` but with per-case parameters (see
    :func:`batched_params`)."""
    n = bstate.u.shape[0]
    return _per_case(mesh, bstate, lambda i, s: step(
        mesh, s, _case_params(bparams, i, n), config, amg))
