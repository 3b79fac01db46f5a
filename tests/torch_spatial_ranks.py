"""Rank functions of the port's multi-rank tests (tests/test_torch_spatial.py,
test_torch_spatial_*.py, test_torch_batch.py, test_torch_checkpoint.py,
test_torch_cuda.py).

The ranks are spawned processes that import the function's module by name,
so this module imports neither JAX nor tests/conftest.py (which imports
JAX): only torch, numpy and the port.  Each function takes
``(rank, world, device, ...)`` as ``cfd2_tpu_torch.parallel.launch.run_ranks``
calls it and returns host data.  The ``*_over`` functions run one case per
world size in ``worlds`` inside one spawned group (the first w ranks as a
sub-group), so that a test pays for one spawn, not one per world size.
"""

from __future__ import annotations

import os
from dataclasses import fields, replace

import numpy as np
import torch
import torch.distributed as dist

from cfd2_tpu_torch.models.coupled import (multi_step_adaptive, step,
                                           step_host)
from cfd2_tpu_torch.ops import banded_kernels as bk
from cfd2_tpu_torch.ops import stencil_kernels as sk
from cfd2_tpu_torch.ops.amg import build_hierarchy_for_mesh, split_level
from cfd2_tpu_torch.parallel import spatial as sp
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
from cfd2_tpu_torch.runtime.state import (SolverConfig, SolverParams,
                                          initial_state)


def _counts(lin: int) -> dict:
    c = dict(sp.COUNT)
    c["per_iteration"] = {k: c[k] / max(lin, 1) for k in
                          ("exchanges", "allreduces", "allgathers")}
    return c


def _over(rank, world, worlds, fn):
    """``fn(group)`` on the first w ranks for each w in ``worlds`` (the
    whole group for w == world): {w: result} of this rank's cases."""
    out = {}
    for w in worlds:
        group = None if w == world else dist.new_group(list(range(w)),
                                                       backend="gloo")
        if rank < w:
            out[w] = fn(group)
    return out


def setup(host_mesh, device, pad_rows_to: int, u0, dt: float,
          config: dict, with_amg: bool, group=None):
    """The whole mesh encoded on the CPU (padded to ``pad_rows_to``
    rows), its hierarchy, the start state and params; then this rank's
    rows of mesh and state on ``device``."""
    dm = encode_mesh(host_mesh, device="cpu", pad_rows_to=pad_rows_to)
    cfg = replace(SolverConfig(), **config)
    amg = build_hierarchy_for_mesh(dm) if with_amg else None
    state = initial_state(dm, u0=u0)
    ny, nx = dm.grid_shape
    decomp = sp.RowDecomposition(ny, nx, transport="gloo", device=device,
                                 group=group)
    mesh = sp.shard_mesh(dm, decomp)
    state = sp.shard_state(dm, state, decomp)
    # initial_state on the sharded mesh makes this rank's rows of it.
    made = initial_state(mesh, u0=u0)
    for f in fields(state):
        assert torch.equal(getattr(made, f.name), getattr(state, f.name)), \
            f.name
    if amg is not None:
        amg = sp.shard_cellwise(amg, dm.num_cells, decomp)
    params = SolverParams.default(dt=dt, device=device)
    return mesh, state, params, cfg, amg, decomp


def sharded_step(host_mesh, device, pad_rows_to, u0, dt, config,
                 with_amg=False, mode="fused", group=None):
    """One step of the row-sharded mesh: this rank's rows of u and p, the
    outer and FGMRES counts, and the exchange and collective counts."""
    mesh, state, params, cfg, amg, decomp = setup(
        host_mesh, device, pad_rows_to, u0, dt, config, with_amg, group)
    sp.reset_counts()
    sk.reset_launches()
    if mode == "host":
        out = step_host(mesh, state, params, cfg, amg)
    else:
        out = step(mesh, state, params, cfg, amg)
    lin = int(out.linear_iters_total)
    return dict(u=out.u.cpu().numpy(), p=out.p.cpu().numpy(),
                outer=int(out.outer_iters), lin=lin,
                counts=_counts(lin), rows=(decomp.r0, decomp.r1),
                transport=decomp.describe(),
                rbgs_leg=sk.LAUNCHES["rbgs_leg"])


def sharded_steps_over(rank, world, device, worlds, host_worlds, host_mesh,
                       *args):
    """:func:`sharded_step` on the rank's device for each world size in
    ``worlds``, and the host-mode step for each in ``host_worlds`` (under
    the key ``(w, "host")``)."""
    out = _over(rank, world, worlds, lambda g: sharded_step(
        host_mesh, device, *args, group=g))
    host = _over(rank, world, host_worlds, lambda g: sharded_step(
        host_mesh, device, *args, mode="host", group=g))
    out.update({(w, "host"): v for w, v in host.items()})
    return out


def sharded_adaptive(host_mesh, device, pad_rows_to, u0, dt, config,
                     num_steps, min_cell, group=None):
    """``multi_step_adaptive`` with the structured multigrid on the
    row-sharded mesh: this rank's rows of u, the per-step dt and outer
    counts, and the first level the V-cycle runs whole."""
    mesh, state, params, cfg, amg, decomp = setup(
        host_mesh, device, pad_rows_to, u0, dt, config, True, group)
    out, params, metrics = multi_step_adaptive(
        mesh, state, params, cfg, num_steps=num_steps, target_cfl=0.5,
        min_cell_size=min_cell, amg=amg)
    return dict(u=out.u.cpu().numpy(), dt=metrics["dt"].cpu().numpy(),
                outer=metrics["outer_iters"].cpu().numpy(),
                split=split_level(amg, decomp))


def sharded_adaptive_over(rank, world, device, worlds, host_mesh, *args):
    """:func:`sharded_adaptive` on the rank's device for each world size in
    ``worlds``."""
    return _over(rank, world, worlds, lambda g: sharded_adaptive(
        host_mesh, device, *args, group=g))


def halo_rows(rank, world, device, grid, depths):
    """``halo_rows`` and ``extend`` of this rank's block of ``grid`` at each
    depth."""
    g = torch.as_tensor(grid, device=device)
    decomp = sp.RowDecomposition(g.shape[0], g.shape[1], transport="gloo",
                                 device=device)
    own = decomp.own_rows(g)
    out = {}
    for d in depths:
        south, north = decomp.halo_rows(own, d)
        ext, lo = decomp.extend(own, d)
        out[d] = (south.cpu().numpy(), north.cpu().numpy(),
                  ext.cpu().numpy(), lo)
    return dict(rows=(decomp.r0, decomp.r1), halos=out)


def fail_on(rank, world, device, bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a collective that never
    completes."""
    if rank == bad_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    t = torch.zeros(1)
    torch.distributed.all_reduce(t)
    return rank


def hang(rank, world, device, seconds):
    """Rank 0 sleeps for ``seconds``; the others wait for it in a
    collective."""
    import time
    if rank == 0:
        time.sleep(seconds)
    t = torch.zeros(1)
    torch.distributed.all_reduce(t)
    return rank


def banded_spmv(rank, world, device, dm, es, x, b, halo, fgmres_kw):
    """``banded_spmv_sharded`` on this rank's range of cells, and a sharded
    FGMRES solve with that operator and the diagonal preconditioner: this
    rank's rows of A x and of the solution, and the iteration count."""
    from cfd2_tpu_torch.ops.fgmres import fgmres_solve
    N = dm.num_cells
    decomp = sp.RowDecomposition(N, 1, transport="gloo", device=device)
    es_l = sp.shard_cellwise(es, N, decomp)
    loc = sp.local_banded_map(dm, decomp, halo)
    own = lambda v: torch.as_tensor(v, device=device)[:, decomp.cells]
    mv = lambda v: sp.banded_spmv_sharded(es_l, loc, v, decomp, halo)
    dinv = torch.stack([es_l.diag_u_inv, es_l.diag_u_inv, es_l.diag_p_inv])
    res = fgmres_solve(mv, lambda r: r * dinv, own(b),
                       torch.zeros_like(own(b)),
                       reduce=decomp.all_reduce_sum, **fgmres_kw)
    return dict(y=mv(own(x)).cpu().numpy(), x=res.x.cpu().numpy(),
                iterations=res.iterations, cells=(decomp.cells.start,
                                                  decomp.cells.stop))


def batch_cases(rank, world, device, host_mesh, u0s, viscosities):
    """The cases of a batched step and of a viscosity sweep split over the
    ranks (``shard_batch`` with a decomposition of the cases), stepped on
    each rank's device with its own mesh and gathered back: every case's
    u, p and counts, as every rank sees them."""
    from dataclasses import fields
    from cfd2_tpu_torch.parallel.batch import (batched_params, batched_step,
                                               gather_batch, shard_batch,
                                               sweep_step)
    from cfd2_tpu_torch.runtime.state import SolverState
    dm = encode_mesh(host_mesh, device=device)
    singles = [initial_state(dm, u0=u0) for u0 in u0s]
    bstate = SolverState(**{f.name: torch.stack([getattr(s, f.name)
                                                 for s in singles])
                            for f in fields(SolverState)})
    decomp = sp.RowDecomposition(len(u0s), 1, transport="gloo",
                                 device=device)
    params = SolverParams.default(dt=0.01, device=device)
    mine = shard_batch(bstate, decomp)
    out = {}
    out["batched"] = gather_batch(batched_step(dm, mine, params,
                                               SolverConfig()), decomp)
    bparams = shard_batch(batched_params(params, {"viscosity": viscosities}),
                          decomp)
    out["sweep"] = gather_batch(sweep_step(dm, mine, bparams,
                                           SolverConfig()), decomp)
    return {k: dict(u=v.u.cpu().numpy(), p=v.p.cpu().numpy(),
                    outer=v.outer_iters.cpu().numpy(),
                    lin=v.linear_iters_total.cpu().numpy(),
                    local=mine.u.shape[0]) for k, v in out.items()}


def dcp_save(rank, world, device, npz, grid, path):
    """This rank's rows of the state and params in ``npz`` written by every
    rank as one distributed checkpoint at ``path``."""
    from cfd2_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                   save_checkpoint_dcp)
    state, params = load_checkpoint(npz, device=device)
    decomp = sp.RowDecomposition(*grid, transport="gloo", device=device)
    mine = sp.shard_cellwise(state, grid[0] * grid[1], decomp)
    save_checkpoint_dcp(path, mine, params, decomp)
    return mine.u.shape[0]


def dcp_load(rank, world, device, grid, path):
    """This rank's rows of the distributed checkpoint at ``path``."""
    from cfd2_tpu_torch.runtime.checkpoint import load_checkpoint_dcp
    from cfd2_tpu_torch.runtime.state import PARAMS_FIELDS, STATE_FIELDS
    decomp = sp.RowDecomposition(*grid, transport="gloo", device=device)
    state, params = load_checkpoint_dcp(path, decomp)
    return dict(cells=(decomp.cells.start, decomp.cells.stop),
                state={f: getattr(state, f).cpu().numpy()
                       for f in STATE_FIELDS},
                params={f: getattr(params, f).cpu().numpy()
                        for f in PARAMS_FIELDS})


def operators_over(rank, world, device, worlds, host_mesh, pad_rows_to, u0,
                   rhs, x):
    """The assembled system's pressure V-cycle, SpMV and Schur
    preconditioner on this rank's rows of ``rhs`` (ny, nx) and ``x``
    (3, ny, nx), for each world size in ``worlds``, and the V-cycle's
    split level."""
    from cfd2_tpu_torch.models.assembly import assemble_stencil, prepare
    from cfd2_tpu_torch.ops import stencil_system as st

    def run(group):
        mesh, state, params, cfg, amg, decomp = setup(
            host_mesh, device, pad_rows_to, u0, 0.001,
            dict(precond_type=1), True, group)
        ss = assemble_stencil(mesh, prepare(mesh, state, params, cfg),
                              params, cfg)
        ps = st.make_pressure_solve2(amg, ss)
        own = lambda a: decomp.own_rows(torch.as_tensor(a, device=device),
                                        dim=a.ndim - 2).contiguous()
        xo = own(x)
        out = dict(
            vcycle=ps(own(rhs)).cpu().numpy(),
            spmv=st.spmv_planar(ss, xo).cpu().numpy(),
            precond=st.schur_precond_planar(
                ss, xo, 1.2, 10, pressure_solve=ps,
                mom_sweeps=8).cpu().numpy(),
            adi=torch.stack(st._momentum_solve_adi(ss, xo[0], xo[1])
                            ).cpu().numpy(),
            precond_adi=st.schur_precond_planar(
                ss, xo, 1.2, 10, pressure_solve=ps,
                mom_adi=1).cpu().numpy(),
            split=split_level(amg, decomp))
        for level in ("1", "0"):
            out["vcycle" + level] = at_smoother_level(
                level, lambda: ps(own(rhs))).cpu().numpy()
        return out

    return _over(rank, world, worlds, run)


def at_smoother_level(level: str | None, fn):
    """``fn()`` with CFD2_PALLAS set to ``level`` (None: as it is), restored
    after, so that it cannot leak into the next run of the same process."""
    old = os.environ.get("CFD2_PALLAS")
    if level is not None:
        os.environ["CFD2_PALLAS"] = level
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("CFD2_PALLAS", None)
        else:
            os.environ["CFD2_PALLAS"] = old


def option_run(mesh, state, params, amg, config: dict, steps: int = 1,
               pallas: str | None = None, simple: bool = False) -> dict:
    """``steps`` steps of one option from ``state``: ``config`` overrides
    SolverConfig; fgmres_recycle >= 2 carries the Krylov basis across the
    steps through ``step(..., krylov=)``; ``pallas`` sets CFD2_PALLAS for
    the run only (restored after, so it cannot leak into the next run);
    ``simple`` steps ``simple_step`` instead.  The hierarchy is passed for
    precond_type=1 only.  Runs in one process (``mesh`` unsharded) and on a
    rank alike: u (this rank's rows), outers and FGMRES iterations per
    step, and the launch, exchange and collective counts of the run."""
    from cfd2_tpu_torch.models.coupled import _basis_init
    from cfd2_tpu_torch.models.pressure_poisson import simple_step
    cfg = replace(SolverConfig(), **config)
    a = amg if cfg.precond_type == 1 else None
    outer, lin = [], []

    def steps_():
        kry = (_basis_init(mesh, state, cfg, a) if cfg.fgmres_recycle >= 2
               else None)
        s = state
        for _ in range(steps):
            if simple:
                s = simple_step(mesh, s, params, cfg)
            elif kry is not None:
                s, kry = step(mesh, s, params, cfg, a, kry)
            else:
                s = step(mesh, s, params, cfg, a)
            outer.append(int(s.outer_iters))
            lin.append(int(s.linear_iters_total))
        return s

    sp.reset_counts()
    sk.reset_launches()
    s = at_smoother_level(pallas, steps_)
    return dict(u=s.u.cpu().numpy(), outer=outer, lin=lin,
                counts=_counts(sum(lin)), launches=dict(sk.LAUNCHES))


def option_runs_over(rank, world, device, worlds, host_mesh, pad_rows_to, u0,
                     dt, runs):
    """Every run of ``runs`` (name -> :func:`option_run` keywords) on this
    rank's rows, from one set-up per world size in ``worlds``: {w: {name:
    result}}, and the V-cycle's split level under ``"split"``."""
    def group_runs(group):
        mesh, state, params, _, amg, decomp = setup(
            host_mesh, device, pad_rows_to, u0, dt, {}, True, group)
        out = {name: option_run(mesh, state, params, amg, **kw)
               for name, kw in runs.items()}
        out["split"] = split_level(amg, decomp)
        return out

    return _over(rank, world, worlds, group_runs)


# The aggregation fallback of ``precond_type=1`` on a structured grid (the
# block path): name -> (cell size of the obstacle channel, pad_rows_to,
# hierarchy).  The 0.05 channel with the aggregation hierarchy built and
# passed in (570, 152, 42 cells; the grid also has the structured one), and
# the 0.25 channel padded to 4 rows (4 x 12 = 48 cells, no more than the
# structured multigrid's 100), where ``build_hierarchy_for_mesh`` falls back
# by itself and finds no aggregation level either: None, the Chebyshev
# pressure relaxation.  dt 0.01, the inlet column at 1.
FALLBACK = {"aggregation": (0.05, 8, "aggregation"),
            "auto": (0.25, 4, "auto")}
FALLBACK_DT = 0.01


def fallback_cases(channel) -> dict:
    """:data:`FALLBACK` as :func:`fallback_step`'s cases, name ->
    (mesh, pad_rows_to, u0, dt, hierarchy), the meshes and starts made by
    ``channel(h)`` -> (host mesh, u0)."""
    out = {}
    for name, (h, pad, kind) in FALLBACK.items():
        mesh, u0 = channel(h)
        out[name] = (mesh, pad, u0, FALLBACK_DT, kind)
    return out


def fallback_hierarchy(dm, kind: str):
    """The aggregation fallback's hierarchy of a structured DeviceMesh:
    ``"aggregation"`` builds it (on a grid that still has the structured
    multigrid), ``"auto"`` is what ``build_hierarchy_for_mesh`` returns (the
    aggregation AMG, or None, on a grid too small for the structured one)."""
    from cfd2_tpu_torch.ops.amg import StructuredAmgHierarchy, build_hierarchy
    if kind == "aggregation":
        return build_hierarchy(*[dm.amg_host[k] for k in
                                 ("ck_neighbor", "ck_mask", "c_valid")],
                               device=dm.device)
    hier = build_hierarchy_for_mesh(dm)
    assert not isinstance(hier, StructuredAmgHierarchy)
    return hier


def fallback_step(host_mesh, device, pad_rows_to, u0, dt, kind, group=None):
    """One ``precond_type=1`` step on the aggregation fallback
    (:func:`fallback_hierarchy`) on ``device``, in one process (``group``
    False) or on this rank's rows: u, the counts, the collectives and the
    kernels' launches."""
    one = group is False
    dm = encode_mesh(host_mesh, device=device if one else "cpu",
                     pad_rows_to=pad_rows_to)
    amg = fallback_hierarchy(dm, kind)
    state, mesh = initial_state(dm, u0=u0), dm
    if not one:
        ny, nx = dm.grid_shape
        decomp = sp.RowDecomposition(ny, nx, transport="gloo", device=device,
                                     group=group)
        mesh, state = sp.shard_mesh(dm, decomp), sp.shard_state(dm, state,
                                                                 decomp)
        amg = sp.shard_cellwise(amg, dm.num_cells, decomp)
    params = SolverParams.default(dt=dt, device=device)
    sp.reset_counts()
    sk.reset_launches()
    bk.reset_launches()
    out = step(mesh, state, params, SolverConfig(precond_type=1), amg)
    lin = int(out.linear_iters_total)
    return dict(u=out.u.cpu().numpy(), outer=int(out.outer_iters), lin=lin,
                levels=None if amg is None else [lv.n for lv in amg.levels],
                counts=_counts(lin),
                launches={**sk.LAUNCHES, **bk.LAUNCHES})


def fallback_steps_over(rank, world, device, worlds, cases):
    """:func:`fallback_step` of every case (name -> (host_mesh,
    pad_rows_to, u0, dt, kind)) for each world size in ``worlds``."""
    return _over(rank, world, worlds, lambda g: {
        name: fallback_step(case[0], device, *case[1:], group=g)
        for name, case in cases.items()})


# The coupled system's planes in the order of coupled_spmv's operands.
OFF_NAMES = ("off_mom", "off_up", "off_vp", "off_pu", "off_pv", "off_pp")
DIAG_NAMES = ("diag_u2", "diag_up2", "diag_vp2", "diag_pu2", "diag_pv2",
              "diag_pp2")


def stencil_planes(grid, seed: int) -> dict:
    """A seeded random coupled system in stencil form on ``grid`` (numpy,
    float32): the six (4, ny, nx) off-diagonal blocks, the six diagonals,
    D_u^-1, and the operands of the four stencil kernels (x (3, ny, nx), r
    (3, ny, nx), z (2, ny, nx), z_p (ny, nx))."""
    ny, nx = grid
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)
    out = {name: f(rng.standard_normal((4, ny, nx)) * 0.1)
           for name in OFF_NAMES}
    out.update({name: f(rng.uniform(1.0, 2.0, (ny, nx)))
                for name in ("diag_u2", "diag_pp2")})
    out.update({name: f(rng.standard_normal((ny, nx)) * 0.5)
                for name in ("diag_up2", "diag_vp2", "diag_pu2",
                             "diag_pv2")})
    out["diag_u_inv2"] = f(1.0 / out["diag_u2"])
    out.update(x=f(rng.standard_normal((3, ny, nx))),
               r=f(rng.standard_normal((3, ny, nx))),
               z=f(rng.standard_normal((2, ny, nx))),
               zp=f(rng.standard_normal((ny, nx))))
    return out


def stencil_tensors(grid, seed: int, device="cpu") -> dict:
    """:func:`stencil_planes` as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in stencil_planes(grid, seed).items()}


def made_up_halo(t):
    """Halo rows of a block ``t`` (..., ny, nx) that differ from the clamp
    (as a row-sharded block's do): (below, above) (..., 1, nx)."""
    return ((0.5 * t[..., -1:, :]).contiguous(),
            t[..., :1, :].flip(-1).contiguous())


def stencil_calls(planes: dict, halo=None, sweeps=(1, 2, 8),
                  plain: bool = False) -> dict:
    """No-argument calls of the four stencil wrappers of
    ``ops/stencil_kernels.py`` on ``planes`` (tensors), keyed by kernel
    (``momentum_jacobi <sweeps>`` for each of ``sweeps``): the kernels on
    CUDA tensors, the plain versions on CPU ones (``plain``: the plain
    versions everywhere).  ``halo(t)``: the (below, above) rows of a block
    ``t`` (..., ny, nx) on a row-sharded grid, or None."""
    p = planes
    rows = halo or (lambda t: (None, None))
    fn = lambda name: getattr(sk, name + "_ref" if plain else name)
    offs = tuple(p[k] for k in OFF_NAMES)
    diags = tuple(p[k] for k in DIAG_NAMES)
    calls = {
        "coupled_spmv": lambda: fn("coupled_spmv")(p["x"], offs, diags,
                                                   *rows(p["x"])),
        "schur_rhs": lambda: fn("schur_rhs")(
            p["r"][2], p["z"], p["diag_pu2"], p["diag_pv2"], p["off_pu"],
            p["off_pv"], *rows(p["z"])),
        "pressure_gradient": lambda: fn("pressure_gradient")(
            p["zp"], p["diag_up2"], p["diag_vp2"], p["off_up"], p["off_vp"],
            *rows(p["zp"])),
    }
    for s in sweeps:
        calls[f"momentum_jacobi {s}"] = lambda s=s: fn("momentum_jacobi")(
            p["r"][:2], p["diag_u_inv2"], p["off_mom"], s, halo=halo)
    return calls


def stencil_kernels(planes: dict, halo=None, sweeps=(1, 2, 8),
                    plain: bool = False) -> dict:
    """:func:`stencil_calls`' results as host arrays."""
    return {k: c().cpu().numpy()
            for k, c in stencil_calls(planes, halo, sweeps, plain).items()}


def stencil_kernels_over(rank, world, device, worlds, grid, seed):
    """:func:`stencil_kernels` on this rank's rows of
    :func:`stencil_planes`, the halo rows from the neighbouring ranks
    (``RowDecomposition.halo_rows``, one exchange per operand), for each
    world size in ``worlds``; and the exchanges made."""
    def run(group):
        decomp = sp.RowDecomposition(*grid, transport="gloo", device=device,
                                     group=group)
        planes = {k: decomp.own_rows(torch.as_tensor(v, device=device),
                                     dim=v.ndim - 2).contiguous()
                  for k, v in stencil_planes(grid, seed).items()}
        sp.reset_counts()
        out = stencil_kernels(planes, lambda t: decomp.halo_rows(
            t, 1, dim=t.dim() - 2))
        out["exchanges"] = sp.COUNT["exchanges"]
        return out

    return _over(rank, world, worlds, run)
