"""The port's row-sharded paths (cfd2_tpu_torch/parallel/spatial.py) on gloo
ranks on the CPU, held against the JAX package's sharded functions on the
suite's 8 virtual CPU devices (tests/conftest.py) and against the port's
one-process runs.

Each spawned group runs every world size of a test (the first 2, 4 and 8
ranks as sub-groups), so a test pays for one spawn.  The sharded V-cycle,
SpMV and Schur preconditioner must give one process's bits exactly; the
sharded steps differ from one process only in the order of their sums.
Tolerances and why:
* one step (tests/test_structured.py:118-139's case, precond_type=0):
  u within 1e-5, the JAX test's own bound, and equal outer counts;
* two adaptive steps with the structured multigrid
  (test_structured.py:162-209's run, on the 4,636-cell mesh instead of the
  100k one): u within 1e-4 and dt within 1e-9, the JAX test's bounds (the
  cross-rank sums reduce in another order, and two steps of Krylov
  iteration amplify it), equal outer counts;
* the banded sharded SpMV (test_parallel.py:79-111): within 1e-5 of the
  product's largest magnitude, the JAX test's bound; the sharded FGMRES
  solve takes the iteration count of the one-range solve.
Every rank of a run must report the same counts (a rank that took another
branch would deadlock the next collective; equal counts show it did not).
"""

import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_spatial_ranks as ranks
from cfd2_tpu.mesh import (ChannelWithObstacle, generate_cut_cell_mesh,
                           generate_delaunay_mesh)
from cfd2_tpu.models import assembly as ja
from cfd2_tpu.models.coupled import multi_step_adaptive as j_adaptive
from cfd2_tpu.models.coupled import step as j_step
from cfd2_tpu.ops import amg as jamg
from cfd2_tpu.ops import ellsys as jel
from cfd2_tpu.parallel import spatial as jsp
from cfd2_tpu.runtime import state as js
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.convert import state_from_arrays
from cfd2_tpu_torch.models import assembly as ta
from cfd2_tpu_torch.models.coupled import step as t_step
from cfd2_tpu_torch.models.coupled import step_host as t_step_host
from cfd2_tpu_torch.ops import ellsys as tel
from cfd2_tpu_torch.ops.fgmres import fgmres_solve
from cfd2_tpu_torch.parallel.launch import run_ranks
from cfd2_tpu_torch.parallel.spatial import banded_bandwidth
from cfd2_tpu_torch.runtime import state as ts
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode

torch.set_num_threads(1)
WORLDS = (2, 4, 8)
GEO = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)


def _jmesh():
    return JMesh(np.array(jax.devices("cpu")[:8]), axis_names=("y",))


def _same_on_every_rank(results, key):
    vals = [np.asarray(r[key]) for r in results]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


def _whole(results, key):
    return np.concatenate([r[key] for r in results])


# ----------------------------------------------------------------------
# (i) one step.


@pytest.fixture(scope="module")
def one_step():
    mesh = generate_cut_cell_mesh(GEO, 0.05, 0.05, 1.2, (3.0, 1.0))
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.05, 0] = 1.0
    dm = jencode(mesh, pad_rows_to=8)
    assert dm.grid_shape == (24, 60)
    state = js.initial_state(dm, u0=u0)
    params = js.SolverParams.default(dt=0.01)
    jm = _jmesh()
    jout = j_step(jsp.shard_mesh(dm, jm), jsp.shard_state(dm, state, jm),
                  params, js.SolverConfig())
    tm = tencode(mesh, device="cpu", pad_rows_to=8)
    tparams = ts.SolverParams.default(dt=0.01, device="cpu")
    tout = t_step(tm, ts.initial_state(tm, u0=u0), tparams,
                  ts.SolverConfig())
    thost = t_step_host(tm, ts.initial_state(tm, u0=u0), tparams,
                        ts.SolverConfig())
    res = run_ranks(ranks.sharded_steps_over, 8, device="cpu", timeout=240,
                    args=(WORLDS, (2,), mesh, 8, u0, 0.01, {}))
    return dict(jax=jout, port=tout, port_host=thost, ranks=res)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_jax_and_one_process(one_step, world):
    rs = [r[world] for r in one_step["ranks"][:world]]
    outer = _same_on_every_rank(rs, "outer")
    lin = _same_on_every_rank(rs, "lin")
    u = _whole(rs, "u")
    assert u.shape == tuple(one_step["port"].u.shape)
    assert np.isfinite(u).all()
    assert outer == int(one_step["jax"].outer_iters)
    assert outer == int(one_step["port"].outer_iters)
    assert abs(lin - int(one_step["port"].linear_iters_total)) <= outer
    assert np.abs(u - np.asarray(one_step["jax"].u)).max() < 1e-5
    assert np.abs(u - one_step["port"].u.numpy()).max() < 1e-5
    # Every rank's rows, in order; the transport is named.
    assert [r["rows"] for r in rs] == [(k * 24 // world, (k + 1) * 24
                                        // world) for k in range(world)]
    assert rs[0]["transport"].startswith("gloo")
    assert rs[0]["counts"]["per_iteration"]["exchanges"] > 0


def test_sharded_host_mode_step_matches_one_process(one_step):
    """``step_host`` on 2 ranks: its per-outer max-diffs are reduced across
    the ranks, so both take the one-process host step's exits."""
    rs = [r[(2, "host")] for r in one_step["ranks"][:2]]
    outer = _same_on_every_rank(rs, "outer")
    assert outer == int(one_step["port_host"].outer_iters)
    u = _whole(rs, "u")
    assert np.abs(u - one_step["port_host"].u.numpy()).max() < 1e-5


@pytest.fixture(scope="module")
def operators():
    """The 4,636-cell mesh's system from the inlet start applied to random
    rhs and x, in one process and over 2, 4 and 8 ranks (one spawn): the
    V-cycle at smoother levels 2, 1 and 0, the ADI momentum predict (blocks
    of 20 rows take its 15 ghost rows by one exchange, of 10 and 5 by an
    all-gather) and the preconditioner with it."""
    from cfd2_tpu_torch.models.assembly import assemble_stencil
    from cfd2_tpu_torch.models.assembly import prepare as t_prepare
    from cfd2_tpu_torch.ops import stencil_system as st
    from cfd2_tpu_torch.ops.amg import build_hierarchy_for_mesh
    mesh = generate_cut_cell_mesh(GEO, 0.025, 0.025, 1.2, (3.0, 1.0))
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    tm = tencode(mesh, device="cpu", pad_rows_to=4)
    ny, nx = tm.grid_shape
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal((ny, nx)).astype(np.float32)
    x = rng.standard_normal((3, ny, nx)).astype(np.float32)
    cfg = ts.SolverConfig(precond_type=1)
    params = ts.SolverParams.default(dt=0.001, device="cpu")
    ss = assemble_stencil(tm, t_prepare(tm, ts.initial_state(tm, u0=u0),
                                        params, cfg), params, cfg)
    ps = st.make_pressure_solve2(build_hierarchy_for_mesh(tm), ss)
    xt = torch.as_tensor(x)
    ref = dict(vcycle=ps(torch.as_tensor(rhs)).numpy(),
               spmv=st.spmv_planar(ss, xt).numpy(),
               precond=st.schur_precond_planar(ss, xt, 1.2, 10,
                                               pressure_solve=ps,
                                               mom_sweeps=8).numpy(),
               adi=torch.stack(st._momentum_solve_adi(ss, xt[0], xt[1])
                               ).numpy(),
               precond_adi=st.schur_precond_planar(
                   ss, xt, 1.2, 10, pressure_solve=ps, mom_adi=1).numpy())
    for level in ("1", "0"):
        ref["vcycle" + level] = ranks.at_smoother_level(
            level, lambda: ps(torch.as_tensor(rhs))).numpy()
    res = run_ranks(ranks.operators_over, 8, device="cpu", timeout=180,
                    collective_timeout=180,
                    args=((2, 4, 8), mesh, 4, u0, rhs, x))
    return ref, res


@pytest.mark.parametrize("world,split", [(2, 2), (4, 1), (8, 0)])
def test_sharded_operators_are_bit_equal(operators, world, split):
    """The sharded V-cycle (its legs on blocks with ghost rows, the gathered
    levels whole) under CFD2_PALLAS unset, 1 and 0, SpMV, ADI predict and
    Schur preconditioner (Jacobi and ADI predicts) give one process's bits
    on every row: the sharded step differs only in its sums."""
    ref, res = operators
    for name in ("vcycle", "vcycle1", "vcycle0", "spmv", "precond", "adi",
                 "precond_adi"):
        got = np.concatenate([r[world][name] for r in res[:world]],
                             axis=ref[name].ndim - 2)
        np.testing.assert_array_equal(got, ref[name], err_msg=name)
    assert res[0][world]["split"] == split


# ----------------------------------------------------------------------
# (ii) two adaptive steps with the structured multigrid.


@pytest.fixture(scope="module")
def adaptive():
    h = 0.025
    mesh = generate_cut_cell_mesh(GEO, h, h, 1.2, (3.0, 1.0))
    assert mesh.num_cells == 4636
    dm = jencode(mesh, pad_rows_to=8)
    assert dm.grid_shape == (40, 120)
    config = replace(js.SolverConfig(), precond_type=js.PRECOND_AMG)
    amg = jamg.build_hierarchy_for_mesh(dm,
                                        agg_passes=config.amg_agg_passes)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < h, 0] = 1.0
    state = js.initial_state(dm, u0=u0)
    jm = _jmesh()
    st8, _, m8 = j_adaptive(
        jsp.shard_cellwise(dm, dm.num_cells, jm),
        jsp.shard_cellwise(state, dm.num_cells, jm),
        js.SolverParams.default(dt=0.001), config,
        amg=jsp.shard_cellwise(amg, dm.num_cells, jm), num_steps=2,
        target_cfl=0.5, min_cell_size=h)
    res = run_ranks(ranks.sharded_adaptive_over, 8, device="cpu",
                    timeout=240,
                    args=(WORLDS, mesh, 8, u0, 0.001,
                          dict(precond_type=1), 2, h))
    return dict(u=np.asarray(st8.u), dt=np.asarray(m8["dt"]),
                outer=np.asarray(m8["outer_iters"]), ranks=res)


@pytest.mark.parametrize("world,split", [(2, 2), (4, 1), (8, 0)])
def test_sharded_adaptive_amg_matches_jax(adaptive, world, split):
    """Blocks of 20, 10 and 5 rows: the V-cycle runs levels 0-1 sharded,
    level 0 only, and (odd rows per rank) none, gathering from there."""
    rs = [r[world] for r in adaptive["ranks"][:world]]
    assert _same_on_every_rank(rs, "split") == split
    outer = _same_on_every_rank(rs, "outer")
    dt = _same_on_every_rank(rs, "dt")
    u = _whole(rs, "u")
    assert np.isfinite(u).all()
    np.testing.assert_array_equal(outer, adaptive["outer"])
    assert np.abs(dt - adaptive["dt"]).max() < 1e-9
    assert np.abs(u - adaptive["u"]).max() < 1e-4


# ----------------------------------------------------------------------
# (iii) the banded sharded SpMV and an FGMRES solve with it.


def test_banded_spmv_sharded_matches_jax():
    mesh = generate_delaunay_mesh(GEO, 0.06, 0.06, 1.2, (3.0, 1.0), seed=3)
    jm_ = jencode(mesh)
    assert jm_.banded
    config = js.SolverConfig()
    params = js.SolverParams.default(dt=0.005)
    rng = np.random.default_rng(0)
    state = js.initial_state(
        jm_, u0=rng.standard_normal((jm_.num_host_cells, 2)) * 0.1)
    state = ja.prepare(jm_, state, params, config)
    jes = ja.assemble_ell(jm_, state, params, config)
    halo = jsp.banded_bandwidth(jm_)
    assert halo <= jm_.num_cells // 8
    x = rng.standard_normal((3, jm_.num_cells)).astype(np.float32)
    y_jax = np.asarray(jsp.banded_spmv_sharded(jes, jm_, jnp.asarray(x),
                                               _jmesh(), halo))

    tm = tencode(mesh, device="cpu")
    assert banded_bandwidth(tm) == halo
    tstate = state_from_arrays({f: np.asarray(getattr(state, f))
                                for f in ts.STATE_FIELDS}, "cpu")
    tparams = ts.SolverParams.default(dt=0.005, device="cpu")
    tes = ta.assemble_ell(tm, tstate, tparams, ts.SolverConfig())
    b = rng.standard_normal((3, tm.num_cells)).astype(np.float32)
    kw = dict(restart=20, max_restarts=3, tol=1e-5)
    dinv = torch.stack([tes.diag_u_inv, tes.diag_u_inv, tes.diag_p_inv])
    one = fgmres_solve(lambda v: tel.spmv(tes, tm, v), lambda r: r * dinv,
                       torch.as_tensor(b), torch.zeros(3, tm.num_cells), **kw)
    res = run_ranks(ranks.banded_spmv, 8, device="cpu", timeout=240,
                    args=(tm, tes, x, b, halo, kw))
    y = np.concatenate([r["y"] for r in res], axis=1)
    scale = max(np.abs(y_jax).max(), 1.0)
    assert np.abs(y - y_jax).max() < 1e-5 * scale
    assert np.abs(y - tel.spmv(tes, tm, torch.as_tensor(x)).numpy()).max() \
        < 1e-5 * scale
    its = _same_on_every_rank(res, "iterations")
    xs = np.concatenate([r["x"] for r in res], axis=1)
    assert np.isfinite(xs).all() and its > 0
    assert its == one.iterations


# ----------------------------------------------------------------------
# (iv) halo rows; (v) a failed or hung rank.


def test_halo_rows_are_the_neighbouring_rows():
    grid = np.arange(24 * 5, dtype=np.float32).reshape(24, 5)
    res = run_ranks(ranks.halo_rows, 4, device="cpu", timeout=120,
                    args=(grid, (1, 2, 3, 4)))
    for r in res:
        r0, r1 = r["rows"]
        for d, (south, north, ext, lo) in r["halos"].items():
            below = grid[max(r0 - d, 0):r0]
            above = grid[r1:r1 + d]
            if r0 == 0:          # the grid's edge: the edge row repeated
                below = np.repeat(grid[:1], d, axis=0)
            if r1 == 24:
                above = np.repeat(grid[-1:], d, axis=0)
            np.testing.assert_array_equal(south, below)
            np.testing.assert_array_equal(north, above)
            np.testing.assert_array_equal(
                ext, grid[max(r0 - d, 0):min(r1 + d, 24)])
            assert lo == (0 if r0 == 0 else d)


def test_a_failed_rank_fails_the_run():
    t0 = time.time()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(ranks.fail_on, 2, device="cpu", timeout=120, args=(1,))
    assert time.time() - t0 < 60


def test_a_hung_rank_fails_the_run_within_its_limit():
    t0 = time.time()
    with pytest.raises(RuntimeError, match="still running"):
        run_ranks(ranks.hang, 2, device="cpu", timeout=15, args=(600,))
    assert time.time() - t0 < 40
