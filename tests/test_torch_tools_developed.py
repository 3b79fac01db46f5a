"""The port's ``prof_developed`` and ``prof_trace`` tools
(``cfd2_tpu_torch/tools/``) against the JAX package's same computations
(``tools/prof_developed.py``, ``tools/prof_trace.py``, rebuilt here from
``cfd2_tpu``'s functions) on the CPU, on the 4,636-cell channel at 0.025:

* ``prof_developed`` from a developed state (the port's three steps from
  rest, written as ``bench_developed_1m.npz`` is written, loaded by both
  packages): the verbose host-mode step's outers and FGMRES iterations per
  outer, and the solve's iterations from the state's own guess.  The
  tool's heal and timed fused steps are left out here (their JAX compile
  alone would take this file's time); ``chip_smoke.py`` phase 16(a) holds
  them to phase 3's counts on the card;
* ``prof_trace``: the outers of its 2 warm and 1 traced host-mode steps
  from rest.

Tolerances: iterations and outers equal.  Times are not compared."""

import contextlib
import io
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfd2_tpu.mesh import ChannelWithObstacle as JChannel
from cfd2_tpu.mesh import generate_cut_cell_mesh as j_cutcell
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu.models.coupled import step_host as j_step_host
from cfd2_tpu_torch.tools import probes, prof_developed, prof_trace

torch.set_num_threads(2)
quiet = lambda m: None
SIZE = 0.025


@pytest.fixture(scope="module")
def jmesh():
    return j_cutcell(JChannel(3.0, 1.0, (1.0, 0.5), 0.2), SIZE, SIZE, 1.2,
                     (3.0, 1.0))


@pytest.fixture(scope="module")
def state_file(tmp_path_factory):
    """A developed-state file of the 0.025 grid: the port's channel after 3
    steps from rest, in ``bench_developed_1m.npz``'s layout (u (ny, nx, 2),
    p (ny, nx), meta with the grid and the viscosity)."""
    s = probes.channel_solver(probes.channel_mesh(SIZE), SIZE, "cpu",
                              fgmres_max_restarts=5)
    for _ in range(3):
        s.step()
    ny, nx = s.mesh.grid_shape
    path = tmp_path_factory.mktemp("developed") / "developed_0.025.npz"
    np.savez(path, u=s.state.u.numpy().reshape(ny, nx, 2),
             p=s.state.p.numpy().reshape(ny, nx),
             meta=json.dumps({"grid": [ny, nx], "viscosity": 0.004}))
    return path


def _jax_ladder(s):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s.state = j_step_host(s.mesh, s.state, s.params, s.config,
                              amg=s._get_amg(), verbose=True)
    return probes.ladder(buf.getvalue().splitlines())


def jax_prof_developed(mesh, path):
    """tools/prof_developed.py:55-156 without its heal and timed steps:
    the state loaded as its lines 55-70 load it, the verbose host-mode
    step, then prepare, assemble, coarsen and the solve from the state's
    own (u, p); returns (ladder, the solve's iterations)."""
    from cfd2_tpu.models.assembly import assemble_stencil, prepare
    from cfd2_tpu.ops import stencil_system as st
    from cfd2_tpu.ops.amg import (_GridOps, _dense_factor,
                                  compute_structured_level_values2,
                                  structured_v_cycle)
    from cfd2_tpu.ops.fgmres import fgmres_solve
    s = JSolver(mesh)
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5)
    d = np.load(path)
    meta = json.loads(str(d["meta"]))
    ny, nx = s.mesh.grid_shape
    u = jnp.asarray(d["u"].astype(np.float32).reshape(ny * nx, 2))
    p = jnp.asarray(d["p"].astype(np.float32).reshape(ny * nx))
    u = u * s.mesh.c_valid[:, None]
    p = p * s.mesh.c_valid
    s.state = replace(s.state, u=u, u_old=u, u_old_old=u, prev_u=u, p=p)
    s.set_viscosity(meta["viscosity"])
    s.set_dt(min(0.002, 0.4 * SIZE))
    ladder = _jax_ladder(s)
    dm, config, params, hier = s.mesh, s.config, s.params, s._get_amg()
    state = jax.jit(prepare, static_argnames=("config",))(
        dm, s.state, params, config)
    ss = jax.jit(assemble_stencil, static_argnames=("config",))(
        dm, state, params, config)
    n_sweeps = config.pressure_sweeps(dm.num_cells)
    ms = config.mom_sweeps(dm.num_cells)

    def coarsen(ss, hier):
        # Every array an argument (the JAX tool closes over some): a
        # closed-over array is a constant of the program and slows its
        # compile, not its arithmetic.
        lv2 = compute_structured_level_values2(hier, ss.P_diag2, ss.P_off2)
        dc, oc = lv2[-1]
        return lv2, _dense_factor(
            dc.reshape(-1), jnp.moveaxis(oc.reshape(4, -1), 0, 1),
            _GridOps(hier.levels[-1].grid).neighbor_cols())

    def solve(ss, lv2, fac, hier, state):
        def ps(rhs2):
            x = ss.diag_p_inv2 * rhs2
            return structured_v_cycle(
                hier, lv2, rhs2.reshape(-1), x.reshape(-1),
                coarse_factors=fac).reshape(ss.grid)

        x0 = st.to_planar(ss, jnp.concatenate([state.u, state.p[:, None]],
                                              axis=1))
        return fgmres_solve(
            lambda x: st.spmv_planar(ss, x),
            lambda r: st.schur_precond_planar(
                ss, r, config.precond_omega, n_sweeps, pressure_solve=ps,
                mom_sweeps=ms),
            st.to_planar(ss, ss.rhs), x0, restart=config.fgmres_restart,
            max_restarts=5, tol=config.fgmres_tol,
            abstol=config.fgmres_abstol)

    lv2, fac = jax.jit(coarsen)(ss, hier)
    res = jax.jit(solve)(ss, lv2, fac, hier, state)
    return ladder, int(res.iterations)


def test_prof_developed_matches_jax(jmesh, state_file):
    got = prof_developed.run(state_file, SIZE, "cpu",
                             mesh=probes.channel_mesh(SIZE), heal=0,
                             n_meas=0, log=quiet)
    ladder, iters = jax_prof_developed(jmesh, state_file)
    assert got["ladder"] == ladder and len(ladder) > 1
    (tol, (it, conv, _)), = got["solves"].items()
    assert it == iters and conv
    assert [r["phase"] for r in got["phases"]] == [
        "prepare", "assemble", "coarsen", f"solve({tol:g})"]


def test_prof_trace_outers_match_jax(jmesh, tmp_path):
    """tools/prof_trace.py:29-55: 2 warm host-mode steps from rest, then
    the traced one; the port writes its trace where it is told."""
    got = prof_trace.run(SIZE, 1, "cpu", mesh=probes.channel_mesh(SIZE),
                         logdir=str(tmp_path), log=quiet)
    s = JSolver(jmesh)
    s.set_dt(min(0.002, 0.4 * SIZE))
    s.set_viscosity(0.01)
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5)
    u0 = np.zeros((jmesh.num_cells, 2))
    u0[jmesh.cell_cx < SIZE * 2, 0] = 1.0
    s.set_u(u0)
    outers = []
    for _ in range(3):
        s.step(mode="host")
        outers.append(int(s.state.outer_iters))
    assert got["warm_outers"] + got["outers"] == outers
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert got["busy_s"] is None and got["by_name"]
