"""The port's ``prof_outer`` tool (``cfd2_tpu_torch/tools/prof_outer.py``)
against the JAX package's same computation (``tools/prof_outer.py``,
rebuilt here from ``cfd2_tpu``'s functions) on the CPU, on the 4,636-cell
channel at 0.025 from rest: the outers of its warm fused step and the
FGMRES iterations of its solves at the relative tolerances 1e-3 and 1e-5.
The knobs' environment variables are refused when they name no mode.

Tolerances: outers and iterations equal.  Times are not compared."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfd2_tpu.mesh import ChannelWithObstacle as JChannel
from cfd2_tpu.mesh import generate_cut_cell_mesh as j_cutcell
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.tools import prof_outer

torch.set_num_threads(2)
quiet = lambda m: None
SIZE = 0.025


def jax_prof_outer(size: float, n_warm: int):
    """tools/prof_outer.py:27-143 at ``size`` with its knobs unset: the
    warm steps' outers and the solve's iterations per tolerance."""
    from cfd2_tpu.models.assembly import assemble_stencil, prepare
    from cfd2_tpu.ops import stencil_system as st
    from cfd2_tpu.ops.amg import (_GridOps, _dense_factor,
                                  compute_structured_level_values2,
                                  structured_v_cycle)
    from cfd2_tpu.ops.fgmres import fgmres_solve
    mesh = j_cutcell(JChannel(3.0, 1.0, (1.0, 0.5), 0.2), size, size, 1.2,
                     (3.0, 1.0))
    s = JSolver(mesh)
    s.set_dt(min(0.002, 0.4 * size))
    s.set_viscosity(0.01)
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < size * 2, 0] = 1.0
    s.set_u(u0)
    outers = []
    for _ in range(n_warm):
        s.step()
        outers.append(int(s.state.outer_iters))
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

    def solve(ss, lv2, fac, hier, state, tol):
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
            max_restarts=5, tol=tol, abstol=config.fgmres_abstol)

    lv2, fac = jax.jit(coarsen)(ss, hier)
    solve = jax.jit(solve)
    return outers, {tol: int(solve(ss, lv2, fac, hier, state,
                                   tol).iterations) for tol in (1e-3, 1e-5)}


def test_prof_outer_matches_jax(monkeypatch):
    for k in ("PROF_VCYCLES", "PROF_MOM", "PROF_BF16"):
        monkeypatch.delenv(k, raising=False)
    got = prof_outer.run(SIZE, 1, "cpu", log=quiet)
    outers, iters = jax_prof_outer(SIZE, 1)
    assert got["warm_outers"] == outers
    assert {t: r[0] for t, r in got["solves"].items()} == iters
    assert iters[1e-5] > 0 and all(r[1] for r in got["solves"].values())
    assert [r["phase"] for r in got["phases"]] == [
        "prepare", "assemble", "coarsen", "solve(0.001)", "solve(1e-05)"]


def test_prof_outer_refuses_an_unknown_bf16_mode(monkeypatch):
    monkeypatch.setenv("PROF_BF16", "half")
    with pytest.raises(ValueError, match="PROF_BF16"):
        prof_outer.run(SIZE, 0, "cpu", log=quiet)
