"""The port's ``prof_precond`` and ``bf16_smoke`` tools
(``cfd2_tpu_torch/tools/``) against the JAX package's same computations
(``tools/prof_precond.py``, ``tools/bf16_smoke.py``) on the CPU: every
preconditioner variant's FGMRES solve of the first outer system of the
4,636-cell structured channel from rest, and the four bf16 combinations'
outers on the 1,168-cell channel.  The aggregation-AMG probe is in
``tests/test_torch_tools_amg.py``, the other tools in
``tests/test_torch_tools.py``.

Tolerances: iterations and outers equal per variant."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfd2_tpu.mesh import ChannelWithObstacle as JChannel
from cfd2_tpu.mesh import generate_cut_cell_mesh as j_cutcell
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.tools import bf16_smoke
from cfd2_tpu_torch.tools import prof_precond as ppc

torch.set_num_threads(2)
quiet = lambda m: None


def _jax_solver(mesh, size, **config):
    """The JAX tools' solver set-up (tools/prof_precond.py:51-59,
    prof_amg_variants.py:56-63, bf16_smoke.py:26-30): dt, viscosity,
    density, precond_type=1, the config overrides, the inlet column at 1."""
    s = JSolver(mesh)
    s.set_dt(min(0.002, 0.4 * size))
    s.set_viscosity(0.01)
    s.set_density(1.0)
    s.set_precond_type(1)
    s.config = replace(s.config, **config)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 2 * size, 0] = 1.0
    s.set_u(u0)
    return s


def _geo():
    return JChannel(3.0, 1.0, (1.0, 0.5), 0.2)


def jax_prof_precond(size: float, n_warm: int) -> dict:
    """tools/prof_precond.py:41-142 at ``size``: the iterations of every
    variant of the port's tool, its ``trunc`` variants through the JAX
    tool's own ``make_trunc`` construction (lines 100-110)."""
    from cfd2_tpu.models.assembly import assemble_stencil, prepare
    from cfd2_tpu.models.coupled import step_host
    from cfd2_tpu.ops import stencil_system as st
    from cfd2_tpu.ops.amg import (_GridOps, _dense_factor,
                                  build_structured_hierarchy,
                                  compute_structured_level_values2,
                                  structured_v_cycle)
    from cfd2_tpu.ops.fgmres import fgmres_solve
    mesh = j_cutcell(_geo(), size, size, 1.2, (3.0, 1.0))
    s = _jax_solver(mesh, size)
    for _ in range(n_warm):
        s.state = step_host(s.mesh, s.state, s.params, s.config, s._get_amg())
    dm, config, params = s.mesh, s.config, s.params
    n_sweeps = config.pressure_sweeps(dm.num_cells)
    state = jax.jit(prepare, static_argnames=("config",))(
        dm, s.state, params, config)
    ss = jax.jit(assemble_stencil, static_argnames=("config",))(
        dm, state, params, config)

    def make_ps(h, n_cycles):
        lv = compute_structured_level_values2(h, ss.P_diag2, ss.P_off2)
        dc, oc = lv[-1]
        fac = _dense_factor(dc.reshape(-1),
                            jnp.moveaxis(oc.reshape(4, -1), 0, 1),
                            _GridOps(h.levels[-1].grid).neighbor_cols())

        def ps(rhs2):
            x = ss.diag_p_inv2 * rhs2
            for _ in range(n_cycles):
                x = structured_v_cycle(h, lv, rhs2.reshape(-1),
                                       x.reshape(-1), coarse_factors=fac,
                                       sweeps=1).reshape(ss.grid)
            return x
        return ps

    x0 = st.to_planar(ss, jnp.concatenate([state.u, state.p[:, None]],
                                          axis=1))
    rhsp = st.to_planar(ss, ss.rhs)
    out = {}
    for tag, cycles, ms, cap in ppc.VARIANTS:
        h = s._get_amg() if cap is None else build_structured_hierarchy(
            dm, min_coarse=cap)
        ps = make_ps(h, cycles) if cycles else None
        pc = (lambda ps, ms: lambda r: st.schur_precond_planar(
            ss, r, config.precond_omega, n_sweeps, pressure_solve=ps,
            mom_sweeps=ms))(ps, ms)
        r = jax.jit(lambda: fgmres_solve(
            lambda x: st.spmv_planar(ss, x), pc, rhsp, x0, restart=50,
            max_restarts=8, tol=1e-3, abstol=1e-7))()
        out[tag] = int(r.iterations)
    return out


def test_prof_precond_matches_jax():
    # No warm step: at this size the system after a warmed step has
    # converged already (0 iterations); from rest it takes dozens.
    got = ppc.run(0.025, 0, device="cpu", log=quiet)
    ref = jax_prof_precond(0.025, 0)
    assert list(got) == list(ref)
    assert {t: r["iterations"] for t, r in got.items()} == ref
    assert got["v1m8"]["iterations"] > 0


def test_bf16_smoke_outers_match_jax(monkeypatch):
    """tools/bf16_smoke.py's four variants (its lines 20-40) at SMOKE_CELL
    0.05, one timed step each: the outers of every step equal."""
    monkeypatch.delenv("SMOKE_VARIANTS", raising=False)
    got = bf16_smoke.run(size=0.05, timed=1, device="cpu", log=quiet)
    assert list(got) == [v[0] for v in bf16_smoke.VARIANTS]
    mesh = j_cutcell(_geo(), 0.05, 0.05, 1.2, (3.0, 1.0))
    for tag, kw in bf16_smoke.VARIANTS:
        s = _jax_solver(mesh, 0.05, fgmres_max_restarts=5, **kw)
        s.step()
        s.step()
        s.step()
        assert got[tag]["outers"] == [int(s.state.outer_iters)], tag
        assert np.isfinite(s.get_u()).all()
