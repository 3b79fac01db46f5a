"""Set-up shared by the option parity tests of the port
(tests/test_torch_fgmres.py, test_torch_stencil_options.py,
test_torch_coupled_*.py): one channel mesh, the coupled system assembled by
both packages from one state, a warm state made by the JAX package, the
same state carried into both packages' solvers under one SolverConfig, and
the step-by-step comparison.

Tolerances of :func:`assert_step_matches` and why (f32 options; the bf16
options pass wider ones, stated in their file):
* outer iteration counts per step equal: the outer exits compare max-diffs
  against 1e-5 / 1e-4 thresholds far from where f32 roundoff moves them;
* FGMRES iterations within +-1 per outer: a solve may end one iteration
  earlier or later when its residual estimate crosses the target within
  roundoff;
* u within 1e-4 * max|u|: every linear solve stops at rtol 1e-5, so two
  correct solves of the same system differ by up to ~10x that after the
  relaxed updates;
* p within 1e-3 * max|p|: the pressure's near-null constant mode amplifies
  the same solve error through the Schur complement.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax

from cfd2_tpu.mesh import ChannelWithObstacle, generate_cut_cell_mesh
from cfd2_tpu.models.assembly import assemble_stencil as j_assemble
from cfd2_tpu.models.assembly import prepare as j_prepare
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu.ops import amg as jamg
from cfd2_tpu.runtime import state as js
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models.assembly import assemble_stencil as t_assemble
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.ops import amg as tamg
from cfd2_tpu_torch.runtime import state as ts
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode


ANDERSON = dict(anderson_depth=2)
# The bounds of the bf16 options (tests/test_torch_coupled_bf16.py says why).
BF16 = dict(outer_slack=1, lin_per_outer=2, u_rel=5e-3, p_rel=5e-2)


def outer_slack(options):
    """Outer-count slack of a configuration: 2 with Anderson mixing (see
    tests/test_torch_coupled_outer.py), else 0."""
    return 2 if options.get("anderson_depth") else 0


def channel_mesh():
    """The cut-cell channel of tests/test_torch_coupled.py (min_cell 0.05)."""
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.0, 1.0))


def assembled_systems():
    """The coupled system of the channel mesh from the inlet start,
    assembled by both packages from the same prepared state, and both
    structured hierarchies: (jax mesh, jax system, port system, jax
    hierarchy, port hierarchy, x0 as (N, 3) numpy)."""
    mesh = channel_mesh()
    jm = jencode(mesh)
    tm = tencode(mesh, device="cpu")
    cfg = js.SolverConfig()
    params = js.SolverParams.default(dt=0.01)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    state = js.initial_state(jm, u0=u0)
    state = jax.jit(j_prepare, static_argnames=("config",))(
        jm, state, params, cfg)
    jss = j_assemble(jm, state, params, cfg)
    tstate = state_from_arrays({f: np.asarray(getattr(state, f))
                                for f in ts.STATE_FIELDS}, "cpu")
    tparams = params_from_arrays({f: np.asarray(getattr(params, f))
                                  for f in ts.PARAMS_FIELDS}, "cpu")
    tss = t_assemble(tm, tstate, tparams, ts.SolverConfig())
    jh = jamg.build_structured_hierarchy(jm)
    th = tamg.build_structured_hierarchy(tm)
    x0 = np.concatenate([np.asarray(state.u), np.asarray(state.p)[:, None]],
                        axis=1)
    return jm, jss, tss, jh, th, x0


def start_from_inlet(solver, mesh, precond=1):
    solver.set_dt(0.01)
    solver.set_precond_type(precond)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    solver.set_u(u0)


def warm_jax_solver(mesh, precond=1, steps=2):
    """A JAX solver two default steps past the inlet start: a non-trivial
    state to carry across."""
    js = JSolver(mesh)
    start_from_inlet(js, mesh, precond)
    for _ in range(steps):
        js.step()
    return js


def pair(warm, mesh, port_mesh=None, **options):
    """(JAX solver, port solver) on ``warm``'s state and params under
    ``warm``'s config with ``options`` set; the JAX state arrays are
    immutable, so they are shared.  ``port_mesh``: the port's own copy of
    ``mesh`` (default ``mesh``; both packages lay it out alike)."""
    js = JSolver(mesh)
    js.state, js.params = warm.state, warm.params
    js.config = replace(warm.config, **options)
    js._amg = warm._amg
    t = TSolver(port_mesh or mesh, config=ts.SolverConfig(
        **{f: getattr(js.config, f) for f in
           ts.SolverConfig.__dataclass_fields__}), device="cpu")
    t.state = state_from_arrays({f: np.asarray(getattr(js.state, f))
                                 for f in ts.STATE_FIELDS}, "cpu")
    t.params = params_from_arrays({f: np.asarray(getattr(js.params, f))
                                   for f in ts.PARAMS_FIELDS}, "cpu")
    return js, t


def assert_step_matches(js, t, tag, outer_slack=0, lin_per_outer=1,
                        u_rel=1e-4, p_rel=1e-3):
    """One step's counts and fields of the two solvers (host cell order)."""
    jo, to = int(js.state.outer_iters), int(t.state.outer_iters)
    assert abs(to - jo) <= outer_slack, (tag, to, jo)
    jl = int(js.state.linear_iters_total)
    tl = int(t.state.linear_iters_total)
    assert abs(tl - jl) <= lin_per_outer * max(jo, to), (tag, tl, jl)
    ju, tu = js.get_u(), t.get_u()
    assert np.isfinite(tu).all() and np.isfinite(t.get_p()).all(), tag
    assert np.abs(tu - ju).max() <= u_rel * np.abs(ju).max(), tag
    if p_rel is not None:
        jp, tp = js.get_p(), t.get_p()
        assert np.abs(tp - jp).max() <= p_rel * np.abs(jp).max(), tag
    assert float(t.state.time) == pytest.approx(float(js.state.time))


def steps_match(js, t, n, mode="fused", **tol):
    for i in range(n):
        js.step(mode=mode)
        t.step(mode=mode)
        assert_step_matches(js, t, (mode, i), **tol)
    assert t.should_stop == js.should_stop
