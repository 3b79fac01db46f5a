"""Set-up shared by the parity tests of the port
(tests/test_torch_fgmres.py, test_torch_stencil_options.py,
test_torch_coupled_*.py, and the generic-mesh files): one channel mesh, the
coupled system assembled by both packages from one state, a warm state made
by the JAX package, the same state carried into both packages' solvers
under one SolverConfig, a mesh pair with the banded maps removed, and the
step-by-step comparison (or the comparison with a recorded JAX run).

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
from types import SimpleNamespace

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
                        u_rel=1e-4, p_rel=1e-3, noop_outer=False):
    """One step's counts and fields of the two solvers (host cell order);
    ``js`` is the JAX solver or a step it recorded (:func:`record_steps`).
    ``noop_outer``: the outer counts may also differ by one when the later
    exit's last outer took 0 FGMRES iterations, and so changed nothing
    (block-Jacobi; tests/test_torch_block_steps.py says why)."""
    jo, to = int(js.state.outer_iters), int(t.state.outer_iters)
    if noop_outer and abs(to - jo) == 1:
        longer = js if jo > to else t
        assert int(longer.state.linear_iters) == 0, (tag, to, jo)
        outer_slack = max(outer_slack, 1)
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


def steps_match(js, t, n, mode="fused", jmode=None, **tol):
    """``n`` steps of both solvers, the port's in ``mode`` and the JAX
    package's in ``jmode`` (default ``mode``), each step held to
    :func:`assert_step_matches`."""
    for i in range(n):
        js.step(mode=jmode or mode)
        t.step(mode=mode)
        assert_step_matches(js, t, (mode, i), **tol)
    assert t.should_stop == js.should_stop


def clear_jax_banded_map(dm):
    """A JAX DeviceMesh with its banded index maps removed, as the
    packages encode a mesh that admits none (the block-ELL path)."""
    none = dict.fromkeys(
        ("bd_W", "bd2_W", "bd_wgs", "bd_k", "bd_lane", "bd_sel", "bd_base",
         "bd2_lane", "bd2_sel", "bd2_bases", "bd_of_rows", "bd_of_slots",
         "bd_of_src"))
    return replace(dm, **none)


def clear_banded_pair(jsol, t):
    """Both solvers' meshes without a banded map, and fresh states for them
    (one flux per face on a generic mesh); set the fields after this."""
    jsol.mesh = clear_jax_banded_map(jsol.mesh)
    t.mesh = replace(t.mesh, banded=False, bd_k=None)
    jsol.state = js.initial_state(jsol.mesh)
    t.state = ts.initial_state(t.mesh)


def _recorded(jsol):
    """A JAX solver's step as a record that :func:`assert_step_matches`
    reads as it reads the solver."""
    st = jsol.state
    u, p = jsol.get_u(), jsol.get_p()
    return SimpleNamespace(
        state=SimpleNamespace(outer_iters=int(st.outer_iters),
                              linear_iters=int(st.linear_iters),
                              linear_iters_total=int(st.linear_iters_total),
                              time=float(st.time)),
        get_u=lambda: u, get_p=lambda: p, should_stop=jsol.should_stop)


def record_steps(jsol, n, mode="fused"):
    """``n`` steps of a JAX solver, each recorded for
    :func:`hold_to_record`."""
    rows = []
    for _ in range(n):
        jsol.step(mode=mode)
        rows.append(_recorded(jsol))
    return rows


def hold_to_record(t, rows, mode="fused", lin_per_outer=2, u_rel=1e-4,
                   p_rel=1e-4):
    """Step the port's solver once per recorded JAX step and hold each step
    to the record with :func:`assert_step_matches`: equal outers, FGMRES
    iterations within ``lin_per_outer`` per outer, u and p within ``u_rel``
    / ``p_rel`` of their maxima."""
    for i, r in enumerate(rows):
        t.step(mode=mode)
        assert_step_matches(r, t, (mode, i), lin_per_outer=lin_per_outer,
                            u_rel=u_rel, p_rel=p_rel)
        assert t.should_stop == r.should_stop
