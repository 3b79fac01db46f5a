"""Two timesteps of the port's CoupledSolver against cfd2_tpu's, from one
state carried across with cfd2_tpu_torch.convert.

Tolerances and why:
* outer iteration counts per step must be equal: the outer exits compare
  max-diffs against 1e-5/1e-4 thresholds far from where f32 roundoff moves
  them on this case;
* linear_iters_total within +-2 per outer: each FGMRES solve may end one
  iteration earlier or later when its residual estimate crosses the target
  within roundoff;
* u within 1e-4 * max|u|: every linear solve stops at rtol 1e-5, so two
  correct solves of the same system differ by up to ~10x that after the
  relaxed updates;
* p within 1e-3 * max|p|: the pressure's near-null constant mode (Dirichlet
  only at the outlet) amplifies the same solve error through the Schur
  complement.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from cfd2_tpu.mesh import ChannelWithObstacle, generate_cut_cell_mesh
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.runtime import state as ts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.0, 1.0))


@pytest.mark.parametrize("precond", [1, 0], ids=["amg", "chebyshev"])
def test_two_steps_match_jax(mesh, precond):
    js = JSolver(mesh)
    js.set_dt(0.01)
    js.set_precond_type(precond)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    js.set_u(u0)
    for _ in range(2):            # a non-trivial state to carry across
        js.step()

    t = TSolver(mesh, config=ts.SolverConfig(precond_type=precond),
                device="cpu")
    t.state = state_from_arrays({f: np.asarray(getattr(js.state, f))
                                 for f in ts.STATE_FIELDS}, "cpu")
    t.params = params_from_arrays({f: np.asarray(getattr(js.params, f))
                                   for f in ts.PARAMS_FIELDS}, "cpu")
    for step in range(2):
        js.step()
        t.step()
        jo, to = int(js.state.outer_iters), int(t.state.outer_iters)
        assert to == jo, (step, to, jo)
        jl = int(js.state.linear_iters_total)
        tl = int(t.state.linear_iters_total)
        assert abs(tl - jl) <= 2 * jo, (step, tl, jl)
        ju, tu = js.get_u(), t.get_u()
        assert np.abs(tu - ju).max() <= 1e-4 * np.abs(ju).max(), step
        jp, tp = js.get_p(), t.get_p()
        assert np.abs(tp - jp).max() <= 1e-3 * np.abs(jp).max(), step
        assert float(t.state.time) == pytest.approx(float(js.state.time))
    assert t.should_stop == js.should_stop


def test_run_metrics_and_setters(mesh):
    s = TSolver(mesh, device="cpu")
    s.set_precond_type(1)
    s.set_dt(0.01)
    s.set_viscosity(0.02)
    s.set_inlet_velocity(0.5)
    s.set_ramp_time(0.0)
    u0 = np.zeros((mesh.num_cells, 2))
    s.set_u(u0)
    s.set_p(np.zeros(mesh.num_cells))
    m = s.run(2)
    assert m["outer_iters"].dtype == np.int32 and m["outer_iters"].shape == (2,)
    assert (m["outer_iters"] > 0).all()
    np.testing.assert_allclose(m["time"], [0.01, 0.02], rtol=1e-6)
    assert not m["should_stop"].any()
    u = s.get_u()
    assert u.shape == (mesh.num_cells, 2) and np.isfinite(u).all()
    assert np.abs(u).max() > 0.1          # the inlet drives the flow
    assert s.get_d_p().shape == (mesh.num_cells,)


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_block_jacobi_matches_jax(mesh, mode):
    """Block-Jacobi preconditioning (precond_type=2) on the block-ELL path,
    in either step mode, against cfd2_tpu: two steps from the inlet start,
    with this file's tolerances, except that the packages may end one
    outer apart when that outer is a 0-iteration no-op
    (tests/test_torch_block_steps.py says why).  Every option of
    SolverConfig is ported, and the host-controlled step runs with
    Anderson mixing."""
    from torch_parity import steps_match
    js, t = JSolver(mesh), TSolver(mesh, device="cpu")
    for s in (js, t):
        s.set_dt(0.01)
        s.set_precond_type(2)
        u0 = np.zeros((mesh.num_cells, 2))
        u0[mesh.cell_cx < 0.1, 0] = 1.0
        s.set_u(u0)
    steps_match(js, t, 2, mode=mode, lin_per_outer=2, noop_outer=True)
    if mode != "host":
        return
    s = TSolver(mesh, device="cpu")
    s.set_dt(0.01)
    s.set_precond_type(1)
    s.config = replace(s.config, anderson_depth=2)
    s.step(mode="host")
    assert int(s.state.outer_iters) > 0
    assert float(s.state.time) == pytest.approx(0.01)
    assert np.isfinite(s.get_u()).all()
