"""Two timesteps of the port's CoupledSolver on a Delaunay and on a
slot-capped Voronoi mesh against cfd2_tpu's, from the same initial fields,
with the aggregation AMG (precond_type=1, per-step frozen coarse operators).
The Chebyshev pressure relaxation and the second-order upwind scheme run the
same comparison in tests/test_torch_unstructured_schemes.py.

Tolerances and why (fields are compared in host cell order):
* outer iteration counts per step must be equal: the outer exits compare
  max-diffs against 1e-5/1e-4 thresholds far from where f32 roundoff moves
  them on these cases;
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

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.ops import banded_kernels as bk
from cfd2_tpu_torch.ops.amg import AmgHierarchy

torch.set_num_threads(1)


def _mesh(mod, kind):
    geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return getattr(mod, f"generate_{kind}_mesh")(
        geo, 0.06, 0.06, 1.2, (3.0, 1.0), seed=2)


def _start(solver, mesh, precond, scheme=0):
    solver.set_dt(0.005)
    solver.set_alpha_u(0.9)
    solver.set_alpha_p(0.9)
    solver.set_precond_type(precond)
    solver.set_scheme(scheme)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    solver.set_u(u0)


def check_two_steps(kind, precond, scheme):
    jm, tm = _mesh(jmesh, kind), _mesh(tmesh, kind)
    js = JSolver(jm)
    t = TSolver(tm, device="cpu")
    assert not t.mesh.structured and t.mesh.banded
    assert t.mesh.bd_k == js.mesh.bd_k == (8 if kind == "voronoi" else None)
    _start(js, jm, precond, scheme)
    _start(t, tm, precond, scheme)
    if precond == 1:
        assert isinstance(t._get_amg(), AmgHierarchy)
    for step in range(2):
        js.step()
        t.step()
        jo, to = int(js.state.outer_iters), int(t.state.outer_iters)
        assert to == jo, (step, to, jo)
        jl = int(js.state.linear_iters_total)
        tl = int(t.state.linear_iters_total)
        assert abs(tl - jl) <= 2 * jo, (step, tl, jl)
        ju, tu = js.get_u(), t.get_u()
        assert tu.shape == (tm.num_cells, 2)
        assert np.abs(tu - ju).max() <= 1e-4 * np.abs(ju).max(), step
        jp, tp = js.get_p(), t.get_p()
        assert np.abs(tp - jp).max() <= 1e-3 * np.abs(jp).max(), step
        assert float(t.state.time) == pytest.approx(float(js.state.time))
    assert t.should_stop == js.should_stop


@pytest.mark.parametrize("kind", ["delaunay", "voronoi"])
def test_two_steps_match_jax(kind):
    check_two_steps(kind, 1, 0)


@pytest.fixture(scope="module")
def delaunay():
    return _mesh(tmesh, "delaunay")


def test_step_fluxes_are_bitwise_antisymmetric(delaunay):
    """After real steps, the state's slot fluxes still pair up exactly."""
    s = TSolver(delaunay, device="cpu")
    _start(s, delaunay, 1)
    s.run(2)
    dm = s.mesh
    flux = s.state.fluxes.numpy()
    assert flux.shape == (dm.num_cells, dm.max_faces)
    ent = np.argwhere((dm.ck_mask.numpy() > 0)
                      & (dm.ck_is_boundary.numpy() == 0))
    face_of = dm.ck_face.numpy()[ent[:, 0], ent[:, 1]]
    order = np.argsort(face_of, kind="stable")
    ent = ent[order]
    fa = flux[ent[0::2, 0], ent[0::2, 1]]
    fb = flux[ent[1::2, 0], ent[1::2, 1]]
    assert np.abs(fa).max() > 0 and np.abs(fa + fb).max() == 0.0


def test_step_goes_through_the_three_wrappers(delaunay, monkeypatch):
    """Every neighbor access of the step is one of the three banded
    wrappers (the gather also as the V-cycle's fused prolongation): count
    their calls (on the CPU they run the plain versions and leave LAUNCHES
    alone) and hold the sweeps to 2 per FGMRES iteration."""
    calls = {"banded_gather": 0, "banded_prolong_add": 0, "banded_dot": 0,
             "banded_jacobi_sweeps": 0}

    def counting(name):
        fn = getattr(bk, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(bk, name, counting(name))
    before = dict(bk.LAUNCHES)
    s = TSolver(delaunay, device="cpu")
    _start(s, delaunay, 1)
    s.step()
    lin = int(s.state.linear_iters_total)
    assert lin > 0
    assert calls["banded_jacobi_sweeps"] == 2 * lin
    levels = len(s._get_amg().levels)
    assert calls["banded_prolong_add"] == levels * lin
    assert calls["banded_gather"] > 0     # the assembly's neighbor values
    assert calls["banded_dot"] >= (3 + 4 * levels) * lin
    assert bk.LAUNCHES == before          # no kernel launch on CPU tensors


def test_run_metrics(delaunay):
    s = TSolver(delaunay, device="cpu")
    _start(s, delaunay, 1)
    m = s.run(2)
    assert m["outer_iters"].shape == (2,) and (m["outer_iters"] > 0).all()
    np.testing.assert_allclose(m["time"], [0.005, 0.01], rtol=1e-6)
    assert np.isfinite(s.get_u()).all() and np.isfinite(s.get_p()).all()
    assert s.get_d_p().shape == (delaunay.num_cells,)


@pytest.mark.parametrize("precond,unbanded", [(2, False), (0, True)],
                         ids=["block-jacobi", "unbanded-chebyshev"])
def test_block_paths_match_jax(precond, unbanded):
    """The two block-ELL entries of a Delaunay mesh against cfd2_tpu, one
    step from this file's start: block-Jacobi (precond_type=2, which takes
    the block path although the mesh has a banded map) and the Chebyshev
    pressure relaxation with the banded map removed.  This file's
    tolerances, except that block-Jacobi may end one outer apart when that
    outer is a 0-iteration no-op (tests/test_torch_block_steps.py says
    why)."""
    from torch_parity import assert_step_matches, clear_banded_pair
    jm, tm = _mesh(jmesh, "delaunay"), _mesh(tmesh, "delaunay")
    js, t = JSolver(jm), TSolver(tm, device="cpu")
    if unbanded:
        clear_banded_pair(js, t)
    _start(js, jm, precond)
    _start(t, tm, precond)
    js.step()
    t.step()
    assert t.mesh.banded != unbanded and int(t.state.outer_iters) > 0
    assert_step_matches(js, t, precond, lin_per_outer=2,
                        noop_outer=precond == 2)
