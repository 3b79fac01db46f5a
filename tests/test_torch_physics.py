"""The physical validations of tests/test_physics.py on the port's plain
path (Poiseuille profile, the lid-driven cavity's boundary tags and its
centreline against Ghia et al. (1982), the degenerate-case stop), each with
the JAX test's own bounds, and short runs of those configurations against
the JAX package's fields.

Tolerances of the short runs (``tests/torch_parity.py`` says why): outer
counts equal per step, FGMRES iterations within 1 per outer, u within
1e-4 * max|u| and p within 1e-3 * max|p| in host order after every step."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU: tests/conftest.py)

from cfd2_tpu.mesh import RectangularChannel as JRect
from cfd2_tpu.mesh import generate_cut_cell_mesh as j_cutcell
from cfd2_tpu.mesh import retag_lid_cavity as j_retag
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.mesh import (BOUNDARY_INLET, BOUNDARY_OUTLET,
                                 BOUNDARY_WALL, RectangularChannel,
                                 generate_cut_cell_mesh, retag_lid_cavity)
from cfd2_tpu_torch.models.coupled import CoupledSolver
from torch_physics_cases import (CAVITY_STEPS, GHIA_BOUND, GHIA_Y, cavity,
                                 centreline_error)

torch.set_num_threads(2)
U_REL, P_REL = 1e-4, 1e-3


def poiseuille(solver_cls, rect, cutcell, **kw):
    """The channel of test_poiseuille_profile: Re 10 from a uniform u = 1."""
    mesh = cutcell(rect(length=3.0, height=1.0), 0.05, 0.05, 1.2, (3.0, 1.0))
    s = solver_cls(mesh, **kw)
    s.set_viscosity(0.1)
    s.set_density(1.0)
    s.set_inlet_velocity(1.0)
    s.set_ramp_time(0.05)
    s.set_dt(0.01)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[:, 0] = 1.0
    s.set_u(u0)
    return mesh, s


def test_poiseuille_profile():
    mesh, s = poiseuille(CoupledSolver, RectangularChannel,
                         generate_cut_cell_mesh, device="cpu")
    for _ in range(150):
        s.step()
        if s.should_stop:
            break
    u = s.get_u()
    assert np.isfinite(u).all()
    col = (mesh.cell_cx > 2.4) & (mesh.cell_cx < 2.5)
    y = mesh.cell_cy[col]
    u_exact = 6.0 * y * (1.0 - y)
    err = np.abs(u[col, 0] - u_exact).max() / u_exact.max()
    assert err < 0.12, f"profile error {err:.3f}"
    center = col & (np.abs(mesh.cell_cy - 0.5) < 0.05)
    assert abs(u[center, 0].mean() - 1.5) < 0.15
    for x0 in (0.5, 1.5, 2.5):
        colx = (mesh.cell_cx > x0 - 0.05) & (mesh.cell_cx < x0)
        flux = (u[colx, 0] * mesh.cell_vol[colx]).sum() / 0.05
        assert abs(flux - 1.0) < 0.05, f"mass flux at x={x0}: {flux}"


def test_lid_cavity_retag_invariants():
    mesh = generate_cut_cell_mesh(RectangularChannel(length=1.0, height=1.0),
                                  0.1, 0.1, 1.2, (1.0, 1.0))
    retag_lid_cavity(mesh, (1.0, 1.0))
    bnd = mesh.face_neighbor < 0
    tags = mesh.face_boundary[bnd]
    lid = mesh.face_cy[bnd] > 1.0 - 1e-6
    assert (tags[lid] == BOUNDARY_INLET).all()
    assert (tags == BOUNDARY_OUTLET).sum() == 1   # single pressure anchor
    assert (tags[~lid] != BOUNDARY_INLET).all()
    others = tags[~lid]
    assert ((others == BOUNDARY_WALL) | (others == BOUNDARY_OUTLET)).all()
    ref = np.flatnonzero(mesh.face_boundary == BOUNDARY_OUTLET)[0]
    assert mesh.face_cx[ref] < 0.2 and mesh.face_cy[ref] < 0.2
    assert not mesh.validate()
    with pytest.raises(ValueError):
        retag_lid_cavity(mesh, (1.0, 1.0), lid_side="left")
    # The same tags as the JAX package's retag.
    jm = j_cutcell(JRect(length=1.0, height=1.0), 0.1, 0.1, 1.2, (1.0, 1.0))
    j_retag(jm, (1.0, 1.0))
    np.testing.assert_array_equal(mesh.face_boundary, jm.face_boundary)


def test_lid_driven_cavity_ghia_re100():
    mesh, s = cavity(CoupledSolver, RectangularChannel,
                     generate_cut_cell_mesh, retag_lid_cavity, device="cpu")
    for _ in range(CAVITY_STEPS):   # t = 10: steady by t ~ 4
        s.step()
        if s.should_stop:
            break
    u = s.get_u()
    assert np.isfinite(u).all()
    err, ui = centreline_error(mesh, u)
    assert err < GHIA_BOUND, f"max centreline-u error vs Ghia: {err:.4f}"
    assert ui[GHIA_Y == 0.5][0] < -0.12
    assert ui[-1] > 0.7


def test_degenerate_case_trips_should_stop():
    mesh = generate_cut_cell_mesh(RectangularChannel(length=1.0, height=1.0),
                                  0.1, 0.1, 1.2, (1.0, 1.0))
    s = CoupledSolver(mesh, device="cpu")
    s.set_inlet_velocity(0.0)
    s.set_dt(0.01)
    hits = s.config.stop_count
    for _ in range(hits + 5):
        s.step()
        if s.should_stop:
            break
    assert s.should_stop
    assert s.degenerate_count > hits
    assert s.steady_state_count == 0
    t_before = float(s.state.time)
    s.run(3)
    assert float(s.state.time) == t_before


def _pair(case):
    if case == "poiseuille":
        _, js = poiseuille(JSolver, JRect, j_cutcell)
        _, ts = poiseuille(CoupledSolver, RectangularChannel,
                           generate_cut_cell_mesh, device="cpu")
    else:
        precond = 1 if case == "cavity_precond1" else None
        _, js = cavity(JSolver, JRect, j_cutcell, j_retag, precond)
        _, ts = cavity(CoupledSolver, RectangularChannel,
                       generate_cut_cell_mesh, retag_lid_cavity, precond,
                       device="cpu")
    return js, ts


@pytest.mark.parametrize("case", ["poiseuille", "cavity", "cavity_precond1"])
def test_short_runs_match_jax(case):
    """Three steps of each configuration in both packages: the moving-lid
    boundary, the single-face pressure anchor and the uniform-inlet
    channel, on the default preconditioner and on the multigrid one."""
    js, ts = _pair(case)
    for i in range(3):
        js.step()
        ts.step()
        jo, to = int(js.state.outer_iters), int(ts.state.outer_iters)
        assert jo == to, f"step {i}: outers {to} != JAX {jo}"
        jl = int(js.state.linear_iters_total)
        tl = int(ts.state.linear_iters_total)
        assert abs(jl - tl) <= jo, f"step {i}: FGMRES {tl} vs JAX {jl}"
        ju, tu = np.asarray(js.get_u()), ts.get_u()
        jp, tp = np.asarray(js.get_p()), ts.get_p()
        assert np.abs(tu - ju).max() <= U_REL * np.abs(ju).max()
        assert np.abs(tp - jp).max() <= P_REL * max(np.abs(jp).max(), 1e-30)
