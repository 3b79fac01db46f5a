"""The port's force coefficients (cfd2_tpu_torch/utils/forces.py) against
cfd2_tpu's, and the JAX package's own force checks (tests/test_forces.py)
held for the port.

The same host mesh goes through both packages' encoders (they keep the
mesh's face order), and the same state — a warm JAX state on the 0.05
cut-cell channel, a seeded random state on a ~1k-cell Delaunay mesh — is
carried into the port with convert.py.  Tolerances: the face masks are
equal element by element (the same comparisons on the same float32 face
centers); forces and coefficients agree to 1e-5 of the larger component
(rtol 1e-5), because both sum the same float32 face terms over all F faces,
in different orders, and the terms do not cancel to below 1e-5 of the
force.  The larger component sets the scale because the warm channel state
is still symmetric: its lift is zero to roundoff (5e-8 against a drag of
0.47).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh_mod
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu.runtime import state as js
from cfd2_tpu.utils import forces as jf
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models.coupled import CoupledSolver
from cfd2_tpu_torch.runtime import state as ts
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode
from cfd2_tpu_torch.utils.forces import (
    body_force,
    force_coefficients,
    obstacle_face_mask,
    strouhal_number,
)
from torch_parity import channel_mesh, warm_jax_solver

torch.set_num_threads(1)
RTOL = 1e-5


def _carry(jstate, jparams):
    return (state_from_arrays({f: np.asarray(getattr(jstate, f))
                               for f in ts.STATE_FIELDS}, "cpu"),
            params_from_arrays({f: np.asarray(getattr(jparams, f))
                                for f in ts.PARAMS_FIELDS}, "cpu"))


def _delaunay_case():
    """A ~1k-cell Delaunay mesh with a seeded random state in device
    order (u, p and grad_p O(1)) and viscosity 0.01."""
    geo = jmesh_mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = jmesh_mod.generate_delaunay_mesh(geo, 0.06, 0.06, 1.2, (3.0, 1.0),
                                            seed=2)
    jm = jencode(mesh)
    rng = np.random.default_rng(7)
    n = jm.num_cells
    st = js.initial_state(jm)
    st = replace(st, u=rng.standard_normal((n, 2)).astype(np.float32),
                 p=rng.standard_normal(n).astype(np.float32),
                 grad_p=rng.standard_normal((n, 2)).astype(np.float32))
    return mesh, jm, st, js.SolverParams.default(dt=0.005)


@pytest.fixture(scope="module")
def cases():
    """(label, JAX DeviceMesh, port DeviceMesh, JAX state, JAX params)."""
    mesh = channel_mesh()
    warm = warm_jax_solver(mesh)
    dmesh, djm, dst, dpar = _delaunay_case()
    return [("channel 0.05", warm.mesh, tencode(mesh, device="cpu"),
             warm.state, warm.params),
            ("delaunay 0.06", djm, tencode(dmesh, device="cpu"), dst, dpar)]


@pytest.mark.parametrize("i", [0, 1], ids=["channel", "delaunay"])
def test_face_order_and_mask_equal_jax(cases, i):
    _, jm, tm, _, _ = cases[i]
    for f in ("f_owner", "f_boundary", "f_nx", "f_ny", "f_area", "f_cx"):
        assert np.array_equal(getattr(tm, f).numpy(),
                              np.asarray(getattr(jm, f))), f
    w = obstacle_face_mask(tm)
    assert w.dtype == np.float32 and w.sum() > 10
    np.testing.assert_array_equal(w, jf.obstacle_face_mask(jm))


@pytest.mark.parametrize("i", [0, 1], ids=["channel", "delaunay"])
def test_body_force_and_coefficients_equal_jax(cases, i):
    _, jm, tm, jst, jpar = cases[i]
    tst, tpar = _carry(jst, jpar)
    w = jf.obstacle_face_mask(jm)
    jforce = np.asarray(jf.body_force(jm, jst, jpar, w))
    tforce = body_force(tm, tst, tpar, obstacle_face_mask(tm)).numpy()
    assert np.abs(jforce).max() > 0.1
    assert np.abs(tforce - jforce).max() <= RTOL * np.abs(jforce).max()
    jc = np.array(jf.force_coefficients(jm, jst, jpar, w, u_ref=1.0,
                                        d_ref=0.4), dtype=np.float64)
    tc = np.array([float(c) for c in force_coefficients(
        tm, tst, tpar, w, u_ref=1.0, d_ref=0.4)])
    assert np.abs(tc - jc).max() <= RTOL * np.abs(jc).max()


def test_card_export_read_by_jax_equals_port(cases, tmp_path):
    """chip_smoke.py --export-forces writes what the force formula reads of
    a state; tests/torch_forces_crosscheck.py reads it with the JAX
    functions.  On the channel state that reading equals the JAX package's
    own on the full mesh and the port's (RTOL), and the drag's parts add up
    to it."""
    import importlib.util
    from pathlib import Path
    from torch_forces_crosscheck import jax_reading
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, jm, tm, jst, jpar = cases[0]
    tst, tpar = _carry(jst, jpar)
    w = obstacle_face_mask(tm)
    port = np.array([float(c) for c in force_coefficients(tm, tst, tpar, w)])
    out = tmp_path / "forces.npz"
    smoke._export_forces(out, tm, tst, tpar, w, port)
    r = jax_reading(out)
    assert r["mask_equal"] and r["faces"] == int(w.sum())
    jc = np.array(jf.force_coefficients(jm, jst, jpar,
                                        jf.obstacle_face_mask(jm)),
                  dtype=np.float64)
    got = np.array(r["jax"])
    assert np.abs(got - jc).max() <= RTOL * np.abs(jc).max()
    assert np.abs(got - port).max() <= RTOL * np.abs(jc).max()
    assert sum(r["parts"].values()) == pytest.approx(jc[0], rel=RTOL)


# --- tests/test_forces.py, held for the port --------------------------


@pytest.fixture(scope="module")
def solver():
    geo = jmesh_mod.ChannelWithObstacle(length=3.0, height=1.0,
                                        obstacle_center=(1.0, 0.5),
                                        obstacle_radius=0.2)
    mesh = jmesh_mod.generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.0, 1.0))
    s = CoupledSolver(mesh, device="cpu")
    s.set_dt(0.01)
    s.set_viscosity(0.01)
    s.set_density(1.0)
    return s


def test_mask_selects_obstacle_faces_only(solver):
    w = obstacle_face_mask(solver.mesh)
    assert w.sum() > 10
    cx = solver.mesh.f_cx.numpy()[w > 0]
    cy = solver.mesh.f_cy.numpy()[w > 0]
    assert np.all(np.abs(np.hypot(cx - 1.0, cy - 0.5) - 0.2) < 0.05)


def test_closed_surface_normals_sum_to_zero(solver):
    """The obstacle's cut faces form a closed polygon: sum n*A ~= 0."""
    m = solver.mesh
    w = obstacle_face_mask(m)
    A = m.f_area.numpy()
    perim = float((w * A).sum())
    assert perim == pytest.approx(2 * np.pi * 0.2, rel=0.15)
    assert abs(float((w * m.f_nx.numpy() * A).sum())) < 1e-3 * perim
    assert abs(float((w * m.f_ny.numpy() * A).sum())) < 1e-3 * perim


def test_uniform_pressure_zero_force(solver):
    """Constant p on a closed body and u = 0 -> zero net force."""
    s = solver
    w = obstacle_face_mask(s.mesh)
    st = replace(s.state, p=s.state.p * 0 + 7.5,
                 grad_p=s.state.grad_p * 0, u=s.state.u * 0)
    f = body_force(s.mesh, st, s.params, w).numpy()
    perim = float((w * s.mesh.f_area.numpy()).sum())
    assert np.abs(f).max() < 1e-3 * 7.5 * perim


def test_drag_positive_on_started_flow(solver):
    """A few steps of impulsively started flow: drag along +x dominates."""
    s = solver
    s.set_u(np.zeros((s.mesh.num_host_cells, 2)))
    s.run(8)
    w = obstacle_face_mask(s.mesh)
    cd, cl = force_coefficients(s.mesh, s.state, s.params, w,
                                u_ref=1.0, d_ref=0.4)
    cd, cl = float(cd), float(cl)
    assert np.isfinite(cd) and np.isfinite(cl)
    assert cd > 0.0
    assert abs(cl) < max(1.0, abs(cd))


def test_strouhal_estimator_synthetic():
    dt = 0.01
    t = np.arange(4000) * dt
    f = 2.5
    cl = 0.3 * np.sin(2 * np.pi * f * t) + 0.02
    st = strouhal_number(cl, np.full(len(t), dt), u_ref=1.0, d_ref=0.4)
    assert st == pytest.approx(f * 0.4, rel=0.02)
    assert st == jf.strouhal_number(cl, np.full(len(t), dt))


def test_strouhal_estimator_too_short():
    cl = np.sin(np.linspace(0, 2.0, 50))
    assert strouhal_number(cl, np.full(50, 0.01)) == 0.0


def test_restarting_the_inlet_ramp_reverses_the_drag():
    """A flow past the end of the inlet ramp (t > ramp_time) stepped on from
    its own time keeps a positive drag; the same state stepped on from time
    0, as a state loaded into a fresh solver is, restarts the ramp: the
    inlet nearly closes, the channel decelerates against an adverse
    pressure gradient and the drag turns negative.  This is why the
    developed 1M state reads a negative Cd after its healing steps."""
    geo = jmesh_mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = jmesh_mod.generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.0, 1.0))
    s = CoupledSolver(mesh, device="cpu")
    s.set_dt(0.01)
    s.set_viscosity(0.0025)
    for _ in range(15):
        s.step()
    assert float(s.state.time) > float(s.params.ramp_time)
    w = obstacle_face_mask(s.mesh)
    developed = s.state
    cd = {}
    for label, state in (("own time", developed),
                         ("time 0", replace(developed, time=torch.zeros_like(
                             developed.time)))):
        s.state = state
        s.set_dt(0.002)
        s.step()
        cd[label] = float(force_coefficients(s.mesh, s.state, s.params,
                                             w)[0])
    assert cd["own time"] > 0.5, cd
    assert cd["time 0"] < -10 * cd["own time"], cd
