"""The port's tools for the developed full-size cases against the JAX
package's, on the CPU at small sizes: the bilinear sampling, the shared mesh
cache, the heal of ``make_developed_unstructured`` and the state it writes,
and each case's set-up in ``developed_cases`` against the JAX set-up of
``tests/torch_fullsize_parity.py``.

Tolerances: the bilinear sampling bit for bit (the same NumPy expression);
cached meshes equal in every field; the heal's outer counts equal per step
and its FGMRES iterations within 1 per outer (``tests/torch_parity.py``
says why); u within 1e-4 * max|u| and p within 1e-3 * max|p| in host order
where every solve ended on the JAX package's iteration, else within
``torch_parity.BF16``'s bounds for a solve that ended on another iteration
(5e-3, 5e-2).  The heal's first solve here ends 16 iterations in against
the JAX package's 15, its residual crossing the target within roundoff,
which leaves u 2.2e-4 * max|u| and p 1.0e-4 * max|p| apart after two
steps.  The set-ups equal in dt, viscosity, density, time, every
``SolverConfig`` field and the loaded fields."""

import json
import sys
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU: tests/conftest.py)

import torch_fullsize_parity as fp
from torch_parity import BF16
from cfd2_tpu.mesh import ChannelWithObstacle
from cfd2_tpu.mesh import generate_cut_cell_mesh as j_cutcell
from cfd2_tpu.mesh import generate_delaunay_mesh as j_delaunay
from cfd2_tpu.mesh import generate_voronoi_mesh as j_voronoi
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.convert import load_developed_unstructured
from cfd2_tpu_torch.mesh import generate_delaunay_mesh as t_delaunay
from cfd2_tpu_torch.mesh import generate_voronoi_mesh as t_voronoi
from cfd2_tpu_torch.mesh.structs import Mesh as TMesh
from cfd2_tpu_torch.runtime.state import SolverConfig
from cfd2_tpu_torch.tools import developed_cases as dc
from cfd2_tpu_torch.tools import make_developed_unstructured as mdu
from cfd2_tpu_torch.tools import mesh_cache

torch.set_num_threads(2)
U_REL, P_REL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def jax_tools():
    return (fp._jax_tool("make_developed_unstructured"),
            fp._jax_tool("mesh_cache"))


@pytest.mark.parametrize("ndim", [2, 3])
def test_bilerp_is_the_jax_tools(jax_tools, ndim):
    rng = np.random.default_rng(7 + ndim)
    shape = (23, 61) if ndim == 2 else (23, 61, 2)
    field = rng.standard_normal(shape).astype(np.float32)
    h = 3.0 / 61
    # Points inside the grid, on and past its edges.
    x = rng.uniform(-0.1, 3.1, 500)
    y = rng.uniform(-0.1, 23 * h + 0.1, 500)
    got = mdu.bilerp(field, x, y, h)
    ref = jax_tools[0].bilerp(field, x, y, h)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


MESHES = {"delaunay": (0.025, t_delaunay, j_delaunay, 5843),
          "voronoi": (0.04, t_voronoi, j_voronoi, None)}


@pytest.fixture(scope="module")
def mesh_pairs():
    """Each mesh generated by both packages' generators, as the two
    ``get_mesh`` call them."""
    out = {}
    for kind, (h, tgen, jgen, _) in MESHES.items():
        t = tgen(mesh_cache.channel(), h, h, 1.2, (3.0, 1.0))
        j = jgen(_jax_channel(), h, h, 1.2, (3.0, 1.0))
        out[kind] = (t, j)
    return out


def _jax_channel():
    return ChannelWithObstacle(length=3.0, height=1.0,
                               obstacle_center=(1.0, 0.5),
                               obstacle_radius=0.2)


def _assert_meshes_equal(a, b):
    for f in fields(TMesh):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (va is None) == (vb is None), f.name
        if va is not None:
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_mesh_cache_round_trip(jax_tools, mesh_pairs, tmp_path, kind,
                               direction):
    t, j = mesh_pairs[kind]
    cells = MESHES[kind][3]
    if cells is not None:
        assert t.num_cells == cells
    jmc = jax_tools[1]
    path = str(tmp_path / "mesh.npz")
    if direction == "jax_to_port":
        jmc.save_mesh(j, path)
        loaded = mesh_cache.load_mesh(path)
        assert isinstance(loaded, TMesh)
        _assert_meshes_equal(loaded, t)
    else:
        mesh_cache.save_mesh(t, path)
        loaded = jmc.load_mesh(path)
        _assert_meshes_equal(loaded, j)
    assert mesh_cache.mesh_path(kind, MESHES[kind][0]).endswith(
        jmc.mesh_path(kind, MESHES[kind][0])[len(str(jmc.CACHE)):])


def _jax_heal_solver(jmesh, size, src_meta):
    """The JAX tool's solver (tools/make_developed_unstructured.py:80-96)."""
    s = JSolver(jmesh)
    s.set_viscosity(src_meta["viscosity"])
    s.set_density(src_meta.get("density", 1.0))
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5, stop_count=10**9)
    s.set_dt(min(2e-4, 0.25 * size))
    return s


def _field_bounds(same_iterations):
    """(u, p) bounds relative to the JAX fields' maxima."""
    if same_iterations:
        return U_REL, P_REL
    return BF16["u_rel"], BF16["p_rel"]


def _counts(s):
    return int(s.state.outer_iters), int(s.state.linear_iters_total)


def test_heal_matches_jax_and_its_state_loads_in_both(jax_tools,
                                                      mesh_pairs, tmp_path):
    size = MESHES["delaunay"][0]
    tmesh, jmesh = mesh_pairs["delaunay"]
    jtool = jax_tools[0]
    u_g, p_g, h, src_meta = mdu.load_source()
    # The JAX tool's prolongation and heal, step by step.
    js = _jax_heal_solver(jmesh, size, src_meta)
    js.set_u(jtool.bilerp(u_g, jmesh.cell_cx, jmesh.cell_cy, h))
    js.set_p(jtool.bilerp(p_g, jmesh.cell_cx, jmesh.cell_cy, h))
    js.initialize_history()
    jcounts = []
    for _ in range(2):
        js.step(mode="fused")
        jcounts.append(_counts(js))
    # The port's tool, as make() runs it.
    ts = mdu.healing_solver(tmesh, size, src_meta, device="cpu")
    mdu.prolong(ts, tmesh, u_g, p_g, h)
    rec = mdu.heal(ts, tmesh, 2, log=lambda m: None)
    for (to, tl), (jo, jl) in zip(rec["counts"], jcounts, strict=True):
        assert to == jo and abs(tl - jl) <= jo, (rec["counts"], jcounts)
    u_rel, p_rel = _field_bounds(rec["counts"] == jcounts)
    ju, tu = js.get_u(), ts.get_u()
    jp, tp = js.get_p(), ts.get_p()
    assert np.abs(tu - ju).max() <= u_rel * np.abs(ju).max()
    assert np.abs(tp - jp).max() <= p_rel * np.abs(jp).max()
    assert float(ts.state.time) == pytest.approx(float(js.state.time))

    # The state the port writes, loaded by both packages: one more step.
    out = tmp_path / "developed.npz"
    meta = {"viscosity": src_meta["viscosity"], "density": 1.0,
            "cells": tmesh.num_cells,
            "solver_time": float(ts.state.time)}
    mdu.write_state(out, ts, meta)
    case = replace(dc.CASES["delaunay_1m_developed"], min_cell=size)
    t2, tmeta = dc.make_solver(case, device="cpu", mesh=tmesh, state=out)
    j2 = fp.jax_solver(case, jmesh, state=out)
    assert tmeta == meta
    assert float(t2.state.time) == float(j2.state.time) \
        == np.float32(meta["solver_time"])
    j2.step()
    t2.step()
    (to, tl), (jo, jl) = _counts(t2), _counts(j2)
    assert to == jo and abs(tl - jl) <= jo, (_counts(t2), _counts(j2))
    u_rel, _ = _field_bounds(tl == jl)
    assert np.abs(t2.get_u() - j2.get_u()).max() \
        <= u_rel * np.abs(j2.get_u()).max()


def test_load_developed_unstructured_refuses_another_mesh(mesh_pairs,
                                                          tmp_path):
    tmesh = mesh_pairs["delaunay"][0]
    n = tmesh.num_cells - 1
    path = tmp_path / "other.npz"
    np.savez_compressed(path, u=np.zeros((n, 2), np.float16),
                        p=np.zeros(n, np.float16),
                        meta=json.dumps({"cells": n, "viscosity": 0.0025,
                                         "solver_time": 0.01}))
    s = mdu.healing_solver(tmesh, 0.025, {"viscosity": 0.0025}, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        load_developed_unstructured(s, path)


def _reduced(name):
    """The case at 8x its cell size, with its mesh from each package."""
    case = dc.CASES[name]
    case = replace(case, min_cell=case.min_cell * 8,
                   max_cell=case.max_cell * 8)
    jgen = {"cutcell": j_cutcell, "delaunay": j_delaunay,
            "voronoi": j_voronoi}[case.mesh_type]
    hmax = max(case.max_cell, case.min_cell)
    jmesh = jgen(_jax_channel(), case.min_cell, hmax, 1.2, (3.0, 1.0))
    tmesh = mesh_cache.GENERATORS[case.mesh_type](
        mesh_cache.channel(), case.min_cell, hmax, 1.2, (3.0, 1.0))
    return case, tmesh, jmesh


def _state_file(case, tmesh, tmp_path):
    """A seeded developed state for the reduced case's mesh: the structured
    checkpoint's keys on its grid, or the heal's keys in host order."""
    rng = np.random.default_rng(3)
    path = tmp_path / "state.npz"
    if case.start == "structured":
        from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
        ny, nx = encode_mesh(tmesh, device="cpu").grid_shape
        np.savez_compressed(
            path, u=rng.standard_normal((ny, nx, 2)).astype(np.float16),
            p=rng.standard_normal((ny, nx)).astype(np.float16),
            h=np.float32(case.min_cell),
            meta=json.dumps({"viscosity": 0.0025, "density": 1.0,
                             "time": 0.05, "grid": [ny, nx]}))
    else:
        n = tmesh.num_cells
        np.savez_compressed(
            path, u=rng.standard_normal((n, 2)).astype(np.float16),
            p=rng.standard_normal(n).astype(np.float16),
            meta=json.dumps({"viscosity": 0.0025, "density": 1.0,
                             "cells": n, "solver_time": 0.0123}))
    return path


@pytest.mark.parametrize("name", sorted(dc.CASES))
def test_case_setup_matches_the_jax_setup(name, tmp_path):
    case, tmesh, jmesh = _reduced(name)
    assert tmesh.num_cells == jmesh.num_cells
    state = (_state_file(case, tmesh, tmp_path) if case.start != "rest"
             else None)
    t, _ = dc.make_solver(case, device="cpu", mesh=tmesh, state=state)
    j = fp.jax_solver(case, jmesh, state=state)
    for f in ("dt", "dt_old", "viscosity", "density", "ramp_time",
              "inlet_velocity", "alpha_u", "alpha_p"):
        assert float(getattr(t.params, f)) == float(getattr(j.params, f)), f
    assert float(t.state.time) == float(j.state.time)
    for f in fields(SolverConfig):
        assert getattr(t.config, f.name) == getattr(j.config, f.name), f.name
    assert np.array_equal(t.get_u(), j.get_u())
    assert np.array_equal(t.get_p(), j.get_p())
    st = dc.settings(case)
    assert float(t.params.dt) == np.float32(st["dt"])
    if case.start == "unstructured":
        assert float(t.state.time) == np.float32(0.0123)
        assert float(t.params.viscosity) == np.float32(0.0025)


def test_entry_points_need_the_card_unless_told_otherwise():
    """The heal's CLI and ``step_case`` default to CUDA and, without a GPU,
    raise before they mesh or step anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dc.step_case("delaunay_1m_developed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mdu.main(["delaunay", "0.0019"])


def test_step_input_round_trip_in_both_packages(tmp_path):
    """``save_step_input`` after two steps of the reduced 403k case: a fresh
    port solver loaded from it takes the next step bit for bit as the
    solver that wrote it, the JAX package's loader in
    ``tests/torch_fullsize_parity.py`` puts the same fields, time and
    parameters into its solver (host order, exactly), and a file of
    another mesh is refused."""
    case, tmesh, jmesh = _reduced("delaunay_403k_rest")
    s, _ = dc.make_solver(case, device="cpu", mesh=tmesh)
    dc.run_steps(s, 2)
    path = tmp_path / "step2.npz"
    dc.save_step_input(s, path, case=case.name, step=2)
    arrs, meta = dc.read_step_input(path)
    assert meta["step"] == 2 and meta["cells"] == tmesh.num_cells
    t, _ = dc.make_solver(case, device="cpu", mesh=tmesh)
    dc.load_step_input(t, path)
    ref, got = dc.run_steps(s, 1)[0], dc.run_steps(t, 1)[0]
    assert (got["outers"], got["its"]) == (ref["outers"], ref["its"])
    assert np.array_equal(t.get_u(), s.get_u())
    assert np.array_equal(t.get_p(), s.get_p())
    j = fp.jax_solver(case, jmesh)
    fp.jax_load_step_input(j, path)
    for f, a in arrs.items():
        assert np.array_equal(np.asarray(j.mesh.to_host_order(
            getattr(j.state, f))), a), f
    assert np.array_equal(np.asarray(j.mesh.to_host_order(j.state.u_old)),
                          arrs["u"])
    assert float(j.state.time) == np.float32(meta["time"])
    for f, v in meta["params"].items():
        assert float(getattr(j.params, f)) == np.float32(v), f
    other = tmp_path / "other.npz"
    np.savez_compressed(other, **arrs, meta=json.dumps(
        dict(meta, cells=tmesh.num_cells + 1)))
    with pytest.raises(ValueError, match="does not fit"):
        dc.load_step_input(t, other)
    with pytest.raises(ValueError, match="does not fit"):
        fp.jax_load_step_input(j, other)


def test_phase_6_holds_step_2_to_the_from_state_record(tmp_path, monkeypatch,
                                                       capsys):
    """``chip_smoke._beside_record`` with the from-state suffix: the card's
    step 2 is held to the one step of ``jax_from_card_step2`` (the round's
    bound: equal outers, iterations within 2 per outer), the from-rest
    record's step 2 only logged; the committed record holds both."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    rec = json.loads(cs.COUNTS_RECORD.read_text())["cases"]
    case = rec["delaunay_403k_rest"]
    assert case["jax_from_card_step2"]["complete"]
    assert case["jax_from_card_step2"]["from_step"] == 2
    step = lambda outers, its: {"outers": outers, "its": its}
    record = tmp_path / "counts.json"
    record.write_text(json.dumps({"cases": {"c": {
        "jax": {"steps": [step(2, [3, 1]), step(2, [4, 1]),
                          step(6, [10] * 6)]},
        "jax_from_card_step2": {"steps": [step(7, [10] * 7)]}}}}))
    monkeypatch.setattr(cs, "COUNTS_RECORD", record)
    rows = [(2, 4), (2, 5), (7, 80)]
    assert cs._beside_record(6, "c", rows[:2], enforce=True) == []
    assert cs._beside_record(6, "c", rows[2:], first=2) == [2]
    assert cs._beside_record(6, "c", rows[2:], enforce=True, first=2,
                             suffix="_from_card_step2") == []
    assert "c_from_card_step2 step 2: card 7 outers, 80 it; JAX (CPU) 7 " \
        "outers, 70 it" in capsys.readouterr().out
    with pytest.raises(cs.PhaseError, match="steps \\[2\\] miss"):
        cs._beside_record(6, "c", [(7, 85)], enforce=True, first=2,
                          suffix="_from_card_step2")


def test_refined_cutcell_state_loads_alike_in_both_packages():
    """The committed refined cut-cell state (129,663 cells, made on the card
    by ``make_developed_unstructured cutcell 0.0015 200 0.006``) on the
    full-size mesh of each package's generator: both take the banded
    unstructured layout (129,664 device cells, 6 faces a cell), and the
    port's loader and the JAX package's reading of the file
    (``torch_fullsize_parity.jax_load_unstructured``) give the same u and p
    in host order, time, viscosity and density, exactly."""
    case = dc.CASES["refined_cutcell_130k_developed"]
    jmesh = j_cutcell(_jax_channel(), case.min_cell, case.max_cell, 1.2,
                      (3.0, 1.0))
    tmesh = mesh_cache.GENERATORS["cutcell"](
        mesh_cache.channel(), case.min_cell, case.max_cell, 1.2, (3.0, 1.0))
    assert tmesh.num_cells == jmesh.num_cells == case.cells
    t, meta = dc.make_solver(case, device="cpu", mesh=tmesh)
    j = fp.jax_solver(case, jmesh)
    assert meta["cells"] == case.cells and meta["heal_steps"] == 200
    for m in (t.mesh, j.mesh):
        assert m.banded and not m.multilevel and not m.structured
        assert (int(m.num_cells), int(m.max_faces)) == (129_664, 6)
    assert np.array_equal(t.get_u(), j.get_u())
    assert np.array_equal(t.get_p(), j.get_p())
    assert float(t.state.time) == float(j.state.time) \
        == np.float32(meta["solver_time"])
    for f in ("viscosity", "density", "dt"):
        assert float(getattr(t.params, f)) == float(getattr(j.params, f)), f
