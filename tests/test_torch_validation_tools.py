"""The port's physics-validation tools (``cfd2_tpu_torch/tools/``) against
the JAX package's (``tools/``), on the CPU at small sizes: Schäfer–Turek
2D-2 at h = 0.02 through the tool's chunk loop against the JAX tool's
scanned loop, the water backwards step at h = 0.05, the developed cascade's
helpers against ``tools/make_developed.py``'s own functions on a 0.05 mesh,
the warm start's interpolation, and the tools' output paths.

Tolerances: outer counts equal per step and FGMRES iterations within 1 per
outer; u within 1e-4 * max|u| and p within 1e-3 * max|p| in host order
(``tests/torch_parity.py`` says why); each step's (Cd, Cl) within 1e-3 of
the largest |Cd| of the run, the pressure's bound carried into its surface
integral; the inlet scale, the cascade's perturbation, grid fields,
prolongation and probe cell, and the interpolation bit for bit (the same
NumPy and SciPy expressions on the same inputs)."""

import json
from dataclasses import replace
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import torch_fullsize_parity as fp
import torch_validation_counts as tvc
from cfd2_tpu.models import coupled as jcp
from cfd2_tpu.utils.forces import body_force as j_body_force
from cfd2_tpu.utils.forces import obstacle_face_mask as j_face_mask
from cfd2_tpu_torch.mesh import BOUNDARY_INLET
from cfd2_tpu_torch.tools import make_developed as md
from cfd2_tpu_torch.tools import make_developed_2m as m2
from cfd2_tpu_torch.tools import measure_strouhal as ms
from cfd2_tpu_torch.tools import stiff_water as sw
from cfd2_tpu_torch.tools import validate_turek as vt
from cfd2_tpu_torch.utils.forces import obstacle_face_mask

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
U_REL, P_REL, F_REL = 1e-4, 1e-3, 1e-3
TUREK_H, WATER_H, CASCADE_H = 0.02, 0.05, 0.05


def _fields_close(js, ts, label):
    ju, tu = np.asarray(js.get_u()), ts.get_u()
    jp, tp = np.asarray(js.get_p()), ts.get_p()
    du = np.abs(tu - ju).max()
    dp = np.abs(tp - jp).max()
    assert du <= U_REL * np.abs(ju).max(), f"{label}: u {du:.3e}"
    assert dp <= P_REL * max(np.abs(jp).max(), 1e-30), f"{label}: p {dp:.3e}"


def _counts_close(js, ts, label):
    jo, to = int(js.state.outer_iters), int(ts.state.outer_iters)
    assert jo == to, f"{label}: outers {to} != JAX {jo}"
    jl = int(js.state.linear_iters_total)
    tl = int(ts.state.linear_iters_total)
    assert abs(jl - tl) <= jo, f"{label}: FGMRES {tl} vs JAX {jl}"


def _jax_chunk(mask, q):
    """The JAX tool's ``run_chunk`` (tools/validate_turek.py:138-144)."""
    @partial(jax.jit, static_argnames=("config", "n"))
    def run_chunk(mesh, state, params, config, amg, n):
        def body(st, _):
            st = lax.cond(st.should_stop, lambda x: x,
                          lambda x: jcp.step(mesh, x, params, config, amg),
                          st)
            return st, j_body_force(mesh, st, params, mask) / q
        return lax.scan(body, state, None, length=n)
    return run_chunk


@pytest.fixture(scope="module")
def turek():
    js = tvc.jax_turek_solver(tvc.jax_turek_mesh(TUREK_H), TUREK_H)
    ts = vt.make_solver(vt.make_mesh(TUREK_H), TUREK_H, device="cpu")
    return js, ts


def test_turek_inlet_scale_is_the_jax_packages(turek):
    js, ts = turek
    for f in ("ck_inlet_scale", "f_inlet_scale"):
        j = np.asarray(getattr(js.mesh, f))
        t = getattr(ts.mesh, f)
        if f == "ck_inlet_scale":   # per cell slot: compare in host order
            j = np.asarray(js.mesh.to_host_order(jnp.asarray(j)))
            t = ts.mesh.to_host_order(t)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)
    inlet = ts.mesh.f_boundary.numpy() == BOUNDARY_INLET
    assert inlet.any()
    np.testing.assert_allclose(ts.mesh.f_inlet_scale.numpy()[inlet].max(),
                               1.5, rtol=2e-2)
    assert ts.params.dt_old is ts.params.dt


def test_turek_chunk_loop_matches_the_jax_tool(turek):
    """Three steps, one chunk of one step each, through both tools' loops:
    outers, fields and the per-step Cd and Cl."""
    js, ts = turek
    q = vt.force_scale()
    run_chunk = _jax_chunk(jnp.asarray(j_face_mask(js.mesh)), q)
    mask = obstacle_face_mask(ts.mesh)
    np.testing.assert_array_equal(mask, np.asarray(j_face_mask(js.mesh)))
    out = torch.empty((vt.CHUNK, 2))
    fj, ft = [], []
    for i in range(3):
        js.state, f = run_chunk(js.mesh, js.state, js.params, js.config,
                                js._get_amg(), 1)
        fj.append(np.asarray(f)[0])
        ft.append(vt.run_chunk(ts, mask, 1, out)[0])
        _counts_close(js, ts, f"step {i}")
        _fields_close(js, ts, f"step {i}")
    fj, ft = np.array(fj), np.array(ft)
    assert np.isfinite(ft).all()
    assert np.abs(ft - fj).max() <= F_REL * np.abs(fj[:, 0]).max(), (ft, fj)
    assert float(ts.params.dt_old) == float(ts.params.dt)


def test_turek_summary_is_the_jax_tools():
    """Cd_max, Cl_max, St and the interval flags of a synthetic series, as
    the JAX tool computes them (tools/validate_turek.py:158-186)."""
    from cfd2_tpu.utils.forces import strouhal_number
    dt, n = 0.001, 4000
    t = np.arange(n) * dt
    cd = 3.23 + 0.01 * np.sin(2 * np.pi * 6.0 * t)
    cl = 1.0 * np.sin(2 * np.pi * 3.0 * t + 0.3)
    row = vt.summary(cd, cl, dt, 3000)
    st = strouhal_number(cl[-3000:], np.full(3000, dt), u_ref=1.0, d_ref=0.1)
    assert row["st"] == round(float(st), 4) and abs(row["st"] - 0.3) < 1e-3
    assert row["cd_max"] == round(float(cd[-3000:].max()), 4)
    assert row["cl_min"] == round(float(cl[-3000:].min()), 4)
    assert row["in_interval"] == {"cd_max": True, "cl_max": True, "st": True}


def test_warm_start_interpolation(tmp_path):
    """A coarse rung's field in the JAX tool's format, interpolated onto a
    finer mesh as the JAX tool interpolates it (griddata linear, nearest
    outside the hull), and the solver's history and ramp as it leaves
    them."""
    from scipy.interpolate import griddata
    coarse = vt.make_mesh(0.04)
    cs = vt.make_solver(coarse, 0.04, device="cpu")
    rng = np.random.default_rng(11)
    cs.set_u(rng.standard_normal((coarse.num_cells, 2)))
    cs.set_p(rng.standard_normal(coarse.num_cells))
    path = tmp_path / "turek_torch_0.04.npz"
    vt.save_field(path, cs, coarse)
    with np.load(path) as d:
        assert sorted(d.files) == ["cx", "cy", "p", "t", "u"]
        assert d["u"].dtype == np.float16 and d["p"].dtype == np.float16
        src = {k: d[k] for k in d.files}
    fine = vt.make_mesh(TUREK_H)
    s = vt.make_solver(fine, TUREK_H, device="cpu")
    vt.warm_start(s, fine, path)
    pts = np.stack([src["cx"], src["cy"]], axis=1)
    tgt = np.stack([fine.cell_cx, fine.cell_cy], axis=1)

    def interp(vals):   # tools/validate_turek.py:119-125
        lin = griddata(pts, vals.astype(np.float32), tgt, method="linear")
        near = griddata(pts, vals.astype(np.float32), tgt, method="nearest")
        return np.where(np.isfinite(lin), lin, near)

    u0 = np.stack([interp(src["u"][:, 0]), interp(src["u"][:, 1])], axis=1)
    np.testing.assert_array_equal(s.get_u(), u0.astype(np.float32))
    np.testing.assert_array_equal(s.get_p(), interp(src["p"])
                                  .astype(np.float32))
    assert torch.equal(s.state.u_old, s.state.u)
    assert torch.equal(s.state.u_old_old, s.state.u)
    assert float(s.params.ramp_time) == np.float32(1e-9)


def test_water_step_matches_jax():
    """The water backwards step at h = 0.05: the tool's record and three
    steps in both packages."""
    js = tvc.jax_water_solver(WATER_H)
    mesh = sw.make_mesh(WATER_H)
    ts = sw.make_solver(mesh, "cpu")
    assert ts.mesh.structured
    assert tuple(ts.mesh.grid_shape) == tuple(js.mesh.grid_shape) == (20, 70)
    for i in range(3):
        js.step()
        ts.step()
        _counts_close(js, ts, f"step {i}")
        _fields_close(js, ts, f"step {i}")
    row = sw.run(WATER_H, 3, device="cpu", out=None, log=lambda m: None)
    assert row["finite"] and row["layout"] == "structured (20, 70)"
    assert row["per_step"][-1]["outers"] == int(js.state.outer_iters)
    # On a solver set up by the caller (as chip_smoke.py hands it one): the
    # same steps.
    again = sw.run(WATER_H, 3, out=None, log=lambda m: None,
                   solver=sw.make_solver(mesh, "cpu"))
    assert [(r["outers"], r["its"], r["max_u"]) for r in again["per_step"]] \
        == [(r["outers"], r["its"], r["max_u"]) for r in row["per_step"]]
    np.testing.assert_allclose(
        row["max_vel"], np.linalg.norm(np.asarray(js.get_u()), axis=1).max(),
        rtol=U_REL)


@pytest.fixture(scope="module")
def cascade():
    jtool = fp._jax_tool("make_developed")
    return jtool, jtool.make_solver(CASCADE_H), md.make_solver(
        CASCADE_H, "cpu", log=lambda m: None)


def test_cascade_solver_is_the_jax_tools(cascade):
    _, js, ts = cascade
    for f in ("dt", "viscosity", "density"):
        assert float(getattr(ts.params, f)) == float(getattr(js.params, f))
    for f in ("precond_type", "fgmres_max_restarts", "stop_count"):
        assert getattr(ts.config, f) == getattr(js.config, f)
    assert tuple(ts.mesh.grid_shape) == tuple(js.mesh.grid_shape)
    assert md.probe_index(ts) == cascade[0].probe_index(js)


def test_cascade_helpers_are_the_jax_tools(cascade):
    jtool, js, ts = cascade
    rng = np.random.default_rng(5)
    ny, nx = 12, 37
    u_c = rng.standard_normal((ny, nx, 2)).astype(np.float32)
    p_c = rng.standard_normal((ny, nx)).astype(np.float32)
    jtool.prolong_into(js, u_c, p_c, 3.0 / nx)
    md.prolong_into(ts, u_c, p_c, 3.0 / nx)
    jtool.perturb_wake(js)
    md.perturb_wake(ts)
    for a, b in zip(jtool.grid_fields(js), md.grid_fields(ts)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    for f in ("u", "u_old", "u_old_old", "prev_u", "p"):
        np.testing.assert_array_equal(getattr(ts.state, f).numpy(),
                                      np.asarray(getattr(js.state, f)), f)


def test_cascade_run_steps_match_the_jax_tools():
    """Two adaptive steps of the cascade's loop (CFL 0.4) from the inlet
    start of the 0.05 channel, in both tools."""
    jtool = fp._jax_tool("make_developed")
    js = jtool.make_solver(CASCADE_H)
    ts = md.make_solver(CASCADE_H, "cpu", log=lambda m: None)
    u0 = np.zeros((js.mesh.num_cells, 2), np.float32)
    cx = np.asarray(js.mesh.c_cx)
    u0[:, 0] = np.where(cx < 0.1, 1.0, 0.0) * np.asarray(js.mesh.c_valid)
    js.state = replace(js.state, u=jnp.asarray(u0), u_old=jnp.asarray(u0),
                       u_old_old=jnp.asarray(u0), prev_u=jnp.asarray(u0))
    md._set_u(ts, u0)
    sj = jtool.run_steps(js, 2, CASCADE_H, batch=2, label="jax")
    st = md.run_steps(ts, 2, CASCADE_H, batch=2, log=lambda m: None)
    assert float(ts.params.dt) == pytest.approx(float(js.params.dt), rel=1e-6)
    assert float(ts.state.time) == pytest.approx(float(js.state.time),
                                                 rel=1e-6)
    scale = float(np.abs(np.asarray(js.state.u)).max())
    assert abs(st[0] - sj[0]) <= U_REL * scale
    _fields_close(js, ts, "after two adaptive steps")


def test_cascade_and_measurement_run_end_to_end(tmp_path, monkeypatch):
    """The cascade (two tiny levels), the 2M tool and the Strouhal tool
    on the CPU: finite outputs in the JAX tools' file formats, every cache
    under the port's own names."""
    monkeypatch.setattr(md, "CACHE", tmp_path)
    out = tmp_path / "developed.npz"
    meta = md.run("cpu", out, sizes=(0.1, 0.05), heal_steps={0.1: 2, 0.05: 2},
                  log=lambda m: None)
    assert sorted(p.name for p in tmp_path.glob("torch_developed_*.npz")) \
        == ["torch_developed_0.05.npz", "torch_developed_0.1.npz"]
    with np.load(out) as d:
        assert sorted(d.files) == ["h", "meta", "p", "u"]
        assert d["u"].shape == (20, 60, 2) and d["u"].dtype == np.float16
        assert json.loads(str(d["meta"]))["grid"] == meta["grid"] == [20, 60]
    m2meta = m2.run(out, tmp_path / "d2.npz", 2, size=0.025, device="cpu",
                    log=lambda m: None)
    assert m2meta["grid"] == [40, 120] and m2meta["cells"] == 4636
    res = ms.run(out, size=0.05, t_span=0.05, heal_steps=2, batch=2,
                 device="cpu", log=lambda m: None)
    assert res["samples"] >= 1 and np.isfinite(res["Cd_mean"])
    assert res["Re"] == 160 and res["card"] == "cpu"


def _jax_outputs():
    """Every file the JAX package's validation tools write; each name is
    checked against the source of the tool that writes it."""
    outs = {"validate_turek.py": ("TUREK.jsonl", 'f"turek_{h}.npz"'),
            "stiff_water_tpu.py": ("STIFF_TPU.json",),
            "stiff_water_x64.py": ("STIFF_X64.json",),
            "make_developed.py": ("bench_developed_1m.npz",
                                  'f"developed_{size}.npz"'),
            "make_developed_2m.py": ("bench_developed_2m.npz",)}
    for tool, tokens in outs.items():
        src = (ROOT / "tools" / tool).read_text()
        for token in tokens:
            assert token in src, (tool, token)
    paths = ["TUREK.jsonl", "STIFF_TPU.json", "STIFF_X64.json",
             "bench_developed_1m.npz", "bench_developed_2m.npz"]
    paths += [f".bench_cache/turek_{h}.npz" for h in (0.005, 0.0035, 0.0025)]
    paths += [f".bench_cache/developed_{s}.npz" for s in md.SIZES]
    return {(ROOT / p).resolve() for p in paths}


def test_no_port_tool_writes_a_jax_tools_path():
    port = {vt.RECORD, sw.OUT, md.OUT, m2.OUT}
    port |= {vt.cache_path(h) for h in (0.005, 0.0035, 0.0025)}
    port |= {vt.window_path(h) for h in (0.005, 0.0035, 0.0025)}
    port |= {md.level_path(s) for s in md.SIZES}
    port = {Path(p).resolve() for p in port}
    assert not port & _jax_outputs()
    assert all(p.name.startswith(("turek_card", "turek_torch_",
                                  "turek_window_", "stiff_water_card",
                                  "developed_1m_card", "torch_developed_"))
               for p in port)
