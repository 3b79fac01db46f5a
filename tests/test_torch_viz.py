"""The port's viz layer (cfd2_tpu_torch/viz) against cfd2_tpu's: the
renderer's pixels on the same host field (grid and polygon paths), the HTML
viewer's bytes, and the live server's run / pause / render / control /
reset behaviour of tests/test_live_viewer.py, port side only (the solver
thread steps the port's Simulation on the CPU)."""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh_mod
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu.viz import FieldRenderer as JRenderer
from cfd2_tpu.viz import rainbow_colormap as jrainbow
from cfd2_tpu.viz import write_html_viewer as jwrite
from cfd2_tpu_torch.app.driver import Simulation
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode
from cfd2_tpu_torch.viz import FieldRenderer, rainbow_colormap, \
    write_html_viewer
from cfd2_tpu_torch.viz.live_server import LiveServer

torch.set_num_threads(1)
plt = pytest.importorskip("matplotlib.pyplot")


def _pixels(fig):
    fig.canvas.draw()
    rgba = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return rgba


def test_colormap_equals_jax():
    t = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_array_equal(rainbow_colormap(t), jrainbow(t))
    assert np.allclose(rainbow_colormap(np.array(0.5)), [0, 1, 0])


@pytest.fixture(scope="module")
def channel():
    geo = jmesh_mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return jmesh_mod.generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.0, 1.0))


@pytest.mark.parametrize("mode", ["mag", "u", "p"])
def test_grid_renderer_pixels_equal_jax(channel, mode):
    """The O(pixels) grid path on the structured layout: the same
    device-order field, given to the port as tensors, to JAX as arrays."""
    dm, jm = tencode(channel, device="cpu"), jencode(channel)
    assert dm.structured
    rng = np.random.default_rng(3)
    n = dm.num_cells
    u = rng.standard_normal((n, 2)).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    port = FieldRenderer(channel, device_mesh=dm)
    ref = JRenderer(channel, device_mesh=jm)
    assert port.grid == ref.grid and port.triangles is None
    S = lambda u, p: type("S", (), {"u": u, "p": p, "d_p": p})()
    got = _pixels(port.render(S(torch.as_tensor(u), torch.as_tensor(p)),
                              mode=mode))
    want = _pixels(ref.render(S(u, p), mode=mode))
    np.testing.assert_array_equal(got, want)


def test_polygon_renderer_pixels_equal_jax(tmp_path):
    geo = jmesh_mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = jmesh_mod.generate_delaunay_mesh(geo, 0.1, 0.1, 1.2, (3.0, 1.0))
    port, ref = FieldRenderer(mesh), JRenderer(mesh)
    np.testing.assert_array_equal(port.triangles, ref.triangles)
    np.testing.assert_array_equal(port.tri_cell, ref.tri_cell)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((mesh.num_cells, 2)).astype(np.float32)
    S = lambda u: type("S", (), {"u": u, "p": u[:, 0], "d_p": u[:, 1]})()
    for mode, wire in (("mag", False), ("v", True)):
        got = _pixels(port.render(S(torch.as_tensor(u)), mode=mode,
                                  show_mesh=wire))
        want = _pixels(ref.render(S(u), mode=mode, show_mesh=wire))
        np.testing.assert_array_equal(got, want)
    path = tmp_path / "frame.png"
    port.render(S(u), path=str(path))
    assert path.read_bytes()[:4] == b"\x89PNG"


def test_html_viewer_bytes_equal_jax(tmp_path):
    frames = [("step 0", b"\x89PNG-a"), ("step <1>", b"\x89PNG-bb")]
    meta = {"cells": 296, "Re": 100.0, "mesh": "cutcell & co"}
    jwrite(str(tmp_path / "j.html"), frames, title="t", metadata=meta)
    write_html_viewer(str(tmp_path / "t.html"), frames, title="t",
                      metadata=meta)
    assert (tmp_path / "t.html").read_bytes() == \
        (tmp_path / "j.html").read_bytes()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _wait_step(base, at_least, seconds=120):
    deadline = time.time() + seconds
    while time.time() < deadline:
        s = json.loads(_get(base + "status"))
        if s["step"] >= at_least:
            return s
        time.sleep(0.2)
    return s


def _rect():
    return Simulation(geometry="rect", mesh_type="cutcell", cell_size=0.1,
                      device="cpu")


def test_live_server_runs_pauses_and_renders():
    sim = _rect()
    server = LiveServer(sim, port=0).start()
    try:
        base = server.url
        assert b"cfd2_tpu" in _get(base)
        s = _wait_step(base, 2)
        assert s["step"] >= 2, f"solver did not advance: {s}"

        _get(base + "control?pause")
        time.sleep(0.5)
        s1 = json.loads(_get(base + "status"))
        assert s1["paused"]
        time.sleep(1.0)
        s2 = json.loads(_get(base + "status"))
        assert s2["step"] == s1["step"]

        _get(base + "control?field=p")
        assert _get(base + "frame.png")[:4] == b"\x89PNG"
        assert _get(base + "frame.png?field=u")[:4] == b"\x89PNG"

        _get(base + "control?inlet=0.5")
        assert float(sim.solver.params.inlet_velocity) == 0.5

        _get(base + "control?resume")
        s3 = _wait_step(base, s2["step"] + 1, 60)
        assert s3["step"] > s2["step"]
    finally:
        server.stop()


def test_live_server_control_parity():
    sim = _rect()
    server = LiveServer(sim, port=0).start()
    try:
        base = server.url
        _get(base + "control?pause")
        time.sleep(0.3)
        _get(base + "control?scheme=1")
        assert sim.solver.config.scheme == 1
        _get(base + "control?time_scheme=1")
        assert sim.solver.config.time_scheme == 1
        _get(base + "control?precond=1")
        assert sim.solver.config.precond_type == 1
        _get(base + "control?fluid=Water")
        assert float(sim.solver.params.density) == 1000.0
        s = json.loads(_get(base + "status"))
        assert abs(s["re"] - sim.reynolds) < 1e-6 and s["re"] > 0
        _get(base + "control?alpha_p=0.8")
        assert abs(float(sim.solver.params.alpha_p) - 0.8) < 1e-6
        _get(base + "control?dt=0.002")
        assert abs(float(sim.solver.params.dt) - 0.002) < 1e-9
        _get(base + "control?cfl=0.3")
        assert abs(sim.controller.target_cfl - 0.3) < 1e-9
        _get(base + "control?adaptive=0")
        assert sim.adaptive is False
        _get(base + "control?wireframe=1")
        assert _get(base + "frame.png")[:4] == b"\x89PNG"
        _get(base + "control?reset")
        s = json.loads(_get(base + "status"))
        assert s["step"] == 0 and s["time"] == 0.0
        assert float(sim.solver.state.time) == 0.0
    finally:
        server.stop()


def test_grid_render_of_the_live_state(channel):
    """The live server's grid path: device-order tensors of a structured
    solver, snapshotted under the step lock, render as a PNG figure."""
    from cfd2_tpu_torch.viz.live_server import LiveSolverThread
    sim = Simulation(geometry="channel", cell_size=0.05, device="cpu")
    r = FieldRenderer(sim.mesh, device_mesh=sim.solver.mesh)
    assert r.grid is not None
    state, stats = LiveSolverThread(sim).snapshot(dev_order=True)
    assert isinstance(state.u, np.ndarray) and stats["step"] == 0
    t0 = time.time()
    fig = r.render(state, mode="mag")
    assert time.time() - t0 < 10.0
    plt.close(fig)


def test_live_server_reset_rebuilds_mesh():
    """As tests/test_live_viewer.py, but paused across the edits: a CPU
    step of this mesh takes ~10 ms, so the rect channel reaches its steady
    state (~150 steps) within seconds, and the solver thread ends there, as
    the JAX package's does."""
    sim = _rect()
    n_before = sim.mesh.num_cells
    server = LiveServer(sim, port=0).start()
    try:
        base = server.url
        _wait_step(base, 1)
        _get(base + "control?pause")
        _get(base + "control?geometry=backstep")
        _get(base + "control?cell=0.08")
        _get(base + "control?reset")
        _get(base + "control?resume")
        assert sim.geometry == "backstep" and sim.cell_size == 0.08
        assert sim.mesh.num_cells != n_before
        assert sim.solver.device.type == "cpu"
        s0 = json.loads(_get(base + "status"))
        assert s0["cells"] == sim.mesh.num_cells
        s = _wait_step(base, 1, 180)
        assert s["step"] >= 1 and s["cells"] == sim.mesh.num_cells
        assert _get(base + "frame.png")[:4] == b"\x89PNG"
        _get(base + "control?reset")
        assert sim.geometry == "backstep"
        assert json.loads(_get(base + "status"))["cells"] == \
            sim.mesh.num_cells
    finally:
        server.stop()
