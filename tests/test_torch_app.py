"""The port's application layer (cfd2_tpu_torch/app, utils/metrics.py,
runtime/profiling.py) against cfd2_tpu's.

The JAX Simulation takes its adaptive dt from whatever max|u| its async
reader has landed, which depends on timing (and on the CPU the port's
reader always lands the fresh value), so the step comparison pins dt:
both Simulations run with ``adaptive=False`` at their dt0.  The adaptive
controller and the reader protocol are tested on their own.  Step
tolerances are tests/torch_parity.py's (equal outers, FGMRES iterations
within 1 per outer, u within 1e-4 and p within 1e-3 of their maxima);
Cd/Cl after the steps agree to 1e-4 of the drag, the velocity bound.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd2_tpu.app.driver import AdaptiveDtController as JController
from cfd2_tpu.app.driver import Simulation as JSimulation
from cfd2_tpu.app.fluids import Fluid as JFluid
from cfd2_tpu.runtime.profiling import ProfileCategory as JCat
from cfd2_tpu.runtime.profiling import ProfilingStats as JStats
from cfd2_tpu.utils import MetricsLog as JLog
from cfd2_tpu_torch.app import AdaptiveDtController, Fluid, Simulation
from cfd2_tpu_torch.app.__main__ import main
from cfd2_tpu_torch.runtime.profiling import ProfileCategory, ProfilingStats
from cfd2_tpu_torch.utils import MetricsLog
from torch_parity import assert_step_matches

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def test_fluid_presets_equal_jax():
    assert [(f.name, f.density, f.viscosity) for f in Fluid.presets()] == \
        [(f.name, f.density, f.viscosity) for f in JFluid.presets()]
    for f in Fluid.presets():
        assert f.reynolds(1.5, 0.4) == JFluid.by_name(f.name).reynolds(1.5,
                                                                       0.4)
    assert Fluid.by_name("water") == Fluid("Water", 1000.0, 0.001)
    with pytest.raises(KeyError):
        Fluid.by_name("honey")


def test_adaptive_dt_controller_equals_jax():
    for cfl, h in ((0.5, 0.05), (0.3, 0.0017)):
        t, j = AdaptiveDtController(cfl, h), JController(cfl, h)
        for dt in (1e-6, 1e-4, 1e-3, 0.05, 0.2):
            for mv in (0.0, 1e-7, 1e-3, 0.5, 1.0, 3.0, 1e4):
                assert t.next_dt(dt, mv) == j.next_dt(dt, mv), (dt, mv)


@pytest.fixture(scope="module")
def sims():
    """A JAX and a port Simulation of the smoothed 0.05 channel with
    dt pinned, each stepped 3 times; the port's steps are held to the JAX
    steps one by one."""
    kw = dict(geometry="channel", cell_size=0.05, adaptive=False, precond=1)
    j, t = JSimulation(**kw), Simulation(device="cpu", **kw)
    assert t.solver.mesh.structured and j.solver.mesh.structured
    rows = []
    for _ in range(3):
        j.run(1)
        t.run(1)
        rows.append((int(j.solver.state.outer_iters),
                     int(t.solver.state.outer_iters)))
        assert_step_matches(j.solver, t.solver, ("app", len(rows)))
    return j, t, rows


def test_simulation_steps_equal_jax(sims):
    j, t, rows = sims
    assert all(jo == to for jo, to in rows)
    assert float(t.solver.params.dt) == pytest.approx(1e-3)
    assert t.mesh.num_cells == j.mesh.num_cells
    np.testing.assert_array_equal(t.mesh.vx, j.mesh.vx)


def test_simulation_forces_equal_jax(sims):
    j, t, _ = sims
    jcd, jcl = j.force_coefficients()
    tcd, tcl = t.force_coefficients()
    assert jcd > 0
    assert abs(tcd - jcd) <= 1e-4 * abs(jcd)
    assert abs(tcl - jcl) <= 1e-4 * abs(jcd)


def test_adaptive_run_lands_the_fresh_max_velocity_on_cpu():
    """On the CPU the reader lands each read at once, so every step's dt is
    the controller's answer to the max|u| just before it."""
    sim = Simulation(geometry="channel", cell_size=0.1, device="cpu")
    for _ in range(3):
        before = float(sim.solver.params.dt)
        mv = float(np.linalg.norm(sim.solver.get_u(), axis=1).max())
        want = sim.controller.next_dt(before, mv)
        sim.run(1)
        assert float(sim.solver.params.dt) == pytest.approx(want, rel=1e-6)


def test_rebuild_changes_the_mesh():
    sim = Simulation(geometry="channel", cell_size=0.1, device="cpu")
    n0 = sim.mesh.num_cells
    assert sim.force_coefficients() is not None
    sim.rebuild(geometry="backstep", cell_size=0.08)
    assert sim.geometry == "backstep" and sim.mesh.num_cells != n0
    assert sim.solver.mesh.num_host_cells == sim.mesh.num_cells
    assert sim.solver.device.type == "cpu"
    assert sim.force_coefficients() is None     # no immersed body


def test_run_scanned_returns_host_metrics():
    sim = Simulation(geometry="channel", cell_size=0.1, device="cpu")
    m = sim.run_scanned(2)
    assert set(m) == {"time", "dt", "max_vel", "outer_iters", "should_stop"}
    assert all(isinstance(v, np.ndarray) and v.shape == (2,)
               for v in m.values())
    assert np.all(np.diff(m["time"]) > 0) and float(m["time"][-1]) == \
        pytest.approx(float(sim.solver.state.time))


def test_entry_points_default_to_cuda():
    """With no device the app runs on CUDA, and raises where there is no
    GPU (before meshing) instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert Simulation(cell_size=0.2).solver.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Simulation(cell_size=0.2)
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--cell-size", "0.2", "--steps", "1"])


def test_cli_runs_on_the_cpu_and_prints_forces_and_profile():
    out = subprocess.run(
        [sys.executable, "-m", "cfd2_tpu_torch.app", "--device", "cpu",
         "--cell-size", "0.1", "--steps", "2", "--forces", "--profile"],
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "layout: structured" in text and "device: cpu" in text
    assert "step 0:" in text and "Cd=" in text and "fgmres=" in text
    launches = json.loads(text.split("kernel launches: ")[1].splitlines()[0])
    assert set(launches) >= {"rbgs_leg", "banded_dot"}
    assert "final state:" in text and "finite=True" in text
    assert "=== Profiling Report ===" in text and "DeviceDispatch:step" in text


def test_cli_scan_prints_final_forces(capsys, tmp_path):
    main(["--device", "cpu", "--cell-size", "0.1", "--steps", "2", "--scan",
          "--forces"])
    text = capsys.readouterr().out
    assert "ran 2 scanned steps" in text and "final Cd=" in text


def test_cli_snapshots_and_html(capsys, tmp_path):
    pytest.importorskip("matplotlib")
    html = tmp_path / "run.html"
    main(["--device", "cpu", "--cell-size", "0.1", "--steps", "2",
          "--snapshot-every", "1", "--out", str(tmp_path), "--html",
          str(html)])
    assert len(list(tmp_path.glob("frame_*.png"))) == 2
    assert b"data:image/png;base64," in html.read_bytes()


def _metrics():
    return [{"time": np.array([0.1, 0.2, 0.3]),
             "outer_iters": np.array([5, 4, 3], np.int32)},
            {"time": np.array([0.4], np.float32),
             "outer_iters": np.array([2], np.int32),
             "linear_residual": np.float32(1e-6)}]


def test_metrics_log_equals_jax(tmp_path):
    j, t = JLog(), MetricsLog()
    for m in _metrics():
        j.append(m)
        t.append({k: torch.as_tensor(v) for k, v in m.items()})
    assert len(t) == len(j) == 4 and t.keys == j.keys
    assert t["outer_iters"].tolist() == [5, 4, 3, 2]
    assert t.summary() == j.summary()
    j.to_jsonl(tmp_path / "j.jsonl")
    t.to_jsonl(tmp_path / "t.jsonl")
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()


def test_solver_run_feeds_metrics_log():
    sim = Simulation(geometry="backstep", cell_size=0.1, device="cpu")
    log = MetricsLog()
    log.append(sim.solver.run(2))
    assert len(log) == 2 and np.isfinite(log["linear_residual"]).all()


def _record(stats, cat):
    stats.enable()
    stats.record_location("solve", cat.DEVICE_DISPATCH, 1.25)
    for _ in range(150):
        stats.record_location("get_u", cat.DEVICE_READ, 0.01, 8)
    stats.record_location("compile", cat.COMPILATION, 0.5, 0)
    stats.increment_iteration()


def test_profiling_report_equals_jax():
    j, t = JStats(), ProfilingStats()
    _record(j, JCat)
    _record(t, ProfileCategory)
    assert t.report() == j.report()
    assert t.suggestions() == j.suggestions() and t.suggestions()
    assert t.category_totals() == pytest.approx(j.category_totals())
    assert [c.value for c in ProfileCategory] == [c.value for c in JCat]


def test_profiling_sessions_and_scopes():
    p = ProfilingStats()
    with p.scope("off", ProfileCategory.OTHER):
        pass
    assert not p.locations
    p.enable()
    with p.session():
        with p.scope("solve", ProfileCategory.DEVICE_DISPATCH):
            pass
        p.increment_iteration()
    rep = p.report()
    for line in ("=== Profiling Report ===", "Session wall-clock:",
                 "-- By category --", "-- Top 15 locations --"):
        assert line in rep
    p.reset()
    assert not p.locations and p.iterations == 0


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    p = ProfilingStats()
    with p.trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "")
               for e in trace["traceEvents"])
