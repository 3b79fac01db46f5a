"""The port's solver tools (``cfd2_tpu_torch/tools/``: ``probe_cavity``,
``iters_1m``, ``prof_step_iters``, ``prof_precond``, ``prof_amg_variants``,
``bf16_smoke``, ``stiff_water_x64``, ``live_demo_1m``) against the JAX
package's same computations (``tools/``) on the CPU at small sizes: the
cavity at h 1/16, the per-outer ladders of one host-mode step from rest on
the 4,636-cell cut-cell and 5,843-cell Delaunay channels, the water step
with float64 norms at h 0.05, the live demo's sequence, and the tools'
output paths and device rule.  ``prof_precond`` and
``bf16_smoke`` are held in ``tests/test_torch_tools_precond.py``,
``prof_amg_variants`` in ``tests/test_torch_tools_amg.py``.

Tolerances: the Ghia error within 1e-4 of the JAX package's; ladders and
water-step outers equal; max|u| of the water step within 1e-5 (relative)
of the JAX package's under ``jax_enable_x64`` (its tool's setting, run in
a process of its own: x64 is process-wide)."""

import contextlib
import io
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU: tests/conftest.py)

import torch_fullsize_parity as fp
from cfd2_tpu.mesh import ChannelWithObstacle as JChannel
from cfd2_tpu.mesh import RectangularChannel as JRect
from cfd2_tpu.mesh import generate_cut_cell_mesh as j_cutcell
from cfd2_tpu.mesh import retag_lid_cavity as j_retag
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu.models.coupled import step_host as j_step_host
from cfd2_tpu_torch.tools import (bf16_smoke, iters_1m, live_demo_1m,
                                  probe_bf16, probe_cavity, probes,
                                  prof_banded, prof_banded2, prof_developed,
                                  prof_fgmres, prof_fgmres_loop, prof_layout,
                                  prof_outer, prof_refined_developed,
                                  prof_step_iters, prof_trace,
                                  stiff_water_x64)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
quiet = lambda m: None


def _jax_tool_solver(mesh, size, **config):
    """The JAX tool's solver set-up (tools/iters_1m.py:14-21): dt,
    viscosity, precond_type=1, the config overrides, the inlet column at
    1 (density 1, the default)."""
    s = JSolver(mesh)
    s.set_dt(min(0.002, 0.4 * size))
    s.set_viscosity(0.01)
    s.set_density(1.0)
    s.set_precond_type(1)
    s.config = replace(s.config, **config)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 2 * size, 0] = 1.0
    s.set_u(u0)
    return s


def _jax_channel(size):
    return j_cutcell(JChannel(3.0, 1.0, (1.0, 0.5), 0.2), size, size, 1.2,
                     (3.0, 1.0))


def _captured(fn) -> list:
    """The lines ``fn()`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def test_probe_cavity_matches_jax():
    """tools/probe_cavity.py at h 1/16, dt 0.25, 10 steps (its lines
    30-58, which run at import there)."""
    h, dt, steps = 1.0 / 16, 0.25, 10
    got = probe_cavity.run(h, dt, steps, device="cpu", log=quiet)
    mesh = j_cutcell(JRect(length=1.0, height=1.0), h, h, 1.2, (1.0, 1.0))
    j_retag(mesh, (1.0, 1.0))
    s = JSolver(mesh)
    s.set_viscosity(0.01)
    s.set_density(1.0)
    s.set_inlet_velocity(1.0)
    s.set_ramp_time(0.0)
    s.set_dt(dt)
    for _ in range(steps):
        s.step()
        assert not s.should_stop
    ref = np.abs(probe_cavity.centreline(mesh, s.get_u(), h)
                 - probe_cavity.GHIA_U).max()
    assert got["cells"] == mesh.num_cells and got["steps"] == steps
    assert np.isfinite(got["ui"]).all()
    assert abs(got["max_err"] - ref) <= 1e-4, (got["max_err"], ref)


def test_iters_1m_ladder_matches_jax(monkeypatch):
    """tools/iters_1m.py at IT_CELL 0.025 (4,636 cells), one step."""
    for k in ("IT_CELL", "IT_STEPS", "IT_EXTRAP", "IT_INCYCLE"):
        monkeypatch.delenv(k, raising=False)
    got = iters_1m.run(cell=0.025, steps=1, device="cpu", log=quiet)
    mesh = _jax_channel(0.025)
    assert mesh.num_cells == 4636
    s = _jax_tool_solver(mesh, 0.025, fgmres_max_restarts=5,
                         extrapolate_guess=False, fgmres_incycle_window=0)

    def one():
        s.state = j_step_host(s.mesh, s.state, s.params, s.config,
                              s._get_amg(), verbose=True)
    ref = probes.ladder(_captured(one))
    assert got == [ref] and sum(ref) > 0


def test_prof_step_iters_ladder_matches_jax(monkeypatch):
    """tools/prof_step_iters.py itself (its ``main``) on the 5,843-cell
    Delaunay channel, one step, against the port's tool."""
    for k in ("CFD2_CHEB", "CFD2_OC", "CFD2_MS", "CFD2_RESTART",
              "CFD2_AGGP", "CFD2_VCYCLES", "CFD2_MAXCELL"):
        monkeypatch.delenv(k, raising=False)
    lines = []
    got = prof_step_iters.run(0.025, "delaunay", 1, device="cpu",
                              log=lines.append)
    assert "5843 cells" in lines[0]
    tool = fp._jax_tool("prof_step_iters")
    monkeypatch.setattr(sys, "argv", ["prof_step_iters.py", "0.025",
                                      "delaunay", "1"])
    out = _captured(tool.main)
    assert "5843 cells" in out[0]
    assert got == [probes.ladder(out)] and sum(got[0]) > 0


_X64 = r"""
import json, sys
from dataclasses import replace
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import numpy as np
from cfd2_tpu.mesh import BackwardsStep, generate_cut_cell_mesh
from cfd2_tpu.models.coupled import CoupledSolver
h, steps = float(sys.argv[1]), int(sys.argv[2])
# tools/stiff_water_x64.py:60-91, without its write of STIFF_X64.json.
geo = BackwardsStep(length=3.5, height_inlet=0.5, height_outlet=1.0,
                    step_x=0.5)
mesh = generate_cut_cell_mesh(geo, h, h, 1.2, (3.5, 1.0))
mesh.smooth(geo, 0.3, 50)
s = CoupledSolver(mesh)
s.config = replace(s.config, fgmres_f64_norms=True)
s.set_dt(0.001)
s.set_density(1000.0)
s.set_viscosity(0.001)
s.set_alpha_u(0.7)
s.set_alpha_p(0.3)
s.set_precond_type(1)
s.set_u(np.full((mesh.num_cells, 2), [0.1, 0.0]))
outers = []
for i in range(steps):
    s.step()
    outers.append(int(s.state.outer_iters))
u = s.get_u()
print(json.dumps({"cells": int(mesh.num_cells), "outers": outers,
                  "max_vel": float(np.linalg.norm(u, axis=1).max())}))
"""


def test_stiff_water_x64_matches_jax(tmp_path):
    """The water step with float64 norms at h 0.05, 3 steps: the port's
    tool against the JAX tool's computation under jax_enable_x64."""
    h, steps = 0.05, 3
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _X64, str(h), str(steps)],
                            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    rec = stiff_water_x64.run(h, steps, device="cpu",
                              out=tmp_path / "x64.json", log=quiet)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    ref = json.loads(out.strip().splitlines()[-1])
    assert rec["f64_norms_active"] and rec["finite"]
    assert json.loads((tmp_path / "x64.json").read_text())["steps"] == steps
    assert rec["cells"] == ref["cells"]
    assert [r["outers"] for r in rec["per_step"]] == ref["outers"]
    assert abs(rec["max_vel"] - ref["max_vel"]) <= 1e-5 * ref["max_vel"]


def test_live_demo_steps_and_takes_the_control(tmp_path):
    """tools/live_demo_1m.py's sequence on a 0.1 channel: 3 steps, the
    frame (matplotlib imports here) and ``control?inlet=1.2`` read back
    from the solver's params."""
    out = tmp_path / "frame.png"
    res = live_demo_1m.run(cell=0.1, device="cpu", out=out, wait=120,
                           log=quiet)
    assert res["steps"] >= 3 and res["inlet"] == pytest.approx(1.2)
    assert out.read_bytes()[:4] == b"\x89PNG"
    assert res["frame_bytes"] == out.stat().st_size


def test_tools_write_no_jax_tools_path():
    """No port tool writes a path its JAX counterpart writes: the water
    record is the port's own, and the live demo writes only where
    ``--out`` says (the JAX tool writes docs/live_1m_frame.png)."""
    assert "STIFF_X64.json" in (ROOT / "tools" / "stiff_water_x64.py"
                                ).read_text()
    assert stiff_water_x64.OUT.name == "stiff_water_x64_card.json"
    assert stiff_water_x64.OUT.resolve() != (ROOT / "STIFF_X64.json"
                                             ).resolve()
    src = (ROOT / "cfd2_tpu_torch" / "tools" / "live_demo_1m.py").read_text()
    assert "live_1m_frame" not in src and '"docs"' not in src


PROFILING_TOOLS = (prof_developed, prof_outer, prof_banded2, prof_banded,
                   prof_refined_developed, prof_fgmres, prof_fgmres_loop,
                   prof_trace, prof_layout, probe_bf16)


@pytest.mark.parametrize("tool", PROFILING_TOOLS,
                         ids=[t.__name__.rsplit(".", 1)[1]
                              for t in PROFILING_TOOLS])
def test_profiling_tools_write_no_jax_tools_path(tool):
    """The profiling tools write no file but ``prof_trace``'s trace, which
    goes to the port's own directory (``runtime/profiling.trace``'s
    ``cfd2_tpu_torch_trace`` under the temporary directory, or where the
    caller says), never the JAX tool's ``/tmp/cfd2_trace``."""
    import inspect
    import tempfile

    from cfd2_tpu_torch.runtime import profiling
    src = inspect.getsource(tool)
    for call in ("np.save", "savez", "write_text", "write_bytes",
                 "json.dump", "open("):
        assert call not in src, (tool.__name__, call)
    if tool is prof_trace:
        assert inspect.signature(tool.run).parameters["logdir"].default \
            is None
        assert "cfd2_tpu_torch_trace" in inspect.getsource(
            profiling.ProfilingStats.trace)
        assert not str(tempfile.gettempdir()).endswith("cfd2_trace")


@pytest.mark.parametrize("tool", [
    lambda: probe_cavity.run(0.25, 0.25, 1, log=quiet),
    lambda: iters_1m.run(cell=0.1, steps=1, log=quiet),
    lambda: prof_step_iters.run(0.1, "cutcell", 1, log=quiet),
    lambda: bf16_smoke.run(size=0.1, timed=1, log=quiet),
    lambda: stiff_water_x64.run(0.1, 1, out=None, log=quiet),
    lambda: live_demo_1m.run(cell=0.1, wait=1, log=quiet),
    lambda: prof_developed.run(min_cell=0.1, log=quiet),
    lambda: prof_outer.run(0.1, 0, log=quiet),
    lambda: prof_banded2.run(0.1, log=quiet),
    lambda: prof_banded.run(0.1, log=quiet),
    lambda: prof_refined_developed.run("delaunay", 0.1, 0.0, log=quiet),
    lambda: prof_fgmres.run(0.1, log=quiet),
    lambda: prof_fgmres_loop.run(4, 6, log=quiet),
    lambda: prof_trace.run(0.1, 1, log=quiet),
    lambda: prof_layout.run(4, 6, log=quiet),
    lambda: probe_bf16.run(4, 6, log=quiet),
], ids=["probe_cavity", "iters_1m", "prof_step_iters", "bf16_smoke",
        "stiff_water_x64", "live_demo_1m", "prof_developed", "prof_outer",
        "prof_banded2", "prof_banded", "prof_refined_developed",
        "prof_fgmres", "prof_fgmres_loop", "prof_trace", "prof_layout",
        "probe_bf16"])
def test_tools_need_the_card_unless_told_cpu(monkeypatch, tool):
    """Each tool runs on the card unless ``device="cpu"`` is given, and
    raises where there is no GPU rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool()
