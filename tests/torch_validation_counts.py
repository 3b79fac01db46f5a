"""The physics-validation cases stepped by the JAX package (and by the
port's plain path) on the CPU at full size; the per-step counts go to
``cfd2_tpu_torch/data/validation_counts.json``, which ``chip_smoke.py``
phase 14 holds the card's steps to.

    JAX_PLATFORMS=cpu python tests/torch_validation_counts.py CASE \\
        [--package jax|port] [--threads T]

Cases:

* ``turek_window``: Schäfer–Turek 2D-2 at h = 0.005 (35,804 cells), 3 steps
  from the state the card's full run saved at the start of its measurement
  window (``cfd2_tpu_torch/data/turek_window_0.005.npz``, written by
  ``developed_cases.save_step_input``: u, p, d_p and grad_p in host order,
  the time and every parameter).  The JAX solver is configured as
  ``tools/validate_turek.py`` configures it (the parabolic inlet, BDF2,
  scheme 1, ``precond_type=1``, ``dt_old`` pinned to dt) and loaded as
  ``tests/torch_fullsize_parity.py`` loads a saved state; the port's as
  ``cfd2_tpu_torch/tools/validate_turek.py`` configures it.
* ``stiff_water``: the water backwards step of ``tools/stiff_water_tpu.py``
  (h = 0.01, smoothed: 32,500 cells), steps 0-2 from its start.
* ``strouhal_cut``: the Strouhal measurement cut as ``chip_smoke.py``
  phase 14(e) cuts it: ``bench_developed_1m.npz`` restricted onto the 0.0068
  mesh (62,814 cells), 20 heal steps and one force batch of 10 adaptive
  steps (``tools/measure_strouhal.py``'s loop, with the JAX tool's own
  ``make_solver`` and ``prolong_into``; the port through
  ``cfd2_tpu_torch/tools/measure_strouhal.run``).  The record holds that
  one sample's Cd and the time it was read at.

Per case and package the record holds the outers per step, the FGMRES
iterations per outer, max|u| and max|p| after each step, the command and
the versions.  Each step is written as soon as it ends.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
RECORD = ROOT / "cfd2_tpu_torch" / "data" / "validation_counts.json"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch_fullsize_parity as fp  # noqa: E402
from cfd2_tpu_torch.tools import developed_cases as dc  # noqa: E402
from cfd2_tpu_torch.tools import stiff_water as sw  # noqa: E402
from cfd2_tpu_torch.tools import validate_turek as vt  # noqa: E402

TUREK_H = 0.005
TUREK_STATE = ROOT / "cfd2_tpu_torch" / "data" / f"turek_window_{TUREK_H}.npz"
STEPS = {"turek_window": 3, "stiff_water": 3, "strouhal_cut": 0}
STROUHAL_CKPT = ROOT / "bench_developed_1m.npz"
STROUHAL_HEAL = 20


def jax_turek_solver(mesh, h=TUREK_H):
    """A JAX CoupledSolver configured as ``tools/validate_turek.py``
    configures it, at cell size ``h``."""
    from cfd2_tpu.models.coupled import CoupledSolver
    from cfd2_tpu.runtime.state import TIME_BDF2
    s = CoupledSolver(mesh)
    s.set_viscosity(vt.NU)
    s.set_density(1.0)
    s.set_inlet_velocity(vt.U_BAR)
    s.set_inlet_profile(vt.inlet_profile)
    s.set_ramp_time(vt.RAMP)
    s.set_scheme(1)
    s.set_time_scheme(TIME_BDF2)
    s.set_precond_type(1)
    s.set_dt(h / 6.0)
    s.params = replace(s.params, dt_old=s.params.dt)
    return s


def jax_turek_mesh(h):
    from cfd2_tpu.mesh import ChannelWithObstacle, generate_cut_cell_mesh
    geo = ChannelWithObstacle(length=vt.L, height=vt.H,
                              obstacle_center=vt.CENTER,
                              obstacle_radius=vt.D / 2.0)
    return generate_cut_cell_mesh(geo, h, h, 1.2, (vt.L, vt.H))


def jax_water_solver(h=0.01):
    """A JAX CoupledSolver as ``tools/stiff_water_tpu.py`` sets it up."""
    from cfd2_tpu.mesh import BackwardsStep, generate_cut_cell_mesh
    from cfd2_tpu.models.coupled import CoupledSolver
    geo = BackwardsStep(length=3.5, height_inlet=0.5, height_outlet=1.0,
                        step_x=0.5)
    mesh = generate_cut_cell_mesh(geo, h, h, 1.2, (3.5, 1.0))
    mesh.smooth(geo, 0.3, 50)
    s = CoupledSolver(mesh)
    s.set_dt(0.001)
    s.set_density(1000.0)
    s.set_viscosity(0.001)
    s.set_alpha_u(0.7)
    s.set_alpha_p(0.3)
    s.set_precond_type(1)
    s.set_u(np.full((mesh.num_cells, 2), [0.1, 0.0]))
    return s


def port_solver(case: str, device="cpu"):
    """The port's solver of ``case``, set up as its tool sets it up (the
    Turek one loaded from the window state)."""
    if case == "turek_window":
        s = vt.make_solver(vt.make_mesh(TUREK_H), TUREK_H, device=device)
        dc.load_step_input(s, TUREK_STATE)
        return s
    return sw.make_solver(sw.make_mesh(0.01), device)


def jax_solver(case: str):
    if case == "turek_window":
        s = jax_turek_solver(jax_turek_mesh(TUREK_H), TUREK_H)
        fp.jax_load_step_input(s, TUREK_STATE)
        return s
    return jax_water_solver()


def strouhal_cut(package: str) -> dict:
    """The one force sample of the cut Strouhal measurement: Cd and the
    time after ``STROUHAL_HEAL`` heal steps and one batch."""
    from cfd2_tpu_torch.tools import measure_strouhal as ms
    if package == "port":
        out = ms.run(STROUHAL_CKPT, heal_steps=STROUHAL_HEAL, t_span=1e-9,
                     device="cpu", log=lambda m: print(m, flush=True))
        return dict(Cd=out["Cd_mean"], samples=out["samples"],
                    cells=out["cells"])
    from cfd2_tpu.models.coupled import multi_step_adaptive
    from cfd2_tpu.utils.forces import force_coefficients, obstacle_face_mask
    jtool = fp._jax_tool("make_developed")
    with np.load(STROUHAL_CKPT) as d:
        meta = json.loads(str(d["meta"]))
        u_c, p_c = d["u"].astype(np.float32), d["p"].astype(np.float32)
        h_c = float(d["h"])
    s = jtool.make_solver(ms.SIZE)
    s.set_viscosity(meta["viscosity"])
    jtool.prolong_into(s, u_c, p_c, h_c)
    w = obstacle_face_mask(s.mesh)
    for n in (STROUHAL_HEAL, ms.BATCH):
        s.state, s.params, _ = multi_step_adaptive(
            s.mesh, s.state, s.params, s.config, n, target_cfl=0.4,
            min_cell_size=ms.SIZE, amg=s._get_amg())
    cd, cl = force_coefficients(s.mesh, s.state, s.params, w, u_ref=1.0,
                                d_ref=0.4)
    return dict(Cd=float(cd), Cl=float(cl), time=float(s.state.time),
                samples=1, cells=int(s.mesh.num_host_cells))


def load_record() -> dict:
    if RECORD.exists():
        return json.loads(RECORD.read_text())
    return {"cases": {}}


def save_entry(case: str, key: str, entry: dict):
    rec = load_record()
    rec["cases"].setdefault(case, {})[key] = entry
    tmp = RECORD.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(rec, indent=1) + "\n")
    os.replace(tmp, RECORD)


def run(case: str, package: str) -> dict:
    import torch
    key = "jax" if package == "jax" else "port_cpu"
    cmd = ["python", "tests/torch_validation_counts.py"] + sys.argv[1:]
    entry = dict(command=" ".join(cmd),
                 torch=torch.__version__, numpy=np.__version__,
                 python=platform.python_version(),
                 host=f"{platform.machine()}, {os.cpu_count()} CPUs",
                 torch_threads=torch.get_num_threads(), steps=[],
                 complete=False)
    if case == "turek_window":
        _, meta = dc.read_step_input(TUREK_STATE)
        entry.update(state=os.path.relpath(TUREK_STATE, ROOT),
                     state_source=meta.get("source"),
                     state_card=meta.get("card"), from_step=meta.get("step"))
    t0 = time.time()
    n = STEPS[case]
    if case == "strouhal_cut":
        entry.update(checkpoint=os.path.relpath(STROUHAL_CKPT, ROOT),
                     heal_steps=STROUHAL_HEAL, **strouhal_cut(package))
        entry.update(complete=True, wall_s=time.time() - t0)
        save_entry(case, key, entry)
        print(f"{case} / {key}: {json.dumps(entry)}", flush=True)
        return entry

    def on_step(rows):
        entry["steps"] = rows
        entry["wall_s"] = time.time() - t0
        save_entry(case, key, entry)
        print(f"{case} / {key}: step {len(rows) - 1}: "
              f"{json.dumps(rows[-1])}", flush=True)

    if package == "jax":
        import jax
        entry.update(jax=jax.__version__, jax_backend=jax.default_backend())
        s = jax_solver(case)
        entry["cells"] = int(s.mesh.grid_of_cell.shape[0])
        entry["setup_s"] = time.time() - t0
        fp.jax_steps(s, n, on_step)
    else:
        s = port_solver(case)
        entry["cells"] = int(s.host_mesh.num_cells)
        entry["setup_s"] = time.time() - t0
        rows = []
        for _ in range(n):
            rows += dc.run_steps(s, 1)
            on_step(rows)
    entry.update(complete=True, wall_s=time.time() - t0)
    save_entry(case, key, entry)
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=sorted(STEPS))
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch threads of the port's run")
    a = ap.parse_args(argv)
    if a.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
    import torch
    if a.threads:
        torch.set_num_threads(a.threads)
    run(a.case, a.package)
    return 0


if __name__ == "__main__":
    sys.exit(main())
