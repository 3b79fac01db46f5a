"""The full-size cases, and the one function that steps any of them.

One table (``CASES``) says how each case is made: its mesh (through
:mod:`.mesh_cache`, so both packages step the very same mesh), its start
(from rest, a structured developed checkpoint, or a developed unstructured
state of :mod:`.make_developed_unstructured`), its configuration
(:func:`settings`) and its steps.  ``chip_smoke.py``, ``profile_step.py
--case`` and ``tests/torch_fullsize_parity.py`` all take their set-up from
here.

* ``delaunay_1m_developed``, ``voronoi_893k_developed``: the developed
  Delaunay (min_cell 0.0019) and Voronoi (0.00143) cases of
  BENCH_SWEEP.jsonl, loaded from the committed states in
  ``cfd2_tpu_torch/data`` with the heal's configuration.
* ``structured_2m_developed``: the cut-cell channel at 0.0012 started from
  ``bench_developed_2m.npz`` as ``bench.py``'s developed leg starts it
  (3 uncounted heal steps; 12 momentum sweeps at this size).
* ``delaunay_403k_rest``, ``refined_132k_rest``: the from-rest Delaunay and
  refined quadtree cases as ``bench_sweep.py`` starts them.

Usage (on the GPU; it raises without one):

    python -m cfd2_tpu_torch.tools.developed_cases delaunay_1m_developed [steps]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

from .make_developed_unstructured import heal_dt
from .mesh_cache import ROOT, get_mesh


@dataclass(frozen=True)
class Case:
    name: str
    mesh_type: str        # cutcell / delaunay / voronoi
    min_cell: float
    start: str            # rest / structured / unstructured
    steps: int            # counted steps
    cells: int            # host cells at full size
    source: str           # where the configuration comes from
    max_cell: float = 0.0
    heal_steps: int = 0   # uncounted steps before the counted ones
    state: str = ""       # developed state, relative to the repo root


CASES = {c.name: c for c in (
    Case("delaunay_1m_developed", "delaunay", 0.0019, "unstructured", 3,
         1_004_266, "BENCH_SWEEP.jsonl rows 23, 25, 36, 37",
         state="cfd2_tpu_torch/data/developed_delaunay_0.0019.npz"),
    Case("voronoi_893k_developed", "voronoi", 0.00143, "unstructured", 2,
         892_916, "BENCH_SWEEP.jsonl rows 38, 39",
         state="cfd2_tpu_torch/data/developed_voronoi_0.00143.npz"),
    Case("structured_2m_developed", "cutcell", 0.0012, "structured", 3,
         1_998_381, "BENCH_SWEEP.jsonl row 21; bench.py's developed leg",
         heal_steps=3, state="bench_developed_2m.npz"),
    Case("delaunay_403k_rest", "delaunay", 0.003, "rest", 3, 403_491,
         "BENCH_SWEEP.jsonl 'delaunay 403k from rest'; bench_sweep.py:19-62"),
    Case("refined_132k_rest", "cutcell", 0.0025, "rest", 3, 132_080,
         "bench_sweep.py:19-62 refined rows at 0.0025/0.005",
         max_cell=0.005),
)}


def case_mesh(case: Case):
    """The case's host mesh, from the shared cache (generated once)."""
    return get_mesh(case.mesh_type, case.min_cell, max_cell=case.max_cell)


def state_path(case: Case) -> Path:
    return ROOT / case.state


def settings(case: Case) -> dict:
    """What the set-up gives the solver before a state is loaded: ``dt``,
    ``viscosity`` / ``density`` (None: the default or the state's),
    ``precond_type``, the ``config`` fields changed, and whether the inlet
    column starts at u = 1.  A developed state then sets u, p, the history
    and (an unstructured one) viscosity, density and time."""
    h = case.min_cell
    if case.start == "rest":
        # bench_sweep.py's from-rest unstructured and refined cases.
        return dict(dt=min(0.002, 0.4 * h), viscosity=None, density=None,
                    precond_type=1, config={}, inlet_column=True)
    if case.start == "structured":
        # bench.py's developed leg: its solver, then the checkpoint.
        return dict(dt=min(0.002, 0.4 * h), viscosity=0.01, density=1.0,
                    precond_type=1, config=dict(fgmres_max_restarts=5),
                    inlet_column=True)
    # The heal's configuration (make_developed_unstructured).
    return dict(dt=heal_dt(h), viscosity=None, density=None, precond_type=1,
                config=dict(fgmres_max_restarts=5, stop_count=10**9),
                inlet_column=False)


def make_solver(case: Case, device=None, mesh=None, state=None):
    """A CoupledSolver on the case's mesh (``mesh``, or the cache's), set up
    and started as the case says; ``state``: another developed state file
    than the case's.  Returns (solver, meta of the loaded state or None)."""
    from ..convert import load_developed_state, load_developed_unstructured
    from ..models.coupled import CoupledSolver
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)   # raises before minutes of meshing
    mesh = case_mesh(case) if mesh is None else mesh
    st = settings(case)
    s = CoupledSolver(mesh, device=device)
    s.set_dt(st["dt"])
    if st["viscosity"] is not None:
        s.set_viscosity(st["viscosity"])
    if st["density"] is not None:
        s.set_density(st["density"])
    s.set_precond_type(st["precond_type"])
    s.config = replace(s.config, **st["config"])
    if st["inlet_column"]:
        u0 = np.zeros((mesh.num_cells, 2))
        u0[mesh.cell_cx < case.min_cell * 2, 0] = 1.0
        s.set_u(u0)
    meta = None
    if case.start == "structured":
        meta = load_developed_state(s, state or state_path(case))
    elif case.start == "unstructured":
        meta = load_developed_unstructured(s, state or state_path(case))
    return s, meta


# What a step of the Euler scheme reads of the state it starts from, in host
# cell order: u and p, and the d_p and grad_p of the last prepare (the
# Rhie-Chow flux reads them before it overwrites them).  Fluxes and the
# velocity gradients are recomputed first; u_old is set to u by the history
# rotation; u_old_old is read only under BDF2.
STEP_INPUT_FIELDS = ("u", "p", "d_p", "grad_p")


def save_step_input(s, path, **meta):
    """Write what the next step of ``s`` reads (``STEP_INPUT_FIELDS`` in
    host order, f32) and, in ``meta``, the state's time and every parameter
    as exact f32 values, beside ``meta``'s own entries."""
    from ..runtime.state import PARAMS_FIELDS
    arrs = {f: s.mesh.to_host_order(getattr(s.state, f)).cpu().numpy()
            .astype(np.float32) for f in STEP_INPUT_FIELDS}
    meta = dict(meta, cells=int(s.host_mesh.num_cells),
                time=float(s.state.time),
                params={f: float(getattr(s.params, f))
                        for f in PARAMS_FIELDS})
    np.savez_compressed(path, meta=json.dumps(meta), **arrs)


def read_step_input(path) -> tuple[dict, dict]:
    """(fields, meta) of a file :func:`save_step_input` wrote."""
    with np.load(path) as d:
        return ({f: d[f] for f in STEP_INPUT_FIELDS},
                json.loads(str(d["meta"])))


def load_step_input(s, path) -> dict:
    """Start ``s`` from a file :func:`save_step_input` wrote: its fields,
    the history set to u, time and parameters as saved.  Returns the
    meta."""
    import torch
    from ..runtime.state import PARAMS_FIELDS
    arrs, meta = read_step_input(path)
    if int(meta["cells"]) != s.host_mesh.num_cells:
        raise ValueError(f"step input of {meta['cells']} cells does not fit "
                         f"a mesh of {s.host_mesh.num_cells}")
    dev = {f: s.mesh.from_host_order(torch.from_numpy(a))
           for f, a in arrs.items()}
    f32 = dict(dtype=torch.float32, device=s.device)
    s.state = replace(s.state, **dev, u_old=dev["u"], u_old_old=dev["u"],
                      prev_u=dev["u"], time=torch.tensor(meta["time"], **f32))
    s.params = replace(s.params, **{f: torch.tensor(meta["params"][f], **f32)
                                    for f in PARAMS_FIELDS})
    return meta


def record_solves():
    """Wrap the solver's per-outer solve to record each one's FGMRES
    iterations; returns (list, restore)."""
    from ..models import coupled
    orig = coupled._assemble_and_solve
    its = []

    def recorded(*a, **k):
        r = orig(*a, **k)
        its.append(int(r.iterations))
        return r

    coupled._assemble_and_solve = recorded
    return its, lambda: setattr(coupled, "_assemble_and_solve", orig)


def run_steps(s, n: int, log=None) -> list:
    """``n`` steps of ``s``; per step a dict of the outers, the FGMRES
    iterations per outer (``its``), max|u| and max|p| (host order) and the
    wall (ending in a device synchronisation)."""
    import torch
    rows = []
    for i in range(n):
        its, restore = record_solves()
        t = time.perf_counter()
        try:
            s.step()
            if s.device.type == "cuda":
                torch.cuda.synchronize(s.device)
        finally:
            restore()
        wall = time.perf_counter() - t
        u, p = s.get_u(), s.get_p()
        row = dict(outers=int(s.state.outer_iters), its=its,
                   linear_iters_total=int(s.state.linear_iters_total),
                   max_u=float(np.abs(u).max()), max_p=float(np.abs(p).max()),
                   finite=bool(np.isfinite(u).all() and np.isfinite(p).all()),
                   wall_s=wall)
        rows.append(row)
        if log is not None:
            log(f"step {i}: {json.dumps(row)}")
        if not row["finite"]:
            raise FloatingPointError(f"non-finite fields after step {i}")
    return rows


def step_case(name: str, steps: int | None = None, device=None, log=None):
    """Set up the case ``name`` on ``device`` (None: CUDA, raising without
    a GPU), run its uncounted heal steps, then ``steps`` counted steps (the
    case's own by default).  Returns the counted steps' rows
    (:func:`run_steps`)."""
    case = CASES[name]
    s, _ = make_solver(case, device=device)
    run_steps(s, case.heal_steps)
    return run_steps(s, case.steps if steps is None else steps, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("steps", nargs="?", type=int, default=None)
    a = ap.parse_args(argv)
    step_case(a.case, a.steps, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
