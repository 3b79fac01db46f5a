"""The full-size cases of ``cfd2_tpu_torch/tools/developed_cases.py`` stepped
by the JAX package and by the port's plain path, both on the CPU, from the
same mesh cache and the same state; the counts go to
``cfd2_tpu_torch/data/fullsize_counts.json``.

    JAX_PLATFORMS=cpu python tests/torch_fullsize_parity.py CASE \\
        [--package jax|port] [--threads T] [--force] [--from-state PATH]

One case and one package per call: at these sizes a step takes the JAX
package minutes to hours on a CPU.  Each step is written to the record as
soon as it ends (``complete`` false until the last), so a cut run keeps the
steps it finished; a call for a (case, package) whose record is complete
does nothing unless ``--force`` is given, and one whose record is not
complete starts the case again.  Per case and package the record holds the
outers per step, the FGMRES iterations per outer, max|u| and max|p| after
each step, the command, the jax and torch versions and the walls.
``chip_smoke.py`` phase 13 reads the record (a JSON file, no JAX import).

``--from-state PATH`` starts both packages from a state another run saved
at the start of one of the case's steps (``developed_cases.save_step_input``:
u, p, d_p and grad_p in host order, the time and the parameters) and takes
that one step; it is recorded under ``<package>_from_card_step<N>`` (the
card wrote the states committed so far).  Both packages then step the very
same input, so a difference in the counts is the step's own and not
roundoff carried in from earlier steps.  ``--perturb-ulp SEED`` adds one
ulp to both components of u in a seeded 1% of the cells before that step
(recorded under ``<package>_from_card_step<N>_ulp<SEED>``): how far the
step's counts move under roundoff alone.

Both packages load the mesh through their own ``mesh_cache.load_mesh`` from
``.bench_cache`` (generated by the port's ``get_mesh`` when missing).  The
JAX solver is set up from the port's ``settings(case)``; a developed state
is loaded as the JAX package's ``bench.py`` (structured) and
``tools/make_developed_unstructured.py`` (unstructured) leave it.  The
JAX package's per-outer FGMRES iterations are read by a host callback on
its per-outer solve, which leaves the step's arithmetic as it is.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import platform
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
RECORD = ROOT / "cfd2_tpu_torch" / "data" / "fullsize_counts.json"
sys.path.insert(0, str(ROOT))

from cfd2_tpu_torch.tools import developed_cases as dc  # noqa: E402
from cfd2_tpu_torch.tools import mesh_cache  # noqa: E402


def _jax_tool(name: str):
    """A module of the JAX package's ``tools/`` by file path (they are
    scripts, not a package); the ``sys.path`` and environment entries its
    top level sets are taken back."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    path, env = list(sys.path), dict(os.environ)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        os.environ.clear()
        os.environ.update(env)
    return mod


def jax_mesh(case: dc.Case):
    """The case's mesh as the JAX package's Mesh, from the shared cache."""
    dc.case_mesh(case)   # generate and cache it, when missing
    path = mesh_cache.mesh_path(case.mesh_type, case.min_cell,
                                max_cell=case.max_cell)
    return _jax_tool("mesh_cache").load_mesh(path)


def jax_load_structured(s, path) -> dict:
    """A structured developed checkpoint into a JAX solver, as ``bench.py``
    loads it: u and p masked to the fluid cells, the history set to u, the
    viscosity from the meta."""
    import jax.numpy as jnp
    with np.load(path) as d:
        meta = json.loads(str(d["meta"]))
        u = d["u"].astype(np.float32)
        p = d["p"].astype(np.float32)
    if tuple(meta["grid"]) != tuple(s.mesh.grid_shape):
        raise ValueError(f"checkpoint grid {meta['grid']} != mesh grid "
                         f"{s.mesh.grid_shape}")
    ny, nx = s.mesh.grid_shape
    valid = s.mesh.c_valid
    u = jnp.asarray(u.reshape(ny * nx, 2)) * valid[:, None]
    p = jnp.asarray(p.reshape(ny * nx)) * valid
    s.state = replace(s.state, u=u, u_old=u, u_old_old=u, prev_u=u, p=p)
    s.set_viscosity(meta["viscosity"])
    return meta


def jax_load_unstructured(s, path) -> dict:
    """A developed unstructured state (host order) into a JAX solver: u and
    p, ``initialize_history``, viscosity and density from the meta, and the
    heal's end time."""
    import jax.numpy as jnp
    with np.load(path) as d:
        meta = json.loads(str(d["meta"]))
        u = d["u"].astype(np.float32)
        p = d["p"].astype(np.float32)
    s.set_u(u)
    s.set_p(p)
    s.initialize_history()
    s.set_viscosity(meta["viscosity"])
    s.set_density(meta.get("density", 1.0))
    s.state = replace(s.state, time=jnp.asarray(meta["solver_time"],
                                                jnp.float32))
    return meta


def perturb_u(u: np.ndarray, seed: int) -> np.ndarray:
    """``u`` (host order, (n, 2) f32) with both components moved up by one
    ulp in a seeded 1% of the cells."""
    u = np.array(u, np.float32)
    rng = np.random.default_rng(seed)
    cells = rng.choice(u.shape[0], size=max(1, u.shape[0] // 100),
                       replace=False)
    u[cells] = np.nextafter(u[cells], np.float32(np.inf))
    return u


def jax_load_step_input(s, path, perturb=None) -> dict:
    """A state ``developed_cases.save_step_input`` wrote into a JAX solver,
    as ``developed_cases.load_step_input`` loads it into the port's: its
    fields, the history set to u, the time and every parameter;
    ``perturb``: a seed for :func:`perturb_u`."""
    import jax.numpy as jnp
    arrs, meta = dc.read_step_input(path)
    if perturb is not None:
        arrs["u"] = perturb_u(arrs["u"], perturb)
    n = int(s.mesh.grid_of_cell.shape[0])
    if int(meta["cells"]) != n:
        raise ValueError(f"step input of {meta['cells']} cells does not fit "
                         f"a mesh of {n}")
    dev = {f: s.mesh.from_host_order(jnp.asarray(a)) for f, a in arrs.items()}
    s.state = replace(s.state, **dev, u_old=dev["u"], u_old_old=dev["u"],
                      prev_u=dev["u"],
                      time=jnp.asarray(meta["time"], jnp.float32))
    s.params = replace(s.params, **{f: jnp.asarray(v, jnp.float32)
                                    for f, v in meta["params"].items()})
    return meta


def jax_solver(case: dc.Case, mesh, state=None):
    """A JAX CoupledSolver set up and started as ``make_solver`` sets up
    the port's."""
    from cfd2_tpu.models.coupled import CoupledSolver
    st = dc.settings(case)
    s = CoupledSolver(mesh)
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
    path = state or dc.state_path(case)
    if case.start == "structured":
        jax_load_structured(s, path)
    elif case.start == "unstructured":
        jax_load_unstructured(s, path)
    return s


_JAX_ITS: list = []


def record_jax_outers():
    """Make the JAX package's per-outer solve report its FGMRES iterations
    to ``_JAX_ITS`` through a host callback (installed once, before the
    first step is traced)."""
    import jax
    from cfd2_tpu.models import coupled
    if getattr(coupled._assemble_and_solve, "_records", False):
        return _JAX_ITS
    orig = coupled._assemble_and_solve

    def recorded(*a, **k):
        r = orig(*a, **k)
        jax.debug.callback(lambda it: _JAX_ITS.append(int(it)),
                           r.iterations)
        return r

    recorded._records = True
    coupled._assemble_and_solve = recorded
    return _JAX_ITS


def jax_steps(s, n: int, on_step=None) -> list:
    """``n`` fused steps of a JAX solver, rows as ``run_steps`` gives them
    for the port."""
    import jax
    its = record_jax_outers()
    rows = []
    for i in range(n):
        its.clear()
        t = time.perf_counter()
        s.step()
        jax.block_until_ready(s.state.u)
        wall = time.perf_counter() - t
        jax.effects_barrier()
        u, p = s.get_u(), s.get_p()
        row = dict(outers=int(s.state.outer_iters), its=list(its),
                   linear_iters_total=int(s.state.linear_iters_total),
                   max_u=float(np.abs(u).max()), max_p=float(np.abs(p).max()),
                   finite=bool(np.isfinite(u).all() and np.isfinite(p).all()),
                   wall_s=wall)
        assert sum(row["its"]) == row["linear_iters_total"] \
            and len(row["its"]) == row["outers"], row
        rows.append(row)
        if on_step is not None:
            on_step(rows)
    return rows


def load_record() -> dict:
    if RECORD.exists():
        return json.loads(RECORD.read_text())
    return {"cases": {}}


def save_entry(case: str, package: str, entry: dict):
    """Write one (case, package) entry into the record (re-read first, so
    concurrent calls for other entries are kept)."""
    rec = load_record()
    rec["cases"].setdefault(case, {})[package] = entry
    tmp = RECORD.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(rec, indent=1) + "\n")
    os.replace(tmp, RECORD)


def _entry(case: dc.Case) -> dict:
    """A record entry's provenance: the command, versions, host, threads."""
    import torch
    return dict(command=" ".join(["python", "tests/torch_fullsize_parity.py"]
                                 + sys.argv[1:]),
                torch=torch.__version__, numpy=np.__version__,
                python=platform.python_version(),
                host=f"{platform.machine()}, {os.cpu_count()} CPUs",
                cpus_allowed=len(os.sched_getaffinity(0)),
                torch_threads=torch.get_num_threads(), cells=case.cells,
                steps=[], complete=False)


def run(case_name: str, package: str, force: bool, from_state=None,
        perturb=None):
    case = dc.CASES[case_name]
    key = "jax" if package == "jax" else "port_cpu"
    if from_state is not None:
        return run_from_state(case, key, force, from_state, perturb)
    old = load_record()["cases"].get(case_name, {}).get(key)
    if old and old.get("complete") and not force:
        print(f"{case_name} / {package}: complete in the record; --force "
              "runs it again", flush=True)
        return old
    n = case.steps
    entry = dict(_entry(case), heal_steps=case.heal_steps)
    t0 = time.time()
    if package == "jax":
        import jax
        entry["jax"] = jax.__version__
        entry["jax_backend"] = jax.default_backend()
        mesh = jax_mesh(case)
        s = jax_solver(case, mesh)
        entry["setup_s"] = time.time() - t0
        print(f"{case_name} / jax: {mesh.num_cells} cells, set-up "
              f"{entry['setup_s']:.1f} s", flush=True)
        heal = jax_steps(s, case.heal_steps)
        entry["heal"] = heal

        def on_step(rows):
            entry["steps"] = rows
            entry["wall_s"] = time.time() - t0
            save_entry(case_name, key, entry)
            print(f"{case_name} / jax: step {len(rows) - 1}: "
                  f"{json.dumps(rows[-1])}", flush=True)

        jax_steps(s, n, on_step)
    else:
        mesh = dc.case_mesh(case)
        s, _ = dc.make_solver(case, device="cpu", mesh=mesh)
        entry["setup_s"] = time.time() - t0
        print(f"{case_name} / port: {mesh.num_cells} cells, set-up "
              f"{entry['setup_s']:.1f} s", flush=True)
        entry["heal"] = dc.run_steps(s, case.heal_steps)
        rows = []
        for i in range(n):
            rows += dc.run_steps(s, 1)
            entry["steps"] = rows
            entry["wall_s"] = time.time() - t0
            save_entry(case_name, key, entry)
            print(f"{case_name} / port: step {i}: {json.dumps(rows[-1])}",
                  flush=True)
    entry["complete"] = True
    entry["wall_s"] = time.time() - t0
    save_entry(case_name, key, entry)
    return entry


def run_from_state(case: dc.Case, key: str, force: bool, path,
                   perturb=None) -> dict:
    """One step of ``case`` from the saved state ``path``, recorded under
    ``<key>_from_card_step<N>`` (``_ulp<SEED>`` after it when u is
    perturbed by :func:`perturb_u`)."""
    path = Path(path)
    _, meta = dc.read_step_input(path)
    name = f"{key}_from_card_step{meta['step']}"
    if perturb is not None:
        name += f"_ulp{perturb}"
    old = load_record()["cases"].get(case.name, {}).get(name)
    if old and old.get("complete") and not force:
        print(f"{case.name} / {name}: complete in the record; --force runs "
              "it again", flush=True)
        return old
    entry = _entry(case)
    entry.update(state=os.path.relpath(path, ROOT), from_step=meta["step"],
                 state_source=meta.get("source"), state_card=meta.get("card"),
                 perturb_ulp_seed=perturb)
    t0 = time.time()
    if key == "jax":
        import jax
        entry["jax"] = jax.__version__
        entry["jax_backend"] = jax.default_backend()
        s = jax_solver(case, jax_mesh(case))
        jax_load_step_input(s, path, perturb)
        entry["setup_s"] = time.time() - t0
        rows = jax_steps(s, 1)
    else:
        s, _ = dc.make_solver(case, device="cpu")
        dc.load_step_input(s, path)
        if perturb is not None:
            s.set_u(perturb_u(s.get_u(), perturb))   # history = u too
        entry["setup_s"] = time.time() - t0
        rows = dc.run_steps(s, 1)
    entry.update(steps=rows, complete=True, wall_s=time.time() - t0)
    save_entry(case.name, name, entry)
    print(f"{case.name} / {name}: {json.dumps(rows[-1])}", flush=True)
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=sorted(dc.CASES))
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch threads of the port's run")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--from-state", metavar="PATH", default=None,
                    help="one step from a state save_step_input wrote")
    ap.add_argument("--perturb-ulp", metavar="SEED", type=int, default=None,
                    help="with --from-state: u one ulp up in a seeded 1%% "
                         "of the cells")
    a = ap.parse_args(argv)
    if a.perturb_ulp is not None and a.from_state is None:
        ap.error("--perturb-ulp needs --from-state")
    if a.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
    import torch
    if a.threads:
        torch.set_num_threads(a.threads)
    run(a.case, a.package, a.force, a.from_state, a.perturb_ulp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
