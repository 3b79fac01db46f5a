"""Set-up shared by the sharded option tests (tests/test_torch_spatial_bf16.py,
test_torch_spatial_krylov.py, test_torch_spatial_precond.py): the 0.05
channel of tests/test_structured.py:118-139 encoded with ``pad_rows_to=8``
(a 24 x 60 grid: blocks of 12, 6 and 3 rows over 2, 4 and 8 ranks), the
inlet-column start, dt 0.01, and each option run three ways from it:

* the JAX package's step on ``shard_mesh`` / ``shard_state`` over the
  suite's 8 virtual CPU devices (tests/conftest.py), the structured
  hierarchy placed by ``shard_cellwise``;
* the port's step in one process;
* the port's step row-sharded over the first 2, 4 and 8 of 8 gloo ranks on
  the CPU, all in one spawned group (tests/torch_spatial_ranks.py).

A run is ``tests/torch_spatial_ranks.option_run``'s keywords: ``config``
(SolverConfig overrides), ``steps``, ``pallas`` (CFD2_PALLAS for the port's
run; the JAX package on the CPU runs its plain stencils, level 0, the
reference of every level) and ``simple`` (``simple_step``).

The JAX package's runs take a Python process of their own (``python -c``
on :func:`jax_process_main`), so that the JAX runtime and the spawned gloo
ranks never share a process: beside them in one process, the suite's
worker once aborted (SIGABRT, no message) while this fixture ran.  The
runs go in and the results come back through pickle files in a temporary
directory; a process that fails puts its exit code and the end of its
stderr into the fixture's error.
"""

import os
import pickle
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
from jax.sharding import Mesh as JMesh

import torch_spatial_ranks as ranks
from cfd2_tpu.mesh import ChannelWithObstacle, generate_cut_cell_mesh
from cfd2_tpu.models import coupled as jc
from cfd2_tpu.models.pressure_poisson import simple_step as j_simple
from cfd2_tpu.ops import amg as jamg
from cfd2_tpu.parallel import spatial as jsp
from cfd2_tpu.runtime import state as js
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.ops.amg import build_hierarchy_for_mesh
from cfd2_tpu_torch.parallel.launch import run_ranks
from cfd2_tpu_torch.runtime import state as ts
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode

WORLDS = (2, 4, 8)
DT = 0.01
PAD = 8


def channel(h: float = 0.05):
    """The mesh and the inlet-column start of test_structured.py:118-139
    (at cell size ``h``)."""
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, h, h, 1.2, (3.0, 1.0))
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < h, 0] = 1.0
    return mesh, u0


FALLBACK_WORLDS = (2, 4)


def fallback_cases() -> dict:
    """tests/torch_spatial_ranks.FALLBACK on :func:`channel`'s meshes."""
    return ranks.fallback_cases(channel)


def jax_fallback_runs(cases: dict) -> dict:
    """Each fallback case on the JAX package's sharded step over 2 and 4
    virtual devices, its hierarchy placed by ``shard_cellwise``: {(world,
    name): u, outers, FGMRES iterations}."""
    out = {}
    for name, (mesh, pad, u0, dt, kind) in cases.items():
        dm = jencode(mesh, pad_rows_to=pad)
        if kind == "aggregation":
            hier = jamg.build_hierarchy(*[jamg._host(dm, k) for k in (
                "ck_neighbor", "ck_mask", "c_valid")])
        else:
            hier = jamg.build_hierarchy_for_mesh(dm)
            assert not isinstance(hier, jamg.StructuredAmgHierarchy)
        params = js.SolverParams.default(dt=dt)
        for w in FALLBACK_WORLDS:
            jm = JMesh(np.array(jax.devices("cpu")[:w]), axis_names=("y",))
            a = (None if hier is None
                 else jsp.shard_cellwise(hier, dm.num_cells, jm))
            s = jc.step(jsp.shard_mesh(dm, jm), jsp.shard_state(
                dm, js.initial_state(dm, u0=u0), jm), params,
                js.SolverConfig(precond_type=1), a)
            out[(w, name)] = dict(u=np.asarray(s.u), outer=int(s.outer_iters),
                                  lin=int(s.linear_iters_total))
    return out


def jax_runs(mesh, u0, runs: dict) -> dict:
    """Each run on the JAX package's sharded step: u and outers and FGMRES
    iterations per step (fgmres_recycle >= 2 carries the basis through
    ``step(..., krylov=)``)."""
    dm = jencode(mesh, pad_rows_to=PAD)
    jm = JMesh(np.array(jax.devices("cpu")[:8]), axis_names=("y",))
    smesh = jsp.shard_mesh(dm, jm)
    state0 = jsp.shard_state(dm, js.initial_state(dm, u0=u0), jm)
    params = js.SolverParams.default(dt=DT)
    amg = jsp.shard_cellwise(jamg.build_hierarchy_for_mesh(dm, agg_passes=1),
                             dm.num_cells, jm)
    out = {}
    for name, run in runs.items():
        cfg = replace(js.SolverConfig(), **run["config"])
        a = amg if cfg.precond_type == js.PRECOND_AMG else None
        kry = (jc._basis_init(dm, state0, cfg, a) if cfg.fgmres_recycle >= 2
               else None)
        s, outer, lin = state0, [], []
        for _ in range(run.get("steps", 1)):
            if run.get("simple"):
                s = jax.jit(j_simple, static_argnums=(3,))(smesh, s, params,
                                                           cfg)
            elif kry is not None:
                s, kry = jc.step(smesh, s, params, cfg, a, kry)
            else:
                s = jc.step(smesh, s, params, cfg, a)
            outer.append(int(s.outer_iters))
            lin.append(int(s.linear_iters_total))
        out[name] = dict(u=np.asarray(s.u), outer=outer, lin=lin)
    return out


def port_runs(mesh, u0, runs: dict) -> dict:
    """Each run on the port's step in one process."""
    dm = tencode(mesh, device="cpu", pad_rows_to=PAD)
    amg = build_hierarchy_for_mesh(dm)
    params = ts.SolverParams.default(dt=DT, device="cpu")
    return {name: ranks.option_run(dm, ts.initial_state(dm, u0=u0), params,
                                   amg, **run)
            for name, run in runs.items()}


def rank_runs(mesh, u0, runs: dict, timeout: float = 600) -> list:
    """Each run row-sharded over 2, 4 and 8 ranks, one spawn: per rank,
    {world: {name: result, "split": level}}.  The ranks beyond the first 2
    and 4 wait in their first exchange of the 8-rank runs until the smaller
    groups are done, so a collective may wait as long as the whole run."""
    return run_ranks(ranks.option_runs_over, max(WORLDS), device="cpu",
                     timeout=timeout, collective_timeout=timeout,
                     args=(WORLDS, mesh, PAD, u0, DT, runs))


TESTS = Path(__file__).resolve().parent


def jax_process_main(src: str, dst: str) -> None:
    """The JAX reference process: :func:`jax_runs` of the runs pickled at
    ``src`` on the channel (or, for the runs ``"fallback"``,
    :func:`jax_fallback_runs`), on the 8 virtual CPU devices its environment
    asks for, pickled to ``dst``."""
    jax.config.update("jax_platforms", "cpu")
    with open(src, "rb") as f:
        runs = pickle.load(f)
    if runs == "fallback":
        out = jax_fallback_runs(fallback_cases())
    else:
        mesh, u0 = channel()
        out = jax_runs(mesh, u0, runs)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


def start_jax_process(runs, tmp: str):
    """Start the JAX reference process for ``runs`` (files in ``tmp``);
    returns (process, path of its result)."""
    src, dst = os.path.join(tmp, "runs.pkl"), os.path.join(tmp, "jax.pkl")
    with open(src, "wb") as f:
        pickle.dump(runs, f)
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                     if "host_platform_device_count" not in f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count=8"
               .strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(TESTS), str(TESTS.parent)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    code = ("import sys, torch_spatial_cases as sc; "
            "sc.jax_process_main(sys.argv[1], sys.argv[2])")
    proc = subprocess.Popen([sys.executable, "-c", code, src, dst], env=env,
                            cwd=str(TESTS.parent), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, dst


def finish_jax_process(proc, dst: str, timeout: float) -> dict:
    """Wait for the JAX reference process; its results, or an error that
    carries its exit code and the end of its stderr."""
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
        raise RuntimeError(f"the JAX reference process ran past {timeout} s;"
                           f" its stderr ends:\n{err[-6000:]}") from None
    if proc.returncode != 0 or not os.path.exists(dst):
        raise RuntimeError(f"the JAX reference process exited with "
                           f"{proc.returncode}; its stderr ends:\n"
                           f"{err[-6000:]}")
    with open(dst, "rb") as f:
        return pickle.load(f)


def all_runs(runs: dict, timeout: float = 600) -> dict:
    """The three ways of every run: ``jax``, ``one`` (the port in one
    process) and ``ranks``.  The JAX package's sharded steps run in a
    process of their own while the ranks run in their spawned processes and
    this one runs the port's one-process steps."""
    mesh, u0 = channel()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        proc, dst = start_jax_process(runs, tmp)
        try:
            with ThreadPoolExecutor(1) as pool:
                spawned = pool.submit(rank_runs, mesh, u0, runs, timeout)
                out["one"] = port_runs(mesh, u0, runs)
                out["ranks"] = spawned.result()
        except BaseException:
            proc.kill()
            proc.communicate()
            raise
        out["jax"] = finish_jax_process(proc, dst, timeout)
    return out


def fallback_runs(timeout: float = 600) -> dict:
    """The fallback cases three ways: ``jax`` (:func:`jax_fallback_runs`,
    in a process of its own), ``one`` (the port in this process) and
    ``ranks`` (2 and 4 gloo ranks on the CPU, one spawn)."""
    cases = fallback_cases()
    with tempfile.TemporaryDirectory() as tmp:
        proc, dst = start_jax_process("fallback", tmp)
        try:
            one = {n: ranks.fallback_step(c[0], "cpu", *c[1:], group=False)
                   for n, c in cases.items()}
            res = run_ranks(ranks.fallback_steps_over, max(FALLBACK_WORLDS),
                            device="cpu", timeout=timeout,
                            collective_timeout=timeout,
                            args=(FALLBACK_WORLDS, cases))
        except BaseException:
            proc.kill()
            proc.communicate()
            raise
        return dict(one=one, ranks=res,
                    jax=finish_jax_process(proc, dst, timeout))


def sharded(res: list, world: int, name: str) -> dict:
    """One run over ``world`` ranks: the whole u, and the counts, which
    every rank must report alike (a rank that took another branch would
    have deadlocked the next collective)."""
    rs = [r[world][name] for r in res[:world]]
    for key in ("outer", "lin"):
        for r in rs[1:]:
            assert r[key] == rs[0][key], (name, world, key)
    return dict(u=np.concatenate([r["u"] for r in rs]),
                outer=rs[0]["outer"], lin=rs[0]["lin"],
                launches=[r.get("launches") for r in rs],
                counts=[r["counts"] for r in rs])


def cases(runs: dict) -> list:
    """(world, name) pairs of every run at every world size."""
    return [(w, n) for n in runs for w in WORLDS]
