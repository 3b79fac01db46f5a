"""How close a full-size case's step 2 solves end to their targets, and
whether the two packages' operators agree on the same outer input.

    python3 tests/torch_step_margins.py [--case CASE] [--state PATH] \
        card [--save-outers DIR]
    python3 tests/torch_step_margins.py [...] cpu-step [--save-outers DIR]
    python3 tests/torch_step_margins.py [...] replay DIR [--outer K] \
        [--device cuda|cpu] [--save PATH] [--against PATH]
    JAX_PLATFORMS=cpu python tests/torch_step_margins.py [...] cpu DIR \
        [--outer K]

``--case`` names a case of ``developed_cases.CASES`` (default
``delaunay_403k_rest``); ``--state`` a step input that
``developed_cases.save_step_input`` wrote for it (default the card's
committed one, ``cfd2_tpu_torch/data/<case without _rest>_step2_card.npz``:
``delaunay_403k_step2_card.npz``, ``refined_132k_step2_card.npz``).

``card`` (on a GPU; no JAX): the case's solver (``developed_cases``) started
from that step input takes the step and prints, for every outer,
its FGMRES iterations and the true residual over the solve's target after
each cycle (the solve ends below 1, at the restart cap or at the
stagnation exit); ``--save-outers DIR`` writes the fields each outer's
solve reads (u, p, d_p, grad_p in host order) as ``outer<K>.npz``.
``cpu-step`` does the same with the port's plain path on the CPU (no JAX;
``--threads T`` sets torch's threads, 2 by default as in the record's
``port_cpu_from_card_step2``).

``replay`` (no JAX): outer K's saved input (from either of the two) solved
with the port's operators on the card (or ``--device cpu``): its cycles'
true residual over the target, and the residual's float32 evaluation error
at x0 and at the solution (the distance from the float64 evaluation);
``--save`` writes the outer's ``prepare`` and ``assemble_ell`` fields, b,
x0, b - A x0 and its preconditioned direction for a bit-for-bit comparison
of two devices.  Replaying one input on both devices tells a difference of
the devices' arithmetic from one of their inputs; ``--against PATH``
(another device's ``--save``) compares each of them with the file's, in
the order the step computes them, and the preconditioner applied to the
file's b - A x0 with the file's direction (the two devices'
preconditioners on one input).

``cpu``: on the saved input of outer K (default 4) and the one before it
(outer 0 reads no saved outer: its input is the step input itself, so
``DIR`` is not read), the JAX package and the port's plain path on the
CPU, one operator at a time: the step-entry ``prepare`` and frozen coarse
operators, the outer's ``prepare`` (also against the saved one's),
``assemble_ell``, the matvec and the Schur preconditioner on a seeded
vector, then the port's FGMRES loop with either package's operators, with
the port's and the loop's products and norms accumulated in float64, and
with each mix of one package's matvec and the other's preconditioner, its
true residual over the target after each cycle.

The FGMRES loop is the port's ``ops/fgmres.py`` with one line added after
each cycle's true residual (and after each iteration's estimate) that
records it; the arithmetic is the module's.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from dataclasses import fields, replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cfd2_tpu_torch.tools import developed_cases as dc  # noqa: E402

CASE = "delaunay_403k_rest"
_CYCLE = "        conv = bool(res_new < target)\n"
_ITER = "            stop = resid < target\n"


class _F64Products:
    """``torch`` for the FGMRES loop, its matrix-vector products (the
    Gram-Schmidt dots, the basis update and the solution update) accumulated
    in float64 and returned in the vectors' dtype."""

    def __getattr__(self, name):
        import torch
        return getattr(torch, name)

    @staticmethod
    def mv(a, v):
        import torch
        return torch.mv(a.double(), v.double()).to(v.dtype)


def recording_fgmres(f64=False):
    """The port's ``fgmres_solve`` with each cycle's true residual and each
    iteration's estimate recorded over the target; returns (solve,
    cycles, estimates), one list per solve appended on each call.  ``f64``:
    the loop's products (:class:`_F64Products`) and norms accumulate in
    float64, the rest of its arithmetic as it is."""
    import cfd2_tpu_torch.ops.fgmres as tf
    src = inspect.getsource(tf.fgmres_solve)
    if _CYCLE not in src or _ITER not in src:
        raise RuntimeError("ops/fgmres.py changed: update the recorded lines")
    src = src.replace(_CYCLE, _CYCLE + "        _CYC[-1].append(float(res_new)"
                      " / float(target))\n")
    src = src.replace(_ITER, _ITER + "            _EST[-1].append(float(resid)"
                      " / float(target))\n")
    cycles, estimates = [], []
    ns = dict(vars(tf), _CYC=cycles, _EST=estimates)
    if f64:
        ns["torch"] = _F64Products()
        ns["_dots"] = _F64Products.mv
        ns["make_norm"] = lambda f64_norms, dtype, reduce: tf.make_norm(
            True, dtype, reduce)
    exec(src, ns)

    def solve(*a, **k):
        cycles.append([])
        estimates.append([])
        return ns["fgmres_solve"](*a, **k)
    return solve, cycles, estimates


def card(save_outers=None, device=None, case=CASE, state=None) -> int:
    import torch
    from cfd2_tpu_torch.models import coupled
    state = Path(state or dc.card_step2_path(case))
    s, _ = dc.make_solver(dc.CASES[case], device=device)
    meta = dc.load_step_input(s, state)
    solve, cycles, estimates = recording_fgmres()
    orig_solve, orig_outer = coupled.fgmres_solve, coupled._assemble_and_solve
    its = []

    def outer(mesh, state, *a, **k):
        if save_outers is not None:
            Path(save_outers).mkdir(parents=True, exist_ok=True)
            np.savez_compressed(
                Path(save_outers) / f"outer{len(its)}.npz",
                **{f: s.mesh.to_host_order(getattr(state, f)).cpu().numpy()
                   for f in dc.STEP_INPUT_FIELDS})
        r = orig_outer(mesh, state, *a, **k)
        its.append(int(r.iterations))
        return r

    coupled.fgmres_solve, coupled._assemble_and_solve = solve, outer
    try:
        s.step()
        if s.state.u.is_cuda:
            torch.cuda.synchronize()
    finally:
        coupled.fgmres_solve = orig_solve
        coupled._assemble_and_solve = orig_outer
    print(f"{case} step {meta['step']} from {state.name}: "
          f"{int(s.state.outer_iters)} outers, "
          f"FGMRES iterations {its}", flush=True)
    for i, (c, e) in enumerate(zip(cycles, estimates)):
        print(f"outer {i}: {its[i]} iterations in {len(c)} cycles; true "
              "residual / target after each cycle "
              + " ".join(f"{v:.4f}" for v in c) + "; estimate / target at "
              "the last 6 iterations " + " ".join(f"{v:.3f}" for v in e[-6:]),
              flush=True)
    where = (torch.cuda.get_device_name(0) if s.state.u.is_cuda
             else f"cpu, {torch.get_num_threads()} torch threads")
    print(json.dumps({"its": its, "cycles": cycles, "device": where}),
          flush=True)
    return 0


def _port_outer(s, outers: Path, k: int) -> dict:
    """The port's set-up of outer ``k`` of step 2 on the solver's device:
    the step entry's ``prepare`` (``entry``) and frozen coarse levels
    (``frozen``), the outer's ``prepare`` (``tp``; outer 0 reads the step
    input itself, later outers their saved ``u``, ``p`` and the ``d_p``,
    ``grad_p`` of the outer before), ``assemble_ell`` (``es``), the pressure
    solve (``ps``), the matvec and Schur preconditioner (``mv``, ``pc``),
    the start vector ``x0`` and right-hand side ``b``."""
    import torch
    import cfd2_tpu_torch.models.assembly as ta
    import cfd2_tpu_torch.ops.ellsys as tel
    from cfd2_tpu_torch.ops.amg import AmgHierarchy, coarse_level_values, \
        make_pressure_solve
    tm = s.mesh
    entry = ta.prepare(tm, replace(s.state, u_old_old=s.state.u_old,
                                   u_old=s.state.u), s.params, s.config)
    amg = s._get_amg()
    # The step freezes the aggregation hierarchy's coarse levels; the
    # multilevel embedding rebuilds its own every outer (models/coupled.py).
    frozen = (coarse_level_values(amg, *ta.assemble_pressure(tm, entry,
                                                             s.params))
              if isinstance(amg, AmgHierarchy) else None)
    if k == 0:
        # Outer 0 solves on the step entry's own prepare (upwind scheme: no
        # second prepare before the first solve), so no saved outer is read.
        if s.config.scheme != 0:
            raise ValueError("--outer 0 assumes the upwind scheme")
        tp, inp = entry, None
    else:
        # Outer k's input: its u and p, the d_p and grad_p of outer k - 1.
        cur = np.load(outers / f"outer{k}.npz")
        prev = np.load(outers / f"outer{k - 1}.npz")
        inp = dict(u=cur["u"], p=cur["p"], d_p=prev["d_p"],
                   grad_p=prev["grad_p"])
        tp = ta.prepare(tm, replace(entry, **{
            f: tm.from_host_order(torch.from_numpy(np.ascontiguousarray(a)))
            for f, a in inp.items()}), s.params, s.config)
    es = ta.assemble_ell(tm, tp, s.params, s.config)
    ps = make_pressure_solve(amg, tm, es, coeff=s.params.density * tp.d_p,
                             cycle_opts=s.config.cycle_opts(), frozen=frozen)
    sweeps = s.config.pressure_sweeps(tm.total_cells)
    return dict(
        entry=entry, frozen=frozen, tp=tp, es=es, ps=ps, saved=inp,
        mv=lambda x: tel.spmv(es, tm, x),
        pc=lambda r: tel.schur_precond(es, tm, r, s.config.precond_omega,
                                       sweeps, pressure_solve=ps,
                                       mom_sweeps=8),
        x0=torch.cat([tp.u, tp.p[:, None]], 1).T.contiguous(),
        b=es.rhs.T.contiguous())


def residual_floor(o: dict, mesh, x) -> tuple:
    """The true residual of ``x`` evaluated as the FGMRES loop evaluates it
    (float32, on the solver's device) and with the matrix, x and b in
    float64 (on the CPU), and the norm of their difference (the float32
    evaluation's own error), as float64 norms."""
    import torch
    import cfd2_tpu_torch.ops.ellsys as tel
    es = o["es"]
    es64 = replace(es, **{f.name: getattr(es, f.name).cpu().double()
                          for f in fields(es)
                          if isinstance(getattr(es, f.name), torch.Tensor)
                          and getattr(es, f.name).is_floating_point()})
    r32 = (o["b"] - o["mv"](x)).cpu().double()
    x64 = x.cpu().double()
    r64 = o["b"].cpu().double() - tel.spmv_window(
        es64, x64, x64, mesh.ck_neighbor.cpu())
    return tuple(float(torch.linalg.vector_norm(v)) for v in
                 (r32, r64, r32 - r64))


def _differ(a, b) -> str:
    """max-abs of a - b, over max|b|, and the share of entries that differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = float(np.abs(a - b).max())
    return (f"max-abs {d:.3e} ({d / max(float(np.abs(b).max()), 1e-300):.3e}"
            f" of max|.|), {float(np.mean(a != b)):.4f} of the entries differ")


def replay(outers: Path, k: int, device: str, save=None, case=CASE,
           state=None, against=None) -> int:
    """Outer ``k``'s saved input (written by ``card`` or ``cpu-step``) solved
    with the port's operators on ``device``, no JAX: its FGMRES iterations,
    the true residual over the target after each cycle, and the residual's
    float32 evaluation error at x0 and at the solution.  ``save``: an npz of
    the outer's prepare and assembly fields, b, x0, r0 = b - A x0 and the
    preconditioned r0 / |r0| in device order, for a bit-for-bit comparison
    of two devices' operators; ``against``: such a file of another device,
    compared with this one's."""
    import torch
    import cfd2_tpu_torch.models.coupled as tc
    s, _ = dc.make_solver(dc.CASES[case], device=device)
    dc.load_step_input(s, state or dc.card_step2_path(case))
    o = _port_outer(s, outers, k)
    solve, cycles, _ = recording_fgmres()
    r = solve(o["mv"], o["pc"], o["b"], o["x0"], tol=s.config.fgmres_tol,
              abstol=s.config.fgmres_abstol, **tc._fgmres_kwargs(s.config))
    b32 = float(torch.sqrt(torch.sum(o["b"].double() ** 2)))
    target = max(s.config.fgmres_tol * b32, s.config.fgmres_abstol)
    where = (torch.cuda.get_device_name(0) if s.state.u.is_cuda
             else f"cpu, {torch.get_num_threads()} torch threads")
    print(f"outer {k} on {where}: {int(r.iterations)} iterations in "
          f"{len(cycles[-1])} cycles, converged {r.converged}; true residual"
          " / target after each cycle "
          + " ".join(f"{v:.4f}" for v in cycles[-1]), flush=True)
    for name, x in (("x0", o["x0"]), ("the solution", r.x)):
        r32, r64, err = residual_floor(o, s.mesh, x)
        print(f"  at {name}: true residual / target {r32 / target:.4f} in "
              f"float32, {r64 / target:.4f} in float64; the float32 "
              f"evaluation's error {err / target:.4f}", flush=True)
    direction = lambda r0: o["pc"](r0 / torch.sqrt(torch.sum(r0 * r0)))
    r0 = o["b"] - o["mv"](o["x0"])
    z0 = direction(r0)
    # The outer's prepare and assembly, in the order the step computes them,
    # then what the solve starts from.
    mine = {f"prepare {f}": getattr(o["tp"], f)
            for f in ("fluxes", "d_p", "grad_p", "grad_u", "grad_v")}
    mine.update({f"assemble_ell {f.name}": getattr(o["es"], f.name)
                 for f in fields(o["es"])})
    mine.update(b=o["b"], x0=o["x0"], r0=r0, z0=z0, x=r.x)
    mine = {n: v.cpu().numpy() for n, v in mine.items()}
    if save is not None:
        np.savez_compressed(save, **mine)
    if against is not None:
        with np.load(against) as f:
            other = {n: f[n] for n in f.files}
        label = {"r0": "b - A x0", "z0": "the direction"}
        for n, v in mine.items():
            if n in other and n != "x":
                print(f"  {label.get(n, n)} against {Path(against).name}: "
                      f"{_differ(v, other[n])}", flush=True)
        z_other = direction(torch.from_numpy(other["r0"]).to(r0.device))
        print(f"  the preconditioner on its b - A x0 against its direction: "
              f"{_differ(z_other.cpu().numpy(), other['z0'])}", flush=True)
    return 0


def cpu(outers: Path, k: int, case=CASE, state=None) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_fullsize_parity as fp
    import cfd2_tpu.models.assembly as ja
    import cfd2_tpu.ops.ellsys as jel
    from cfd2_tpu.ops.amg import AmgHierarchy as JAmgHierarchy
    from cfd2_tpu.ops.amg import coarse_level_values as j_levels
    from cfd2_tpu.ops.amg import make_pressure_solve as j_pressure
    import cfd2_tpu_torch.models.coupled as tc

    t0 = time.time()
    state = state or dc.card_step2_path(case)
    case = dc.CASES[case]
    j = fp.jax_solver(case, fp.jax_mesh(case))
    fp.jax_load_step_input(j, state)
    s, _ = dc.make_solver(case, device="cpu")
    dc.load_step_input(s, state)
    tm, jm = s.mesh, j.mesh
    o = _port_outer(s, outers, k)

    def host(mesh, x):
        return np.asarray(mesh.to_host_order(x))

    def cmp(name, a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d, sc = np.abs(a - b).max(), np.abs(b).max()
        print(f"[{time.time() - t0:6.1f} s] {name:24s} max-abs {d:.3e} of "
              f"{sc:.3e} ({d / max(sc, 1e-30):.3e} relative)", flush=True)

    # Step entry: the history rotation, prepare, the frozen coarse levels.
    js0 = ja.prepare(jm, replace(j.state, u_old_old=j.state.u_old,
                                 u_old=j.state.u), j.params, j.config)
    cmp("entry prepare: d_p", host(tm, o["entry"].d_p), host(jm, js0.d_p))
    amg_j = j._get_amg()
    fr_j = (j_levels(amg_j, *ja.assemble_pressure(jm, js0, j.params))
            if isinstance(amg_j, JAmgHierarchy) else None)
    if k == 0:
        jp = js0
    else:
        jp = ja.prepare(jm, replace(js0, **{
            f: jm.from_host_order(jnp.asarray(a))
            for f, a in o["saved"].items()}), j.params, j.config)
        cur = np.load(outers / f"outer{k}.npz")
    tp = o["tp"]
    for f in ("d_p", "grad_p"):
        cmp(f"prepare: {f} port/JAX", host(tm, getattr(tp, f)),
            host(jm, getattr(jp, f)))
        if k > 0:
            cmp(f"prepare: {f} saved/JAX", cur[f], host(jm, getattr(jp, f)))
    es_t = o["es"]
    es_j = ja.assemble_ell(jm, jp, j.params, j.config)
    for f in fields(es_t):
        a, b = getattr(es_t, f.name), getattr(es_j, f.name, None)
        if isinstance(a, torch.Tensor) and b is not None:
            cmp(f"assemble_ell: {f.name}", a.numpy(), np.asarray(b))
    n = tm.total_cells
    rv = np.random.default_rng(0).standard_normal((3, n)).astype(np.float32)
    rv[:, ~tm.c_valid.numpy().astype(bool)] = 0
    cmp("matvec", o["mv"](torch.from_numpy(rv)).numpy(),
        np.asarray(jel.spmv(es_j, jm, jnp.asarray(rv))))
    ps_j = j_pressure(amg_j, jm, es_j, coeff=j.params.density * jp.d_p,
                      cycle_opts=j.config.cycle_opts(), frozen=fr_j)
    sweeps = s.config.pressure_sweeps(n)
    omega = s.config.precond_omega
    pc_t, mv_t = o["pc"], o["mv"]
    pc_j = jax.jit(lambda r: jel.schur_precond(
        es_j, jm, r, omega, sweeps, pressure_solve=ps_j, mom_sweeps=8))
    mv_j = jax.jit(lambda x: jel.spmv(es_j, jm, x))
    cmp("Schur preconditioner", pc_t(torch.from_numpy(rv)).numpy(),
        np.asarray(pc_j(jnp.asarray(rv))))
    port, port64 = recording_fgmres(), recording_fgmres(f64=True)
    via_jax = lambda f: (lambda x: torch.from_numpy(
        np.asarray(f(jnp.asarray(x.numpy())))))
    for name, mv, pc, (solve, cycles, _) in (
            ("the port's operators", mv_t, pc_t, port),
            ("the port's operators, the loop's products and norms in "
             "float64", mv_t, pc_t, port64),
            ("the JAX package's operators", via_jax(mv_j), via_jax(pc_j),
             port),
            ("the port's matvec, JAX's preconditioner", mv_t, via_jax(pc_j),
             port),
            ("JAX's matvec, the port's preconditioner", via_jax(mv_j), pc_t,
             port)):
        r = solve(mv, pc, o["b"], o["x0"], tol=s.config.fgmres_tol,
                  abstol=s.config.fgmres_abstol, **tc._fgmres_kwargs(s.config))
        print(f"[{time.time() - t0:6.1f} s] outer {k}, FGMRES with {name}: "
              f"{int(r.iterations)} iterations in {len(cycles[-1])} cycles; "
              "true residual / target after each cycle "
              + " ".join(f"{v:.4f}" for v in cycles[-1]), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=sorted(dc.CASES), default=CASE)
    ap.add_argument("--state", type=Path, default=None,
                    help="the step input (default: the card's committed "
                         "step-2 state of the case)")
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("card")
    c.add_argument("--save-outers", default=None)
    cs = sub.add_parser("cpu-step")
    cs.add_argument("--save-outers", default=None)
    cs.add_argument("--threads", type=int, default=2)
    p = sub.add_parser("cpu")
    p.add_argument("outers", type=Path)
    p.add_argument("--outer", type=int, default=4)
    rp = sub.add_parser("replay")
    rp.add_argument("outers", type=Path)
    rp.add_argument("--outer", type=int, default=4)
    rp.add_argument("--device", default="cuda")
    rp.add_argument("--threads", type=int, default=2)
    rp.add_argument("--save", default=None)
    rp.add_argument("--against", default=None)
    a = ap.parse_args(argv)
    where = dict(case=a.case, state=a.state)
    if a.mode == "card":
        return card(a.save_outers, **where)
    if a.mode == "replay":
        import torch
        torch.set_num_threads(a.threads)
        return replay(a.outers, a.outer, a.device, a.save,
                      against=a.against, **where)
    if a.mode == "cpu-step":
        import torch
        torch.set_num_threads(a.threads)
        return card(a.save_outers, device="cpu", **where)
    return cpu(a.outers, a.outer, **where)


if __name__ == "__main__":
    sys.exit(main())
