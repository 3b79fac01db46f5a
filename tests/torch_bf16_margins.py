"""The sharded bf16-basis step of tests/test_torch_spatial_bf16.py, three
ways, with how close its FGMRES solves end to their targets and how far runs
that differ only in the order of their sums move them: whether that test's
exact count assertions can fail between correct runs.

    JAX_PLATFORMS=cpu python tests/torch_bf16_margins.py [WORLDS]

runs the channel of tests/torch_spatial_cases.py one step with the bf16
basis and with the default f32 basis: in one process, row-sharded over each
world size of WORLDS (default 1,2,3,4,6,8; gloo ranks on the CPU), and on the
JAX package's sharded step.  It prints, per run, the outers, the FGMRES
iterations, max|du| against one process and against the JAX package, and for
the one-process run's three stop tests closest to their target (the residual
estimate |g_j| over the target, or the true residual at a cycle's end) the
same tests' ratios in each sharded run.  Under another BLAS code path
(e.g. ``MKL_ENABLE_INSTRUCTIONS=SSE4_2``) it samples other sum orders.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch_spatial_ranks as ranks  # noqa: E402

RUNS = {"fgmres_basis_bf16": dict(config=dict(fgmres_basis_bf16=True)),
        "default": dict(config=dict())}


def _ratios(solves):
    """Replay each recorded solve's host reads (FGMRES's Givens arithmetic,
    as ``fgmres_solve`` does it) into the ratio residual / target at every
    stop test, in order."""
    from cfd2_tpu_torch.ops.fgmres import _givens_column
    out = []
    for tol, abstol, reads in solves:
        rhs_norm, beta = (np.float32(v) for v in reads[0])
        target = max(np.float32(tol) * rhs_norm, np.float32(abstol))
        j, g, cs, sn = 0, None, None, None
        for h in reads[1:]:
            if h.ndim == 0:                  # the true residual of a cycle
                beta = np.float32(h)
                out.append(float(beta / target))
                j = 0
                continue
            if j == 0:
                m = 64
                g, cs, sn = (np.zeros(m + 1, np.float32),
                             np.zeros(m, np.float32), np.zeros(m, np.float32))
                g[0] = beta
            _givens_column(h, cs, sn, j)
            gj = g[j]
            g[j] = cs[j] * gj
            g[j + 1] = -sn[j] * gj
            j += 1
            out.append(float(abs(g[j]) / target))
    return np.array(out)


def _recorded(fn):
    """``fn()`` with every FGMRES solve's tolerances and host reads
    recorded: (result, [(tol, abstol, reads), ...])."""
    from cfd2_tpu_torch.models import coupled
    from cfd2_tpu_torch.ops import fgmres
    solves, solve, read = [], coupled.fgmres_solve, fgmres.read

    def recorded_solve(*a, **k):
        reads = []

        def recorded_read(t):
            v = read(t)
            reads.append(np.array(v, np.float32))
            return v

        fgmres.read = recorded_read
        try:
            return solve(*a, **k)
        finally:
            fgmres.read = read
            solves.append((k["tol"], k["abstol"], reads))

    coupled.fgmres_solve = recorded_solve
    try:
        return fn(), solves
    finally:
        coupled.fgmres_solve = solve


def margin_runs_over(rank, world, device, worlds, host_mesh, pad, u0, dt):
    """The rank side: each run of ``RUNS`` over each world size, with its
    stop tests' ratios."""
    def group_runs(group):
        mesh, state, params, _, amg, _ = ranks.setup(
            host_mesh, device, pad, u0, dt, {}, True, group)
        out = {}
        for name, kw in RUNS.items():
            res, solves = _recorded(lambda: ranks.option_run(
                mesh, state, params, amg, **kw))
            out[name] = dict(res, ratios=_ratios(solves))
        return out

    return ranks._over(rank, world, worlds, group_runs)


def main(argv) -> None:
    import torch_spatial_cases as sc
    from cfd2_tpu_torch.parallel.launch import run_ranks
    from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
    from cfd2_tpu_torch.ops.amg import build_hierarchy_for_mesh
    from cfd2_tpu_torch.runtime import state as ts

    torch.set_num_threads(1)
    worlds = tuple(int(w) for w in (argv[0] if argv else
                                    "1,2,3,4,6,8").split(","))
    mesh, u0 = sc.channel()
    jax = sc.jax_runs(mesh, u0, RUNS)
    dm = encode_mesh(mesh, device="cpu", pad_rows_to=sc.PAD)
    params = ts.SolverParams.default(dt=sc.DT, device="cpu")
    one = {}
    for name, kw in RUNS.items():
        res, solves = _recorded(lambda: ranks.option_run(
            dm, ts.initial_state(dm, u0=u0), params,
            build_hierarchy_for_mesh(dm), **kw))
        one[name] = dict(res, ratios=_ratios(solves))
    res = run_ranks(margin_runs_over, max(worlds), device="cpu", timeout=900,
                    collective_timeout=900,
                    args=(worlds, mesh, sc.PAD, u0, sc.DT))
    print("MKL_ENABLE_INSTRUCTIONS="
          f"{os.environ.get('MKL_ENABLE_INSTRUCTIONS')}")
    for name in RUNS:
        o = one[name]
        close = np.argsort(np.abs(np.log(o["ratios"])))[:3]
        du_jax = np.abs(o["u"] - jax[name]["u"]).max()
        print(f"{name}: one process outers {o['outer']}, FGMRES {o['lin']}, "
              f"max|du| against JAX {du_jax:.3e} (JAX outers "
              f"{jax[name]['outer']}); closest stop tests "
              + ", ".join(f"#{i} {o['ratios'][i]:.5f}" for i in close))
        for w in worlds:
            r = res[0][w][name]
            u = np.concatenate([rr[w][name]["u"] for rr in res[:w]])
            n = min(len(r["ratios"]), len(o["ratios"]))
            rel = np.abs(r["ratios"][:n] / o["ratios"][:n] - 1)
            print(f"  {w} ranks: outers {r['outer']}, FGMRES {r['lin']}, "
                  f"max|du| {np.abs(u - o['u']).max():.3e} (JAX "
                  f"{np.abs(u - jax[name]['u']).max():.3e}); stop-test "
                  f"ratios apart by median {np.median(rel):.2e}, max "
                  f"{rel.max():.2e}; at "
                  + ", ".join(f"#{i} {r['ratios'][i]:.5f}" for i in close
                              if i < n))


if __name__ == "__main__":
    import conftest  # noqa: F401  (the 8 virtual CPU devices of the suite)
    main(sys.argv[1:])
