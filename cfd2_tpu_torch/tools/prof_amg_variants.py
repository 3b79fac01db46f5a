"""Aggregation-AMG cycle variants on an unstructured channel: the pressure
V-cycle's contraction and the coupled FGMRES iterations under each.

The port's counterpart of the JAX package's ``tools/prof_amg_variants.py``,
with its variants (baseline damped-Jacobi V(1,1); prolongation
over-correction; 2-sweep Jacobi; Chebyshev smoothing of degree 2 and 3)
through ``make_pressure_solve(..., cycle_opts=...)``.  For each: the
coupled system of the first outer from rest solved by FGMRES (the solver's
restart, 5 restarts, rtol 1e-5, atol 1e-7) with the Schur preconditioner,
8 momentum sweeps and that pressure solve (iterations, converged, wall of
the second of two solves); and the contraction the JAX tool's docstring
names: the pressure solve used as a stationary iteration on the assembled
pressure operator, x <- x + M(b - P x) from x = 0 for a seeded b, the
geometric mean of the residual ratio over 5 cycles (above 1 where the
stationary cycle diverges on the near-null constant mode; FGMRES needs
only the clustering).

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.prof_amg_variants [min_cell] \\
        [delaunay|voronoi] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import probes

VARIANTS = (
    ("base j1", {}),
    ("oc1.5", {"overcorrect": 1.5}),
    ("oc1.8", {"overcorrect": 1.8}),
    ("j2", {"smooth_arg": 2}),
    ("j2+oc1.5", {"smooth_arg": 2, "overcorrect": 1.5}),
    ("cheb2", {"smoother": "cheb", "smooth_arg": 2}),
    ("cheb2+oc1.5", {"smoother": "cheb", "smooth_arg": 2,
                     "overcorrect": 1.5}),
    ("cheb3+oc1.5", {"smoother": "cheb", "smooth_arg": 3,
                     "overcorrect": 1.5}),
)
CYCLES = 5


def seeded_rhs(n: int, valid, seed: int = 0) -> np.ndarray:
    """The contraction's right-hand side: standard normal float32 from
    ``seed``, zero on the cells ``valid`` masks out."""
    b = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return b * (np.asarray(valid) > 0)


def contraction(ps, apply_p, b, cycles: int = CYCLES) -> float:
    """Geometric-mean residual ratio of ``cycles`` stationary steps
    x <- x + ps(b - P x) from x = 0 (``apply_p``: x -> P x)."""
    x = torch.zeros_like(b)
    r0 = torch.sqrt(torch.sum(b.double() ** 2))
    r = b
    for _ in range(cycles):
        x = x + ps(r)
        r = b - apply_p(x)
    rk = torch.sqrt(torch.sum(r.double() ** 2))
    return float((rk / r0) ** (1.0 / cycles))


def run(size: float = 0.01, mesh_type: str = "delaunay", device=None,
        mesh=None, variants=VARIANTS, log=print) -> dict:
    """Every variant on the first outer system from rest: name ->
    iterations, converged, seconds, contraction.  ``mesh``: the channel's
    host mesh, made here when None."""
    from ..models.assembly import assemble_ell, prepare
    from ..ops import ellsys as el
    from ..ops.amg import make_pressure_solve
    from ..ops.blockell import scalar_spmv
    from ..ops.fgmres import fgmres_solve
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    if mesh is None:
        mesh = probes.channel_mesh(size, mesh_type)
    s = probes.channel_solver(mesh, size, device)
    dm, config, params = s.mesh, s.config, s.params
    hier = s._get_amg()
    log(f"# {mesh_type} {size}: {mesh.num_cells} cells on {device}, levels "
        f"{[lv.n for lv in hier.levels]}")
    state = prepare(dm, s.state, params, config)
    es = assemble_ell(dm, state, params, config)
    n_sweeps = config.pressure_sweeps(dm.num_cells)
    x0 = torch.cat([state.u, state.p[:, None]], dim=1).T.contiguous()
    rhs = es.rhs.T.contiguous()
    b = torch.as_tensor(seeded_rhs(dm.num_cells, dm.c_valid.cpu()),
                        device=dm.device)
    apply_p = lambda x: scalar_spmv(es.P_diag, es.P_off, dm, x)
    out = {}
    for name, opts in variants:
        ps = make_pressure_solve(hier, dm, es, cycle_opts=opts)

        def solve():
            return fgmres_solve(
                lambda x: el.spmv(es, dm, x),
                lambda r: el.schur_precond(es, dm, r, config.precond_omega,
                                           n_sweeps, pressure_solve=ps,
                                           mom_sweeps=8),
                rhs, x0, restart=config.fgmres_restart, max_restarts=5,
                tol=1e-5, abstol=1e-7)

        solve()
        probes.sync(device)
        t0 = time.time()
        r = solve()
        probes.sync(device)
        dt = time.time() - t0
        rho = contraction(ps, apply_p, b)
        out[name] = dict(iterations=r.iterations, converged=r.converged,
                         seconds=dt, contraction=rho)
        log(f"solve[{name:14s}] {dt * 1e3:.0f} ms iters={r.iterations} "
            f"conv={r.converged} contraction={rho:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("min_cell", nargs="?", type=float, default=0.01)
    ap.add_argument("mesh_type", nargs="?", default="delaunay",
                    choices=("delaunay", "voronoi"))
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.min_cell, a.mesh_type, a.device,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
