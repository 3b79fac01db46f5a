"""Preconditioner-quality probe on a hard outer system of the structured
channel.

The port's counterpart of the JAX package's ``tools/prof_precond.py``: a
few host-mode steps from rest, then the outer system of the state they
leave (its ``prepare`` and ``assemble_stencil``, no new step's history
rotation) solved (restart 50, 8 restarts, rtol 1e-3, atol 1e-7) under
each preconditioner variant, with its iterations, final residual and wall
(at 1M after 2 steps: 11 iterations with ``v1m8`` on the H100):

* ``v1m8`` -- the production Schur preconditioner: one structured V(1,1)
  cycle for the pressure, 8 Jacobi momentum sweeps;
* ``v1m4``, ``v1m12`` -- 4 and 12 momentum sweeps;
* ``v2m8`` -- two V-cycles per application;
* ``cheb`` -- the Chebyshev/Jacobi pressure sweeps, 1 momentum sweep;
* ``trunc400``, ``trunc2000`` -- ``v1m8`` on the hierarchy truncated at
  400 and 2000 coarsest cells (a bigger dense coarsest solve; the JAX tool
  builds them, ``make_trunc``, without timing them; at 1M their coarsest
  levels are 10x28 and 19x56).

Usage (on the GPU unless ``--device cpu``):

    python -m cfd2_tpu_torch.tools.prof_precond [min_cell] [n_warm] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import probes

# (tag, V-cycles, momentum sweeps, coarsest-level cap); V-cycles 0: the
# Chebyshev pressure sweeps; cap None: the solver's own hierarchy.
VARIANTS = (("v1m8", 1, 8, None), ("v1m4", 1, 4, None),
            ("v1m12", 1, 12, None), ("v2m8", 2, 8, None),
            ("cheb", 0, 1, None), ("trunc400", 1, 8, 400),
            ("trunc2000", 1, 8, 2000))


def outer_system(s):
    """The first outer's stencil system at the solver's state: the
    prepared state and its assembled :class:`~..ops.stencil_system.
    StencilSystem`."""
    from ..models.assembly import assemble_stencil, prepare
    state = prepare(s.mesh, s.state, s.params, s.config)
    return state, assemble_stencil(s.mesh, state, s.params, s.config)


def pressure_solve(hier, ss, n_cycles: int):
    """``n_cycles`` structured V-cycles from the Jacobi seed, on (ny, nx)
    grids, with ``hier``'s level values of ``ss``."""
    from ..ops.amg import (_coarse_factors, compute_structured_level_values2,
                           structured_v_cycle)
    lv2 = compute_structured_level_values2(hier, ss.P_diag2, ss.P_off2)
    factors = _coarse_factors(hier, lv2)

    def ps(rhs2):
        x = ss.diag_p_inv2 * rhs2
        for _ in range(n_cycles):
            x = structured_v_cycle(hier, lv2, rhs2.reshape(-1),
                                   x.reshape(-1), coarse_factors=factors
                                   ).reshape(ss.grid)
        return x
    return ps


def solve_variants(s, state, ss, variants=VARIANTS, log=print) -> dict:
    """Each variant's FGMRES solve of the outer system ``ss`` from the
    state's (u, p), solved twice (the second timed): tag -> iterations,
    residual, converged, seconds."""
    from ..ops import stencil_system as st
    from ..ops.amg import build_structured_hierarchy
    from ..ops.fgmres import fgmres_solve
    n_sweeps = s.config.pressure_sweeps(s.mesh.num_cells)
    omega = s.config.precond_omega
    x0 = st.to_planar(ss, torch.cat([state.u, state.p[:, None]], dim=1))
    rhs = st.to_planar(ss, ss.rhs)
    out = {}
    for tag, cycles, ms, cap in variants:
        hier = s._get_amg()
        if cap is not None:
            hier = build_structured_hierarchy(s.mesh, min_coarse=cap)
            log(f"# {tag}: {len(hier.levels)} levels, coarsest "
                f"{hier.levels[-1].grid}")
        ps = pressure_solve(hier, ss, cycles) if cycles else None

        def solve():
            return fgmres_solve(
                lambda x: st.spmv_planar(ss, x),
                lambda r: st.schur_precond_planar(
                    ss, r, omega, n_sweeps, pressure_solve=ps,
                    mom_sweeps=ms),
                rhs, x0, restart=50, max_restarts=8, tol=1e-3, abstol=1e-7)

        t0 = time.time()
        solve()
        probes.sync(s.device)
        first = time.time() - t0
        t0 = time.time()
        r = solve()
        probes.sync(s.device)
        dt = time.time() - t0
        out[tag] = dict(iterations=r.iterations, residual=r.residual,
                        converged=r.converged, seconds=dt)
        log(f"{tag:9s} iters={r.iterations:4d} resid={r.residual:.2e} "
            f"conv={r.converged} {dt * 1e3:8.1f} ms "
            f"({dt / max(r.iterations, 1) * 1e3:.2f} ms/iter, first "
            f"{first:.1f}s)")
    return out


def run(min_cell: float = 0.0017, n_warm: int = 2, device=None, mesh=None,
        variants=VARIANTS, log=print) -> dict:
    """Warm ``n_warm`` host-mode steps from rest, then
    :func:`solve_variants` on the next outer system.  ``mesh``: the
    channel's host mesh at ``min_cell``, made here when None."""
    from ..models.coupled import step_host
    from ..runtime.device_mesh import resolve_device
    device = resolve_device(device)
    t0 = time.time()
    if mesh is None:
        mesh = probes.channel_mesh(min_cell)
    s = probes.channel_solver(mesh, min_cell, device)
    log(f"# mesh {mesh.num_cells} -> {s.mesh.num_cells} on {device} in "
        f"{time.time() - t0:.0f}s; warming {n_warm} steps")
    for _ in range(n_warm):
        s.state = step_host(s.mesh, s.state, s.params, s.config,
                            s._get_amg())
    probes.sync(device)
    log(f"# warm done ({time.time() - t0:.0f}s)")
    state, ss = outer_system(s)
    return solve_variants(s, state, ss, variants, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("min_cell", nargs="?", type=float, default=0.0017)
    ap.add_argument("n_warm", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: CUDA)")
    a = ap.parse_args(argv)
    run(a.min_cell, a.n_warm, a.device, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
