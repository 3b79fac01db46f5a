"""Coupled (u,v,p) timestep driver.

Port of ``cfd2_tpu.models.coupled``:

* :func:`step` = prepare -> [assemble -> FGMRES -> relaxed update] outer
  correctors as a Python loop, with the same convergence, stagnation and
  pressure-plateau exits as the JAX package's ``lax.while_loop``.  Each
  outer corrector reads its two max-diff scalars to the host once (one
  synchronisation, counted by :mod:`..runtime.host_reads`);
* :func:`step_host` (``begin_step`` / ``outer_iteration`` /
  ``finish_step``): the JAX package's host-controlled step, with its own
  quirks (coarse operators rebuilt every outer, presolve not gated to the
  first outer, no recycling, ``FloatingPointError`` on NaN residuals);
* :func:`multi_step` / :func:`multi_step_adaptive`: N steps with the
  stopped state frozen, the latter with the CFL controller on the device;
* :func:`check_evolution`, the steady-state/degeneracy classifier, runs on
  the device from state carried across steps;
* :class:`CoupledSolver` is the host-side façade with the reference's
  headless API (GpuSolver::new -> set_* -> step -> get_u/get_p), plus
  checkpoints and cross-step Krylov recycling.

Every option of :class:`SolverConfig` is ported: the bf16 Krylov basis and
preconditioner, the mixed-precision phase, float64 norms, the in-cycle exit,
Krylov recycling across outers and steps, the first-outer pressure presolve,
the ADI momentum predict, Anderson mixing, the extrapolated guess and the
adaptive linear tolerance.  As in the JAX package, the bf16 preconditioner,
the mixed phase, the presolve and the ADI predict act on the structured path
only, and recycling is off on the block path.

Three solve paths, chosen as the JAX package chooses them:

* the stencil system (ops/stencil_system.py): uniform cut-cell meshes with
  the Schur preconditioner, whose pressure block is the structured
  multigrid (``precond_type=1``) or the Chebyshev relaxation (``0``);
* the scalar-coefficient ELL system (ops/ellsys.py): meshes with a banded
  index map (Delaunay, Voronoi, multilevel refined quadtree meshes) with
  the Schur preconditioner and the aggregation AMG or, on multilevel
  meshes, the fine-grid-embedded multigrid;
* the block-ELL system (ops/blockell.py, ops/schur.py): block-Jacobi
  preconditioning (``precond_type=2``) on every mesh, and the Schur
  preconditioner on meshes that fit neither path above (no banded map, or a
  structured mesh too small for the structured multigrid).

On a row-sharded structured mesh (parallel/spatial.py: one process per
rank, each with its block of rows) the same functions step the stencil and
block paths under every option: the shifts and gathers exchange ghost rows,
the ADI predict's column solves take deep ghost rows, and every value behind
a decision (the outer max-diffs, ``check_evolution``'s sums, the CFL max,
FGMRES's dots and norms, the recycled projection, Anderson's normal
equations, the presolve gate) is reduced across the ranks, so every rank
takes the same branches.  A structured grid too small for the structured
multigrid takes the block path there too: with the aggregation AMG its
V-cycle runs replicated on every rank (``ops/amg.py``), without a hierarchy
its Chebyshev pressure relaxation is local.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..ops import ellsys as el
from ..ops import stencil_system as st
from ..ops.amg import (AmgHierarchy, StructuredAmgHierarchy,
                       coarse_level_values, make_pressure_solve)
from ..ops.blockell import block_spmv
from ..ops.fgmres import fgmres_solve, zero_basis
from ..ops.schur import block_jacobi_preconditioner, schur_preconditioner
from ..runtime.device_mesh import DeviceMesh, encode_mesh, resolve_device
from ..runtime.host_reads import read
from ..runtime.state import (
    PRECOND_AMG,
    PRECOND_BLOCK_JACOBI,
    SCHEME_UPWIND,
    SolverConfig,
    SolverParams,
    SolverState,
    initial_state,
)
from .assembly import (assemble_coupled, assemble_ell, assemble_pressure,
                       assemble_stencil, prepare)

_F32_MAX = float(np.finfo(np.float32).max)


def _use_stencil_path(mesh: DeviceMesh, config: SolverConfig, amg) -> bool:
    """The stencil system covers the Schur-preconditioned flows on
    structured meshes; block-Jacobi, and a structured mesh whose hierarchy
    fell back to the aggregation AMG, keep the block-ELL path."""
    if not mesh.structured or config.precond_type == PRECOND_BLOCK_JACOBI:
        return False
    if config.precond_type == PRECOND_AMG:
        return isinstance(amg, StructuredAmgHierarchy)
    return True


def _reduce(mesh: DeviceMesh):
    """The cross-rank sum of a row-sharded mesh, else None."""
    return None if mesh.decomp is None else mesh.decomp.all_reduce_sum


def _max_all(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a max over this rank's cells) maxed over the ranks."""
    return t if mesh.decomp is None else mesh.decomp.all_reduce_max(t)


def _use_banded_path(mesh: DeviceMesh, config: SolverConfig) -> bool:
    return mesh.banded and config.precond_type != PRECOND_BLOCK_JACOBI


def _basis_init(mesh: DeviceMesh, state: SolverState, config: SolverConfig,
                amg) -> tuple | None:
    """Zero Krylov-basis seed of the recycling carry
    (SolverConfig.fgmres_recycle): the shapes fgmres_solve returns for this
    mesh and config, with ``j = 0``, so the first solve starts cold.  None
    on the block path, where recycling is off (as in the JAX package)."""
    if not (_use_stencil_path(mesh, config, amg)
            or _use_banded_path(mesh, config)):
        return None
    bd = torch.bfloat16 if config.fgmres_basis_bf16 else torch.float32
    return zero_basis(config.fgmres_restart, 3 * state.u.shape[0], bd,
                      torch.float32, state.u.device)


def _fgmres_kwargs(config: SolverConfig) -> dict:
    """The solve options shared by every FGMRES call of a step."""
    return dict(restart=config.fgmres_restart,
                max_restarts=config.fgmres_max_restarts,
                stagnation_tol=config.fgmres_stagnation_tol,
                stagnation_limit=config.fgmres_stagnation_limit,
                f64_norms=config.fgmres_f64_norms,
                incycle_window=config.fgmres_incycle_window,
                incycle_tol=config.fgmres_incycle_tol)


def _solve_banded(mesh, state, params, config, amg, n_sweeps, tol, x0,
                  frozen_amg, recycle):
    """Banded path: scalar-coefficient ELL system, banded kernels, Schur
    preconditioner with the aggregation AMG (or the multilevel embedding),
    FGMRES on component-major (3, N) vectors (one transpose each way per
    solve)."""
    es = assemble_ell(mesh, state, params, config)
    ps = (make_pressure_solve(amg, mesh, es,
                              coeff=params.density * state.d_p,
                              cycle_opts=config.cycle_opts(),
                              frozen=frozen_amg)
          if config.precond_type == PRECOND_AMG and amg is not None else None)
    # Momentum depth 8 on this path (the JAX package's choice: a sweep is
    # one fused dot, and the halved iteration count wins).
    ms = config.precond_mom_sweeps if config.precond_mom_sweeps > 0 else 8
    result = fgmres_solve(
        lambda x: el.spmv(es, mesh, x),
        lambda r: el.schur_precond(es, mesh, r, config.precond_omega,
                                   n_sweeps, pressure_solve=ps,
                                   mom_sweeps=ms),
        es.rhs.T.contiguous(), x0.T.contiguous(), tol=tol,
        abstol=config.fgmres_abstol,
        basis_dtype=torch.bfloat16 if config.fgmres_basis_bf16 else None,
        recycle=recycle, return_basis=recycle is not None,
        **_fgmres_kwargs(config))
    return replace(result, x=result.x.T)


def _solve_block(mesh, state, params, config, amg, n_sweeps, tol, x0):
    """Block-ELL path: (N, K, 3, 3) blocks, FGMRES on (N, 3) vectors with
    block-Jacobi or the Schur preconditioner (its pressure block the
    hierarchy's V-cycle for ``precond_type=1``, else Chebyshev).  The
    momentum predict takes ``mom_sweeps`` sweeps on a banded mesh and the
    reference's bare diagonal elsewhere."""
    sys = assemble_coupled(mesh, state, params, config)
    if config.precond_type == PRECOND_BLOCK_JACOBI:
        precond = lambda r: block_jacobi_preconditioner(sys, r)
    else:
        ps = (make_pressure_solve(amg, mesh, sys,
                                  coeff=params.density * state.d_p,
                                  cycle_opts=config.cycle_opts())
              if config.precond_type == PRECOND_AMG and amg is not None
              else None)
        if config.precond_mom_sweeps > 0:
            ms = config.precond_mom_sweeps
        elif mesh.banded:
            ms = config.mom_sweeps(mesh.total_cells)
        else:
            ms = 1
        precond = lambda r: schur_preconditioner(
            sys, mesh, r, config.precond_omega, n_sweeps, pressure_solve=ps,
            mom_sweeps=ms)
    return fgmres_solve(
        lambda x: block_spmv(sys, mesh, x), precond, sys.rhs, x0, tol=tol,
        abstol=config.fgmres_abstol,
        basis_dtype=torch.bfloat16 if config.fgmres_basis_bf16 else None,
        reduce=_reduce(mesh), **_fgmres_kwargs(config))


def _bf16_precond(ss, ps, config, n_sweeps, mom_sweeps):
    """The Schur preconditioner applied in bf16 on the cast coefficients
    (SolverConfig.precond_bf16 and the mixed phase's first phase).  The
    pressure block stays f32 on the f32 system, with a cast in and out, so
    the V-cycle's kernel keeps taking f32."""
    ss16 = st.cast_coeffs(ss, torch.bfloat16)
    if ps is None:
        ps = lambda rhs2: st.chebyshev_pressure_solve2(
            ss, rhs2, config.precond_omega, n_sweeps)
    ps16 = lambda rhs2: ps(rhs2.float()).to(torch.bfloat16)
    return lambda r: st.schur_precond_planar(
        ss16, r.to(torch.bfloat16), config.precond_omega, n_sweeps,
        pressure_solve=ps16, mom_sweeps=mom_sweeps,
        mom_adi=config.precond_mom_adi).float()


def _presolve(ss, b2, x0p, ps, config, n_sweeps, mom_sweeps, tol,
              presolve_ok):
    """First-outer pressure presolve (SolverConfig.presolve_pressure_iters):
    when the initial residual exceeds ``presolve_threshold`` x the Krylov
    target, move x0 by one Schur correction with a CG pressure block
    (:func:`st.schur_guess`), kept only if one more matvec shows it reduced
    the residual.  The gate reads the two norms to the host (one read); the
    guard stays on the device.  ``presolve_ok`` False skips it (the fused
    step's later outers), None does not gate (host mode)."""
    if presolve_ok is False:
        return x0p
    r0 = b2 - st.spmv_planar(ss, x0p)
    r0n_t = st.norm(ss, r0)
    r0n, bn = read(torch.stack([r0n_t, st.norm(ss, b2)]))
    target = max(np.float32(tol) * bn, np.float32(config.fgmres_abstol))
    if not r0n > np.float32(config.presolve_threshold) * target:
        return x0p
    corr = st.schur_guess(ss, r0, config.precond_omega, n_sweeps,
                          pressure_solve=ps,
                          cg_iters=config.presolve_pressure_iters,
                          mom_sweeps=mom_sweeps,
                          mom_adi=config.precond_mom_adi)
    rn = r0 - st.spmv_planar(ss, corr)
    return torch.where(st.norm(ss, rn) < r0n_t, x0p + corr, x0p)


def _assemble_and_solve(mesh, state, params, config, amg, n_sweeps,
                        tol=None, x_guess=None, presolve_ok=None,
                        frozen_amg=None, recycle=None):
    """Assemble the coupled system and run one preconditioned FGMRES solve:
    in stencil form on (3, ny, nx) component planes, in ELL form on (3, N)
    vectors or in block-ELL form on (N, 3) vectors (see the module
    docstring for which mesh and option takes which).

    ``tol``: the relative tolerance (default config.fgmres_tol);
    ``x_guess``: the (N, 3) initial guess (default the current fields);
    ``presolve_ok``: gate of the presolve (see :func:`_presolve`);
    ``frozen_amg``: the step's frozen coarse operators; ``recycle``: a
    previous solve's basis, and the result then carries its own."""
    tol = config.fgmres_tol if tol is None else tol
    x0 = (x_guess if x_guess is not None else
          torch.cat([state.u, state.p[:, None]], dim=1))
    if not _use_stencil_path(mesh, config, amg):
        if _use_banded_path(mesh, config):
            return _solve_banded(mesh, state, params, config, amg, n_sweeps,
                                 tol, x0, frozen_amg, recycle)
        return _solve_block(mesh, state, params, config, amg, n_sweeps, tol,
                            x0)
    ss = assemble_stencil(mesh, state, params, config)
    ps = (st.make_pressure_solve2(
              amg, ss, n_cycles=config.pressure_vcycles(mesh.total_cells),
              frozen=frozen_amg)
          if config.precond_type == PRECOND_AMG else None)
    ms = config.mom_sweeps(mesh.total_cells)
    precond = lambda r: st.schur_precond_planar(
        ss, r, config.precond_omega, n_sweeps, pressure_solve=ps,
        mom_sweeps=ms, mom_adi=config.precond_mom_adi)
    precond16 = (_bf16_precond(ss, ps, config, n_sweeps, ms)
                 if config.precond_bf16 or config.fgmres_mixed_phase
                 else None)
    pc = precond16 if config.precond_bf16 else precond
    matvec = lambda x: st.spmv_planar(ss, x)
    b2 = st.to_planar(ss, ss.rhs)
    x0p = st.to_planar(ss, x0)
    if config.presolve_pressure_iters > 0:
        x0p = _presolve(ss, b2, x0p, ps, config, n_sweeps, ms, tol,
                        presolve_ok)
    kw = _fgmres_kwargs(config)
    bd = torch.bfloat16 if config.fgmres_basis_bf16 else None
    if config.fgmres_mixed_phase:
        # Phase 1: bf16 basis and preconditioner down to ~1e-3 relative,
        # with no recycling; phase 2: the full tolerance in f32 from the
        # phase-1 iterate (it derives its own true residual).
        r1 = fgmres_solve(matvec, precond16, b2, x0p,
                          tol=max(float(np.float32(tol) * np.float32(30.0)),
                                  1e-3),
                          abstol=config.fgmres_abstol * 100.0,
                          basis_dtype=torch.bfloat16, reduce=_reduce(mesh),
                          **kw)
        x0p = r1.x
    result = fgmres_solve(matvec, pc, b2, x0p, tol=tol,
                          abstol=config.fgmres_abstol, basis_dtype=bd,
                          recycle=recycle, return_basis=recycle is not None,
                          reduce=_reduce(mesh), **kw)
    if config.fgmres_mixed_phase:
        result = replace(result, iterations=r1.iterations + result.iterations)
    return replace(result, x=st.from_planar(ss, result.x))


def _anderson_mix(g, x, Gh, Fh, it: int, config: SolverConfig,
                  reduce=None):
    """One Anderson (type-II) mixing step of the outer fixed point
    x -> G(x): ``g`` = G(x_k) and ``x`` = x_k flattened, ``Gh`` / ``Fh`` the
    last depth+1 map outputs / residuals, newest first.  The depth x depth
    normal equations are Tikhonov-regularized and solved on the device
    (``solve_ex``: no singularity check, so no host read); the update falls
    back to ``g`` when the coefficients are not finite or exceed
    ``anderson_gamma_max``.  Returns (x_next, Gh, Fh).

    ``reduce``: the vectors and history hold one rank's rows; the Gram
    matrix and right-hand side are summed across the ranks (one
    reduction), so every rank solves the same system and takes the same
    fallback."""
    m = config.anderson_depth
    f = g - x
    Gh = torch.cat([g[None], Gh[:-1]])
    Fh = torch.cat([f[None], Fh[:-1]])
    navail = min(it, m)
    if navail == 0:
        return g, Gh, Fh
    mask = torch.arange(1, m + 1, device=g.device) <= navail
    dF = torch.where(mask[:, None], Fh[0][None] - Fh[1:], 0.0)    # (m, D)
    dG = torch.where(mask[:, None], Gh[0][None] - Gh[1:], 0.0)
    gram = dF @ dF.T                                              # (m, m)
    rhs = dF @ f
    if reduce is not None:
        both = reduce(torch.cat([gram.reshape(-1), rhs]))
        gram, rhs = both[:m * m].reshape(m, m), both[m * m:]
    # Masked rows become identity rows with zero rhs -> gamma_i = 0.
    eye = torch.eye(m, dtype=gram.dtype, device=g.device)
    scale = torch.clamp(torch.trace(gram) / m, min=1e-30)
    gram = gram + 1e-8 * scale * eye
    gram = torch.where(mask[:, None] & mask[None, :], gram, eye)
    rhs = torch.where(mask, rhs, 0.0)
    gamma = torch.linalg.solve_ex(gram, rhs)[0]
    ok = torch.all(torch.isfinite(gamma)) & (
        torch.sqrt(torch.sum(gamma * gamma)) <= config.anderson_gamma_max)
    return torch.where(ok, g - gamma @ dG, g), Gh, Fh


def _extrapolated_guess(state: SolverState, params: SolverParams):
    """First outer's temporal predictor (SolverConfig.extrapolate_guess):
    u + (dt/dt_old)(u - u_old_old) beside the current p, as (N, 3)."""
    beta = params.dt / torch.clamp(params.dt_old, min=1e-30)
    u_g = state.u + beta * (state.u - state.u_old_old)
    return torch.cat([u_g, state.p[:, None]], dim=1)


def _lin_tol(config: SolverConfig, it: int):
    """Inexact-Newton forcing (SolverConfig.adaptive_linear_tol):
    max(fgmres_tol, 10^-(3+it)); None keeps fgmres_tol."""
    if not config.adaptive_linear_tol:
        return None
    return max(config.fgmres_tol, 10.0 ** -(3 + it))


def _relaxed_update(state, params, config, x, it: int, aa, reduce=None):
    """Under-relaxed field update (update_fields_from_coupled.wgsl) with the
    alpha ramp, then Anderson mixing when ``aa`` holds its history
    (``reduce``: see :func:`_anderson_mix`).  Returns (u_new, p_new, aa)."""
    alpha_u = params.alpha_u
    if config.alpha_u_final > 0 and it >= config.alpha_ramp_after:
        alpha_u = torch.tensor(config.alpha_u_final, dtype=torch.float32,
                               device=state.u.device)
    u_new = state.u + alpha_u * (x[:, 0:2] - state.u)
    p_new = state.p + params.alpha_p * (x[:, 2] - state.p)
    if aa is not None:
        g = torch.cat([u_new, p_new[:, None]], dim=1).reshape(-1)
        x_cur = torch.cat([state.u, state.p[:, None]], dim=1).reshape(-1)
        x_next, Gh, Fh = _anderson_mix(g, x_cur, aa[0], aa[1], it, config,
                                       reduce)
        xn = x_next.reshape(-1, 3)
        u_new, p_new, aa = xn[:, 0:2], xn[:, 2], (Gh, Fh)
    return u_new, p_new, aa


def _anderson_init(mesh: DeviceMesh, config: SolverConfig, device):
    """Zero Anderson history (this rank's rows on a row-sharded mesh)."""
    if not config.anderson_depth:
        return None
    z = torch.zeros((config.anderson_depth + 1, mesh.num_cells * 3),
                    dtype=torch.float32, device=device)
    return z, z


def _plateau_update(du_ok, dp_ref, diff_u, diff_p, config: SolverConfig):
    """Pressure-plateau patience bookkeeping
    (SolverConfig.outer_pressure_patience), on host scalars.

    Counts consecutive outers with du below 2x tol; the exit is gated on
    the pressure residual stalling: dp must not have halved across the
    patience window (``dp_ref`` = dp at window start).  A window that
    expires while pressure still improves restarts.
    Returns (du_ok, dp_ref, plateau)."""
    if du_ok == 0:
        dp_ref = diff_p
    du_ok = du_ok + 1 if diff_u < 2.0 * config.outer_tol_u else 0
    window_full = du_ok >= config.outer_pressure_patience
    p_stalled = diff_p > 0.5 * dp_ref
    plateau = config.outer_pressure_patience > 0 and window_full and p_stalled
    if window_full and not p_stalled:
        du_ok = 0
    return du_ok, dp_ref, plateau


def check_evolution(state: SolverState, config: SolverConfig,
                    valid: torch.Tensor | None = None,
                    decomp=None) -> SolverState:
    """Steady-state / degeneracy classifier (reference
    coupled_solver.rs:501-580): current velocity variance plus the
    RMSE-vs-previous-step evolution test and consecutive-hit counters.
    ``valid`` masks out structured-layout solid cells; ``decomp``: the
    fields are one rank's rows, and the sums are summed across the ranks
    (one reduction)."""
    u = state.u
    w = torch.ones((u.shape[0],), dtype=u.dtype, device=u.device) \
        if valid is None else valid
    sums = torch.cat([
        torch.sum(w)[None], torch.sum(u * w[:, None], dim=0),
        torch.sum(u * u * w[:, None], dim=0),
        torch.sum(torch.sum((u - state.prev_u) ** 2, dim=1) * w)[None]])
    if decomp is not None:
        sums = decomp.all_reduce_sum(sums)
    n = sums[0]
    mean = sums[1:3] / n
    var = sums[3:5] / n - mean * mean
    var = torch.clamp(var, min=0.0)

    rmse = torch.sqrt(sums[5] / n)

    evolving = rmse >= config.evolution_threshold
    uniform = (var[0] < config.variance_threshold) \
        & (var[1] < config.variance_threshold)

    zero = torch.zeros_like(state.degenerate_count)
    degen = torch.where(~evolving & uniform, state.degenerate_count + 1, zero)
    steady = torch.where(~evolving & ~uniform, state.steady_count + 1, zero)
    diverged = torch.isnan(state.outer_residual_u) \
        | torch.isnan(state.outer_residual_p)
    stop = state.should_stop | (degen > config.stop_count) \
        | (steady > config.stop_count) | diverged
    return replace(state, prev_u=u, degenerate_count=degen,
                   steady_count=steady, should_stop=stop)


def step(mesh: DeviceMesh, state: SolverState, params: SolverParams,
         config: SolverConfig, amg=None, krylov=None):
    """Advance one timestep (reference GpuSolver::step -> step_coupled).

    ``amg``: the hierarchy used when ``config.precond_type == PRECOND_AMG``
    (see ops/amg.py:build_hierarchy_for_mesh; a mesh too small for any
    hierarchy takes the Chebyshev pressure relaxation, as in the JAX
    package).

    ``krylov``: with ``config.fgmres_recycle >= 2``, the previous step's
    Krylov basis tuple (or a zero seed): the first outer's solve then
    recycles it, and the step returns ``(state, krylov')`` instead of
    ``state``.

    On a row-sharded mesh every rank calls it with its own rows of the
    state (the same ``amg``, built on the whole mesh) and gets its own rows
    back."""
    n_sweeps = config.pressure_sweeps(mesh.total_cells)
    dev = state.u.device

    # History rotation (coupled_solver.rs:43-71), initial prepare (:74-107).
    state = replace(state, u_old_old=state.u_old, u_old=state.u)
    state = prepare(mesh, state, params, config)

    # Per-step frozen coarse multigrid operators from a pressure-only
    # assembly at step entry (SolverConfig.amg_freeze_coarse): the
    # structured multigrid on the stencil path, the aggregation AMG on the
    # banded path; the multilevel embedding and the block path rebuild them
    # every outer, as in the JAX package.
    frozen_amg = None
    if (config.amg_freeze_coarse and amg is not None
            and config.precond_type == PRECOND_AMG):
        if _use_stencil_path(mesh, config, amg):
            P_diag, P_off = assemble_pressure(mesh, state, params)
            ny, nx = mesh.grid_shape
            frozen_amg = st.coarse_level_values2_planes(
                amg, P_diag.reshape(ny, nx),
                P_off[:, :4].T.reshape(4, ny, nx).contiguous(), mesh.decomp)
        elif mesh.banded and isinstance(amg, AmgHierarchy):
            P_diag, P_off = assemble_pressure(mesh, state, params)
            frozen_amg = coarse_level_values(amg, P_diag, P_off)

    aa = _anderson_init(mesh, config, dev)
    # Krylov recycling across the outers (SolverConfig.fgmres_recycle): the
    # previous solve's basis is carried; outer 0 sees the zero seed, or the
    # previous step's basis when recycling across steps.
    kry = (_basis_init(mesh, state, config, amg) if config.fgmres_recycle
           else None)
    cross_step = (config.fgmres_recycle >= 2 and krylov is not None
                  and kry is not None)
    if cross_step:
        kry = krylov

    max_iters = max(config.n_outer_correctors, 10)
    prev_du = prev_dp = dp_ref = _F32_MAX
    du_ok = 0
    li = lt = 0
    lr = 0.0
    for it in range(max_iters):
        # Re-prepare on later iterations / higher-order schemes
        # (coupled_solver.rs:166-189).
        if config.scheme != SCHEME_UPWIND or it > 0:
            state = prepare(mesh, state, params, config)
        x_guess = (_extrapolated_guess(state, params)
                   if config.extrapolate_guess and it == 0 else None)
        result = _assemble_and_solve(mesh, state, params, config, amg,
                                     n_sweeps, _lin_tol(config, it),
                                     x_guess=x_guess, presolve_ok=it == 0,
                                     frozen_amg=frozen_amg, recycle=kry)
        if kry is not None:
            kry = result.basis

        u_new, p_new, aa = _relaxed_update(state, params, config, result.x,
                                           it, aa, _reduce(mesh))
        diffs = _max_all(mesh, torch.stack([
            torch.max(torch.abs(u_new - state.u)),
            torch.max(torch.abs(p_new - state.p))]))
        state = replace(state, u=u_new, p=p_new,
                        outer_residual_u=diffs[0], outer_residual_p=diffs[1],
                        outer_iters=torch.tensor(it + 1, dtype=torch.int32,
                                                 device=dev))
        li, lr = result.iterations, result.residual
        lt += li

        # Convergence + stagnation (coupled_solver.rs:396-479).
        du, dp = (float(v) for v in read(diffs))
        converged = du < config.outer_tol_u and dp < config.outer_tol_p
        rel_u = abs((du - prev_du) / max(abs(prev_du), 1e-14))
        rel_p = abs((dp - prev_dp) / max(abs(prev_dp), 1e-14))
        stagnated = (rel_u < config.outer_stagnation_factor
                     and rel_p < config.outer_stagnation_factor and it > 2)
        du_ok, dp_ref, plateau = _plateau_update(du_ok, dp_ref, du, dp,
                                                 config)
        prev_du, prev_dp = du, dp
        if (converged and it > 0) or stagnated or plateau:
            break

    i32 = dict(dtype=torch.int32, device=dev)
    state = replace(state, time=state.time + params.dt,
                    linear_iters=torch.tensor(li, **i32),
                    linear_residual=torch.tensor(lr, dtype=torch.float32,
                                                 device=dev),
                    linear_iters_total=torch.tensor(lt, **i32))
    state = check_evolution(state, config, valid=mesh.c_valid,
                            decomp=mesh.decomp)
    if cross_step:
        return state, kry
    return state


# ----------------------------------------------------------------------
# Host-controlled variant (the JAX package's ``mode="host"``): the outer
# loop with its own exits, one outer corrector per call of
# :func:`outer_iteration`.  Unlike :func:`step` it rebuilds the coarse
# operators every outer, does not gate the presolve to the first outer and
# does not recycle Krylov bases, as in the JAX package.


def begin_step(mesh: DeviceMesh, state: SolverState, params: SolverParams,
               config: SolverConfig) -> SolverState:
    state = replace(state, u_old_old=state.u_old, u_old=state.u,
                    linear_iters_total=torch.zeros(
                        (), dtype=torch.int32, device=state.u.device))
    return prepare(mesh, state, params, config)


def outer_iteration(mesh: DeviceMesh, state: SolverState,
                    params: SolverParams, config: SolverConfig, amg=None,
                    do_prepare: bool = True, lin_tol=None, aa=None,
                    it: int = 0):
    """One outer corrector: (prepare) -> assemble -> solve -> update.
    Returns (state, diff_u, diff_p, aa) with the max-diffs as 0-d device
    tensors; ``aa`` is the Anderson history pair (or None)."""
    n_sweeps = config.pressure_sweeps(mesh.total_cells)
    if do_prepare:
        state = prepare(mesh, state, params, config)
    x_guess = (_extrapolated_guess(state, params)
               if config.extrapolate_guess and it == 0 else None)
    result = _assemble_and_solve(mesh, state, params, config, amg, n_sweeps,
                                 lin_tol, x_guess=x_guess)
    u_new, p_new, aa = _relaxed_update(state, params, config, result.x, it,
                                       aa if config.anderson_depth else None,
                                       _reduce(mesh))
    diff_u, diff_p = _max_all(mesh, torch.stack([
        torch.max(torch.abs(u_new - state.u)),
        torch.max(torch.abs(p_new - state.p))]))
    i32 = dict(dtype=torch.int32, device=state.u.device)
    state = replace(state, u=u_new, p=p_new,
                    outer_residual_u=diff_u, outer_residual_p=diff_p,
                    linear_iters=torch.tensor(result.iterations, **i32),
                    linear_residual=torch.tensor(
                        result.residual, dtype=torch.float32,
                        device=state.u.device),
                    linear_iters_total=(state.linear_iters_total
                                        + result.iterations))
    return state, diff_u, diff_p, aa


def finish_step(mesh: DeviceMesh, state: SolverState, params: SolverParams,
                config: SolverConfig) -> SolverState:
    state = replace(state, time=state.time + params.dt)
    return check_evolution(state, config, valid=mesh.c_valid,
                           decomp=mesh.decomp)


def step_host(mesh: DeviceMesh, state: SolverState, params: SolverParams,
              config: SolverConfig, amg=None,
              verbose: bool = False) -> SolverState:
    """Host-controlled timestep with per-outer convergence reads; raises
    ``FloatingPointError`` when an outer's max-diffs are NaN."""
    state = begin_step(mesh, state, params, config)
    max_iters = max(config.n_outer_correctors, 10)
    prev_du = prev_dp = float("inf")
    du_ok = 0
    dp_ref = float("inf")
    aa = _anderson_init(mesh, config, state.u.device)
    for it in range(max_iters):
        do_prep = it > 0 or config.scheme != SCHEME_UPWIND
        state, du, dp, aa = outer_iteration(
            mesh, state, params, config, amg, do_prepare=do_prep,
            lin_tol=_lin_tol(config, it), aa=aa, it=it)
        du, dp = (float(v) for v in read(torch.stack([du, dp])))
        if verbose:
            print(f"  outer {it}: du={du:.2e} dp={dp:.2e} "
                  f"lin_it={int(state.linear_iters)} "
                  f"lin_res={float(state.linear_residual):.2e}")
        state = replace(state, outer_iters=torch.tensor(
            it + 1, dtype=torch.int32, device=state.u.device))
        if np.isnan(du) or np.isnan(dp):
            raise FloatingPointError(
                f"coupled solver diverged: NaN outer residuals at iter {it}")
        if it > 0 and du < config.outer_tol_u and dp < config.outer_tol_p:
            break
        rel_u = abs(du - prev_du) / max(abs(prev_du), 1e-14)
        rel_p = abs(dp - prev_dp) / max(abs(prev_dp), 1e-14)
        if it > 2 and rel_u < config.outer_stagnation_factor \
                and rel_p < config.outer_stagnation_factor:
            break
        # The fused path's pressure-stall gate, on host floats.
        if du_ok == 0:
            dp_ref = dp
        du_ok = du_ok + 1 if du < 2.0 * config.outer_tol_u else 0
        if config.outer_pressure_patience > 0 \
                and du_ok >= config.outer_pressure_patience:
            if dp > 0.5 * dp_ref:
                break
            du_ok = 0
        prev_du, prev_dp = du, dp
    return finish_step(mesh, state, params, config)


def _max_vel(mesh: DeviceMesh, u: torch.Tensor) -> torch.Tensor:
    return _max_all(mesh, torch.max(torch.linalg.vector_norm(u, dim=1)))


def multi_step(mesh: DeviceMesh, state: SolverState, params: SolverParams,
               config: SolverConfig, num_steps: int, amg=None):
    """N steps of :func:`step`; a stopped state (degenerate, steady or
    diverged) is frozen for the rest.  ``dt_old`` takes each step's dt, so
    BDF2's ratio returns to 1 after a dt change.  Returns (state, metrics):
    per-step 1-D device tensors, read by nobody until the caller does."""
    rows = []
    for _ in range(num_steps):
        if not bool(read(state.should_stop)):
            state = step(mesh, state, params, config, amg)
        rows.append({"time": state.time, "outer_iters": state.outer_iters,
                     "linear_iters": state.linear_iters,
                     "linear_iters_total": state.linear_iters_total,
                     "linear_residual": state.linear_residual,
                     "outer_residual_u": state.outer_residual_u,
                     "max_vel": _max_vel(mesh, state.u),
                     "should_stop": state.should_stop})
        params = replace(params, dt_old=params.dt)
    return state, _stack_rows(rows)


def multi_step_adaptive(mesh: DeviceMesh, state: SolverState,
                        params: SolverParams, config: SolverConfig,
                        num_steps: int, target_cfl: float = 0.5,
                        min_cell_size: float = 0.05, amg=None):
    """N adaptive-dt steps: the reference app's CFL controller
    (ui/app.rs:878-909) on the device — dt = target_cfl * h / max|u|
    clipped to [1e-5, 0.1], at most 1.2x the last dt, held while
    max|u| <= 1e-6.  Returns (state, params, metrics)."""
    rows = []
    for _ in range(num_steps):
        max_vel = _max_vel(mesh, state.u)
        new_dt = torch.clamp(
            torch.full_like(max_vel, target_cfl * min_cell_size)
            / torch.clamp(max_vel, min=1e-6), 1e-5, 0.1)
        new_dt = torch.minimum(new_dt, params.dt * 1.2)
        new_dt = torch.where(max_vel > 1e-6, new_dt, params.dt)
        params = replace(params, dt_old=params.dt, dt=new_dt)
        if not bool(read(state.should_stop)):
            state = step(mesh, state, params, config, amg)
        rows.append({"time": state.time, "dt": params.dt, "max_vel": max_vel,
                     "outer_iters": state.outer_iters,
                     "should_stop": state.should_stop})
    return state, params, _stack_rows(rows)


def _stack_rows(rows: list) -> dict:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]} \
        if rows else {}


class CoupledSolver:
    """Host-side façade with the reference's headless API contract
    (SURVEY.md §3.5):
        GpuSolver::new(&mesh) -> set_* -> set_u/set_p
        -> initialize_history -> loop { step(); get_u()/get_p() }

    ``device``: where the solver runs; None means CUDA, and raises when no
    GPU is present (pass ``device="cpu"`` for the plain PyTorch path)."""

    def __init__(self, mesh, config: SolverConfig | None = None,
                 params: SolverParams | None = None, device=None,
                 pad_rows_to: int = 1, pad_cols_to: int = 1):
        self.device = resolve_device(device)
        self.host_mesh = mesh
        self.mesh = encode_mesh(mesh, device=self.device,
                                pad_rows_to=pad_rows_to,
                                pad_cols_to=pad_cols_to)
        self.config = config or SolverConfig()
        self.params = params or SolverParams.default(device=self.device)
        self.state = initial_state(self.mesh)
        self._amg = None
        self._krylov = None   # cross-step recycling (fgmres_recycle >= 2)

    def _f32(self, v) -> torch.Tensor:
        return torch.tensor(float(v), dtype=torch.float32, device=self.device)

    # --- setters (reference solver.rs:36-95) ---
    def set_dt(self, dt):
        self.params = replace(self.params, dt_old=self.params.dt,
                              dt=self._f32(dt))

    def set_viscosity(self, v):
        self.params = replace(self.params, viscosity=self._f32(v))

    def set_density(self, d):
        self.params = replace(self.params, density=self._f32(d))

    def set_alpha_u(self, a):
        self.params = replace(self.params, alpha_u=self._f32(a))

    def set_alpha_p(self, a):
        self.params = replace(self.params, alpha_p=self._f32(a))

    def set_inlet_velocity(self, v):
        self.params = replace(self.params, inlet_velocity=self._f32(v))

    def set_ramp_time(self, t):
        self.params = replace(self.params, ramp_time=self._f32(t))

    def set_inlet_profile(self, fn):
        """Per-face inlet profile: u_inlet(face) = inlet_velocity * fn(x, y)
        (e.g. the Schäfer–Turek parabola).  ``None`` clears it."""
        if fn is None:
            self.mesh = replace(self.mesh, f_inlet_scale=None,
                                ck_inlet_scale=None)
            return
        fx = self.mesh.f_cx.cpu().numpy()
        fy = self.mesh.f_cy.cpu().numpy()
        scale = np.asarray(fn(fx, fy), np.float32)
        ckf = self.mesh.ck_face.cpu().numpy()
        self.mesh = replace(
            self.mesh,
            f_inlet_scale=torch.as_tensor(scale, device=self.device),
            ck_inlet_scale=torch.as_tensor(scale[ckf], device=self.device))

    def set_scheme(self, scheme: int):
        self.config = replace(self.config, scheme=int(scheme))

    def set_time_scheme(self, ts: int):
        self.config = replace(self.config, time_scheme=int(ts))

    def set_precond_type(self, pt: int):
        self.config = replace(self.config, precond_type=int(pt))

    def set_n_outer_correctors(self, n: int):
        self.config = replace(self.config, n_outer_correctors=int(n))

    # --- field IO (solver.rs:97-128, 241-294); host-mesh cell order ---
    def set_u(self, u):
        u = torch.as_tensor(np.asarray(u, dtype=np.float32).reshape(-1, 2))
        u = self.mesh.from_host_order(u)
        self.state = replace(self.state, u=u, u_old=u, u_old_old=u, prev_u=u)

    def set_p(self, p):
        p = torch.as_tensor(np.asarray(p, dtype=np.float32).reshape(-1))
        self.state = replace(self.state, p=self.mesh.from_host_order(p))

    def initialize_history(self):
        self.state = replace(self.state, u_old=self.state.u,
                             u_old_old=self.state.u, prev_u=self.state.u)

    def get_u(self) -> np.ndarray:
        return self.mesh.to_host_order(self.state.u).cpu().numpy()

    def max_velocity_device(self) -> torch.Tensor:
        """max |u| as an unfetched 0-d device tensor: a host loop hands it
        to :class:`..runtime.async_reader.AsyncFieldReader` and overlaps the
        4-byte read with the next step (reference async_buffer.rs)."""
        return _max_vel(self.mesh, self.state.u)

    def get_p(self) -> np.ndarray:
        return self.mesh.to_host_order(self.state.p).cpu().numpy()

    def get_d_p(self) -> np.ndarray:
        return self.mesh.to_host_order(self.state.d_p).cpu().numpy()

    # --- stepping ---
    def _get_amg(self):
        if self.config.precond_type != PRECOND_AMG:
            return None
        if self._amg is None:
            from ..ops.amg import build_hierarchy_for_mesh
            self._amg = build_hierarchy_for_mesh(
                self.mesh, agg_passes=self.config.amg_agg_passes)
        return self._amg

    def step(self, mode: str = "fused"):
        """Advance one timestep.  ``mode="fused"`` runs :func:`step` (the
        outer loop in Python with one host read per outer corrector);
        ``mode="host"`` runs :func:`step_host`."""
        amg = self._get_amg()
        if mode == "host":
            self.state = step_host(self.mesh, self.state, self.params,
                                   self.config, amg)
        elif mode != "fused":
            raise ValueError(f"unknown step mode {mode!r}")
        elif self.config.fgmres_recycle >= 2:
            # Cross-step Krylov recycling: the basis tuple is carried here,
            # outside SolverState (2(m+1)·3N floats: not checkpointed).  On
            # the block path there is none, and step() returns the state.
            if self._krylov is None:
                self._krylov = _basis_init(self.mesh, self.state,
                                           self.config, amg)
            if self._krylov is None:
                self.state = step(self.mesh, self.state, self.params,
                                  self.config, amg)
            else:
                self.state, self._krylov = step(self.mesh, self.state,
                                                self.params, self.config,
                                                amg, self._krylov)
        else:
            self.state = step(self.mesh, self.state, self.params,
                              self.config, amg)
        # The step just taken becomes the BDF2 history step.
        if self.params.dt_old is not self.params.dt:
            self.params = replace(self.params, dt_old=self.params.dt)

    def run(self, num_steps: int) -> dict:
        """Run N steps through :func:`multi_step` (none once
        ``should_stop``); returns per-step metrics as host arrays.  As in
        the JAX package it does not carry the cross-step Krylov basis, so
        ``fgmres_recycle=2`` recycles only across the outers of a step."""
        self.state, metrics = multi_step(self.mesh, self.state, self.params,
                                         self.config, num_steps,
                                         self._get_amg())
        if num_steps > 0:
            self.params = replace(self.params, dt_old=self.params.dt)
        return {k: read(v) for k, v in metrics.items()}

    # --- checkpoint/resume (runtime/checkpoint.py) ---
    def save_checkpoint(self, path):
        from ..runtime.checkpoint import save_checkpoint
        save_checkpoint(path, self.state, self.params)

    def load_checkpoint(self, path):
        from ..runtime.checkpoint import load_checkpoint
        state, params = load_checkpoint(path, device=self.device)
        self.state = state
        if params is not None:
            self.params = params

    # --- status (reference structs.rs should_stop / counters) ---
    @property
    def should_stop(self) -> bool:
        return bool(read(self.state.should_stop))

    @property
    def degenerate_count(self) -> int:
        return int(read(self.state.degenerate_count))

    @property
    def steady_state_count(self) -> int:
        return int(read(self.state.steady_count))

