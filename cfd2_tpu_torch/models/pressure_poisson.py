"""Segregated pressure-Poisson assembly and the SIMPLE stepper.

Port of ``cfd2_tpu.models.pressure_poisson`` (the reference's segregated
kernel, shaders/pressure_assembly.wgsl:56-210): a scalar
pressure-correction system with RHS = -sum(mass fluxes) and a
magnitude-limited, 0.5-under-relaxed non-orthogonal correction from the
stored pressure gradients.  The coupled solver (models/coupled.py)
supersedes it, as in the reference; :func:`simple_step` completes the
classical SIMPLE capability around it:

  1. momentum predictor: A_uu u* = b_u - G p (BiCGStab), the momentum block
     of the coupled assembly with the current-pressure gradient on the RHS;
  2. pressure correction: P p' = -div(flux(u*)) (CG);
  3. correct u -= d_p grad p' (Green-Gauss), p += alpha_p p'.

Boundary conditions: outlet Dirichlet p=0; inlet/wall Neumann (zero flux).

On a row-sharded structured mesh (parallel/spatial.py) every gather
exchanges ghost rows, the Krylov dots and the max-diffs are reduced across
the ranks, and each rank returns its own rows.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..runtime.device_mesh import DeviceMesh
from ..runtime.state import SolverParams, SolverState


def assemble_pressure_poisson(mesh: DeviceMesh, state: SolverState,
                              params: SolverParams):
    """Returns (P_diag (N,), P_off (N,K), rhs (N,)) for the pressure
    correction equation."""
    mask = mesh.ck_mask
    is_b = mesh.ck_is_boundary
    internal = mask * (1.0 - is_b)
    bdry = mesh.ck_boundary

    flux_out = mesh.slot_fluxes(state.fluxes)          # (N, K) outward
    rhs = -torch.sum(flux_out * mask, dim=1)

    # Laplacian coefficients: rho * d_p_face * A / |d| (plain distance,
    # pressure_assembly.wgsl:120-127).  One gather for d_p and grad_p.
    g = mesh.gather(torch.cat([state.d_p[:, None], state.grad_p], dim=1))
    dp_this = state.d_p[:, None]
    dp_other = g[..., 0]
    lam = mesh.ck_lam
    dp_face = lam * dp_this + (1.0 - lam) * dp_other
    coeff = params.density * dp_face * mesh.ck_area / mesh.ck_dist
    P_off = -coeff * internal
    diag = torch.sum(coeff * internal, dim=1)

    # Non-orthogonal correction (pressure_assembly.wgsl:146-189):
    # k = S - d * (A/|d|), clamped to |k| <= A/2; correction flux =
    # 0.5 * rho * dp_face * (grad_p_face . k), subtracted from the RHS.
    s_x = mesh.ck_nx * mesh.ck_area
    s_y = mesh.ck_ny * mesh.ck_area
    a_over_d = mesh.ck_area / mesh.ck_dist
    k_x = s_x - mesh.ck_dcdx * a_over_d
    k_y = s_y - mesh.ck_dcdy * a_over_d
    k_mag = torch.sqrt(k_x * k_x + k_y * k_y)
    k_lim = 0.5 * mesh.ck_area
    scale = torch.where(k_mag > k_lim,
                        k_lim / torch.clamp(k_mag, min=1e-30), 1.0)
    k_x = k_x * scale
    k_y = k_y * scale

    gp_this = state.grad_p[:, None, :]
    gp_other = g[..., 1:3]
    # Weight toward the neighbor by d_own/total (wgsl:174-182) = 1 - ck_lam.
    w = 1.0 - lam
    gp_f_x = gp_this[..., 0] + w * (gp_other[..., 0] - gp_this[..., 0])
    gp_f_y = gp_this[..., 1] + w * (gp_other[..., 1] - gp_this[..., 1])
    corr = 0.5 * params.density * dp_face * (gp_f_x * k_x + gp_f_y * k_y)
    rhs = rhs - torch.sum(corr * internal, dim=1)

    # Outlet Dirichlet (wgsl:191-201): coeff from cell center to face center.
    is_outlet = (is_b > 0) & (bdry == 2)
    coeff_out = params.density * dp_this * mesh.ck_area / mesh.ck_dist
    diag = diag + torch.sum(torch.where(is_outlet, coeff_out, 0.0), dim=1)

    # Masked solid cells: identity rows.
    diag = torch.where(mesh.c_valid > 0, diag, 1.0)
    return diag, P_off, rhs * mesh.c_valid


def _green_gauss_scalar(mesh: DeviceMesh, s: torch.Tensor,
                        outlet_dirichlet: bool = True) -> torch.Tensor:
    """Green-Gauss gradient of a cell scalar; outlet faces read 0 (the
    pressure-correction BC), other boundaries zero-normal-gradient."""
    mask = mesh.ck_mask
    is_b = mesh.ck_is_boundary
    bdry = mesh.ck_boundary
    lam = mesh.ck_lam
    s_this = s[:, None]
    f_internal = lam * s_this + (1.0 - lam) * mesh.gather(s)
    f_bdry = torch.where((bdry == 2) & outlet_dirichlet, 0.0, s_this)
    s_face = torch.where(is_b > 0, f_bdry, f_internal) * mask
    inv_vol = 1.0 / mesh.c_vol
    return torch.stack([
        torch.sum(s_face * mesh.ck_nx * mesh.ck_area, dim=1) * inv_vol,
        torch.sum(s_face * mesh.ck_ny * mesh.ck_area, dim=1) * inv_vol,
    ], dim=1)


def simple_step(mesh: DeviceMesh, state: SolverState, params: SolverParams,
                config, n_correctors: int = 2,
                mom_tol: float = 1e-6, p_tol: float = 1e-6):
    """One segregated SIMPLE timestep; returns the advanced state.  Reuses
    the coupled assembly's momentum block, so the discretization (upwind /
    deferred correction, boundary conditions, time scheme) is the coupled
    path's."""
    from ..ops.blockell import scalar_spmv
    from ..ops.krylov import bicgstab_solve, cg_solve
    from .assembly import assemble_coupled, prepare
    from .coupled import _max_all, _reduce, check_evolution

    reduce = _reduce(mesh)
    dev = state.u.device
    i32 = dict(dtype=torch.int32, device=dev)
    state = replace(state, u_old_old=state.u_old, u_old=state.u,
                    linear_iters_total=torch.zeros((), **i32))

    for _ in range(n_correctors):
        state = prepare(mesh, state, params, config)
        sys = assemble_coupled(mesh, state, params, config)

        # 1. Momentum predictor.
        p_g = mesh.gather(state.p)
        b_u = sys.rhs[:, 0] - (sys.A_diag[:, 0, 2] * state.p + torch.sum(
            sys.A_off[:, :, 0, 2] * p_g, dim=1))
        b_v = sys.rhs[:, 1] - (sys.A_diag[:, 1, 2] * state.p + torch.sum(
            sys.A_off[:, :, 1, 2] * p_g, dim=1))
        a_diag, a_off = sys.A_diag[:, 0, 0], sys.A_off[:, :, 0, 0]

        def mv_mom(x):
            return scalar_spmv(a_diag, a_off, mesh, x)

        d_inv = sys.diag_u_inv
        ru = bicgstab_solve(mv_mom, b_u, state.u[:, 0],
                            precond=lambda r: d_inv * r,
                            max_iters=200, tol=mom_tol, reduce=reduce)
        rv = bicgstab_solve(mv_mom, b_v, state.u[:, 1],
                            precond=lambda r: d_inv * r,
                            max_iters=200, tol=mom_tol, reduce=reduce)
        u_star = torch.stack([ru.x, rv.x], dim=1)
        # Under-relax the predictor like classical SIMPLE.
        u_star = state.u + params.alpha_u * (u_star - state.u)

        # 2. Pressure correction from the predictor's fluxes.
        state_star = prepare(mesh, replace(state, u=u_star), params, config)
        diag, P_off, rhs = assemble_pressure_poisson(mesh, state_star,
                                                     params)
        p_inv = torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, 0.0)
        rp = cg_solve(lambda x: scalar_spmv(diag, P_off, mesh, x), rhs,
                      torch.zeros_like(rhs), precond=lambda r: p_inv * r,
                      max_iters=500, tol=p_tol, reduce=reduce)
        p_corr = rp.x * mesh.c_valid

        # 3. Correct fields.
        gp_corr = _green_gauss_scalar(mesh, p_corr)
        u_new = u_star - state_star.d_p[:, None] * gp_corr
        p_new = state.p + params.alpha_p * p_corr

        iters = ru.iterations + rv.iterations + rp.iterations
        diffs = _max_all(mesh, torch.stack([
            torch.max(torch.abs(u_new - state.u)),
            torch.max(torch.abs(params.alpha_p * p_corr))]))
        state = replace(state_star, u=u_new, p=p_new,
                        outer_residual_u=diffs[0],
                        outer_residual_p=diffs[1],
                        linear_iters=torch.tensor(iters, **i32),
                        linear_residual=rp.residual,
                        linear_iters_total=state.linear_iters_total + iters)

    state = replace(state, time=state.time + params.dt,
                    outer_iters=torch.tensor(n_correctors, **i32))
    return check_evolution(state, config, valid=mesh.c_valid,
                           decomp=mesh.decomp)
