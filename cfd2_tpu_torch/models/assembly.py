"""Finite-volume kernels: prepare (fluxes, d_p, gradients) and the coupled
assembly, in stencil form (structured meshes), scalar-coefficient ELL form
(banded meshes) or 3x3 block-ELL form (every mesh).

Port of ``cfd2_tpu.models.assembly`` as plain PyTorch on float32 tensors;
neighbor values come from ``DeviceMesh.gather`` (grid shifts, or the banded
gather kernel on multilevel and unstructured meshes).  The expressions keep
the JAX package's order of operations so that both give the same values to
f32 roundoff:

* :func:`prepare` — Rhie–Chow mass fluxes (in slot layout, or one per face
  by :func:`compute_fluxes` on generic meshes without a banded map), the
  pressure-correction coefficient d_p = vol/a_P, and Green–Gauss gradients of
  p, u, v (reference shaders/prepare_coupled.wgsl:63-348);
* :func:`assemble_stencil` — the coupled (u, v, p) system as 2D stencil
  planes (reference shaders/coupled_assembly_merged.wgsl:70-463);
* :func:`assemble_ell` — the same coefficients as (N, K) planes for the
  banded path (see ops/ellsys.py);
* :func:`assemble_coupled` — the same as (N, K, 3, 3) blocks for the
  block-ELL path (see ops/blockell.py);
* :func:`assemble_pressure` — the scalar pressure (Schur) matrix alone.

Boundary codes: 1=Inlet (ramped u_bc), 2=Outlet (p=0, backflow guard),
3=Wall (no-slip).  Upwind convection with deferred-correction SOU/QUICK, and
Euler/BDF2 time schemes, as in the reference.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..runtime.device_mesh import SLOT_E, SLOT_N, SLOT_S, SLOT_W, DeviceMesh
from ..runtime.state import (
    SCHEME_SECOND_ORDER_UPWIND,
    SCHEME_UPWIND,
    TIME_BDF2,
    SolverConfig,
    SolverParams,
    SolverState,
)


def _smoothstep(edge1: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(x / torch.clamp(edge1, min=1e-9), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _inlet_velocity(params: SolverParams, time: torch.Tensor):
    ramp = _smoothstep(params.ramp_time, time)
    return params.inlet_velocity * ramp


def _inlet_bc(mesh: DeviceMesh, params: SolverParams, time: torch.Tensor,
              slot: bool = True):
    """Inlet u value per slot ((N, K)) or per face ((F,)), or a scalar for
    a uniform inlet."""
    u_bc = _inlet_velocity(params, time)
    scale = mesh.ck_inlet_scale if slot else mesh.f_inlet_scale
    return u_bc if scale is None else u_bc * scale


def _time_coeff(mesh: DeviceMesh, params: SolverParams, config: SolverConfig):
    """Diagonal time-derivative coefficient per cell (prepare_coupled.wgsl:82-89)."""
    base = mesh.c_vol * params.density / params.dt
    if config.time_scheme == TIME_BDF2:
        r = params.dt / params.dt_old
        return base * (1.0 + 2.0 * r) / (1.0 + r)
    return base


def compute_fluxes(mesh: DeviceMesh, state: SolverState, params: SolverParams,
                   time: torch.Tensor) -> torch.Tensor:
    """Rhie–Chow face mass fluxes (F,), face-parallel, for generic meshes
    without a banded map (prepare_coupled.wgsl:120-195).  Positive = out of
    the owner cell.  Both cells' values of every face come from one gather
    through the (F, 2) [owner, neighbor] map."""
    packed = torch.cat(
        [state.u, state.p[:, None], state.d_p[:, None], state.grad_p],
        dim=1)                                         # (N, 6)
    from ..ops.banded_kernels import banded_gather
    cells = torch.stack([mesh.f_owner, mesh.f_neighbor_safe], dim=1)
    g = banded_gather(packed, cells)                   # (F, 2, 6)
    own, ngh = g[:, 0], g[:, 1]
    u_own, u_ngh = own[:, 0:2], ngh[:, 0:2]
    lam = mesh.f_lambda[:, None]
    u_face = lam * u_own + (1.0 - lam) * u_ngh

    dp_face = mesh.f_lambda * own[:, 3] + (1.0 - mesh.f_lambda) * ngh[:, 3]
    gp_face = lam * own[:, 4:6] + (1.0 - lam) * ngh[:, 4:6]

    grad_p_n = gp_face[:, 0] * mesh.f_nx + gp_face[:, 1] * mesh.f_ny
    p_grad_f = (ngh[:, 2] - own[:, 2]) / mesh.f_dist_cc
    rc_term = dp_face * mesh.f_area * (grad_p_n - p_grad_f)
    u_n = u_face[:, 0] * mesh.f_nx + u_face[:, 1] * mesh.f_ny
    flux_internal = params.density * (u_n * mesh.f_area + rc_term)

    u_bc = _inlet_bc(mesh, params, time, slot=False)
    flux_inlet = params.density * u_bc * mesh.f_nx * mesh.f_area
    un_own = u_own[:, 0] * mesh.f_nx + u_own[:, 1] * mesh.f_ny
    flux_outlet = torch.clamp(params.density * un_own * mesh.f_area, min=0.0)

    return torch.where(mesh.f_internal, flux_internal,
                       torch.where(mesh.f_boundary == 1, flux_inlet,
                                   torch.where(mesh.f_boundary == 2,
                                               flux_outlet, 0.0)))


def _boundary_slot_fluxes(mesh, state, params, time):
    """Boundary-face mass flux for every slot (inlet ramp / outlet guard /
    wall zero), elementwise."""
    u_bc = _inlet_bc(mesh, params, time)
    an = mesh.ck_area * mesh.ck_nx
    fl_inlet = params.density * u_bc * an
    un = state.u[:, 0][:, None] * mesh.ck_nx + state.u[:, 1][:, None] * mesh.ck_ny
    fl_outlet = torch.clamp(params.density * un * mesh.ck_area, min=0.0)
    return torch.where(mesh.ck_boundary == 1, fl_inlet,
                       torch.where(mesh.ck_boundary == 2, fl_outlet, 0.0))


def compute_slot_fluxes(mesh: DeviceMesh, state: SolverState,
                        params: SolverParams, time: torch.Tensor) -> torch.Tensor:
    """Structured- and multilevel-path fluxes in slot layout (N, K),
    outward-positive.

    E/N slots evaluate the internal Rhie–Chow formula; W/S mirror them via
    shifts (exact antisymmetry); boundary slots use the boundary formulas.
    On a multilevel mesh the W/S mirror applies where ``ck_mirror`` says the
    same-level partner holds the face; every other internal face (hanging
    faces, extra slots) is evaluated on one side and scattered negated to
    the other through the ``ml_pair`` entry pairs, so per-face antisymmetry
    is exact there too.
    """
    # One multi-component gather: the kernel loads each index once, and a
    # row-sharded mesh exchanges its ghost rows once.
    g = mesh.gather(torch.cat([state.u, state.p[:, None],
                               state.d_p[:, None], state.grad_p], dim=1))
    u_n, p_n, dp_n, gp_n = g[..., 0:2], g[..., 2], g[..., 3], g[..., 4:6]

    lam = mesh.ck_lam
    u_face = lam[..., None] * state.u[:, None, :] + (1.0 - lam[..., None]) * u_n
    dp_face = lam * state.d_p[:, None] + (1.0 - lam) * dp_n
    gp_face = lam[..., None] * state.grad_p[:, None, :] \
        + (1.0 - lam[..., None]) * gp_n

    gpn = gp_face[..., 0] * mesh.ck_nx + gp_face[..., 1] * mesh.ck_ny
    p_grad = (p_n - state.p[:, None]) / mesh.ck_dist_proj
    rc = dp_face * mesh.ck_area * (gpn - p_grad)
    un_face = u_face[..., 0] * mesh.ck_nx + u_face[..., 1] * mesh.ck_ny
    fl_int = params.density * (un_face * mesh.ck_area + rc)   # (N, K)

    fl_bdry = _boundary_slot_fluxes(mesh, state, params, time)

    is_b = mesh.ck_is_boundary > 0
    mask = mesh.ck_mask
    fE = torch.where(is_b[:, SLOT_E], fl_bdry[:, SLOT_E], fl_int[:, SLOT_E]) \
        * mask[:, SLOT_E]
    fN = torch.where(is_b[:, SLOT_N], fl_bdry[:, SLOT_N], fl_int[:, SLOT_N]) \
        * mask[:, SLOT_N]
    if mesh.multilevel:
        fl = torch.where(is_b, fl_bdry, fl_int)
        fW = torch.where(mesh.ck_mirror[:, SLOT_W] > 0,
                         -mesh.shift_from_west(fE), fl[:, SLOT_W]) \
            * mask[:, SLOT_W]
        fS = torch.where(mesh.ck_mirror[:, SLOT_S] > 0,
                         -mesh.shift_from_south(fN), fl[:, SLOT_S]) \
            * mask[:, SLOT_S]
        flux = torch.stack([fE, fW, fN, fS] + [
            fl[:, k] * mask[:, k] for k in range(4, mesh.max_faces)], dim=1)
        # Each internal face has one side-b entry, so the targets are
        # distinct and the scatter is deterministic.
        a = (mesh.ml_pair_cell_a.long(), mesh.ml_pair_slot_a.long())
        b = (mesh.ml_pair_cell_b.long(), mesh.ml_pair_slot_b.long())
        return flux.index_put_(b, -flux[a])
    fW = torch.where(is_b[:, SLOT_W], fl_bdry[:, SLOT_W],
                     -mesh.shift_from_west(fE)) * mask[:, SLOT_W]
    fS = torch.where(is_b[:, SLOT_S], fl_bdry[:, SLOT_S],
                     -mesh.shift_from_south(fN)) * mask[:, SLOT_S]
    cols = [fE, fW, fN, fS]
    for k in range(4, mesh.max_faces):
        cols.append(fl_bdry[:, k] * mask[:, k])
    return torch.stack(cols, dim=1)


def compute_banded_slot_fluxes(mesh: DeviceMesh, state: SolverState,
                               params: SolverParams, time: torch.Tensor):
    """Generic-banded-path fluxes in slot layout (N, K), outward-positive,
    from ONE shared multi-component neighbor gather (u, p, d_p, grad_p).

    Every slot evaluates the internal Rhie–Chow formula directly; per-face
    antisymmetry is *bitwise exact* without a pair scatter because the
    symmetric interpolation uses the partner entry's own lambda
    (``ck_lam_other``, bitwise equal to what the other side computes) and
    every remaining term is an exact f32 negation across the pair (normals
    are exact negations, area/dist_proj are bitwise shared, and f32
    negation/commutativity are exact).  The order of operations below is
    part of that property.

    Returns ``(flux, p_other, u_other)`` so prepare's Green–Gauss gradients
    reuse the gathered planes.
    """
    packed = torch.cat(
        [state.u, state.p[:, None], state.d_p[:, None], state.grad_p],
        dim=1)                                         # (N, 6)
    g = mesh.gather(packed)                            # (N, K, 6)
    u_n = g[..., 0:2]
    p_n = g[..., 2]
    dp_n = g[..., 3]
    gp_n = g[..., 4:6]

    lam = mesh.ck_lam
    lam_o = mesh.ck_lam_other
    u_face = lam[..., None] * state.u[:, None, :] + lam_o[..., None] * u_n
    dp_face = lam * state.d_p[:, None] + lam_o * dp_n
    gp_face = lam[..., None] * state.grad_p[:, None, :] \
        + lam_o[..., None] * gp_n

    gpn = gp_face[..., 0] * mesh.ck_nx + gp_face[..., 1] * mesh.ck_ny
    p_grad = (p_n - state.p[:, None]) / mesh.ck_dist_proj
    rc = dp_face * mesh.ck_area * (gpn - p_grad)
    un_face = u_face[..., 0] * mesh.ck_nx + u_face[..., 1] * mesh.ck_ny
    fl_int = params.density * (un_face * mesh.ck_area + rc)

    fl_bdry = _boundary_slot_fluxes(mesh, state, params, time)
    flux = torch.where(mesh.ck_is_boundary > 0, fl_bdry, fl_int) * mesh.ck_mask
    return flux, p_n, u_n


def prepare(mesh: DeviceMesh, state: SolverState, params: SolverParams,
            config: SolverConfig) -> SolverState:
    """Fused pre-pass: fluxes, d_p, grad_p, grad_u, grad_v.

    Uses the *incoming* state's d_p/grad_p in the Rhie–Chow flux (like the
    reference, which reads them before overwriting).
    """
    p_other = u_other = None
    if mesh.structured or mesh.multilevel:
        flux = flux_out = compute_slot_fluxes(mesh, state, params,
                                              state.time)
    elif mesh.banded:
        flux, p_other, u_other = compute_banded_slot_fluxes(
            mesh, state, params, state.time)
        flux_out = flux
    else:
        flux = compute_fluxes(mesh, state, params, state.time)
        flux_out = mesh.slot_fluxes(flux)

    mask = mesh.ck_mask
    is_b = mesh.ck_is_boundary
    bdry = mesh.ck_boundary

    # --- d_p: momentum diagonal accumulation (prepare_coupled.wgsl:202-254) ---
    diff = params.viscosity * mesh.ck_area / mesh.ck_dist  # plain distance here
    conv_diag = torch.clamp(flux_out, min=0.0)
    contrib = torch.where((is_b > 0) & (bdry == 2), conv_diag, diff + conv_diag)
    diag = _time_coeff(mesh, params, config) + torch.sum(contrib * mask, dim=1)
    d_p = torch.where(torch.abs(diag) > 1e-20, mesh.c_vol / diag, 0.0)

    # --- Green-Gauss gradients (prepare_coupled.wgsl:256-347) ---
    lam = mesh.ck_lam
    p_this = state.p[:, None]
    if p_other is None:
        p_other = mesh.gather(state.p)
    pf_internal = lam * p_this + (1.0 - lam) * p_other
    pf_bdry = torch.where(bdry == 2, 0.0, p_this)            # outlet: p = 0
    p_face = torch.where(is_b > 0, pf_bdry, pf_internal) * mask
    inv_vol = 1.0 / mesh.c_vol
    grad_p = torch.stack([
        torch.sum(p_face * mesh.ck_nx * mesh.ck_area, dim=1) * inv_vol,
        torch.sum(p_face * mesh.ck_ny * mesh.ck_area, dim=1) * inv_vol,
    ], dim=1)

    u_bc = _inlet_bc(mesh, params, state.time)
    if u_other is None:
        u_other = mesh.gather(state.u)                       # (N, K, 2)
    for_comp = []
    for comp in (0, 1):
        v_this = state.u[:, comp][:, None]
        vf_internal = lam * v_this + (1.0 - lam) * u_other[..., comp]
        bc_in = (u_bc if comp == 0 else 0.0) * torch.ones_like(v_this)
        bc_val = torch.where(bdry == 1, bc_in,
                             torch.where(bdry == 3, 0.0, v_this))
        v_face = torch.where(is_b > 0, bc_val, vf_internal) * mask
        for_comp.append(torch.stack([
            torch.sum(v_face * mesh.ck_nx * mesh.ck_area, dim=1) * inv_vol,
            torch.sum(v_face * mesh.ck_ny * mesh.ck_area, dim=1) * inv_vol,
        ], dim=1))

    return replace(state, fluxes=flux, d_p=d_p, grad_p=grad_p,
                   grad_u=for_comp[0], grad_v=for_comp[1])


def _deferred_correction(mesh, state, flux, config):
    """Higher-order convection via deferred correction
    (coupled_assembly_merged.wgsl:229-293).  Returns (corr_u, corr_v) summed
    over internal slots, to be subtracted from the RHS."""
    upwind_own = flux > 0.0
    # One shared multi-component gather (the kernel loads each index once
    # for all six components; a row-sharded mesh exchanges once).
    packed = torch.cat([state.u, state.grad_u, state.grad_v], dim=1)
    g = mesh.gather(packed)                  # (N, K, 6)
    u_other2, gu_other, gv_other = g[..., 0:2], g[..., 2:4], g[..., 4:6]
    u_this = state.u[:, 0][:, None]
    v_this = state.u[:, 1][:, None]
    u_other = u_other2[..., 0]
    v_other = u_other2[..., 1]

    phi_up_u = torch.where(upwind_own, u_this, u_other)
    phi_up_v = torch.where(upwind_own, v_this, v_other)

    gu_this = state.grad_u[:, None, :]        # (N, 1, 2)
    gv_this = state.grad_v[:, None, :]

    if config.scheme == SCHEME_SECOND_ORDER_UPWIND:
        # r vector from the upwind cell's center to the face center.
        r_own = torch.stack([mesh.ck_rx, mesh.ck_ry], dim=-1)          # (N,K,2)
        r_other = r_own - torch.stack([mesh.ck_dcdx, mesh.ck_dcdy], dim=-1)
        ho_own_u = u_this + torch.sum(gu_this * r_own, dim=-1)
        ho_own_v = v_this + torch.sum(gv_this * r_own, dim=-1)
        ho_oth_u = u_other + torch.sum(gu_other * r_other, dim=-1)
        ho_oth_v = v_other + torch.sum(gv_other * r_other, dim=-1)
    else:  # QUICK
        dcd = torch.stack([mesh.ck_dcdx, mesh.ck_dcdy], dim=-1)
        gt_own_u = torch.sum(gu_this * dcd, dim=-1)
        gt_own_v = torch.sum(gv_this * dcd, dim=-1)
        gt_oth_u = torch.sum(gu_other * (-dcd), dim=-1)
        gt_oth_v = torch.sum(gv_other * (-dcd), dim=-1)
        ho_own_u = 0.625 * u_this + 0.375 * u_other + 0.125 * gt_own_u
        ho_own_v = 0.625 * v_this + 0.375 * v_other + 0.125 * gt_own_v
        ho_oth_u = 0.625 * u_other + 0.375 * u_this + 0.125 * gt_oth_u
        ho_oth_v = 0.625 * v_other + 0.375 * v_this + 0.125 * gt_oth_v

    phi_ho_u = torch.where(upwind_own, ho_own_u, ho_oth_u)
    phi_ho_v = torch.where(upwind_own, ho_own_v, ho_oth_v)

    internal = mesh.ck_mask * (1.0 - mesh.ck_is_boundary)
    corr_u = torch.sum(flux * (phi_ho_u - phi_up_u) * internal, dim=1)
    corr_v = torch.sum(flux * (phi_ho_v - phi_up_v) * internal, dim=1)
    return corr_u, corr_v


def _assemble_parts(mesh: DeviceMesh, state: SolverState, params: SolverParams,
                    config: SolverConfig) -> dict:
    """Per-slot (N, K) off-diagonal coefficients and the (N,) diagonals/RHS
    of the coupled system (coupled_assembly_merged.wgsl math)."""
    mask = mesh.ck_mask
    is_b = mesh.ck_is_boundary
    internal = mask * (1.0 - is_b)
    bdry = mesh.ck_boundary

    flux = mesh.slot_fluxes(state.fluxes)                  # (N, K), outward
    dist = mesh.ck_dist_proj
    diff = params.viscosity * mesh.ck_area / dist
    conv_diag = torch.clamp(flux, min=0.0)
    conv_off = torch.clamp(flux, max=0.0)

    area_nx = mesh.ck_area * mesh.ck_nx
    area_ny = mesh.ck_area * mesh.ck_ny
    lam = mesh.ck_lam

    # ---- time derivative (coupled_assembly_merged.wgsl:108-132) ----
    vol_rho_dt = mesh.c_vol * params.density / params.dt
    if config.time_scheme == TIME_BDF2:
        r = params.dt / params.dt_old
        coeff_time = vol_rho_dt * (1.0 + 2.0 * r) / (1.0 + r)
        factor_n = 1.0 + r
        factor_nm1 = (r * r) / (1.0 + r)
        rhs_time = vol_rho_dt[:, None] * (
            factor_n * state.u_old - factor_nm1 * state.u_old_old)
    else:
        coeff_time = vol_rho_dt
        rhs_time = vol_rho_dt[:, None] * state.u_old

    # ---- internal-face contributions ----
    off_mom = (-diff + conv_off) * internal                # A_uu = A_vv off-diag
    diag_mom_c = (diff + conv_diag) * internal

    off_up = (1.0 - lam) * area_nx * internal
    off_vp = (1.0 - lam) * area_ny * internal
    diag_up_c = lam * area_nx * internal
    diag_vp_c = lam * area_ny * internal

    off_pu = (1.0 - lam) * area_nx * internal
    off_pv = (1.0 - lam) * area_ny * internal
    diag_pu_c = lam * area_nx * internal
    diag_pv_c = lam * area_ny * internal

    dp_this = state.d_p[:, None]
    dp_other = mesh.gather(state.d_p)
    dp_f = lam * dp_this + (1.0 - lam) * dp_other
    lapl = dp_f * mesh.ck_area / dist
    off_pp = -lapl * internal
    diag_pp_c = lapl * internal

    scalar_coeff = params.density * lapl
    P_off = -scalar_coeff * internal
    scalar_diag_c = scalar_coeff * internal

    # ---- boundary contributions (coupled_assembly_merged.wgsl:352-419) ----
    u_bc = _inlet_bc(mesh, params, state.time)
    is_inlet = (is_b > 0) & (bdry == 1)
    is_wall = (is_b > 0) & (bdry == 3)
    is_outlet = (is_b > 0) & (bdry == 2)
    fpos = flux > 0.0

    flux_pos = torch.where(fpos, flux, 0.0)
    b_diag_mom = torch.where(is_inlet | is_wall, diff + flux_pos,
                             torch.where(is_outlet, flux_pos, 0.0))
    b_rhs_u = torch.where(is_inlet, diff * u_bc
                          - torch.where(fpos, 0.0, flux * u_bc), 0.0)
    # v inlet BC value is 0, so no v RHS contribution.
    b_diag_up = torch.where(is_inlet | is_wall, area_nx, 0.0)
    b_diag_vp = torch.where(is_inlet | is_wall, area_ny, 0.0)
    # Continuity at inlet: rhs_p -= (u_bc . n) * area (volumetric, :381).
    b_rhs_p = torch.where(is_inlet, -(u_bc * area_nx), 0.0)
    b_diag_pu = torch.where(is_outlet, area_nx, 0.0)
    b_diag_pv = torch.where(is_outlet, area_ny, 0.0)
    lapl_out = dp_this * mesh.ck_area / dist
    b_diag_pp = torch.where(is_outlet, lapl_out, 0.0)
    b_scalar_diag = torch.where(is_outlet, params.density * lapl_out, 0.0)

    # ---- reductions over slots ----
    diag_u = coeff_time + torch.sum(diag_mom_c + b_diag_mom, dim=1)
    diag_up = torch.sum(diag_up_c + b_diag_up, dim=1)
    diag_vp = torch.sum(diag_vp_c + b_diag_vp, dim=1)
    diag_pu = torch.sum(diag_pu_c + b_diag_pu, dim=1)
    diag_pv = torch.sum(diag_pv_c + b_diag_pv, dim=1)
    diag_pp = torch.sum(diag_pp_c + b_diag_pp, dim=1)
    P_diag = torch.sum(scalar_diag_c + b_scalar_diag, dim=1)

    rhs_u = rhs_time[:, 0] + torch.sum(b_rhs_u, dim=1)
    rhs_v = rhs_time[:, 1]
    rhs_p = torch.sum(b_rhs_p, dim=1)

    if config.scheme != SCHEME_UPWIND:
        corr_u, corr_v = _deferred_correction(mesh, state, flux, config)
        rhs_u = rhs_u - corr_u
        rhs_v = rhs_v - corr_v

    # ---- masked solid cells (structured layout): identity pressure rows ----
    valid = mesh.c_valid
    diag_pp = torch.where(valid > 0, diag_pp, 1.0)
    P_diag = torch.where(valid > 0, P_diag, 1.0)

    rhs = torch.stack([rhs_u, rhs_v, rhs_p], dim=-1) * valid[:, None]

    return dict(
        off_mom=off_mom, off_up=off_up, off_vp=off_vp,
        off_pu=off_pu, off_pv=off_pv, off_pp=off_pp, P_off=P_off,
        diag_u=diag_u, diag_up=diag_up, diag_vp=diag_vp,
        diag_pu=diag_pu, diag_pv=diag_pv, diag_pp=diag_pp, P_diag=P_diag,
        rhs=rhs,
    )


def _safe_inv(x):
    return torch.where(torch.abs(x) > 1e-14, 1.0 / x, 0.0)


def assemble_pressure(mesh: DeviceMesh, state: SolverState,
                      params: SolverParams):
    """Scalar pressure matrix ``(P_diag, P_off)`` alone — what the per-step
    frozen coarse multigrid needs.  Mirrors :func:`_assemble_parts`'
    pressure rows in the same order of operations."""
    mask = mesh.ck_mask
    is_b = mesh.ck_is_boundary
    internal = mask * (1.0 - is_b)

    dist = mesh.ck_dist_proj
    lam = mesh.ck_lam
    dp_this = state.d_p[:, None]
    dp_other = mesh.gather(state.d_p)
    dp_f = lam * dp_this + (1.0 - lam) * dp_other
    lapl = dp_f * mesh.ck_area / dist
    scalar_coeff = params.density * lapl
    P_off = -scalar_coeff * internal
    scalar_diag_c = scalar_coeff * internal

    is_outlet = (is_b > 0) & (mesh.ck_boundary == 2)
    lapl_out = dp_this * mesh.ck_area / dist
    b_scalar_diag = torch.where(is_outlet, params.density * lapl_out, 0.0)

    P_diag = torch.sum(scalar_diag_c + b_scalar_diag, dim=1)
    P_diag = torch.where(mesh.c_valid > 0, P_diag, 1.0)
    return P_diag, P_off


def assemble_coupled(mesh: DeviceMesh, state: SolverState,
                     params: SolverParams, config: SolverConfig):
    """Assemble the coupled system as 3x3 blocks plus the scalar pressure
    matrix (:class:`..ops.blockell.BlockSystem`)."""
    from ..ops.blockell import BlockSystem

    c = _assemble_parts(mesh, state, params, config)
    zero_nk = torch.zeros_like(c["off_mom"])
    A_off = torch.stack([
        torch.stack([c["off_mom"], zero_nk, c["off_up"]], dim=-1),
        torch.stack([zero_nk, c["off_mom"], c["off_vp"]], dim=-1),
        torch.stack([c["off_pu"], c["off_pv"], c["off_pp"]], dim=-1),
    ], dim=-2)                                             # (N, K, 3, 3)
    zero_n = torch.zeros_like(c["diag_u"])
    A_diag = torch.stack([
        torch.stack([c["diag_u"], zero_n, c["diag_up"]], dim=-1),
        torch.stack([zero_n, c["diag_u"], c["diag_vp"]], dim=-1),
        torch.stack([c["diag_pu"], c["diag_pv"], c["diag_pp"]], dim=-1),
    ], dim=-2)                                             # (N, 3, 3)
    diag_u_inv = _safe_inv(c["diag_u"])
    return BlockSystem(
        A_diag=A_diag, A_off=A_off, rhs=c["rhs"],
        P_diag=c["P_diag"], P_off=c["P_off"],
        diag_u_inv=diag_u_inv, diag_v_inv=diag_u_inv,
        diag_p_inv=_safe_inv(c["P_diag"]))


def assemble_stencil(mesh: DeviceMesh, state: SolverState,
                     params: SolverParams, config: SolverConfig):
    """Assemble the coupled system in 2D stencil form: only the 6
    structurally-nonzero block entries per slot, each as a (4, ny, nx)
    plane (see ops/stencil_system.py)."""
    from ..ops.stencil_system import StencilSystem

    ny, nx = mesh.grid_shape
    c = _assemble_parts(mesh, state, params, config)

    def off2(a):                        # (N, K) -> (4, ny, nx)
        return a[:, :4].T.reshape(4, ny, nx).contiguous()

    def d2(a):                          # (N,) -> (ny, nx)
        return a.reshape(ny, nx)

    return StencilSystem(
        grid=(ny, nx), decomp=mesh.decomp,
        off_mom=off2(c["off_mom"]), off_up=off2(c["off_up"]),
        off_vp=off2(c["off_vp"]), off_pu=off2(c["off_pu"]),
        off_pv=off2(c["off_pv"]), off_pp=off2(c["off_pp"]),
        P_off2=off2(c["P_off"]),
        diag_u2=d2(c["diag_u"]), diag_up2=d2(c["diag_up"]),
        diag_vp2=d2(c["diag_vp"]), diag_pu2=d2(c["diag_pu"]),
        diag_pv2=d2(c["diag_pv"]), diag_pp2=d2(c["diag_pp"]),
        P_diag2=d2(c["P_diag"]),
        diag_u_inv2=d2(_safe_inv(c["diag_u"])),
        diag_p_inv2=d2(_safe_inv(c["P_diag"])),
        rhs=c["rhs"],
    )


def assemble_ell(mesh: DeviceMesh, state: SolverState,
                 params: SolverParams, config: SolverConfig):
    """Assemble the coupled system in scalar-coefficient ELL form for the
    banded (unstructured) path (ops/ellsys.py) — the unstructured twin of
    :func:`assemble_stencil`: (N, K) coefficient planes over
    ``mesh.ck_neighbor``."""
    from ..ops.ellsys import EllSystem

    c = _assemble_parts(mesh, state, params, config)
    return EllSystem(
        off_mom=c["off_mom"], off_up=c["off_up"], off_vp=c["off_vp"],
        off_pu=c["off_pu"], off_pv=c["off_pv"], off_pp=c["off_pp"],
        P_off=c["P_off"],
        diag_u=c["diag_u"], diag_up=c["diag_up"], diag_vp=c["diag_vp"],
        diag_pu=c["diag_pu"], diag_pv=c["diag_pv"], diag_pp=c["diag_pp"],
        P_diag=c["P_diag"],
        diag_u_inv=_safe_inv(c["diag_u"]),
        diag_p_inv=_safe_inv(c["P_diag"]),
        rhs=c["rhs"],
    )
