"""2D-native coupled operator for structured meshes.

Port of ``cfd2_tpu.ops.stencil_system``: the coupled (u, v, p) system is kept
as the 6 structurally nonzero block entries per directional slot, each a
(4, ny, nx) plane, plus (ny, nx) diagonals, and every operator application is
a stencil of edge-clamped shifts and multiply-adds on (ny, nx) planes.
Vectors of the Krylov solve are (3, ny, nx) component planes.

Off-diagonal coefficients are identically zero at boundary/extra slots (the
assembly multiplies them by the internal-face mask), so edge-clamped shifts
never contribute.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .stencil_kernels import _shifts2


def _dot4(off: torch.Tensor, sh) -> torch.Tensor:
    """sum_s off[s] * sh[s] for the 4 directional slots."""
    return off[0] * sh[0] + off[1] * sh[1] + off[2] * sh[2] + off[3] * sh[3]


@dataclass
class StencilSystem:
    """Coupled (u,v,p) system on an (ny, nx) grid, stencil layout.

    Block entry names follow the coupled matrix
        [ A_uu   0     G_u ]   row u: off_mom, off_up
        [ 0      A_vv  G_v ]   row v: off_mom, off_vp
        [ D_u    D_v   C   ]   row p: off_pu, off_pv, off_pp
    (A_uu == A_vv by construction; diag_v == diag_u likewise).
    """
    grid: tuple                  # (ny, nx)
    # (4, ny, nx): per-slot off-diagonal coefficients, slots E,W,N,S
    off_mom: torch.Tensor
    off_up: torch.Tensor
    off_vp: torch.Tensor
    off_pu: torch.Tensor
    off_pv: torch.Tensor
    off_pp: torch.Tensor
    P_off2: torch.Tensor         # scalar pressure (Schur) off-diagonals
    # (ny, nx) diagonals
    diag_u2: torch.Tensor
    diag_up2: torch.Tensor
    diag_vp2: torch.Tensor
    diag_pu2: torch.Tensor
    diag_pv2: torch.Tensor
    diag_pp2: torch.Tensor
    P_diag2: torch.Tensor
    diag_u_inv2: torch.Tensor
    diag_p_inv2: torch.Tensor
    rhs: torch.Tensor            # (N, 3)


def spmv_planar(ss: StencilSystem, x: torch.Tensor) -> torch.Tensor:
    """y = A x with x, y of shape (3, ny, nx) (component planes)."""
    xu, xv, xp = x[0], x[1], x[2]
    su = _shifts2(xu)
    sv = _shifts2(xv)
    sp = _shifts2(xp)

    yu = ss.diag_u2 * xu + ss.diag_up2 * xp \
        + _dot4(ss.off_mom, su) + _dot4(ss.off_up, sp)
    yv = ss.diag_u2 * xv + ss.diag_vp2 * xp \
        + _dot4(ss.off_mom, sv) + _dot4(ss.off_vp, sp)
    yp = ss.diag_pu2 * xu + ss.diag_pv2 * xv + ss.diag_pp2 * xp \
        + _dot4(ss.off_pu, su) + _dot4(ss.off_pv, sv) + _dot4(ss.off_pp, sp)

    return torch.stack([yu, yv, yp])


def chebyshev_pressure_solve2(ss: StencilSystem, rhs_p2: torch.Tensor,
                              omega: float, n_sweeps: int) -> torch.Tensor:
    """Two-term damped-Jacobi recurrence on the scalar pressure system
    (reference schur_precond.wgsl:49-90)."""
    x_prev = torch.zeros_like(rhs_p2)
    x_cur = ss.diag_p_inv2 * rhs_p2
    for _ in range(n_sweeps):
        sigma = _dot4(ss.P_off2, _shifts2(x_cur))
        hat = ss.diag_p_inv2 * (rhs_p2 - sigma)
        x_prev, x_cur = x_cur, x_prev + omega * (hat - x_prev)
    return x_cur


def _momentum_solve(ss: StencilSystem, r_u, r_v, sweeps: int):
    """Approximate A_uu^{-1} applied to (r_u, r_v): Jacobi iteration seeded
    with the diagonal predict.  ``sweeps=1`` is the reference's SIMPLE
    diagonal approximation (schur_precond.wgsl:19-34); extra sweeps fold
    the momentum off-diagonals in."""
    z_u = ss.diag_u_inv2 * r_u
    z_v = ss.diag_u_inv2 * r_v
    for _ in range(sweeps - 1):
        z_u = ss.diag_u_inv2 * (r_u - _dot4(ss.off_mom, _shifts2(z_u)))
        z_v = ss.diag_u_inv2 * (r_v - _dot4(ss.off_mom, _shifts2(z_v)))
    return z_u, z_v


def schur_precond_planar(ss: StencilSystem, r: torch.Tensor, omega: float,
                         n_sweeps: int, pressure_solve=None,
                         mom_sweeps: int = 1) -> torch.Tensor:
    """SIMPLE/Schur preconditioner M^{-1} r on (3, ny, nx) component planes
    (reference schur_precond.wgsl): momentum predict -> Schur RHS ->
    pressure solve -> velocity correct.  ``pressure_solve`` takes and
    returns an (ny, nx) grid; defaults to the Chebyshev sweeps."""
    ru, rv, rp = r[0], r[1], r[2]
    z_u, z_v = _momentum_solve(ss, ru, rv, mom_sweeps)

    rhs_p = rp - ss.diag_pu2 * z_u - ss.diag_pv2 * z_v \
        - _dot4(ss.off_pu, _shifts2(z_u)) - _dot4(ss.off_pv, _shifts2(z_v))

    if pressure_solve is None:
        z_p = chebyshev_pressure_solve2(ss, rhs_p, omega, n_sweeps)
    else:
        z_p = pressure_solve(rhs_p)

    sp = _shifts2(z_p)
    g_u = ss.diag_up2 * z_p + _dot4(ss.off_up, sp)
    g_v = ss.diag_vp2 * z_p + _dot4(ss.off_vp, sp)
    gz_u, gz_v = _momentum_solve(ss, g_u, g_v, mom_sweeps)
    return torch.stack([z_u - gz_u, z_v - gz_v, z_p])


def to_planar(ss: StencilSystem, x: torch.Tensor) -> torch.Tensor:
    """(N, 3) interleaved -> (3, ny, nx) planes (once per solve)."""
    ny, nx = ss.grid
    return x.T.reshape(3, ny, nx).contiguous()


def from_planar(ss: StencilSystem, x: torch.Tensor) -> torch.Tensor:
    """(3, ny, nx) planes -> (N, 3) interleaved (once per solve)."""
    return x.reshape(3, -1).T


def coarse_level_values2_planes(hier, P_diag2, P_off2):
    """Galerkin-coarsen once from the planar pressure matrix, returning
    ``(coarse_vals, factors)`` for :func:`make_pressure_solve2`'s
    ``frozen=``: the level-1+ stencil values and the coarsest dense LU.  The
    fused step calls it once per timestep (SolverConfig.amg_freeze_coarse)."""
    from .amg import _coarse_factors, compute_structured_level_values2
    lv2 = compute_structured_level_values2(hier, P_diag2, P_off2)
    return tuple(lv2[1:]), _coarse_factors(hier, lv2)


def make_pressure_solve2(hier, ss: StencilSystem, n_cycles: int = 1,
                         frozen=None):
    """Structured-multigrid pressure solve taking/returning (ny, nx) grids:
    ``n_cycles`` V-cycles from the Jacobi seed ``diag_p_inv * rhs``.

    With ``frozen`` (from :func:`coarse_level_values2_planes`) level 0 is
    re-derived from the current assembly and only the level-1+ Galerkin
    products and the coarsest LU are reused."""
    from .amg import (_NULL_SHIFT, StructuredAmgHierarchy, _coarse_factors,
                      compute_structured_level_values2, structured_v_cycle)

    if not isinstance(hier, StructuredAmgHierarchy):
        raise TypeError("make_pressure_solve2 needs a StructuredAmgHierarchy")
    if frozen is not None:
        coarse_vals, factors = frozen
        d0 = ss.P_diag2 + _NULL_SHIFT * torch.abs(ss.P_diag2)
        lv2 = [(d0, ss.P_off2[:4])] + list(coarse_vals)
    else:
        lv2 = compute_structured_level_values2(hier, ss.P_diag2, ss.P_off2)
        factors = _coarse_factors(hier, lv2)

    def pressure_solve(rhs_p2):
        x = ss.diag_p_inv2 * rhs_p2
        for _ in range(n_cycles):
            x = structured_v_cycle(hier, lv2, rhs_p2.reshape(-1),
                                   x.reshape(-1),
                                   coarse_factors=factors).reshape(ss.grid)
        return x

    return pressure_solve
