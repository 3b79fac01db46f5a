"""SIMPLE/Schur-complement preconditioner of the block-ELL system.

Port of ``cfd2_tpu.ops.schur``.  M^{-1} approximates [A G; D C]^{-1}
(reference schur_precond.wgsl:1-188):

  1. predict velocity:   z_u = D_u^{-1} r_u (Jacobi sweeps)
  2. form Schur RHS:     r_p' = r_p - D z_u
  3. solve pressure:     A_p z_p ~= r_p'  (Chebyshev/Jacobi sweeps or AMG)
  4. correct velocity:   z_u -= D_u^{-1} G z_p

and :func:`block_jacobi_preconditioner` is the per-cell 3x3 block inverse
(``precond_type=2``).  Every neighbor access is ``mesh.gather``.
"""

from __future__ import annotations

import torch

from .blockell import BlockSystem


def chebyshev_pressure_solve(sys: BlockSystem, mesh, rhs_p: torch.Tensor,
                             omega: float, n_sweeps: int) -> torch.Tensor:
    """Damped-Jacobi / Chebyshev-style two-term relaxation of A_p x = rhs_p:
    x_{k+1} = (1-omega) x_{k-1} + omega * D^{-1}(rhs - R x_k), x_{-1} = 0,
    x_0 = D^{-1} rhs (reference schur_precond.wgsl:49-90,183-187)."""
    x_cur = sys.diag_p_inv * rhs_p
    x_prev = torch.zeros_like(rhs_p)
    for _ in range(n_sweeps):
        sigma = torch.sum(sys.P_off * mesh.gather(x_cur), dim=1)
        hat = sys.diag_p_inv * (rhs_p - sigma)
        x_prev, x_cur = x_cur, x_prev + omega * (hat - x_prev)
    return x_cur


def block_jacobi_preconditioner(sys: BlockSystem,
                                r: torch.Tensor) -> torch.Tensor:
    """z_i = (A_ii)^{-1} r_i, batched over cells (reference
    shaders/preconditioner.wgsl:106-224).  ``solve_ex`` checks no
    singularity, so it adds no host read; every block is invertible, as
    masked and padded cells carry diag(rho*vol/dt, rho*vol/dt, 1)."""
    return torch.linalg.solve_ex(sys.A_diag, r[..., None])[0][..., 0]


def _momentum_solve(sys: BlockSystem, mesh, r_u, r_v, sweeps: int):
    """Approximate momentum-block inverse: Jacobi iteration seeded with the
    diagonal predict.  ``sweeps=1`` is the reference's bare diagonal
    (schur_precond.wgsl:149-156)."""
    z_u = sys.diag_u_inv * r_u
    z_v = sys.diag_v_inv * r_v
    for _ in range(sweeps - 1):
        z_u = sys.diag_u_inv * (
            r_u - torch.sum(sys.A_off[:, :, 0, 0] * mesh.gather(z_u), dim=1))
        z_v = sys.diag_v_inv * (
            r_v - torch.sum(sys.A_off[:, :, 1, 1] * mesh.gather(z_v), dim=1))
    return z_u, z_v


def schur_preconditioner(sys: BlockSystem, mesh, r: torch.Tensor,
                         omega: float, n_sweeps: int,
                         pressure_solve=None,
                         mom_sweeps: int = 1) -> torch.Tensor:
    """Apply M^{-1} to a residual r of shape (N, 3); returns z (N, 3).
    ``pressure_solve`` (rhs_p -> z_p) overrides the Chebyshev relaxation of
    step 3, e.g. with an AMG V-cycle."""
    r_u, r_v, r_p = r[:, 0], r[:, 1], r[:, 2]

    # 1. Predict velocity (schur_precond.wgsl:149-156).
    z_u, z_v = _momentum_solve(sys, mesh, r_u, r_v, mom_sweeps)

    # 2. Schur RHS r_p' = r_p - D z_u from the pressure rows of the blocks
    #    (schur_precond.wgsl:158-181).
    zg_u = mesh.gather(z_u)                      # (N, K)
    zg_v = mesh.gather(z_v)
    rhs_p = r_p \
        - sys.A_diag[:, 2, 0] * z_u - sys.A_diag[:, 2, 1] * z_v \
        - torch.sum(sys.A_off[:, :, 2, 0] * zg_u
                    + sys.A_off[:, :, 2, 1] * zg_v, dim=1)

    # 3. Pressure solve.
    if pressure_solve is None:
        z_p = chebyshev_pressure_solve(sys, mesh, rhs_p, omega, n_sweeps)
    else:
        z_p = pressure_solve(rhs_p)

    # 4. Correct velocity with the gradient blocks G
    #    (schur_precond.wgsl:92-139).
    zg_p = mesh.gather(z_p)                      # (N, K)
    g_u = sys.A_diag[:, 0, 2] * z_p \
        + torch.sum(sys.A_off[:, :, 0, 2] * zg_p, dim=1)
    g_v = sys.A_diag[:, 1, 2] * z_p \
        + torch.sum(sys.A_off[:, :, 1, 2] * zg_p, dim=1)
    gz_u, gz_v = _momentum_solve(sys, mesh, g_u, g_v, mom_sweeps)
    return torch.stack([z_u - gz_u, z_v - gz_v, z_p], dim=1)
