"""Scalar-coefficient coupled system for the banded (unstructured) path.

Port of ``cfd2_tpu.ops.ellsys``.  The container keeps the per-slot scalar
coefficient planes the assembly produces (models/assembly.py:
``_assemble_parts``) — the unstructured twin of ops/stencil_system.py:

    [ A_uu   0     G_u ]   off_mom, off_up
    [ 0      A_vv  G_v ]   off_mom, off_vp
    [ D_u    D_v   C   ]   off_pu, off_pv, off_pp

Every neighbor sum goes through ``mesh.banded_dot`` and the momentum predict
through ``mesh.banded_jacobi_sweeps`` (the CUDA kernels of
:mod:`.banded_kernels`), so the (N, K) gathered values never reach device
memory.  Solve vectors are component-major (3, N), as in the JAX package.
The JAX package's pre-blocked ``*B`` coefficient twins are a TPU relayout
and have no counterpart here: the kernels read the (N, K) planes as they are.
Duck-types ``P_diag``/``P_off``/``diag_p_inv`` for
:func:`.amg.make_pressure_solve`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import banded_kernels as bk


@dataclass
class EllSystem:
    # (N, K) per-slot off-diagonal coefficients
    off_mom: torch.Tensor
    off_up: torch.Tensor
    off_vp: torch.Tensor
    off_pu: torch.Tensor
    off_pv: torch.Tensor
    off_pp: torch.Tensor
    P_off: torch.Tensor
    # (N,) diagonals
    diag_u: torch.Tensor
    diag_up: torch.Tensor
    diag_vp: torch.Tensor
    diag_pu: torch.Tensor
    diag_pv: torch.Tensor
    diag_pp: torch.Tensor
    P_diag: torch.Tensor
    diag_u_inv: torch.Tensor
    diag_p_inv: torch.Tensor
    rhs: torch.Tensor            # (N, 3)


def spmv(es: EllSystem, mesh, x: torch.Tensor) -> torch.Tensor:
    """y = A x, x (3, N) component-major; one fused banded dot shares the
    u/v/p neighbor reads and never materializes the (N, K, 3) gather."""
    mesh._need_banded()
    return spmv_window(es, x, x, mesh.ck_neighbor)


def spmv_window(es: EllSystem, x: torch.Tensor, xw: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """:func:`spmv` with the neighbor values read from ``xw`` (3, M)
    through ``idx`` (N, K): the whole vector and ``ck_neighbor``, or one
    rank's window of its cells and their halo and a map made local to it
    (parallel/spatial.py)."""
    xu, xv, xp = x[0], x[1], x[2]
    du = es.diag_u * xu + es.diag_up * xp
    dv = es.diag_u * xv + es.diag_vp * xp
    dp_ = es.diag_pu * xu + es.diag_pv * xv + es.diag_pp * xp
    su, sv, sp = bk.banded_dot(
        (xw[0], xw[1], xw[2]),
        (es.off_mom, es.off_up, es.off_vp, es.off_pu, es.off_pv, es.off_pp),
        idx,
        (((0, 0), (1, 2)),            # A_uu gu + G_u gp
         ((0, 1), (2, 2)),            # A_vv gv + G_v gp
         ((3, 0), (4, 1), (5, 2))))   # D_u gu + D_v gv + C gp
    return torch.stack([du + su, dv + sv, dp_ + sp], dim=0)


def _mom_dot2(es: EllSystem, mesh, z_u, z_v):
    """(A_off z_u, A_off z_v) sharing one kernel's neighbor reads."""
    return mesh.banded_dot((z_u, z_v), (es.off_mom,),
                           (((0, 0),), ((0, 1),)))


def _momentum_solve(es: EllSystem, mesh, r_u, r_v, sweeps: int):
    """Jacobi momentum predict (see stencil_system._momentum_solve); u and v
    share the neighbor reads.  With three or more sweeps all sweeps run in
    one call of ``mesh.banded_jacobi_sweeps``, otherwise one exact fused
    dot per sweep.  On a map without a slot cap the two compute the same
    sums, and the one call is taken at any size.  On a slot-capped map the
    one call drops the overflow slots, so it is taken only where the JAX
    package takes its one-kernel sweeps (``mesh.banded_sweeps_fit``: its
    TPU memory rule), which keeps the iteration counts of that package."""
    if sweeps >= 3 and (mesh.bd_k is None or mesh.banded_sweeps_fit(2)):
        return mesh.banded_jacobi_sweeps((r_u, r_v), es.diag_u_inv,
                                         es.off_mom, sweeps)
    z_u = es.diag_u_inv * r_u
    z_v = es.diag_u_inv * r_v
    for _ in range(sweeps - 1):
        su, sv = _mom_dot2(es, mesh, z_u, z_v)
        z_u = es.diag_u_inv * (r_u - su)
        z_v = es.diag_u_inv * (r_v - sv)
    return z_u, z_v


def chebyshev_pressure_solve(es: EllSystem, mesh, rhs_p, omega: float,
                             n_sweeps: int):
    x_cur = es.diag_p_inv * rhs_p
    x_prev = torch.zeros_like(rhs_p)
    for _ in range(n_sweeps):
        (sigma,) = mesh.banded_dot((x_cur,), (es.P_off,), (((0, 0),),))
        hat = es.diag_p_inv * (rhs_p - sigma)
        x_prev, x_cur = x_cur, x_prev + omega * (hat - x_prev)
    return x_cur


def schur_precond(es: EllSystem, mesh, r: torch.Tensor, omega: float,
                  n_sweeps: int, pressure_solve=None,
                  mom_sweeps: int = 1) -> torch.Tensor:
    """SIMPLE/Schur preconditioner M^{-1} r (reference schur_precond.wgsl),
    scalar-coefficient form; r is (3, N) component-major (see spmv)."""
    r_u, r_v, r_p = r[0].contiguous(), r[1].contiguous(), r[2]

    z_u, z_v = _momentum_solve(es, mesh, r_u, r_v, mom_sweeps)

    (sig_p,) = mesh.banded_dot((z_u, z_v), (es.off_pu, es.off_pv),
                               (((0, 0), (1, 1)),))
    rhs_p = r_p - es.diag_pu * z_u - es.diag_pv * z_v - sig_p

    if pressure_solve is None:
        z_p = chebyshev_pressure_solve(es, mesh, rhs_p, omega, n_sweeps)
    else:
        z_p = pressure_solve(rhs_p)

    sg_u, sg_v = mesh.banded_dot((z_p,), (es.off_up, es.off_vp),
                                 (((0, 0),), ((1, 0),)))
    g_u = es.diag_up * z_p + sg_u
    g_v = es.diag_vp * z_p + sg_v
    gz_u, gz_v = _momentum_solve(es, mesh, g_u, g_v, mom_sweeps)
    return torch.stack([z_u - gz_u, z_v - gz_v, z_p], dim=0)
