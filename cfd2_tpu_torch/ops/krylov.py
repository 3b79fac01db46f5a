"""CG and BiCGStab for the scalar systems of the segregated stepper.

Port of ``cfd2_tpu.ops.krylov`` (the reference's alternate linear-solver
path, shaders/linear_solver.wgsl:50-200 + scalars.wgsl).  The JAX package
runs each solver as one ``lax.while_loop`` with its scalar recurrences in
the carry; here the loop is Python and the recurrences stay 0-d device
tensors.  The loop condition (residual above target, iteration cap, and for
BiCGStab the breakdown flag) is read to the host once per iteration: one
synchronisation per iteration, plus one at entry (counted by
:mod:`..runtime.host_reads`).

With ``reduce`` (a sum across ranks, ``RowDecomposition.all_reduce_sum`` of
parallel/spatial.py) each rank holds its own rows of every vector and every
dot is summed across the ranks before it is used: every rank computes the
same scalars and reads the same loop test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..runtime.host_reads import read


@dataclass
class KrylovResult:
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor      # 0-d
    converged: torch.Tensor     # 0-d bool


def _dotter(reduce):
    """The dot product, summed across ranks by ``reduce`` when given."""
    if reduce is None:
        return lambda a, b: torch.sum(a * b)
    return lambda a, b: reduce(torch.sum(a * b))


def _nonzero(v, eps=1e-30):
    """v where |v| > eps, else eps (the JAX package's breakdown guards)."""
    return torch.where(torch.abs(v) > eps, v, eps)


def cg_solve(matvec: Callable, b: torch.Tensor, x0: torch.Tensor,
             precond: Callable | None = None,
             max_iters: int = 1000, tol: float = 1e-6,
             abstol: float = 1e-12, reduce=None) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD systems)."""
    M = precond if precond is not None else (lambda r: r)
    _dot = _dotter(reduce)
    target = torch.clamp(tol * torch.sqrt(_dot(b, b)), min=abstol)

    x = x0
    r = b - matvec(x0)
    z = M(r)
    p = z
    rz = _dot(r, z)
    it = 0
    while it < max_iters and bool(read(torch.sqrt(_dot(r, r)) > target)):
        Ap = matvec(p)
        alpha = rz / torch.clamp(_dot(p, Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    rn = torch.sqrt(_dot(r, r))
    return KrylovResult(x=x, iterations=it, residual=rn,
                        converged=rn <= target)


def bicgstab_solve(matvec: Callable, b: torch.Tensor, x0: torch.Tensor,
                   precond: Callable | None = None,
                   max_iters: int = 1000, tol: float = 1e-6,
                   abstol: float = 1e-12, reduce=None) -> KrylovResult:
    """Preconditioned BiCGStab (general nonsymmetric systems), the
    reference's spmv_p_v/spmv_s_t recurrence structure
    (linear_solver.wgsl:50-200), with its breakdown guard."""
    M = precond if precond is not None else (lambda r: r)
    _dot = _dotter(reduce)
    target = torch.clamp(tol * torch.sqrt(_dot(b, b)), min=abstol)

    x = x0
    r = b - matvec(x0)
    r_hat = r
    rho = _dot(r_hat, r)
    p = r
    brk = torch.zeros((), dtype=torch.bool, device=b.device)
    it = 0
    while it < max_iters and bool(read(
            (torch.sqrt(_dot(r, r)) > target) & ~brk)):
        p_hat = M(p)
        v = matvec(p_hat)
        alpha = rho / _nonzero(_dot(r_hat, v))
        s = r - alpha * v
        s_hat = M(s)
        t = matvec(s_hat)
        tt = _dot(t, t)
        omega = _dot(t, s) / torch.where(tt > 1e-30, tt, 1e-30)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        rho_new = _dot(r_hat, r)
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        brk = (torch.abs(rho_new) < 1e-30) | (torch.abs(omega) < 1e-30)
        rho = rho_new
        it += 1
    rn = torch.sqrt(_dot(r, r))
    return KrylovResult(x=x, iterations=it, residual=rn,
                        converged=rn <= target)
