"""Restarted FGMRES with right (flexible) preconditioning.

Port of ``cfd2_tpu.ops.fgmres.fgmres_solve`` on its default path: a float32
Krylov basis, one classical Gram-Schmidt pass per iteration against the rows
``0..j`` of the basis (two matrix-vector products over ``V[:j+1]``), Givens
rotations, the true residual recomputed after every cycle, and the
restart-stagnation exit.  Numerics follow the reference: restart m=50, <=20
restarts, rtol 1e-5, atol 1e-7, stagnation after 3 restarts with <1e-3
relative improvement (coupled_solver_fgmres.rs:1737-1740, 2403-2419).

The basis lives on the device as (m+1, D) rows of flattened vectors; the
user's matvec/precond always see the caller's shape (a contiguous
(3, ny, nx) tensor and its flat view share memory, so no relayout happens in
either direction).  The Hessenberg/Givens arithmetic on (m+1,) vectors runs
on the host in float32: the loop is eager, and its convergence test needs
the residual estimate on the host anyway.  Each Arnoldi iteration therefore
makes one device-to-host read (its Hessenberg column), each cycle one more
(the true residual), and each solve one at entry (the norms of b and r0);
see :mod:`..runtime.host_reads`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import scipy.linalg
import torch

from ..runtime.host_reads import read

_F32_MAX = np.float32(np.finfo(np.float32).max)


@dataclass
class FgmresResult:
    x: torch.Tensor            # solution, the shape of b
    iterations: int            # total inner iterations
    residual: float            # final (true) residual norm
    converged: bool


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def _safe_scale(v: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    return torch.where(nrm > 0.0, 1.0 / torch.clamp(nrm, min=1e-30), 0.0) * v


def _givens_column(h: np.ndarray, cs: np.ndarray, sn: np.ndarray, j: int):
    """Apply rotations 0..j-1 to the Hessenberg column ``h`` (length j+2),
    then build rotation j annihilating h[j+1].  Float32 throughout."""
    h = h.astype(np.float32)
    for i in range(j):
        hi, hi1 = h[i], h[i + 1]
        h[i] = cs[i] * hi + sn[i] * hi1
        h[i + 1] = -sn[i] * hi + cs[i] * hi1
    a, b = h[j], h[j + 1]
    r = np.float32(np.sqrt(a * a + b * b))
    if r > 1e-30:
        c, s = a / r, b / r
    else:
        c, s = np.float32(1.0), np.float32(0.0)
    cs[j], sn[j] = c, s
    h[j] = c * a + s * b
    h[j + 1] = 0.0
    return h[:j + 1]


def fgmres_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    restart: int = 50,
    max_restarts: int = 20,
    tol: float = 1e-5,
    abstol: float = 1e-7,
    stagnation_tol: float = 1e-3,
    stagnation_limit: int = 3,
    basis_dtype=None,
    f64_norms: bool = False,
    incycle_window: int = 0,
    recycle=None,
    return_basis: bool = False,
) -> FgmresResult:
    """Solve A x = b for vectors of any fixed shape (b.shape)."""
    if basis_dtype not in (None, torch.float32) or f64_norms \
            or incycle_window or recycle is not None or return_basis:
        raise NotImplementedError(
            "only the default FGMRES path is ported (f32 basis and norms, "
            "no in-cycle exit, no Krylov recycling)")
    m = restart
    shape = b.shape
    dtype = b.dtype
    bf = b.reshape(-1)
    D = bf.numel()
    mv = lambda xf: matvec(xf.view(shape)).reshape(-1)
    pc = lambda rf: precond(rf.view(shape)).reshape(-1)
    x = x0.reshape(-1).clone()

    r = bf - mv(x)
    rhs_norm, beta0 = read(torch.stack([_norm(bf), _norm(r)]))
    target = max(np.float32(tol) * rhs_norm, np.float32(abstol))

    V = torch.empty((m + 1, D), dtype=dtype, device=b.device)
    Z = torch.empty((m, D), dtype=dtype, device=b.device)

    k = total = stag = 0
    conv = bool(beta0 < target)
    prev_res = _F32_MAX
    res = beta = beta0
    while k < max_restarts and not conv and beta > 0.0:
        # Seed V[0] = r / beta; r and its norm carry over from the previous
        # true-residual computation (same x, so the same values).
        V[0] = r * float(np.float32(1.0) / max(beta, np.float32(1e-30)))
        H = np.zeros((m, m), np.float32)
        cs = np.zeros(m, np.float32)
        sn = np.zeros(m, np.float32)
        g = np.zeros(m + 1, np.float32)
        g[0] = beta
        j = 0
        while j < m:
            z = pc(V[j])
            Z[j] = z
            w = mv(z)
            Vj = V[:j + 1]
            dots = torch.mv(Vj, w)
            w = w - torch.mv(Vj.T, dots)
            hnorm = _norm(w)
            V[j + 1] = _safe_scale(w, hnorm)
            h = read(torch.cat([dots, hnorm[None]]))
            H[:j + 1, j] = _givens_column(h, cs, sn, j)
            gj = g[j]
            g[j] = cs[j] * gj
            g[j + 1] = -sn[j] * gj
            j += 1
            if abs(g[j]) < target:
                break
        y = scipy.linalg.solve_triangular(H[:j, :j], g[:j], lower=False)
        yt = torch.as_tensor(y.astype(np.float32), device=b.device)
        x = x + torch.mv(Z[:j].T, yt)
        total += j

        # True residual after the cycle (coupled_solver_fgmres.rs:2354-2373).
        r = bf - mv(x)
        res_new = np.float32(read(_norm(r)))
        conv = bool(res_new < target)
        # Stagnation across restarts (:2403-2419).
        improvement = (prev_res - res_new) / max(prev_res, np.float32(1e-30))
        stag = stag + 1 if improvement < stagnation_tol else 0
        conv = conv or stag >= stagnation_limit
        prev_res = res = beta = res_new
        k += 1

    return FgmresResult(x=x.view(shape), iterations=total,
                        residual=float(res), converged=conv)
