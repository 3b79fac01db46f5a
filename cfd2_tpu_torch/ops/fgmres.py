"""Restarted FGMRES with right (flexible) preconditioning.

Port of ``cfd2_tpu.ops.fgmres.fgmres_solve``: one classical Gram-Schmidt
pass per iteration against the rows ``0..j`` of the basis (two
matrix-vector products over ``V[:j+1]``), Givens rotations, the true
residual recomputed after every cycle, and the restart-stagnation exit.
Numerics follow the reference: restart m=50, <=20 restarts, rtol 1e-5, atol
1e-7, stagnation after 3 restarts with <1e-3 relative improvement
(coupled_solver_fgmres.rs:1737-1740, 2403-2419).  The options of the JAX
function are all here: a bf16 basis, float64 norms, the in-cycle stall exit,
and the recycled warm start (``recycle`` / ``return_basis``).

The basis lives on the device as (m+1, D) rows of flattened vectors; the
user's matvec/precond always see the caller's shape (a contiguous
(3, ny, nx) tensor and its flat view share memory, so no relayout happens in
either direction).  The Hessenberg/Givens arithmetic on (m+1,) vectors runs
on the host in float32: the loop is eager, and its convergence test needs
the residual estimate on the host anyway.  Each Arnoldi iteration therefore
makes one device-to-host read (its Hessenberg column), each cycle one more
(the true residual), and each solve one at entry (the norms of b and r0),
plus two for a recycled warm start; see :mod:`..runtime.host_reads`.

With ``reduce`` (a sum across ranks, ``RowDecomposition.all_reduce_sum`` of
parallel/spatial.py) each rank holds its own rows of every vector: the
Gram-Schmidt dots and every norm are summed across the ranks before they
are used, so every rank computes the same Hessenberg column and rotations
and takes the same exits.
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
    # With return_basis: the last cycle's (V, Z, R, cs, sn, j) — V (m+1, D)
    # and Z (m, D) on the device, the Givens-rotated Hessenberg R (m, m) and
    # the rotations cs, sn (m,) as float32 numpy arrays, j the valid column
    # count.  Else None.
    basis: tuple | None = None


def _norm(v: torch.Tensor) -> torch.Tensor:
    """The float32 2-norm.  On the CPU it is the square root of
    ``torch.sum``'s cascaded sum of squares: torch's CPU ``vector_norm``
    accumulates float32 with an error that grows with the length
    (tests/test_torch_fgmres.py holds the norm to float64 at 1.2M
    entries)."""
    if v.device.type == "cpu":
        return torch.sqrt(torch.sum(v * v))
    return torch.linalg.vector_norm(v)


def _dots(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``V @ w``: each row's dot with ``w``.  On the CPU each is a cascaded
    ``torch.sum`` of the products, one row at a time: the BLAS product
    accumulates float32 along the rows with an error that grows with their
    length.  With both this and :func:`_norm` as torch's CPU library calls,
    the 403k Delaunay case's first step-2 solve ran to its restart cap
    (155 iterations against 98 on the card and in the JAX package)."""
    if w.device.type == "cpu":
        return torch.stack([torch.sum(v * w) for v in V])
    return torch.mv(V, w)


def make_norm(f64_norms: bool, dtype=torch.float32, reduce=None):
    """Norm used for the residuals and the convergence tests.

    With ``f64_norms`` the sum of squares accumulates in float64 and the
    norm comes back as ``dtype``: the stiff cases (water at rho=1000, whose
    squared f32 magnitudes saturate) need it.  The JAX package does the same
    only under ``jax_enable_x64`` and silently stays f32 without it; the
    port always does what the option says.  ``reduce``: the vector's rows
    are one rank's, and the sum of squares is summed across the ranks."""
    if reduce is not None:
        acc = torch.float64 if f64_norms else dtype
        return lambda v: torch.sqrt(
            reduce(torch.sum(v.to(acc) * v.to(acc)))).to(dtype)
    if not f64_norms:
        return _norm

    def nrm(v):
        return torch.linalg.vector_norm(v, dtype=torch.float64).to(dtype)

    return nrm


def zero_basis(m: int, D: int, basis_dtype, dtype, device) -> tuple:
    """The basis tuple of a solve that ran no Arnoldi cycle: zero rows and
    ``j = 0``, so a solve that recycles it starts cold."""
    return (torch.zeros((m + 1, D), dtype=basis_dtype, device=device),
            torch.zeros((m, D), dtype=dtype, device=device),
            np.zeros((m, m), np.float32), np.zeros(m, np.float32),
            np.zeros(m, np.float32), 0)


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


def _recycled_start(recycle, mv, nrm, x, r, beta0, reduce=None):
    """Least-squares projection of r0 onto a previous solve's search space
    (the JAX package's ``recycle`` warm start, GCRO-DR's projection-only
    form): d = V^T r0 on the device (one read), the stored rotations and the
    triangular solve over the leading healthy diagonal of R on the host,
    dx = Z y on the device, then one guard matvec and its norm (one read).
    The correction is taken only if it cuts ||r0|| below 0.7 of itself.
    Returns (x, r, beta0).

    With ``reduce`` the basis holds this rank's rows: d and the guard norm
    are summed across the ranks, and R and the rotations, made from reduced
    values, are the same on every rank, so every rank takes the same
    columns and the same decision."""
    V_r, Z_r, R_r, cs_r, sn_r, j_r = recycle
    d = _dots(V_r[:j_r + 1].to(r.dtype), r)
    if reduce is not None:
        d = reduce(d)
    d = read(d).astype(np.float32)
    for i in range(j_r):
        c, s = cs_r[i], sn_r[i]
        di, di1 = d[i], d[i + 1]
        d[i] = c * di + s * di1
        d[i + 1] = -s * di + c * di1
    # Only the leading columns whose diagonals are healthy: near the donor
    # solve's convergence the trailing diagonals are tiny, and R^{-1}
    # through them turns the projection into amplified f32 noise.
    diag = np.abs(np.diagonal(R_r)[:j_r])
    healthy = diag > np.float32(1e-4) * max(diag[0], np.float32(1e-30))
    nv = j_r if healthy.all() else int(np.argmin(healthy))
    if nv == 0:
        return x, r, beta0
    y = scipy.linalg.solve_triangular(R_r[:nv, :nv], d[:nv], lower=False)
    dx = torch.mv(Z_r[:nv].T, torch.as_tensor(y.astype(np.float32),
                                              device=x.device))
    r_try = r - mv(dx)
    rn_try = np.float32(read(nrm(r_try)))
    if rn_try < np.float32(0.7) * beta0:
        return x + dx, r_try, rn_try
    return x, r, beta0


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
    cgs_chunk_rows: int = 8,
    flatten: bool | None = None,
    basis_dtype=None,
    f64_norms: bool = False,
    incycle_window: int = 0,
    incycle_tol: float = 0.02,
    recycle: tuple | None = None,
    return_basis: bool = False,
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> FgmresResult:
    """Solve A x = b for vectors of any fixed shape (b.shape).

    ``cgs_chunk_rows`` and ``flatten`` are the JAX package's TPU layout and
    gating; here the vectors are always flattened and the Gram-Schmidt
    products read only the live rows ``V[:j+1]``, so both are ignored.

    ``basis_dtype``: storage dtype of V (default b.dtype).  With
    ``torch.bfloat16`` the rows are rounded on store and upcast to b.dtype
    for every product (an f32 copy of the live rows per iteration), as the
    JAX package promotes them; Z and all arithmetic stay b.dtype.

    ``f64_norms``: see :func:`make_norm`.

    ``incycle_window``: if > 0, end an Arnoldi cycle once the residual
    estimate |g_{j+1}| has not improved by ``incycle_tol`` (relative) over
    the last ``incycle_window`` iterations.

    ``recycle``: a previous solve's ``FgmresResult.basis``; the initial
    guess is first improved by :func:`_recycled_start`.  ``return_basis``:
    return this solve's last cycle in ``FgmresResult.basis`` (a zero basis
    when no cycle ran); with ``reduce``, its rows are this rank's.

    ``reduce``: see the module docstring."""
    m = restart
    shape = b.shape
    dtype = b.dtype
    bd = dtype if basis_dtype is None else basis_dtype
    nrm = make_norm(f64_norms, dtype, reduce)
    bf = b.reshape(-1)
    D = bf.numel()
    mv = lambda xf: matvec(xf.view(shape)).reshape(-1)
    pc = lambda rf: precond(rf.view(shape)).reshape(-1)
    x = x0.reshape(-1).clone()

    r = bf - mv(x)
    rhs_norm, beta0 = read(torch.stack([nrm(bf), nrm(r)]))
    target = max(np.float32(tol) * rhs_norm, np.float32(abstol))
    if recycle is not None and recycle[5] > 0:
        x, r, beta0 = _recycled_start(recycle, mv, nrm, x, r, beta0,
                                      reduce)

    V = torch.empty((m + 1, D), dtype=bd, device=b.device)
    Z = torch.empty((m, D), dtype=dtype, device=b.device)

    k = total = stag = 0
    conv = bool(beta0 < target)
    prev_res = _F32_MAX
    res = beta = beta0
    basis = None
    decay = np.float32(1.0 - incycle_tol)
    while k < max_restarts and not conv and beta > 0.0:
        # Seed V[0] = r / beta; r and its norm carry over from the previous
        # true-residual computation (same x, so the same values).
        V[0] = r * float(np.float32(1.0) / max(beta, np.float32(1e-30)))
        H = np.zeros((m, m), np.float32)
        cs = np.zeros(m, np.float32)
        sn = np.zeros(m, np.float32)
        g = np.zeros(m + 1, np.float32)
        g[0] = beta
        best_r, best_j = beta, 0
        j = 0
        while j < m:
            z = pc(V[j].to(dtype))
            Z[j] = z
            w = mv(z)
            Vj = V[:j + 1].to(dtype)
            dots = _dots(Vj, w)
            if reduce is not None:
                dots = reduce(dots)
            w = w - torch.mv(Vj.T, dots)
            hnorm = nrm(w)
            V[j + 1] = _safe_scale(w, hnorm)
            h = read(torch.cat([dots, hnorm[None]]))
            H[:j + 1, j] = _givens_column(h, cs, sn, j)
            gj = g[j]
            g[j] = cs[j] * gj
            g[j + 1] = -sn[j] * gj
            j += 1
            resid = abs(g[j])
            stop = resid < target
            if incycle_window > 0:
                if resid < decay * best_r:
                    best_r, best_j = resid, j
                stop = stop or j - best_j >= incycle_window
            if stop:
                break
        y = scipy.linalg.solve_triangular(H[:j, :j], g[:j], lower=False)
        yt = torch.as_tensor(y.astype(np.float32), device=b.device)
        x = x + torch.mv(Z[:j].T, yt)
        total += j
        if return_basis:
            basis = (V, Z, H, cs, sn, j)

        # True residual after the cycle (coupled_solver_fgmres.rs:2354-2373).
        r = bf - mv(x)
        res_new = np.float32(read(nrm(r)))
        conv = bool(res_new < target)
        # Stagnation across restarts (:2403-2419).
        improvement = (prev_res - res_new) / max(prev_res, np.float32(1e-30))
        stag = stag + 1 if improvement < stagnation_tol else 0
        conv = conv or stag >= stagnation_limit
        prev_res = res = beta = res_new
        k += 1

    if return_basis and basis is None:
        basis = zero_basis(m, D, bd, dtype, b.device)
    return FgmresResult(x=x.view(shape), iterations=total,
                        residual=float(res), converged=conv, basis=basis)
