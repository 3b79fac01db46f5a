"""2D-native coupled operator for structured meshes.

Port of ``cfd2_tpu.ops.stencil_system``: the coupled (u, v, p) system is kept
as the 6 structurally nonzero block entries per directional slot, each a
(4, ny, nx) plane, plus (ny, nx) diagonals, and every operator application is
a stencil of edge-clamped shifts and multiply-adds on (ny, nx) planes.
Vectors of the Krylov solve are (3, ny, nx) component planes; ``spmv`` and
``schur_precond`` also take (N, 3) interleaved vectors, as the JAX package's
first forms do.  Beside the Jacobi momentum predict the preconditioner has
its red-black and ADI (truncated-PCR line solve) forms, and the presolve's
pressure CG (``pcg_pressure``, ``schur_guess``) lives here too.

Off-diagonal coefficients are identically zero at boundary/extra slots (the
assembly multiplies them by the internal-face mask), so edge-clamped shifts
never contribute.

On a row-sharded mesh (parallel/spatial.py) the system holds this rank's
rows and its ``decomp``: every shift takes the neighbouring ranks' edge rows
(one exchange per shifted group of planes), the ADI predict's column solves
take 15 ghost rows (:func:`_column_solves`), and every sum and norm is
reduced across the ranks.

The main path's operators (the matvec :func:`spmv_planar` and, in the Schur
preconditioner, the Jacobi momentum predict, the Schur right-hand side and
the pressure gradient) go through ``ops/stencil_kernels.py``: one
hand-written CUDA kernel each on float32 CUDA tensors, the plain version on
the CPU, bit-equal either way.  The other forms keep their plain ops on
every device, by explicit branches: the bf16 preconditioner
(:func:`cast_coeffs`), the red-black and ADI momentum predicts, the
Chebyshev pressure sweeps and the presolve's pressure operator.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from . import stencil_kernels as sk
from .stencil_kernels import dot4 as _dot4
from .stencil_kernels import plane_shifts as _plane


def _halo(ss, x: torch.Tensor):
    """``(below, above)``: the rows beyond this block of ``x`` (..., ny, nx)
    for its N and S shifts; (None, None) unsharded (the block's own edge
    rows), else from the neighbouring ranks, one exchange for all leading
    planes."""
    if ss.decomp is None:
        return None, None
    return ss.decomp.halo_rows(x, 1, dim=x.dim() - 2)


def _shifts(ss, x: torch.Tensor):
    """Edge-clamped E, W, N, S neighbour planes of ``x`` (..., ny, nx); on a
    row-sharded system N and S read across an inner block edge from the
    neighbouring ranks."""
    return sk.edge_shifts(x, *_halo(ss, x))


def _kernels(x: torch.Tensor) -> bool:
    """Whether an operator on ``x`` goes through stencil_kernels' wrappers
    (the kernel for a CUDA tensor, the plain version for a CPU one).  The
    bf16 form (SolverConfig.precond_bf16's :func:`cast_coeffs` system) keeps
    its plain ops on every device: its kernels are still to come (ROADMAP)."""
    return x.dtype is torch.float32


def _sum(ss, x: torch.Tensor) -> torch.Tensor:
    """Sum over every cell (of every rank on a row-sharded system)."""
    t = torch.sum(x)
    return t if ss.decomp is None else ss.decomp.all_reduce_sum(t)


def norm(ss, x: torch.Tensor) -> torch.Tensor:
    """2-norm over every cell (of every rank on a row-sharded system)."""
    if ss.decomp is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(ss.decomp.all_reduce_sum(torch.sum(x * x)))


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
    # The mesh's row decomposition when row-sharded (parallel/spatial.py),
    # else None.
    decomp: object | None = None


def cast_coeffs(ss: StencilSystem, dtype) -> StencilSystem:
    """Copy of ``ss`` with every coefficient plane cast to ``dtype``
    (``grid`` and ``rhs`` kept): the bf16 Schur preconditioner reads it
    (SolverConfig.precond_bf16) while the matvec keeps the f32 system."""
    return StencilSystem(**{
        f.name: (getattr(ss, f.name) if f.name in ("grid", "rhs", "decomp")
                 else getattr(ss, f.name).to(dtype))
        for f in fields(StencilSystem)})


def _split3(x: torch.Tensor, grid):
    """(N, 3) interleaved -> its three (ny, nx) component grids."""
    ny, nx = grid
    return (x[:, 0].reshape(ny, nx), x[:, 1].reshape(ny, nx),
            x[:, 2].reshape(ny, nx))


def spmv(ss: StencilSystem, x: torch.Tensor) -> torch.Tensor:
    """y = A x on (N, 3) interleaved vectors (the JAX package's first form;
    the same arithmetic as :func:`spmv_planar`)."""
    return from_planar(ss, spmv_planar(ss, torch.stack(_split3(x, ss.grid))))


def spmv_planar(ss: StencilSystem, x: torch.Tensor) -> torch.Tensor:
    """y = A x with x, y of shape (3, ny, nx) (component planes): the
    ``coupled_spmv`` kernel on the card."""
    offs = (ss.off_mom, ss.off_up, ss.off_vp, ss.off_pu, ss.off_pv,
            ss.off_pp)
    diags = (ss.diag_u2, ss.diag_up2, ss.diag_vp2, ss.diag_pu2, ss.diag_pv2,
             ss.diag_pp2)
    return sk.coupled_spmv(x, offs, diags, *_halo(ss, x))


def chebyshev_pressure_solve2(ss: StencilSystem, rhs_p2: torch.Tensor,
                              omega: float, n_sweeps: int) -> torch.Tensor:
    """Two-term damped-Jacobi recurrence on the scalar pressure system
    (reference schur_precond.wgsl:49-90)."""
    x_prev = torch.zeros_like(rhs_p2)
    x_cur = ss.diag_p_inv2 * rhs_p2
    for _ in range(n_sweeps):
        sigma = _dot4(ss.P_off2, _shifts(ss, x_cur))
        hat = ss.diag_p_inv2 * (rhs_p2 - sigma)
        x_prev, x_cur = x_cur, x_prev + omega * (hat - x_prev)
    return x_cur


def _jacobi(ss: StencilSystem, r2: torch.Tensor, sweeps: int):
    """The Jacobi momentum predict of the (2, ny, nx) block (r_u, r_v):
    :func:`stencil_kernels.momentum_jacobi` (its kernel on the card), or its
    plain version for the bf16 form."""
    fn = sk.momentum_jacobi if _kernels(r2) else sk.momentum_jacobi_ref
    halo = (None if ss.decomp is None
            else lambda z: ss.decomp.halo_rows(z, 1, dim=1))
    return fn(r2, ss.diag_u_inv2, ss.off_mom, sweeps, halo=halo)


def _momentum_solve(ss: StencilSystem, r_u, r_v, sweeps: int,
                    rbgs: bool = False):
    """Approximate A_uu^{-1} applied to (r_u, r_v): Jacobi iteration seeded
    with the diagonal predict.  ``sweeps=1`` is the reference's SIMPLE
    diagonal approximation (schur_precond.wgsl:19-34); extra sweeps fold
    the momentum off-diagonals in.  ``rbgs=True`` makes each sweep a
    red-black Gauss-Seidel sweep (two coloured half-passes; plain ops on
    every device)."""
    if not rbgs:
        z = _jacobi(ss, torch.stack([r_u, r_v]), sweeps)
        return z[0], z[1]
    z_u = ss.diag_u_inv2 * r_u
    z_v = ss.diag_u_inv2 * r_v
    ny, nx = ss.grid
    dev = r_u.device
    row0 = 0 if ss.decomp is None else ss.decomp.r0    # the global colour
    color = (torch.arange(row0, row0 + ny, device=dev)[:, None]
             + torch.arange(nx, device=dev)[None, :]) % 2
    for _ in range(sweeps - 1):
        for c in (0, 1):
            sh = _shifts(ss, torch.stack([z_u, z_v]))
            zn_u = ss.diag_u_inv2 * (r_u - _dot4(ss.off_mom, _plane(sh, 0)))
            zn_v = ss.diag_u_inv2 * (r_v - _dot4(ss.off_mom, _plane(sh, 1)))
            z_u = torch.where(color == c, zn_u, z_u)
            z_v = torch.where(color == c, zn_v, z_v)
    return z_u, z_v


def _shift_along(x: torch.Tensor, s: int, axis: int,
                 fill: float) -> torch.Tensor:
    """Value from index i+s along ``axis`` (s may be negative), edges filled
    with ``fill``."""
    n = x.shape[axis]
    pad = torch.full_like(x.narrow(axis, 0, abs(s)), fill)
    if s > 0:
        return torch.cat([x.narrow(axis, s, n - s), pad], dim=axis)
    return torch.cat([pad, x.narrow(axis, 0, n + s)], dim=axis)


def pcr_line_solve(a, b, c, r, axis: int, steps: int = 4) -> torch.Tensor:
    """Approximate batched tridiagonal solve along ``axis`` by truncated
    parallel cyclic reduction: row i couples (a_i, b_i, c_i) to
    (i-1, i, i+1); step k eliminates the couplings at distance 2^k, and
    ``steps`` steps end in a diagonal solve.  Boundary rows carry
    a_0 = c_last = 0, which PCR propagates, so zero-filled shifts are
    exact."""
    for k in range(steps):
        s = 1 << k
        b_m = _shift_along(b, -s, axis, 1.0)
        b_p = _shift_along(b, +s, axis, 1.0)
        a_m = _shift_along(a, -s, axis, 0.0)
        c_m = _shift_along(c, -s, axis, 0.0)
        a_p = _shift_along(a, +s, axis, 0.0)
        c_p = _shift_along(c, +s, axis, 0.0)
        r_m = _shift_along(r, -s, axis, 0.0)
        r_p = _shift_along(r, +s, axis, 0.0)
        alpha = a / b_m
        gamma = c / b_p
        b = b - alpha * c_m - gamma * a_p
        r = r - alpha * r_m - gamma * r_p
        a = -alpha * a_m
        c = -gamma * c_p
    return r / b


def _column_solves(ss: StencilSystem, a, b, c, rhs_u, rhs_v, steps: int):
    """The y-direction line solves of both components (one matrix).  On a
    row-sharded system the columns cross every rank: PCR step k reads the
    rows 2^k away, so the rank solves on its block plus 2^steps - 1 ghost
    rows from each neighbour (one exchange of the five planes; all-gathered
    where a block is shallower, :meth:`RowDecomposition.extend_deep`).  The
    steps spoil only ghost rows, and at the grid's edges the window ends
    where the grid does, so ``_shift_along``'s fills are the global ones:
    the block's rows are one process's bits."""
    if ss.decomp is None:
        return (pcr_line_solve(a, b, c, rhs_u, axis=0, steps=steps),
                pcr_line_solve(a, b, c, rhs_v, axis=0, steps=steps))
    ny = a.shape[0]
    ext, lo = ss.decomp.extend_deep(torch.stack([a, b, c, rhs_u, rhs_v]),
                                    (1 << steps) - 1, dim=1)
    z = [pcr_line_solve(ext[0], ext[1], ext[2], r, axis=0,
                        steps=steps)[lo:lo + ny] for r in (ext[3], ext[4])]
    return z[0], z[1]


def _momentum_solve_adi(ss: StencilSystem, r_u, r_v, passes: int = 1,
                        steps: int = 4):
    """ADI line-relaxation momentum predict: implicit tridiagonal solves
    (truncated PCR) along x, then along y, the transverse coupling taken
    explicitly.  Slots: off_mom[0]=E (x+1), [1]=W, [2]=N (y+1), [3]=S."""
    cE, cW, cN, cS = (ss.off_mom[0], ss.off_mom[1], ss.off_mom[2],
                      ss.off_mom[3])
    b = 1.0 / ss.diag_u_inv2
    z_u = torch.zeros_like(r_u)
    z_v = torch.zeros_like(r_v)
    for _ in range(passes):
        # implicit in x, explicit in y
        sh = _shifts(ss, torch.stack([z_u, z_v]))
        rhs_u = r_u - _dot4(ss.off_mom, _plane(sh, 0)) \
            + cE * _shift_along(z_u, 1, 1, 0.0) \
            + cW * _shift_along(z_u, -1, 1, 0.0)
        rhs_v = r_v - _dot4(ss.off_mom, _plane(sh, 1)) \
            + cE * _shift_along(z_v, 1, 1, 0.0) \
            + cW * _shift_along(z_v, -1, 1, 0.0)
        z_u = pcr_line_solve(cW, b, cE, rhs_u, axis=1, steps=steps)
        z_v = pcr_line_solve(cW, b, cE, rhs_v, axis=1, steps=steps)
        # implicit in y, explicit in x
        rhs_u = r_u - cE * _shift_along(z_u, 1, 1, 0.0) \
            - cW * _shift_along(z_u, -1, 1, 0.0)
        rhs_v = r_v - cE * _shift_along(z_v, 1, 1, 0.0) \
            - cW * _shift_along(z_v, -1, 1, 0.0)
        z_u, z_v = _column_solves(ss, cS, b, cN, rhs_u, rhs_v, steps)
    return z_u, z_v


def _momentum_predict(ss: StencilSystem, mom_sweeps: int, mom_rbgs: bool,
                      mom_adi: int):
    """The momentum block of the Schur preconditioner as a function of the
    (2, ny, nx) block (r_u, r_v), returning (2, ny, nx): ``mom_adi`` ADI
    passes when > 0, else ``mom_sweeps`` Jacobi (or red-black) sweeps.  The
    Jacobi predict is :func:`_jacobi`; the red-black and ADI predicts keep
    their plain ops (their kernels are still to come: ROADMAP)."""
    if mom_adi <= 0 and not mom_rbgs:
        return lambda r2: _jacobi(ss, r2, mom_sweeps)
    if mom_adi > 0:
        solve = lambda a, b: _momentum_solve_adi(ss, a, b, passes=mom_adi)
    else:
        solve = lambda a, b: _momentum_solve(ss, a, b, mom_sweeps, rbgs=True)
    return lambda r2: torch.stack(solve(r2[0], r2[1]))


def _schur_rhs(ss: StencilSystem, rp, z):
    """r_p - D z: the pressure right-hand side after the momentum predict
    z (2, ny, nx)."""
    fn = sk.schur_rhs if _kernels(z) else sk.schur_rhs_ref
    return fn(rp, z, ss.diag_pu2, ss.diag_pv2, ss.off_pu, ss.off_pv,
              *_halo(ss, z))


def _gradient(ss: StencilSystem, z_p):
    """G z_p (2, ny, nx), the (u, v) rows' pressure coupling."""
    fn = sk.pressure_gradient if _kernels(z_p) else sk.pressure_gradient_ref
    return fn(z_p, ss.diag_up2, ss.diag_vp2, ss.off_up, ss.off_vp,
              *_halo(ss, z_p))


def schur_precond_planar(ss: StencilSystem, r: torch.Tensor, omega: float,
                         n_sweeps: int, pressure_solve=None,
                         mom_sweeps: int = 1, mom_rbgs: bool = False,
                         mom_adi: int = 0) -> torch.Tensor:
    """SIMPLE/Schur preconditioner M^{-1} r on (3, ny, nx) component planes
    (reference schur_precond.wgsl): momentum predict -> Schur RHS ->
    pressure solve -> velocity correct.  ``pressure_solve`` takes and
    returns an (ny, nx) grid; defaults to the Chebyshev sweeps.
    ``mom_adi`` > 0 replaces the Jacobi momentum predict with that many ADI
    passes, ``mom_rbgs`` makes its sweeps red-black."""
    mom = _momentum_predict(ss, mom_sweeps, mom_rbgs, mom_adi)
    z = mom(r[:2])
    rhs_p = _schur_rhs(ss, r[2], z)
    if pressure_solve is None:
        z_p = chebyshev_pressure_solve2(ss, rhs_p, omega, n_sweeps)
    else:
        z_p = pressure_solve(rhs_p)
    return torch.cat([z - mom(_gradient(ss, z_p)), z_p[None]])


def schur_precond(ss: StencilSystem, r: torch.Tensor, omega: float,
                  n_sweeps: int, pressure_solve=None) -> torch.Tensor:
    """The Schur preconditioner with the bare diagonal predict on (N, 3)
    interleaved vectors (the JAX package's first form)."""
    zp = schur_precond_planar(ss, torch.stack(_split3(r, ss.grid)), omega,
                              n_sweeps, pressure_solve=pressure_solve)
    return from_planar(ss, zp)


def pressure_apply(ss: StencilSystem, x2: torch.Tensor) -> torch.Tensor:
    """Scalar pressure (Schur) operator on an (ny, nx) grid: P x."""
    return ss.P_diag2 * x2 + _dot4(ss.P_off2, _shifts(ss, x2))


def pcg_pressure(ss: StencilSystem, rhs2: torch.Tensor, pressure_solve,
                 iters: int) -> torch.Tensor:
    """``iters`` preconditioned-CG iterations on the scalar pressure system,
    preconditioned by ``pressure_solve`` (a V-cycle of
    :func:`make_pressure_solve2` or the Chebyshev relaxation).  The scalars
    stay on the device: no host read."""
    x = torch.zeros_like(rhs2)
    r = rhs2
    z = pressure_solve(r)
    p = z
    rz = _sum(ss, r * z)
    for _ in range(iters):
        Ap = pressure_apply(ss, p)
        denom = _sum(ss, p * Ap)
        alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pressure_solve(r)
        rz_new = _sum(ss, r * z)
        beta = torch.where(torch.abs(rz) > 1e-30, rz_new / rz, 0.0)
        rz = rz_new
        p = z + beta * p
    return x


def schur_guess(ss: StencilSystem, r: torch.Tensor, omega: float,
                n_sweeps: int, pressure_solve=None, cg_iters: int = 8,
                mom_sweeps: int = 1, mom_adi: int = 0) -> torch.Tensor:
    """One SIMPLE/Schur correction whose pressure block runs ``cg_iters``
    preconditioned-CG iterations: the first-outer initial guess of
    the presolve (SolverConfig.presolve_pressure_iters).  It moves only the
    start point, so the solve's rtol/atol contract is untouched."""
    mom = _momentum_predict(ss, mom_sweeps, False, mom_adi)
    z = mom(r[:2])
    rhs_p = _schur_rhs(ss, r[2], z)
    if pressure_solve is None:
        pressure_solve = lambda rr: chebyshev_pressure_solve2(
            ss, rr, omega, n_sweeps)
    z_p = pcg_pressure(ss, rhs_p, pressure_solve, cg_iters)
    return torch.cat([z - mom(_gradient(ss, z_p)), z_p[None]])


def to_planar(ss: StencilSystem, x: torch.Tensor) -> torch.Tensor:
    """(N, 3) interleaved -> (3, ny, nx) planes (once per solve)."""
    ny, nx = ss.grid
    return x.T.reshape(3, ny, nx).contiguous()


def from_planar(ss: StencilSystem, x: torch.Tensor) -> torch.Tensor:
    """(3, ny, nx) planes -> (N, 3) interleaved (once per solve)."""
    return x.reshape(3, -1).T


def coarse_level_values2(hier, ss: StencilSystem):
    """:func:`coarse_level_values2_planes` from an assembled system."""
    return coarse_level_values2_planes(hier, ss.P_diag2, ss.P_off2,
                                       ss.decomp)


def coarse_level_values2_planes(hier, P_diag2, P_off2, decomp=None):
    """Galerkin-coarsen once from the planar pressure matrix, returning
    ``(coarse_vals, factors)`` for :func:`make_pressure_solve2`'s
    ``frozen=``: the level-1+ stencil values and the coarsest dense LU.  The
    fused step calls it once per timestep (SolverConfig.amg_freeze_coarse).
    ``decomp``: the planes are a row-sharded system's rows."""
    from .amg import _coarse_factors, compute_structured_level_values2
    lv2 = compute_structured_level_values2(hier, P_diag2, P_off2, decomp)
    return tuple(lv2[1:]), _coarse_factors(hier, lv2)


def make_pressure_solve2(hier, ss: StencilSystem, n_cycles: int = 1,
                         frozen=None):
    """Structured-multigrid pressure solve taking/returning (ny, nx) grids:
    ``n_cycles`` V-cycles from the Jacobi seed ``diag_p_inv * rhs``.

    With ``frozen`` (from :func:`coarse_level_values2_planes`) level 0 is
    re-derived from the current assembly and only the level-1+ Galerkin
    products and the coarsest LU are reused.  On a row-sharded system each
    cycle is :func:`.amg.sharded_v_cycle`."""
    from .amg import (StructuredAmgHierarchy, _coarse_factors,
                      _level0_values2, compute_structured_level_values2,
                      sharded_v_cycle, split_level, structured_v_cycle)

    if not isinstance(hier, StructuredAmgHierarchy):
        raise TypeError("make_pressure_solve2 needs a StructuredAmgHierarchy")
    decomp = ss.decomp
    if frozen is not None:
        coarse_vals, factors = frozen
        whole = decomp is not None and split_level(hier, decomp) == 0
        lv2 = [_level0_values2(ss.P_diag2, ss.P_off2, decomp, whole)] \
            + list(coarse_vals)
    else:
        lv2 = compute_structured_level_values2(hier, ss.P_diag2, ss.P_off2,
                                               decomp)
        factors = _coarse_factors(hier, lv2)
    if decomp is None:
        cycle = lambda b, x: structured_v_cycle(
            hier, lv2, b.reshape(-1), x.reshape(-1),
            coarse_factors=factors).reshape(ss.grid)
    else:
        cycle = sharded_v_cycle(hier, lv2, factors, decomp)

    def pressure_solve(rhs_p2):
        x = ss.diag_p_inv2 * rhs_p2
        for _ in range(n_cycles):
            x = cycle(rhs_p2, x)
        return x

    return pressure_solve
