"""Structured geometric multigrid for the scalar pressure (Schur) system.

Port of the structured part of ``cfd2_tpu.ops.amg``: repeated 2x2 block
coarsening of the (ny, nx) grid, piecewise-constant transfers and the
Galerkin product, so that every level keeps the 5-point stencil.  The
hierarchy's index maps are built once on the host in NumPy (the same code as
the JAX package); level values are recomputed per assembly as 2D stencil sums,
and the V(1,1) cycle smooths each level with red-black Gauss-Seidel through
the kernels of :mod:`.stencil_kernels`, with a regularized dense LU at the
coarsest level.

The aggregation AMG of unstructured meshes and the multilevel (quadtree)
embedding are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import stencil_kernels as sk

_MIN_COARSE = 100
_MAX_LEVELS = 20
_NULL_SHIFT = 1e-3  # shifted-Laplacian regularization (see below)


@dataclass(frozen=True)
class StructuredAmgLevel:
    """Grid-structured coarse level: 2x2 block coarsening of a 5-point
    stencil stays 5-point."""
    fine_grid: tuple             # (nyf, nxf) of the finer level
    grid: tuple                  # (nyc, nxc) of this level
    rap_target: torch.Tensor     # finer flattened values -> this level slots

    @property
    def n(self):
        return self.grid[0] * self.grid[1]


@dataclass(frozen=True)
class StructuredAmgHierarchy:
    levels: tuple  # of StructuredAmgLevel
    # Level-0 masks for the stencil-form Galerkin coarsening: fluid-cell
    # diagonal validity (ny, nx) and internal-face validity per directional
    # slot (4, ny, nx).
    diag_valid2: torch.Tensor | None = None
    internal2: torch.Tensor | None = None


# ----------------------------------------------------------------------
# Host-side setup


def _host(mesh, name: str) -> np.ndarray:
    """Host copy of a DeviceMesh array for setup-time consumers:
    encode_mesh's ``amg_host`` dict, else a copy back from the device."""
    host = getattr(mesh, "amg_host", None)
    if host is not None and name in host:
        return host[name]
    return getattr(mesh, name).cpu().numpy()


def _structured_rap_target(nyf, nxf, nyc, nxc, kf,
                           internal_mask=None, diag_valid=None):
    """Index map from a finer structured level's flattened values
    [diag (nf,); off (nf, kf) slots E,W,N,S,...] to the coarse flattened
    layout (nc, 5) = [diag, E, W, N, S] + dump slot."""
    nf = nyf * nxf
    nc = nyc * nxc
    dump = nc * 5
    j, i = np.divmod(np.arange(nf), nxf)
    J, I = j // 2, i // 2
    cidx = J * nxc + I

    targets = np.full(nf + nf * kf, dump, dtype=np.int64)
    tdiag = cidx * 5
    if diag_valid is not None:
        tdiag = np.where(diag_valid, tdiag, dump)
    targets[:nf] = tdiag

    # Directional slots: (di, dj, coarse slot id 1..4); stored slot-major.
    dirs = [(1, 0, 1), (-1, 0, 2), (0, 1, 3), (0, -1, 4)]
    for s, (di, dj, cslot) in enumerate(dirs):
        ii = i + di
        jj = j + dj
        valid = (ii >= 0) & (ii < nxf) & (jj >= 0) & (jj < nyf)
        if internal_mask is not None:
            valid &= internal_mask[:, s]
        In = np.where(valid, ii // 2, 0)
        Jn = np.where(valid, jj // 2, 0)
        same = (In == I) & (Jn == J)
        t = np.where(same, cidx * 5, cidx * 5 + cslot)
        t = np.where(valid, t, dump)
        targets[nf + s * nf:nf + (s + 1) * nf] = t
    return targets


def _structured_levels(ny, nx, internal0, diag_valid0, device,
                       min_coarse=_MIN_COARSE):
    """2x2 coarsening level chain over an (ny, nx) grid, stopping once a
    level has <= ``min_coarse`` cells (that level gets the dense solve)."""
    levels = []
    nyf, nxf = ny, nx
    first = True
    while nyf * nxf > min_coarse and len(levels) < _MAX_LEVELS \
            and (nyf > 1 or nxf > 1):
        nyc = (nyf + 1) // 2
        nxc = (nxf + 1) // 2
        targets = _structured_rap_target(
            nyf, nxf, nyc, nxc, 4,
            internal_mask=internal0 if first else None,
            diag_valid=diag_valid0 if first else None)
        levels.append(StructuredAmgLevel(
            fine_grid=(nyf, nxf), grid=(nyc, nxc),
            rap_target=torch.as_tensor(targets.astype(np.int32),
                                       device=device)))
        nyf, nxf = nyc, nxc
        first = False
    return levels


def build_structured_hierarchy(mesh, min_coarse=_MIN_COARSE
                               ) -> StructuredAmgHierarchy | None:
    """Geometric-aggregation multigrid for structured meshes: repeated 2x2
    block coarsening, built from encode-time host copies of the masks."""
    if not mesh.structured:
        return None
    ny, nx = mesh.grid_shape
    internal0 = (_host(mesh, "ck_mask")
                 * (1.0 - _host(mesh, "ck_is_boundary"))) > 0
    internal0 = internal0[:, :4]
    diag_valid0 = _host(mesh, "c_valid") > 0

    levels = _structured_levels(ny, nx, internal0, diag_valid0, mesh.device,
                                min_coarse=min_coarse)
    if not levels:
        return None
    diag_valid2 = torch.as_tensor(
        diag_valid0.reshape(ny, nx).astype(np.float32), device=mesh.device)
    internal2 = torch.as_tensor(np.ascontiguousarray(
        np.moveaxis(internal0.reshape(ny, nx, 4), 2, 0)).astype(np.float32),
        device=mesh.device)
    return StructuredAmgHierarchy(levels=tuple(levels),
                                  diag_valid2=diag_valid2,
                                  internal2=internal2)


def build_hierarchy_for_mesh(mesh, agg_passes: int = 0):
    """The pressure hierarchy of a DeviceMesh: the geometric 2x2 multigrid on
    structured meshes.  None if the mesh is too small."""
    if not mesh.structured:
        raise NotImplementedError(
            "only the structured multigrid is ported; the aggregation AMG "
            "of unstructured meshes is later work")
    return build_structured_hierarchy(mesh)


# ----------------------------------------------------------------------
# Coarsest-level dense solve


def _dense_factor(diag, off, cols):
    """LU-factorize the coarsest-level matrix: scatter the ELL values into a
    dense (nc, nc) matrix and factor once; rows with zero diagonal are
    regularized to identity.  The Tikhonov shift ``1e-4*mean|diag|`` caps
    the condition number of the near-singular constant pressure mode."""
    nc = diag.shape[0]
    cols = cols.long()
    rows = torch.arange(nc, device=diag.device).repeat_interleave(
        cols.shape[1])
    eps = 1e-4 * torch.mean(torch.abs(diag))
    A = torch.zeros((nc, nc), dtype=diag.dtype, device=diag.device)
    ar = torch.arange(nc, device=diag.device)
    A.index_put_((ar, ar), diag + eps + torch.where(torch.abs(diag) < 1e-30,
                                                    1.0, 0.0),
                 accumulate=True)
    A.index_put_((rows, cols.reshape(-1)), off.reshape(-1), accumulate=True)
    return torch.linalg.lu_factor(A)


def _dense_solve_factored(factors, b):
    LU, piv = factors
    return torch.linalg.lu_solve(LU, piv, b[:, None])[:, 0]


# ----------------------------------------------------------------------
# Stencil ops on one level


class _GridOps:
    """Stencil ops on one structured level (E,W,N,S edge-clamped shifts),
    2D-native: state (ny, nx), values (ny, nx) / (4, ny, nx)."""

    def __init__(self, grid):
        self.ny, self.nx = grid

    def neighbor_cols(self, device=None):
        """(n, 4) clamped neighbour column indices [E,W,N,S]."""
        ny, nx = self.ny, self.nx
        j, i = np.divmod(np.arange(ny * nx), nx)
        e = j * nx + np.minimum(i + 1, nx - 1)
        w = j * nx + np.maximum(i - 1, 0)
        n = np.minimum(j + 1, ny - 1) * nx + i
        s = np.maximum(j - 1, 0) * nx + i
        return torch.as_tensor(np.stack([e, w, n, s], axis=1).astype(np.int32),
                               device=device)

    def spmv2(self, diag2, off2, xg):
        return diag2 * xg + sk._sigma2(off2, xg)

    def smooth_rbgs2(self, diag2, off2, xg, bg, sweeps=1):
        """Red-black Gauss-Seidel on 2D grids (plain stencils)."""
        return sk.rbgs_leg_ref(xg, diag2, off2, bg, sweeps=sweeps)

    def restrict2(self, coarse_grid, rg):
        """2x2 block sums (zero-padded to an even grid)."""
        nyc, nxc = coarse_grid
        rg = F.pad(rg, (0, 2 * nxc - self.nx, 0, 2 * nyc - self.ny))
        return rg.reshape(nyc, 2, nxc, 2).sum(dim=(1, 3))

    def prolong2(self, coarse_grid, xcg):
        """Piecewise-constant 2x upsample, cropped to this level's grid."""
        full = xcg.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        return full[:self.ny, :self.nx]


def compute_structured_level_values2(hier: StructuredAmgHierarchy,
                                     P_diag2: torch.Tensor,
                                     P_off2: torch.Tensor):
    """Galerkin-coarsen values down the structured hierarchy as 2D stencil
    sums.  For 2x2 piecewise-constant aggregation of a 5-point stencil, a
    fine E entry at even x couples cells of the same block (-> coarse
    diagonal) and at odd x crosses the block boundary (-> coarse E slot),
    mirrored for W/N/S; the coarse entry is the 2x2 block sum.

    The fine diagonal is shifted by ``_NULL_SHIFT * |diag|`` first: the
    pressure operator's constant mode is near-null (Dirichlet only at the
    outlet), and the shift caps the condition.  Takes ``P_diag2`` (ny, nx),
    ``P_off2`` (4+, ny, nx); returns ``[(diag2, off2), ...]`` per level,
    coarsest last."""
    d0 = P_diag2 + _NULL_SHIFT * torch.abs(P_diag2)
    vals = [(d0, P_off2[:4])]
    for li, lvl in enumerate(hier.levels):
        d, off = vals[-1]
        if li == 0:
            # The masks apply to the level-0 -> 1 transition only; level-0
            # values themselves stay raw for the fine smoother.
            d = d * hier.diag_valid2
            off = off * hier.internal2
        nyf, nxf = lvl.fine_grid
        ops = _GridOps(lvl.fine_grid)
        evx = (torch.arange(nxf, device=d.device) % 2 == 0).to(d.dtype)[None, :]
        evy = (torch.arange(nyf, device=d.device) % 2 == 0).to(d.dtype)[:, None]
        odx = 1.0 - evx
        ody = 1.0 - evy
        within = off[0] * evx + off[1] * odx + off[2] * evy + off[3] * ody
        dc = ops.restrict2(lvl.grid, d + within)
        oc = torch.stack([ops.restrict2(lvl.grid, off[0] * odx),
                          ops.restrict2(lvl.grid, off[1] * evx),
                          ops.restrict2(lvl.grid, off[2] * ody),
                          ops.restrict2(lvl.grid, off[3] * evy)])
        vals.append((dc, oc))
    return vals


def structured_level_values_2d(hier: StructuredAmgHierarchy, level_values):
    """Reshape flat per-level values [(n,), (n,4)] to 2D grid form
    [(ny,nx), (4,ny,nx)]; values already in 2D form pass through."""
    grids = [hier.levels[0].fine_grid] + [lvl.grid for lvl in hier.levels]
    out = []
    for (ny, nx), (d, o) in zip(grids, level_values):
        if d.dim() == 2:
            out.append((d, o))
        else:
            out.append((d.reshape(ny, nx), o.T.reshape(4, ny, nx)))
    return out


def _coarse_factors(hier, lv2):
    dc, oc = lv2[-1]
    return _dense_factor(
        dc.reshape(-1), oc.reshape(4, -1).T,
        _GridOps(hier.levels[-1].grid).neighbor_cols(dc.device))


def structured_v_cycle(hier: StructuredAmgHierarchy, level_values,
                       b0: torch.Tensor, x0: torch.Tensor,
                       coarse_factors=None, sweeps: int = 1) -> torch.Tensor:
    """One V(1,1)-cycle with red-black Gauss-Seidel smoothing and an exact
    (dense, regularized) coarsest solve.  ``coarse_factors``: precomputed LU
    of the coarsest matrix; computed here when None.

    The smoother follows :func:`.stencil_kernels.smoother_level`: at level 2
    each level's down leg is one :func:`~.stencil_kernels.rbgs_leg` launch
    with the residual and its up leg one without (2 launches per level); at
    level 1 each half-sweep is one :func:`~.stencil_kernels.rbgs_half_sweep`
    launch on the flat layout; level 0 (CPU only) runs the plain stencils."""
    L = len(hier.levels)
    grids = [hier.levels[0].fine_grid] + [lvl.grid for lvl in hier.levels]
    ops = [_GridOps(g) for g in grids]
    lv2 = structured_level_values_2d(hier, level_values)
    level = sk.smoother_level(b0.device)

    def smooth(i, xg, bg):
        diag2, off2 = lv2[i]
        if level == 2:
            return sk.rbgs_leg(xg, diag2, off2, bg, sweeps=sweeps)
        if level == 1:
            ny, nx = grids[i]
            off_flat = off2.reshape(4, ny * nx).T.contiguous()
            x = sk.smooth_rbgs_half_sweeps((ny, nx), diag2.reshape(-1),
                                           off_flat, xg.reshape(-1),
                                           bg.reshape(-1), sweeps=sweeps)
            return x.reshape(ny, nx)
        return ops[i].smooth_rbgs2(diag2, off2, xg, bg, sweeps=sweeps)

    xs = [x0.reshape(grids[0])]
    bs = [b0.reshape(grids[0])]
    for i in range(L):
        diag2, off2 = lv2[i]
        if level == 2:
            x, r = sk.rbgs_leg(xs[i], diag2, off2, bs[i], sweeps=sweeps,
                               residual=True)
        else:
            x = smooth(i, xs[i], bs[i])
            r = bs[i] - ops[i].spmv2(diag2, off2, x)
        xs[i] = x
        bs.append(ops[i].restrict2(grids[i + 1], r))
        xs.append(torch.zeros(grids[i + 1], dtype=x0.dtype, device=x0.device))

    if coarse_factors is None:
        coarse_factors = _coarse_factors(hier, lv2)
    xs[L] = _dense_solve_factored(
        coarse_factors, bs[L].reshape(-1)).reshape(grids[L])

    for i in reversed(range(L)):
        x = xs[i] + ops[i].prolong2(grids[i + 1], xs[i + 1])
        xs[i] = smooth(i, x, bs[i])
    return xs[0].reshape(-1)
