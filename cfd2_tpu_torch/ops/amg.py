"""Multigrid for the scalar pressure (Schur) system.

Port of ``cfd2_tpu.ops.amg``, in two parts.

**Structured geometric multigrid**: repeated 2x2 block coarsening of the
(ny, nx) grid, piecewise-constant transfers and the Galerkin product, so that
every level keeps the 5-point stencil.  Level values are recomputed per
assembly as 2D stencil sums, and the V(1,1) cycle smooths each level with
red-black Gauss-Seidel through the kernels of :mod:`.stencil_kernels`.

**Aggregation AMG** (unstructured meshes): greedy aggregation over the
pressure sparsity pattern in device cell order (one or two passes per level),
piecewise-constant prolongation, and the *structure* of each Galerkin coarse
operator as an index map (``rap_target``), all built once on the host in
NumPy with the same code as the JAX package.  Level values are one sum per
coarse slot over the finer values that ``rap_target`` routes to it (the JAX
package's ``segment_sum``), taken in a fixed order so that a run repeats bit
for bit.  The V-cycle (damped Jacobi or
Chebyshev smoothing) takes every neighbor sum, the restriction (a dot over
the aggregate member lists) and the prolongation (a K = 1 gather through the
aggregate map) through the CUDA kernels of :mod:`.banded_kernels`, on every
level.

Both end in a regularized dense LU at the coarsest level.  The multilevel
(quadtree) embedding is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import banded_kernels as bk
from . import stencil_kernels as sk

_OMEGA = 0.8
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


@dataclass(frozen=True)
class AmgLevel:
    """One coarse level of the aggregation hierarchy (level 0 is the fine
    pressure system itself).  Index tensors are int32 and contiguous: they
    are the (M, K) maps the banded kernels take."""
    n: int                       # size
    k: int                       # max neighbors in ELL
    ell_neighbor: torch.Tensor   # (n, k) int32; pad slots repeat a neighbor
    rap_target: torch.Tensor     # flattened finer values -> this level's slots
    # The same map sorted by target, for a Galerkin sum that adds in a fixed
    # order: the (n_flat, 1) permutation that groups the finer values by
    # slot, and the number of values per slot (dump slot last).
    rap_order: torch.Tensor      # (n_flat, 1) int32
    rap_lengths: torch.Tensor    # (n * (k + 1) + 1,) int64
    agg: torch.Tensor            # (n_fine, 1) int32 aggregate id (prolongation)
    members: torch.Tensor        # (n, m) int32 fine members (restriction)
    members_mask: torch.Tensor   # (n, m) f32


@dataclass(frozen=True)
class AmgHierarchy:
    levels: tuple  # of AmgLevel, coarsest last; empty if mesh too small


# ----------------------------------------------------------------------
# Host-side setup


def _aggregate_ell(ngh: np.ndarray, mask: np.ndarray) -> tuple[np.ndarray, int]:
    """Greedy aggregation over an ELL adjacency (reference amg.rs:84-116):
    each unaggregated cell seeds an aggregate and absorbs its unaggregated
    neighbors.  Uses the native C++ kernel when available (the scan is
    inherently sequential)."""
    from ..mesh import native
    res = native.amg_aggregate(ngh, mask)
    if res is not None:
        return res
    n, k = ngh.shape
    agg = np.full(n, -1, dtype=np.int64)
    num = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        agg[i] = num
        for s in range(k):
            j = ngh[i, s]
            if mask[i, s] and j != i and agg[j] < 0:
                agg[j] = num
        num += 1
    return agg, num


def _coarse_graph_from_agg(ngh: np.ndarray, mask: np.ndarray,
                           agg: np.ndarray, nc: int):
    """Aggregate-graph adjacency (ELL) induced by fine edges."""
    n, kf = ngh.shape
    fi = np.repeat(np.arange(n), kf)
    fj = ngh.ravel()
    fv = mask.ravel()
    a_i = agg[fi]
    a_j = agg[fj]
    cross = fv & (a_i != a_j)
    pair = np.unique(a_i[cross] * nc + a_j[cross])
    pci = pair // nc
    pcj = pair % nc
    counts = np.bincount(pci, minlength=nc)
    kc = max(int(counts.max()) if len(pair) else 0, 1)
    row_start = np.zeros(nc + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    slot = np.arange(len(pair)) - row_start[pci]
    cn = np.tile(np.arange(nc, dtype=np.int64)[:, None], (1, kc))
    cm = np.zeros((nc, kc), bool)
    cn[pci, slot] = pcj
    cm[pci, slot] = True
    return cn, cm


def build_hierarchy(ck_neighbor: np.ndarray, ck_mask: np.ndarray,
                    c_valid: np.ndarray | None = None,
                    agg_passes: int = 1, device="cpu") -> AmgHierarchy:
    """Build the static AMG hierarchy from the fine pressure sparsity pattern
    (the mesh's cell adjacency).  Fully vectorized except the (native) greedy
    scan; scales to multi-million-cell meshes.

    Masked solid cells of the structured layout (``c_valid == 0``) are inert
    identity rows; they are pooled into one decoupled aggregate at the first
    coarsening so they do not pollute the hierarchy.
    """
    levels: list[AmgLevel] = []
    ngh = np.asarray(ck_neighbor, dtype=np.int64)
    n = ngh.shape[0]
    mask = (np.asarray(ck_mask) > 0) & (ngh != np.arange(n)[:, None])
    invalid = (np.asarray(c_valid) <= 0) if c_valid is not None else None

    for _level in range(_MAX_LEVELS):
        n, kf = ngh.shape
        if n <= _MIN_COARSE:
            break
        agg, nc = _aggregate_ell(ngh, mask)
        # Multi-pass aggregation (pairwise-squared, Notay-style): compose a
        # second greedy pass over the aggregate graph for ~3x fewer levels
        # (a shallower hierarchy means fewer launches per V-cycle).
        for _ in range(agg_passes - 1):
            if nc <= _MIN_COARSE:
                break
            cn, cm = _coarse_graph_from_agg(ngh, mask, agg, nc)
            agg2, nc2 = _aggregate_ell(cn, cm)
            agg = agg2[agg]
            nc = nc2
        trash = -1
        if invalid is not None and invalid.any():
            # Remap all solid cells into a single trash aggregate.  It gets
            # no restriction members (solid identity-row residuals are zero by
            # construction) so the padded members matrix stays small.
            keep = np.unique(agg[~invalid])
            remap = np.full(nc, len(keep), dtype=np.int64)
            remap[keep] = np.arange(len(keep))
            agg = remap[agg]
            trash = len(keep)
            agg[invalid] = trash
            nc = len(keep) + 1
        invalid = None  # only relevant at the first coarsening
        if nc >= n:
            break

        # Coarse adjacency from fine edges (vectorized).
        fi = np.repeat(np.arange(n), kf)
        fj = ngh.ravel()
        fv = mask.ravel()
        a_i = agg[fi]
        a_j = agg[fj]
        cross = fv & (a_i != a_j)
        pair = a_i[cross] * nc + a_j[cross]
        uniq_pairs = np.unique(pair)
        pci = uniq_pairs // nc
        pcj = uniq_pairs % nc
        counts_row = np.bincount(pci, minlength=nc)
        kc = max(int(counts_row.max()) if len(uniq_pairs) else 0, 1)
        row_start = np.zeros(nc + 1, dtype=np.int64)
        np.cumsum(counts_row, out=row_start[1:])
        slot = np.arange(len(uniq_pairs)) - row_start[pci]
        coarse_ngh = np.tile(np.arange(nc, dtype=np.int64)[:, None], (1, kc))
        coarse_mask = np.zeros((nc, kc), dtype=bool)
        coarse_ngh[pci, slot] = pcj
        coarse_mask[pci, slot] = True
        # Rows are ascending (uniq_pairs is sorted and slots fill 0..deg-1);
        # repeat the last real neighbor into pad slots, as the JAX package
        # does.  Pad coefficients are zero (RAP never writes them) and the
        # next level's aggregation reads coarse_mask, so values at pads are
        # free.
        ffil = np.maximum.accumulate(
            np.where(coarse_mask, np.arange(kc)[None, :], 0), axis=1)
        coarse_ngh = np.take_along_axis(coarse_ngh, ffil, axis=1)

        # RAP index map: flattened fine values [diag(n); off(n*kf)] -> coarse
        # flattened slots [c*(kc+1) + 0 (diag) | 1+slot]; dump slot at end.
        dump = nc * (kc + 1)
        targets = np.full(n + n * kf, dump, dtype=np.int64)
        targets[:n] = agg * (kc + 1)
        flat_idx = np.arange(n * kf) + n
        vsame = fv & (a_i == a_j)
        targets[flat_idx[vsame]] = a_i[vsame] * (kc + 1)
        pos = np.searchsorted(uniq_pairs, a_i[cross] * nc + a_j[cross])
        targets[flat_idx[cross]] = a_i[cross] * (kc + 1) + 1 + slot[pos]

        # Restriction member lists (piecewise-constant R = P^T), vectorized.
        # The trash aggregate (solid cells) is excluded: padding the matrix
        # to its size would be enormous and its residuals are identically 0.
        member_cells = (np.nonzero(agg != trash)[0] if trash >= 0
                        else np.arange(n))
        magg = agg[member_cells]
        order = member_cells[np.argsort(magg, kind="stable")]
        counts_m = np.bincount(agg[order], minlength=nc)
        m = max(int(counts_m.max()), 1)
        mem_start = np.zeros(nc + 1, dtype=np.int64)
        np.cumsum(counts_m, out=mem_start[1:])
        within = np.arange(len(order)) - mem_start[agg[order]]
        members = np.zeros((nc, m), dtype=np.int64)
        members_mask = np.zeros((nc, m), dtype=np.float64)
        members[agg[order], within] = order
        members_mask[agg[order], within] = 1.0

        def as_i(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)

        levels.append(AmgLevel(
            n=nc, k=kc,
            ell_neighbor=as_i(coarse_ngh),
            rap_target=as_i(targets),
            rap_order=as_i(np.argsort(targets, kind="stable")[:, None]),
            rap_lengths=torch.as_tensor(
                np.bincount(targets, minlength=dump + 1), device=device),
            agg=as_i(agg[:, None]),
            # Masked member entries hold index 0 with a zero coefficient.
            members=as_i(members),
            members_mask=torch.as_tensor(
                np.ascontiguousarray(members_mask, np.float32),
                device=device),
        ))

        ngh = coarse_ngh
        mask = coarse_mask

    return AmgHierarchy(levels=tuple(levels))


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
    structured meshes, the greedy aggregation AMG on generic ones.  None if
    the mesh is too small.

    ``agg_passes=0`` (auto) resolves to 2 on the generic path, as in the JAX
    package (the shallower double-pass hierarchy)."""
    if mesh.structured:
        return build_structured_hierarchy(mesh)
    hier = build_hierarchy(_host(mesh, "ck_neighbor"), _host(mesh, "ck_mask"),
                           _host(mesh, "c_valid"),
                           agg_passes=agg_passes or 2, device=mesh.device)
    return hier if hier.levels else None


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


# ----------------------------------------------------------------------
# Aggregation AMG: per-solve values and the V-cycle


_ONE_DOT = (((0, 0),),)


def compute_level_values(hier: AmgHierarchy, P_diag: torch.Tensor,
                         P_off: torch.Tensor):
    """Galerkin-coarsen the current pressure values down the hierarchy:
    every coarse entry is a plain sum of fine entries, routed by
    ``rap_target``.

    Unlike the structured path, the fine diagonal is NOT ``_NULL_SHIFT``
    regularized here (as in the JAX package): the regularized coarsest LU
    bounds the near-null constant mode well enough for FGMRES."""
    vals = [(P_diag, P_off)]
    for lvl in hier.levels:
        fd, fo = vals[-1]
        flat = torch.cat([fd, fo.reshape(-1)])
        # Group the finer values by coarse slot (one gather through the
        # sorted map) and add each group in order: the same bits on every
        # run and on both devices, where index_add_ over ``rap_target``
        # would add with atomics in an order that changes from run to run.
        grouped = bk.banded_gather(flat, lvl.rap_order)[:, 0]
        seg = torch.segment_reduce(grouped, "sum", lengths=lvl.rap_lengths,
                                   unsafe=True)
        seg = seg[:-1].reshape(lvl.n, lvl.k + 1)
        vals.append((seg[:, 0].contiguous(), seg[:, 1:].contiguous()))
    return vals


def _ell_spmv(diag, off, dot, x):
    return diag * x + dot(off, x)


def _smooth(diag, off, dot, x, b, sweeps=1):
    dinv = torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, 0.0)
    for _ in range(sweeps):
        x = x + _OMEGA * dinv * (b - _ell_spmv(diag, off, dot, x))
    return x


def _gershgorin_lmax(diag, off):
    """Per-level upper bound on lambda_max(D^-1 A) from row sums, so that
    Chebyshev smoothing never runs with modes outside its interval (the
    pressure M-matrix's interior rows reach exactly 2.0)."""
    ad = torch.abs(diag)
    row_abs = torch.sum(torch.abs(off), dim=1)
    ratio = (ad + row_abs) / torch.clamp(ad, min=1e-30)
    return torch.max(torch.where(ad > 1e-30, ratio, 1.0))


def _smooth_cheb(diag, off, dot, x, b, degree=2, lmax=2.0):
    """Chebyshev polynomial smoother on the Jacobi-preconditioned operator
    D^-1 A, targeting [lmax/4, lmax].  Each application costs ``degree``
    operator dots.  ``lmax`` may be a 0-d tensor
    (see :func:`_gershgorin_lmax`)."""
    dinv = torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, 0.0)
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - _ell_spmv(diag, off, dot, x)
    d = dinv * r / theta
    x = x + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = b - _ell_spmv(diag, off, dot, x)
        d = rho_new * rho * d + 2.0 * rho_new / delta * (dinv * r)
        rho = rho_new
        x = x + d
    return x


def _coarsest_cols(hier: AmgHierarchy, n: int, device):
    if hier.levels:
        return hier.levels[-1].ell_neighbor
    return torch.zeros((n, 1), dtype=torch.int32, device=device)


def v_cycle(hier: AmgHierarchy, level_values, mesh,
            b0: torch.Tensor, x0: torch.Tensor,
            coarse_factors=None, smoother: str = "jacobi",
            smooth_arg: int = 1, overcorrect: float = 1.0) -> torch.Tensor:
    """One V-cycle of the aggregation hierarchy.

    Per-level neighbor sums are fused banded dots over the level's ELL map
    (level 0: the mesh's), restriction is a dot over the member lists with
    ``members_mask`` as coefficients, prolongation a K = 1 gather through
    the aggregate map; all on :mod:`.banded_kernels`.

    ``smoother``: "jacobi" (damped, ``smooth_arg`` sweeps) or "cheb"
    (Chebyshev of degree ``smooth_arg``).  ``overcorrect``: scale on the
    prolongated coarse correction (the classic plain-aggregation fix).
    """
    def _ell_dot(idx):
        return lambda off, x: bk.banded_dot((x,), (off,), idx, _ONE_DOT)[0]

    def _dot0(off, x):
        return mesh.banded_dot((x,), (off,), _ONE_DOT)[0]

    L = len(hier.levels)
    dots = [_dot0] + [_ell_dot(lvl.ell_neighbor) for lvl in hier.levels]

    if smoother == "cheb":
        def smooth(diag, off, dot, x, b):
            return _smooth_cheb(diag, off, dot, x, b, degree=smooth_arg,
                                lmax=_gershgorin_lmax(diag, off))
    else:
        def smooth(diag, off, dot, x, b):
            return _smooth(diag, off, dot, x, b, sweeps=smooth_arg)

    xs = [x0]
    bs = [b0]
    # Downward
    for i in range(L):
        diag, off = level_values[i]
        lvl = hier.levels[i]
        x = smooth(diag, off, dots[i], xs[i], bs[i])
        r = bs[i] - _ell_spmv(diag, off, dots[i], x)
        (b_c,) = bk.banded_dot((r,), (lvl.members_mask,), lvl.members,
                               _ONE_DOT)
        xs[i] = x
        bs.append(b_c)
        xs.append(torch.zeros((lvl.n,), dtype=x.dtype, device=x.device))

    # Coarsest solve: exact dense solve (see _dense_factor).
    diag, off = level_values[L]
    if coarse_factors is None:
        coarse_factors = _dense_factor(
            diag, off, _coarsest_cols(hier, diag.shape[0], diag.device))
    xs[L] = _dense_solve_factored(coarse_factors, bs[L])

    # Upward
    for i in reversed(range(L)):
        lvl = hier.levels[i]
        diag, off = level_values[i]
        prol = bk.banded_gather(xs[i + 1], lvl.agg)[:, 0]
        x = xs[i] + overcorrect * prol
        xs[i] = smooth(diag, off, dots[i], x, bs[i])

    return xs[0]


def coarse_level_values(hier: AmgHierarchy, P_diag, P_off):
    """Galerkin-coarsen once and return ``(coarse_vals, factors)`` for
    :func:`make_pressure_solve`'s ``frozen=`` argument: the level-1+
    (diag, off) pairs plus the coarsest-level dense factorization.  The
    step re-coarsens once per TIMESTEP instead of once per outer corrector
    (SolverConfig.amg_freeze_coarse)."""
    level_values = compute_level_values(hier, P_diag, P_off)
    dc, oc = level_values[-1]
    factors = _dense_factor(dc, oc,
                            _coarsest_cols(hier, dc.shape[0], dc.device))
    return tuple(level_values[1:]), factors


def make_pressure_solve(hier: AmgHierarchy, mesh, sys, cycle_opts=None,
                        frozen=None):
    """pressure_solve(rhs_p) closure for the Schur preconditioner on the
    aggregation hierarchy.  ``sys`` carries ``P_diag``, ``P_off`` and
    ``diag_p_inv`` (an :class:`.ellsys.EllSystem`).

    ``cycle_opts``: extra kwargs for :func:`v_cycle` (smoother and
    overcorrection variants).  ``frozen``: ``(coarse_vals, factors)`` from
    :func:`coarse_level_values` — skip the per-call Galerkin re-coarsening
    and use these level-1+ operators instead (level 0 stays current;
    FGMRES is flexible, so the staleness never touches the solve contract).
    """
    if frozen is not None:
        coarse_vals, factors = frozen
        level_values = [(sys.P_diag, sys.P_off)] + list(coarse_vals)
    else:
        level_values = compute_level_values(hier, sys.P_diag, sys.P_off)
        dc, oc = level_values[-1]
        factors = _dense_factor(
            dc, oc, _coarsest_cols(hier, dc.shape[0], dc.device))
    opts = dict(cycle_opts or {})

    def pressure_solve(rhs_p):
        x0 = sys.diag_p_inv * rhs_p          # Jacobi seed, like p_sol init
        return v_cycle(hier, level_values, mesh, rhs_p, x0,
                       coarse_factors=factors, **opts)

    return pressure_solve
