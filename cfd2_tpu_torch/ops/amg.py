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
aggregate map, fused with the update) through the CUDA kernels of
:mod:`.banded_kernels`, on every level.

**Multilevel embedding** (locally-refined quadtree meshes): the composite
mesh is embedded in its finest uniform grid, a structured V-cycle
preconditions the fine-grid Laplacian built per assembly from the spread
rho*d_p field, and damped Jacobi on the true composite operator takes the
cross-level error (:class:`MultilevelAmg`).

All end in a regularized dense LU at the coarsest level.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..runtime.device_mesh import resolve_device
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
                    agg_passes: int = 1, device=None) -> AmgHierarchy:
    """Build the static AMG hierarchy from the fine pressure sparsity pattern
    (the mesh's cell adjacency).  Fully vectorized except the (native) greedy
    scan; scales to multi-million-cell meshes.

    Masked solid cells of the structured layout (``c_valid == 0``) are inert
    identity rows; they are pooled into one decoupled aggregate at the first
    coarsening so they do not pollute the hierarchy.

    ``device``: where the hierarchy's tensors go; None means CUDA and raises
    with no GPU present (``resolve_device``): pass ``device="cpu"`` for the
    plain path.
    """
    device = resolve_device(device)
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


@dataclass(frozen=True)
class MultilevelAmg:
    """Pressure multigrid for multilevel (locally-refined quadtree) meshes.

    The composite mesh is embedded in its finest uniform grid: every cell's
    value is replicated over its 2^l x 2^l fine squares, a structured
    V-cycle preconditions the fine-grid Laplacian (built per assembly from
    the spread rho*d_p field), and the correction is averaged back.  The 2D
    Poisson stencil is scale-invariant (area/dist = 1 at every level), so the
    fine operator is spectrally close to the composite Schur operator.
    Assumes the outlet lies on the domain's east edge (true for all
    reference geometries)."""
    fine: StructuredAmgHierarchy
    ml_levels: tuple              # composite level grids, finest first
    outlet_e2: torch.Tensor       # (ny0, nx0) f32: fine squares with an
    #                               outlet east face


def _ml_spread(ml_levels, x, extensive=False):
    """Composite (N,) -> fine (ny0, nx0): each cell's value replicated over
    its fine squares.  ``extensive`` divides level-l values by 4^l (for
    quantities that are integrals over the cell, e.g. the continuity RHS)."""
    grids = list(ml_levels)
    out = None
    off = 0
    for li, (ny, nx) in enumerate(grids):
        xg = x[off:off + ny * nx].reshape(ny, nx)
        off += ny * nx
        if extensive and li:
            xg = xg / (4.0 ** li)
        for k in range(li, 0, -1):
            xg = sk.prolong2(xg, grids[k - 1])
        out = xg if out is None else out + xg
    return out


def _ml_restrict_avg(ml_levels, xf):
    """Fine (ny0, nx0) -> composite (N,): average over each cell's fine
    squares (intensive restriction, the adjoint of _ml_spread up to 4^l)."""
    grids = list(ml_levels)
    parts = [xf.reshape(-1)]
    cur = xf
    for li in range(1, len(grids)):
        cur = sk.restrict2(cur, grids[li])             # 2x2 sum
        parts.append((cur / (4.0 ** li)).reshape(-1))
    return torch.cat(parts)


def build_multilevel_amg(mesh) -> MultilevelAmg | None:
    """The fine-grid hierarchy and masks of a multilevel DeviceMesh, built
    on the host from encode-time copies."""
    if not mesh.multilevel:
        return None
    grids = mesh.ml_levels
    ny0, nx0 = grids[0]

    def spread_np(v):
        out = np.zeros((ny0, nx0))
        off = 0
        for li, (ny, nx) in enumerate(grids):
            g = v[off:off + ny * nx].reshape(ny, nx)
            off += ny * nx
            up = np.kron(g, np.ones((1 << li, 1 << li)))
            out += up[:ny0, :nx0]
        return out

    fluid = spread_np(_host(mesh, "c_valid")) > 0          # (ny0, nx0)
    internal2 = np.zeros((4, ny0, nx0), dtype=bool)
    internal2[0, :, :-1] = fluid[:, :-1] & fluid[:, 1:]    # E
    internal2[1, :, 1:] = fluid[:, 1:] & fluid[:, :-1]     # W
    internal2[2, :-1, :] = fluid[:-1, :] & fluid[1:, :]    # N
    internal2[3, 1:, :] = fluid[1:, :] & fluid[:-1, :]     # S
    internal0 = np.moveaxis(internal2, 0, 2).reshape(-1, 4)

    levels = _structured_levels(ny0, nx0, internal0, fluid.reshape(-1),
                                mesh.device)
    if not levels:
        return None

    def as_f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=mesh.device)

    fine = StructuredAmgHierarchy(levels=tuple(levels),
                                  diag_valid2=as_f(fluid),
                                  internal2=as_f(internal2))
    has_outlet = ((_host(mesh, "ck_boundary") == 2)
                  & (_host(mesh, "ck_mask") > 0)).any(axis=1)
    outlet = spread_np(has_outlet.astype(np.float64)) > 0
    outlet_e2 = np.zeros((ny0, nx0))
    outlet_e2[:, -1] = (outlet & fluid)[:, -1]
    return MultilevelAmg(fine=fine, ml_levels=tuple(grids),
                         outlet_e2=as_f(outlet_e2))


def build_hierarchy_for_mesh(mesh, agg_passes: int = 0):
    """The pressure hierarchy of a DeviceMesh: the geometric 2x2 multigrid on
    structured meshes, the fine-grid-embedded multigrid on multilevel ones,
    the greedy aggregation AMG otherwise, and also where the first two do
    not build (a mesh too small for them).  None if the mesh is too small
    for any.

    ``agg_passes=0`` (auto) resolves to 2 on the generic path, as in the JAX
    package (the shallower double-pass hierarchy)."""
    if mesh.structured:
        hier = build_structured_hierarchy(mesh)
        if hier is not None:
            return hier
    if mesh.multilevel:
        hier = build_multilevel_amg(mesh)
        if hier is not None:
            return hier
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

    def smooth_rbgs2(self, diag2, off2, xg, bg, sweeps=1):
        """Red-black Gauss-Seidel on 2D grids (plain stencils)."""
        return sk.rbgs_leg_ref(xg, diag2, off2, bg, sweeps=sweeps)

    def restrict2(self, coarse_grid, rg):
        """2x2 block sums (zero-padded to an even grid)."""
        return sk.restrict2(rg, coarse_grid)

    def prolong2(self, coarse_grid, xcg):
        """Piecewise-constant 2x upsample, cropped to this level's grid."""
        return sk.prolong2(xcg, (self.ny, self.nx))


def split_level(hier: StructuredAmgHierarchy, decomp) -> int:
    """The first level of ``hier`` that a row-sharded V-cycle runs whole on
    every rank.  A level stays sharded while each rank's block of its rows
    is even, so that ``restrict2``'s 2x2 pairs never straddle two ranks
    (every block then starts on an even row, which also keeps the
    red-black colours of the block's own indices the global ones), and at
    least as deep as the legs' ghost rows; the coarsest level, with its
    dense solve, is always whole."""
    grids = [hier.levels[0].fine_grid] + [lvl.grid for lvl in hier.levels]
    split = 0
    while split < len(hier.levels):
        ny = grids[split][0]
        block = ny // decomp.world
        if ny % decomp.world or block % 2 or block < decomp.ghost:
            break
        split += 1
    return split


def _level0_values2(P_diag2, P_off2, decomp=None, whole=False):
    """Level 0's smoother values: the shifted diagonal and the four
    directional planes; ``whole`` gathers a row-sharded system's rows from
    every rank (a V-cycle whose split is level 0)."""
    d0, off0 = P_diag2 + _NULL_SHIFT * torch.abs(P_diag2), P_off2[:4]
    if whole:
        d0 = decomp.all_gather_rows(d0)
        off0 = decomp.all_gather_rows(off0.contiguous(), dim=1)
    return d0, off0


def compute_structured_level_values2(hier: StructuredAmgHierarchy,
                                     P_diag2: torch.Tensor,
                                     P_off2: torch.Tensor, decomp=None):
    """Galerkin-coarsen values down the structured hierarchy as 2D stencil
    sums.  For 2x2 piecewise-constant aggregation of a 5-point stencil, a
    fine E entry at even x couples cells of the same block (-> coarse
    diagonal) and at odd x crosses the block boundary (-> coarse E slot),
    mirrored for W/N/S; the coarse entry is the 2x2 block sum.

    The fine diagonal is shifted by ``_NULL_SHIFT * |diag|`` first: the
    pressure operator's constant mode is near-null (Dirichlet only at the
    outlet), and the shift caps the condition.  Takes ``P_diag2`` (ny, nx),
    ``P_off2`` (4+, ny, nx); returns ``[(diag2, off2), ...]`` per level,
    coarsest last.

    With ``decomp`` (a row-sharded system's rows): the levels below
    :func:`split_level` hold this rank's rows, coarsened locally (their
    blocks start on even rows), and the split level and those below it the
    whole grid, gathered once here."""
    split = len(hier.levels) if decomp is None else split_level(hier, decomp)
    vals = [_level0_values2(P_diag2, P_off2, decomp, whole=split == 0)]
    for li, lvl in enumerate(hier.levels):
        d, off = vals[-1]
        if li == 0:
            # The masks apply to the level-0 -> 1 transition only; level-0
            # values themselves stay raw for the fine smoother.
            dv, it = hier.diag_valid2, hier.internal2
            if split > 0 and decomp is not None:
                dv, it = decomp.own_rows(dv), decomp.own_rows(it, dim=1)
            d = d * dv
            off = off * it
        nyf, nxf = d.shape
        ops = _GridOps((nyf, nxf))
        cgrid = ((nyf + 1) // 2, lvl.grid[1])
        evx = (torch.arange(nxf, device=d.device) % 2 == 0).to(d.dtype)[None, :]
        evy = (torch.arange(nyf, device=d.device) % 2 == 0).to(d.dtype)[:, None]
        odx = 1.0 - evx
        ody = 1.0 - evy
        within = off[0] * evx + off[1] * odx + off[2] * evy + off[3] * ody
        dc = ops.restrict2(cgrid, d + within)
        oc = torch.stack([ops.restrict2(cgrid, off[0] * odx),
                          ops.restrict2(cgrid, off[1] * evx),
                          ops.restrict2(cgrid, off[2] * ody),
                          ops.restrict2(cgrid, off[3] * evy)])
        if li + 1 == split and decomp is not None:
            dc = decomp.all_gather_rows(dc)
            oc = decomp.all_gather_rows(oc, dim=1)
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
    that returns the restricted residual, and its up leg one that adds the
    prolongated correction before it smooths (2 launches per level, and no
    launch for the grid transfers; with ``sweeps > 1`` the legs are unfused
    and the transfers plain); at level 1 each half-sweep is one
    :func:`~.stencil_kernels.rbgs_half_sweep` launch on the level's own
    (4, ny, nx) coefficient planes, the down leg's residual and restriction
    one :func:`~.stencil_kernels.rbgs_residual` launch, the prolongation
    plain; level 0 (CPU only) runs the plain stencils."""
    L = len(hier.levels)
    grids = [hier.levels[0].fine_grid] + [lvl.grid for lvl in hier.levels]
    ops = [_GridOps(g) for g in grids]
    lv2 = structured_level_values_2d(hier, level_values)
    level = sk.smoother_level(b0.device)
    fused = level == 2 and sweeps == 1

    def smooth(i, xg, bg):
        diag2, off2 = lv2[i]
        if level == 2:
            return sk.rbgs_leg(xg, diag2, off2, bg, sweeps=sweeps)
        if level == 1:
            return sk.smooth_rbgs_half_sweeps(diag2, off2, xg, bg,
                                              sweeps=sweeps)
        return ops[i].smooth_rbgs2(diag2, off2, xg, bg, sweeps=sweeps)

    xs = [x0.reshape(grids[0])]
    bs = [b0.reshape(grids[0])]
    for i in range(L):
        diag2, off2 = lv2[i]
        if fused:
            x, b_coarse = sk.rbgs_leg(xs[i], diag2, off2, bs[i],
                                      restrict_to=grids[i + 1])
        else:
            if level == 2:
                x, r = sk.rbgs_leg(xs[i], diag2, off2, bs[i], sweeps=sweeps,
                                   residual=True)
                b_coarse = ops[i].restrict2(grids[i + 1], r)
            else:
                x = smooth(i, xs[i], bs[i])
                b_coarse = sk.rbgs_residual(x, diag2, off2, bs[i],
                                            grids[i + 1])
        xs[i] = x
        bs.append(b_coarse)
        xs.append(torch.zeros(grids[i + 1], dtype=x0.dtype, device=x0.device))

    if coarse_factors is None:
        coarse_factors = _coarse_factors(hier, lv2)
    xs[L] = _dense_solve_factored(
        coarse_factors, bs[L].reshape(-1)).reshape(grids[L])

    for i in reversed(range(L)):
        if fused:
            diag2, off2 = lv2[i]
            xs[i] = sk.rbgs_leg(xs[i], diag2, off2, bs[i],
                                add_prolong=xs[i + 1])
        else:
            x = xs[i] + ops[i].prolong2(grids[i + 1], xs[i + 1])
            xs[i] = smooth(i, x, bs[i])
    return xs[0].reshape(-1)


def sharded_v_cycle(hier: StructuredAmgHierarchy, level_values,
                    coarse_factors, decomp):
    """:func:`structured_v_cycle` on a row-sharded system, as a function
    ``cycle(b0, x0)`` of this rank's (rows, nx) grids; ``level_values``
    from :func:`compute_structured_level_values2` with the same
    ``decomp``.

    Below :func:`split_level` each leg runs on the rank's block plus ghost
    rows, a contiguous slice of the level's grid, in the structure of
    :func:`structured_v_cycle` at the smoother level of
    :func:`~.stencil_kernels.smoother_level`: at level 2 one fused
    :func:`~.stencil_kernels.rbgs_leg` launch per leg; at level 1 two
    :func:`~.stencil_kernels.rbgs_half_sweep` launches per leg, the down
    leg's residual and restriction one
    :func:`~.stencil_kernels.rbgs_residual` launch and the prolongation
    plain; at level 0 (CPU only) the plain stencils.  The down leg takes
    ``decomp.ghost`` (4) rows on each inner side, of which its two
    half-sweeps and the residual spoil three, so the
    restricted residual of the block's own rows is exact; the up leg takes
    2, which its two half-sweeps spoil, on the down leg's iterate (exact
    there) plus the prolongated coarse correction (the coarse block with one
    ghost row).  (One sweep per leg: no option asks for more here; s sweeps
    would spoil 2s + 1 rows.)  The ghost rows are even in number, so every
    extended block starts on an even row and the kernels' colours and
    ``restrict2``'s pairs stay the global ones; the half-sweeps update the
    extended block in place, a copy that no one else reads.  The split
    level's right-hand side is gathered from every rank; from there the
    cycle runs whole on every rank (the same kernels on the same values),
    the coarsest dense solve included, and each rank takes its own rows of
    the correction on the way up.  Exchanges per cycle: one per sharded
    level down, one per sharded level below the last up, and one gather;
    the coefficient planes' ghost rows are exchanged here, once."""
    level = sk.smoother_level(decomp.device)
    L = len(hier.levels)
    grids = [hier.levels[0].fine_grid] + [lvl.grid for lvl in hier.levels]
    split = split_level(hier, decomp)
    lv2 = structured_level_values_2d(hier, level_values)
    g = decomp.ghost
    down, up = [], []
    for i in range(split):
        planes, lo = decomp.extend(
            torch.cat([lv2[i][0][None], lv2[i][1]]), g, dim=1)
        down.append((planes[0], planes[1:], lo))
        u = decomp.trim(planes, g, 2, dim=1).contiguous()
        up.append((u[0], u[1:]))
    rest = StructuredAmgHierarchy(levels=hier.levels[split:])

    def smooth(x, diag2, off2, b):
        if level == 1:
            return sk.smooth_rbgs_half_sweeps(diag2, off2, x, b)
        return sk.rbgs_leg_ref(x, diag2, off2, b)

    def down_leg(x, diag2, off2, b, coarse):
        if level == 2:
            return sk.rbgs_leg(x, diag2, off2, b, restrict_to=coarse)
        x = smooth(x, diag2, off2, b)
        return x, sk.rbgs_residual(x, diag2, off2, b, coarse)

    def up_leg(x, diag2, off2, b, xc):
        if level == 2:
            return sk.rbgs_leg(x, diag2, off2, b, add_prolong=xc)
        return smooth(x + sk.prolong2(xc, x.shape), diag2, off2, b)

    def whole(b, x):
        """The cycle from the split level on, whole on every rank."""
        if split == L:
            return _dense_solve_factored(coarse_factors, b.reshape(-1)
                                         ).reshape(grids[L])
        return structured_v_cycle(rest, lv2[split:], b.reshape(-1),
                                  x.reshape(-1), coarse_factors
                                  ).reshape(grids[split])

    def cycle(b0: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        if split == 0:
            x = whole(decomp.all_gather_rows(b0),
                      decomp.all_gather_rows(x0))
            return decomp.own_rows(x)
        xs, bs = [], []
        b = b0
        for i in range(split):
            d_e, o_e, lo = down[i]
            if i == 0:
                xb, _ = decomp.extend(torch.stack([x0, b0]), g, dim=1)
                x_e, b_e = xb[0], xb[1]
            else:
                b_e, _ = decomp.extend(b, g)
                x_e = torch.zeros_like(b_e)
            x_e, rc_e = down_leg(x_e, d_e, o_e, b_e,
                                 (b_e.shape[0] // 2, grids[i + 1][1]))
            xs.append(x_e)
            bs.append(b_e)
            b = rc_e[lo // 2:lo // 2 + b.shape[0] // 2]
        b = decomp.all_gather_rows(b)
        xc = whole(b, torch.zeros_like(b))
        for i in reversed(range(split)):
            if i + 1 == split:       # the whole coarse grid: slice it
                n = grids[i + 1][0] // decomp.world
                lo = decomp.rank * n - (1 if decomp.rank > 0 else 0)
                hi = (decomp.rank + 1) * n \
                    + (1 if decomp.rank < decomp.world - 1 else 0)
                xc_e = xc[lo:hi]
            else:
                xc_e, _ = decomp.extend(xc, 1)
            d_u, o_u = up[i]
            x = up_leg(decomp.trim(xs[i], g, 2).contiguous(), d_u, o_u,
                       decomp.trim(bs[i], g, 2).contiguous(),
                       xc_e.contiguous())
            lo2 = 2 if decomp.rank > 0 else 0
            xc = x[lo2:lo2 + grids[i][0] // decomp.world]
        return xc

    return cycle


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
    (level 0: the mesh's; on a mesh without a banded map, level 0 takes
    ``mesh.gather`` and a sum, as in the JAX package), restriction is a dot over the member lists with
    ``members_mask`` as coefficients, prolongation a K = 1 gather through
    the aggregate map fused with the update it feeds
    (:func:`.banded_kernels.banded_prolong_add`); all on
    :mod:`.banded_kernels`.

    ``smoother``: "jacobi" (damped, ``smooth_arg`` sweeps) or "cheb"
    (Chebyshev of degree ``smooth_arg``).  ``overcorrect``: scale on the
    prolongated coarse correction (the classic plain-aggregation fix).
    """
    def _ell_dot(idx):
        return lambda off, x: bk.banded_dot((x,), (off,), idx, _ONE_DOT)[0]

    if mesh.banded:
        def _dot0(off, x):
            return mesh.banded_dot((x,), (off,), _ONE_DOT)[0]
    else:
        def _dot0(off, x):
            return torch.sum(off * mesh.gather(x), dim=1)

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
        # xs[i] + overcorrect * xs[i + 1][agg] in one launch, rounded as
        # the eager ops round it.
        x = bk.banded_prolong_add(xs[i], xs[i + 1], lvl.agg, overcorrect)
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


_ML_OMEGA = 0.8      # damped Jacobi on the composite operator


def _multilevel_pressure_solve(hier: MultilevelAmg, mesh, sys, coeff):
    """FAC-style two-grid for a multilevel mesh: damped Jacobi on the true
    composite operator around one fine-grid V-cycle of the Laplacian built
    from the spread ``coeff`` (rho*d_p): area/dist = 1 per face, lam = 1/2,
    Dirichlet p = 0 at the outlet column.  Identity on hole components,
    matching the composite P's identity rows."""
    from .blockell import scalar_spmv
    grids = hier.ml_levels
    ny0, nx0 = grids[0]
    fh = hier.fine
    valid = mesh.c_valid
    # Mask composite holes before any spread: a level-l hole would
    # otherwise upsample its junk into fine squares owned by other cells.
    c2 = _ml_spread(grids, coeff * valid)
    intl = fh.internal2
    e, w, n, s = sk.edge_shifts(c2)
    offE = -0.5 * (c2 + e) * intl[0]
    offW = -0.5 * (c2 + w) * intl[1]
    offN = -0.5 * (c2 + n) * intl[2]
    offS = -0.5 * (c2 + s) * intl[3]
    off2 = torch.stack([offE, offW, offN, offS])
    diag2 = -(offE + offW + offN + offS) + hier.outlet_e2 * c2
    lv2 = compute_structured_level_values2(fh, diag2, off2)
    factors = _coarse_factors(fh, lv2)
    dinv0 = torch.where(torch.abs(diag2) > 1e-30, 1.0 / diag2, 0.0)
    Pd, Po, dpi = sys.P_diag, sys.P_off, sys.diag_p_inv

    def fine_correct(r):
        rf = _ml_spread(grids, r * valid, extensive=True)
        zf = structured_v_cycle(fh, lv2, rf.reshape(-1),
                                (dinv0 * rf).reshape(-1),
                                coarse_factors=factors)
        return _ml_restrict_avg(grids, zf.reshape(ny0, nx0))

    def pressure_solve(rhs_p):
        z = _ML_OMEGA * dpi * rhs_p
        z = z + fine_correct(rhs_p - scalar_spmv(Pd, Po, mesh, z))
        z = z + _ML_OMEGA * dpi * (rhs_p - scalar_spmv(Pd, Po, mesh, z))
        return torch.where(valid > 0, z, rhs_p)

    return pressure_solve


def _replicated_pressure_solve(hier: AmgHierarchy, mesh, sys, cycle_opts):
    """The aggregation V-cycle on a row-sharded structured mesh (a grid too
    small for the structured multigrid): every rank all-gathers the fine
    pressure operator once (here) and the right-hand side with its Jacobi
    seed once per cycle, runs the whole hierarchy's V-cycle on the whole
    grid, and keeps its own rows.  The JAX package's GSPMD placement
    replicates the same computation; on the same operator every rank's
    cycle is one process's, bit for bit.  ``hier`` is the whole mesh's
    (``parallel.spatial.shard_cellwise`` leaves it whole)."""
    d = mesh.decomp
    whole = d.all_gather_rows(torch.cat([sys.P_diag[:, None], sys.P_off], 1))
    level_values = compute_level_values(
        hier, whole[:, 0].contiguous(), whole[:, 1:].contiguous())
    dc, oc = level_values[-1]
    factors = _dense_factor(
        dc, oc, _coarsest_cols(hier, dc.shape[0], dc.device))
    grid = replace(mesh, num_cells=d.rows * d.row_size,
                   grid_shape=(d.rows, d.row_size), decomp=None)
    opts = dict(cycle_opts or {})

    def pressure_solve(rhs_p):
        b_x = d.all_gather_rows(torch.stack([rhs_p, sys.diag_p_inv * rhs_p],
                                            1))
        x = v_cycle(hier, level_values, grid, b_x[:, 0].contiguous(),
                    b_x[:, 1].contiguous(), coarse_factors=factors, **opts)
        return x[d.cells]

    return pressure_solve


def make_pressure_solve(hier, mesh, sys, coeff=None, cycle_opts=None,
                        frozen=None):
    """pressure_solve(rhs_p) closure for the Schur preconditioner.  ``sys``
    carries ``P_diag``, ``P_off`` and ``diag_p_inv`` (an
    :class:`.ellsys.EllSystem` or a :class:`.blockell.BlockSystem`).

    ``hier``: an :class:`AmgHierarchy`, or a :class:`MultilevelAmg`, whose
    solve needs ``coeff``, the composite rho*d_p field.  ``cycle_opts``:
    extra kwargs for :func:`v_cycle` (smoother and overcorrection variants;
    aggregation only).  ``frozen`` (aggregation only): ``(coarse_vals,
    factors)`` from :func:`coarse_level_values` — skip the per-call Galerkin
    re-coarsening and use these level-1+ operators instead (level 0 stays
    current; FGMRES is flexible, so the staleness never touches the solve
    contract).  On a row-sharded mesh the aggregation cycle runs replicated
    (:func:`_replicated_pressure_solve`; the block path, which never
    freezes).
    """
    if isinstance(hier, MultilevelAmg):
        return _multilevel_pressure_solve(hier, mesh, sys, coeff)
    if mesh.decomp is not None:
        return _replicated_pressure_solve(hier, mesh, sys, cycle_opts)
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
