"""Cut-cell Cartesian mesh generator (host-side, NumPy).

Capability parity with the reference generator (src/solver/mesh/cut_cell.rs:10-510):
quadtree-refined Cartesian grid, marching-squares-style SDF cuts with
false-position root finding, sharp-corner reconstruction by intersecting
boundary tangent lines, hanging-node imprinting, and face dedup via quantized
vertex keys.  The implementation is redesigned around NumPy vectorization:

  * the quadtree forest is refined breadth-first with batched SDF calls,
  * all edge/SDF intersections are root-found in one vectorized pass,
  * vertex dedup is an ``np.unique`` over quantized integer keys,
  * hanging nodes are found with sorted-key range queries instead of the
    reference's SIMD point-on-segment grid search (hanging nodes only occur on
    axis-aligned quadtree edges, which makes exact range queries possible),
  * faces are deduped with one ``np.unique`` over (min,max) vertex-pair keys.
"""

from __future__ import annotations

import numpy as np

from .geometry import Geometry
from .quadtree import refine_leaves
from .structs import (
    BOUNDARY_INLET,
    BOUNDARY_OUTLET,
    BOUNDARY_WALL,
    Mesh,
)
from .utils import intersect_lines

_SDF_TOL = 1e-9
_QUANT = 100000.0  # vertex quantization, matches reference cut_cell.rs:26


def _quant_key(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    kx = np.round(np.asarray(x) * _QUANT).astype(np.int64)
    ky = np.round(np.asarray(y) * _QUANT).astype(np.int64)
    return (kx << 32) | (ky + (1 << 31)), kx, ky + (1 << 31)


def _bisect_intersections(geo, p0x, p0y, p1x, p1y, d0, d1, iters: int = 10):
    """Vectorized false-position root find of the SDF along segments
    (reference cut_cell.rs:117-147)."""
    t_a = np.zeros_like(d0)
    t_b = np.ones_like(d0)
    d_a = d0.copy()
    d_b = d1.copy()
    t = t_a - d_a * (t_b - t_a) / (d_b - d_a)
    active = np.ones(t.shape, dtype=bool)
    for _ in range(iters):
        ix = p0x + (p1x - p0x) * t
        iy = p0y + (p1y - p0y) * t
        d = geo.sdf(ix, iy)
        active &= np.abs(d) >= 1e-12
        same_side = np.sign(d) == np.sign(d_a)
        d_a = np.where(active & same_side, d, d_a)
        t_a = np.where(active & same_side, t, t_a)
        d_b = np.where(active & ~same_side, d, d_b)
        t_b = np.where(active & ~same_side, t, t_b)
        denom = d_b - d_a
        active &= np.abs(denom) >= 1e-20
        t_new = t_a - d_a * (t_b - t_a) / np.where(np.abs(denom) < 1e-20, 1.0, denom)
        t = np.where(active, t_new, t)
    return t


def generate_cut_cell_mesh(geo: Geometry, min_cell_size: float, max_cell_size: float,
                           growth_rate: float, domain_size) -> Mesh:
    """Generate a cut-cell mesh of the fluid region of ``geo``.

    Equivalent of reference ``generate_cut_cell_mesh`` (cut_cell.rs:10).
    ``domain_size`` is (width, height); boundary faces are classified Inlet at
    x=0, Outlet at x=width, and Wall elsewhere (cut_cell.rs:457-463).
    """
    mins, maxs = refine_leaves(geo, min_cell_size, max_cell_size, growth_rate,
                               domain_size)
    leaf_idx = np.arange(len(mins))

    # Corner SDFs for every leaf: order p00, p10, p11, p01 (CCW).
    cx = np.stack([mins[:, 0], maxs[:, 0], maxs[:, 0], mins[:, 0]], axis=-1)
    cy = np.stack([mins[:, 1], mins[:, 1], maxs[:, 1], maxs[:, 1]], axis=-1)
    d = geo.sdf(cx, cy)

    inside = d < -_SDF_TOL
    all_outside = ~inside.any(axis=1)
    all_inside = inside.all(axis=1)
    is_rect = all_inside
    is_cut = ~all_outside & ~all_inside

    # ------------------------------------------------------------------
    # Rectangular interior cells: 4 CCW corners each, fully vectorized.
    rx = cx[is_rect]          # (R, 4)
    ry = cy[is_rect]
    R = len(rx)

    # ------------------------------------------------------------------
    # Cut cells: vectorized intersection root-finds, then per-cell assembly.
    ccx = cx[is_cut]          # (C, 4)
    ccy = cy[is_cut]
    cd = d[is_cut]
    C = len(ccx)

    nxt = [1, 2, 3, 0]
    d_curr = cd                           # (C, 4)
    d_next = cd[:, nxt]
    crossing = ((d_curr < -_SDF_TOL) & (d_next >= -_SDF_TOL)) | \
               ((d_curr >= -_SDF_TOL) & (d_next < -_SDF_TOL))

    ci, ck = np.nonzero(crossing)
    p0x_c = ccx[ci, ck]
    p0y_c = ccy[ci, ck]
    p1x_c = ccx[ci, np.array(nxt)[ck]]
    p1y_c = ccy[ci, np.array(nxt)[ck]]
    t = _bisect_intersections(geo, p0x_c, p0y_c, p1x_c, p1y_c,
                              d_curr[ci, ck], d_next[ci, ck])
    ix = p0x_c + (p1x_c - p0x_c) * t
    iy = p0y_c + (p1y_c - p0y_c) * t

    # Map (cut cell, edge) -> intersection coordinate for the assembly loop.
    inter_x = np.full((C, 4), np.nan)
    inter_y = np.full((C, 4), np.nan)
    inter_x[ci, ck] = ix
    inter_y[ci, ck] = iy

    # Pre-batch the surface normals of all intersection points (one
    # vectorized SDF-gradient call instead of per-cell scalar calls).
    nrm_all = np.full((C, 4, 2), np.nan)
    if len(ix):
        nrm_all[ci, ck] = geo.normal(ix, iy)

    cut_poly_x: list[float] = []
    cut_poly_y: list[float] = []
    cut_poly_fixed: list[bool] = []
    cut_counts = np.zeros(C, dtype=np.int64)
    cmins = mins[is_cut]
    cmaxs = maxs[is_cut]

    for c in range(C):
        # March the 4 edges, collecting inside corners and intersections
        # (cut_cell.rs:98-148).  Each vertex carries its surface normal when
        # it is a boundary intersection.
        verts: list[tuple[float, float, bool, int]] = []
        for k in range(4):
            if cd[c, k] < -_SDF_TOL:
                verts.append((ccx[c, k], ccy[c, k], False, -1))
            if crossing[c, k]:
                verts.append((inter_x[c, k], inter_y[c, k], True, k))
        if len(verts) < 3:
            continue
        # Sharp-corner reconstruction (cut_cell.rs:151-180): between two
        # consecutive boundary-intersection vertices whose surface normals
        # diverge, insert the tangent-line intersection point.
        n = len(verts)
        rebuilt: list[tuple[float, float, bool]] = []
        for k in range(n):
            xk, yk, fk, sk = verts[k]
            xn, yn, fn, sn_ = verts[(k + 1) % n]
            rebuilt.append((xk, yk, fk))
            if fk and fn:
                n1 = nrm_all[c, sk]
                n2 = nrm_all[c, sn_]
                if float(n1 @ n2) < 0.7:
                    corner = intersect_lines((xk, yk), n1, (xn, yn), n2)
                    if corner is not None and abs(float(geo.sdf(
                            np.float64(corner[0]),
                            np.float64(corner[1])))) <= 1e-4:
                        tol = 1e-5
                        if (cmins[c, 0] - tol <= corner[0] <= cmaxs[c, 0] + tol
                                and cmins[c, 1] - tol <= corner[1] <= cmaxs[c, 1] + tol):
                            rebuilt.append((corner[0], corner[1], True))
        for xk, yk, fk in rebuilt:
            cut_poly_x.append(xk)
            cut_poly_y.append(yk)
            cut_poly_fixed.append(fk)
        cut_counts[c] = len(rebuilt)

    # ------------------------------------------------------------------
    # Flatten all polygons (rect first, then cut) into one vertex stream.
    flat_x = np.concatenate([rx.ravel(), np.array(cut_poly_x, dtype=np.float64)])
    flat_y = np.concatenate([ry.ravel(), np.array(cut_poly_y, dtype=np.float64)])
    flat_fixed = np.concatenate([
        np.zeros(R * 4, dtype=bool),
        np.array(cut_poly_fixed, dtype=bool),
    ])
    counts = np.concatenate([np.full(R, 4, dtype=np.int64),
                             cut_counts[cut_counts >= 3]])
    # Quadtree provenance per polygon, carried through every cell drop below.
    cell_leaf = np.concatenate([leaf_idx[is_rect],
                                leaf_idx[is_cut][cut_counts >= 3]])

    # Dedup vertices by quantized coordinates (cut_cell.rs:26-44).
    keys, _, _ = _quant_key(flat_x, flat_y)
    uniq_keys, first_idx, inverse = np.unique(keys, return_index=True,
                                              return_inverse=True)
    vx = flat_x[first_idx]
    vy = flat_y[first_idx]
    v_fixed = np.zeros(len(uniq_keys), dtype=bool)
    np.logical_or.at(v_fixed, inverse, flat_fixed)

    poly_verts = inverse.astype(np.int64)   # flat polygon vertex ids
    poly_offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=poly_offsets[1:])

    # Drop consecutive duplicate vertices within a polygon (can appear when
    # quantization merges nearly-coincident points).
    cell_ids = np.repeat(np.arange(len(counts)), counts)
    nxt_idx = np.arange(len(poly_verts)) + 1
    nxt_idx[poly_offsets[1:] - 1] = poly_offsets[:-1]
    keep = poly_verts != poly_verts[nxt_idx]
    poly_verts = poly_verts[keep]
    cell_ids = cell_ids[keep]
    counts = np.bincount(cell_ids, minlength=len(counts))
    valid_cells = counts >= 3
    # Re-index cells, dropping degenerate ones.
    cell_remap = np.cumsum(valid_cells) - 1
    keep_v = valid_cells[cell_ids]
    poly_verts = poly_verts[keep_v]
    cell_ids = cell_remap[cell_ids[keep_v]]
    counts = counts[valid_cells]
    cell_leaf = cell_leaf[valid_cells]
    n_cells = len(counts)
    poly_offsets = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=poly_offsets[1:])

    # ------------------------------------------------------------------
    # Hanging-node imprinting (cut_cell.rs:194-388).  Hanging nodes only occur
    # on axis-aligned (quadtree) edges, so exact range queries on quantized
    # keys replace the reference's grid+SIMD point-on-segment search.
    poly_verts, poly_offsets = _imprint_hanging_nodes(
        vx, vy, poly_verts, poly_offsets)
    counts = np.diff(poly_offsets)
    cell_ids = np.repeat(np.arange(n_cells), counts)

    # ------------------------------------------------------------------
    # Drop cells with near-zero area (cut_cell.rs:422).
    nxt_idx = np.arange(len(poly_verts)) + 1
    nxt_idx[poly_offsets[1:] - 1] = poly_offsets[:-1]
    p0x_, p0y_ = vx[poly_verts], vy[poly_verts]
    p1x_, p1y_ = vx[poly_verts[nxt_idx]], vy[poly_verts[nxt_idx]]
    cross = p0x_ * p1y_ - p1x_ * p0y_
    signed_area = 0.5 * np.bincount(cell_ids, weights=cross, minlength=n_cells)
    valid_cells = np.abs(signed_area) >= 1e-9
    if not valid_cells.all():
        cell_remap = np.cumsum(valid_cells) - 1
        keep_v = valid_cells[cell_ids]
        poly_verts = poly_verts[keep_v]
        cell_ids = cell_remap[cell_ids[keep_v]]
        counts = counts[valid_cells]
        cell_leaf = cell_leaf[valid_cells]
        n_cells = int(valid_cells.sum())
        poly_offsets = np.zeros(n_cells + 1, dtype=np.int64)
        np.cumsum(counts, out=poly_offsets[1:])

    # ------------------------------------------------------------------
    # Build faces: polygon edges deduped by unordered vertex pair.
    nxt_idx = np.arange(len(poly_verts)) + 1
    nxt_idx[poly_offsets[1:] - 1] = poly_offsets[:-1]
    e_v1 = poly_verts
    e_v2 = poly_verts[nxt_idx]
    e_cell = cell_ids

    # Drop zero-length edges.
    ex = vx[e_v2] - vx[e_v1]
    ey = vy[e_v2] - vy[e_v1]
    elen = np.hypot(ex, ey)
    good = (e_v1 != e_v2) & (elen >= 1e-9)
    e_v1, e_v2, e_cell = e_v1[good], e_v2[good], e_cell[good]

    lo = np.minimum(e_v1, e_v2)
    hi = np.maximum(e_v1, e_v2)
    pair_key = lo * np.int64(len(vx)) + hi
    uniq_pairs, pair_first, pair_inv, pair_counts = np.unique(
        pair_key, return_index=True, return_inverse=True, return_counts=True)
    n_faces = len(uniq_pairs)

    face_v1 = e_v1[pair_first]       # owner's winding order preserved
    face_v2 = e_v2[pair_first]
    face_owner = e_cell[pair_first]
    face_neighbor = np.full(n_faces, -1, dtype=np.int64)
    # The second occurrence of a pair is the neighbor cell.
    order = np.argsort(pair_inv, kind="stable")
    sorted_inv = pair_inv[order]
    second_mask = np.zeros(len(order), dtype=bool)
    second_mask[1:] = sorted_inv[1:] == sorted_inv[:-1]
    face_neighbor[sorted_inv[second_mask]] = e_cell[order[second_mask]]

    fx0, fy0 = vx[face_v1], vy[face_v1]
    fx1, fy1 = vx[face_v2], vy[face_v2]
    face_cx = 0.5 * (fx0 + fx1)
    face_cy = 0.5 * (fy0 + fy1)
    fex, fey = fx1 - fx0, fy1 - fy0
    flen = np.hypot(fex, fey)
    face_nx = fey / flen
    face_ny = -fex / flen

    internal = face_neighbor >= 0
    face_boundary = np.where(
        internal, 0,
        np.where(face_cx < 1e-6, BOUNDARY_INLET,
                 np.where(np.abs(face_cx - float(domain_size[0])) < 1e-6,
                          BOUNDARY_OUTLET, BOUNDARY_WALL))).astype(np.int32)

    # cell_faces CSR, in polygon-edge order per cell.
    cell_face_ids = pair_inv
    face_counts = np.bincount(e_cell, minlength=n_cells)
    cell_face_offsets = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(face_counts, out=cell_face_offsets[1:])

    # Quadtree provenance: per-cell refinement level (0 = finest size
    # present) + integer grid position on that level's uniform grid.  Only
    # attached when every leaf is an exact power-of-2 square of the finest
    # size (clipped domain-edge tiles disqualify); consumers fall back to the
    # generic encoding when absent.
    cell_level = cell_gi = cell_gj = None
    if n_cells:
        lsz_x = maxs[cell_leaf, 0] - mins[cell_leaf, 0]
        lsz_y = maxs[cell_leaf, 1] - mins[cell_leaf, 1]
        dx_dom = float(domain_size[0])
        dy_dom = float(domain_size[1])
        # Tiles on the domain's max-x/max-y edge are clipped
        # (quadtree.refine_leaves:32-33), so their size is NOT the level
        # size; infer the level from the unclipped dimension.  Without this
        # any domain whose extent is not an integer multiple of the cell
        # size (e.g. the 1M flagship: 3.0 / 0.0017 = 1764.7 columns) lost
        # provenance entirely and smoothed meshes fell off the structured
        # fast path.
        clip_x = maxs[cell_leaf, 0] >= dx_dom - 1e-12
        clip_y = maxs[cell_leaf, 1] >= dy_dom - 1e-12
        interior = np.concatenate([lsz_x[~clip_x], lsz_y[~clip_y]])
        h0 = float(interior.min()) if len(interior) else float(lsz_x.min())
        # Unclipped size where available; for the (rare) corner tile clipped
        # in both dims, lsz <= sz, so ceil(log2) recovers the level.
        usz = np.where(~clip_x, lsz_x, np.where(~clip_y, lsz_y,
                                                np.maximum(lsz_x, lsz_y)))
        ratio = usz / h0
        lev = np.where(
            clip_x & clip_y,
            np.ceil(np.log2(np.maximum(ratio, 1e-300)) - 1e-9),
            np.round(np.log2(np.maximum(ratio, 1e-300)))).astype(np.int64)
        sz = h0 * (2.0 ** lev)
        gi = np.round(mins[cell_leaf, 0] / sz)
        gj = np.round(mins[cell_leaf, 1] / sz)
        size_ok_x = (np.abs(lsz_x - sz) < 1e-9 * sz) \
            | (clip_x & (lsz_x <= sz * (1 + 1e-9)))
        size_ok_y = (np.abs(lsz_y - sz) < 1e-9 * sz) \
            | (clip_y & (lsz_y <= sz * (1 + 1e-9)))
        ok = size_ok_x.all() and size_ok_y.all() \
            and (np.abs(gi * sz - mins[cell_leaf, 0]) < 1e-9 * sz).all() \
            and (np.abs(gj * sz - mins[cell_leaf, 1]) < 1e-9 * sz).all()
        if ok:
            cell_level = lev
            cell_gi = gi.astype(np.int64)
            cell_gj = gj.astype(np.int64)

    mesh = Mesh(
        vx=vx, vy=vy, v_fixed=v_fixed,
        face_v1=face_v1, face_v2=face_v2,
        face_owner=face_owner, face_neighbor=face_neighbor,
        face_boundary=face_boundary,
        face_nx=face_nx, face_ny=face_ny, face_area=flen,
        face_cx=face_cx, face_cy=face_cy,
        cell_cx=np.zeros(n_cells), cell_cy=np.zeros(n_cells),
        cell_vol=np.zeros(n_cells),
        cell_faces=cell_face_ids, cell_face_offsets=cell_face_offsets,
        cell_vertices=poly_verts, cell_vertex_offsets=poly_offsets,
        cell_level=cell_level, cell_gi=cell_gi, cell_gj=cell_gj,
    )
    mesh.recalculate_geometry()
    return mesh


def _imprint_hanging_nodes(vx, vy, poly_verts, poly_offsets):
    """Insert vertices that lie strictly inside axis-aligned polygon edges.

    A hanging node appears when quadtree refinement levels differ across an
    edge (or when a cut vertex lands on a shared grid line).  Both only happen
    on horizontal/vertical segments, so for each such edge we range-query the
    globally sorted quantized vertex keys.
    """
    n_entries = len(poly_verts)
    if n_entries == 0:
        return poly_verts, poly_offsets
    counts = np.diff(poly_offsets)
    nxt_idx = np.arange(n_entries) + 1
    nxt_idx[poly_offsets[1:] - 1] = poly_offsets[:-1]
    v1 = poly_verts
    v2 = poly_verts[nxt_idx]

    kx = np.round(vx * _QUANT).astype(np.int64)
    ky = np.round(vy * _QUANT).astype(np.int64) + (1 << 31)

    key_v = (kx << 32) | ky          # sort by (x, y): vertical-edge queries
    key_h = (ky << 32) | kx          # sort by (y, x): horizontal-edge queries
    order_v = np.argsort(key_v, kind="stable")
    order_h = np.argsort(key_h, kind="stable")
    sorted_v = key_v[order_v]
    sorted_h = key_h[order_h]

    vertical = kx[v1] == kx[v2]
    horizontal = ky[v1] == ky[v2]

    # For each edge, the [lo, hi) range of sorted keys strictly inside it.
    lo_q = np.zeros(n_entries, dtype=np.int64)
    hi_q = np.zeros(n_entries, dtype=np.int64)

    vmask = vertical & ~horizontal
    y_lo = np.minimum(ky[v1[vmask]], ky[v2[vmask]])
    y_hi = np.maximum(ky[v1[vmask]], ky[v2[vmask]])
    base = kx[v1[vmask]] << 32
    lo_q[vmask] = np.searchsorted(sorted_v, base | (y_lo + 1))
    hi_q[vmask] = np.searchsorted(sorted_v, base | y_hi)

    hmask = horizontal & ~vertical
    x_lo = np.minimum(kx[v1[hmask]], kx[v2[hmask]])
    x_hi = np.maximum(kx[v1[hmask]], kx[v2[hmask]])
    base_h = ky[v1[hmask]] << 32
    lo_q[hmask] = np.searchsorted(sorted_h, base_h | (x_lo + 1))
    hi_q[hmask] = np.searchsorted(sorted_h, base_h | x_hi)

    hits = np.maximum(hi_q - lo_q, 0)
    hits[~(vmask | hmask)] = 0
    total_hits = int(hits.sum())
    if total_hits == 0:
        return poly_verts, poly_offsets

    # Expand hits: for edge e with h hits, the inserted vertex ids (sorted by
    # key, i.e. ascending coordinate) then possibly reversed to follow the
    # edge direction v1 -> v2.
    edge_idx = np.repeat(np.arange(n_entries), hits)
    within = np.arange(total_hits) - np.repeat(np.cumsum(hits) - hits, hits)
    take = np.repeat(lo_q, hits) + within
    is_vert = vmask[edge_idx]
    hit_vid = np.where(is_vert, order_v[np.minimum(take, len(order_v) - 1)],
                       order_h[np.minimum(take, len(order_h) - 1)])
    # Ascending key order == ascending y (vertical) / x (horizontal); reverse
    # when the edge runs in the negative direction.
    desc = np.where(is_vert, ky[v1[edge_idx]] > ky[v2[edge_idx]],
                    kx[v1[edge_idx]] > kx[v2[edge_idx]])
    rank = np.where(desc, hits[edge_idx] - 1 - within, within)

    # New polygon stream: per edge emit v1 then its hits in order.
    src_edge = np.concatenate([np.arange(n_entries), edge_idx])
    src_rank = np.concatenate([np.full(n_entries, -1, dtype=np.int64), rank])
    src_vid = np.concatenate([v1, hit_vid])
    order_out = np.lexsort((src_rank, src_edge))
    new_verts = src_vid[order_out]

    per_edge = 1 + hits
    cell_ids = np.repeat(np.arange(len(counts)), counts)
    new_counts = np.bincount(cell_ids, weights=per_edge,
                             minlength=len(counts)).astype(np.int64)
    new_offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(new_counts, out=new_offsets[1:])
    return new_verts, new_offsets
