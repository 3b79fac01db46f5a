"""Delaunay mesh generator (host-side, NumPy + scipy Qhull).

Capability parity with the reference Delaunay mesher
(src/solver/mesh/delaunay.rs:125-848): boundary seeding, variable-radius
Bridson Poisson-disk interior sampling, SDF-weighted Laplacian generator
smoothing, triangulation, and triangle->Mesh conversion with boundary
classification.  Where the reference hand-rolls a Morton-sorted Bowyer–Watson
with walk-based point location (delaunay.rs:485-730) — necessary in
library-free Rust — the host pipeline here uses scipy's Qhull, the idiomatic
NumPy choice; the robust-predicate concerns it addresses
(Triangle::in_circumcircle, delaunay.rs:88-118) are Qhull's job.
"""

from __future__ import annotations

import numpy as np

from .geometry import Geometry
from .structs import (
    BOUNDARY_INLET,
    BOUNDARY_OUTLET,
    BOUNDARY_WALL,
    Mesh,
)


def _poisson_disk(geo: Geometry, boundary_points: np.ndarray,
                  min_cell_size: float, max_cell_size: float,
                  growth_rate: float, domain_size, seed: int = 0) -> np.ndarray:
    """Variable-radius Bridson sampling (reference delaunay.rs:200-334):
    r(p) = min(min_size + (rate-1)*|sdf(p)|, max_size), k=30 candidates.

    Uses the native C++ kernel when available (pure-Python fallback below)."""
    from . import native
    if native.available(geo):
        pts = native.poisson_disk(geo, boundary_points, min_cell_size,
                                  max_cell_size, growth_rate, domain_size,
                                  seed)
        if pts is not None:
            return pts

    rng = np.random.default_rng(seed)
    r_min = min_cell_size
    cell = r_min / np.sqrt(2.0)
    gw = int(np.ceil(domain_size[0] / cell))
    gh = int(np.ceil(domain_size[1] / cell))

    def radius(px, py):
        d = np.abs(geo.sdf(px, py))
        r = min_cell_size + max(growth_rate - 1.0, 0.0) * d
        return np.minimum(r, max_cell_size)

    pts_x = list(boundary_points[:, 0])
    pts_y = list(boundary_points[:, 1])
    # Grid of point indices (list per cell; variable radius needs windows).
    grid: dict[tuple[int, int], list[int]] = {}
    for i, (x, y) in enumerate(zip(pts_x, pts_y)):
        grid.setdefault((int(x / cell), int(y / cell)), []).append(i)

    active = list(range(len(pts_x)))
    k = 30

    def has_close(x, y, r):
        w = int(np.ceil(r / cell))
        gx, gy = int(x / cell), int(y / cell)
        for ix in range(gx - w, gx + w + 1):
            for iy in range(gy - w, gy + w + 1):
                for j in grid.get((ix, iy), ()):
                    dx = pts_x[j] - x
                    dy = pts_y[j] - y
                    if dx * dx + dy * dy < r * r:
                        return True
        return False

    while active:
        ai = rng.integers(0, len(active))
        p_idx = active[ai]
        px, py = pts_x[p_idx], pts_y[p_idx]
        r = float(radius(np.float64(px), np.float64(py)))

        found = False
        angles = rng.random(k) * 2.0 * np.pi
        dists = rng.uniform(r, 2.0 * r, k)
        for ang, dist in zip(angles, dists):
            nx = px + dist * np.cos(ang)
            ny = py + dist * np.sin(ang)
            if not (0.0 <= nx <= domain_size[0] and 0.0 <= ny <= domain_size[1]):
                continue
            if geo.sdf(np.float64(nx), np.float64(ny)) >= -0.3 * r:
                continue  # outside fluid or too close to the boundary
            nr = float(radius(np.float64(nx), np.float64(ny)))
            if has_close(nx, ny, nr):
                continue
            idx = len(pts_x)
            pts_x.append(nx)
            pts_y.append(ny)
            grid.setdefault((int(nx / cell), int(ny / cell)), []).append(idx)
            active.append(idx)
            found = True
        if not found:
            active[ai] = active[-1]
            active.pop()

    return np.stack([np.array(pts_x), np.array(pts_y)], axis=-1)


def _smooth_generators(points: np.ndarray, n_fixed: int, tri_simplices,
                       geo: Geometry, iterations: int = 20,
                       alpha: float = 0.1) -> np.ndarray:
    """SDF-weighted Laplacian smoothing of interior generators
    (reference delaunay.rs:173-195, alpha=0.1)."""
    from scipy.spatial import Delaunay as SciDelaunay

    pts = points.copy()
    n = len(pts)
    for _ in range(iterations):
        tri = SciDelaunay(pts)
        s = tri.simplices
        # adjacency via triangle edges
        e = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [2, 0]]])
        e = np.concatenate([e, e[:, ::-1]])
        sums = np.zeros((n, 2))
        cnts = np.zeros(n)
        np.add.at(sums, e[:, 0], pts[e[:, 1]])
        np.add.at(cnts, e[:, 0], 1.0)
        avg = sums / np.maximum(cnts, 1.0)[:, None]
        new = pts + alpha * (avg - pts)
        new[:n_fixed] = pts[:n_fixed]           # boundary generators fixed
        # Keep interior points strictly inside the fluid.
        inside = geo.sdf(new[:, 0], new[:, 1]) < 0.0
        pts = np.where(inside[:, None], new, pts)
    return pts


def triangulate(geo: Geometry, min_cell_size: float, max_cell_size: float,
                growth_rate: float, domain_size, seed: int = 0):
    """Sample + smooth + triangulate; returns (points, simplices, fixed_mask).

    Triangles whose centroid lies outside the fluid are discarded — this is
    what makes holes (obstacles) work (reference's hole handling is tested by
    tests/reproduce_hole.rs)."""
    from scipy.spatial import Delaunay as SciDelaunay

    boundary = geo.get_boundary_points(min_cell_size)
    # Dedup boundary points.
    keys = np.round(boundary * 1e9).astype(np.int64)
    _, uniq = np.unique(keys[:, 0] * np.int64(2 ** 31) + keys[:, 1],
                        return_index=True)
    boundary = boundary[np.sort(uniq)]
    n_fixed = len(boundary)

    points = _poisson_disk(geo, boundary, min_cell_size, max_cell_size,
                           growth_rate, domain_size, seed)
    points = _smooth_generators(points, n_fixed, None, geo)

    tri = SciDelaunay(points)
    s = tri.simplices
    cx = points[s, 0].mean(axis=1)
    cy = points[s, 1].mean(axis=1)
    keep = geo.sdf(cx, cy) < 0.0
    s = s[keep]

    fixed = np.zeros(len(points), dtype=bool)
    fixed[:n_fixed] = True
    return points, s, fixed


def _mesh_from_triangles(points: np.ndarray, simplices: np.ndarray,
                         fixed: np.ndarray, domain_size) -> Mesh:
    """Triangles -> Mesh with CCW winding, deduped faces, and boundary
    classification by face-center x (reference delaunay.rs:732-848)."""
    # Ensure CCW winding.
    p0 = points[simplices[:, 0]]
    p1 = points[simplices[:, 1]]
    p2 = points[simplices[:, 2]]
    cross = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - \
            (p2[:, 0] - p0[:, 0]) * (p1[:, 1] - p0[:, 1])
    flip = cross < 0
    simplices = simplices.copy()
    simplices[flip] = simplices[flip][:, [0, 2, 1]]

    n_cells = len(simplices)
    e_v1 = simplices[:, [0, 1, 2]].ravel()
    e_v2 = simplices[:, [1, 2, 0]].ravel()
    e_cell = np.repeat(np.arange(n_cells), 3)

    nv = len(points)
    lo = np.minimum(e_v1, e_v2)
    hi = np.maximum(e_v1, e_v2)
    key = lo.astype(np.int64) * nv + hi
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    n_faces = len(uniq)

    face_v1 = e_v1[first]
    face_v2 = e_v2[first]
    face_owner = e_cell[first]
    face_neighbor = np.full(n_faces, -1, dtype=np.int64)
    order = np.argsort(inv, kind="stable")
    si = inv[order]
    second = np.zeros(len(order), dtype=bool)
    second[1:] = si[1:] == si[:-1]
    face_neighbor[si[second]] = e_cell[order[second]]

    vx = points[:, 0]
    vy = points[:, 1]
    fx0, fy0 = vx[face_v1], vy[face_v1]
    fx1, fy1 = vx[face_v2], vy[face_v2]
    flen = np.hypot(fx1 - fx0, fy1 - fy0)
    face_cx = 0.5 * (fx0 + fx1)
    face_cy = 0.5 * (fy0 + fy1)
    face_nx = (fy1 - fy0) / flen
    face_ny = -(fx1 - fx0) / flen

    internal = face_neighbor >= 0
    face_boundary = np.where(
        internal, 0,
        np.where(face_cx < 1e-6, BOUNDARY_INLET,
                 np.where(np.abs(face_cx - float(domain_size[0])) < 1e-6,
                          BOUNDARY_OUTLET, BOUNDARY_WALL))).astype(np.int32)

    counts = np.full(n_cells, 3, dtype=np.int64)
    offsets = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    mesh = Mesh(
        vx=vx.copy(), vy=vy.copy(), v_fixed=fixed.copy(),
        face_v1=face_v1, face_v2=face_v2,
        face_owner=face_owner, face_neighbor=face_neighbor,
        face_boundary=face_boundary,
        face_nx=face_nx, face_ny=face_ny, face_area=flen,
        face_cx=face_cx, face_cy=face_cy,
        cell_cx=np.zeros(n_cells), cell_cy=np.zeros(n_cells),
        cell_vol=np.zeros(n_cells),
        cell_faces=inv.astype(np.int64), cell_face_offsets=offsets,
        cell_vertices=simplices.ravel().astype(np.int64),
        cell_vertex_offsets=offsets.copy(),
    )
    mesh.recalculate_geometry()
    return mesh


def generate_delaunay_mesh(geo: Geometry, min_cell_size: float,
                           max_cell_size: float, growth_rate: float,
                           domain_size, seed: int = 0) -> Mesh:
    """Equivalent of reference ``generate_delaunay_mesh`` (delaunay.rs:732)."""
    points, simplices, fixed = triangulate(
        geo, min_cell_size, max_cell_size, growth_rate, domain_size, seed)
    return _mesh_from_triangles(points, simplices, fixed, domain_size)
