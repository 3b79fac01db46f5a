"""Voronoi mesh generator — dual of the Delaunay triangulation.

Capability parity with the reference (src/solver/mesh/voronoi.rs:23-782):
Voronoi vertices are triangle circumcenters plus boundary-edge midpoints and
boundary generator points (voronoi.rs:69-102); one face per Delaunay edge
(internal: circumcenter-to-circumcenter; boundary: circumcenter-to-midpoint
plus two wall segments, :109-234); cell polygons are chained from their face
edges and forced CCW (:275-386); concave boundary cells are split into fans
of triangles around their generator with faces re-wired (fix_concave_cells,
:405-721).
"""

from __future__ import annotations

import numpy as np

from .delaunay import triangulate
from .geometry import Geometry
from .structs import (
    BOUNDARY_INLET,
    BOUNDARY_OUTLET,
    BOUNDARY_WALL,
    Mesh,
)


def _circumcenters(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    a = points[tris[:, 0]]
    b = points[tris[:, 1]]
    c = points[tris[:, 2]]
    d = 2.0 * (a[:, 0] * (b[:, 1] - c[:, 1]) + b[:, 0] * (c[:, 1] - a[:, 1])
               + c[:, 0] * (a[:, 1] - b[:, 1]))
    d = np.where(np.abs(d) < 1e-300, 1e-300, d)
    a2 = (a * a).sum(1)
    b2 = (b * b).sum(1)
    c2 = (c * c).sum(1)
    ux = (a2 * (b[:, 1] - c[:, 1]) + b2 * (c[:, 1] - a[:, 1])
          + c2 * (a[:, 1] - b[:, 1])) / d
    uy = (a2 * (c[:, 0] - b[:, 0]) + b2 * (a[:, 0] - c[:, 0])
          + c2 * (b[:, 0] - a[:, 0])) / d
    return np.stack([ux, uy], axis=-1)


def _classify(face_cx, domain_x):
    if face_cx < 1e-6:
        return BOUNDARY_INLET
    if abs(face_cx - domain_x) < 1e-6:
        return BOUNDARY_OUTLET
    return BOUNDARY_WALL


def generate_voronoi_mesh(geo: Geometry, min_cell_size: float,
                          max_cell_size: float, growth_rate: float,
                          domain_size, seed: int = 0) -> Mesh:
    points, tris, _fixed = triangulate(geo, min_cell_size, max_cell_size,
                                       growth_rate, domain_size, seed)
    n_gen = len(points)
    cc = _circumcenters(points, tris)

    # Edge -> triangles map.
    e_all = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    t_all = np.tile(np.arange(len(tris)), 3)
    lo = np.minimum(e_all[:, 0], e_all[:, 1])
    hi = np.maximum(e_all[:, 0], e_all[:, 1])
    key = lo.astype(np.int64) * n_gen + hi
    order = np.argsort(key, kind="stable")
    skey = key[order]
    edge_tris: dict[int, list[int]] = {}
    for k, t in zip(skey, t_all[order]):
        edge_tris.setdefault(int(k), []).append(int(t))

    # Voronoi vertex pool (dedup by quantization).
    vor_x: list[float] = []
    vor_y: list[float] = []
    v_fixed: list[bool] = []
    vmap: dict[tuple[int, int], int] = {}

    def add_vertex(x, y, fixed=False):
        kq = (int(round(x * 1e9)), int(round(y * 1e9)))
        idx = vmap.get(kq)
        if idx is None:
            idx = len(vor_x)
            vor_x.append(float(x))
            vor_y.append(float(y))
            v_fixed.append(fixed)
            vmap[kq] = idx
        elif fixed:
            v_fixed[idx] = True
        return idx

    cc_idx = [add_vertex(c[0], c[1]) for c in cc]

    # Faces.
    f_v1: list[int] = []
    f_v2: list[int] = []
    f_owner: list[int] = []
    f_neigh: list[int] = []
    f_bdry: list[int] = []
    cell_faces: list[list[int]] = [[] for _ in range(n_gen)]

    def add_face(v1, v2, owner, neigh, bdry):
        if v1 == v2:
            return None
        dx = vor_x[v1] - vor_x[v2]
        dy = vor_y[v1] - vor_y[v2]
        if dx * dx + dy * dy < 1e-20:
            return None
        idx = len(f_v1)
        f_v1.append(v1)
        f_v2.append(v2)
        f_owner.append(owner)
        f_neigh.append(neigh)
        f_bdry.append(bdry)
        # cell_faces tracks generator cells only (chaining phase); spoke faces
        # added during concave splitting reference final cell ids instead.
        if owner < n_gen:
            cell_faces[owner].append(idx)
        if 0 <= neigh < n_gen:
            cell_faces[neigh].append(idx)
        return idx

    dom_x = float(domain_size[0])
    for k, ts in edge_tris.items():
        v1 = int(k // n_gen)
        v2 = int(k % n_gen)
        if len(ts) == 2:
            add_face(cc_idx[ts[0]], cc_idx[ts[1]], v1, v2, 0)
        else:
            p1 = points[v1]
            p2 = points[v2]
            mid = 0.5 * (p1 + p2)
            i_mid = add_vertex(mid[0], mid[1], fixed=True)
            i_p1 = add_vertex(p1[0], p1[1], fixed=True)
            i_p2 = add_vertex(p2[0], p2[1], fixed=True)
            # Main dual face between the two generator cells.
            add_face(cc_idx[ts[0]], i_mid, v1, v2, 0)
            # Two boundary wall segments.
            c1 = 0.5 * (mid + p1)
            add_face(i_mid, i_p1, v1, -1, _classify(c1[0], dom_x))
            c2 = 0.5 * (mid + p2)
            add_face(i_mid, i_p2, v2, -1, _classify(c2[0], dom_x))

    vor_x_arr = np.array(vor_x)
    vor_y_arr = np.array(vor_y)

    # ------------------------------------------------------------------
    # Chain each cell's faces into a polygon; force CCW (voronoi.rs:275-386).
    cell_polys: list[list[int]] = []
    keep_cell: list[bool] = []
    for ci in range(n_gen):
        faces = cell_faces[ci]
        adj: dict[int, list[int]] = {}
        for fi in faces:
            adj.setdefault(f_v1[fi], []).append(f_v2[fi])
            adj.setdefault(f_v2[fi], []).append(f_v1[fi])
        if len(adj) < 3:
            cell_polys.append([])
            keep_cell.append(False)
            continue
        start = next(iter(adj))
        poly = [start]
        visited = {start}
        prev = -1
        curr = start
        ok = True
        while True:
            nxt = None
            for cand in adj[curr]:
                if cand == prev:
                    continue
                if cand == start and len(poly) >= 3:
                    nxt = start
                    break
                if cand not in visited:
                    nxt = cand
                    break
            if nxt is None:
                ok = False
                break
            if nxt == start:
                break
            poly.append(nxt)
            visited.add(nxt)
            prev, curr = curr, nxt
        ok = ok and len(poly) >= 3 and len(poly) == len(adj)
        if ok:
            px = vor_x_arr[poly]
            py = vor_y_arr[poly]
            area2 = np.sum(px * np.roll(py, -1) - np.roll(px, -1) * py)
            if area2 < 0:
                poly.reverse()
            if abs(area2) < 1e-14:
                ok = False
        cell_polys.append(poly if ok else [])
        keep_cell.append(ok)

    # ------------------------------------------------------------------
    # Split concave cells into fans around their generator (voronoi.rs:405-721).
    face_edge_map = {}
    for fi in range(len(f_v1)):
        a, b = f_v1[fi], f_v2[fi]
        face_edge_map[(min(a, b), max(a, b))] = fi

    def is_convex(poly):
        px = vor_x_arr[poly]
        py = vor_y_arr[poly]
        ex = np.roll(px, -1) - px
        ey = np.roll(py, -1) - py
        cr = ex * np.roll(ey, -1) - ey * np.roll(ex, -1)
        return (cr >= -1e-12 * max(1.0, np.abs(cr).max())).all()

    new_cell_ids = {}
    next_cell = 0
    for ci in range(n_gen):
        if keep_cell[ci]:
            new_cell_ids[ci] = next_cell
            next_cell += 1

    split_cells = [ci for ci in range(n_gen)
                   if keep_cell[ci] and not is_convex(cell_polys[ci])]
    split_set = set(split_cells)

    # Final cell data.
    final_polys: list[list[int]] = []
    final_faces: list[list[int]] = []

    # Keep convex cells (renumbered).
    renum = {}
    for ci in range(n_gen):
        if keep_cell[ci] and ci not in split_set:
            renum[ci] = len(final_polys)
            poly = cell_polys[ci]
            final_polys.append(poly)
            final_faces.append([
                face_edge_map[(min(poly[k], poly[(k + 1) % len(poly)]),
                               max(poly[k], poly[(k + 1) % len(poly)]))]
                for k in range(len(poly))])

    # Split concave cells into a fan of triangles anchored at the generator
    # (voronoi.rs fix_concave_cells).  If the generator is itself a polygon
    # vertex (boundary cells) the fan is anchored there; otherwise the
    # generator is inserted as a new interior vertex.
    for ci in split_set:
        poly = list(cell_polys[ci])
        n = len(poly)
        g = add_vertex(points[ci][0], points[ci][1])

        if g in poly:
            # Rotate so the anchor is poly[0]; fan = (p0, p_k, p_{k+1}).
            j = poly.index(g)
            poly = poly[j:] + poly[:j]
            tri_polys = [[poly[0], poly[k], poly[k + 1]]
                         for k in range(1, n - 1)]
            edge_of_tri = [[(poly[k], poly[k + 1])] for k in range(1, n - 1)]
            edge_of_tri[0].append((poly[0], poly[1]))
            edge_of_tri[-1].append((poly[n - 1], poly[0]))
            spokes = [(poly[0], poly[k]) for k in range(2, n - 1)]
            spoke_between = [(k - 1, k) for k in range(1, len(tri_polys))]
        else:
            tri_polys = [[poly[k], poly[(k + 1) % n], g] for k in range(n)]
            edge_of_tri = [[(poly[k], poly[(k + 1) % n])] for k in range(n)]
            spokes = [(g, poly[k]) for k in range(n)]
            spoke_between = [((k - 1) % n, k) for k in range(n)]

        # Validity: all fan triangles must have positive area (star-shaped
        # from the anchor); otherwise keep the concave polygon as-is.
        ok = True
        for t in tri_polys:
            ax, ay = vor_x[t[0]], vor_y[t[0]]
            bx, by = vor_x[t[1]], vor_y[t[1]]
            cx_, cy_ = vor_x[t[2]], vor_y[t[2]]
            if (bx - ax) * (cy_ - ay) - (cx_ - ax) * (by - ay) <= 1e-14:
                ok = False
                break
        if not ok:
            cell_id = len(final_polys)
            final_polys.append(list(cell_polys[ci]))
            final_faces.append([
                face_edge_map[(min(cell_polys[ci][k],
                                   cell_polys[ci][(k + 1) % n]),
                               max(cell_polys[ci][k],
                                   cell_polys[ci][(k + 1) % n]))]
                for k in range(n)])
            continue

        base = len(final_polys)
        tri_ids = [base + k for k in range(len(tri_polys))]
        tri_face_lists = [[] for _ in tri_polys]
        for (ta, tb), (v1s, v2s) in zip(spoke_between, spokes):
            si = add_face(v1s, v2s, tri_ids[ta], tri_ids[tb], 0)
            if si is not None:
                tri_face_lists[ta].append(si)
                tri_face_lists[tb].append(si)
        for k, edges_k in enumerate(edge_of_tri):
            for (a, b) in edges_k:
                fi = face_edge_map[(min(a, b), max(a, b))]
                tri_face_lists[k].append(fi)
        for tp, fl in zip(tri_polys, tri_face_lists):
            final_polys.append(tp)
            final_faces.append(fl)

    vor_x_arr = np.array(vor_x)
    vor_y_arr = np.array(vor_y)

    # Rewrite owners/neighbors: walk final cells' face lists.
    # (Sized here: the concave-split loop appends spoke faces.)
    f_owner_new = [-1] * len(f_v1)
    f_neigh_new = [-1] * len(f_v1)

    def assign(fi, cell_id):
        if f_owner_new[fi] < 0:
            f_owner_new[fi] = cell_id
        else:
            f_neigh_new[fi] = cell_id

    n_final = len(final_polys)
    for cell_id, fl in enumerate(final_faces):
        for fi in fl:
            assign(fi, cell_id)

    # Drop faces that reference dropped cells on both sides.
    valid_face = [f_owner_new[fi] >= 0 for fi in range(len(f_v1))]
    face_renum = np.cumsum(valid_face) - 1

    fv1 = np.array([f_v1[i] for i in range(len(f_v1)) if valid_face[i]])
    fv2 = np.array([f_v2[i] for i in range(len(f_v1)) if valid_face[i]])
    fow = np.array([f_owner_new[i] for i in range(len(f_v1)) if valid_face[i]])
    fng = np.array([f_neigh_new[i] for i in range(len(f_v1)) if valid_face[i]])
    fbd = np.array([f_bdry[i] for i in range(len(f_v1)) if valid_face[i]],
                   dtype=np.int32)
    # A face that lost its neighbor cell becomes a wall.
    lost = (fng < 0) & (fbd == 0)
    orig_internal = np.array(
        [f_neigh[i] >= 0 for i in range(len(f_v1)) if valid_face[i]])
    fbd = np.where(lost & orig_internal, BOUNDARY_WALL, fbd).astype(np.int32)

    fx0, fy0 = vor_x_arr[fv1], vor_y_arr[fv1]
    fx1, fy1 = vor_x_arr[fv2], vor_y_arr[fv2]
    flen = np.hypot(fx1 - fx0, fy1 - fy0)
    fcx = 0.5 * (fx0 + fx1)
    fcy = 0.5 * (fy0 + fy1)
    fnx = (fy1 - fy0) / np.maximum(flen, 1e-300)
    fny = -(fx1 - fx0) / np.maximum(flen, 1e-300)

    cf_flat = []
    cf_off = [0]
    cv_flat = []
    cv_off = [0]
    for cell_id in range(n_final):
        cf_flat.extend(int(face_renum[fi]) for fi in final_faces[cell_id])
        cf_off.append(len(cf_flat))
        cv_flat.extend(final_polys[cell_id])
        cv_off.append(len(cv_flat))

    mesh = Mesh(
        vx=vor_x_arr, vy=vor_y_arr,
        v_fixed=np.array(v_fixed, dtype=bool),
        face_v1=fv1.astype(np.int64), face_v2=fv2.astype(np.int64),
        face_owner=fow.astype(np.int64), face_neighbor=fng.astype(np.int64),
        face_boundary=fbd,
        face_nx=fnx, face_ny=fny, face_area=flen, face_cx=fcx, face_cy=fcy,
        cell_cx=np.zeros(n_final), cell_cy=np.zeros(n_final),
        cell_vol=np.zeros(n_final),
        cell_faces=np.array(cf_flat, dtype=np.int64),
        cell_face_offsets=np.array(cf_off, dtype=np.int64),
        cell_vertices=np.array(cv_flat, dtype=np.int64),
        cell_vertex_offsets=np.array(cv_off, dtype=np.int64),
    )
    mesh.recalculate_geometry()

    # Canonicalize normals to point out of the owner.
    dx = mesh.face_cx - mesh.cell_cx[mesh.face_owner]
    dy = mesh.face_cy - mesh.cell_cy[mesh.face_owner]
    flip = dx * mesh.face_nx + dy * mesh.face_ny < 0.0
    mesh.face_nx = np.where(flip, -mesh.face_nx, mesh.face_nx)
    mesh.face_ny = np.where(flip, -mesh.face_ny, mesh.face_ny)
    return mesh
