"""Host-side unstructured polygonal mesh container (SoA, NumPy float64).

Capability parity with the reference ``Mesh`` struct and its methods
(reference: src/solver/mesh/structs.rs:13-354).  All geometry recomputation
and skewness metrics are vectorized NumPy (the reference uses rayon +
hand-rolled loops).  Laplacian smoothing (``Mesh.smooth``, backed by the
native C++ library in the JAX package) is not part of this package yet.

Boundary codes (BoundaryType):
    0 = internal face, 1 = Inlet, 2 = Outlet, 3 = Wall
These integer codes match the ones used on-device by the solver kernels (and
the reference's WGSL: prepare_coupled.wgsl:183-194).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BOUNDARY_NONE = 0
BOUNDARY_INLET = 1
BOUNDARY_OUTLET = 2
BOUNDARY_WALL = 3


@dataclass
class Mesh:
    # Vertices
    vx: np.ndarray = field(default_factory=lambda: np.zeros(0))
    vy: np.ndarray = field(default_factory=lambda: np.zeros(0))
    v_fixed: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=bool))

    # Faces
    face_v1: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    face_v2: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    face_owner: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    face_neighbor: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))  # -1 = boundary
    face_boundary: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int32))
    face_nx: np.ndarray = field(default_factory=lambda: np.zeros(0))
    face_ny: np.ndarray = field(default_factory=lambda: np.zeros(0))
    face_area: np.ndarray = field(default_factory=lambda: np.zeros(0))
    face_cx: np.ndarray = field(default_factory=lambda: np.zeros(0))
    face_cy: np.ndarray = field(default_factory=lambda: np.zeros(0))

    # Cells
    cell_cx: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cell_cy: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cell_vol: np.ndarray = field(default_factory=lambda: np.zeros(0))

    # Connectivity (CSR-style)
    cell_faces: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    cell_face_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.int64))
    cell_vertices: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    cell_vertex_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.int64))

    # Optional quadtree provenance (cut-cell meshes only): per-cell
    # refinement level (0 = finest leaves present) and integer grid position
    # (gi, gj) on that level's uniform grid.  None for generators that don't
    # produce it (Delaunay/Voronoi); enables the multilevel stencil fast
    # path in runtime/device_mesh.py.
    cell_level: np.ndarray | None = None
    cell_gi: np.ndarray | None = None
    cell_gj: np.ndarray | None = None

    @property
    def num_cells(self) -> int:
        return len(self.cell_cx)

    @property
    def num_faces(self) -> int:
        return len(self.face_cx)

    @property
    def num_vertices(self) -> int:
        return len(self.vx)

    # ------------------------------------------------------------------

    def recalculate_geometry(self) -> None:
        """Recompute face centers/areas/normals and cell centroids/volumes from
        vertex positions (reference structs.rs:61-157), fully vectorized."""
        vx, vy = self.vx, self.vy

        # Faces
        x0 = vx[self.face_v1]
        y0 = vy[self.face_v1]
        x1 = vx[self.face_v2]
        y1 = vy[self.face_v2]
        self.face_cx = 0.5 * (x0 + x1)
        self.face_cy = 0.5 * (y0 + y1)
        ex = x1 - x0
        ey = y1 - y0
        ln = np.hypot(ex, ey)
        self.face_area = ln
        safe = np.maximum(ln, 1e-300)
        tx, ty = ex / safe, ey / safe
        nx, ny = ty, -tx
        # Preserve existing orientation.
        flip = nx * self.face_nx + ny * self.face_ny < 0.0
        sign = np.where(flip, -1.0, 1.0)
        self.face_nx = nx * sign
        self.face_ny = ny * sign

        # Cells: polygon area + centroid via the shoelace formula over the
        # (variable-length) vertex lists, vectorized with segment offsets.
        offs = self.cell_vertex_offsets
        counts = np.diff(offs)
        n_cells = len(counts)
        cv = self.cell_vertices
        # Index of "next vertex within the same cell" for each entry of cv.
        nxt = np.arange(len(cv)) + 1
        ends = offs[1:] - 1                      # last slot of each cell
        nxt[ends] = offs[:-1]                    # wrap around per cell
        p0x, p0y = vx[cv], vy[cv]
        p1x, p1y = vx[cv[nxt]], vy[cv[nxt]]
        cross = p0x * p1y - p1x * p0y
        seg_ids = np.repeat(np.arange(n_cells), counts)
        signed_area = 0.5 * np.bincount(seg_ids, weights=cross, minlength=n_cells)
        cx6 = np.bincount(seg_ids, weights=(p0x + p1x) * cross, minlength=n_cells)
        cy6 = np.bincount(seg_ids, weights=(p0y + p1y) * cross, minlength=n_cells)
        area = np.abs(signed_area)
        good = area > 1e-12
        denom = np.where(good, 6.0 * signed_area, 1.0)
        ccx = cx6 / denom
        ccy = cy6 / denom
        # Fallback to vertex average for degenerate cells.
        avg_x = np.bincount(seg_ids, weights=p0x, minlength=n_cells) / np.maximum(counts, 1)
        avg_y = np.bincount(seg_ids, weights=p0y, minlength=n_cells) / np.maximum(counts, 1)
        self.cell_cx = np.where(good, ccx, avg_x)
        self.cell_cy = np.where(good, ccy, avg_y)
        self.cell_vol = area

    # ------------------------------------------------------------------

    def calculate_max_skewness(self) -> float:
        """Max face skewness: 1 - |d_hat . n| over all faces
        (reference structs.rs:294-320)."""
        owner = self.face_owner
        neigh = self.face_neighbor
        internal = neigh >= 0
        ox = self.cell_cx[owner]
        oy = self.cell_cy[owner]
        tx = np.where(internal, self.cell_cx[np.maximum(neigh, 0)], self.face_cx)
        ty = np.where(internal, self.cell_cy[np.maximum(neigh, 0)], self.face_cy)
        dx = tx - ox
        dy = ty - oy
        nrm = np.hypot(dx, dy)
        ok = nrm * nrm > 1e-12
        safe = np.maximum(nrm, 1e-300)
        dot = np.abs((dx * self.face_nx + dy * self.face_ny) / safe)
        skew = np.where(ok, 1.0 - dot, 1.0)
        return float(skew.max()) if len(skew) else 0.0

    # ------------------------------------------------------------------

    def get_cell_at_pos(self, x: float, y: float) -> int | None:
        """Point-in-polygon lookup by ray casting (reference structs.rs:324-353)."""
        for i in range(self.num_cells):
            s, e = self.cell_vertex_offsets[i], self.cell_vertex_offsets[i + 1]
            verts = self.cell_vertices[s:e]
            px = self.vx[verts]
            py = self.vy[verts]
            j = len(verts) - 1
            inside = False
            for k in range(len(verts)):
                if (py[k] > y) != (py[j] > y) and (
                    x < (px[j] - px[k]) * (y - py[k]) / (py[j] - py[k]) + px[k]
                ):
                    inside = not inside
                j = k
            if inside:
                return i
        return None

    # ------------------------------------------------------------------

    def validate(self) -> list[str]:
        """Structural sanity checks; returns a list of problems (empty = OK)."""
        problems = []
        if (self.cell_vol <= 0).any():
            problems.append(f"{int((self.cell_vol <= 0).sum())} non-positive cell volumes")
        if (self.face_area <= 0).any():
            problems.append(f"{int((self.face_area <= 0).sum())} non-positive face areas")
        if (self.face_owner >= self.num_cells).any():
            problems.append("face_owner out of range")
        if (self.face_neighbor >= self.num_cells).any():
            problems.append("face_neighbor out of range")
        internal = self.face_neighbor >= 0
        if (self.face_boundary[internal] != BOUNDARY_NONE).any():
            problems.append("internal face with boundary tag")
        if (self.face_boundary[~internal] == BOUNDARY_NONE).any():
            problems.append("boundary face without boundary tag")
        return problems
