"""Device mesh encoding: host ``Mesh`` -> padded tensors on one device.

Port of ``cfd2_tpu.runtime.device_mesh``:

* **structured fast path**: uniform cut-cell meshes are laid out on their
  generating (ny, nx) grid with solid cells masked out, and slots 0..3 fixed
  to the E/W/N/S neighbors.  Every neighbor access is then an edge-clamped
  shift of the grid.
* **generic path**: Delaunay / Voronoi meshes keep arbitrary (N, K) neighbor
  indices.  Cells are ordered so that neighbors fall in narrow index bands,
  the count is padded to a multiple of 128, each cell's slots are sorted by
  neighbor id and trailing pad slots repeat the last real neighbor.  Every
  neighbor access goes through the CUDA kernels of
  :mod:`..ops.banded_kernels`, which take ``ck_neighbor`` itself.

The cell ordering, the ``banded`` decision and the slot cap ``bd_k`` are
chosen exactly as the JAX package chooses them, by the walk costs of its TPU
index maps (:mod:`..ops.banded_maps`): they decide the aggregation hierarchy
and the smoother's arithmetic, so the port mirrors them to give the same
iterations, although no kernel here reads such a map.

The multilevel (refined quadtree) layout is not ported yet: ``encode_mesh``
raises ``NotImplementedError`` for meshes that would take it.

All geometric factors are computed on the host in float64 (the same NumPy
code as the JAX package) and stored as float32 tensors; indices are int32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.structs import Mesh

# Structured slot convention.
SLOT_E, SLOT_W, SLOT_N, SLOT_S = 0, 1, 2, 3


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no GPU present, ``device=None`` raises instead of quietly
    running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


def _shift_slots(xg: torch.Tensor):
    """Edge-clamped E, W, N, S shifts of an (ny, nx, ...) grid."""
    e = torch.cat([xg[:, 1:], xg[:, -1:]], dim=1)
    w = torch.cat([xg[:, :1], xg[:, :-1]], dim=1)
    n = torch.cat([xg[1:], xg[-1:]], dim=0)
    s = torch.cat([xg[:1], xg[:-1]], dim=0)
    return e, w, n, s


@dataclass
class DeviceMesh:
    """Tensors describing one mesh on one device."""

    # --- static metadata ---
    num_cells: int                # device cell count (incl. masked solids)
    num_faces: int
    max_faces: int                # K
    num_host_cells: int           # fluid cells in the host mesh
    grid_shape: tuple | None      # (ny, nx) for the structured fast path
    device: torch.device

    # --- face-major (F,) ---
    f_owner: torch.Tensor         # int32 (device ids)
    f_neighbor: torch.Tensor      # int32, -1 = boundary
    f_neighbor_safe: torch.Tensor
    f_internal: torch.Tensor      # bool
    f_boundary: torch.Tensor      # int32 code (0/1/2/3)
    f_area: torch.Tensor
    f_nx: torch.Tensor            # canonical: points OUT of owner
    f_ny: torch.Tensor
    f_cx: torch.Tensor
    f_cy: torch.Tensor
    f_lambda: torch.Tensor        # owner-side dist weight d_n/(d_o+d_n)
    f_dist_cc: torch.Tensor       # max(|(c_n - c_o) . n|, 1e-6)

    # --- cell-major (N,) ---
    c_cx: torch.Tensor
    c_cy: torch.Tensor
    c_vol: torch.Tensor
    c_valid: torch.Tensor         # f32: 1 fluid, 0 masked solid
    grid_of_cell: torch.Tensor    # (num_host_cells,) device index of host cell

    # --- cell-major padded (N, K) ---
    ck_face: torch.Tensor         # int32 face index (pad: 0)
    ck_mask: torch.Tensor         # f32 1.0 valid / 0.0 pad
    ck_sign: torch.Tensor         # f32 +1 owner / -1 neighbor (pad: 0)
    ck_neighbor: torch.Tensor     # int32 adjacent device cell (pad/bdry: self)
    ck_is_boundary: torch.Tensor  # f32 1.0 if boundary face
    ck_boundary: torch.Tensor     # int32 boundary code
    ck_nx: torch.Tensor           # outward normal from THIS cell
    ck_ny: torch.Tensor
    ck_area: torch.Tensor
    ck_lam: torch.Tensor          # own-side weight: d_other/(d_own+d_other)
    ck_lam_other: torch.Tensor    # the partner entry's own lam
    ck_dist_proj: torch.Tensor    # max(|d . n|, 1e-6)
    ck_dist: torch.Tensor         # plain |other - this center|
    ck_rx: torch.Tensor           # f_center - this center
    ck_ry: torch.Tensor
    ck_dcdx: torch.Tensor         # other_center - this center
    ck_dcdy: torch.Tensor

    # Optional per-face inlet velocity profile scale (None = uniform inlet).
    f_inlet_scale: torch.Tensor | None = None
    ck_inlet_scale: torch.Tensor | None = None

    # Host copies for setup-time consumers (the AMG hierarchy build).
    amg_host: dict | None = None

    # Generic layout: True when the JAX package would build a banded index
    # map for this mesh (its banded solver path); False sends it to the
    # block-ELL path there, which is not ported.
    banded: bool = False
    # Slot cap (generic layout, K > 8 with at most 5% of cells occupying a
    # slot >= 8): the Jacobi-sweep smoother walks only the first bd_k slots.
    # gather() and banded_dot() stay exact: they walk all K slots, whose pad
    # entries repeat a real neighbor and carry zero coefficients.
    bd_k: int | None = None

    @property
    def structured(self) -> bool:
        return self.grid_shape is not None

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Neighbor values per slot: (N, ...) -> (N, K, ...).

        Structured: four edge-clamped shifts of the (ny, nx) grid (clamped
        values are always masked by zero coefficients) + self for extra
        slots.  Generic: one gather through ``ck_neighbor``
        (:func:`..ops.banded_kernels.banded_gather`)."""
        if not self.structured:
            self._need_banded()
            from ..ops.banded_kernels import banded_gather
            return banded_gather(x.contiguous(), self.ck_neighbor)
        tail = tuple(x.shape[1:])
        ny, nx = self.grid_shape
        xg = x.reshape((ny, nx) + tail)
        e, w, n, s = _shift_slots(xg)
        slots = [e, w, n, s] + [xg] * (self.max_faces - 4)
        return torch.stack(slots, dim=2).reshape((ny * nx, self.max_faces)
                                                 + tail)

    def _need_banded(self) -> None:
        if not self.banded:
            raise NotImplementedError(
                "this generic mesh admits no banded index map, which sends "
                "it to the block-ELL path of the JAX package; that path is "
                "not ported")

    def banded_dot(self, xs, offs, prods):
        """Fused neighbor sums over the mesh map: out_j = sum over (oi, ci)
        in prods[j] of sum_k offs[oi][:, k] * xs[ci][neighbor[:, k]]; the
        gathered values never reach device memory
        (:func:`..ops.banded_kernels.banded_dot`).

        Coefficients on unoccupied (pad) slots MUST be zero (the assembly
        invariant).  The kernel walks all K slots, so no slot-cap correction
        is needed."""
        self._need_banded()
        from ..ops.banded_kernels import banded_dot
        return banded_dot(xs, offs, self.ck_neighbor, prods)

    def banded_sweeps_fit(self, n_comps: int) -> bool:
        """The JAX package's rule for running its one-kernel multi-sweep
        Jacobi: the iterate ping-pong, right-hand sides and inverse diagonal
        (3*C + 1 row planes) must fit 12 MiB of TPU VMEM.  Kept with its
        number because on a slot-capped map it decides whether the smoother
        drops the overflow slots (one-kernel sweeps) or not (per-sweep
        dots), and so the iteration counts on either side of it."""
        nb = -(-self.num_cells // 128)
        resident = (3 * n_comps + 1) * nb * 128 * 4
        return resident <= 12 * 2**20

    def banded_jacobi_sweeps(self, rs, dinv, off, sweeps: int):
        """``sweeps`` Jacobi iterations z = dinv*(r - A_off z) from the seed
        dinv*r for each rhs in ``rs``, in one kernel call
        (:func:`..ops.banded_kernels.banded_jacobi_sweeps`).  On a
        slot-capped map (``bd_k``) A_off drops the occupied slots >= bd_k,
        as the JAX package's smoother does (it is a preconditioner, and the
        outer FGMRES is flexible)."""
        self._need_banded()
        from ..ops.banded_kernels import banded_jacobi_sweeps
        return banded_jacobi_sweeps(rs, dinv, off, self.ck_neighbor, sweeps,
                                    k_cap=self.bd_k)

    def shift_from_west(self, v: torch.Tensor) -> torch.Tensor:
        """(N,) value of the west neighbor (edge-clamped)."""
        ny, nx = self.grid_shape
        vg = v.reshape(ny, nx)
        return torch.cat([vg[:, :1], vg[:, :-1]], dim=1).reshape(-1)

    def shift_from_south(self, v: torch.Tensor) -> torch.Tensor:
        ny, nx = self.grid_shape
        vg = v.reshape(ny, nx)
        return torch.cat([vg[:1], vg[:-1]], dim=0).reshape(-1)

    def slot_fluxes(self, fluxes: torch.Tensor) -> torch.Tensor:
        """Per-slot outward mass fluxes (N, K).  The structured and banded
        paths store them in slot layout already; a face-major (F,) field
        (one owner-outward value per face) is gathered per slot and signed
        per side."""
        if self.structured or fluxes.dim() == 2:
            return fluxes
        from ..ops.banded_kernels import banded_gather
        return banded_gather(fluxes.contiguous(), self.ck_face) * self.ck_sign

    def to_host_order(self, x: torch.Tensor) -> torch.Tensor:
        """Device cell field -> host mesh cell order."""
        return x[self.grid_of_cell.long()]

    def from_host_order(self, x: torch.Tensor) -> torch.Tensor:
        """Host mesh cell field -> device layout (solids get zeros)."""
        x = torch.as_tensor(x, device=self.device)
        out = torch.zeros((self.num_cells,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=self.device)
        out[self.grid_of_cell.long()] = x
        return out


def _detect_uniform_grid(mesh: Mesh):
    """Return (h, nx, ny, ix, jy) if the mesh is a uniform cut-cell grid
    (all internal faces connect 4-adjacent grid squares), else None.

    Prefers the cut-cell generator's quadtree provenance (cell_gi/cell_gj)
    when the mesh is single-level: it survives boundary smoothing, which
    moves cut-cell centroids enough to break the position-based
    reconstruction."""
    if mesh.num_cells == 0:
        return None
    h = float(np.median(mesh.face_area))
    if h <= 0:
        return None
    if mesh.cell_level is not None and \
            mesh.cell_level.max() == mesh.cell_level.min():
        ix = mesh.cell_gi.astype(np.int64)
        jy = mesh.cell_gj.astype(np.int64)
    else:
        ix = np.floor(mesh.cell_cx / h + 1e-9).astype(np.int64)
        jy = np.floor(mesh.cell_cy / h + 1e-9).astype(np.int64)
    if ix.min() < 0 or jy.min() < 0:
        return None
    nx = int(ix.max()) + 1
    ny = int(jy.max()) + 1
    if nx * ny > 4 * mesh.num_cells + 64:
        return None                      # too sparse: not a uniform grid
    key = jy * nx + ix
    if len(np.unique(key)) != mesh.num_cells:
        return None
    internal = mesh.face_neighbor >= 0
    do = mesh.face_owner[internal]
    dn = mesh.face_neighbor[internal]
    dx = ix[dn] - ix[do]
    dy = jy[dn] - jy[do]
    if not ((np.abs(dx) + np.abs(dy)) == 1).all():
        return None
    return h, nx, ny, ix, jy


def _multilevel_layout(mesh: Mesh):
    """Device layout for a locally-refined quadtree mesh: each refinement
    level is its own (ny, nx) uniform grid (holes masked), concatenated
    finest-first.  Returns (shapes, offsets, N_dev, dev_of_host) or None.
    The layout itself is not ported; ``encode_mesh`` uses this only to tell
    a mesh that would take it from one that goes to the generic path."""
    lev = mesh.cell_level
    if lev is None or lev.max() == lev.min():
        return None
    lev = lev - lev.min()           # finest present = 0
    gi = mesh.cell_gi
    gj = mesh.cell_gj
    nlev = int(lev.max()) + 1
    ext_x = int(((gi + 1) << lev).max())    # extent in finest units
    ext_y = int(((gj + 1) << lev).max())
    shapes = []
    offsets = []
    off = 0
    for li in range(nlev):
        nxl = (ext_x + (1 << li) - 1) >> li
        nyl = (ext_y + (1 << li) - 1) >> li
        shapes.append((nyl, nxl))
        offsets.append(off)
        off += nyl * nxl
    offs = np.asarray(offsets, np.int64)
    nxs = np.asarray([s[1] for s in shapes], np.int64)
    dev_of_host = offs[lev] + gj * nxs[lev] + gi
    if len(np.unique(dev_of_host)) != len(dev_of_host):
        return None                 # inconsistent metadata
    if off > 6 * mesh.num_cells:
        # The embedded layout allocates every level as a FULL grid; with
        # refinement localized to a small region the slot waste dominates
        # (0.002/0.008 channel-obstacle: 984k slots for 80k cells).  The
        # JAX package keeps the embedding only while slots stay within 6x
        # the real cells and sends the rest to the generic path.
        return None
    return tuple(shapes), offsets, off, dev_of_host


def _band_order_cost(rank, owner_i, neigh_i, N_host):
    """Best achievable banded-map walk cost (the JAX package's vreg-gather
    units, see ops/banded_maps.window_cost) for a candidate cell ordering,
    computed on a sorted-slot proxy ELL of the internal adjacency.  The real encode
    adds boundary/self slots, but those sit on the diagonal and never
    widen a block's source window, so the proxy ranks orderings
    faithfully.  Returns None when no banded map builds."""
    from ..ops.banded_maps import (build_banded_map, build_banded_map2,
                                   build_banded_map_grouped, grouped_cost,
                                   window_cost)
    N_dev = ((N_host + 127) // 128) * 128
    ii = np.concatenate([rank[owner_i], rank[neigh_i]])
    jj = np.concatenate([rank[neigh_i], rank[owner_i]])
    order = np.lexsort((jj, ii))
    ii, jj = ii[order], jj[order]
    counts = np.bincount(ii, minlength=N_dev)
    K = int(counts.max())
    if K == 0:
        return None
    start = np.zeros(N_dev + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    slot = np.arange(len(ii)) - start[ii]
    ck = np.tile(np.arange(N_dev, dtype=np.int64)[:, None], (1, K))
    ck[ii, slot] = jj
    occ = np.zeros((N_dev, K), bool)
    occ[ii, slot] = True
    ffi = np.maximum.accumulate(
        np.where(occ, np.arange(K)[None, :], 0), axis=1)
    ck = np.take_along_axis(ck, ffi, axis=1)

    costs = []
    bl = build_banded_map(ck, N_dev)
    if bl is not None:
        costs.append(window_cost(bl[3], K))
    for nw in (2, 3, 4):
        bl2 = build_banded_map2(ck, N_dev, n_windows=nw)
        if bl2 is not None:
            costs.append(window_cost(bl2[3], K, nw))
    blg = build_banded_map_grouped(ck, N_dev)
    if blg is not None:
        costs.append(grouped_cost(blg[3]))
    return min(costs) if costs else None


def _generic_rank(mesh: Mesh, owner, neigh, internal, N_host):
    """Cell ordering for the generic (unstructured) layout.

    Candidates — RCM plus geometric column sweeps — are scored by the best
    banded-map walk cost they admit on the real adjacency; cheapest wins.
    The score is the JAX package's (a TPU cost); it is kept because the
    winner fixes the device cell order, and with it the greedy aggregation
    and the iteration counts.
    RCM minimizes graph bandwidth, but on polygonal (voronoi) meshes its
    single band runs 2-3x the geometric cross-section, while a column
    sweep bucketed at ~1-2 mean spacings concentrates each block's sources
    into a few narrow windows, so large voronoi meshes take a column sweep.
    Triangle (delaunay) meshes keep RCM."""
    owner_i = owner[internal]
    neigh_i = neigh[internal]
    candidates = []
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        adj = sp.csr_matrix(
            (np.ones(2 * len(owner_i)),
             (np.concatenate([owner_i, neigh_i]),
              np.concatenate([neigh_i, owner_i]))),
            shape=(N_host, N_host))
        perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True),
                          dtype=np.int64)
        rank = np.empty(N_host, dtype=np.int64)
        rank[perm] = np.arange(N_host)
        candidates.append(("rcm", rank))
    except Exception:
        pass

    cx, cy = mesh.cell_cx, mesh.cell_cy
    ex = float(cx.max() - cx.min()) if N_host else 0.0
    ey = float(cy.max() - cy.min()) if N_host else 0.0
    if N_host and max(ex, ey) > 0:
        spacing = np.sqrt(max(ex * ey, 1e-300) / N_host)
        along, across = (cx, cy) if ex >= ey else (cy, cx)
        for mult in (1.0, 2.0):
            bx = np.floor((along - along.min())
                          / max(mult * spacing, 1e-300)).astype(np.int64)
            order = np.lexsort((across, bx))
            rank = np.empty(N_host, dtype=np.int64)
            rank[order] = np.arange(N_host)
            candidates.append((f"colsweep-x{mult:g}", rank))

        # Level-aware sweep for locally-refined quadtree meshes that fall
        # through to the generic path: segregate refinement levels, column-sweep each level at ITS
        # OWN spacing (sqrt of the per-cell volume).  Same-level neighbors
        # then sit in a narrow per-level band and cross-level neighbors in
        # one other compact region — exactly the shape the multi-window
        # banded maps (build_banded_map2) capture, instead of one global
        # band as wide as the worst cross-section mix.
        lev = mesh.cell_level
        if lev is not None and int(lev.max()) != int(lev.min()):
            own = np.sqrt(np.maximum(np.asarray(mesh.cell_vol), 1e-300))
            for mult in (1.0, 2.0):
                bx = np.floor((along - along.min())
                              / np.maximum(mult * own, 1e-300)).astype(np.int64)
                order = np.lexsort((across, bx, lev))
                rank = np.empty(N_host, dtype=np.int64)
                rank[order] = np.arange(N_host)
                candidates.append((f"lev-colsweep-x{mult:g}", rank))

    if not candidates:
        return np.arange(N_host, dtype=np.int64)
    if len(candidates) == 1 or len(owner_i) == 0:
        return candidates[0][1]
    best = None
    for name, rank in candidates:
        c = _band_order_cost(rank, owner_i, neigh_i, N_host)
        if c is not None and (best is None or c < best[0]):
            best = (c, name, rank)
    return best[2] if best is not None else candidates[0][1]


def _banded_decision(ck_neighbor, occ, N_dev):
    """``(banded, bd_k)`` as the JAX package decides them.

    Slot cap: when K > 8 and at most 5% of cells occupy a slot >= 8
    (polygonal meshes), its kernel map covers the first 8 sorted slots only
    and ``bd_k = 8``.  ``banded`` is whether any of its index maps (single
    window, 2-4 windows, sorted-slot grouped) builds on that map; when none
    does the cap does not apply either."""
    from ..ops.banded_maps import (build_banded_map, build_banded_map2,
                                   build_banded_map_grouped)
    K = ck_neighbor.shape[1]
    ck_map = ck_neighbor
    bd_k = None
    if K > 8:
        ovr, _ = np.nonzero(occ[:, 8:])
        if len(ovr) <= 0.05 * N_dev:
            ck_map = ck_neighbor[:, :8]
            bd_k = 8
    banded = (build_banded_map(ck_map, N_dev) is not None
              or build_banded_map_grouped(ck_map, N_dev) is not None
              or any(build_banded_map2(ck_map, N_dev, n_windows=nw)
                     is not None for nw in (2, 3, 4)))
    return banded, (bd_k if banded else None)


def encode_mesh(mesh: Mesh, device=None, structured: str = "auto",
                pad_rows_to: int = 1, pad_cols_to: int = 1) -> DeviceMesh:
    """Encode a host mesh onto ``device`` (CUDA unless the caller names
    another; see :func:`resolve_device`).

    ``structured``: "auto" picks the stencil fast path when the mesh is a
    uniform cut-cell grid; "never" forces the generic layout.
    ``pad_rows_to`` / ``pad_cols_to``: round ny / nx up to a multiple (the
    extra rows / columns are masked solid cells; structured layout only).
    """
    device = resolve_device(device)
    N_host = mesh.num_cells
    F = mesh.num_faces

    owner = mesh.face_owner.astype(np.int64)
    neigh = mesh.face_neighbor.astype(np.int64)
    internal = neigh >= 0
    neigh_safe = np.where(internal, neigh, owner)

    # Canonicalize normals out of the owner cell.
    dxn = mesh.face_cx - mesh.cell_cx[owner]
    dyn = mesh.face_cy - mesh.cell_cy[owner]
    flip = dxn * mesh.face_nx + dyn * mesh.face_ny < 0.0
    f_nx = np.where(flip, -mesh.face_nx, mesh.face_nx)
    f_ny = np.where(flip, -mesh.face_ny, mesh.face_ny)

    grid = _detect_uniform_grid(mesh) if structured == "auto" else None
    if grid is None and structured == "auto" \
            and _multilevel_layout(mesh) is not None:
        raise NotImplementedError(
            "the multilevel layout of refined quadtree meshes is not ported")

    # ------------------------------------------------------------------
    # Device cell layout.
    if grid is not None:
        h, nx, ny, ixs, jys = grid
        if pad_rows_to > 1:
            ny = ((ny + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
        if pad_cols_to > 1:
            nx = ((nx + pad_cols_to - 1) // pad_cols_to) * pad_cols_to
        N_dev = nx * ny
        dev_of_host = (jys * nx + ixs).astype(np.int64)
        grid_shape = (ny, nx)
    else:
        # Generic (unstructured) layout: order cells so neighbors fall in
        # narrow index bands, and pad the count to a multiple of 128 (the
        # JAX package's lane width; kept so that both packages lay cells
        # out identically).  Padded cells are masked identity rows like
        # structured solids.
        dev_of_host = _generic_rank(mesh, owner, neigh, internal, N_host)
        N_dev = ((N_host + 127) // 128) * 128
        grid_shape = None

    host_of_dev = np.full(N_dev, -1, dtype=np.int64)
    host_of_dev[dev_of_host] = np.arange(N_host)
    c_valid = (host_of_dev >= 0).astype(np.float64)
    hsafe = np.maximum(host_of_dev, 0)

    c_cx = np.where(c_valid > 0, mesh.cell_cx[hsafe], 0.0)
    c_cy = np.where(c_valid > 0, mesh.cell_cy[hsafe], 0.0)
    c_vol = np.where(c_valid > 0, mesh.cell_vol[hsafe], 1.0)
    if grid is not None:
        # Masked solid cells get their grid-square center (placeholder only).
        gi = np.arange(N_dev) % nx
        gj = np.arange(N_dev) // nx
        c_cx = np.where(c_valid > 0, c_cx, (gi + 0.5) * h)
        c_cy = np.where(c_valid > 0, c_cy, (gj + 0.5) * h)

    # ------------------------------------------------------------------
    # Entry list: one (face, side) pair per slot occupancy.
    # side 0 = owner, side 1 = neighbor.
    faces_idx = np.arange(F)
    e_face = np.concatenate([faces_idx, faces_idx[internal]])
    e_sign = np.concatenate([np.ones(F), -np.ones(int(internal.sum()))])
    e_host = np.concatenate([owner, neigh[internal]])
    e_dev = dev_of_host[e_host]

    if grid is not None:
        # Slot assignment: internal by grid offset, boundary by outward normal.
        this_ix = ixs[e_host]
        this_jy = jys[e_host]
        oth_host = np.where(e_sign > 0, neigh_safe[e_face], owner[e_face])
        e_internal = internal[e_face]
        dix = np.where(e_internal, ixs[oth_host] - this_ix, 0)
        djy = np.where(e_internal, jys[oth_host] - this_jy, 0)
        onx = f_nx[e_face] * e_sign
        ony = f_ny[e_face] * e_sign
        dir_slot = np.where(
            e_internal,
            np.select([dix == 1, dix == -1, djy == 1, djy == -1],
                      [SLOT_E, SLOT_W, SLOT_N, SLOT_S], default=-1),
            np.select([onx > 0.999, onx < -0.999, ony > 0.999, ony < -0.999],
                      [SLOT_E, SLOT_W, SLOT_N, SLOT_S], default=-1))
        # Resolve conflicts / unassigned into extra slots (vectorized).
        n_e = len(e_face)
        e_slot = np.full(n_e, -1, dtype=np.int64)
        has_dir = dir_slot >= 0
        e_bnd = ~e_internal
        keyd = e_dev * 4 + np.where(has_dir, dir_slot, 0)
        # Within each (cell, direction), prefer the internal face.
        ordk = np.lexsort((e_bnd, keyd))
        sk = keyd[ordk]
        first = np.ones(n_e, dtype=bool)
        first[1:] = sk[1:] != sk[:-1]
        keep = np.zeros(n_e, dtype=bool)
        keep[ordk] = first
        keep &= has_dir
        if (e_internal & has_dir & ~keep).any() or (e_internal & ~has_dir).any():
            # Two internal faces share a direction slot / unassigned
            # internal face: not a uniform grid.  Take the generic layout.
            return encode_mesh(mesh, device=device, structured="never",
                               pad_rows_to=pad_rows_to,
                               pad_cols_to=pad_cols_to)
        e_slot[keep] = dir_slot[keep]
        # Extras: rank within cell.
        idxe = np.nonzero(~keep)[0]
        K_extra = 0
        if len(idxe):
            orde = np.argsort(e_dev[idxe], kind="stable")
            sc = e_dev[idxe][orde]
            change = np.ones(len(idxe), dtype=bool)
            change[1:] = sc[1:] != sc[:-1]
            grp_start = np.maximum.accumulate(
                np.where(change, np.arange(len(idxe)), 0))
            rank = np.arange(len(idxe)) - grp_start
            e_slot[idxe[orde]] = 4 + rank
            K_extra = int(rank.max()) + 1
        K = 4 + K_extra
    else:
        # Generic: slots in the host CSR order (sorted by neighbor below).
        counts = np.diff(mesh.cell_face_offsets)
        K = int(counts.max())
        csr_cells = np.repeat(np.arange(N_host), counts)
        within = np.arange(len(mesh.cell_faces)) - np.repeat(
            mesh.cell_face_offsets[:-1], counts)
        csr_faces = mesh.cell_faces
        e_face = csr_faces
        e_sign = np.where(owner[csr_faces] == csr_cells, 1.0, -1.0)
        e_host = csr_cells
        e_dev = dev_of_host[csr_cells]
        e_slot = within
        oth_host = np.where(e_sign > 0, neigh_safe[e_face], owner[e_face])

    # ------------------------------------------------------------------
    # Per-entry geometry (float64), scattered into (N_dev, K).
    fc_x = mesh.face_cx[e_face]
    fc_y = mesh.face_cy[e_face]
    this_cx = mesh.cell_cx[e_host]
    this_cy = mesh.cell_cy[e_host]
    e_is_b = ~internal[e_face]
    oc_x = np.where(e_is_b, fc_x, mesh.cell_cx[oth_host])
    oc_y = np.where(e_is_b, fc_y, mesh.cell_cy[oth_host])

    nrm_x = f_nx[e_face] * e_sign
    nrm_y = f_ny[e_face] * e_sign
    area = mesh.face_area[e_face]

    d_this = np.hypot(this_cx - fc_x, this_cy - fc_y)
    d_other = np.hypot(oc_x - fc_x, oc_y - fc_y)
    tot = d_this + d_other
    lam = np.where(tot > 1e-6, d_other / np.maximum(tot, 1e-300), 0.5)
    lam_other = np.where(tot > 1e-6, d_this / np.maximum(tot, 1e-300), 0.5)

    dvx = oc_x - this_cx
    dvy = oc_y - this_cy
    dist_proj = np.maximum(np.abs(dvx * nrm_x + dvy * nrm_y), 1e-6)
    dist = np.maximum(np.hypot(dvx, dvy), 1e-12)
    bdry = np.where(e_is_b, mesh.face_boundary[e_face], 0)
    ngh_dev = np.where(e_is_b, e_dev, dev_of_host[oth_host])

    if grid is None:
        # Sort each cell's slots by neighbor device id: slot k then holds
        # the k-th order statistic of the cell's neighbors (the JAX
        # package's sorted-slot maps rely on it; here it fixes which slots
        # the cap below cuts).
        ords = np.lexsort((ngh_dev, e_dev))
        sd = e_dev[ords]
        change = np.ones(len(ords), dtype=bool)
        change[1:] = sd[1:] != sd[:-1]
        grp_start = np.maximum.accumulate(
            np.where(change, np.arange(len(ords)), 0))
        e_slot = np.empty(len(ords), dtype=np.int64)
        e_slot[ords] = np.arange(len(ords)) - grp_start

    def scat(vals, fill=0.0, idtype=np.float64):
        out = np.full((N_dev, K), fill, dtype=idtype)
        out[e_dev, e_slot] = vals
        return out

    ck_neighbor = np.tile(np.arange(N_dev, dtype=np.int64)[:, None], (1, K))
    ck_neighbor[e_dev, e_slot] = ngh_dev

    banded = False
    bd_k = None
    if grid is None:
        # Padded trailing slots repeat the cell's last real neighbor;
        # sorted ranks are contiguous from slot 0, so occupancy is a prefix
        # and fully masked padding cells keep self.
        occ = np.zeros((N_dev, K), dtype=bool)
        occ[e_dev, e_slot] = True
        ffi = np.maximum.accumulate(
            np.where(occ, np.arange(K)[None, :], 0), axis=1)
        ck_neighbor = np.take_along_axis(ck_neighbor, ffi, axis=1)
        banded, bd_k = _banded_decision(ck_neighbor, occ, N_dev)

    mask = np.zeros((N_dev, K))
    mask[e_dev, e_slot] = 1.0

    # Face-level arrays with device ids.
    d_own_f = np.hypot(mesh.cell_cx[owner] - mesh.face_cx,
                       mesh.cell_cy[owner] - mesh.face_cy)
    d_ngh_f = np.hypot(mesh.cell_cx[neigh_safe] - mesh.face_cx,
                       mesh.cell_cy[neigh_safe] - mesh.face_cy)
    tot_f = d_own_f + d_ngh_f
    lam_f = np.where(tot_f > 1e-6, d_ngh_f / np.maximum(tot_f, 1e-300), 0.5)
    ccx = mesh.cell_cx[neigh_safe] - mesh.cell_cx[owner]
    ccy = mesh.cell_cy[neigh_safe] - mesh.cell_cy[owner]
    dist_cc = np.maximum(np.abs(ccx * f_nx + ccy * f_ny), 1e-6)

    def as_f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def as_i(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)

    is_b_nk = scat(e_is_b.astype(np.float64))
    bdry_nk = scat(bdry, 0, np.int64)
    return DeviceMesh(
        num_cells=N_dev, num_faces=F, max_faces=K, num_host_cells=N_host,
        grid_shape=grid_shape, device=device, banded=banded, bd_k=bd_k,
        f_owner=as_i(dev_of_host[owner]),
        f_neighbor=as_i(np.where(internal, dev_of_host[neigh_safe], -1)),
        f_neighbor_safe=as_i(dev_of_host[neigh_safe]),
        f_internal=torch.as_tensor(internal, device=device),
        f_boundary=as_i(mesh.face_boundary),
        f_area=as_f(mesh.face_area), f_nx=as_f(f_nx), f_ny=as_f(f_ny),
        f_cx=as_f(mesh.face_cx), f_cy=as_f(mesh.face_cy),
        f_lambda=as_f(lam_f), f_dist_cc=as_f(dist_cc),
        c_cx=as_f(c_cx), c_cy=as_f(c_cy), c_vol=as_f(c_vol),
        c_valid=as_f(c_valid), grid_of_cell=as_i(dev_of_host),
        ck_face=as_i(scat(e_face, 0, np.int64)),
        ck_mask=as_f(mask),
        ck_sign=as_f(scat(e_sign)),
        ck_neighbor=as_i(ck_neighbor),
        ck_is_boundary=as_f(is_b_nk),
        ck_boundary=as_i(bdry_nk),
        ck_nx=as_f(scat(nrm_x)), ck_ny=as_f(scat(nrm_y)),
        ck_area=as_f(scat(area)),
        ck_lam=as_f(scat(lam, 0.5)),
        ck_lam_other=as_f(scat(lam_other, 0.5)),
        ck_dist_proj=as_f(scat(dist_proj, 1.0)),
        ck_dist=as_f(scat(dist, 1.0)),
        ck_rx=as_f(scat(fc_x - this_cx)), ck_ry=as_f(scat(fc_y - this_cy)),
        ck_dcdx=as_f(scat(dvx)), ck_dcdy=as_f(scat(dvy)),
        amg_host={
            "ck_mask": np.asarray(mask, np.float32),
            "ck_is_boundary": np.asarray(is_b_nk, np.float32),
            "c_valid": np.asarray(c_valid, np.float32),
            "ck_neighbor": np.asarray(ck_neighbor, np.int32),
            "ck_boundary": np.asarray(bdry_nk, np.int32),
        },
    )
