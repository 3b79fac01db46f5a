"""Device mesh encoding: host ``Mesh`` -> padded tensors on one device.

Port of ``cfd2_tpu.runtime.device_mesh`` for the structured fast path:
uniform cut-cell meshes are laid out on their generating (ny, nx) grid with
solid cells masked out, and slots 0..3 fixed to the E/W/N/S neighbors.  Every
neighbor access is then an edge-clamped shift of the grid.  The generic
(unstructured) and multilevel layouts are not ported yet: ``encode_mesh``
raises ``NotImplementedError`` for meshes that are not a uniform grid.

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
    """Tensors describing one structured mesh on one device."""

    # --- static metadata ---
    num_cells: int                # device cell count (incl. masked solids)
    num_faces: int
    max_faces: int                # K
    num_host_cells: int           # fluid cells in the host mesh
    grid_shape: tuple             # (ny, nx)
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

    @property
    def structured(self) -> bool:
        return self.grid_shape is not None

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Neighbor values per slot: (N, ...) -> (N, K, ...): four
        edge-clamped shifts of the (ny, nx) grid (clamped values are always
        masked by zero coefficients) + self for extra slots."""
        tail = tuple(x.shape[1:])
        ny, nx = self.grid_shape
        xg = x.reshape((ny, nx) + tail)
        e, w, n, s = _shift_slots(xg)
        slots = [e, w, n, s] + [xg] * (self.max_faces - 4)
        return torch.stack(slots, dim=2).reshape((ny * nx, self.max_faces)
                                                 + tail)

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
        """Per-slot outward mass fluxes (N, K); the structured layout stores
        them in slot layout already."""
        return fluxes

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


def _not_structured():
    return NotImplementedError(
        "only uniform cut-cell meshes (the structured grid layout) are "
        "ported; the generic and multilevel layouts are later work")


def encode_mesh(mesh: Mesh, device=None, pad_rows_to: int = 1,
                pad_cols_to: int = 1) -> DeviceMesh:
    """Encode a host mesh onto ``device`` (CUDA unless the caller names
    another; see :func:`resolve_device`).

    ``pad_rows_to`` / ``pad_cols_to``: round ny / nx up to a multiple (the
    extra rows / columns are masked solid cells).
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

    grid = _detect_uniform_grid(mesh)
    if grid is None:
        raise _not_structured()

    # ------------------------------------------------------------------
    # Device cell layout.
    h, nx, ny, ixs, jys = grid
    if pad_rows_to > 1:
        ny = ((ny + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
    if pad_cols_to > 1:
        nx = ((nx + pad_cols_to - 1) // pad_cols_to) * pad_cols_to
    N_dev = nx * ny
    dev_of_host = (jys * nx + ixs).astype(np.int64)

    host_of_dev = np.full(N_dev, -1, dtype=np.int64)
    host_of_dev[dev_of_host] = np.arange(N_host)
    c_valid = (host_of_dev >= 0).astype(np.float64)
    hsafe = np.maximum(host_of_dev, 0)

    c_cx = np.where(c_valid > 0, mesh.cell_cx[hsafe], 0.0)
    c_cy = np.where(c_valid > 0, mesh.cell_cy[hsafe], 0.0)
    c_vol = np.where(c_valid > 0, mesh.cell_vol[hsafe], 1.0)
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
        # Two internal faces share a direction slot / unassigned internal
        # face: not a uniform grid (the JAX package falls back to its
        # generic path here).
        raise _not_structured()
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

    def scat(vals, fill=0.0, idtype=np.float64):
        out = np.full((N_dev, K), fill, dtype=idtype)
        out[e_dev, e_slot] = vals
        return out

    ck_neighbor = np.tile(np.arange(N_dev, dtype=np.int64)[:, None], (1, K))
    ck_neighbor[e_dev, e_slot] = ngh_dev

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
        grid_shape=(ny, nx), device=device,
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
