"""Spatial domain decomposition over ``torch.distributed`` ranks.

Port of ``cfd2_tpu.parallel.spatial``.  The JAX module only places data:
XLA's sharding propagation inserts the halo exchanges and the sums across
devices.  PyTorch has nothing of the kind, so here every rank is one process
holding its own block of rows (SPMD), and the code that reads across a
block edge or reduces over cells asks the mesh's :class:`RowDecomposition`
for it explicitly:

* structured meshes: the (ny, nx) grid's rows are cut into equal contiguous
  blocks, one per rank (:func:`shard_mesh`, :func:`shard_state`,
  :func:`shard_cellwise`).  A row shift takes the neighbouring rank's edge
  row (:meth:`RowDecomposition.halo_rows`; one exchange per gathered field
  group), the multigrid legs run on the block plus ghost rows
  (:meth:`RowDecomposition.extend`; the ADI predict's column solves on 15,
  :meth:`RowDecomposition.extend_deep`), and every dot product, norm and max
  that steers a branch is reduced across ranks
  (:meth:`RowDecomposition.all_reduce_sum` / ``all_reduce_max``), so all
  ranks take the same branch;
* banded (unstructured) meshes: contiguous cell ranges, one exchange of
  ``halo`` cells to each side, and the local product through the
  ``banded_dot`` kernel on index maps made local once on the host
  (:func:`local_banded_map`, :func:`banded_spmv_sharded`).

The transport is chosen by the caller and never guessed: ``"nccl"`` moves
CUDA tensors directly (one card per rank); ``"gloo"`` moves host tensors,
so CUDA tensors are staged through host memory for every exchange and
reduction — the transport of several ranks sharing one card, where NCCL
refuses to run.  bf16 tensors travel as f32 (exact both ways).  Either
way every stencil, kernel and reduction computes on the rank's own device.
``COUNT`` counts the exchanges, the bytes they send and the collectives;
:func:`reset_counts` zeroes it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from ..ops import ellsys as el
from ..ops.amg import AmgHierarchy

TRANSPORTS = ("gloo", "nccl")
# Exchanges, bytes sent by this rank in them, and collectives, since the
# last reset_counts().
COUNT = {"exchanges": 0, "exchange_bytes": 0, "allreduces": 0,
         "allgathers": 0}


def reset_counts() -> None:
    for k in COUNT:
        COUNT[k] = 0


class RowDecomposition:
    """``rows`` rows of ``row_size`` cells each, cut into equal contiguous
    blocks over the ranks of ``group`` (None: the default group; with no
    group initialised, one rank holding every row).  Rank r holds rows
    ``[r0, r1)``.

    The rows are the structured grid's rows (``row_size`` = nx), a banded
    mesh's cells (``row_size`` = 1) or a batch's cases."""

    # Ghost rows of a multigrid leg's block (:meth:`extend`): its two
    # half-sweeps and its residual spoil 3 rows at an inner edge, and an
    # even depth keeps every block starting on an even row.
    ghost = 4

    def __init__(self, rows: int, row_size: int = 1, *, transport: str,
                 device, group=None):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r} is not one of "
                             f"{TRANSPORTS}")
        self.group = group
        grouped = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank(group) if grouped else 0
        self.world = dist.get_world_size(group) if grouped else 1
        if grouped and dist.get_backend(group) != transport:
            raise ValueError(f"transport {transport!r}, but the group runs "
                             f"{dist.get_backend(group)!r}")
        self.device = torch.device(device)
        if transport == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl transport moves CUDA tensors only")
        if rows % self.world:
            raise ValueError(f"{rows} rows do not split evenly over "
                             f"{self.world} ranks")
        self.transport = transport
        self.rows, self.row_size = rows, row_size
        self.block = rows // self.world
        self.r0 = self.rank * self.block
        self.r1 = self.r0 + self.block

    @property
    def staged(self) -> bool:
        """True when CUDA tensors travel through host memory (gloo)."""
        return self.transport == "gloo" and self.device.type == "cuda"

    def describe(self) -> str:
        how = ("CUDA tensors staged through host memory" if self.staged
               else "tensors moved in place")
        return (f"{self.transport} ({how}), {self.world} ranks of "
                f"{self.block} rows x {self.row_size} on {self.device}")

    @property
    def cells(self) -> slice:
        """This rank's part of a flat, row-major cell axis."""
        return slice(self.r0 * self.row_size, self.r1 * self.row_size)

    # --- wire ---
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        # bf16 travels as f32 (exact both ways): not every gloo build
        # takes bf16 tensors.
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu() if self.staged else t.contiguous()

    def _back(self, t: torch.Tensor, dtype) -> torch.Tensor:
        return t.to(self.device, dtype)

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r) if self.group is not None \
            else r

    def _exchange(self, lo: torch.Tensor, hi: torch.Tensor):
        """Send ``lo`` (this block's first rows) to the rank below and
        ``hi`` (its last rows) to the rank above; returns what they sent
        (``from_below``, ``from_above``), None at the grid's edges."""
        COUNT["exchanges"] += 1
        ops, below, above = [], None, None
        if self.rank > 0:
            send = self._wire(lo)
            below = torch.empty_like(send)
            ops += [dist.P2POp(dist.isend, send, self._peer(self.rank - 1),
                               self.group, tag=1),
                    dist.P2POp(dist.irecv, below, self._peer(self.rank - 1),
                               self.group, tag=0)]
            COUNT["exchange_bytes"] += send.numel() * send.element_size()
        if self.rank < self.world - 1:
            send = self._wire(hi)
            above = torch.empty_like(send)
            ops += [dist.P2POp(dist.isend, send, self._peer(self.rank + 1),
                               self.group, tag=0),
                    dist.P2POp(dist.irecv, above, self._peer(self.rank + 1),
                               self.group, tag=1)]
            COUNT["exchange_bytes"] += send.numel() * send.element_size()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return (None if below is None else self._back(below, lo.dtype),
                None if above is None else self._back(above, hi.dtype))

    @staticmethod
    def _check_depth(depth: int, rows: int) -> None:
        if not 0 < depth <= rows:
            raise ValueError(f"depth {depth} outside 1..{rows} (the rows of "
                             "one block)")

    def halo_rows(self, x: torch.Tensor, depth: int, dim: int = 0):
        """``(south, north)``: the ``depth`` rows below and above this
        block of ``x`` (rows along ``dim``), from the neighbouring ranks.
        At the grid's edges the edge row repeated (the clamp of an
        edge-clamped shift)."""
        self._check_depth(depth, x.shape[dim])
        if self.world == 1:
            below = above = None
        else:
            below, above = self._exchange(
                x.narrow(dim, 0, depth).contiguous(),
                x.narrow(dim, x.shape[dim] - depth, depth).contiguous())
        if below is None:
            below = x.narrow(dim, 0, 1).repeat_interleave(depth, dim=dim)
        if above is None:
            above = x.narrow(dim, x.shape[dim] - 1, 1).repeat_interleave(
                depth, dim=dim)
        return below, above

    def extend(self, x: torch.Tensor, depth: int, dim: int = 0):
        """``(x_ext, lo)``: this block of ``x`` with ``depth`` ghost rows
        from each neighbouring rank (none beyond the grid's edges), and the
        number of ghost rows below it.  ``x_ext`` is a contiguous slice of
        the global grid, so an edge-clamped stencil on it is exact on every
        row more than its reach away from an inner ghost edge."""
        self._check_depth(depth, x.shape[dim])
        if self.world == 1:
            return x, 0
        below, above = self._exchange(
            x.narrow(dim, 0, depth).contiguous(),
            x.narrow(dim, x.shape[dim] - depth, depth).contiguous())
        parts = [p for p in (below, x, above) if p is not None]
        return torch.cat(parts, dim=dim), 0 if below is None else depth

    def extend_deep(self, x: torch.Tensor, depth: int, dim: int = 0):
        """:meth:`extend` at any depth: no deeper than the block, one
        exchange; deeper (a small grid over many ranks), the whole grid
        all-gathered and the same window cut from it.  Either way the
        window holds the global grid's bits."""
        if depth <= x.shape[dim] or self.world == 1:
            return self.extend(x, min(depth, x.shape[dim]), dim)
        b = x.shape[dim]
        r0, rows = self.rank * b, self.world * b
        whole = self.all_gather_rows(x.contiguous(), dim)
        lo = min(depth, r0)
        return whole.narrow(dim, r0 - lo,
                            min(r0 + b + depth, rows) - r0 + lo), lo

    def trim(self, x_ext: torch.Tensor, depth: int, to: int, dim: int = 0):
        """The rows of an ``extend(., depth)`` block that an
        ``extend(., to)`` block holds (``to <= depth``)."""
        lo = depth - to if self.rank > 0 else 0
        n = x_ext.shape[dim] - lo - (depth - to if self.rank < self.world - 1
                                     else 0)
        return x_ext.narrow(dim, lo, n)

    # --- collectives ---
    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.world == 1:
            return t
        COUNT["allreduces"] += 1
        w = self._wire(t).clone()
        dist.all_reduce(w, op=op, group=self.group)
        return self._back(w, t.dtype)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks.  Every rank receives the same bits
        (gloo and NCCL reduce each element once and broadcast it)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def all_gather_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The whole grid of a block-distributed ``x`` (rows along
        ``dim``), on every rank."""
        if self.world == 1:
            return x
        COUNT["allgathers"] += 1
        w = self._wire(x.contiguous())
        parts = [torch.empty_like(w) for _ in range(self.world)]
        dist.all_gather(parts, w, group=self.group)
        return self._back(torch.cat(parts, dim=dim), x.dtype)

    def own_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of a whole grid ``x`` (rows along ``dim``;
        any grid whose rows split evenly, a coarse level's too)."""
        b = x.shape[dim] // self.world
        return x.narrow(dim, self.rank * b, b)


# ----------------------------------------------------------------------
# Placement (the JAX package's row_sharding / shard_cellwise / shard_state /
# shard_mesh).


def row_sharding(decomp: RowDecomposition) -> slice:
    """This rank's part of flat (N, ...) cell tensors: cell index is
    jy*nx + ix, so axis 0 is the row-major grid and a block of rows is one
    contiguous range."""
    return decomp.cells


def _place(x, num_cells: int, decomp: RowDecomposition, skip=()):
    if isinstance(x, AmgHierarchy) and num_cells >= 0:
        # Its V-cycle runs replicated on every rank: moved whole.
        return _place(x, -1, decomp)
    if isinstance(x, torch.Tensor):
        if x.dim() >= 1 and x.shape[0] == num_cells:
            x = x[row_sharding(decomp)]
        return x.to(decomp.device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return replace(x, **{
            f.name: _place(getattr(x, f.name), num_cells, decomp)
            for f in dataclasses.fields(x)
            if f.name not in skip and getattr(x, f.name) is not None})
    if isinstance(x, (tuple, list)):
        return type(x)(_place(v, num_cells, decomp) for v in x)
    if isinstance(x, dict):
        return {k: _place(v, num_cells, decomp) for k, v in x.items()}
    return x


def shard_cellwise(tree, num_cells: int, decomp: RowDecomposition):
    """Every tensor in ``tree`` (a dataclass, tuple, list or dict, nested)
    whose leading axis is ``num_cells`` cut to this rank's rows, every other
    tensor copied whole, each onto the rank's device.  Works for
    SolverState, an assembled system and a multigrid hierarchy alike (a
    structured hierarchy's planes are (ny, nx): they stay whole, and the
    V-cycle takes its rows itself; an aggregation hierarchy stays whole, its
    V-cycle replicated on every rank)."""
    if num_cells != decomp.rows * decomp.row_size:
        raise ValueError(f"{num_cells} cells, the decomposition covers "
                         f"{decomp.rows} x {decomp.row_size}")
    return _place(tree, num_cells, decomp)


def _check_structured(mesh, decomp: RowDecomposition) -> None:
    if not mesh.structured:
        raise NotImplementedError(
            "spatial sharding needs the structured layout (the multilevel "
            "and banded steps are not sharded)")
    ny, nx = mesh.grid_shape
    if (decomp.rows, decomp.row_size) != (ny, nx):
        raise ValueError(f"the decomposition covers {decomp.rows} x "
                         f"{decomp.row_size}, the grid is {ny} x {nx}; "
                         f"encode with pad_rows_to={decomp.world}")


def shard_state(mesh, state, decomp: RowDecomposition):
    """This rank's rows of every cell-sized state tensor; scalars copied."""
    _check_structured(mesh, decomp)
    return shard_cellwise(state, mesh.num_cells, decomp)


# Mesh fields that stay whole although their length may equal num_cells:
# the host-cell map (one entry per fluid cell) and the face-major arrays.
_WHOLE = ("grid_of_cell",)


def shard_mesh(mesh, decomp: RowDecomposition):
    """This rank's rows of a structured DeviceMesh, with ``decomp``
    attached: its cell-major tensors cut to the block, its face-major
    tensors and host-cell map whole (outside the hot loop), its grid the
    block's (rows, nx)."""
    _check_structured(mesh, decomp)
    whole = tuple(f.name for f in dataclasses.fields(mesh)
                  if f.name.startswith("f_") or f.name in _WHOLE)
    out = _place(mesh, mesh.num_cells, decomp, skip=whole + ("amg_host",))
    moved = {n: getattr(mesh, n).to(decomp.device) for n in whole
             if getattr(mesh, n) is not None}
    return replace(out, num_cells=decomp.block * decomp.row_size,
                   grid_shape=(decomp.block, decomp.row_size),
                   device=decomp.device, amg_host=None, decomp=decomp,
                   **moved)


def gather_cellwise(tree, decomp: RowDecomposition):
    """The inverse of :func:`shard_cellwise` on every rank: each tensor
    whose leading axis is this rank's cell count all-gathered back to the
    whole grid (one collective per tensor), others as they are."""
    n = decomp.block * decomp.row_size

    def back(x):
        if isinstance(x, torch.Tensor):
            return decomp.all_gather_rows(x) if x.dim() >= 1 \
                and x.shape[0] == n else x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return replace(x, **{f.name: back(getattr(x, f.name))
                                 for f in dataclasses.fields(x)})
        return x

    return back(tree)


# ----------------------------------------------------------------------
# Banded (unstructured) meshes: contiguous cell ranges with a halo.


def banded_bandwidth(mesh) -> int:
    """Matrix bandwidth of the banded cell order: max |neighbor - cell| over
    live slots.  A contiguous rank range needs this many cells of halo from
    each side."""
    ngh = mesh.ck_neighbor.cpu().numpy().astype(np.int64)
    live = (mesh.ck_mask * (1.0 - mesh.ck_is_boundary)).cpu().numpy() > 0
    rows = np.arange(ngh.shape[0])[:, None]
    return int(np.abs(np.where(live, ngh - rows, 0)).max())


def local_banded_map(mesh, decomp: RowDecomposition, halo: int):
    """This rank's rows of ``ck_neighbor`` made local once on the host:
    indices into the window [range start - halo, range end + halo) of
    (chunk + 2*halo) cells, clipped into it (only dead slots, whose
    coefficients are zero, are clipped)."""
    N = mesh.num_cells
    if (decomp.rows, decomp.row_size) != (N, 1):
        raise ValueError(f"the decomposition covers {decomp.rows} x "
                         f"{decomp.row_size}, the mesh {N} cells")
    if not 0 < halo <= decomp.block:
        raise ValueError(f"halo {halo} outside 1..{decomp.block}")
    ngh = mesh.ck_neighbor.cpu().numpy().astype(np.int64)[decomp.cells]
    loc = np.clip(ngh - (decomp.r0 - halo), 0, decomp.block + 2 * halo - 1)
    return torch.as_tensor(loc.astype(np.int32), device=decomp.device)


def banded_spmv_sharded(es, loc: torch.Tensor, x: torch.Tensor,
                        decomp: RowDecomposition, halo: int) -> torch.Tensor:
    """y = A x on a banded mesh with ``x`` (3, chunk) this rank's range of
    cells and ``es`` its rows of the system (:func:`shard_cellwise`): one
    exchange of ``halo`` cells to each side, then the product of
    ``ellsys.spmv`` on the window through ``banded_dot`` and the local map
    ``loc`` (:func:`local_banded_map`).  Edge ranks get the edge cell
    repeated where there is no neighbour; no live slot reaches it."""
    below, above = decomp.halo_rows(x, halo, dim=1)
    return el.spmv_window(es, x, torch.cat([below, x, above], dim=1), loc)

