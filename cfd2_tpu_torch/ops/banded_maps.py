"""Banded index maps and their walk costs (host-side NumPy only).

Own copy of ``build_banded_map``, ``build_banded_map_grouped``,
``build_banded_map2``, ``window_cost`` and ``grouped_cost`` from
``cfd2_tpu/ops/banded_gather.py``.  There they compile an (M, K) index map
into the (lane, sel, bases) planes that the TPU kernel walks, and price the
walk in vreg-gather units.  No kernel of this package reads such a plane: the
CUDA kernels in ``csrc/banded.cu`` take the (M, K) int32 index map itself.

They are kept because they decide *semantics*, not layout:

* ``encode_mesh`` orders the cells of an unstructured mesh by the candidate
  ordering (RCM or a geometric column sweep) with the lowest walk cost
  (``runtime/device_mesh.py:_generic_rank``).  The greedy AMG aggregation
  scans cells in device order, so the hierarchy, and with it the FGMRES
  iteration counts, depend on which candidate wins.  To give the JAX
  package's iterations the port has to pick the same order, so it scores the
  candidates with the same functions.
* whether any map builds at all decides ``DeviceMesh.banded`` (the banded
  solver path against the block-ELL path of the JAX package).

Only the returned window sizes are used; the planes are discarded.
"""

from __future__ import annotations

import numpy as np

LANES = 128


def build_banded_map(idx: np.ndarray, n_src: int, w_max: int = 40):
    """Compile an (M, K) int index map into banded-gather planes.

    Returns ``(lane, sel, base, W)`` — lane/sel (NB, K, 128) int32, base
    (NB,) int32, W static — or None when some destination block's source
    spread exceeds ``w_max`` window rows (no map: the caller leaves the banded path).

    Padded output rows (M -> NB*128) gather an index near the last real
    rows' sources (not 0: the final block's window must not stretch across
    the whole operand); callers slice the output back to M.
    """
    idx = np.asarray(idx, dtype=np.int64)
    M, K = idx.shape
    NB = (M + LANES - 1) // LANES
    Mp = NB * LANES
    if Mp != M:
        fill = idx[M - 1, 0]
        idx = np.concatenate(
            [idx, np.full((Mp - M, K), fill, np.int64)], axis=0)
    n_rows = (n_src + LANES - 1) // LANES

    sb = (idx // LANES).reshape(NB, LANES, K)
    lane = (idx % LANES).reshape(NB, LANES, K)
    lo = sb.min(axis=(1, 2))
    hi = sb.max(axis=(1, 2))
    W = int((hi - lo).max()) + 1
    if W > w_max or n_rows < 1:
        return None
    W = min(W, n_rows)
    base = np.minimum(lo, max(n_rows - W, 0)).astype(np.int32)
    sel = (sb - base[:, None, None]).astype(np.int32)
    assert (sel >= 0).all() and (sel < W).all()
    lane = np.ascontiguousarray(lane.transpose(0, 2, 1)).astype(np.int32)
    sel = np.ascontiguousarray(sel.transpose(0, 2, 1)).astype(np.int32)
    return lane, sel, base, W


def build_banded_map_grouped(idx: np.ndarray, n_src: int, w_max: int = 40,
                             group: int = 2):
    """Compile an (M, K) index map whose rows are SORTED ascending into
    per-slot-group banded planes.

    A window map walks NW*W candidate rows per block, gathering all K slots
    each step; when each row's slots are sorted by source index, slot k
    holds the k-th order statistic, whose per-block span is far narrower
    than the whole band (voronoi at 294k: W=17 single-window vs ~4 per
    sorted slot).  Slots are walked in groups of ``group`` (the TPU kernel cannot
    gather a single-slot (1, LANES) tile); group g walks its
    own static step count wgs[g].

    Returns ``(lane, sel, bases, wgs)`` — lane/sel (NB, K, 128) int32,
    bases (NB, G) int32, wgs a static tuple of per-group walk lengths —
    or None when some group's span exceeds ``w_max``.
    """
    idx = np.asarray(idx, dtype=np.int64)
    M, K = idx.shape
    if K < 2:
        return None
    NB = (M + LANES - 1) // LANES
    Mp = NB * LANES
    if Mp != M:
        fill = idx[M - 1, 0]
        idx = np.concatenate(
            [idx, np.full((Mp - M, K), fill, np.int64)], axis=0)
    n_rows = (n_src + LANES - 1) // LANES

    sb = (idx // LANES).reshape(NB, LANES, K)
    lane = (idx % LANES).reshape(NB, LANES, K).astype(np.int32)

    # Slot groups: pairs; an odd K folds the last slot into the final group.
    bounds = [(k0, min(k0 + group, K)) for k0 in range(0, K, group)]
    if len(bounds) > 1 and bounds[-1][1] - bounds[-1][0] == 1:
        bounds[-2] = (bounds[-2][0], K)
        bounds.pop()
    G = len(bounds)
    bases = np.zeros((NB, G), np.int32)
    wgs = []
    sel = np.zeros_like(sb, dtype=np.int32)
    for g, (k0, k1) in enumerate(bounds):
        sub = sb[:, :, k0:k1]
        lo = sub.min(axis=(1, 2))
        hi = sub.max(axis=(1, 2))
        wg = int((hi - lo).max()) + 1
        if wg > w_max:
            return None
        wg = min(wg, n_rows)
        base = np.minimum(lo, max(n_rows - wg, 0))
        bases[:, g] = base
        sel[:, :, k0:k1] = sub - base[:, None, None]
        wgs.append(wg)
        assert (sel[:, :, k0:k1] >= 0).all() and (sel[:, :, k0:k1] < wg).all()
    lane = np.ascontiguousarray(lane.transpose(0, 2, 1))
    sel = np.ascontiguousarray(sel.transpose(0, 2, 1))
    slot_bounds = tuple(bounds)
    return lane, sel, bases, (tuple(wgs), slot_bounds)


VREG_SUBLANES = 8


def window_cost(W: int, K: int, nw: int = 1) -> int:
    """Walk cost of a (multi-)window map in the JAX package's vreg-gather
    units: its TPU kernel does one masked lane-gather over a (K, LANES) tile
    per step, and a tile costs ceil(K/8) (8, 128) vector registers however
    few slots it covers.  Here the number only ranks cell orderings."""
    return nw * W * -(-K // VREG_SUBLANES)


def grouped_cost(wgs) -> int:
    """Walk cost of a sorted-slot grouped map in vreg-gather units (see
    window_cost): each group's step processes a (gsz, LANES) tile that
    still occupies ceil(gsz/8) full vregs."""
    lens, bounds = wgs
    return sum(w * -(-(k1 - k0) // VREG_SUBLANES)
               for w, (k0, k1) in zip(lens, bounds))


def build_banded_map2(idx: np.ndarray, n_src: int, w_max: int = 16,
                      n_windows: int = 3):
    """Compile an (M, K) index map into multi-window banded-gather planes.

    Per 128-output block, source rows are split at their ``n_windows - 1``
    largest gaps into clusters (a multilevel cell block touches its own
    level's band plus the finer and coarser levels' bands); returns
    (lane, sel, bases (NB, n_windows), W) or None when any cluster's span
    exceeds ``w_max`` rows.
    """
    idx = np.asarray(idx, dtype=np.int64)
    M, K = idx.shape
    NB = (M + LANES - 1) // LANES
    Mp = NB * LANES
    if Mp != M:
        fill = idx[M - 1, 0]
        idx = np.concatenate(
            [idx, np.full((Mp - M, K), fill, np.int64)], axis=0)
    n_rows = (n_src + LANES - 1) // LANES

    sb = (idx // LANES).reshape(NB, LANES, K)
    lane = (idx % LANES).reshape(NB, LANES, K).astype(np.int32)

    NW = n_windows
    bases = np.zeros((NB, NW), np.int32)
    # Per-block cluster boundaries: cluster w covers rows in
    # [edges[b, w], edges[b, w + 1]).
    edges = np.zeros((NB, NW + 1), np.int64)
    W = 1
    for b in range(NB):
        rows = np.unique(sb[b])
        cuts = []
        if len(rows) > 1:
            gaps = np.diff(rows)
            order = np.argsort(gaps)[::-1][:NW - 1]
            cuts = sorted(int(rows[g + 1]) for g in order if gaps[g] > 1)
        bounds = [int(rows[0])] + cuts + [int(rows[-1]) + 1]
        # Assign clusters; unused trailing windows mirror the last cluster.
        for w in range(NW):
            lo = bounds[min(w, len(bounds) - 2)]
            hi_excl = bounds[min(w + 1, len(bounds) - 1)]
            sub = rows[(rows >= lo) & (rows < hi_excl)]
            if len(sub) == 0:
                bases[b, w] = bases[b, max(w - 1, 0)]
                continue
            span = int(sub[-1] - sub[0]) + 1
            if span > w_max:
                return None
            W = max(W, span)
            bases[b, w] = sub[0]
        edges[b, :len(bounds)] = bounds
        edges[b, len(bounds):] = bounds[-1]
    bases = np.minimum(bases, max(n_rows - W, 0)).astype(np.int32)

    sel = np.zeros_like(sb, dtype=np.int32)
    for w in range(NW):
        lo = edges[:, w][:, None, None]
        hi = edges[:, w + 1][:, None, None]
        inw = (sb >= lo) & (sb < hi)
        sel = np.where(inw, sb - bases[:, w][:, None, None] + w * W, sel)
    assert (sel >= 0).all() and (sel < NW * W).all()
    lane = np.ascontiguousarray(lane.transpose(0, 2, 1))
    sel = np.ascontiguousarray(sel.transpose(0, 2, 1))
    return lane, sel, np.ascontiguousarray(bases), W
