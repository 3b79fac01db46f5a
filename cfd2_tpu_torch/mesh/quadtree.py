"""Vectorized quadtree refinement over the whole domain at once.

The reference refines one `QuadNode` tree per coarse tile with recursion
(src/solver/mesh/quadtree.rs:4-103).  Here the entire forest is flattened into
NumPy arrays of leaf bounds and refined breadth-first: each pass evaluates the
SDF at every candidate leaf's corners in one vectorized call and splits all
leaves that need it simultaneously.  Same refinement criteria:

  * split if the SDF changes sign across the cell's corners (boundary inside),
  * growth-rate limit: size must not exceed min_size + (rate-1) * distance.
"""

from __future__ import annotations

import numpy as np


def refine_leaves(geo, min_size: float, max_cell_size: float,
                  growth_rate: float, domain_size) -> tuple[np.ndarray, np.ndarray]:
    """Return (mins, maxs) float64 arrays of shape (L, 2): the quadtree leaves.

    Starts from a uniform base grid of `max_cell_size` tiles clipped to the
    domain (reference cut_cell.rs:48-58) and refines until every leaf either
    reaches ``min_size`` or satisfies both criteria.
    """
    dx, dy = float(domain_size[0]), float(domain_size[1])
    nx = int(np.ceil(dx / max_cell_size))
    ny = int(np.ceil(dy / max_cell_size))
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    x0 = (i * max_cell_size).ravel()
    y0 = (j * max_cell_size).ravel()
    x1 = np.minimum(x0 + max_cell_size, dx)
    y1 = np.minimum(y0 + max_cell_size, dy)
    mins = np.stack([x0, y0], axis=-1)
    maxs = np.stack([x1, y1], axis=-1)
    # Logical (unclipped power-of-2) tile size: splits MUST bisect the
    # logical box, not the domain-clipped one, or the clipped edge tiles'
    # children land off the level grid (breaking quadtree provenance and
    # hanging-node pairing whenever the domain extent is not an integer
    # multiple of the cell size).
    usz = np.full(len(mins), max_cell_size)

    done_mins = []
    done_maxs = []

    for _level in range(64):
        if len(mins) == 0:
            break
        size = usz
        refinable = size > min_size * 1.001

        cx = np.stack([mins[:, 0], maxs[:, 0], maxs[:, 0], mins[:, 0]], axis=-1)
        cy = np.stack([mins[:, 1], mins[:, 1], maxs[:, 1], maxs[:, 1]], axis=-1)
        d = geo.sdf(cx, cy)  # (L, 4)

        has_inside = (d < 0.0).any(axis=1)
        has_outside = (d >= 0.0).any(axis=1)
        crossing = has_inside & has_outside

        slope = max(growth_rate - 1.0, 0.0)
        dist = np.abs(d).min(axis=1)
        too_big = size > min_size + slope * dist

        split = refinable & (crossing | too_big)

        done_mins.append(mins[~split])
        done_maxs.append(maxs[~split])

        if not split.any():
            break

        smin = mins[split]
        su = usz[split]
        half = 0.5 * su
        ctr = smin + half[:, None]            # logical center
        # 4 children per split leaf: logical quadrants clipped to the
        # domain; fully-outside children are dropped.
        c_min = np.concatenate([
            smin,
            np.stack([ctr[:, 0], smin[:, 1]], axis=-1),
            np.stack([smin[:, 0], ctr[:, 1]], axis=-1),
            ctr,
        ])
        c_half = np.concatenate([half] * 4)
        c_max = np.minimum(c_min + c_half[:, None],
                           np.asarray([dx, dy])[None, :])
        inside = (c_max > c_min + 1e-12 * c_half[:, None]).all(axis=1)
        mins, maxs, usz = c_min[inside], c_max[inside], c_half[inside]

    return np.concatenate(done_mins), np.concatenate(done_maxs)
