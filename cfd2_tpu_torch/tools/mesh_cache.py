"""Generate-and-cache host meshes (``.bench_cache/mesh_*.npz``).

Unstructured generation at ~1M cells is minutes of host work, so a mesh is
built once and reloaded from npz.  The file names and arrays are those of the
JAX package's ``tools/mesh_cache.py``: a mesh cached by either package loads
in the other, and both step the very same mesh.  Usage:

    python -m cfd2_tpu_torch.tools.mesh_cache delaunay 0.0019
    python -m cfd2_tpu_torch.tools.mesh_cache voronoi 0.00143
    python -m cfd2_tpu_torch.tools.mesh_cache cutcell 0.0025 0.005
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import fields
from pathlib import Path

import numpy as np

from ..mesh import (ChannelWithObstacle, generate_cut_cell_mesh,
                    generate_delaunay_mesh, generate_voronoi_mesh)
from ..mesh.structs import Mesh

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / ".bench_cache"

GENERATORS = {"cutcell": generate_cut_cell_mesh,
              "delaunay": generate_delaunay_mesh,
              "voronoi": generate_voronoi_mesh}


def mesh_path(mesh_type: str, size: float, geo: str = "channel",
              max_cell: float = 0.0) -> str:
    tag = f"{size}" if not max_cell else f"{size}-{max_cell}"
    return os.path.join(CACHE, f"mesh_{geo}_{mesh_type}_{tag}.npz")


def save_mesh(mesh: Mesh, path: str):
    """Every field of ``mesh`` that is not None, as one compressed npz."""
    arrs = {f.name: np.asarray(getattr(mesh, f.name)) for f in fields(Mesh)
            if getattr(mesh, f.name) is not None}
    np.savez_compressed(path, **arrs)


def load_mesh(path: str) -> Mesh:
    with np.load(path) as d:
        return Mesh(**{k: d[k] for k in d.files})


def channel() -> ChannelWithObstacle:
    """The bench geometry: the 3x1 channel with the r = 0.2 obstacle at
    (1.0, 0.5)."""
    return ChannelWithObstacle(length=3.0, height=1.0,
                               obstacle_center=(1.0, 0.5),
                               obstacle_radius=0.2)


def get_mesh(mesh_type: str, size: float, geo: str = "channel",
             max_cell: float = 0.0) -> Mesh:
    """Load from the cache, or generate and cache.  ``geo``: ``channel``
    only (the bench configuration).  ``max_cell`` > ``size`` gives a
    locally refined mesh."""
    if geo != "channel":
        raise ValueError(f"unknown geometry {geo!r}")
    os.makedirs(CACHE, exist_ok=True)
    path = mesh_path(mesh_type, size, geo, max_cell)
    if os.path.exists(path):
        t0 = time.time()
        m = load_mesh(path)
        print(f"# mesh cache hit {path}: {m.num_cells} cells "
              f"({time.time() - t0:.0f}s load)", flush=True)
        return m
    t0 = time.time()
    mesh = GENERATORS[mesh_type](channel(), size, max(max_cell, size), 1.2,
                                 (3.0, 1.0))
    print(f"# generated {mesh_type} {size}: {mesh.num_cells} cells "
          f"({time.time() - t0:.0f}s)", flush=True)
    # Written under a temporary name and renamed, so a reader never sees
    # a half-written cache.
    tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
    save_mesh(mesh, tmp)
    os.replace(tmp, path)
    return mesh


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mt, sz = argv[0], float(argv[1])
    mx = float(argv[2]) if len(argv) > 2 else 0.0
    m = get_mesh(mt, sz, max_cell=mx)
    print(f"# done: {m.num_cells} cells, {m.num_faces} faces", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
