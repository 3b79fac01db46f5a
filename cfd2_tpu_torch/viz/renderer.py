"""Headless field renderer — the visualization layer (L4) equivalent.

Port of ``cfd2_tpu.viz.renderer``: fields come in as tensors (on any
device) or arrays and go to the host once per render.

The reference renders the solver's live GPU state buffer through fan-
triangulated cell polygons with a rainbow colormap
(src/ui/cfd_renderer.rs:329-411, src/ui/cfd_mesh_shader.wgsl:70-98), plus a
line pipeline for the mesh wireframe and a legend.  Here the same pipeline
runs headless: cells are fan-triangulated once at init, per-cell fields stay
on the device until a snapshot is requested, and frames rasterize to PNG
(matplotlib backend) with the reference's exact blue->green->red colormap and
a colorbar legend.

Two raster paths:

* **grid (O(pixels))** — on structured meshes the field is an (ny, nx) image;
  ``imshow`` renders it in time proportional to the *output* resolution, so
  watching a 1M-cell run live works (the PolyCollection path would build 1M
  polygons per frame).
* **polygons** — generic meshes fan-triangulate exactly like the reference,
  with an optional wireframe overlay (cfd_renderer.rs line pipeline).
"""

from __future__ import annotations

import numpy as np

from ..mesh.structs import Mesh
from ..runtime.host_reads import host_array


def rainbow_colormap(t: np.ndarray) -> np.ndarray:
    """Reference cfd_mesh_shader.wgsl:71-94: blue -> green -> red."""
    t = np.clip(t, 0.0, 1.0)
    s_lo = t * 2.0
    s_hi = (t - 0.5) * 2.0
    lo = t < 0.5
    r = np.where(lo, 0.0, s_hi)
    g = np.where(lo, s_lo, 1.0 - s_hi)
    b = np.where(lo, 1.0 - s_lo, 0.0)
    return np.stack([r, g, b], axis=-1)


def _mpl_cmap():
    from matplotlib.colors import ListedColormap
    t = np.linspace(0.0, 1.0, 256)
    return ListedColormap(rainbow_colormap(t))


class FieldRenderer:
    """Renders per-cell scalar fields; see module docstring.

    ``device_mesh``: pass the solver's DeviceMesh to enable the O(pixels)
    grid path on structured layouts (field arrays are then taken in device
    order).  Field modes mirror the reference control panel: "u"
    (x-velocity), "v", "mag" (|u|), "p", "d_p".
    """

    def __init__(self, mesh: Mesh, device_mesh=None):
        self.mesh = mesh
        self.device_mesh = device_mesh
        self.grid = (tuple(device_mesh.grid_shape)
                     if device_mesh is not None
                     and device_mesh.grid_shape is not None else None)
        if self.grid is not None:
            ny, nx = self.grid
            self.valid_g = host_array(device_mesh.c_valid).reshape(ny, nx) > 0
            self.triangles = self.tri_cell = None
        else:
            # Fan triangulation (cfd_renderer.rs:329-361): per cell,
            # triangles (v0, vk, vk+1); every triangle carries its cell index.
            tri_v = []
            tri_cell = []
            offs = mesh.cell_vertex_offsets
            cv = mesh.cell_vertices
            for c in range(mesh.num_cells):
                s, e = offs[c], offs[c + 1]
                for k in range(s + 1, e - 1):
                    tri_v.append((cv[s], cv[k], cv[k + 1]))
                    tri_cell.append(c)
            self.triangles = np.asarray(tri_v, dtype=np.int64)
            self.tri_cell = np.asarray(tri_cell, dtype=np.int64)
        self.bounds = (mesh.vx.min(), mesh.vx.max(),
                       mesh.vy.min(), mesh.vy.max())

    def field_values(self, state, mode: str = "mag") -> np.ndarray:
        u = host_array(state.u)
        if mode == "u":
            return u[:, 0]
        if mode == "v":
            return u[:, 1]
        if mode == "mag":
            return np.linalg.norm(u, axis=1)
        if mode == "p":
            return host_array(state.p)
        if mode == "d_p":
            return host_array(state.d_p)
        raise ValueError(f"unknown field mode {mode!r}")

    def render(self, state, mode: str = "mag", path: str | None = None,
               value_range: tuple[float, float] | None = None,
               show_mesh: bool = False, dpi: int = 110):
        """Render a snapshot; returns the matplotlib figure (saves PNG when
        ``path`` given).  ``state`` fields are host-order on the polygon
        path, device-order on the grid path (pass the raw SolverState
        arrays there)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        vals = self.field_values(state, mode)
        lo, hi = (value_range if value_range is not None
                  else (float(vals.min()), float(vals.max())))
        rng = hi - lo if abs(hi - lo) > 1e-10 else 1.0

        fig, ax = plt.subplots(
            figsize=((self.bounds[1] - self.bounds[0]) * 3 + 1,
                     (self.bounds[3] - self.bounds[2]) * 3 + 1), dpi=dpi)

        if self.grid is not None:
            ny, nx = self.grid
            t = (vals.reshape(ny, nx) - lo) / rng
            img = rainbow_colormap(t)
            img[~self.valid_g] = 0.15          # masked solids: dark
            ax.imshow(img, origin="lower", interpolation="nearest",
                      extent=self.bounds, aspect="equal")
        else:
            from matplotlib.collections import PolyCollection
            t = (vals - lo) / rng
            colors = rainbow_colormap(t)
            m = self.mesh
            polys = [np.stack([m.vx[m.cell_vertices[s:e]],
                               m.vy[m.cell_vertices[s:e]]], axis=-1)
                     for s, e in zip(m.cell_vertex_offsets[:-1],
                                     m.cell_vertex_offsets[1:])]
            pc = PolyCollection(polys, facecolors=colors,
                                edgecolors="k" if show_mesh else colors,
                                linewidths=0.1 if show_mesh else 0.3,
                                antialiaseds=show_mesh)
            ax.add_collection(pc)
        ax.set_xlim(self.bounds[0], self.bounds[1])
        ax.set_ylim(self.bounds[2], self.bounds[3])
        ax.set_aspect("equal")
        ax.set_title(f"{mode}  [{lo:.3g}, {hi:.3g}]")

        # Legend (reference app legend/colorbar).
        from matplotlib.cm import ScalarMappable
        from matplotlib.colors import Normalize
        sm = ScalarMappable(norm=Normalize(lo, hi), cmap=_mpl_cmap())
        fig.colorbar(sm, ax=ax, fraction=0.025, pad=0.02)

        if path:
            fig.savefig(path, bbox_inches="tight")
            plt.close(fig)
        return fig
