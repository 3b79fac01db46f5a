"""Host-side mesh pipeline (NumPy float64): SDF geometry and the cut-cell,
Delaunay and Voronoi generators.  The solver consumes the encoded device tensors from
:mod:`cfd2_tpu_torch.runtime.device_mesh`."""

from .geometry import (
    BackwardsStep,
    ChannelWithObstacle,
    CircleObstacle,
    Geometry,
    RectangularChannel,
)
from .structs import (
    BOUNDARY_INLET,
    BOUNDARY_NONE,
    BOUNDARY_OUTLET,
    BOUNDARY_WALL,
    Mesh,
)
from .cut_cell import generate_cut_cell_mesh
from .utils import retag_lid_cavity
from .delaunay import generate_delaunay_mesh, triangulate
from .voronoi import generate_voronoi_mesh

__all__ = [
    "Geometry", "ChannelWithObstacle", "BackwardsStep", "RectangularChannel",
    "CircleObstacle", "Mesh", "generate_cut_cell_mesh",
    "generate_delaunay_mesh", "generate_voronoi_mesh", "triangulate",
    "BOUNDARY_NONE", "BOUNDARY_INLET", "BOUNDARY_OUTLET", "BOUNDARY_WALL",
    "retag_lid_cavity",
]
