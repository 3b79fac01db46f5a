"""cfd2_tpu_torch — the PyTorch/CUDA port of cfd2_tpu.

A second package beside the JAX reference, for one NVIDIA H100: the same
finite-volume coupled (u, v, p) solver with FGMRES and a SIMPLE/Schur
preconditioner whose pressure block is a multigrid: geometric on uniform
cut-cell meshes, aggregation AMG on Delaunay and Voronoi meshes.  The
red-black Gauss-Seidel smoother of the first (``csrc/rbgs.cu``) and every
neighbor access of the second (gather, fused gather-dot, multi-sweep Jacobi;
``csrc/banded.cu``) run as CUDA kernels written for Hopper; everything else
is plain PyTorch.

Module paths and function names follow ``cfd2_tpu`` so each counterpart is
easy to find.  Entry points run on the GPU unless the caller passes
``device="cpu"``.

Quick start::

    from cfd2_tpu_torch import ChannelWithObstacle, generate_cut_cell_mesh, CoupledSolver
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.02, 0.02, 1.2, (3.0, 1.0))
    s = CoupledSolver(mesh)          # device="cuda"
    s.set_dt(0.005)
    s.run(10)

Unstructured meshes take the same solver::

    from cfd2_tpu_torch import generate_delaunay_mesh   # or generate_voronoi_mesh
    mesh = generate_delaunay_mesh(geo, 0.02, 0.02, 1.2, (3.0, 1.0))
    s = CoupledSolver(mesh)
    s.set_precond_type(1)            # aggregation AMG
"""

__version__ = "0.1.0"

from .mesh import (  # noqa: E402
    ChannelWithObstacle,
    Geometry,
    Mesh,
    RectangularChannel,
    generate_cut_cell_mesh,
    generate_delaunay_mesh,
    generate_voronoi_mesh,
)
from .models.coupled import CoupledSolver, step  # noqa: E402
from .runtime.device_mesh import DeviceMesh, encode_mesh  # noqa: E402
from .runtime.state import (  # noqa: E402
    SolverConfig,
    SolverParams,
    SolverState,
    initial_state,
)

__all__ = [
    "Geometry", "ChannelWithObstacle", "RectangularChannel", "Mesh",
    "generate_cut_cell_mesh", "generate_delaunay_mesh",
    "generate_voronoi_mesh", "CoupledSolver", "step",
    "SolverConfig", "SolverParams", "SolverState", "initial_state",
    "DeviceMesh", "encode_mesh",
]
