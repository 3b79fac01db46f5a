"""Finite-volume assembly and the coupled timestep driver."""

from .assembly import assemble_coupled, compute_fluxes, prepare
from .coupled import CoupledSolver, multi_step, multi_step_adaptive, step

__all__ = [
    "prepare", "compute_fluxes", "assemble_coupled",
    "step", "multi_step", "multi_step_adaptive", "CoupledSolver",
]
