"""Solver state and device mesh encoding."""

from .device_mesh import DeviceMesh, encode_mesh
from .state import SolverConfig, SolverParams, SolverState, initial_state

__all__ = [
    "DeviceMesh", "encode_mesh",
    "SolverConfig", "SolverParams", "SolverState", "initial_state",
]
