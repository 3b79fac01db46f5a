"""Application layer: fluid presets, simulation driver, headless viewer CLI."""

from .fluids import Fluid
from .driver import Simulation, AdaptiveDtController

__all__ = ["Fluid", "Simulation", "AdaptiveDtController"]
