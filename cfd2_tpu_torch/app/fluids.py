"""Fluid presets with real material properties (reference ui/app.rs:61-93)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Fluid:
    name: str
    density: float      # kg/m^3
    viscosity: float    # Pa.s (dynamic)

    @staticmethod
    def presets() -> list["Fluid"]:
        return [
            Fluid("Water", 1000.0, 0.001),
            Fluid("Air", 1.225, 1.81e-5),
            Fluid("Alcohol", 789.0, 0.0012),
            Fluid("Kerosene", 820.0, 0.00164),
            Fluid("Mercury", 13546.0, 0.001526),
            Fluid("Custom", 1.0, 0.01),
        ]

    @staticmethod
    def by_name(name: str) -> "Fluid":
        for f in Fluid.presets():
            if f.name.lower() == name.lower():
                return f
        raise KeyError(name)

    def reynolds(self, velocity: float, length: float) -> float:
        """Re = rho * U * L / mu (displayed in the reference panel,
        app.rs:685)."""
        return self.density * velocity * length / self.viscosity
