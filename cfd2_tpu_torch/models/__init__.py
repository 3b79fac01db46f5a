"""Finite-volume assembly and the coupled timestep driver."""
