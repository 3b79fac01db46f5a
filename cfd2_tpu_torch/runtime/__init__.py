"""Solver state and device mesh encoding."""
