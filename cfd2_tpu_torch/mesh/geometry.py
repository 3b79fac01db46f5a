"""Signed-distance-function geometry definitions (host-side, NumPy, float64).

Capability parity with the reference's ``Geometry`` trait and shapes
(reference: src/solver/mesh/geometry.rs:5-260).  The reference exposes a scalar
``sdf`` plus a 4-wide SIMD ``sdf_batch``; here every SDF is natively vectorized
over arrays of points, which is the idiomatic NumPy equivalent (and is what the
cut-cell generator calls with whole batches of corner points at once).
"""

from __future__ import annotations

import numpy as np


class Geometry:
    """SDF-defined 2D domain.  Negative inside the fluid, positive outside.

    Subclasses implement :meth:`sdf` (vectorized over the last axis = points)
    and :meth:`get_boundary_points`.
    """

    def sdf(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def is_inside(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        return self.sdf(np.asarray(x), np.asarray(y)) < 0.0

    def get_boundary_points(self, spacing: float) -> np.ndarray:
        """Return (M, 2) array of points seeded on the domain boundary."""
        raise NotImplementedError

    # -- helpers shared by meshers ------------------------------------------

    def normal(self, x: np.ndarray, y: np.ndarray, eps: float = 1e-6) -> np.ndarray:
        """Outward SDF normal by central differences (reference mesh/utils.rs:4-16)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        dx = self.sdf(x + eps, y) - self.sdf(x - eps, y)
        dy = self.sdf(x, y + eps) - self.sdf(x, y - eps)
        n = np.stack([dx, dy], axis=-1)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(norm, 1e-300)


def _box_sdf(px, py, cx, cy, hx, hy):
    """SDF of an axis-aligned box centered at (cx, cy) with half-extents (hx, hy)."""
    dx = np.abs(px - cx) - hx
    dy = np.abs(py - cy) - hy
    outside = np.hypot(np.maximum(dx, 0.0), np.maximum(dy, 0.0))
    inside = np.minimum(np.maximum(dx, dy), 0.0)
    return inside + outside


def _segment_points(p1, p2, spacing):
    """Points along a segment [p1, p2) with approximately the given spacing."""
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    dist = np.linalg.norm(p2 - p1)
    n = max(int(np.ceil(dist / spacing)), 1)
    t = np.arange(n, dtype=np.float64)[:, None] / n
    return p1[None, :] + (p2 - p1)[None, :] * t


class ChannelWithObstacle(Geometry):
    """Rectangular channel with a circular obstacle (geometry.rs:24-103)."""

    def __init__(self, length: float, height: float,
                 obstacle_center: tuple[float, float], obstacle_radius: float):
        self.length = float(length)
        self.height = float(height)
        self.obstacle_center = (float(obstacle_center[0]), float(obstacle_center[1]))
        self.obstacle_radius = float(obstacle_radius)

    def sdf(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        box = _box_sdf(x, y, self.length / 2.0, self.height / 2.0,
                       self.length / 2.0, self.height / 2.0)
        circ = np.hypot(x - self.obstacle_center[0], y - self.obstacle_center[1]) \
            - self.obstacle_radius
        # Fluid: inside box AND outside circle.
        return np.maximum(box, -circ)

    def get_boundary_points(self, spacing):
        pts = []
        nx = int(np.ceil(self.length / spacing))
        ny = int(np.ceil(self.height / spacing))
        xs = np.minimum(np.arange(nx + 1) * spacing, self.length)
        ys = np.minimum(np.arange(ny + 1) * spacing, self.height)
        pts.append(np.stack([xs, np.zeros_like(xs)], axis=-1))
        pts.append(np.stack([xs, np.full_like(xs, self.height)], axis=-1))
        pts.append(np.stack([np.zeros_like(ys), ys], axis=-1))
        pts.append(np.stack([np.full_like(ys, self.length), ys], axis=-1))
        circumference = 2.0 * np.pi * self.obstacle_radius
        n_obs = max(int(np.ceil(circumference / spacing)), 1)
        theta = 2.0 * np.pi * np.arange(n_obs) / n_obs
        pts.append(np.stack([
            self.obstacle_center[0] + self.obstacle_radius * np.cos(theta),
            self.obstacle_center[1] + self.obstacle_radius * np.sin(theta),
        ], axis=-1))
        return np.concatenate(pts, axis=0)


class BackwardsStep(Geometry):
    """Backward-facing step channel (geometry.rs:105-211)."""

    def __init__(self, length: float, height_inlet: float, height_outlet: float,
                 step_x: float):
        self.length = float(length)
        self.height_inlet = float(height_inlet)
        self.height_outlet = float(height_outlet)
        self.step_x = float(step_x)

    def sdf(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        outer = _box_sdf(x, y, self.length / 2.0, self.height_outlet / 2.0,
                         self.length / 2.0, self.height_outlet / 2.0)
        step_h = self.height_outlet - self.height_inlet
        step_w = self.step_x
        block = _box_sdf(x, y, step_w / 2.0, step_h / 2.0, step_w / 2.0, step_h / 2.0)
        return np.maximum(outer, -block)

    def get_boundary_points(self, spacing):
        step_h = self.height_outlet - self.height_inlet
        corners = [
            (0.0, self.height_outlet), (self.length, self.height_outlet),
            (self.length, 0.0), (self.step_x, 0.0),
            (self.step_x, step_h), (0.0, step_h),
        ]
        segs = [
            _segment_points(corners[i], corners[(i + 1) % 6], spacing)
            for i in range(6)
        ]
        return np.concatenate(segs, axis=0)


class RectangularChannel(Geometry):
    """Plain rectangular channel (geometry.rs:213-260)."""

    def __init__(self, length: float, height: float):
        self.length = float(length)
        self.height = float(height)

    def sdf(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        return _box_sdf(x, y, self.length / 2.0, self.height / 2.0,
                        self.length / 2.0, self.height / 2.0)

    def get_boundary_points(self, spacing):
        pts = []
        nx = int(np.ceil(self.length / spacing))
        ny = int(np.ceil(self.height / spacing))
        xs = np.minimum(np.arange(nx + 1) * spacing, self.length)
        ys = np.minimum(np.arange(ny + 1) * spacing, self.height)
        pts.append(np.stack([xs, np.zeros_like(xs)], axis=-1))
        pts.append(np.stack([xs, np.full_like(xs, self.height)], axis=-1))
        pts.append(np.stack([np.zeros_like(ys), ys], axis=-1))
        pts.append(np.stack([np.full_like(ys, self.length), ys], axis=-1))
        return np.concatenate(pts, axis=0)


class CircleObstacle(Geometry):
    """Circular hole in an unbounded plane — test-only geometry
    (reference mesh/tests.rs:5-62 uses an equivalent shape)."""

    def __init__(self, center: tuple[float, float], radius: float):
        self.center = (float(center[0]), float(center[1]))
        self.radius = float(radius)

    def sdf(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        # Fluid outside the circle.
        return self.radius - np.hypot(x - self.center[0], y - self.center[1])

    def get_boundary_points(self, spacing):
        circumference = 2.0 * np.pi * self.radius
        n = max(int(np.ceil(circumference / spacing)), 1)
        theta = 2.0 * np.pi * np.arange(n) / n
        return np.stack([
            self.center[0] + self.radius * np.cos(theta),
            self.center[1] + self.radius * np.sin(theta),
        ], axis=-1)
