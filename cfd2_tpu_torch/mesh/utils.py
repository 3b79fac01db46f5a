"""Small geometry helpers (reference: src/solver/mesh/utils.rs:4-29)."""

from __future__ import annotations

import numpy as np


def retag_lid_cavity(mesh, domain_size, lid_side: str = "top",
                     pressure_ref: bool = True, tol: float = 1e-6):
    """Retag an open-channel mesh's boundary faces as a closed lid-driven
    cavity, in place.

    The reference meshers (and ours — cut_cell.rs:457-463) hard-code the
    channel classification inlet@x=0 / outlet@x=W / wall elsewhere.  A
    closed cavity reuses the existing BC machinery with no solver changes:

    * the moving lid becomes an INLET face — on a horizontal face nx = 0,
      so every inlet mass-flux/continuity contribution
      (models/assembly.py:84,99,415) vanishes and only the Dirichlet
      momentum rows u = (u_bc, 0) remain: exactly a tangentially moving
      wall with speed ``params.inlet_velocity``;
    * every other boundary face becomes a no-slip WALL;
    * a closed box leaves pressure defined only up to a constant (the
      Poisson block is pure-Neumann/singular), so with ``pressure_ref``
      the single boundary face nearest the corner opposite the lid is
      tagged OUTLET, whose p = 0 Dirichlet row (assembly.py:419) anchors
      the pressure level.  The face sits in the quiescent corner; the
      zero-gradient momentum treatment there perturbs one cell.

    ``lid_side`` is "top" or "bottom": the inlet Dirichlet rows impose
    u = (u_bc, 0), which is tangential only on horizontal faces — on a
    vertical face it would be a normal (mass-injecting) velocity, so
    vertical lids are rejected.  Call before
    ``CoupledSolver``/``encode_mesh`` — tags are copied into the device
    slot containers at encode time.
    """
    from .structs import BOUNDARY_INLET, BOUNDARY_OUTLET, BOUNDARY_WALL

    w, h = domain_size
    tol = tol * max(w, h)        # relative to the domain scale (advisor r3)
    bnd = mesh.face_neighbor < 0
    fx, fy = mesh.face_cx, mesh.face_cy
    side_masks = {
        "top": fy > h - tol,
        "bottom": fy < tol,
    }
    if lid_side not in side_masks:
        raise ValueError(f"lid_side must be one of {sorted(side_masks)}")
    lid = bnd & side_masks[lid_side]
    if not lid.any():
        raise ValueError(f"no boundary faces found on the {lid_side} side")

    mesh.face_boundary[bnd] = BOUNDARY_WALL
    mesh.face_boundary[lid] = BOUNDARY_INLET

    if pressure_ref:
        # Corner opposite the lid: far corner in the lid-normal direction,
        # x=0 side by convention.
        corner = {"top": (0.0, 0.0), "bottom": (0.0, h)}[lid_side]
        cand = np.flatnonzero(bnd & ~lid)
        d2 = (fx[cand] - corner[0]) ** 2 + (fy[cand] - corner[1]) ** 2
        mesh.face_boundary[cand[np.argmin(d2)]] = BOUNDARY_OUTLET
    return mesh


def intersect_lines(p1, d1, p2, d2):
    """Intersection of lines p1 + t*t1 and p2 + s*t2 where t1/t2 are the
    tangents perpendicular to the given normals d1/d2.  Returns None for
    (near-)parallel lines.  Mirrors reference utils.rs:18-29, which intersects
    the two boundary tangent lines to reconstruct a sharp corner."""
    t1 = np.array([-d1[1], d1[0]])
    t2 = np.array([-d2[1], d2[0]])
    denom = t1[0] * t2[1] - t1[1] * t2[0]
    if abs(denom) < 1e-12:
        return None
    dx = p2[0] - p1[0]
    dy = p2[1] - p1[1]
    t = (dx * t2[1] - dy * t2[0]) / denom
    return (p1[0] + t1[0] * t, p1[1] + t1[1] * t)
