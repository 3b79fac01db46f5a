"""Aerodynamic force coefficients on immersed bodies (drag, lift, Strouhal).

Port of ``cfd2_tpu.utils.forces``: integrate the pressure and viscous
traction over the obstacle's wall faces to get the force the fluid exerts
on the body, normalized to the standard coefficients

    Cd = F_x / (1/2 rho U_ref^2 D),    Cl = F_y / (1/2 rho U_ref^2 D).

The lift series Cl(t) of a shedding cylinder oscillates at the shedding
frequency f, giving the Strouhal number St = f D / U.

Discretization (first-order, consistent with the solver's own wall
treatment, models/assembly.py):

* pressure traction on the body  =  p_f * n_face  per unit area, where
  ``n_face`` is the face normal pointing out of the owner (fluid) cell —
  i.e. into the body — and p_f is the owner-cell pressure linearly
  extrapolated to the face center with the Green-Gauss gradient;
* viscous traction  =  mu * u_t(P) / d  per unit area: no-slip makes the
  wall-tangential velocity profile go from 0 at the face to u_t(P) at the
  owner center, a distance d = |(x_f - x_P) . n| along the normal.

:func:`body_force` is a masked sum over the faces in plain PyTorch on the
mesh's device (no host read); :func:`obstacle_face_mask` and
:func:`strouhal_number` run on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.structs import BOUNDARY_WALL


def obstacle_face_mask(dm, margin: float | None = None) -> np.ndarray:
    """(F,) float32 mask of wall faces on the *immersed* body: wall-tagged
    faces whose centers sit strictly inside the domain bounding box.

    ``margin``: distance from the bounding box within which wall faces are
    treated as channel (outer) walls; defaults to 1/4 of the median face
    size.  The four face tensors are copied to the host once per call.
    """
    fb, cx, cy, area = (t.cpu().numpy() for t in
                        (dm.f_boundary, dm.f_cx, dm.f_cy, dm.f_area))
    if margin is None:
        margin = 0.25 * float(np.median(area))
    x0, x1 = cx.min(), cx.max()
    y0, y1 = cy.min(), cy.max()
    interior = ((cx - x0 > margin) & (x1 - cx > margin)
                & (cy - y0 > margin) & (y1 - cy > margin))
    return ((fb == BOUNDARY_WALL) & interior).astype(np.float32)


def body_force(dm, state, params, face_mask) -> torch.Tensor:
    """Total (F_x, F_y) the fluid exerts on the body selected by
    ``face_mask`` ((F,) 0/1 weights), as a (2,) tensor on the mesh's
    device."""
    w = torch.as_tensor(face_mask, dtype=torch.float32,
                        device=dm.f_area.device)
    own = dm.f_owner.long()
    nx, ny = dm.f_nx, dm.f_ny
    A = dm.f_area

    # Pressure: owner value extrapolated to the face center.
    dx = dm.f_cx - dm.c_cx[own]
    dy = dm.f_cy - dm.c_cy[own]
    gp = state.grad_p[own]
    p_f = state.p[own] + gp[:, 0] * dx + gp[:, 1] * dy
    fpx = torch.sum(w * p_f * nx * A)
    fpy = torch.sum(w * p_f * ny * A)

    # Viscous: wall shear from the owner's tangential velocity over the
    # wall-normal distance (no-slip).
    u = state.u[own]
    un = u[:, 0] * nx + u[:, 1] * ny
    utx = u[:, 0] - un * nx
    uty = u[:, 1] - un * ny
    d = torch.clamp(torch.abs(dx * nx + dy * ny), min=1e-12)
    fvx = torch.sum(w * params.viscosity * utx / d * A)
    fvy = torch.sum(w * params.viscosity * uty / d * A)

    return torch.stack([fpx + fvx, fpy + fvy])


def force_coefficients(dm, state, params, face_mask,
                       u_ref: float = 1.0, d_ref: float = 0.4):
    """(Cd, Cl) as 0-d tensors for the masked body; ``d_ref`` defaults to
    the builtin channel obstacle's diameter (2 x 0.2)."""
    f = body_force(dm, state, params, face_mask)
    q = 0.5 * params.density * u_ref ** 2 * d_ref
    return f[0] / q, f[1] / q


def strouhal_number(cl_series, dt_series, u_ref: float = 1.0,
                    d_ref: float = 0.4) -> float:
    """St = f D / U from the dominant oscillation frequency of Cl(t).

    Uses the mean interval between successive mean-crossings in the same
    direction (robust to slow drift and to a handful of noisy samples;
    an FFT needs uniform sampling, which adaptive dt breaks).
    Returns 0.0 when fewer than two full periods are present.
    """
    cl = np.asarray(cl_series, dtype=np.float64)
    t = np.concatenate([[0.0], np.cumsum(np.asarray(dt_series, np.float64))])
    t = t[:len(cl)]
    x = cl - cl.mean()
    up = np.where((x[:-1] < 0) & (x[1:] >= 0))[0]
    if len(up) < 3:
        return 0.0
    # Linear interpolation of each crossing time.
    tc = t[up] + (t[up + 1] - t[up]) * (-x[up] / (x[up + 1] - x[up]))
    period = float(np.mean(np.diff(tc)))
    if period <= 0:
        return 0.0
    return d_ref / (u_ref * period)
