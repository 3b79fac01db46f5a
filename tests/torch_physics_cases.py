"""The lid-driven cavity of tests/test_physics.py and its check against
Ghia et al. (1982), for either package's solver: the set-up, the
centreline error and the table.  It imports numpy only, so that
``chip_smoke.py`` (no JAX) and ``tests/test_torch_physics.py`` share it."""

import numpy as np

# Ghia, Ghia & Shin (1982) Table I: u through the vertical centreline
# x = 0.5 of the unit lid-driven cavity at Re = 100.
GHIA_Y = np.array([0.0547, 0.1016, 0.1719, 0.2813, 0.4531, 0.5000,
                   0.6172, 0.7344, 0.8516, 0.9531, 0.9766])
GHIA_U = np.array([-0.03717, -0.06434, -0.10150, -0.15662, -0.21090,
                   -0.20581, -0.13641, 0.00332, 0.23151, 0.68717, 0.84123])
# The JAX test's bound on the centreline error, its grid and its steps.
GHIA_BOUND, CAVITY_N, CAVITY_STEPS = 0.06, 32, 100


def cavity(solver_cls, rect, cutcell, retag, precond=None, **kw):
    """The 32 x 32 lid-driven cavity of test_lid_driven_cavity_ghia_re100
    (Re 100, dt 0.1); ``precond``: another precond_type than the
    default."""
    h = 1.0 / CAVITY_N
    mesh = cutcell(rect(length=1.0, height=1.0), h, h, 1.2, (1.0, 1.0))
    retag(mesh, (1.0, 1.0))
    s = solver_cls(mesh, **kw)
    s.set_viscosity(0.01)
    s.set_density(1.0)
    s.set_inlet_velocity(1.0)
    s.set_ramp_time(0.0)
    s.set_dt(0.1)
    if precond is not None:
        s.set_precond_type(precond)
    return mesh, s


def centreline_error(mesh, u, h=1.0 / CAVITY_N):
    """Max |u - Ghia| on the centreline x = 0.5 (the two straddling cell
    columns averaged per row), and u interpolated at Ghia's points."""
    col = np.abs(mesh.cell_cx - 0.5) < 0.75 * h
    yr = np.round(mesh.cell_cy[col] / h - 0.5).astype(int)
    rows = np.unique(yr)
    y = np.array([mesh.cell_cy[col][yr == j].mean() for j in rows])
    ux = np.array([u[col, 0][yr == j].mean() for j in rows])
    ui = np.interp(GHIA_Y, y, ux)
    return float(np.abs(ui - GHIA_U).max()), ui
