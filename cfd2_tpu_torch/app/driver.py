"""Simulation driver — the headless equivalent of the reference app loop.

Port of ``cfd2_tpu.app.driver``.  The reference spawns a solver thread that
steps, reads fields, applies an adaptive CFL timestep (growth-limited),
publishes state for rendering, and stops on divergence/steady state
(ui/app.rs:852-948).  Here the same loop exists in two flavors:

* :meth:`Simulation.run` — host loop with per-step callbacks (snapshots,
  rendering, adaptive dt), matching the reference semantics step-for-step;
* :meth:`Simulation.run_scanned` — N steps of
  :func:`..models.coupled.multi_step_adaptive`, with the CFL controller on
  the device and the metrics read back once at the end.

The solver runs on CUDA unless ``device="cpu"`` is given; with no GPU and
no ``device`` it raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..mesh import (
    BackwardsStep,
    ChannelWithObstacle,
    RectangularChannel,
    generate_cut_cell_mesh,
    generate_delaunay_mesh,
    generate_voronoi_mesh,
)
from ..models.coupled import CoupledSolver, multi_step_adaptive
from ..runtime import host_reads
from ..runtime.device_mesh import resolve_device
from ..runtime.profiling import ProfileCategory, ProfilingStats
from .fluids import Fluid


@dataclass
class AdaptiveDtController:
    """CFL-targeted adaptive timestep (reference ui/app.rs:878-909):
    dt = clamp(cfl * min_cell / max_vel, 1e-5, 0.1), growth <= 1.2x."""
    target_cfl: float = 0.5
    min_cell_size: float = 0.05
    dt_min: float = 1e-5
    dt_max: float = 0.1
    growth: float = 1.2

    def next_dt(self, dt: float, max_vel: float) -> float:
        if max_vel <= 1e-6:
            return dt
        ideal = self.target_cfl * self.min_cell_size / max_vel
        return float(np.clip(min(ideal, dt * self.growth),
                             self.dt_min, self.dt_max))


_GEOMETRIES = {
    "channel": lambda: (ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2),
                        (3.0, 1.0)),
    "backstep": lambda: (BackwardsStep(3.5, 0.5, 1.0, 0.5), (3.5, 1.0)),
    "rect": lambda: (RectangularChannel(3.0, 1.0), (3.0, 1.0)),
}

_GENERATORS = {
    "cutcell": generate_cut_cell_mesh,
    "delaunay": generate_delaunay_mesh,
    "voronoi": generate_voronoi_mesh,
}


@dataclass
class Simulation:
    """End-to-end case setup + run loop (the reference's init_solver + solver
    thread, ui/app.rs:301-393,852-948).  ``device``: where the solver runs
    (None: CUDA, raising without a GPU)."""
    geometry: str = "channel"
    mesh_type: str = "cutcell"
    cell_size: float = 0.02
    # > cell_size enables local quadtree refinement (cutcell only): fine
    # cells near boundaries growing to max_cell_size in the bulk.
    max_cell_size: float = 0.0
    fluid: Fluid = field(default_factory=lambda: Fluid.by_name("Custom"))
    inlet_velocity: float = 1.0
    ramp_time: float = 0.1
    scheme: int = 0
    time_scheme: int = 0
    precond: int = 0
    alpha_u: float = 0.7
    alpha_p: float = 1.0
    dt0: float = 1e-3
    adaptive: bool = True
    target_cfl: float = 0.5
    device: str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)   # raise before meshing
        self._build()

    def rebuild(self, geometry: str | None = None,
                mesh_type: str | None = None,
                cell_size: float | None = None,
                max_cell_size: float | None = None):
        """Rebuild the mesh and solver from (possibly new) panel-selected
        geometry / mesh type / cell sizes — the reference's Init/Reset
        contract (ui/app.rs:301-393 re-runs build_mesh at :395-482 from the
        panel state).  Fluid, schemes, inlet, relaxation settings and the
        device carry over; fields restart from the inlet-column impulse."""
        if geometry is not None:
            self.geometry = geometry
        if mesh_type is not None:
            self.mesh_type = mesh_type
        if cell_size is not None:
            self.cell_size = cell_size
        if max_cell_size is not None:
            self.max_cell_size = max_cell_size
        if hasattr(self, "_force_mask"):      # stale face mask of the old mesh
            del self._force_mask
        self._build()

    def _build(self):
        geo, domain = _GEOMETRIES[self.geometry]()
        self.geo = geo
        self.domain = domain
        gen = _GENERATORS[self.mesh_type]
        max_cell = max(self.max_cell_size, self.cell_size)
        self.mesh = gen(geo, self.cell_size, max_cell, 1.2, domain)
        if self.mesh_type != "voronoi":
            self.mesh.smooth(geo, 0.3, 50)

        self.solver = CoupledSolver(self.mesh, device=self.device)
        s = self.solver
        s.set_dt(self.dt0)
        s.set_density(self.fluid.density)
        s.set_viscosity(self.fluid.viscosity)
        s.set_alpha_u(self.alpha_u)
        s.set_alpha_p(self.alpha_p)
        s.set_inlet_velocity(self.inlet_velocity)
        s.set_ramp_time(self.ramp_time)
        s.set_scheme(self.scheme)
        s.set_time_scheme(self.time_scheme)
        s.set_precond_type(self.precond)
        # Initial condition: inlet-column impulse like the reference tests.
        u0 = np.zeros((self.mesh.num_cells, 2))
        u0[self.mesh.cell_cx < self.cell_size * 2, 0] = self.inlet_velocity
        s.set_u(u0)

        self.controller = AdaptiveDtController(
            target_cfl=self.target_cfl, min_cell_size=self.cell_size)
        self.profiling = ProfilingStats()

    @property
    def reynolds(self) -> float:
        return self.fluid.reynolds(self.inlet_velocity, self.domain[1])

    def force_coefficients(self):
        """(Cd, Cl) on the immersed obstacle, or ``None`` when the geometry
        has no immersed body (backstep/rect: the obstacle face mask is
        empty).  One host read for the pair; see utils/forces.py."""
        from ..utils.forces import force_coefficients, obstacle_face_mask

        if not hasattr(self, "_force_mask"):
            # Built on the host once per mesh, kept on the solver's device
            # (None: no immersed body).
            mask = obstacle_face_mask(self.solver.mesh)
            self._force_mask = (torch.as_tensor(mask,
                                                device=self.solver.device)
                                if mask.any() else None)
            self._d_ref = 2.0 * getattr(self.geo, "obstacle_radius", 0.0)
        if self._force_mask is None or self._d_ref <= 0:
            return None
        cd, cl = force_coefficients(self.solver.mesh, self.solver.state,
                                    self.solver.params, self._force_mask,
                                    u_ref=max(abs(self.inlet_velocity), 1e-9),
                                    d_ref=self._d_ref)
        cd, cl = host_reads.read(torch.stack([cd, cl])).tolist()
        return cd, cl

    def run(self, num_steps: int, snapshot_every: int = 0,
            on_snapshot=None, verbose: bool = False,
            show_forces: bool = False, log_every: int = 10):
        """Host loop with adaptive dt and optional snapshot callback.
        ``verbose`` prints every ``log_every``-th step; with profiling
        enabled each step also ends in a device synchronisation, so that
        its "step" location and the printed wall hold the step's device
        work, and the line adds the step's FGMRES iterations, wall and host
        reads."""
        from ..runtime.async_reader import AsyncFieldReader

        s = self.solver
        prof = self.profiling
        # Adaptive-dt readback: a device-side max-|u| reduction read through
        # the double-buffered async reader — the value used may be one step
        # stale (on the CPU it is always fresh), the reference's async
        # convergence-read semantics (async_buffer.rs:11-248).  4 B/step
        # instead of a blocking full-field get_u.
        mv_reader = AsyncFieldReader(depth=2)
        with prof.session():
            for i in range(num_steps):
                if self.adaptive:
                    with prof.scope("max_vel(adaptive_dt,async)",
                                    ProfileCategory.DEVICE_READ, 4):
                        mv_reader.start_read(s.max_velocity_device())
                        mv_reader.poll()
                        mv = mv_reader.get_last_value()
                        if mv is None:
                            mv = mv_reader.flush()
                        max_vel = float(mv)
                    s.set_dt(self.controller.next_dt(float(s.params.dt),
                                                     max_vel))
                reads0 = host_reads.COUNT["reads"]
                t0 = time.perf_counter()
                with prof.scope("step", ProfileCategory.DEVICE_DISPATCH):
                    s.step()
                    if prof.enabled and s.device.type == "cuda":
                        torch.cuda.synchronize(s.device)
                wall = time.perf_counter() - t0
                reads = host_reads.COUNT["reads"] - reads0
                prof.increment_iteration()
                if verbose and i % log_every == 0:
                    forces = self.force_coefficients() if show_forces else None
                    extra = (f" Cd={forces[0]:.3f} Cl={forces[1]:+.3f}"
                             if forces else "")
                    if prof.enabled:
                        extra += (f" fgmres={int(s.state.linear_iters_total)}"
                                  f" wall={wall:.4f}s host_reads={reads}")
                    print(f"step {i}: t={float(s.state.time):.4f} "
                          f"dt={float(s.params.dt):.2e} "
                          f"outer={int(s.state.outer_iters)}{extra}",
                          flush=True)
                if snapshot_every and on_snapshot and i % snapshot_every == 0:
                    on_snapshot(i, s)
                if s.should_stop:
                    if verbose:
                        print(f"solver stopped at step {i} "
                              f"(degenerate={s.degenerate_count}, "
                              f"steady={s.steady_state_count})")
                    break
        return s

    def run_scanned(self, num_steps: int):
        """N steps of :func:`multi_step_adaptive` (CFL controller on the
        device); returns the per-step metrics as numpy arrays."""
        s = self.solver
        state, params, metrics = multi_step_adaptive(
            s.mesh, s.state, s.params, s.config, num_steps,
            target_cfl=self.target_cfl, min_cell_size=self.cell_size,
            amg=s._get_amg())
        s.state = state
        s.params = params
        return {k: host_reads.read(v) for k, v in metrics.items()}
