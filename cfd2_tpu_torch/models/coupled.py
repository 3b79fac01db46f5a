"""Coupled (u,v,p) timestep driver.

Port of ``cfd2_tpu.models.coupled`` on the structured stencil path:

* :func:`step` = prepare -> [assemble -> FGMRES -> relaxed update] outer
  correctors as a Python loop, with the same convergence, stagnation and
  pressure-plateau exits as the JAX package's ``lax.while_loop``.  Each
  outer corrector reads its two max-diff scalars to the host once (one
  synchronisation, counted by :mod:`..runtime.host_reads`);
* :func:`check_evolution`, the steady-state/degeneracy classifier, runs on
  the device from state carried across steps;
* :class:`CoupledSolver` is the host-side façade with the reference's
  headless API (GpuSolver::new -> set_* -> step -> get_u/get_p).

Only the structured stencil path is ported: uniform cut-cell meshes with the
Schur preconditioner, whose pressure block is the structured multigrid
(``precond_type=1``) or the Chebyshev relaxation (``precond_type=0``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..ops import stencil_system as st
from ..ops.fgmres import fgmres_solve
from ..runtime.device_mesh import DeviceMesh, encode_mesh, resolve_device
from ..runtime.host_reads import read
from ..runtime.state import (
    PRECOND_AMG,
    PRECOND_BLOCK_JACOBI,
    SCHEME_UPWIND,
    SolverConfig,
    SolverParams,
    SolverState,
    initial_state,
)
from .assembly import assemble_pressure, assemble_stencil, prepare

_F32_MAX = float(np.finfo(np.float32).max)

# Options of SolverConfig whose code paths are not ported yet, with the
# value that leaves them off.
_UNPORTED = {
    "extrapolate_guess": False, "anderson_depth": 0,
    "fgmres_basis_bf16": False, "precond_bf16": False,
    "fgmres_f64_norms": False, "presolve_pressure_iters": 0,
    "fgmres_incycle_window": 0, "fgmres_mixed_phase": False,
    "adaptive_linear_tol": False, "fgmres_recycle": 0, "precond_mom_adi": 0,
}


def _check_ported(mesh: DeviceMesh, config: SolverConfig) -> None:
    on = [k for k, off in _UNPORTED.items() if getattr(config, k) != off]
    if on:
        raise NotImplementedError(
            f"SolverConfig options not ported yet: {', '.join(on)}")
    if not mesh.structured or config.precond_type == PRECOND_BLOCK_JACOBI:
        raise NotImplementedError(
            "only the structured stencil path with the Schur preconditioner "
            "is ported (no block-ELL / block-Jacobi path)")


def _assemble_and_solve(mesh, state, params, config, amg, n_sweeps,
                        frozen_amg=None):
    """Assemble the coupled system in stencil form and run one
    Schur-preconditioned FGMRES solve on (3, ny, nx) component planes."""
    ss = assemble_stencil(mesh, state, params, config)
    ps = (st.make_pressure_solve2(
              amg, ss, n_cycles=config.pressure_vcycles(mesh.num_cells),
              frozen=frozen_amg)
          if config.precond_type == PRECOND_AMG else None)
    mom_sweeps = config.mom_sweeps(mesh.num_cells)
    x0 = torch.cat([state.u, state.p[:, None]], dim=1)
    result = fgmres_solve(
        lambda x: st.spmv_planar(ss, x),
        lambda r: st.schur_precond_planar(ss, r, config.precond_omega,
                                          n_sweeps, pressure_solve=ps,
                                          mom_sweeps=mom_sweeps),
        st.to_planar(ss, ss.rhs), st.to_planar(ss, x0),
        restart=config.fgmres_restart,
        max_restarts=config.fgmres_max_restarts,
        tol=config.fgmres_tol, abstol=config.fgmres_abstol,
        stagnation_tol=config.fgmres_stagnation_tol,
        stagnation_limit=config.fgmres_stagnation_limit)
    return replace(result, x=st.from_planar(ss, result.x))


def _plateau_update(du_ok, dp_ref, diff_u, diff_p, config: SolverConfig):
    """Pressure-plateau patience bookkeeping
    (SolverConfig.outer_pressure_patience), on host scalars.

    Counts consecutive outers with du below 2x tol; the exit is gated on
    the pressure residual stalling: dp must not have halved across the
    patience window (``dp_ref`` = dp at window start).  A window that
    expires while pressure still improves restarts.
    Returns (du_ok, dp_ref, plateau)."""
    if du_ok == 0:
        dp_ref = diff_p
    du_ok = du_ok + 1 if diff_u < 2.0 * config.outer_tol_u else 0
    window_full = du_ok >= config.outer_pressure_patience
    p_stalled = diff_p > 0.5 * dp_ref
    plateau = config.outer_pressure_patience > 0 and window_full and p_stalled
    if window_full and not p_stalled:
        du_ok = 0
    return du_ok, dp_ref, plateau


def check_evolution(state: SolverState, config: SolverConfig,
                    valid: torch.Tensor | None = None) -> SolverState:
    """Steady-state / degeneracy classifier (reference
    coupled_solver.rs:501-580): current velocity variance plus the
    RMSE-vs-previous-step evolution test and consecutive-hit counters.
    ``valid`` masks out structured-layout solid cells."""
    u = state.u
    w = torch.ones((u.shape[0],), dtype=u.dtype, device=u.device) \
        if valid is None else valid
    n = torch.sum(w)
    mean = torch.sum(u * w[:, None], dim=0) / n
    var = torch.sum(u * u * w[:, None], dim=0) / n - mean * mean
    var = torch.clamp(var, min=0.0)

    rmse = torch.sqrt(torch.sum(torch.sum((u - state.prev_u) ** 2, dim=1)
                                * w) / n)

    evolving = rmse >= config.evolution_threshold
    uniform = (var[0] < config.variance_threshold) \
        & (var[1] < config.variance_threshold)

    zero = torch.zeros_like(state.degenerate_count)
    degen = torch.where(~evolving & uniform, state.degenerate_count + 1, zero)
    steady = torch.where(~evolving & ~uniform, state.steady_count + 1, zero)
    diverged = torch.isnan(state.outer_residual_u) \
        | torch.isnan(state.outer_residual_p)
    stop = state.should_stop | (degen > config.stop_count) \
        | (steady > config.stop_count) | diverged
    return replace(state, prev_u=u, degenerate_count=degen,
                   steady_count=steady, should_stop=stop)


def step(mesh: DeviceMesh, state: SolverState, params: SolverParams,
         config: SolverConfig, amg=None) -> SolverState:
    """Advance one timestep (reference GpuSolver::step -> step_coupled).

    ``amg``: the StructuredAmgHierarchy used when
    ``config.precond_type == PRECOND_AMG``."""
    _check_ported(mesh, config)
    if config.precond_type == PRECOND_AMG and amg is None:
        raise NotImplementedError(
            "precond_type=1 needs the structured multigrid, which this mesh "
            "is too small for; the block-ELL fallback is not ported")
    n_sweeps = config.pressure_sweeps(mesh.num_cells)
    dev = state.u.device

    # History rotation (coupled_solver.rs:43-71), initial prepare (:74-107).
    state = replace(state, u_old_old=state.u_old, u_old=state.u)
    state = prepare(mesh, state, params, config)

    # Per-step frozen coarse multigrid operators from a pressure-only
    # assembly at step entry (SolverConfig.amg_freeze_coarse).
    frozen_amg = None
    if (config.amg_freeze_coarse and amg is not None
            and config.precond_type == PRECOND_AMG):
        P_diag, P_off = assemble_pressure(mesh, state, params)
        ny, nx = mesh.grid_shape
        frozen_amg = st.coarse_level_values2_planes(
            amg, P_diag.reshape(ny, nx),
            P_off[:, :4].T.reshape(4, ny, nx).contiguous())

    max_iters = max(config.n_outer_correctors, 10)
    prev_du = prev_dp = dp_ref = _F32_MAX
    du_ok = 0
    li = lt = 0
    lr = 0.0
    for it in range(max_iters):
        # Re-prepare on later iterations / higher-order schemes
        # (coupled_solver.rs:166-189).
        if config.scheme != SCHEME_UPWIND or it > 0:
            state = prepare(mesh, state, params, config)
        result = _assemble_and_solve(mesh, state, params, config, amg,
                                     n_sweeps, frozen_amg=frozen_amg)

        # Under-relaxed field update + max-diff
        # (update_fields_from_coupled.wgsl), with the alpha ramp.
        alpha_u = params.alpha_u
        if config.alpha_u_final > 0 and it >= config.alpha_ramp_after:
            alpha_u = torch.tensor(config.alpha_u_final, dtype=torch.float32,
                                   device=dev)
        u_new = state.u + alpha_u * (result.x[:, 0:2] - state.u)
        p_new = state.p + params.alpha_p * (result.x[:, 2] - state.p)
        diffs = torch.stack([torch.max(torch.abs(u_new - state.u)),
                             torch.max(torch.abs(p_new - state.p))])
        state = replace(state, u=u_new, p=p_new,
                        outer_residual_u=diffs[0], outer_residual_p=diffs[1],
                        outer_iters=torch.tensor(it + 1, dtype=torch.int32,
                                                 device=dev))
        li, lr = result.iterations, result.residual
        lt += li

        # Convergence + stagnation (coupled_solver.rs:396-479).
        du, dp = (float(v) for v in read(diffs))
        converged = du < config.outer_tol_u and dp < config.outer_tol_p
        rel_u = abs((du - prev_du) / max(abs(prev_du), 1e-14))
        rel_p = abs((dp - prev_dp) / max(abs(prev_dp), 1e-14))
        stagnated = (rel_u < config.outer_stagnation_factor
                     and rel_p < config.outer_stagnation_factor and it > 2)
        du_ok, dp_ref, plateau = _plateau_update(du_ok, dp_ref, du, dp,
                                                 config)
        prev_du, prev_dp = du, dp
        if (converged and it > 0) or stagnated or plateau:
            break

    i32 = dict(dtype=torch.int32, device=dev)
    state = replace(state, time=state.time + params.dt,
                    linear_iters=torch.tensor(li, **i32),
                    linear_residual=torch.tensor(lr, dtype=torch.float32,
                                                 device=dev),
                    linear_iters_total=torch.tensor(lt, **i32))
    return check_evolution(state, config, valid=mesh.c_valid)


class CoupledSolver:
    """Host-side façade with the reference's headless API contract
    (SURVEY.md §3.5):
        GpuSolver::new(&mesh) -> set_* -> set_u/set_p
        -> initialize_history -> loop { step(); get_u()/get_p() }

    ``device``: where the solver runs; None means CUDA, and raises when no
    GPU is present (pass ``device="cpu"`` for the plain PyTorch path)."""

    def __init__(self, mesh, config: SolverConfig | None = None,
                 params: SolverParams | None = None, device=None,
                 pad_rows_to: int = 1, pad_cols_to: int = 1):
        self.device = resolve_device(device)
        self.host_mesh = mesh
        self.mesh = encode_mesh(mesh, device=self.device,
                                pad_rows_to=pad_rows_to,
                                pad_cols_to=pad_cols_to)
        self.config = config or SolverConfig()
        self.params = params or SolverParams.default(device=self.device)
        self.state = initial_state(self.mesh)
        self._amg = None

    def _f32(self, v) -> torch.Tensor:
        return torch.tensor(float(v), dtype=torch.float32, device=self.device)

    # --- setters (reference solver.rs:36-95) ---
    def set_dt(self, dt):
        self.params = replace(self.params, dt_old=self.params.dt,
                              dt=self._f32(dt))

    def set_viscosity(self, v):
        self.params = replace(self.params, viscosity=self._f32(v))

    def set_density(self, d):
        self.params = replace(self.params, density=self._f32(d))

    def set_alpha_u(self, a):
        self.params = replace(self.params, alpha_u=self._f32(a))

    def set_alpha_p(self, a):
        self.params = replace(self.params, alpha_p=self._f32(a))

    def set_inlet_velocity(self, v):
        self.params = replace(self.params, inlet_velocity=self._f32(v))

    def set_ramp_time(self, t):
        self.params = replace(self.params, ramp_time=self._f32(t))

    def set_inlet_profile(self, fn):
        """Per-face inlet profile: u_inlet(face) = inlet_velocity * fn(x, y)
        (e.g. the Schäfer–Turek parabola).  ``None`` clears it."""
        if fn is None:
            self.mesh = replace(self.mesh, f_inlet_scale=None,
                                ck_inlet_scale=None)
            return
        fx = self.mesh.f_cx.cpu().numpy()
        fy = self.mesh.f_cy.cpu().numpy()
        scale = np.asarray(fn(fx, fy), np.float32)
        ckf = self.mesh.ck_face.cpu().numpy()
        self.mesh = replace(
            self.mesh,
            f_inlet_scale=torch.as_tensor(scale, device=self.device),
            ck_inlet_scale=torch.as_tensor(scale[ckf], device=self.device))

    def set_scheme(self, scheme: int):
        self.config = replace(self.config, scheme=int(scheme))

    def set_time_scheme(self, ts: int):
        self.config = replace(self.config, time_scheme=int(ts))

    def set_precond_type(self, pt: int):
        self.config = replace(self.config, precond_type=int(pt))

    def set_n_outer_correctors(self, n: int):
        self.config = replace(self.config, n_outer_correctors=int(n))

    # --- field IO (solver.rs:97-128, 241-294); host-mesh cell order ---
    def set_u(self, u):
        u = torch.as_tensor(np.asarray(u, dtype=np.float32).reshape(-1, 2))
        u = self.mesh.from_host_order(u)
        self.state = replace(self.state, u=u, u_old=u, u_old_old=u, prev_u=u)

    def set_p(self, p):
        p = torch.as_tensor(np.asarray(p, dtype=np.float32).reshape(-1))
        self.state = replace(self.state, p=self.mesh.from_host_order(p))

    def initialize_history(self):
        self.state = replace(self.state, u_old=self.state.u,
                             u_old_old=self.state.u, prev_u=self.state.u)

    def get_u(self) -> np.ndarray:
        return self.mesh.to_host_order(self.state.u).cpu().numpy()

    def get_p(self) -> np.ndarray:
        return self.mesh.to_host_order(self.state.p).cpu().numpy()

    def get_d_p(self) -> np.ndarray:
        return self.mesh.to_host_order(self.state.d_p).cpu().numpy()

    # --- stepping ---
    def _get_amg(self):
        if self.config.precond_type != PRECOND_AMG:
            return None
        if self._amg is None:
            from ..ops.amg import build_hierarchy_for_mesh
            self._amg = build_hierarchy_for_mesh(
                self.mesh, agg_passes=self.config.amg_agg_passes)
        return self._amg

    def step(self, mode: str = "fused"):
        """Advance one timestep.  ``mode="fused"`` runs :func:`step` (the
        outer loop in Python with one host read per outer corrector); the
        JAX package's ``mode="host"`` variant is not ported."""
        if mode != "fused":
            raise NotImplementedError(f"step mode {mode!r} is not ported")
        self.state = step(self.mesh, self.state, self.params, self.config,
                          self._get_amg())
        # The step just taken becomes the BDF2 history step.
        if self.params.dt_old is not self.params.dt:
            self.params = replace(self.params, dt_old=self.params.dt)

    def run(self, num_steps: int) -> dict:
        """Run N steps (one :meth:`step` each, none once ``should_stop``);
        returns per-step metrics as host arrays, as the JAX package's
        ``run`` does."""
        keys = ("time", "outer_iters", "linear_iters", "linear_iters_total",
                "linear_residual", "outer_residual_u", "max_vel",
                "should_stop")
        rows = {k: [] for k in keys}
        for _ in range(num_steps):
            if not self.should_stop:
                self.step()
            s = self.state
            vals = torch.stack([
                s.time, s.outer_iters.float(), s.linear_iters.float(),
                s.linear_iters_total.float(), s.linear_residual,
                s.outer_residual_u,
                torch.max(torch.linalg.vector_norm(s.u, dim=1)),
                s.should_stop.float()])
            for k, v in zip(keys, read(vals)):
                rows[k].append(v)
        ints = ("outer_iters", "linear_iters", "linear_iters_total")
        return {k: np.asarray(v, np.int32 if k in ints else
                              bool if k == "should_stop" else np.float32)
                for k, v in rows.items()}

    # --- status (reference structs.rs should_stop / counters) ---
    @property
    def should_stop(self) -> bool:
        return bool(read(self.state.should_stop))

    @property
    def degenerate_count(self) -> int:
        return int(read(self.state.degenerate_count))

    @property
    def steady_state_count(self) -> int:
        return int(read(self.state.steady_count))

