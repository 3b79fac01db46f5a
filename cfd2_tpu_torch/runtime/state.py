"""Solver configuration and state.

The same split as ``cfd2_tpu.runtime.state``:

* :class:`SolverConfig` — frozen hashable dataclass (scheme ids, iteration
  caps, tolerances); a verbatim copy of the JAX package's, so the two
  packages read the same options with the same defaults.
* :class:`SolverParams` — dataclass of float32 0-d tensors (dt, viscosity,
  density, relaxation factors, inlet ramp).
* :class:`SolverState` — dataclass of the per-step field tensors carried
  from one step to the next.

All floating tensors are float32 and all integer tensors int32.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

# Scheme ids (reference src/solver/scheme.rs:1-17)
SCHEME_UPWIND = 0
SCHEME_SECOND_ORDER_UPWIND = 1
SCHEME_QUICK = 2

# Time scheme ids
TIME_EULER = 0
TIME_BDF2 = 1

# Preconditioner ids (reference structs.rs precond_type)
PRECOND_JACOBI = 0        # Chebyshev/Jacobi pressure relaxation
PRECOND_AMG = 1           # AMG V-cycle
PRECOND_BLOCK_JACOBI = 2  # per-cell 3x3 block inverse (preconditioner.wgsl)


# The option comments below are the JAX package's; the measurements they
# quote were taken there, on a TPU, and say nothing of this port's speed.
@dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (frozen, hashable)."""
    scheme: int = SCHEME_UPWIND
    time_scheme: int = TIME_EULER
    precond_type: int = PRECOND_JACOBI

    # Outer (non-linear) loop: reference coupled_solver.rs:110-117
    n_outer_correctors: int = 20
    outer_tol_u: float = 1e-5
    outer_tol_p: float = 1e-4
    outer_stagnation_factor: float = 1e-2
    # Temporal extrapolation of the first outer's Krylov initial guess:
    # x0_u = u + (dt/dt_old)(u - u_old_old).  Measured NET NEGATIVE at 1M
    # (1.25M vs 1.48M cell-updates/s): the extrapolated start perturbs the
    # Picard iterate the outer max-diff test measures against, costing more
    # outer correctors than the Krylov iterations it saves.  Kept as an
    # option; off by default.
    extrapolate_guess: bool = False
    # Outer relaxation ramp: the under-relaxed corrector contracts its error
    # by exactly (1 - alpha_u) per outer once the solve is tight, so fixed
    # alpha_u = 0.7 costs ~3x the outers of alpha 1.0 in the linearized
    # tail.  After `alpha_ramp_after` outers the effective alpha_u ramps to
    # alpha_u_final (0 disables; the converged state is the same fixed point
    # either way, so the reference's convergence contract is preserved —
    # early outers keep the damped alpha for nonlinear robustness).
    alpha_u_final: float = 1.0
    alpha_ramp_after: int = 2
    # Anderson acceleration of the outer Picard iteration (depth = number of
    # history differences; 0 disables).  The under-relaxed corrector is a
    # fixed-point map whose converged state is iteration-path-independent, so
    # accelerating it preserves the reference's convergence contract; the
    # mixing coefficients come from a tiny (depth x depth) least-squares
    # solved on-device each outer, safeguarded by anderson_gamma_max (fall
    # back to the plain relaxed update when the extrapolation is wild).
    anderson_depth: int = 0
    anderson_gamma_max: float = 2.0
    # Pressure-plateau patience: when du has been below outer_tol_u for this
    # many consecutive outers while dp wanders on a sub-tolerance-scale noise
    # plateau (linear-solve error amplified through the Schur complement; the
    # reference burns to its 20-cap in exactly this regime), exit.  The
    # returned fields match the burn-to-cap result to within the plateau
    # amplitude (pinned by tests/test_solver_convergence.py).  0 disables.
    outer_pressure_patience: int = 5

    # FGMRES: reference coupled_solver_fgmres.rs:1737-1740
    fgmres_restart: int = 50
    fgmres_max_restarts: int = 20
    fgmres_tol: float = 1e-5
    fgmres_abstol: float = 1e-7
    fgmres_stagnation_tol: float = 1e-3
    fgmres_stagnation_limit: int = 3
    # Krylov basis storage dtype: bf16 basis rows with f32 arithmetic halve
    # the CGS streaming traffic — the dominant per-iteration byte count at
    # >=1M cells (DESIGN.md §9b).  Convergence is protected by the per-cycle
    # true-residual recomputation; tests/test_fgmres.py pins solution parity
    # vs the f32 basis.  Default False: on TPU at 1M cells the measured
    # end-to-end effect was neutral (1.42 vs 1.48M cell-updates/s) while
    # compile time dropped 132 -> 47 s; on the CPU backend bf16 is emulated
    # ~30x slower.  bench.py opts in per measurement.
    fgmres_basis_bf16: bool = False
    # Run the Schur preconditioner's momentum sweeps / Schur RHS / velocity
    # correct in bf16 (coefficients cast once per assembly, result cast back
    # to f32).  M^{-1} is an approximation by construction and FGMRES is
    # *flexible* — arbitrary preconditioner variation is absorbed by storing
    # Z — so low-precision application costs at most a few Krylov iterations
    # while halving the preconditioner's HBM traffic.  The pressure V-cycle
    # stays f32 (the near-null constant mode already strains f32
    # conditioning, DESIGN.md §10).  Default False (see fgmres_basis_bf16).
    precond_bf16: bool = False
    # f64 accumulation of FGMRES norms/residuals (stiff cases, e.g. water at
    # rho=1000 where squared norms strain f32).  Needs jax_enable_x64;
    # without it the cast is a silent no-op.  Off by default (f32 matches
    # the reference's all-f32 device numerics, DESIGN.md §10).
    fgmres_f64_norms: bool = False
    # First-outer pressure presolve (structured path; VERDICT r3 #2): when
    # the initial residual of an outer's linear solve exceeds
    # presolve_threshold x the Krylov target, build the initial guess with
    # one SIMPLE/Schur correction whose pressure block runs this many
    # V-cycle-preconditioned CG iterations (ops/stencil_system.schur_guess).
    # From-rest first solves burn 88-100 coupled FGMRES iterations retiring
    # an error that is overwhelmingly the elliptic pressure mode — CG on the
    # scalar pressure system retires the same mode at ~1/3 the bytes per
    # iteration.  The Krylov rtol/atol contract is unchanged (only x0
    # moves); warm states never trip the threshold and pay one norm
    # computation.  0 disables.
    presolve_pressure_iters: int = 0
    presolve_threshold: float = 100.0
    # In-cycle stall exit (ops/fgmres.py incycle_window): stop an Arnoldi
    # cycle when the residual estimate has improved < incycle_tol over the
    # last N iterations (the f32 attainable-accuracy floor on warm states
    # turns strict-tolerance solves into long stalls; the true-residual /
    # restart-stagnation contract is unchanged).  0 = off (reference
    # parity).
    fgmres_incycle_window: int = 0
    fgmres_incycle_tol: float = 0.02
    # Two-phase mixed-precision solve (structured path): bf16 basis +
    # preconditioner down to ~1e-3 relative, then f32 to the full tolerance
    # from the phase-1 iterate.  Same final contract (the f32 phase derives
    # its own true residual); saves ~20% of the dominant first-outer solve's
    # bytes.  Off by default pending measurement.
    fgmres_mixed_phase: bool = False
    # Inexact-Newton forcing: early outer iterations solve to a looser
    # relative tolerance (10^-(3+it) floored at fgmres_tol).  This paid
    # ~28% when the preconditioner was weak (round 1: first solves burned
    # 250 Krylov iterations); with the deep momentum predict a 1e-5 solve
    # costs ~1.5x a 1e-3 one and tight first solves SAVE outer correctors —
    # measured at 1M: strict 1.47 vs adaptive 1.21 steps/s.  Default False
    # = the reference's fixed rtol=1e-5 every solve
    # (coupled_solver_fgmres.rs:1737-1740); no tolerance deviation.
    adaptive_linear_tol: bool = False
    # Krylov recycling across outer correctors (fused step; VERDICT r4 #6 /
    # DESIGN §9c's last untried lever).  1: each outer's FGMRES warm-starts
    # from a guarded least-squares projection of its residual onto the
    # previous solve's Krylov space (ops/fgmres.py `recycle` — GCRO-DR's
    # projection-only form).  Consecutive outer systems differ by one
    # under-relaxed field update, so the previous search space retires most
    # of the shared low-frequency error at ~2 iterations' bandwidth cost;
    # one extra matvec confirms the correction reduced ||r0|| before it is
    # taken, so the rtol/atol contract never loosens.  Carries (V, Z, R,
    # givens) in the outer-loop carry: +2(m+1)·3N floats of HBM while the
    # step runs.  0 = off (reference parity: no recycling,
    # coupled_solver_fgmres.rs restarts cold every outer).
    fgmres_recycle: int = 0

    # Schur pressure relaxation: coupled_solver_fgmres.rs:1812-1817
    precond_omega: float = 1.2
    pressure_iters: int = 0   # 0 -> auto: min(20 + sqrt(N)/2, 200)
    # Momentum-block Jacobi sweeps inside the Schur preconditioner.  1 is the
    # reference's bare diagonal predict (schur_precond.wgsl:149-156); higher
    # values fold the momentum off-diagonals in (measured: 42 -> 33 FGMRES
    # iters at 3 sweeps on a developed 120k-cell state — a wash at small
    # sizes where iteration cost is launch-bound, +24% end-to-end at 1M
    # where basis reads dominate).  0 = auto: 1 below 500k cells, 2 above.
    precond_mom_sweeps: int = 0
    # > 0: replace the Jacobi momentum predict with N ADI line-relaxation
    # passes (truncated-PCR tridiagonal solves along grid rows/columns,
    # ops/stencil_system.py) — mesh-size-independent strength along lines.
    # Structured stencil path only; measured head-to-head vs the Jacobi
    # predict before changing defaults.
    precond_mom_adi: int = 0
    # V-cycles per Schur-preconditioner pressure solve (structured path).
    # 0 = size-auto (see pressure_vcycles()); the first outer solve's large
    # smooth pressure error converges slowly through one piecewise-constant
    # V-cycle at >=1M cells, and extra cycles buy contraction^n for ~18%
    # more bytes per Krylov iteration.
    precond_vcycles: int = 0
    # Aggregation-AMG cycle shape (generic/banded unstructured path only).
    # precond_cheb > 0: Chebyshev smoother of that degree (per-level
    # Gershgorin lambda_max) instead of one damped-Jacobi sweep.
    # precond_overcorrect != 1: scale on the prolongated coarse correction
    # (plain-aggregation transfers underestimate correction energy).
    precond_cheb: int = 0
    precond_overcorrect: float = 1.0
    # Freeze the generic-AMG coarse operators per TIMESTEP (banded path,
    # fused step): Galerkin re-coarsening (a segment-sum RAP over ~N*(K+1)
    # entries) costs 7.5 ms/outer at 130k cells — ~30% of a developed-state
    # step — while the level-1+ operators it rebuilds only steer the
    # preconditioner's coarse correction.  With this flag the step coarsens
    # once at entry and every outer reuses those coarse operators; level 0
    # (smoother + residual, which set the V-cycle's fixed point) still
    # tracks each outer's assembly, and flexible FGMRES absorbs the
    # staleness without touching the rtol/atol contract.  The host-mode
    # step keeps per-outer re-coarsening (verification exactness).
    amg_freeze_coarse: bool = True
    # Aggregation passes per AMG level (generic hierarchy).  2 composes a
    # second greedy pass over the aggregate graph (~9x coarsening per
    # level): the unstructured V-cycle's cost at >=100k cells is
    # kernel-launch count, so ~half the levels beats the slightly better
    # per-cycle contraction of the deep hierarchy.  0 = auto.
    amg_agg_passes: int = 0

    # Steady-state / degeneracy detection: coupled_solver.rs:501-580
    evolution_threshold: float = 1e-6
    variance_threshold: float = 1e-10
    stop_count: int = 10

    def pressure_sweeps(self, num_cells: int) -> int:
        if self.pressure_iters > 0:
            return self.pressure_iters
        return int(min(20 + np.sqrt(num_cells) / 2.0, 200.0))

    def pressure_vcycles(self, num_cells: int) -> int:
        if self.precond_vcycles > 0:
            return self.precond_vcycles
        return 1

    def cycle_opts(self) -> dict:
        """kwargs for ops/amg.v_cycle on the aggregation-AMG path."""
        opts = {}
        if self.precond_cheb > 0:
            opts["smoother"] = "cheb"
            opts["smooth_arg"] = self.precond_cheb
        if self.precond_overcorrect != 1.0:
            opts["overcorrect"] = self.precond_overcorrect
        return opts

    def mom_sweeps(self, num_cells: int) -> int:
        # Measured (DESIGN.md §9b): FGMRES iterations at 1M drop 48/32/23/11
        # for 2/3/4/8 sweeps at near-constant per-iteration cost; end-to-end
        # with the strict tolerance default, 8 sweeps measured 1.19M
        # cell-updates/s at 120k (vs 519k bare-diagonal) and 1.47M at 1M;
        # 12 sweeps win at 2M.
        if self.precond_mom_sweeps > 0:
            return self.precond_mom_sweeps
        return 8 if num_cells < 1_500_000 else 12


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


@dataclass
class SolverParams:
    """Physics parameters as float32 0-d tensors on the solver's device."""
    dt: torch.Tensor
    dt_old: torch.Tensor
    viscosity: torch.Tensor
    density: torch.Tensor
    alpha_u: torch.Tensor
    alpha_p: torch.Tensor
    inlet_velocity: torch.Tensor
    ramp_time: torch.Tensor

    @staticmethod
    def default(dt=0.0001, viscosity=0.01, density=1.0, alpha_u=0.7,
                alpha_p=1.0, inlet_velocity=1.0, ramp_time=0.1,
                device=None):
        """Defaults match the reference GpuConstants (init/fields.rs:101-116).
        ``device`` None means CUDA (see device_mesh.resolve_device)."""
        from .device_mesh import resolve_device
        device = resolve_device(device)
        return SolverParams(
            dt=_f32(dt, device), dt_old=_f32(dt, device),
            viscosity=_f32(viscosity, device), density=_f32(density, device),
            alpha_u=_f32(alpha_u, device), alpha_p=_f32(alpha_p, device),
            inlet_velocity=_f32(inlet_velocity, device),
            ramp_time=_f32(ramp_time, device))


@dataclass
class SolverState:
    """Everything carried across timesteps (the reference's 3 FluidState
    buffers + fluxes + evolution-detector state, init/fields.rs:8-190)."""
    u: torch.Tensor          # (N, 2)
    p: torch.Tensor          # (N,)
    d_p: torch.Tensor        # (N,)
    grad_p: torch.Tensor     # (N, 2)
    grad_u: torch.Tensor     # (N, 2)  d(u_x)/dx, d(u_x)/dy
    grad_v: torch.Tensor     # (N, 2)
    fluxes: torch.Tensor     # (N, K) slot layout, or (F,) per face
    u_old: torch.Tensor      # (N, 2)  state at t^n
    u_old_old: torch.Tensor  # (N, 2)  state at t^{n-1} (BDF2)
    time: torch.Tensor       # f32 scalar

    # Evolution / degeneracy detector (coupled_solver.rs:501-580)
    prev_u: torch.Tensor            # (N, 2) u at previous step
    degenerate_count: torch.Tensor  # int32
    steady_count: torch.Tensor      # int32
    should_stop: torch.Tensor       # bool

    # Last-step diagnostics
    outer_iters: torch.Tensor       # int32
    outer_residual_u: torch.Tensor  # f32
    outer_residual_p: torch.Tensor  # f32
    linear_iters: torch.Tensor      # int32 (FGMRES iterations, last solve)
    linear_residual: torch.Tensor   # f32
    linear_iters_total: torch.Tensor  # int32, summed over the step's outers


STATE_FIELDS = tuple(f.name for f in fields(SolverState))
PARAMS_FIELDS = tuple(f.name for f in fields(SolverParams))


def initial_state(mesh, u0=None, p0=None,
                  host_order: bool = True) -> SolverState:
    """Build the initial state for a :class:`DeviceMesh` on its device;
    ``initialize_history`` semantics of the reference (solver.rs:276-294):
    history buffers = current state.

    ``u0``/``p0`` are given in host-mesh cell order (like the reference's
    set_u/set_p) unless ``host_order=False``.
    """
    dev = mesh.device
    N = mesh.num_cells
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.zeros((N, 2), **f32)
    p = torch.zeros((N,), **f32)
    if u0 is not None:
        u0 = torch.as_tensor(np.asarray(u0, np.float32), device=dev)
        u = mesh.from_host_order(u0) if host_order else u0
    if p0 is not None:
        p0 = torch.as_tensor(np.asarray(p0, np.float32), device=dev)
        p = mesh.from_host_order(p0) if host_order else p0
    i32 = dict(dtype=torch.int32, device=dev)
    return SolverState(
        u=u, p=p, d_p=torch.zeros((N,), **f32),
        grad_p=torch.zeros((N, 2), **f32), grad_u=torch.zeros((N, 2), **f32),
        grad_v=torch.zeros((N, 2), **f32),
        # Slot layout everywhere except the generic path without a banded
        # map, which keeps one value per face (prepare_coupled.wgsl).
        fluxes=torch.zeros((N, mesh.max_faces) if mesh.structured
                           or mesh.multilevel or mesh.banded
                           else (mesh.num_faces,), **f32),
        u_old=u, u_old_old=u, time=torch.zeros((), **f32),
        prev_u=u, degenerate_count=torch.zeros((), **i32),
        steady_count=torch.zeros((), **i32),
        should_stop=torch.zeros((), dtype=torch.bool, device=dev),
        outer_iters=torch.zeros((), **i32),
        outer_residual_u=torch.zeros((), **f32),
        outer_residual_p=torch.zeros((), **f32),
        linear_iters=torch.zeros((), **i32),
        linear_residual=torch.zeros((), **f32),
        linear_iters_total=torch.zeros((), **i32),
    )
