"""The port's ``prof_banded`` tool (``cfd2_tpu_torch/tools/prof_banded.py``)
against the JAX package's same computation (``tools/prof_banded.py``,
rebuilt here from ``cfd2_tpu``'s functions) on the CPU, on the 5,843-cell
Delaunay channel at 0.025 at rest: the block-ELL system's FGMRES solve
(restart 50, 3 restarts, rtol 1e-5) with 1 and with 8 momentum sweeps.
The tool's host-mode warm step is left out (``warm=0``): the JAX package's
takes ~95 s on this mesh on the sandbox's CPU, compiles included; the card
runs it (``chip_smoke.py`` phase 16(d)).

Tolerances: iterations equal per variant.  Times are not compared."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cfd2_tpu.mesh import ChannelWithObstacle as JChannel
from cfd2_tpu.mesh import generate_delaunay_mesh as j_delaunay
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.tools import probes, prof_banded

torch.set_num_threads(2)
quiet = lambda m: None
SIZE = 0.025


def jax_prof_banded(size: float) -> dict:
    """tools/prof_banded.py:17-114 at ``size`` without its warm step: the
    solve's iterations per momentum-sweep count."""
    from cfd2_tpu.models.assembly import assemble_coupled, prepare
    from cfd2_tpu.ops.amg import coarse_level_values, make_pressure_solve
    from cfd2_tpu.ops.blockell import block_spmv
    from cfd2_tpu.ops.fgmres import fgmres_solve
    from cfd2_tpu.ops.schur import schur_preconditioner
    mesh = j_delaunay(JChannel(3.0, 1.0, (1.0, 0.5), 0.2), size, size, 1.2,
                      (3.0, 1.0))
    s = JSolver(mesh)
    s.set_dt(min(0.002, 0.4 * size))
    s.set_viscosity(0.01)
    s.set_precond_type(1)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 2 * size, 0] = 1.0
    s.set_u(u0)
    dm = s.mesh
    config, params = s.config, s.params
    state = jax.jit(prepare, static_argnames=("config",))(
        dm, s.state, params, config)
    sysb = jax.jit(assemble_coupled, static_argnames=("config",))(
        dm, state, params, config)
    hier = s._get_amg()
    # The coarse levels coarsened outside the solve's program, as
    # make_pressure_solve coarsens them there, and passed through frozen=
    # (the same arrays): every array an argument, where the JAX tool closes
    # over them, which makes them constants of the program and slows its
    # compile, not its arithmetic.
    frozen = coarse_level_values(hier, sysb.P_diag, sysb.P_off)
    n_sweeps = config.pressure_sweeps(dm.num_cells)
    x0 = jnp.concatenate([state.u, state.p[:, None]], axis=1)

    def solve(sysb, dm, hier, frozen, x0, ms):
        ps = make_pressure_solve(hier, dm, sysb, frozen=frozen)
        return fgmres_solve(
            lambda xx: block_spmv(sysb, dm, xx),
            lambda rr: schur_preconditioner(
                sysb, dm, rr, config.precond_omega, n_sweeps,
                pressure_solve=ps, mom_sweeps=ms),
            sysb.rhs, x0, restart=50, max_restarts=3, tol=1e-5, abstol=1e-7)

    solve = jax.jit(solve, static_argnames=("ms",))
    out = {}
    for ms in (1, 8):
        res = solve(sysb, dm, hier, frozen, x0, ms=ms)
        out[ms] = (int(res.iterations), bool(res.converged))
    return out


def test_prof_banded_solves_match_jax():
    got = prof_banded.run(SIZE, "delaunay", "cpu",
                          mesh=probes.channel_mesh(SIZE, "delaunay"),
                          warm=0, log=quiet)
    assert got["solves"] == jax_prof_banded(SIZE)
    assert all(it > 0 for it, _ in got["solves"].values())
    assert [r["phase"] for r in got["phases"]][:2] == [
        "gather (N,K) (x20, per call)", "precond m1 (x10, per call)"]
