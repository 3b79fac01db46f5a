"""The port's ``prof_fgmres`` and ``prof_fgmres_loop`` tools
(``cfd2_tpu_torch/tools/``) against the JAX package's same computations
(``tools/prof_fgmres.py``, ``tools/prof_fgmres_loop.py``, rebuilt here from
``cfd2_tpu``'s functions) on the CPU:

* ``prof_fgmres`` on the 1,168-cell channel at 0.05 from rest, every piece
  run: the iterations of ``fgmres30`` (the solver's assemble-and-solve,
  tol 1e-12, restart 30, one cycle) and ``fgmres30id`` (the identity
  preconditioner);
* ``prof_fgmres_loop`` on (3, 12, 20) planes: the bare loop's iterations
  at restart 30 and 50, one cycle.

Tolerances: iterations equal.  Times are not compared."""

from dataclasses import replace

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cfd2_tpu.mesh import ChannelWithObstacle as JChannel
from cfd2_tpu.mesh import generate_cut_cell_mesh as j_cutcell
from cfd2_tpu_torch.tools import prof_fgmres, prof_fgmres_loop

torch.set_num_threads(2)
quiet = lambda m: None
SIZE = 0.05


def jax_prof_fgmres(size: float) -> dict:
    """tools/prof_fgmres.py:62-80 and 213-260 at ``size``: the iterations
    of fgmres30 and fgmres30id."""
    from cfd2_tpu.models.assembly import assemble_stencil, prepare
    from cfd2_tpu.models.coupled import _assemble_and_solve
    from cfd2_tpu.ops import stencil_system as st
    from cfd2_tpu.ops.amg import build_hierarchy_for_mesh
    from cfd2_tpu.ops.fgmres import fgmres_solve
    from cfd2_tpu.runtime.device_mesh import encode_mesh
    from cfd2_tpu.runtime.state import (SolverConfig, SolverParams,
                                        initial_state)
    mesh = j_cutcell(JChannel(3.0, 1.0, (1.0, 0.5), 0.2), size, size, 1.2,
                     (3.0, 1.0))
    dm = encode_mesh(mesh)
    config = SolverConfig()
    params = SolverParams.default(dt=min(0.002, 0.4 * size))
    u0 = np.zeros((mesh.num_cells, 2), np.float32)
    u0[mesh.cell_cx < size * 2, 0] = 1.0
    state = jax.jit(prepare, static_argnames=("config",))(
        dm, initial_state(dm, u0=u0), params, config)
    hier = build_hierarchy_for_mesh(dm)
    n_sweeps = config.pressure_sweeps(dm.num_cells)
    cfg30 = replace(config, fgmres_tol=1e-12, fgmres_abstol=1e-12,
                    fgmres_max_restarts=1, fgmres_restart=30)
    r30 = jax.jit(lambda: _assemble_and_solve(dm, state, params, cfg30, hier,
                                              n_sweeps, None))()

    def solve30id():
        ss = assemble_stencil(dm, state, params, config)
        x0 = jnp.concatenate([state.u, state.p[:, None]], axis=1)
        return fgmres_solve(lambda x: st.spmv(ss, x), lambda r: r, ss.rhs,
                            x0, restart=30, max_restarts=1, tol=1e-12,
                            abstol=1e-12)
    rid = jax.jit(solve30id)()
    return {"fgmres30": int(r30.iterations),
            "fgmres30id": int(rid.iterations)}


def test_prof_fgmres_iterations_match_jax():
    got = prof_fgmres.run(SIZE, None, "cpu", log=quiet)
    assert got["iterations"] == jax_prof_fgmres(SIZE)
    assert set(got["phases"]) >= {"launch", "stream64", "matvec", "precond",
                                  "vapply", "cgs j=45", "fgmres30id"}


def test_cgs_step_is_the_gram_schmidt_of_fgmres():
    """prof_fgmres's timed Gram-Schmidt step: the live rows' dots with w
    and w minus their projection."""
    rng = np.random.default_rng(4)
    V = torch.as_tensor(rng.standard_normal((9, 50)), dtype=torch.float64)
    w = torch.as_tensor(rng.standard_normal(50), dtype=torch.float64)
    d, w2 = prof_fgmres.cgs_step(V, w, 4)
    assert torch.allclose(d, V[:5] @ w)
    assert torch.allclose(w2, w - V[:5].T @ (V[:5] @ w))


def test_prof_fgmres_loop_iterations_match_jax():
    from cfd2_tpu.ops.fgmres import fgmres_solve
    ny, nx = 12, 20
    got = prof_fgmres_loop.run(ny, nx, "cpu", log=quiet)
    b = jnp.asarray(prof_fgmres_loop.rhs(ny, nx, "cpu").numpy())
    mv = lambda x: x * 1.0001 + 0.0001 * jnp.roll(x, 1, axis=-1)
    pc = lambda r: r * 0.999
    for m in prof_fgmres_loop.RESTARTS:
        r = jax.jit(lambda bb, m=m: fgmres_solve(
            mv, pc, bb, jnp.zeros_like(bb), restart=m, max_restarts=1,
            tol=1e-30, abstol=1e-30))(b)
        assert got[m]["iterations"] == int(r.iterations) == m
