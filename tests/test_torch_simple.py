"""The segregated SIMPLE stepper and the Krylov helpers of the port against
cfd2_tpu: CG and BiCGStab on the scalar pressure system and host GMRES
(the JAX suite's tests/test_krylov.py and test_aux_paths.py set-up: the
backward-facing step at min_cell 0.05), the pressure-Poisson assembly and
the Green-Gauss gradient on the same prepared state, and one SIMPLE step
(tests/test_assembly.py's channel) from the same fields.

Tolerances and why:
* assembly and gradient within 1e-5 of their largest magnitude (the same
  f32 expressions, summed in another order);
* CG / BiCGStab: after the same 10 iterations, iterates within 1e-4 of
  their maxima and residual norms within 1e-3 (the same recurrences in f32;
  why 10 is in test_krylov_recurrences); run to convergence, the port meets
  the JAX suite's residual bounds (where BiCGStab stops moves with
  roundoff);
* host GMRES: the JAX suite's residual bound, and the solution within 1e-4
  of the JAX package's (SciPy's iteration on an f32 matvec);
* the SIMPLE step: u and p within 1e-4 of their maxima, the three solves'
  iterations within 2 each."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models import assembly as ja
from cfd2_tpu.models import pressure_poisson as jpp
from cfd2_tpu.ops import blockell as jb
from cfd2_tpu.ops import host_krylov as jhk
from cfd2_tpu.ops import krylov as jk
from cfd2_tpu.runtime import state as js
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models import assembly as ta
from cfd2_tpu_torch.models import pressure_poisson as tpp
from cfd2_tpu_torch.ops import blockell as tb
from cfd2_tpu_torch.ops import host_krylov as thk
from cfd2_tpu_torch.ops import krylov as tk
from cfd2_tpu_torch.runtime import state as ts
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode

torch.set_num_threads(1)
RTOL = 1e-5


def _to_port(jstate, jparams):
    return (state_from_arrays({f: np.asarray(getattr(jstate, f))
                               for f in ts.STATE_FIELDS}, "cpu"),
            params_from_arrays({f: np.asarray(getattr(jparams, f))
                                for f in ts.PARAMS_FIELDS}, "cpu"))


def _close(name, got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (name, err, scale)


@pytest.fixture(scope="module")
def setup():
    meshes = []
    for mod in (jmesh, tmesh):
        geo = mod.BackwardsStep(length=3.5, height_inlet=0.5,
                                height_outlet=1.0, step_x=0.5)
        meshes.append(mod.generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2,
                                                 (3.5, 1.0)))
    jm, tm = jencode(meshes[0]), tencode(meshes[1], device="cpu")
    cfg = js.SolverConfig()
    jparams = js.SolverParams.default(dt=0.001)
    jstate = js.initial_state(
        jm, u0=np.full((jm.num_host_cells, 2), [0.1, 0.0]))
    jstate = jax.jit(ja.prepare, static_argnames=("config",))(
        jm, jstate, jparams, cfg)
    tstate, tparams = _to_port(jstate, jparams)
    tcfg = ts.SolverConfig()
    rng = np.random.default_rng(0)
    b = rng.standard_normal(jm.num_cells).astype(np.float32) \
        * np.asarray(jm.c_valid)
    return dict(jm=jm, tm=tm, jstate=jstate, tstate=tstate, jparams=jparams,
                tparams=tparams, b=b,
                jsys=ja.assemble_coupled(jm, jstate, jparams, cfg),
                tsys=ta.assemble_coupled(tm, tstate, tparams, tcfg))


def _matvecs(s):
    j, t = s["jsys"], s["tsys"]
    return (lambda x: jb.scalar_spmv(j.P_diag, j.P_off, s["jm"], x),
            lambda x: tb.scalar_spmv(t.P_diag, t.P_off, s["tm"], x))


@pytest.mark.parametrize("solver", ["cg_solve", "bicgstab_solve"])
def test_krylov_recurrences(setup, solver):
    """The first 10 iterations of both packages' recurrences (the cap ends
    both solves there) reach the same iterate.  BiCGStab on this
    near-singular operator amplifies roundoff: the iterates agree to 1.6e-7
    after 5 iterations and 1.7e-6 after 10, then part (8% after 20), so the
    comparison stops at 10."""
    jmv, tmv = _matvecs(setup)
    b = setup["b"]
    jdinv, tdinv = setup["jsys"].diag_p_inv, setup["tsys"].diag_p_inv
    jr = getattr(jk, solver)(jmv, jnp.asarray(b), jnp.zeros(len(b)),
                             precond=lambda r: jdinv * r, max_iters=10,
                             tol=1e-5)
    tr = getattr(tk, solver)(tmv, torch.as_tensor(b), torch.zeros(len(b)),
                             precond=lambda r: tdinv * r, max_iters=10,
                             tol=1e-5)
    assert tr.iterations == int(jr.iterations) == 10
    _close("x", tr.x, jr.x, rtol=1e-4)
    _close("residual", tr.residual, jr.residual, rtol=1e-3)


@pytest.mark.parametrize("solver,rel_bound", [("cg_solve", 1e-4),
                                              ("bicgstab_solve", 1e-3)])
def test_krylov_on_pressure_system(setup, solver, rel_bound):
    """Run to convergence, the JAX suite's tests/test_krylov.py on the
    port: the residual bound it holds (BiCGStab's stopping iteration moves
    with roundoff: 125 here against 143 in the JAX package)."""
    _, tmv = _matvecs(setup)
    b = setup["b"]
    tdinv = setup["tsys"].diag_p_inv
    tr = getattr(tk, solver)(tmv, torch.as_tensor(b), torch.zeros(len(b)),
                             precond=lambda r: tdinv * r, max_iters=2000,
                             tol=1e-5)
    assert 0 < tr.iterations < 2000
    if solver == "cg_solve":
        assert bool(tr.converged)
    rel = float(torch.linalg.vector_norm(torch.as_tensor(b) - tmv(tr.x))
                / np.linalg.norm(b))
    assert rel < rel_bound


def test_host_gmres(setup):
    jmv, tmv = _matvecs(setup)
    b = setup["b"]
    x, info = thk.host_gmres(lambda v: tmv(torch.as_tensor(v)), b,
                             restart=60, max_restarts=50, tol=1e-6)
    rel = np.linalg.norm(tmv(torch.as_tensor(x.astype(np.float32))).numpy()
                         - b) / np.linalg.norm(b)
    assert rel < 1e-3
    xj, info_j = jhk.host_gmres(lambda v: jmv(jnp.asarray(v)), b, restart=60,
                                max_restarts=50, tol=1e-6)
    assert info == info_j
    _close("x", x, xj, rtol=1e-4)


@pytest.mark.parametrize("i,name", [(0, "P_diag"), (1, "P_off"), (2, "rhs")])
def test_assemble_pressure_poisson(setup, i, name):
    got = tpp.assemble_pressure_poisson(setup["tm"], setup["tstate"],
                                        setup["tparams"])[i]
    ref = jpp.assemble_pressure_poisson(setup["jm"], setup["jstate"],
                                        setup["jparams"])[i]
    _close(name, got, ref)


def test_green_gauss_scalar(setup):
    b = setup["b"]
    _close("grad", tpp._green_gauss_scalar(setup["tm"], torch.as_tensor(b)),
           jpp._green_gauss_scalar(setup["jm"], jnp.asarray(b)))


def test_simple_step():
    meshes = []
    for mod in (jmesh, tmesh):
        geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
        meshes.append(mod.generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2,
                                                 (3.0, 1.0)))
    h = meshes[0]
    jm, tm = jencode(h), tencode(meshes[1], device="cpu")
    cfg = js.SolverConfig()
    jparams = js.SolverParams.default(dt=0.01)
    u0 = np.zeros((h.num_cells, 2))
    u0[h.cell_cx < 0.1, 0] = 1.0
    jstate = js.initial_state(jm, u0=u0)
    tstate, tparams = _to_port(jstate, jparams)
    jstate = jax.jit(partial(jpp.simple_step, n_correctors=2),
                     static_argnums=(3,))(jm, jstate, jparams, cfg)
    tstate = tpp.simple_step(tm, tstate, tparams, ts.SolverConfig(),
                             n_correctors=2)
    assert int(tstate.outer_iters) == int(jstate.outer_iters) == 2
    assert abs(int(tstate.linear_iters_total)
               - int(jstate.linear_iters_total)) <= 2 * 3 * 2
    assert abs(int(tstate.linear_iters) - int(jstate.linear_iters)) <= 2 * 3
    for f, tol in (("u", 1e-4), ("p", 1e-4)):
        got = tm.to_host_order(getattr(tstate, f))
        ref = jm.to_host_order(getattr(jstate, f))
        assert torch.isfinite(got).all()
        _close(f, got, ref, rtol=tol)
    assert float(tstate.time) == pytest.approx(float(jstate.time))
    assert bool(tstate.should_stop) == bool(jstate.should_stop)
