"""The port's FGMRES against cfd2_tpu.ops.fgmres.

On an assembled coupled system both solve with the same operator and
preconditioner (each package's own stencil_system): iteration counts within
+-1 (the Givens/Gram-Schmidt sums round differently), and solutions within
10x the solve's relative tolerance of each other (each meets rtol against
its own operator; 10x leaves room for the two f32 operators' roundoff)."""

import jax
import numpy as np
import pytest
import torch

from cfd2_tpu.mesh import ChannelWithObstacle, generate_cut_cell_mesh
from cfd2_tpu.models.assembly import assemble_stencil as j_assemble
from cfd2_tpu.models.assembly import prepare as j_prepare
from cfd2_tpu.ops import amg as jamg
from cfd2_tpu.ops import stencil_system as jst
from cfd2_tpu.ops.fgmres import fgmres_solve as j_fgmres
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu.runtime import state as js
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models.assembly import assemble_stencil as t_assemble
from cfd2_tpu_torch.ops import amg as tamg
from cfd2_tpu_torch.ops import stencil_system as tst
from cfd2_tpu_torch.ops.fgmres import fgmres_solve as t_fgmres
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode
from cfd2_tpu_torch.runtime import host_reads
from cfd2_tpu_torch.runtime import state as ts

torch.set_num_threads(1)
RTOL = 1e-5


@pytest.fixture(scope="module")
def systems():
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.0, 1.0))
    jm = jencode(mesh)
    tm = tencode(mesh, device="cpu")
    cfg = js.SolverConfig()
    params = js.SolverParams.default(dt=0.01)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    state = js.initial_state(jm, u0=u0)
    state = jax.jit(j_prepare, static_argnames=("config",))(
        jm, state, params, cfg)
    jss = j_assemble(jm, state, params, cfg)
    tstate = state_from_arrays({f: np.asarray(getattr(state, f))
                                for f in ts.STATE_FIELDS}, "cpu")
    tparams = params_from_arrays({f: np.asarray(getattr(params, f))
                                  for f in ts.PARAMS_FIELDS}, "cpu")
    tss = t_assemble(tm, tstate, tparams, ts.SolverConfig())
    jh = jamg.build_structured_hierarchy(jm)
    th = tamg.build_structured_hierarchy(tm)
    x0 = np.concatenate([np.asarray(state.u), np.asarray(state.p)[:, None]],
                        axis=1)
    return jm, jss, tss, jh, th, x0


@pytest.mark.parametrize("precond", ["amg", "chebyshev"])
def test_coupled_solve_matches_jax(systems, precond):
    jm, jss, tss, jh, th, x0 = systems
    n_sweeps = js.SolverConfig().pressure_sweeps(jm.num_cells)
    if precond == "amg":
        jps = jst.make_pressure_solve2(jh, jss)
        tps = tst.make_pressure_solve2(th, tss)
    else:
        jps = tps = None
    kw = dict(restart=50, max_restarts=20, tol=RTOL, abstol=1e-7)
    jr = j_fgmres(
        lambda x: jst.spmv_planar(jss, x),
        lambda r: jst.schur_precond_planar(jss, r, 1.2, n_sweeps,
                                           pressure_solve=jps, mom_sweeps=8),
        jst.to_planar(jss, jss.rhs), jst.to_planar(jss, x0), **kw)
    host_reads.reset()
    tr = t_fgmres(
        lambda x: tst.spmv_planar(tss, x),
        lambda r: tst.schur_precond_planar(tss, r, 1.2, n_sweeps,
                                           pressure_solve=tps, mom_sweeps=8),
        tst.to_planar(tss, tss.rhs), tst.to_planar(tss, torch.as_tensor(x0)),
        **kw)
    assert bool(jr.converged) and tr.converged
    assert abs(tr.iterations - int(jr.iterations)) <= 1
    assert tr.iterations > 5
    # One read per Arnoldi iteration, one per cycle, one at entry.
    assert host_reads.COUNT["reads"] == tr.iterations + 2
    jx = np.asarray(jr.x)
    err = np.linalg.norm(tr.x.numpy() - jx) / np.linalg.norm(jx)
    assert err <= 10 * RTOL


def _dense(A, b, scale, x0=None, **kw):
    At = torch.as_tensor(A)
    N = b.shape[0]
    mv = lambda x: (At @ x.reshape(-1)).reshape(N, 3)
    x0 = torch.zeros((N, 3)) if x0 is None else torch.as_tensor(x0)
    return t_fgmres(mv, lambda r: r * scale, torch.as_tensor(b), x0, **kw)


def test_restart_path_converges():
    rng = np.random.default_rng(1)
    N = 30
    A = rng.standard_normal((3 * N, 3 * N)).astype(np.float32) * 0.3
    A += np.eye(3 * N, dtype=np.float32) * 4.0
    b = rng.standard_normal((N, 3)).astype(np.float32)
    res = _dense(A, b, 0.25, restart=5, max_restarts=40, tol=1e-6,
                 abstol=1e-10)
    x = res.x.numpy().reshape(-1)
    assert np.linalg.norm(A @ x - b.reshape(-1)) / np.linalg.norm(b) < 1e-3
    assert res.iterations > 5


def test_zero_rhs_and_exact_guess_take_no_iterations():
    N = 10
    A = np.eye(3 * N, dtype=np.float32) * 2.0
    res = _dense(A, np.zeros((N, 3), np.float32), 1.0, tol=1e-5, abstol=1e-7)
    assert res.converged and res.iterations == 0
    x_true = np.random.default_rng(2).standard_normal((N, 3)).astype(
        np.float32)
    b = (A @ x_true.reshape(-1)).reshape(N, 3)
    res = _dense(A, b, 1.0, x0=x_true, tol=1e-5, abstol=1e-7)
    assert res.converged and res.iterations == 0
    np.testing.assert_array_equal(res.x.numpy(), x_true)


def test_unported_options_raise():
    b = torch.ones(6)
    with pytest.raises(NotImplementedError):
        t_fgmres(lambda x: x, lambda r: r, b, b, f64_norms=True)
    with pytest.raises(NotImplementedError):
        t_fgmres(lambda x: x, lambda r: r, b, b, basis_dtype=torch.bfloat16)
