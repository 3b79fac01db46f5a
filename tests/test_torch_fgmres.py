"""The port's FGMRES against cfd2_tpu.ops.fgmres.

On an assembled coupled system both solve with the same operator and
preconditioner (each package's own stencil_system): iteration counts within
+-1 (the Givens/Gram-Schmidt sums round differently), and solutions within
10x the solve's relative tolerance of each other (each meets rtol against
its own operator; 10x leaves room for the two f32 operators' roundoff).
The options (float64 norms, the bf16 basis, the in-cycle exit, the
recycled warm start) are held the same way, each with its tolerance stated
beside it."""

import jax
import numpy as np
import pytest
import torch

from cfd2_tpu.ops import stencil_system as jst
from cfd2_tpu.ops.fgmres import fgmres_solve as j_fgmres
from cfd2_tpu.runtime import state as js
from cfd2_tpu_torch.ops import stencil_system as tst
from cfd2_tpu_torch.ops.fgmres import fgmres_solve as t_fgmres
from cfd2_tpu_torch.runtime import host_reads
from torch_parity import assembled_systems

torch.set_num_threads(1)
RTOL = 1e-5


@pytest.fixture(scope="module")
def systems():
    return assembled_systems()


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
    """Nothing of the JAX function is refused any more: the options the
    first slices refused (float64 norms, the bf16 basis) and the TPU layout
    arguments (accepted and ignored) solve a small system."""
    A = np.eye(30, dtype=np.float32) * 2.0
    b = np.arange(30, dtype=np.float32).reshape(10, 3)
    for kw in (dict(f64_norms=True), dict(basis_dtype=torch.bfloat16),
               dict(flatten=False, cgs_chunk_rows=4)):
        res = _dense(A, b, 0.5, tol=1e-6, abstol=1e-10, **kw)
        assert res.converged and res.basis is None, kw
        np.testing.assert_allclose(res.x.numpy(), b / 2, rtol=1e-5)


def test_make_norm_f64_against_numpy():
    """make_norm(True) sums the squares in float64 (numpy's float64 norm,
    rounded to f32 once: equal within one f32 ulp); on a vector whose f32
    squares overflow it stays finite, where the f32 norm does not.  The JAX
    package's make_norm(True) without jax_enable_x64 is the f32 norm (a
    deliberate difference of the port)."""
    from cfd2_tpu.ops.fgmres import make_norm as j_make_norm
    from cfd2_tpu_torch.ops.fgmres import make_norm
    rng = np.random.default_rng(5)
    nrm = make_norm(True)
    for v in (rng.standard_normal(10_001).astype(np.float32) * 1e3,
              np.array([3e20, 4e20, 1.0], np.float32)):
        got = nrm(torch.as_tensor(v))
        assert got.dtype == torch.float32
        ref = np.float32(np.sqrt(np.sum(v.astype(np.float64) ** 2)))
        np.testing.assert_allclose(float(got), ref, rtol=1.2e-7)
    assert not np.isfinite(float(make_norm(False)(torch.as_tensor(v))))
    assert not np.isfinite(float(j_make_norm(True, jax.numpy.float32)(
        jax.numpy.asarray(v))))


def test_f32_norm_is_accurate_at_full_size():
    """The f32 norm (make_norm(False)) on the CPU at a full-size length
    (1,210,752 entries: the 403k Delaunay case's three rows of 403,584)
    within 1e-7 (relative) of the float64 norm, as the JAX package's f32
    norm is.  FGMRES reads every basis vector's norm: torch's CPU
    ``vector_norm``, which the port used before, misses by far more there
    and ended that case's first step-2 solve at its restart cap."""
    from cfd2_tpu.ops.fgmres import make_norm as j_make_norm
    from cfd2_tpu_torch.ops.fgmres import make_norm
    rng = np.random.default_rng(7)
    n = 1_210_752
    v = (rng.standard_normal(n) * rng.random(n) ** 4).astype(np.float32)
    ref = np.sqrt(np.sum(v.astype(np.float64) ** 2))
    got = make_norm(False)(torch.as_tensor(v))
    assert got.dtype == torch.float32
    assert abs(float(got) - ref) <= 1e-7 * ref
    jgot = j_make_norm(False, jax.numpy.float32)(jax.numpy.asarray(v))
    assert abs(float(jgot) - ref) <= 1e-7 * ref


@pytest.mark.parametrize("option,slack", [
    (dict(f64_norms=True), 1),
    (dict(basis_dtype="bf16"), 2),
], ids=["f64_norms", "bf16_basis"])
def test_option_solve_matches_jax(systems, option, slack):
    """One option of the JAX function against its port on the assembled
    coupled system (AMG pressure block): iterations within 1 (within 2 for
    the bf16 basis, whose rows the two packages round from slightly
    different f32 vectors), solutions within 10x the solve's rtol."""
    jm, jss, tss, jh, th, x0 = systems
    n_sweeps = js.SolverConfig().pressure_sweeps(jm.num_cells)
    jps = jst.make_pressure_solve2(jh, jss)
    tps = tst.make_pressure_solve2(th, tss)
    kw = dict(restart=50, max_restarts=3, tol=RTOL, abstol=1e-9)
    jopt, topt = dict(option), dict(option)
    if option.get("basis_dtype"):
        jopt["basis_dtype"] = jax.numpy.bfloat16
        topt["basis_dtype"] = torch.bfloat16
    jr = j_fgmres(
        lambda x: jst.spmv_planar(jss, x),
        lambda r: jst.schur_precond_planar(jss, r, 1.2, n_sweeps,
                                           pressure_solve=jps, mom_sweeps=8),
        jst.to_planar(jss, jss.rhs), jst.to_planar(jss, x0), **kw, **jopt)
    tr = t_fgmres(
        lambda x: tst.spmv_planar(tss, x),
        lambda r: tst.schur_precond_planar(tss, r, 1.2, n_sweeps,
                                           pressure_solve=tps, mom_sweeps=8),
        tst.to_planar(tss, tss.rhs), tst.to_planar(tss, torch.as_tensor(x0)),
        **kw, **topt)
    assert abs(tr.iterations - int(jr.iterations)) <= slack, \
        (tr.iterations, int(jr.iterations))
    jx = np.asarray(jr.x)
    err = np.linalg.norm(tr.x.numpy() - jx) / np.linalg.norm(jx)
    assert err <= 10 * RTOL


def test_incycle_exit_matches_jax():
    """The in-cycle stall exit on the JAX package's own case for it
    (tests/test_fgmres.py: an unattainable tolerance, a noisy
    preconditioner): it cuts the iterations, and the port exits where the
    JAX package does (counts within 1, true residuals within 1e-4)."""
    rng = np.random.default_rng(21)
    N = 50
    A = rng.standard_normal((3 * N, 3 * N)).astype(np.float32) * 0.3
    A += np.eye(3 * N, dtype=np.float32) * 3.0
    b = rng.standard_normal((N, 3)).astype(np.float32)
    kw = dict(restart=40, max_restarts=4, tol=1e-14, abstol=1e-30)
    full = _dense(A, b, 0.3, **kw)
    cut = _dense(A, b, 0.3, incycle_window=12, **kw)
    ref = _jax_dense(A, b, 0.3, incycle_window=12, **kw)
    assert cut.iterations < full.iterations
    assert abs(cut.iterations - int(ref.iterations)) <= 1
    assert cut.residual == pytest.approx(float(ref.residual), rel=1e-4)


def _perturbed_pair(seed, N, drift):
    rng = np.random.default_rng(seed)
    A1 = rng.standard_normal((3 * N, 3 * N)).astype(np.float32) * 0.1
    A1 += np.eye(3 * N, dtype=np.float32) * 4.0
    A2 = A1 + drift * rng.standard_normal((3 * N, 3 * N)).astype(np.float32)
    b = rng.standard_normal((N, 3)).astype(np.float32)
    return A1, A2, b


def test_recycle_zero_seed_is_noop():
    """The zero-basis seed (j = 0; the first outer of a recycling step)
    leaves the solve bit-equal to a cold one, with no host read more."""
    from cfd2_tpu_torch.ops.fgmres import zero_basis
    A, _, b = _perturbed_pair(4, 24, 0.0)
    A += np.eye(72, dtype=np.float32)
    kw = dict(restart=20, max_restarts=5, tol=1e-6, abstol=1e-10)
    host_reads.reset()
    cold = _dense(A, b, 0.2, **kw)
    reads = host_reads.COUNT["reads"]
    host_reads.reset()
    warm = _dense(A, b, 0.2, recycle=zero_basis(20, 72, torch.float32,
                                                torch.float32, "cpu"),
                  return_basis=True, **kw)
    assert host_reads.COUNT["reads"] == reads
    assert cold.iterations == warm.iterations
    np.testing.assert_array_equal(cold.x.numpy(), warm.x.numpy())
    V, Z, R, cs, sn, j = warm.basis
    assert V.shape == (21, 72) and Z.shape == (20, 72) and R.shape == (20, 20)
    assert j == warm.iterations <= 20


def test_recycle_warm_start_cuts_iterations():
    """A perturbed system warm-started from the first solve's basis keeps
    the convergence contract and takes fewer iterations than a cold solve,
    in the port as in the JAX package (counts within 1 of the JAX
    package's)."""
    A1, A2, b = _perturbed_pair(3, 60, 0.01)
    kw = dict(restart=30, max_restarts=10, tol=1e-6, abstol=1e-10,
              return_basis=True)
    counts = {}
    for pkg, solve in (("port", lambda A, rc: _dense(A, b, 0.25,
                                                     recycle=rc, **kw)),
                       ("jax", lambda A, rc: _jax_dense(A, b, 0.25,
                                                        recycle=rc, **kw))):
        r1 = solve(A1, None)
        cold = solve(A2, None)
        warm = solve(A2, r1.basis)
        for res in (cold, warm):
            x = np.asarray(res.x).reshape(-1)
            rel = np.linalg.norm(A2 @ x - b.reshape(-1)) / np.linalg.norm(b)
            assert bool(res.converged) and rel < 1e-4, pkg
        counts[pkg] = (int(cold.iterations), int(warm.iterations))
        assert counts[pkg][1] < counts[pkg][0], pkg
    assert all(abs(p - j) <= 1 for p, j in zip(counts["port"],
                                               counts["jax"])), counts


def test_converged_at_entry_returns_a_zero_basis():
    """A solve that converges before its first cycle returns the zero basis
    (j = 0), as the JAX package does."""
    A = np.eye(30, dtype=np.float32) * 2.0
    x_true = np.ones((10, 3), np.float32)
    b = (A @ x_true.reshape(-1)).reshape(10, 3)
    res = _dense(A, b, 1.0, x0=x_true, restart=8, tol=1e-5, abstol=1e-7,
                 return_basis=True)
    V, Z, R, cs, sn, j = res.basis
    assert res.iterations == 0 and j == 0
    assert not V.any() and not Z.any() and not R.any()


def _jax_dense(A, b, scale, **kw):
    Aj = jax.numpy.asarray(A)
    N = b.shape[0]
    return j_fgmres(lambda x: (Aj @ x.reshape(-1)).reshape(N, 3),
                    lambda r: r * scale, jax.numpy.asarray(b),
                    jax.numpy.zeros((N, 3), jax.numpy.float32), **kw)
