"""The rest of the port's ops/stencil_system.py against cfd2_tpu's, on the
coupled system both packages assemble from one state (tests/torch_parity.py)
and on seeded random inputs: cast_coeffs, the (N, 3) spmv and Schur
preconditioner, the red-black and ADI momentum predicts with their PCR line
solve, the preconditioner's mom_rbgs / mom_adi / bf16 forms, the pressure
operator, its preconditioned CG and the presolve's schur_guess, and
coarse_level_values2.

Tolerances: f32 results within 1e-5 of the JAX result's largest magnitude
(the two packages sum the same terms in other orders); those that iterate
(CG, the eight-sweep predicts, a V-cycle inside) within 1e-4; bf16 results
within 2e-2 (3 significant digits, rounded at other places: torch after
every op, XLA where its fusions end)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd2_tpu.ops import stencil_system as jst
from cfd2_tpu_torch.ops import stencil_system as tst
from torch_parity import assembled_systems

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def systems():
    jm, jss, tss, jh, th, x0 = assembled_systems()
    return dict(jss=jss, tss=tss, jps=jst.make_pressure_solve2(jh, jss),
                tps=tst.make_pressure_solve2(th, tss), jh=jh, th=th,
                n_sweeps=int(min(20 + np.sqrt(jm.num_cells) / 2.0, 200.0)))


def _close(got, ref, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_cast_coeffs_matches_jax(systems):
    jss, tss = systems["jss"], systems["tss"]
    j16 = jst.cast_coeffs(jss, jnp.bfloat16)
    t16 = tst.cast_coeffs(tss, torch.bfloat16)
    assert t16.grid == tss.grid and t16.rhs is tss.rhs
    for name in ("off_mom", "off_pu", "P_off2", "diag_u2", "diag_u_inv2",
                 "P_diag2", "diag_p_inv2"):
        got = getattr(t16, name)
        assert got.dtype == torch.bfloat16, name
        # Both round to nearest even: the same bf16 values.
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(getattr(j16, name), np.float32))


def test_interleaved_forms_match_jax(systems):
    """spmv and schur_precond on (N, 3) vectors."""
    jss, tss = systems["jss"], systems["tss"]
    n = tss.rhs.shape[0]
    x = _rand((n, 3), 1)
    _close(tst.spmv(tss, torch.as_tensor(x)), jst.spmv(jss, jnp.asarray(x)),
           1e-5)
    _close(tst.schur_precond(tss, torch.as_tensor(x), 1.2,
                             systems["n_sweeps"]),
           jst.schur_precond(jss, jnp.asarray(x), 1.2, systems["n_sweeps"]),
           1e-4)


@pytest.mark.parametrize("axis", [0, 1])
def test_pcr_line_solve(axis):
    """Truncated PCR against the JAX package's at 4 steps, and with enough
    steps for the line length (2^steps >= n) against a dense solve of each
    line."""
    ny, nx = 24, 37
    a, c = 0.3 * _rand((ny, nx), 2), 0.3 * _rand((ny, nx), 3)
    b = 2.0 + np.abs(_rand((ny, nx), 4))
    r = _rand((ny, nx), 5)
    # Boundary rows carry no coupling outside the line.
    idx = [slice(None)] * 2
    idx[axis] = 0
    a[tuple(idx)] = 0.0
    idx[axis] = -1
    c[tuple(idx)] = 0.0
    t = lambda v: torch.as_tensor(v)
    _close(tst.pcr_line_solve(t(a), t(b), t(c), t(r), axis),
           jst.pcr_line_solve(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                              jnp.asarray(r), axis), 1e-5)
    n = (ny, nx)[axis]
    got = tst.pcr_line_solve(t(a), t(b), t(c), t(r), axis,
                             steps=int(np.ceil(np.log2(n)))).numpy()
    am, bm, cm, rm, gm = (np.moveaxis(v, axis, 0) for v in
                          (a, b, c, r, got))
    for k in range(am.shape[1]):
        M = np.diag(bm[:, k].astype(np.float64)) \
            + np.diag(am[1:, k], -1) + np.diag(cm[:-1, k], 1)
        np.testing.assert_allclose(gm[:, k], np.linalg.solve(M, rm[:, k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("form", ["jacobi", "rbgs", "adi"])
def test_momentum_predicts_match_jax(systems, form):
    jss, tss = systems["jss"], systems["tss"]
    ny, nx = tss.grid
    ru, rv = _rand((ny, nx), 6), _rand((ny, nx), 7)
    if form == "adi":
        jz = jst._momentum_solve_adi(jss, jnp.asarray(ru), jnp.asarray(rv))
        tz = tst._momentum_solve_adi(tss, torch.as_tensor(ru),
                                     torch.as_tensor(rv))
    else:
        rb = form == "rbgs"
        jz = jst._momentum_solve(jss, jnp.asarray(ru), jnp.asarray(rv), 8,
                                 rbgs=rb)
        tz = tst._momentum_solve(tss, torch.as_tensor(ru),
                                 torch.as_tensor(rv), 8, rbgs=rb)
    for got, ref in zip(tz, jz):
        _close(got, ref, 1e-4)


@pytest.mark.parametrize("form", ["mom_rbgs", "mom_adi", "bf16"])
def test_schur_precond_forms_match_jax(systems, form):
    """The preconditioner with the AMG pressure block in its option forms;
    ``bf16`` is SolverConfig.precond_bf16's: cast coefficients, the
    pressure V-cycle in f32 between two casts."""
    jss, tss = systems["jss"], systems["tss"]
    jps, tps = systems["jps"], systems["tps"]
    ny, nx = tss.grid
    r = _rand((3, ny, nx), 8)
    kw = dict(mom_sweeps=8, mom_rbgs=form == "mom_rbgs",
              mom_adi=1 if form == "mom_adi" else 0)
    if form == "bf16":
        jss = jst.cast_coeffs(jss, jnp.bfloat16)
        tss = tst.cast_coeffs(tss, torch.bfloat16)
        jps16 = jps
        jps = lambda v: jps16(v.astype(jnp.float32)).astype(jnp.bfloat16)
        tps16 = tps
        tps = lambda v: tps16(v.float()).to(torch.bfloat16)
    jr = jnp.asarray(r).astype(jss.diag_u2.dtype)
    tr = torch.as_tensor(r).to(tss.diag_u2.dtype)
    ref = jst.schur_precond_planar(jss, jr, 1.2, systems["n_sweeps"],
                                   pressure_solve=jps, **kw)
    got = tst.schur_precond_planar(tss, tr, 1.2, systems["n_sweeps"],
                                   pressure_solve=tps, **kw)
    assert got.dtype == tr.dtype
    _close(got, ref, 2e-2 if form == "bf16" else 1e-4)


def test_pressure_cg_and_schur_guess_match_jax(systems):
    jss, tss = systems["jss"], systems["tss"]
    jps, tps = systems["jps"], systems["tps"]
    ny, nx = tss.grid
    x2 = _rand((ny, nx), 9)
    _close(tst.pressure_apply(tss, torch.as_tensor(x2)),
           jst.pressure_apply(jss, jnp.asarray(x2)), 1e-5)
    rhs = tst.pressure_apply(tss, torch.as_tensor(x2))
    got = tst.pcg_pressure(tss, rhs, tps, 8)
    _close(got, jst.pcg_pressure(jss, jnp.asarray(rhs.numpy()), jps, 8),
           1e-4)
    # Eight V-cycle-preconditioned CG iterations solve the pressure system.
    res = rhs - tst.pressure_apply(tss, got)
    assert float(res.norm()) < 1e-3 * float(rhs.norm())
    r = _rand((3, ny, nx), 10)
    for ps in ("amg", None):
        _close(tst.schur_guess(tss, torch.as_tensor(r), 1.2,
                               systems["n_sweeps"],
                               pressure_solve=tps if ps else None,
                               cg_iters=8, mom_sweeps=8),
               jst.schur_guess(jss, jnp.asarray(r), 1.2, systems["n_sweeps"],
                               pressure_solve=jps if ps else None,
                               cg_iters=8, mom_sweeps=8), 1e-4)


def test_coarse_level_values2_matches_jax(systems):
    jss, tss = systems["jss"], systems["tss"]
    tvals, _ = tst.coarse_level_values2(systems["th"], tss)
    jvals, _ = jst.coarse_level_values2(systems["jh"], jss)
    assert len(tvals) == len(jvals) > 0
    for (td, to), (jd, jo) in zip(tvals, jvals):
        _close(td, jd, 1e-5)
        _close(to, jo, 1e-5)
