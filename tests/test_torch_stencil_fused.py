"""The structured coupled system's stencils as the port dispatches them
(ops/stencil_system.py -> ops/stencil_kernels.py: the matvec, the Jacobi
momentum predict, the Schur right-hand side and the pressure gradient),
against the JAX package's cfd2_tpu.ops.stencil_system on the CPU, where the
wrappers run their plain versions; their row-sharded forms; and the
dispatch rule.  The CUDA kernels themselves are held bit for bit against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances and why: the port and the JAX package compute the same terms in
the same order, but XLA:CPU may contract a product and a sum into one fused
multiply-add where PyTorch rounds both, so f32 results agree to within a
few units of roundoff: the matvec, the Schur right-hand side, the gradient
and the one-sweep predict within 1e-5 of the JAX result's largest
magnitude; the eight-sweep predict and the preconditioner (eight sweeps, a
pressure solve) within 1e-4 (tests/test_torch_stencil_options.py's bounds).
The row-sharded forms are bit-equal to one process: they take the same
rows from their neighbours that the one-process shifts take from the grid.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_ranks as ranks
from cfd2_tpu.ops import stencil_system as jst
from cfd2_tpu_torch.ops import _build
from cfd2_tpu_torch.ops import stencil_kernels as sk
from cfd2_tpu_torch.ops import stencil_system as tst
from cfd2_tpu_torch.parallel.launch import run_ranks
from torch_parity import assembled_systems

torch.set_num_threads(1)

GRID = (48, 75)          # 3,600 cells
SHARD_GRID = (24, 37)    # blocks of 12 and 6 rows over 2 and 4 ranks
PLANES = ("off_mom", "off_up", "off_vp", "off_pu", "off_pv", "off_pp",
          "diag_u2", "diag_up2", "diag_vp2", "diag_pu2", "diag_pv2",
          "diag_pp2", "diag_u_inv2")


def _systems(grid, seed):
    """One seeded random system (tests/torch_spatial_ranks.stencil_planes)
    as both packages' StencilSystem, with a diagonally dominant scalar
    pressure operator for the Chebyshev sweeps; and the planes."""
    ny, nx = grid
    p = ranks.stencil_planes(grid, seed)
    rng = np.random.default_rng(seed + 1)
    p["P_off2"] = (-rng.uniform(0.1, 0.25, (4, ny, nx))).astype(np.float32)
    p["P_diag2"] = (1.0 + np.abs(p["P_off2"]).sum(axis=0)).astype(np.float32)
    p["diag_p_inv2"] = (1.0 / p["P_diag2"]).astype(np.float32)
    fields = PLANES + ("P_off2", "P_diag2", "diag_p_inv2")
    rhs = np.zeros((ny * nx, 3), np.float32)
    jss = jst.StencilSystem(grid=grid, rhs=jnp.asarray(rhs),
                            **{f: jnp.asarray(p[f]) for f in fields})
    tss = tst.StencilSystem(grid=grid, rhs=torch.as_tensor(rhs),
                            **{f: torch.as_tensor(p[f]) for f in fields})
    return jss, tss, p


@pytest.fixture(scope="module")
def random_systems():
    return _systems(GRID, 3)


@pytest.fixture(scope="module")
def assembled():
    _, jss, tss, jh, th, _ = assembled_systems()
    return dict(jss=jss, tss=tss, jps=jst.make_pressure_solve2(jh, jss),
                tps=tst.make_pressure_solve2(th, tss))


def _close(got, ref, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("which", ["random", "assembled"])
def test_spmv_planar_matches_jax(random_systems, assembled, which):
    if which == "random":
        jss, tss, _ = random_systems
    else:
        jss, tss = assembled["jss"], assembled["tss"]
    x = _rand((3, *tss.grid), 11)
    _close(tst.spmv_planar(tss, torch.as_tensor(x)),
           jst.spmv_planar(jss, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("sweeps", [1, 2, 8])
def test_dispatched_momentum_solve_matches_jax(random_systems, sweeps):
    jss, tss, _ = random_systems
    ru, rv = _rand(tss.grid, 12), _rand(tss.grid, 13)
    got = tst._momentum_solve(tss, torch.as_tensor(ru), torch.as_tensor(rv),
                              sweeps)
    ref = jst._momentum_solve(jss, jnp.asarray(ru), jnp.asarray(rv), sweeps)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5 if sweeps == 1 else 1e-4)


def test_schur_rhs_and_gradient_match_jax(random_systems):
    """The preconditioner's two middle stencils against the JAX package's
    inline forms (cfd2_tpu/ops/stencil_system.py:337-338, 345-347)."""
    jss, tss, _ = random_systems
    z, zp, rp = _rand((2, *tss.grid), 14), _rand(tss.grid, 15), \
        _rand(tss.grid, 16)
    jz = jnp.asarray(z)
    ref = jnp.asarray(rp) - jss.diag_pu2 * jz[0] - jss.diag_pv2 * jz[1] \
        - jst._dot4(jss.off_pu, jst._shifts2(jz[0])) \
        - jst._dot4(jss.off_pv, jst._shifts2(jz[1]))
    _close(tst._schur_rhs(tss, torch.as_tensor(rp), torch.as_tensor(z)),
           ref, 1e-5)
    sp = jst._shifts2(jnp.asarray(zp))
    ref = jnp.stack([jss.diag_up2 * zp + jst._dot4(jss.off_up, sp),
                     jss.diag_vp2 * zp + jst._dot4(jss.off_vp, sp)])
    _close(tst._gradient(tss, torch.as_tensor(zp)), ref, 1e-5)


@pytest.mark.parametrize("mom_sweeps", [1, 8])
@pytest.mark.parametrize("which", ["random", "assembled"])
def test_schur_precond_planar_matches_jax(random_systems, assembled,
                                          which, mom_sweeps):
    """The whole preconditioner (predict, Schur right-hand side, pressure
    solve, gradient, second predict): the Chebyshev sweeps on the random
    system, the structured V-cycle on the assembled one."""
    if which == "random":
        jss, tss, _ = random_systems
        jps = tps = None
    else:
        jss, tss = assembled["jss"], assembled["tss"]
        jps, tps = assembled["jps"], assembled["tps"]
    r = _rand((3, *tss.grid), 17)
    ref = jst.schur_precond_planar(jss, jnp.asarray(r), 1.2, 10,
                                   pressure_solve=jps, mom_sweeps=mom_sweeps)
    got = tst.schur_precond_planar(tss, torch.as_tensor(r), 1.2, 10,
                                   pressure_solve=tps, mom_sweeps=mom_sweeps)
    _close(got, ref, 1e-4)


def test_preconditioner_ends_with_the_second_predicts_difference(
        random_systems):
    """schur_precond_planar is, bit for bit, the plain sequence of its
    stencils: the predict, the Schur right-hand side, the Chebyshev sweeps,
    the gradient, the second predict and (z - that predict, z_p)."""
    _, tss, p = random_systems
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    mom = lambda r2: sk.momentum_jacobi_ref(r2, t["diag_u_inv2"],
                                            t["off_mom"], 8)
    r = torch.as_tensor(_rand((3, *tss.grid), 20))
    z = mom(r[:2])
    rhs = sk.schur_rhs_ref(r[2], z, t["diag_pu2"], t["diag_pv2"],
                           t["off_pu"], t["off_pv"])
    zp = tst.chebyshev_pressure_solve2(tss, rhs, 1.2, 4)
    g = sk.pressure_gradient_ref(zp, t["diag_up2"], t["diag_vp2"],
                                 t["off_up"], t["off_vp"])
    ref = torch.stack([z[0] - mom(g)[0], z[1] - mom(g)[1], zp])
    assert torch.equal(tst.schur_precond_planar(tss, r, 1.2, 4,
                                                mom_sweeps=8), ref)


def test_tile_limit_is_the_kernel_sources():
    """TILE_MAX_SWEEPS and MOM_THREADS are csrc/stencil.cu's constants of
    the same names."""
    src = (Path(sk.__file__).parent.parent / "csrc" / "stencil.cu")
    for name in ("TILE_MAX_SWEEPS", "MOM_THREADS"):
        found = re.findall(rf"constexpr int {name} = (\d+);", src.read_text())
        assert found == [str(getattr(sk, name))], name


def test_stencil_lib_refuses_another_tile_limit(monkeypatch):
    """A library that runs another number of sweeps in one launch than
    TILE_MAX_SWEEPS, or on other blocks than MOM_THREADS, is refused at
    load, before any launch."""
    class Lib:
        def __init__(self, limit, threads=sk.MOM_THREADS):
            self.stencil_tile_max_sweeps = lambda: limit
            self.stencil_mom_threads = lambda: threads

    monkeypatch.setattr(sk, "_constants_checked", False)
    monkeypatch.setattr(_build, "load", lambda name: Lib(10))
    with pytest.raises(RuntimeError, match="up to 10 sweeps"):
        sk._stencil_lib()
    monkeypatch.setattr(_build, "load",
                        lambda name: Lib(sk.TILE_MAX_SWEEPS, 256))
    with pytest.raises(RuntimeError, match="blocks of 256 threads"):
        sk._stencil_lib()
    lib = Lib(sk.TILE_MAX_SWEEPS)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    assert sk._stencil_lib() is lib


@pytest.mark.parametrize("ny,nx,sweeps,per_sm,bands,rows,row_blocks", [
    (589, 1765, 8, 2, 16, 37, 16),      # the 1M main path: 256 blocks
    (834, 2500, 12, 3, 24, 53, 16),     # the 2M case: 384 blocks
    (589, 1765, 8, 1, 16, 74, 8),
    (1, 1, 2, 2, 1, 1, 1),
    (1, 5000, 12, 1, 48, 1, 1),         # more bands than SMs: one row block
    (40, 3, 5, 4, 1, 1, 40),            # fewer rows than slots: a row a block
])
def test_momentum_plan_fills_the_card_in_one_wave(ny, nx, sweeps, per_sm,
                                                  bands, rows, row_blocks):
    """The streamed predict's plan on 132 SMs holding ``per_sm`` blocks
    each: bands of MOM_THREADS less the halo cover the columns, the rows
    are cut so that the blocks fill the slots once; the recomputed share
    is counted from the same cut."""
    plan = sk.momentum_plan(ny, nx, sweeps, 132, per_sm)
    h = sweeps - 1
    assert plan.band_cols == sk.MOM_THREADS - 2 * h
    assert (plan.bands, plan.tile_rows, plan.row_blocks) == (
        bands, rows, row_blocks)
    assert plan.bands * plan.band_cols >= nx > (plan.bands - 1) * plan.band_cols
    assert plan.row_blocks * plan.tile_rows >= ny
    assert plan.bands * plan.row_blocks <= max(132 * per_sm, plan.bands)
    streamed = sum(min(ny, (i + 1) * rows + h) - max(0, i * rows - h)
                   for i in range(row_blocks))
    assert plan.cells_per_output == pytest.approx(
        bands * sk.MOM_THREADS * streamed / (ny * nx))
    for bad in ((1, 132, 1), (sk.TILE_MAX_SWEEPS + 1, 132, 1), (8, 0, 1),
                (8, 132, 0)):
        with pytest.raises(ValueError):
            sk.momentum_plan(ny, nx, *bad)


@pytest.fixture(scope="module")
def sharded_runs():
    res = run_ranks(ranks.stencil_kernels_over, 4, device="cpu",
                    timeout=300, args=((2, 4), SHARD_GRID, 5))
    planes = {k: torch.as_tensor(v)
              for k, v in ranks.stencil_planes(SHARD_GRID, 5).items()}
    return res, ranks.stencil_kernels(planes)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_halo_operands_equal_one_process(sharded_runs, world):
    """Each wrapper on a rank's rows with the neighbours' rows as explicit
    ``below`` / ``above`` operands, concatenated over the ranks: bit-equal
    to the wrapper on the whole grid; one exchange per operand and per
    sweep after the first."""
    res, one = sharded_runs
    for key, ref in one.items():
        got = np.concatenate([r[world][key] for r in res[:world]],
                             axis=ref.ndim - 2)
        np.testing.assert_array_equal(got, ref, err_msg=key)
    # spmv, schur_rhs, gradient: one each; momentum at 1, 2, 8 sweeps: one
    # per sweep after the first, 0 + 1 + 7.
    for r in res[:world]:
        assert r[world]["exchanges"] == 3 + (0 + 1 + 7)


@pytest.mark.parametrize("sweeps,sharded,launches", [
    (1, False, 1), (2, False, 1), (8, False, 1), (12, False, 1),
    (13, False, 13), (20, False, 20), (1, True, 1), (2, True, 2),
    (8, True, 8)])
def test_momentum_launches(sweeps, sharded, launches):
    assert sk.momentum_launches(sweeps, sharded) == launches


def test_momentum_launches_refuse_no_sweeps():
    with pytest.raises(ValueError):
        sk.momentum_launches(0, False)
    with pytest.raises(ValueError):
        sk.momentum_jacobi(torch.zeros(2, 3, 4), torch.ones(3, 4),
                           torch.zeros(4, 3, 4), 0)


def test_cpu_tensors_take_the_plain_versions(monkeypatch, random_systems):
    """On the CPU the solver's operators never reach a build or a launch
    counter."""
    def no_build(name):
        raise AssertionError("the CUDA build was touched for CPU tensors")
    monkeypatch.setattr(_build, "load", no_build)
    _, tss, _ = random_systems
    sk.reset_launches()
    r = torch.as_tensor(_rand((3, *tss.grid), 18))
    tst.spmv_planar(tss, r)
    tst.schur_precond_planar(tss, r, 1.2, 4, mom_sweeps=8)
    tst._momentum_solve(tss, r[0], r[1], 8)
    assert all(v == 0 for v in sk.LAUNCHES.values())


def _launch_path(monkeypatch):
    """Every tensor counts as a CUDA tensor, the build fails as it does
    without nvcc, and the plain versions must not be reached."""
    monkeypatch.setattr(sk, "_cuda_or_cpu", lambda t: True)

    def no_build(name):
        raise RuntimeError("nvcc not found")

    def boom(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(_build, "load", no_build)
    for name in ("coupled_spmv_ref", "momentum_jacobi_ref", "schur_rhs_ref",
                 "pressure_gradient_ref"):
        monkeypatch.setattr(sk, name, boom)


def _wrapper_calls(t, case):
    """Each wrapper's arguments with the fault of ``case`` in one of them."""
    bad = {
        "bf16": lambda a: a.to(torch.bfloat16),
        "non_contiguous": lambda a: torch.stack([a, a], dim=-1)[..., 0],
        "mis_shaped": lambda a: a[..., :-1],
        "ok": lambda a: a,
    }[case]
    offs = tuple(t[k] for k in PLANES[:6])
    diags = tuple(t[k] for k in PLANES[6:12])
    ny, nx = t["zp"].shape
    return {
        "coupled_spmv": lambda: sk.coupled_spmv(
            t["x"], offs[:2] + (bad(offs[2]),) + offs[3:], diags),
        "momentum_jacobi": lambda: sk.momentum_jacobi(
            t["r"][:2].contiguous(), bad(t["diag_u_inv2"]), t["off_mom"], 8),
        "schur_rhs": lambda: sk.schur_rhs(
            t["r"][2], t["z"], t["diag_pu2"], bad(t["diag_pv2"]),
            t["off_pu"], t["off_pv"]),
        "pressure_gradient": lambda: sk.pressure_gradient(
            t["zp"], t["diag_up2"], t["diag_vp2"], t["off_up"],
            t["off_vp"], bad(torch.zeros(1, nx)), torch.zeros(1, nx)),
    }


@pytest.mark.parametrize("case", ["bf16", "non_contiguous", "mis_shaped",
                                  "ok"])
@pytest.mark.parametrize("name", ["coupled_spmv", "momentum_jacobi",
                                  "schur_rhs", "pressure_gradient"])
def test_launch_path_refuses_what_the_kernel_does_not_take(
        monkeypatch, random_systems, name, case):
    """On the launch path (a CUDA tensor) each wrapper refuses, with an
    error naming the operand, a bf16, non-contiguous or mis-shaped operand
    before it builds anything, and never falls back to its plain version;
    what it takes goes on to the build (which fails here, as it does
    without nvcc)."""
    _launch_path(monkeypatch)
    _, _, p = random_systems
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    call = _wrapper_calls(t, case)[name]
    if case == "ok":
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
        return
    err = TypeError if case == "bf16" else ValueError
    with pytest.raises(err, match=r"^(offs\[2\]|dinv|d_pv|below) "):
        call()


def test_launch_path_refuses_one_halo_row(monkeypatch, random_systems):
    _launch_path(monkeypatch)
    _, _, p = random_systems
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="together"):
        sk.schur_rhs(t["r"][2], t["z"], t["diag_pu2"], t["diag_pv2"],
                     t["off_pu"], t["off_pv"], below=t["z"][:, :1])


def test_bf16_form_keeps_its_plain_ops_on_the_card(monkeypatch,
                                                   random_systems):
    """The bf16 preconditioner (a cast_coeffs system) takes the plain
    versions by its explicit branch even where every tensor is on the
    card, so it never reaches a kernel, which takes float32 only; the same
    call in float32 goes to the kernels."""
    _, tss, p = random_systems
    monkeypatch.setattr(sk, "_cuda_or_cpu", lambda t: True)

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)
    r = torch.as_tensor(_rand((3, *tss.grid), 19))
    ss16 = tst.cast_coeffs(tss, torch.bfloat16)
    got = tst.schur_precond_planar(ss16, r.to(torch.bfloat16), 1.2, 4,
                                   mom_sweeps=8)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    with pytest.raises(RuntimeError, match="nvcc"):
        tst.schur_precond_planar(tss, r, 1.2, 4, mom_sweeps=8)
