"""The RB-GS kernels' plain versions (what the wrappers run for CPU tensors)
against the JAX package's Pallas kernels in interpret mode, on the cases of
tests/test_pallas.py.  Tolerance 1e-5 max-abs on O(1) random data, as there.

The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py (and tests/test_torch_cuda.py where a GPU exists)."""

import numpy as np
import pytest
import torch

from cfd2_tpu.ops.amg import _GridOps as JGridOps
from cfd2_tpu.ops.pallas_stencil import fused_rbgs2, rbgs_half_sweep
from cfd2_tpu_torch.ops import _build
from cfd2_tpu_torch.ops import stencil_kernels as sk

torch.set_num_threads(1)
TOL = 1e-5


def _grid_system(ny, nx, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1, 2, (ny, nx)).astype(np.float32),
            (rng.standard_normal((4, ny, nx)) * 0.1).astype(np.float32),
            rng.standard_normal((ny, nx)).astype(np.float32),
            rng.standard_normal((ny, nx)).astype(np.float32))


T = torch.as_tensor


@pytest.mark.parametrize("ny,nx,sweeps,seed", [
    (37, 53, 1, 0), (37, 53, 2, 1), (16, 24, 1, 2), (300, 128, 1, 3)])
def test_leg_matches_pallas_fused(ny, nx, sweeps, seed):
    diag2, off2, x, b = _grid_system(ny, nx, seed)
    jx, jr = fused_rbgs2(x, diag2, off2, b, (ny, nx), sweeps=sweeps,
                         residual=True, interpret=True)
    tx, tr = sk.rbgs_leg_ref(T(x), T(diag2), T(off2), T(b), sweeps, True)
    assert float(np.abs(tx.numpy() - np.asarray(jx)).max()) < TOL
    assert float(np.abs(tr.numpy() - np.asarray(jr)).max()) < TOL
    tx2 = sk.rbgs_leg_ref(T(x), T(diag2), T(off2), T(b), sweeps, False)
    assert torch.equal(tx2, tx)


@pytest.mark.parametrize("ny,nx,seed", [(37, 53, 0), (16, 24, 1),
                                        (300, 128, 2)])
@pytest.mark.parametrize("parity", [0, 1])
def test_half_sweep_matches_pallas(ny, nx, seed, parity):
    """The port's half-sweep takes the (4, ny, nx) planes; the TPU kernel
    takes them moved to (n, 4)."""
    diag2, off2, x, b = _grid_system(ny, nx, seed)
    ref = rbgs_half_sweep(x.reshape(-1), diag2.reshape(-1),
                          np.moveaxis(off2.reshape(4, -1), 0, 1), b.reshape(-1),
                          parity, (ny, nx), interpret=True)
    got = sk.rbgs_half_sweep(T(x), T(diag2), T(off2), T(b), parity)
    assert got.shape == (ny, nx)
    got = got.numpy().reshape(-1)
    assert float(np.abs(got - np.asarray(ref)).max()) < TOL
    # Only the active colour moves.
    j, i = np.divmod(np.arange(ny * nx), nx)
    other = (j + i + parity) % 2 == 1
    np.testing.assert_array_equal(got[other], x.reshape(-1)[other])
    assert not np.allclose(got[~other], x.reshape(-1)[~other])


def test_half_sweep_pairs_equal_leg():
    """Two half-sweeps (parity 0 then 1) are one leg without residual."""
    ny, nx = 37, 53
    diag2, off2, x, b = (T(a) for a in _grid_system(ny, nx, 5))
    leg = sk.rbgs_leg_ref(x, diag2, off2, b, 2)
    got = sk.smooth_rbgs_half_sweeps(diag2, off2, x, b, sweeps=2)
    assert float((got - leg).abs().max()) < TOL
    assert not torch.equal(got, x)   # the caller's x is left as it was
    assert torch.equal(x, T(_grid_system(ny, nx, 5)[2]))


@pytest.mark.parametrize("ny,nx", [(10, 28), (19, 56), (5, 3)])
def test_half_sweep_in_place_equals_a_new_tensor(ny, nx):
    """in_place updates x itself and gives the values of a new tensor."""
    diag2, off2, x, b = (T(a) for a in _grid_system(ny, nx, 9))
    for parity in (0, 1):
        new = sk.rbgs_half_sweep(x, diag2, off2, b, parity)
        xi = x.clone()
        got = sk.rbgs_half_sweep(xi, diag2, off2, b, parity, in_place=True)
        assert got is xi and torch.equal(xi, new)


# Odd and even grids, among them level grids of the 589x1765 hierarchy.
FUSED_GRIDS = [(37, 53, 0), (16, 24, 1), (19, 56, 2), (10, 28, 3),
               (74, 111, 4), (5, 3, 5)]
# The fused forms repeat the unfused arithmetic in the same order on both
# sides; what is left is the order of the 2x2 sum and fused multiply-adds.
FUSED_TOL = 1e-6


def _coarse(ny, nx):
    return (ny + 1) // 2, (nx + 1) // 2


@pytest.mark.parametrize("ny,nx,seed", FUSED_GRIDS)
def test_fused_down_leg_matches_pallas_then_restrict(ny, nx, seed):
    """rbgs_leg(restrict_to=...) on the CPU against fused_rbgs2 in interpret
    mode followed by the JAX package's restrict2."""
    diag2, off2, x, b = _grid_system(ny, nx, seed)
    coarse = _coarse(ny, nx)
    jx, jr = fused_rbgs2(x, diag2, off2, b, (ny, nx), sweeps=1,
                         residual=True, interpret=True)
    jb = JGridOps((ny, nx)).restrict2(coarse, jr)
    tx, tb = sk.rbgs_leg(T(x), T(diag2), T(off2), T(b), restrict_to=coarse)
    assert tuple(tb.shape) == coarse
    scale = max(1.0, float(np.abs(np.asarray(jb)).max()))
    assert float(np.abs(tx.numpy() - np.asarray(jx)).max()) < FUSED_TOL * scale
    assert float(np.abs(tb.numpy() - np.asarray(jb)).max()) < FUSED_TOL * scale


@pytest.mark.parametrize("ny,nx,seed", FUSED_GRIDS)
def test_fused_up_leg_matches_prolong_then_pallas(ny, nx, seed):
    """rbgs_leg(add_prolong=...) on the CPU against the JAX package's
    prolong2 and add followed by fused_rbgs2 in interpret mode."""
    diag2, off2, x, b = _grid_system(ny, nx, seed)
    coarse = _coarse(ny, nx)
    xc = np.random.default_rng(100 + seed).standard_normal(coarse).astype(
        np.float32)
    jin = x + np.asarray(JGridOps((ny, nx)).prolong2(coarse, xc))
    jx = fused_rbgs2(jin, diag2, off2, b, (ny, nx), sweeps=1,
                     residual=False, interpret=True)
    tx = sk.rbgs_leg(T(x), T(diag2), T(off2), T(b), add_prolong=T(xc))
    scale = max(1.0, float(np.abs(np.asarray(jx)).max()))
    assert float(np.abs(tx.numpy() - np.asarray(jx)).max()) < FUSED_TOL * scale


@pytest.mark.parametrize("ny,nx", [(37, 53), (16, 24), (5, 3), (1, 1)])
def test_grid_transfers_match_the_jax_package(ny, nx):
    rng = np.random.default_rng(ny * nx)
    coarse = _coarse(ny, nx)
    r = rng.standard_normal((ny, nx)).astype(np.float32)
    xc = rng.standard_normal(coarse).astype(np.float32)
    ops = JGridOps((ny, nx))
    assert float(np.abs(sk.restrict2(T(r), coarse).numpy()
                        - np.asarray(ops.restrict2(coarse, r))).max()) < 1e-6
    np.testing.assert_array_equal(sk.prolong2(T(xc), (ny, nx)).numpy(),
                                  np.asarray(ops.prolong2(coarse, xc)))
    assert sk.coarse_grid_of((ny, nx)) == coarse


def test_fused_forms_equal_the_unfused_composition():
    """On the CPU the fused forms are the plain leg composed with the plain
    grid transfers, bit for bit: what structured_v_cycle computed before."""
    ny, nx = 37, 53
    diag2, off2, x, b = (T(a) for a in _grid_system(ny, nx, 6))
    coarse = _coarse(ny, nx)
    xc = T(np.random.default_rng(7).standard_normal(coarse).astype(
        np.float32))
    gx, gb = sk.rbgs_leg(x, diag2, off2, b, restrict_to=coarse)
    rx, rr = sk.rbgs_leg_ref(x, diag2, off2, b, 1, True)
    assert torch.equal(gx, rx) and torch.equal(gb, sk.restrict2(rr, coarse))
    up = sk.rbgs_leg(x, diag2, off2, b, add_prolong=xc)
    assert torch.equal(up, sk.rbgs_leg_ref(
        x + sk.prolong2(xc, (ny, nx)), diag2, off2, b, 1))


@pytest.mark.parametrize("kwargs", [
    dict(restrict_to=(8, 12), sweeps=2),
    dict(restrict_to=(8, 12), residual=True),
    dict(restrict_to=(8, 12), add_prolong=torch.zeros(8, 12)),
    dict(restrict_to=(8, 11)),
    dict(add_prolong=torch.zeros(9, 12)),
    dict(sweeps=0),
])
def test_leg_refuses_what_the_fused_forms_do_not_take(kwargs):
    diag2, off2, x, b = (T(a) for a in _grid_system(16, 24, 8))
    with pytest.raises(ValueError):
        sk.rbgs_leg(x, diag2, off2, b, **kwargs)


def test_wrappers_on_cpu_run_plain_version_without_build(monkeypatch):
    """A CPU tensor never reaches the build or the launch counter."""
    def no_build(name):
        raise AssertionError("the CUDA build was touched for CPU tensors")
    monkeypatch.setattr(_build, "load", no_build)
    before = dict(sk.LAUNCHES)
    diag2, off2, x, b = (T(a) for a in _grid_system(16, 24, 3))
    gx, gr = sk.rbgs_leg(x, diag2, off2, b, 1, residual=True)
    rx, rr = sk.rbgs_leg_ref(x, diag2, off2, b, 1, residual=True)
    assert torch.equal(gx, rx) and torch.equal(gr, rr)
    assert torch.equal(sk.rbgs_half_sweep(x, diag2, off2, b, 1),
                       sk.rbgs_half_sweep_ref(x, diag2, off2, b, 1))
    assert sk.LAUNCHES == before


def test_wrapper_rejects_other_devices():
    x = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError):
        sk.rbgs_leg(x, x, torch.zeros((4, 4, 4), device="meta"), x)


@pytest.mark.parametrize("raw,level", [(None, 2), ("", 2), ("2", 2),
                                       ("1", 1), ("0", 0)])
def test_smoother_level_on_cpu(monkeypatch, raw, level):
    if raw is None:
        monkeypatch.delenv("CFD2_PALLAS", raising=False)
    else:
        monkeypatch.setenv("CFD2_PALLAS", raw)
    assert sk.smoother_level(torch.device("cpu")) == level


@pytest.mark.parametrize("raw", ["0", "3", "on"])
def test_smoother_level_refusals_on_cuda(monkeypatch, raw):
    """CFD2_PALLAS=0 (plain stencils) never runs on the card; values other
    than 0/1/2 are refused everywhere."""
    monkeypatch.setenv("CFD2_PALLAS", raw)
    with pytest.raises(ValueError):
        sk.smoother_level(torch.device("cuda"))


@pytest.mark.parametrize("case", ["flat_off", "strided_off", "short_off",
                                  "x_double", "b_transposed", "planar"])
def test_half_sweep_launch_path_checks_before_it_builds(monkeypatch, case):
    """On the launch path (a CUDA tensor) the planar half-sweep refuses the
    TPU kernel's (n, 4) layout and any plane it cannot read as (ny, nx)
    float32 before it builds anything, and never reaches the plain version;
    what it takes goes on to the build."""
    monkeypatch.setattr(sk, "_cuda_or_cpu", lambda t: True)

    def no_build(name):
        raise RuntimeError("nvcc not found")

    def boom(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(sk, "rbgs_half_sweep_ref", boom)
    diag2, off2, x, b = (T(a) for a in _grid_system(6, 10, 4))
    args = {"flat_off": (x, diag2, off2.reshape(4, -1).T.contiguous(), b),
            "strided_off": (x, diag2, off2.transpose(1, 2).contiguous()
                            .transpose(1, 2), b),
            "short_off": (x, diag2, off2[:3], b),
            "x_double": (x.double(), diag2, off2, b),
            "b_transposed": (x, diag2, off2, b.T.contiguous().T),
            "planar": (x, diag2, off2, b)}[case]
    err = RuntimeError if case == "planar" else (ValueError, TypeError)
    with pytest.raises(err):
        sk.rbgs_half_sweep(*args, 0)
