"""The CUDA kernels against their plain versions on a GPU.  Marked ``cuda``;
skipped where no GPU is present (chip_smoke.py runs the same comparisons on
the card as part of its phases).  Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from cfd2_tpu_torch.ops import banded_kernels as bk
from cfd2_tpu_torch.ops import stencil_kernels as sk

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _grid_system(ny, nx, seed, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return (t(rng.uniform(1, 2, (ny, nx))),
            t(rng.standard_normal((4, ny, nx)) * 0.1),
            t(rng.standard_normal((ny, nx))),
            t(rng.standard_normal((ny, nx))))


@pytest.mark.parametrize("ny,nx,sweeps", [(37, 53, 1), (37, 53, 2),
                                          (16, 24, 1), (300, 128, 1)])
def test_leg_kernel_matches_plain(cuda, ny, nx, sweeps):
    diag2, off2, x, b = _grid_system(ny, nx, 0, cuda)
    before = sk.LAUNCHES["rbgs_leg"]
    gx, gr = sk.rbgs_leg(x, diag2, off2, b, sweeps, residual=True)
    rx, rr = sk.rbgs_leg_ref(x, diag2, off2, b, sweeps, residual=True)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["rbgs_leg"] == before + 1
    assert float((gx - rx).abs().max()) <= TOL
    assert float((gr - rr).abs().max()) <= TOL


@pytest.mark.parametrize("parity", [0, 1])
def test_half_sweep_kernel_matches_plain(cuda, parity):
    ny, nx = 37, 53
    diag2, off2, x, b = _grid_system(ny, nx, 1, cuda)
    args = (x.reshape(-1), diag2.reshape(-1),
            off2.reshape(4, -1).T.contiguous(), b.reshape(-1), parity,
            (ny, nx))
    got = sk.rbgs_half_sweep(*args)
    ref = sk.rbgs_half_sweep_ref(*args)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= TOL


def test_wrapper_refuses_bad_input(cuda):
    diag2, off2, x, b = _grid_system(16, 24, 2, cuda)
    with pytest.raises(TypeError):
        sk.rbgs_leg(x.double(), diag2, off2, b)
    with pytest.raises(ValueError):
        sk.rbgs_leg(x.T, diag2, off2, b)


# ----------------------------------------------------------------------
# The banded kernels (csrc/banded.cu).

BANDED_MAPS = [(5000, 5000, 1), (5000, 5000, 3), (4096, 4096, 9),
               (5000, 700, 1), (700, 5000, 17)]
DOT_FORMS = {
    "spmv": (3, 6, (((0, 0), (1, 2)), ((0, 1), (2, 2)),
                    ((3, 0), (4, 1), (5, 2)))),
    "mom2": (2, 1, (((0, 0),), ((0, 1),))),
    "schur_rhs": (2, 2, (((0, 0), (1, 1)),)),
    "grad": (1, 2, (((0, 0),), ((1, 0),))),
    "scalar": (1, 1, (((0, 0),),)),
}


def _band_map(M, n_src, K, seed, device):
    rng = np.random.default_rng(seed)
    centre = (np.arange(M) * (n_src / M)).astype(np.int64)[:, None]
    idx = centre + rng.integers(-300, 301, (M, K))
    idx = np.sort(np.clip(idx, 0, n_src - 1), axis=1)
    return torch.as_tensor(idx.astype(np.int32), device=device)


def _rand(shape, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32),
        device=device)


@pytest.mark.parametrize("tail", [None, 2, 6])
@pytest.mark.parametrize("M,n_src,K", BANDED_MAPS)
def test_gather_kernel_matches_plain(cuda, M, n_src, K, tail):
    idx = _band_map(M, n_src, K, 0, cuda)
    x = _rand((n_src,) if tail is None else (n_src, tail), 1, cuda)
    before = bk.LAUNCHES["banded_gather"]
    got = bk.banded_gather(x, idx)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["banded_gather"] == before + 1
    assert torch.equal(got, bk.banded_gather_ref(x, idx))


@pytest.mark.parametrize("form", list(DOT_FORMS))
@pytest.mark.parametrize("M,n_src,K", BANDED_MAPS)
def test_dot_kernel_matches_plain(cuda, M, n_src, K, form):
    n_x, n_off, prods = DOT_FORMS[form]
    idx = _band_map(M, n_src, K, 2, cuda)
    xs = [_rand((n_src,), 3 + c, cuda) for c in range(n_x)]
    offs = [_rand((M, K), 10 + p, cuda, 0.3) for p in range(n_off)]
    before = bk.LAUNCHES["banded_dot"]
    got = bk.banded_dot(xs, offs, idx, prods)
    ref = bk.banded_dot_ref(xs, offs, idx, prods)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["banded_dot"] == before + 1
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= TOL


@pytest.mark.parametrize("sweeps", [1, 3, 8])
@pytest.mark.parametrize("K,cap", [(3, None), (9, None), (9, 8)])
def test_sweeps_kernel_matches_plain(cuda, K, cap, sweeps):
    n = 4096
    idx = _band_map(n, n, K, 4, cuda)
    rs = [_rand((n,), 5 + c, cuda) for c in range(2)]
    dinv = 1.0 / (1.0 + _rand((n,), 7, cuda).abs())
    off = _rand((n, K), 8, cuda, 0.5 / K)
    before = bk.LAUNCHES["banded_jacobi_sweeps"]
    got = bk.banded_jacobi_sweeps(rs, dinv, off, idx, sweeps, k_cap=cap)
    ref = bk.banded_jacobi_sweeps_ref(rs, dinv, off, idx, sweeps, k_cap=cap)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["banded_jacobi_sweeps"] == before + 1
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= TOL


def test_banded_wrappers_refuse_bad_input(cuda):
    idx = _band_map(256, 256, 3, 9, cuda)
    x = _rand((256,), 10, cuda)
    off = _rand((256, 3), 11, cuda)
    with pytest.raises(TypeError):
        bk.banded_gather(x.double(), idx)
    with pytest.raises(TypeError):
        bk.banded_gather(x, idx.long())
    with pytest.raises(ValueError):
        bk.banded_dot((x,), (off.T.contiguous().T,), idx, (((0, 0),),))
    with pytest.raises(ValueError):
        bk.banded_dot((x,), (off,), idx, (((1, 0),),))
    with pytest.raises(ValueError):
        bk.banded_jacobi_sweeps((x,), x, off, idx, 3, k_cap=4)
