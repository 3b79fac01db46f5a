"""The CUDA kernels against their plain versions on a GPU.  Marked ``cuda``;
skipped where no GPU is present (chip_smoke.py runs the same comparisons on
the card as part of its phases).  Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

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
