"""The bf16 options of SolverConfig on the port's structured path against
cfd2_tpu's, from one warm state carried across (tests/torch_parity.py): the
bf16 Krylov basis, the bf16 Schur preconditioner and the mixed-precision
phase.

Tolerances, the JAX package's own bf16-against-f32 bounds
(tests/test_solver_convergence.py, test_mixed_phase_solver_matches_f32):
outer counts within 1 and FGMRES iterations within 2 per outer, u within
5e-3 * max|u|, p within 5e-2 * max|p|.  bf16 rounds to 3 decimal digits, and
the two packages round at different places: torch after every elementwise
op, XLA on the CPU where its fusions end, so the bf16 operands differ in
their last bit here and there and the solves take different paths to the
same tolerance."""

import pytest
import torch

from torch_parity import (BF16, channel_mesh, pair, steps_match,
                          warm_jax_solver)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return channel_mesh()


@pytest.fixture(scope="module")
def warm(mesh):
    return warm_jax_solver(mesh)


@pytest.mark.parametrize("options", [
    dict(fgmres_basis_bf16=True),
    dict(precond_bf16=True),
    dict(fgmres_mixed_phase=True),
    dict(fgmres_basis_bf16=True, fgmres_recycle=1),
], ids=["basis", "precond", "mixed_phase", "basis_recycle1"])
def test_bf16_option_steps_match_jax(mesh, warm, options):
    js, t = pair(warm, mesh, **options)
    steps_match(js, t, 2, **BF16)
