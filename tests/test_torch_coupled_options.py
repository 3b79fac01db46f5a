"""The solve options of SolverConfig on the port's structured path against
cfd2_tpu's, from one warm state carried across (tests/torch_parity.py; its
docstring gives the tolerances and why): float64 norms, the in-cycle exit,
Krylov recycling across outers (1) and across steps (2, through
CoupledSolver.step), the ADI momentum predict and, from an impulsive start,
the first-outer pressure presolve.

float64 norms differ on purpose: the port accumulates them in float64, the
JAX package (without jax_enable_x64) silently in float32; on this case the
two stay within the f32 tolerances."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from torch_parity import (assert_step_matches, channel_mesh, pair,
                          steps_match, warm_jax_solver)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return channel_mesh()


@pytest.fixture(scope="module")
def warm(mesh):
    return warm_jax_solver(mesh)


@pytest.mark.parametrize("options", [
    dict(fgmres_f64_norms=True),
    dict(fgmres_incycle_window=5),
    dict(fgmres_recycle=1),
    dict(fgmres_recycle=2),
    dict(precond_mom_adi=1),
], ids=["f64_norms", "incycle", "recycle1", "recycle2", "mom_adi"])
def test_option_steps_match_jax(mesh, warm, options):
    js, t = pair(warm, mesh, **options)
    steps_match(js, t, 2)
    if options.get("fgmres_recycle") == 2:
        # The basis crossed the step boundary on both sides.
        # The basis crossed the step boundary on both sides, with the same
        # column count (0 where the last outer converged before its first
        # cycle: the zero basis, on both sides).
        assert t._krylov[5] == int(js._krylov[5])


def _impulsive(s, mesh, presolve_iters):
    """The JAX package's presolve case (tests/test_presolve.py): an
    impulsive start, u = 1 in every cell."""
    s.set_dt(0.005)
    s.set_precond_type(1)
    s.config = replace(s.config, presolve_pressure_iters=presolve_iters)
    u0 = np.zeros((mesh.num_cells, 2), np.float32)
    u0[:, 0] = 1.0
    s.set_u(u0)
    return s


def test_presolve_matches_jax_and_fires(mesh):
    """From an impulsive start the first outer's residual is far above the
    gate: the presolve fires (the port's step no longer equals the same step
    without it) and both packages agree."""
    js = _impulsive(JSolver(mesh), mesh, 8)
    t = _impulsive(TSolver(mesh, device="cpu"), mesh, 8)
    plain = _impulsive(TSolver(mesh, device="cpu"), mesh, 0)
    js.step()
    t.step()
    plain.step()
    assert_step_matches(js, t, "presolve")
    assert not np.array_equal(t.get_u(), plain.get_u())
