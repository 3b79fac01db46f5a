"""cfd2_tpu_torch.runtime.state against cfd2_tpu.runtime.state."""

import dataclasses

import numpy as np
import pytest
import torch

from cfd2_tpu.runtime import state as jstate
from cfd2_tpu_torch.runtime import state as tstate

torch.set_num_threads(1)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_solver_config_fields_and_defaults_equal():
    assert _fields(tstate.SolverConfig) == _fields(jstate.SolverConfig)


@pytest.mark.parametrize("n", [1, 1000, 100_000, 996_558, 1_500_000,
                               3_000_000])
def test_solver_config_size_rules_equal(n):
    for kw in ({}, {"pressure_iters": 7, "precond_vcycles": 2,
                    "precond_mom_sweeps": 3}):
        a, b = jstate.SolverConfig(**kw), tstate.SolverConfig(**kw)
        assert a.pressure_sweeps(n) == b.pressure_sweeps(n)
        assert a.pressure_vcycles(n) == b.pressure_vcycles(n)
        assert a.mom_sweeps(n) == b.mom_sweeps(n)
        assert a.cycle_opts() == b.cycle_opts()


def test_ids_equal():
    for name in ("SCHEME_UPWIND", "SCHEME_SECOND_ORDER_UPWIND", "SCHEME_QUICK",
                 "TIME_EULER", "TIME_BDF2", "PRECOND_JACOBI", "PRECOND_AMG",
                 "PRECOND_BLOCK_JACOBI"):
        assert getattr(tstate, name) == getattr(jstate, name)


def test_params_and_state_field_names_equal():
    assert [f.name for f in dataclasses.fields(tstate.SolverParams)] == \
        [f.name for f in dataclasses.fields(jstate.SolverParams)]
    assert [f.name for f in dataclasses.fields(tstate.SolverState)] == \
        [f.name for f in dataclasses.fields(jstate.SolverState)]


def test_params_defaults_equal():
    a = jstate.SolverParams.default()
    b = tstate.SolverParams.default(device="cpu")
    for f in tstate.PARAMS_FIELDS:
        ta = getattr(b, f)
        assert ta.dtype == torch.float32 and ta.dim() == 0
        assert float(ta) == float(np.asarray(getattr(a, f)))
