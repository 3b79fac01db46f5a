"""Krylov recycling and Anderson mixing on the port's row-sharded step
(tests/torch_spatial_cases.py): ``fgmres_recycle=1`` (the basis carried
across the outers of a step), ``fgmres_recycle=2`` (also across two steps,
through ``step(..., krylov=)``, the basis holding each rank's rows) and
``anderson_depth=2``, over 2, 4 and 8 gloo ranks on the CPU, against the
JAX package's sharded step on 8 virtual devices and the port's one-process
step.

Tolerances and why: the outer and FGMRES counts equal on every rank and to
one process (the recycled projection and Anderson's normal equations are
summed across the ranks before any decision reads them); outers equal to
the JAX package's; u within 1e-5 after one step (tests/test_structured.py:
118-139's sharded-against-single bound) and within 1e-4 after the two
recycled steps (test_structured.py:162-209's two-step bound: the cross-rank
sums reduce in another order, and two steps of Krylov iteration amplify
it).
"""

import numpy as np
import pytest
import torch

import torch_spatial_cases as sc

torch.set_num_threads(1)

RUNS = {
    "fgmres_recycle=1": dict(config=dict(fgmres_recycle=1)),
    "fgmres_recycle=2": dict(config=dict(fgmres_recycle=2), steps=2),
    "anderson_depth=2": dict(config=dict(anderson_depth=2)),
}


@pytest.fixture(scope="module")
def runs():
    return sc.all_runs(RUNS)


@pytest.mark.parametrize("world,name", sc.cases(RUNS))
def test_sharded_krylov_option_matches_jax_and_one_process(runs, world,
                                                           name):
    got = sc.sharded(runs["ranks"], world, name)
    one, ref = runs["one"][name], runs["jax"][name]
    tol = 1e-5 if len(ref["outer"]) == 1 else 1e-4
    assert np.isfinite(got["u"]).all()
    assert got["outer"] == one["outer"] == ref["outer"]
    assert got["lin"] == one["lin"]
    assert np.abs(got["u"] - one["u"]).max() < tol
    assert np.abs(got["u"] - ref["u"]).max() < tol
