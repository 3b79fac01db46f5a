"""The bf16 options of SolverConfig on the port's row-sharded step
(tests/torch_spatial_cases.py): the bf16 Krylov basis, the bf16 Schur
preconditioner (whose shifts exchange bf16 rows, carried as f32 on the
wire) and the mixed-precision phase, over 2, 4 and 8 gloo ranks on the CPU,
against the JAX package's sharded step on 8 virtual devices and the port's
one-process step.

Tolerances and why: the outer and FGMRES counts equal on every rank and to
one process; u within 1e-5 of one process (tests/test_structured.py:118-139's
sharded-against-single bound; the ranks differ only in the order of their
sums); against the JAX package equal outers and u within 1e-5 as well (the
JAX test's own bound for its sharded step).
"""

import numpy as np
import pytest
import torch

import torch_spatial_cases as sc

torch.set_num_threads(1)

RUNS = {
    "fgmres_basis_bf16": dict(config=dict(fgmres_basis_bf16=True)),
    "precond_bf16": dict(config=dict(precond_bf16=True)),
    "fgmres_mixed_phase": dict(config=dict(fgmres_mixed_phase=True)),
}


@pytest.fixture(scope="module")
def runs():
    return sc.all_runs(RUNS)


@pytest.mark.parametrize("world,name", sc.cases(RUNS))
def test_sharded_bf16_option_matches_jax_and_one_process(runs, world, name):
    got = sc.sharded(runs["ranks"], world, name)
    one, ref = runs["one"][name], runs["jax"][name]
    assert np.isfinite(got["u"]).all()
    assert got["outer"] == one["outer"] == ref["outer"]
    assert got["lin"] == one["lin"]
    assert np.abs(got["u"] - one["u"]).max() < 1e-5
    assert np.abs(got["u"] - ref["u"]).max() < 1e-5


def test_jax_reference_process_reports_its_stderr(tmp_path):
    """A JAX reference process that fails raises with its exit code and the
    end of its stderr, so that an abort is readable in the test's report."""
    import subprocess
    import sys
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.stderr.write('boom: the "
         "reference aborted'); sys.exit(134)"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with pytest.raises(RuntimeError, match=r"exited with 134(.|\n)*boom: "
                       "the reference aborted"):
        sc.finish_jax_process(proc, str(tmp_path / "jax.pkl"), timeout=60)
