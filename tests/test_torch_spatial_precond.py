"""The preconditioner options and the SIMPLE stepper on the port's
row-sharded step (tests/torch_spatial_cases.py): the ADI momentum predict
(``precond_mom_adi=1``: its y-direction line solves cross every rank
boundary), the structured multigrid under ``CFD2_PALLAS=1`` (the half-sweep
V-cycle; on the CPU its wrappers run their plain versions), block-Jacobi
(``precond_type=2``, the block-ELL path, cut to 10 outers by
``n_outer_correctors=1``) and one ``simple_step``, over 2, 4 and 8 gloo
ranks on the CPU, against the JAX package's sharded step on 8 virtual
devices (its plain stencils stand for every smoother level) and the port's
one-process step.  Also: ``precond_type=1`` on the aggregation fallback
(the structured grid's block path with the aggregation AMG, or with no
hierarchy) over 2 and 4 ranks against one process and the JAX package's
sharded step (tests/torch_spatial_cases.fallback_runs), and the entry points
that default to the card raise without one.

Tolerances and why: the counts equal on every rank; the coupled steps'
outer and FGMRES counts equal to one process and their outers to the JAX
package's, u within 1e-5 of both (tests/test_structured.py:118-139's
sharded-against-single bound).  The SIMPLE step always takes its 2
correctors; each of its 6 Krylov solves may end one iteration earlier or
later than one process's when its residual crosses the target within the
roundoff of the reordered sums (and within 2 of the JAX package's, the
bound of tests/test_torch_simple.py::test_simple_step); u within 1e-5 of one
process and within 1e-4 x max|u| of the JAX package (that test's bound).
"""

import numpy as np
import pytest
import torch

import torch_spatial_cases as sc
import torch_spatial_ranks as ranks
from cfd2_tpu_torch.ops import amg as tamg
from cfd2_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

RUNS = {
    "precond_mom_adi=1": dict(config=dict(precond_mom_adi=1)),
    "CFD2_PALLAS=1": dict(config=dict(precond_type=1), pallas="1"),
    "precond_type=2": dict(config=dict(precond_type=2,
                                       n_outer_correctors=1)),
}
SIMPLE = {"simple_step": dict(config={}, simple=True)}


@pytest.fixture(scope="module")
def runs():
    return sc.all_runs({**RUNS, **SIMPLE})


@pytest.mark.parametrize("world,name", sc.cases(RUNS))
def test_sharded_precond_option_matches_jax_and_one_process(runs, world,
                                                            name):
    got = sc.sharded(runs["ranks"], world, name)
    one, ref = runs["one"][name], runs["jax"][name]
    assert np.isfinite(got["u"]).all()
    assert got["outer"] == one["outer"] == ref["outer"]
    assert got["lin"] == one["lin"]
    assert np.abs(got["u"] - one["u"]).max() < 1e-5
    assert np.abs(got["u"] - ref["u"]).max() < 1e-5


@pytest.mark.parametrize("world", sc.WORLDS)
def test_sharded_simple_step_matches_jax_and_one_process(runs, world):
    got = sc.sharded(runs["ranks"], world, "simple_step")
    one, ref = runs["one"]["simple_step"], runs["jax"]["simple_step"]
    assert np.isfinite(got["u"]).all()
    assert got["outer"] == one["outer"] == ref["outer"] == [2]
    assert abs(got["lin"][0] - one["lin"][0]) <= 3 * 2
    assert abs(got["lin"][0] - ref["lin"][0]) <= 2 * 3 * 2
    assert np.abs(got["u"] - one["u"]).max() < 1e-5
    assert np.abs(got["u"] - ref["u"]).max() <= 1e-4 * np.abs(ref["u"]).max()


def test_entry_points_default_to_the_card(monkeypatch):
    """``run_ranks`` and ``build_hierarchy`` run on CUDA unless the caller
    names the CPU, and raise where there is no GPU (as ``resolve_device``
    does) before they start anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(ranks.fail_on, 2, args=(1,))
    mesh, _ = sc.channel()
    from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
    dm = encode_mesh(mesh, device="cpu")
    args = [dm.amg_host[k] for k in ("ck_neighbor", "ck_mask", "c_valid")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamg.build_hierarchy(*args)
    hier = tamg.build_hierarchy(*args, device="cpu")
    assert hier.levels and hier.levels[0].agg.device.type == "cpu"


@pytest.fixture(scope="module")
def fallback():
    return sc.fallback_runs()


@pytest.mark.parametrize("world", sc.FALLBACK_WORLDS)
@pytest.mark.parametrize("name", ["aggregation", "auto"])
def test_sharded_step_refuses_only_the_aggregation_fallback(fallback, world,
                                                            name):
    """``precond_type=1`` on a structured grid without the structured
    multigrid (tests/torch_spatial_cases.fallback_cases: the aggregation
    AMG passed in, or a grid too small for any hierarchy) is no longer
    refused on a row-sharded mesh: the block path's aggregation V-cycle runs
    replicated on every rank (one all-gather of the fine operator per outer
    and of the right-hand side per cycle), and the step takes one process's
    outers and FGMRES iterations and the JAX package's sharded step's, u
    within 1e-5 of both."""
    got = sc.sharded(fallback["ranks"], world, name)
    one, ref = fallback["one"][name], fallback["jax"][(world, name)]
    assert np.isfinite(got["u"]).all()
    assert got["outer"] == one["outer"] == ref["outer"]
    assert got["lin"] == one["lin"] == ref["lin"]
    assert np.abs(got["u"] - one["u"]).max() < 1e-5
    assert np.abs(got["u"] - ref["u"]).max() < 1e-5
    levels = one["levels"]
    assert (levels is None) == (name == "auto")
    allgathers = got["counts"][0]["allgathers"]
    assert allgathers > 0 if levels else allgathers == 0
