"""The other entry points of the port's coupled solver against cfd2_tpu's,
from one warm state carried across (tests/torch_parity.py; its docstring
gives the tolerances and why): the host-controlled step (``mode="host"``,
also with Anderson mixing, whose outer counts are held within 2 for the
reason tests/test_torch_coupled_outer.py gives), ``run`` (multi_step),
multi_step_adaptive and the frozen stopped state."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from cfd2_tpu.models.coupled import multi_step_adaptive as j_adaptive
from cfd2_tpu_torch.models.coupled import multi_step
from cfd2_tpu_torch.models.coupled import multi_step_adaptive as t_adaptive
from torch_parity import (ANDERSON, assert_step_matches, channel_mesh,
                          outer_slack, pair, steps_match, warm_jax_solver)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return channel_mesh()


@pytest.fixture(scope="module")
def warm(mesh):
    return warm_jax_solver(mesh)


@pytest.mark.parametrize("options", [{}, ANDERSON],
                         ids=["default", "anderson"])
def test_host_mode_matches_jax(mesh, warm, options):
    """The host-controlled step: its own exits, coarse operators rebuilt
    every outer."""
    js, t = pair(warm, mesh, **options)
    steps_match(js, t, 2, mode="host", outer_slack=outer_slack(options))


def test_run_matches_jax(mesh, warm):
    """``run`` goes through multi_step: per-step metrics of both packages,
    and the fields after it."""
    js, t = pair(warm, mesh)
    jm, tm = js.run(2), t.run(2)
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k].dtype == np.asarray(jm[k]).dtype, k
        assert tm[k].shape == (2,), k
    np.testing.assert_array_equal(tm["outer_iters"], jm["outer_iters"])
    assert (np.abs(tm["linear_iters_total"] - jm["linear_iters_total"])
            <= jm["outer_iters"]).all()
    np.testing.assert_allclose(tm["time"], jm["time"], rtol=1e-6)
    np.testing.assert_allclose(tm["max_vel"], jm["max_vel"], rtol=1e-4)
    assert_step_matches(js, t, "run")
    assert float(t.params.dt_old) == float(t.params.dt)


def test_multi_step_adaptive_matches_jax(mesh, warm):
    """The CFL controller on the device: the same dt sequence, counts and
    fields."""
    js, t = pair(warm, mesh)
    jstate, jparams, jm = j_adaptive(js.mesh, js.state, js.params, js.config,
                                     2, amg=js._get_amg())
    tstate, tparams, tm = t_adaptive(t.mesh, t.state, t.params, t.config, 2,
                                     amg=t._get_amg())
    np.testing.assert_allclose(tm["dt"].numpy(), np.asarray(jm["dt"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(tm["outer_iters"].numpy(),
                                  np.asarray(jm["outer_iters"]))
    assert float(tparams.dt_old) == pytest.approx(float(jparams.dt_old))
    js.state, js.params, t.state, t.params = jstate, jparams, tstate, tparams
    assert_step_matches(js, t, "adaptive")


def test_stopped_state_is_frozen(mesh, warm):
    """multi_step takes no step once should_stop is set."""
    _, t = pair(warm, mesh)
    t.state = replace(t.state, should_stop=torch.tensor(True))
    state, m = multi_step(t.mesh, t.state, t.params, t.config, 2,
                          amg=t._get_amg())
    assert state is t.state
    np.testing.assert_array_equal(m["time"].numpy(),
                                  [float(t.state.time)] * 2)
