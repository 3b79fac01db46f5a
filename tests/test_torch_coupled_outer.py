"""The outer-loop options of the port's coupled solver against cfd2_tpu's,
from one warm state carried across (tests/torch_parity.py; its docstring
gives the tolerances and why): Anderson mixing, the extrapolated first
guess and the adaptive linear tolerance.

Anderson mixing is held to outer counts within 2 instead of equal: from the
fourth outer on, the residual differences it extrapolates are at the level
of the linear solves' rtol 1e-5 (measured: both packages' du agree to 1e-6
relative over the first three outers, to 1% at the fourth), so the two
trajectories cross the outer tolerance one or two outers apart while the
fields agree within the f32 bounds.  The mixing arithmetic itself is held
tightly by test_anderson_mix_matches_jax."""

import numpy as np
import pytest
import torch

from torch_parity import (ANDERSON, channel_mesh, outer_slack, pair,
                          steps_match, warm_jax_solver)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return channel_mesh()


@pytest.fixture(scope="module")
def warm(mesh):
    return warm_jax_solver(mesh)


@pytest.mark.parametrize("options", [
    ANDERSON,
    dict(extrapolate_guess=True),
    dict(adaptive_linear_tol=True),
], ids=["anderson", "extrapolate", "adaptive_tol"])
def test_option_steps_match_jax(mesh, warm, options):
    js, t = pair(warm, mesh, **options)
    steps_match(js, t, 2, outer_slack=outer_slack(options))


@pytest.mark.parametrize("it", [0, 1, 2, 3])
def test_anderson_mix_matches_jax(it):
    """One mixing step on the same seeded histories: the port's
    (``solve_ex`` on the device) against the JAX package's, within f32
    roundoff of the (D,) update."""
    import jax.numpy as jnp
    from cfd2_tpu.models.coupled import _anderson_mix as j_mix
    from cfd2_tpu.runtime.state import SolverConfig as JConfig
    from cfd2_tpu_torch.models.coupled import _anderson_mix as t_mix
    from cfd2_tpu_torch.runtime.state import SolverConfig as TConfig
    rng = np.random.default_rng(10 + it)
    D, m = 600, 2
    x = rng.standard_normal(D).astype(np.float32)
    g = x + 0.1 * rng.standard_normal(D).astype(np.float32)
    Gh = rng.standard_normal((m + 1, D)).astype(np.float32)
    Fh = 0.1 * rng.standard_normal((m + 1, D)).astype(np.float32)
    jx, jG, jF = j_mix(jnp.asarray(g), jnp.asarray(x), jnp.asarray(Gh),
                       jnp.asarray(Fh), jnp.int32(it),
                       JConfig(anderson_depth=m))
    tx, tG, tF = t_mix(torch.as_tensor(g), torch.as_tensor(x),
                       torch.as_tensor(Gh), torch.as_tensor(Fh), it,
                       TConfig(anderson_depth=m))
    np.testing.assert_array_equal(tG.numpy(), np.asarray(jG))
    np.testing.assert_array_equal(tF.numpy(), np.asarray(jF))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jx)).max())
    if it == 0:
        np.testing.assert_array_equal(tx.numpy(), g)
    else:
        assert not np.array_equal(tx.numpy(), g)   # the mix was taken
