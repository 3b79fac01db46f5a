"""The port's packages export the names of their JAX counterparts: the top
level and the ``mesh``, ``models``, ``ops``, ``runtime``, ``app``,
``utils``, ``viz`` and ``parallel`` sub-packages have equal ``__all__``, and
every exported name resolves."""

import importlib

import pytest


@pytest.mark.parametrize("sub", ["", ".mesh", ".models", ".ops", ".runtime",
                                 ".app", ".utils", ".viz", ".parallel"])
def test_all_matches_the_jax_package(sub):
    ref = importlib.import_module("cfd2_tpu" + sub)
    port = importlib.import_module("cfd2_tpu_torch" + sub)
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_top_level_names():
    from cfd2_tpu_torch import BackwardsStep, multi_step
    from cfd2_tpu_torch.models.coupled import multi_step as ms
    assert multi_step is ms and BackwardsStep.__name__ == "BackwardsStep"
