"""The two-step comparison of tests/test_torch_unstructured_coupled.py (same
tolerances, stated there) on the other options of the banded path: the
Chebyshev pressure relaxation (precond_type=0) and second-order upwind
convection with its deferred correction through the packed six-component
gather."""

import pytest

from test_torch_unstructured_coupled import check_two_steps


@pytest.mark.parametrize("kind,precond,scheme", [
    ("delaunay", 0, 0), ("voronoi", 1, 1)],
    ids=["delaunay-chebyshev", "voronoi-amg-sou"])
def test_two_steps_match_jax(kind, precond, scheme):
    check_two_steps(kind, precond, scheme)
