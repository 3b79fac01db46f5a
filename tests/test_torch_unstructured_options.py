"""The options that act on the banded path, on the Delaunay mesh of
tests/test_torch_unstructured_coupled.py, against cfd2_tpu from its inlet
start carried across.  A JAX compile of the banded step takes ~25 s on the
CPU, so the options run together in two configurations: the f32 solve and
outer options (float64 norms, the in-cycle exit, recycling across outers
and steps through CoupledSolver.step, the extrapolated guess, the adaptive
tolerance; the f32 tolerances of tests/torch_parity.py) and the bf16 basis
with recycling across outers (the bf16 bounds of
tests/test_torch_coupled_bf16.py).  Each option alone is held on the
structured path (tests/test_torch_coupled_*.py), and the code that carries
them is shared by both paths.  As in the JAX package, the bf16
preconditioner, the mixed phase, the presolve and the ADI predict do not
act on this path."""

import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from test_torch_unstructured_coupled import _mesh, _start
from torch_parity import BF16, pair, steps_match

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return _mesh(jmesh, "delaunay"), _mesh(tmesh, "delaunay")


@pytest.fixture(scope="module")
def start(meshes):
    jm = meshes[0]
    js = JSolver(jm)
    _start(js, jm, 1)
    return js


@pytest.mark.parametrize("options,steps,tol", [
    (dict(fgmres_f64_norms=True, fgmres_incycle_window=5, fgmres_recycle=2,
          extrapolate_guess=True, adaptive_linear_tol=True), 2, {}),
    (dict(fgmres_basis_bf16=True, fgmres_recycle=1), 1, BF16),
], ids=["f32_options", "bf16_basis_recycle1"])
def test_banded_options_step_match_jax(meshes, start, options, steps, tol):
    jm, tm = meshes
    js, t = pair(start, jm, port_mesh=tm, **options)
    assert not t.mesh.structured and t.mesh.banded
    steps_match(js, t, steps, **tol)
