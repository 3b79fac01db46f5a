"""Timesteps of the port's CoupledSolver on the block-ELL path against
cfd2_tpu's, in both step modes, from the same initial fields:

* block-Jacobi preconditioning (``precond_type=2``) on the backward-facing
  step of the JAX suite's test_block_jacobi_preconditioned_step and on a
  Delaunay mesh that has a banded map (precond_type=2 still takes the block
  path there);
* the Schur preconditioner with the aggregation AMG (``precond_type=1``) on
  a Delaunay mesh with its banded map removed (face-parallel fluxes, level-0
  V-cycle sums through ``mesh.gather``);
* ``precond_type=1`` on the 75-cell channel at min_cell 0.2, whose 5x15 grid
  is too small for the structured multigrid: the greedy fallback (itself
  too small, so the Chebyshev pressure relaxation) on the block path.

Tolerances and why (host cell order): outer counts equal, because the outer
exits compare max-diffs against 1e-5 / 1e-4 thresholds far from where f32
roundoff moves them; except that under block-Jacobi the two packages may end
one outer apart when that extra outer's solve takes 0 iterations and so
changes nothing: block-Jacobi solves run 150-500 FGMRES iterations, and the
pressure max-diff of the last working outer then lands within 0.5-2x of the
1e-4 exit threshold (measured on both cases: 2.0e-4 against 7.5e-5, 1.2e-4
against 7.6e-5), so one package exits there and the other one outer later
on an unchanged state; FGMRES iterations within +-2 per outer, because a solve
may end an iteration or two earlier or later when its residual estimate
crosses the target within roundoff; u and p within 1e-4 of their maxima,
as every solve stops at rtol 1e-5 and the relaxed updates carry ~10x that;
on the Delaunay mesh under block-Jacobi, p within 1e-3 (the bound of the
banded path's tests in test_torch_unstructured_coupled.py): with no coarse
correction the pressure's near-null constant mode (Dirichlet only at the
outlet) amplifies the solve error, measured 4.5e-4 after two steps while u
agrees to 1e-5.
"""

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.models.coupled import _basis_init
from cfd2_tpu_torch.ops import amg as tamg
from torch_parity import clear_banded_pair, steps_match

torch.set_num_threads(1)
TOL = dict(lin_per_outer=2, u_rel=1e-4, p_rel=1e-4)


def _mesh(mod, kind):
    if kind == "step":
        geo = mod.BackwardsStep(length=3.5, height_inlet=0.5,
                                height_outlet=1.0, step_x=0.5)
        return mod.generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.5, 1.0))
    geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    if kind == "delaunay":
        return mod.generate_delaunay_mesh(geo, 0.06, 0.06, 1.2, (3.0, 1.0),
                                          seed=2)
    return mod.generate_cut_cell_mesh(geo, 0.2, 0.2, 1.2, (3.0, 1.0))


def _start(s, mesh, precond, kind):
    s.set_precond_type(precond)
    s.set_alpha_u(0.9)
    s.set_alpha_p(0.9)
    if kind == "step":
        s.set_dt(0.001)
        s.set_u(np.full((mesh.num_cells, 2), [0.1, 0.0]))
        return
    s.set_dt(0.005 if kind == "delaunay" else 0.01)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    s.set_u(u0)


def _pair(kind, precond, unbanded=False):
    hj, ht = _mesh(jmesh, kind), _mesh(tmesh, kind)
    js, t = JSolver(hj), TSolver(ht, device="cpu")
    if unbanded:
        clear_banded_pair(js, t)
    _start(js, hj, precond, kind)
    _start(t, ht, precond, kind)
    return js, t


CASES = [("step", 2, False), ("delaunay", 2, False), ("delaunay", 1, True),
         ("channel", 1, False)]


@pytest.mark.parametrize("mode", ["fused", "host"])
@pytest.mark.parametrize("kind,precond,unbanded", CASES,
                         ids=["step-bj", "delaunay-bj", "unbanded-amg",
                              "tiny-grid-amg"])
def test_two_steps_match_jax(kind, precond, unbanded, mode):
    js, t = _pair(kind, precond, unbanded)
    tol = dict(TOL, noop_outer=precond == 2)
    if kind == "delaunay" and precond == 2:
        tol["p_rel"] = 1e-3
    steps_match(js, t, 2, mode=mode, **tol)


def test_path_choices():
    """Which path and hierarchy each case takes, in both packages."""
    _, t = _pair("channel", 1)
    assert t.mesh.structured and t.mesh.num_cells == 75
    assert tamg.build_structured_hierarchy(t.mesh) is None
    assert t._get_amg() is None            # greedy fallback: too small too
    _, t = _pair("delaunay", 1, unbanded=True)
    assert isinstance(t._get_amg(), tamg.AmgHierarchy)
    assert t.state.fluxes.shape == (t.mesh.num_faces,)


@pytest.mark.parametrize("recycle", [1, 2])
@pytest.mark.parametrize("kind,precond,unbanded", CASES[:3])
def test_block_path_has_no_recycled_basis(kind, precond, unbanded, recycle):
    """Recycling is off on the block path, as in the JAX package: no basis
    seed, so the solves start cold, and fgmres_recycle=2 carries nothing
    across steps."""
    from dataclasses import replace
    _, t = _pair(kind, precond, unbanded)
    t.config = replace(t.config, fgmres_recycle=recycle)
    assert _basis_init(t.mesh, t.state, t.config, t._get_amg()) is None
    t.step()
    assert t._krylov is None and int(t.state.outer_iters) > 0
    assert np.isfinite(t.get_u()).all()
