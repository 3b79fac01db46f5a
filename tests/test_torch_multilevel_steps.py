"""Two timesteps of the port's CoupledSolver on the refined quadtree mesh of
tests/test_torch_multilevel.py (multilevel banded path: ELL system, banded
kernels) with the fine-grid-embedded multigrid (``precond_type=1``), in
both step modes, against cfd2_tpu from the inlet-column start.

On this path the JAX package's host-controlled step does the fused step's
arithmetic, so the port's two modes are both held to one recorded JAX fused
run (an interpret-mode Pallas step takes ~70 s to compile on the CPU and a
host-mode outer ~120 s).  In cfd2_tpu/models/coupled.py the two modes differ
only in what this path never takes: the fused step's frozen coarse
operators (`step`, :444-465) exist for the structured stencil path and for
an `AmgHierarchy`, not for the `MultilevelAmg`; its first-outer pressure
presolve (`presolve_ok`, :165-198) sits in the stencil branch of
`_assemble_and_solve`, which a multilevel mesh does not take
(`_use_stencil_path`, :84-93: not structured), and
`presolve_pressure_iters` is 0 by default; its Krylov recycling
(:476-477) needs `fgmres_recycle` > 0 (default 0).  Otherwise both call
`_assemble_and_solve` with the same arguments (`step`'s loop body,
:487-520, and `outer_iteration`, :590-640) and test the same outer exits
(`step`'s `cond` and `body`, :483-563, and `step_host`, :643-694).

Tolerances and why (host cell order): outer counts equal (the exits compare
max-diffs against 1e-5 / 1e-4 thresholds far from where f32 roundoff moves
them); FGMRES iterations within +-2 per outer (a solve may end an iteration
or two apart when its residual estimate crosses the target within
roundoff); u and p within 1e-4 of their maxima (solves stop at rtol 1e-5,
the relaxed updates carry ~10x that)."""

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.ops.amg import MultilevelAmg
from torch_parity import hold_to_record, record_steps

torch.set_num_threads(1)


def _host(mod):
    geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return mod.generate_cut_cell_mesh(geo, 0.02, 0.04, 1.2, (3.0, 1.0))


def _start(s, mesh, precond):
    s.set_dt(0.01)
    s.set_precond_type(precond)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    s.set_u(u0)


def jax_record(precond):
    """Two fused JAX steps from the inlet-column start, recorded."""
    h = _host(jmesh)
    jsol = JSolver(h)
    _start(jsol, h, precond)
    return record_steps(jsol, 2)


def port_solver(precond):
    h = _host(tmesh)
    t = TSolver(h, device="cpu")
    _start(t, h, precond)
    assert t.mesh.multilevel and t.mesh.banded
    return t


@pytest.fixture(scope="module")
def record():
    return jax_record(1)


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_two_steps_match_jax(record, mode):
    t = port_solver(1)
    assert isinstance(t._get_amg(), MultilevelAmg)
    hold_to_record(t, record, mode=mode)
