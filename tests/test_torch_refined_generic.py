"""A refined quadtree mesh beyond the multilevel layout's 6x rule takes the
generic banded path in both packages: channel with obstacle at min_cell
0.005 / max_cell 0.04 (19,235 cells, K = 7), two steps of the aggregation
AMG (precond_type=1) from the inlet column with the relaxation of
tests/test_torch_unstructured_coupled.py, at two time steps.

Tolerances and why (host cell order): outer counts equal, FGMRES iterations
within +-2 per outer and p within 1e-3 of its maximum, as stated in
tests/test_torch_unstructured_coupled.py; u within 1e-4 of its maximum at
that file's dt 0.005, and within 2e-4 at dt 0.01 (CFL ~2 on the finest
cells), for this measured reason (CPU; ``JAX_PLATFORMS=cpu PYTHONPATH=.
python tests/test_torch_refined_generic.py`` prints the table):

* at dt 0.01 the second step's solves stop where one FGMRES iteration
  still moves u by ~1e-4 of its maximum, and which iteration crosses the
  exit threshold is decided within roundoff.  The port against itself, on
  1 and on 2 CPU threads (another summation order in torch's reductions,
  nothing else changed), ends that step one iteration apart (102 / 103)
  and 1.36e-4 off.  Against the JAX package (100 iterations) the port is
  5.9e-6 off on 1 thread, as this test runs it, and 1.32e-4 on 2.
* the gap is the solve tolerance's: at ``fgmres_tol`` 1e-6 the two
  packages agree to 1.4e-5 on the second step.

So a 1e-4 bound at dt 0.01 would pass or fail with the summation order;
2e-4 is the roundoff-driven move with a margin of 1.5, the move that the
+-2 iterations per outer already allow for."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.ops.amg import AmgHierarchy
from cfd2_tpu_torch.runtime.device_mesh import _multilevel_layout
from test_torch_unstructured_coupled import _start
from torch_parity import steps_match

torch.set_num_threads(1)


def _host(mod):
    geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return mod.generate_cut_cell_mesh(geo, 0.005, 0.04, 1.2, (3.0, 1.0))


def _solver(pkg, dt, tol=None):
    """One package's solver at ``dt`` (and ``fgmres_tol`` ``tol``) from the
    inlet-column start, and its host mesh."""
    h = _host(jmesh if pkg == "jax" else tmesh)
    s = JSolver(h) if pkg == "jax" else TSolver(h, device="cpu")
    _start(s, h, 1)
    s.set_dt(dt)
    if tol is not None:
        s.config = replace(s.config, fgmres_tol=tol)
    return s, h


@pytest.mark.parametrize("dt,u_rel", [(0.005, 1e-4), (0.01, 2e-4)])
def test_two_steps_match_jax(dt, u_rel):
    (js, _), (t, ht) = _solver("jax", dt), _solver("port", dt)
    assert ht.num_cells == 19235 and ht.cell_level.max() > ht.cell_level.min()
    assert _multilevel_layout(ht) is None          # beyond the 6x rule
    assert not t.mesh.multilevel and not t.mesh.structured and t.mesh.banded
    assert t.mesh.max_faces == 7
    assert isinstance(t._get_amg(), AmgHierarchy)
    steps_match(js, t, 2, lin_per_outer=2, u_rel=u_rel)


def _sensitivity():
    """The table behind the dt-0.01 bound: per step, outers, FGMRES
    iterations and max|du| / max|u| between runs at dt 0.01: the JAX
    package, the port on 1 and on 2 CPU threads (another summation order
    in torch's reductions), and both at ``fgmres_tol`` 1e-6."""
    def run(pkg, threads, tol=None):
        torch.set_num_threads(threads)
        s = _solver(pkg, 0.01, tol)[0]
        rows = []
        for _ in range(2):
            s.step()
            rows.append((int(s.state.outer_iters),
                         int(s.state.linear_iters_total), s.get_u()))
        return rows

    runs = {("jax", 1e-5): run("jax", 1),
            ("port 1 thread", 1e-5): run("port", 1),
            ("port 2 threads", 1e-5): run("port", 2),
            ("jax", 1e-6): run("jax", 1, 1e-6),
            ("port 1 thread", 1e-6): run("port", 1, 1e-6)}
    for a, b in ((("jax", 1e-5), ("port 1 thread", 1e-5)),
                 (("jax", 1e-5), ("port 2 threads", 1e-5)),
                 (("port 1 thread", 1e-5), ("port 2 threads", 1e-5)),
                 (("jax", 1e-6), ("port 1 thread", 1e-6))):
        for i, (ra, rb) in enumerate(zip(runs[a], runs[b])):
            du = np.abs(ra[2] - rb[2]).max() / np.abs(ra[2]).max()
            print(f"{a} vs {b} step {i}: outers {ra[0]} / {rb[0]}, FGMRES "
                  f"{ra[1]} / {rb[1]}, max|du| / max|u| {du:.3e}")


if __name__ == "__main__":
    _sensitivity()
