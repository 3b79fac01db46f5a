"""The port's ``prof_banded2`` tool (``cfd2_tpu_torch/tools/prof_banded2.py``)
against the JAX package's same computation (``tools/prof_banded2.py``,
rebuilt from ``cfd2_tpu``'s functions in ``tests/torch_banded_tools.py``)
on the CPU, on the 5,843-cell Delaunay channel at 0.025 from rest: the
FGMRES solve's iterations (8 momentum sweeps, 3 restarts, rtol 1e-5) on the
first outer's system.  The tool's fused steps are left out of the
comparison (their JAX compile alone would take this file's time; the port
still runs one).  ``prof_refined_developed`` is held in
``tests/test_torch_tools_refined.py``.

Tolerances: iterations equal.  Times are not compared."""

import numpy as np
import torch

from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.tools import prof_banded2
from torch_banded_tools import (SIZE, delaunay_meshes, jax_banded_solve,
                                jax_system)

torch.set_num_threads(2)
quiet = lambda m: None


def test_prof_banded2_solve_matches_jax():
    jm, tm = delaunay_meshes()
    got = prof_banded2.run(SIZE, "delaunay", "cpu", mesh=tm, steps=1,
                           log=quiet)
    s = JSolver(jm)
    s.set_dt(min(0.002, 0.4 * SIZE))
    s.set_viscosity(0.01)
    s.set_precond_type(1)
    u0 = np.zeros((jm.num_cells, 2))
    u0[jm.cell_cx < 2 * SIZE, 0] = 1.0
    s.set_u(u0)
    state, es = jax_system(s)
    res = jax_banded_solve(s, state, es, 8,
                            restart=s.config.fgmres_restart, max_restarts=3,
                            tol=1e-5, abstol=1e-7)
    assert got["solve"] == (int(res.iterations), bool(res.converged))
    assert got["solve"][0] > 0 and len(got["outers"]) == 1
