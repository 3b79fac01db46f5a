"""The port's ``prof_refined_developed`` tool
(``cfd2_tpu_torch/tools/prof_refined_developed.py``) against the JAX
package's same computation (``tools/prof_refined_developed.py``, rebuilt
from ``cfd2_tpu``'s functions in ``tests/torch_banded_tools.py``) on the
CPU, on the 5,843-cell Delaunay channel at 0.025 from a small healed state
(the port's ``make_developed_unstructured`` with 3 heal steps, loaded by
both packages, the state's time the heal's end in both): the FGMRES solve's
iterations from the state's own guess.  The tool's heal and timed fused
steps are left out of the comparison (``heal=0``, ``n_meas=0``: their JAX
compile alone would take this file's time); ``chip_smoke.py`` phase 16(e)
runs them on the card.

Tolerances: iterations equal.  Times are not compared."""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu_torch.tools import make_developed_unstructured as mdu
from cfd2_tpu_torch.tools import prof_refined_developed
from torch_banded_tools import (SIZE, delaunay_meshes, jax_banded_solve,
                                jax_system)

torch.set_num_threads(2)
quiet = lambda m: None


def test_prof_refined_developed_solve_matches_jax(tmp_path):
    jm, tm = delaunay_meshes()
    path = tmp_path / "developed_delaunay_0.025.npz"
    mdu.make("delaunay", SIZE, heal_steps=3, device="cpu", out=path, mesh=tm,
             log=quiet)
    got = prof_refined_developed.run("delaunay", SIZE, 0.0, "cpu", mesh=tm,
                                     state=path, heal=0, n_meas=0, log=quiet)
    d = np.load(path)
    meta = json.loads(str(d["meta"]))
    s = JSolver(jm)
    s.set_viscosity(meta["viscosity"])
    s.set_density(meta["density"])
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5, stop_count=10**9)
    s.set_dt(meta["dt"])
    s.set_u(d["u"].astype(np.float32))
    s.set_p(d["p"].astype(np.float32))
    s.initialize_history()
    s.state = replace(s.state, time=jnp.float32(meta["solver_time"]))
    state, es = jax_system(s)
    config = s.config
    ms = config.precond_mom_sweeps if config.precond_mom_sweeps > 0 else 8
    res = jax_banded_solve(
        s, state, es, ms, coeff=s.params.density * state.d_p,
        cycle_opts=config.cycle_opts(), restart=config.fgmres_restart,
        max_restarts=config.fgmres_max_restarts, tol=config.fgmres_tol,
        abstol=config.fgmres_abstol,
        stagnation_tol=config.fgmres_stagnation_tol,
        stagnation_limit=config.fgmres_stagnation_limit)
    assert got["solve"] == (int(res.iterations), bool(res.converged))
    assert got["cells"] == 5843 and got["outers"] == []


def test_prof_refined_developed_names_a_missing_state(tmp_path):
    with pytest.raises(FileNotFoundError, match="make_developed_unstructured"):
        prof_refined_developed.run("delaunay", SIZE, 0.0, "cpu",
                                   state=tmp_path / "none.npz", log=quiet)
