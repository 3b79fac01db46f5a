"""The port's aggregation-AMG probe (``cfd2_tpu_torch/tools/
prof_amg_variants.py``) against the JAX package's same computation
(``tools/prof_amg_variants.py``) on the CPU: the 5,843-cell Delaunay channel
from rest, every variant's FGMRES solve of the first outer system and its
pressure V-cycle's contraction.

Tolerances: iterations equal per variant; contraction factors within 1e-3
(relative) of the JAX package's."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfd2_tpu.mesh import generate_delaunay_mesh as j_delaunay
from cfd2_tpu_torch.tools import prof_amg_variants as pav
from test_torch_tools_precond import _geo, _jax_solver

torch.set_num_threads(2)


def jax_prof_amg_variants(size: float) -> tuple:
    """tools/prof_amg_variants.py:49-90 at ``size`` (the coupled solve's
    iterations per variant) and the port tool's contraction with the JAX
    package's pressure solve and operator on the same seeded vector (run
    eagerly).  One compiled solve per smoother and sweep count, the
    overcorrection its argument: the JAX tool compiles one per variant,
    about 25 s each on a CPU."""
    from cfd2_tpu.models.assembly import assemble_ell, prepare
    from cfd2_tpu.ops import ellsys as el
    from cfd2_tpu.ops.amg import make_pressure_solve
    from cfd2_tpu.ops.blockell import scalar_spmv
    from cfd2_tpu.ops.fgmres import fgmres_solve
    mesh = j_delaunay(_geo(), size, size, 1.2, (3.0, 1.0))
    s = _jax_solver(mesh, size)
    dm, config, params = s.mesh, s.config, s.params
    hier = s._get_amg()
    state = jax.jit(lambda st: prepare(dm, st, params, config))(s.state)
    es = jax.jit(lambda st: assemble_ell(dm, st, params, config))(state)
    n_sweeps = config.pressure_sweeps(dm.num_cells)
    x0 = jnp.concatenate([state.u, state.p[:, None]], axis=1).T

    @partial(jax.jit, static_argnames=("smoother", "smooth_arg"))
    def solve(rhs, x0v, overcorrect, smoother, smooth_arg):
        ps = make_pressure_solve(hier, dm, es, cycle_opts=dict(
            smoother=smoother, smooth_arg=smooth_arg,
            overcorrect=overcorrect))
        mv = lambda xx: el.spmv(es, dm, xx)
        pc = lambda rr: el.schur_precond(es, dm, rr, config.precond_omega,
                                         n_sweeps, pressure_solve=ps,
                                         mom_sweeps=8)
        return fgmres_solve(mv, pc, rhs, x0v, restart=config.fgmres_restart,
                            max_restarts=5, tol=1e-5, abstol=1e-7)

    b = jnp.asarray(pav.seeded_rhs(dm.num_cells, np.asarray(dm.c_valid)))
    its, rho = {}, {}
    for name, opts in pav.VARIANTS:
        kw = dict(smoother=opts.get("smoother", "jacobi"),
                  smooth_arg=opts.get("smooth_arg", 1))
        its[name] = int(solve(es.rhs.T, x0, jnp.float32(
            opts.get("overcorrect", 1.0)), **kw).iterations)
        ps = make_pressure_solve(hier, dm, es, cycle_opts=opts)
        x, r = jnp.zeros_like(b), b
        for _ in range(pav.CYCLES):
            x = x + ps(r)
            r = b - scalar_spmv(es.P_diag, es.P_off, dm, x)
        rk = np.linalg.norm(np.asarray(r, np.float64))
        rho[name] = (rk / np.linalg.norm(np.asarray(b, np.float64))) \
            ** (1.0 / pav.CYCLES)
    return mesh.num_cells, its, rho


def test_prof_amg_variants_match_jax():
    lines = []
    got = pav.run(0.025, "delaunay", device="cpu", log=lines.append)
    cells, its, rho = jax_prof_amg_variants(0.025)
    assert f"{cells} cells" in lines[0] and cells == 5843
    assert {n: r["iterations"] for n, r in got.items()} == its
    for name, r in got.items():
        assert np.isfinite(r["contraction"])
        assert r["contraction"] == pytest.approx(rho[name], rel=1e-3), name
