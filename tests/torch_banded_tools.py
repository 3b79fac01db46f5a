"""The JAX package's side of the banded profiling tools' tests
(``tests/test_torch_tools_banded.py``, ``tests/test_torch_tools_refined.py``):
the 5,843-cell Delaunay channel at 0.025 in both packages, and the JAX
tools' outer system and banded FGMRES solve rebuilt from ``cfd2_tpu``'s
functions."""

import jax
import jax.numpy as jnp

from cfd2_tpu.mesh import ChannelWithObstacle as JChannel
from cfd2_tpu.mesh import generate_delaunay_mesh as j_delaunay
from cfd2_tpu_torch.tools import probes

SIZE = 0.025


def delaunay_meshes():
    """The channel's 0.025 Delaunay mesh as the JAX package's and the
    port's host Mesh (the same generator, the same 5,843 cells)."""
    jm = j_delaunay(JChannel(3.0, 1.0, (1.0, 0.5), 0.2), SIZE, SIZE, 1.2,
                    (3.0, 1.0))
    tm = probes.channel_mesh(SIZE, "delaunay")
    assert tm.num_cells == jm.num_cells == 5843
    return jm, tm


def jax_banded_solve(s, state, es, ms, coeff=None, cycle_opts=None, **kw):
    """The JAX tools' banded FGMRES solve of ``es`` from the state's own
    (u, p): tools/prof_banded2.py:126-136, prof_refined_developed.py:
    152-166.  The pressure solve's coarse levels are coarsened outside the
    solve's program, as ``make_pressure_solve`` coarsens them there, and
    reach it through ``frozen=`` (the same arrays): every array is an
    argument, where the JAX tools close over them, which makes them
    constants of the program and slows its compile, not its
    arithmetic."""
    from cfd2_tpu.ops import ellsys as el
    from cfd2_tpu.ops.amg import coarse_level_values, make_pressure_solve
    from cfd2_tpu.ops.fgmres import fgmres_solve
    config = s.config
    n_sweeps = config.pressure_sweeps(s.mesh.num_cells)
    hier = s._get_amg()
    frozen = coarse_level_values(hier, es.P_diag, es.P_off)

    def solve(es, dm, hier, frozen, state, coeff):
        ps = make_pressure_solve(hier, dm, es, coeff=coeff,
                                 cycle_opts=cycle_opts, frozen=frozen)
        x0 = jnp.concatenate([state.u, state.p[:, None]], axis=1).T
        return fgmres_solve(
            lambda xx: el.spmv(es, dm, xx),
            lambda rr: el.schur_precond(es, dm, rr, config.precond_omega,
                                        n_sweeps, pressure_solve=ps,
                                        mom_sweeps=ms),
            es.rhs.T, x0, **kw)
    return jax.jit(solve)(es, s.mesh, hier, frozen, state, coeff)


def jax_system(s):
    """The JAX solver ``s``'s prepared state and assembled EllSystem, each
    one program with the mesh an argument."""
    from cfd2_tpu.models.assembly import assemble_ell, prepare
    state = jax.jit(prepare, static_argnames=("config",))(
        s.mesh, s.state, s.params, s.config)
    es = jax.jit(assemble_ell, static_argnames=("config",))(
        s.mesh, state, s.params, s.config)
    return state, es
