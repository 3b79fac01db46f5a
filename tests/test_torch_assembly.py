"""prepare / assemble_stencil / assemble_pressure of the port against
cfd2_tpu.models.assembly on the same state.

Tolerance: 1e-5 relative to each plane's largest magnitude.  Both sides run
the same float32 expressions in the same order; what differs is the
summation order of the per-slot reductions (XLA vs PyTorch's CPU kernels),
a few ulps."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from cfd2_tpu.mesh import ChannelWithObstacle, generate_cut_cell_mesh
from cfd2_tpu.models import assembly as ja
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu.runtime import state as js
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models import assembly as ta
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode
from cfd2_tpu_torch.runtime import state as ts

torch.set_num_threads(1)
RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.0, 1.0))
    jm = jencode(mesh)
    tm = tencode(mesh, device="cpu")
    rng = np.random.default_rng(0)
    N = jm.num_cells
    valid = np.asarray(jm.c_valid)
    rnd = lambda *s: (rng.standard_normal((N,) + s) * (valid.reshape(
        (N,) + (1,) * len(s)))).astype(np.float32)
    jstate = js.initial_state(jm)
    jstate = replace(
        jstate, u=rnd(2) * 0.5 + np.float32(0.8) * valid[:, None],
        u_old=rnd(2), u_old_old=rnd(2), p=rnd(), d_p=np.abs(rnd()) * 1e-2,
        grad_p=rnd(2), time=np.float32(0.05))
    jparams = js.SolverParams.default(dt=0.01, viscosity=0.01)
    jparams = replace(jparams, dt_old=np.float32(0.008))
    arrays = {f: np.asarray(getattr(jstate, f)) for f in ts.STATE_FIELDS}
    tstate = state_from_arrays(arrays, "cpu")
    tparams = params_from_arrays(
        {f: np.asarray(getattr(jparams, f)) for f in ts.PARAMS_FIELDS}, "cpu")
    return jm, tm, jstate, tstate, jparams, tparams


def _close(name, got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= RTOL * scale, (name, err, scale)


CONFIGS = [(0, 0), (1, 0), (2, 0), (0, 1)]


@pytest.mark.parametrize("scheme,time_scheme", CONFIGS,
                         ids=["upwind-euler", "sou-euler", "quick-euler",
                              "upwind-bdf2"])
def test_prepare_and_stencil_assembly(setup, scheme, time_scheme):
    jm, tm, jstate, tstate, jparams, tparams = setup
    jcfg = js.SolverConfig(scheme=scheme, time_scheme=time_scheme)
    tcfg = ts.SolverConfig(scheme=scheme, time_scheme=time_scheme)
    jp = jax.jit(ja.prepare, static_argnames=("config",))(
        jm, jstate, jparams, jcfg)
    tp = ta.prepare(tm, tstate, tparams, tcfg)
    for f in ("fluxes", "d_p", "grad_p", "grad_u", "grad_v"):
        _close(f, getattr(tp, f), getattr(jp, f))

    # Assemble both from the JAX prepare output, so the assembly is
    # compared alone.
    tp = state_from_arrays({f: np.asarray(getattr(jp, f))
                            for f in ts.STATE_FIELDS}, "cpu")
    jss = ja.assemble_stencil(jm, jp, jparams, jcfg)
    tss = ta.assemble_stencil(tm, tp, tparams, tcfg)
    assert tuple(tss.grid) == tuple(jss.grid)
    for f in ("off_mom", "off_up", "off_vp", "off_pu", "off_pv", "off_pp",
              "P_off2", "diag_u2", "diag_up2", "diag_vp2", "diag_pu2",
              "diag_pv2", "diag_pp2", "P_diag2", "diag_u_inv2",
              "diag_p_inv2", "rhs"):
        _close(f, getattr(tss, f), getattr(jss, f))

    jP = ja.assemble_pressure(jm, jp, jparams)
    tP = ta.assemble_pressure(tm, tp, tparams)
    _close("P_diag", tP[0], jP[0])
    _close("P_off", tP[1], jP[1])


def test_inlet_ramp(setup):
    jm, tm, _, _, jparams, tparams = setup
    for t in (0.0, 0.01, 0.05, 0.2):
        a = ja._inlet_velocity(jparams, np.float32(t))
        b = ta._inlet_velocity(tparams, torch.tensor(t, dtype=torch.float32))
        assert abs(float(a) - float(b)) <= 1e-7
