"""The block-ELL system of the port against cfd2_tpu on the same state:
the face-parallel fluxes, prepare, assemble_coupled (every BlockSystem
field), block_spmv / scalar_spmv, the Chebyshev pressure relaxation, the
block-Jacobi preconditioner and the Schur preconditioner.

Two meshes: a ~1k-cell Delaunay mesh with its banded map removed (the
generic path: one flux per face, every neighbor access a gather through
``ck_neighbor``) and the structured channel at min_cell 0.05 (grid shifts).

Tolerance: 1e-5 relative to each result's largest magnitude.  Both sides run
the same float32 expressions; what differs is the summation order of the
per-slot reductions and the batched 3x3 solves (XLA vs PyTorch's CPU
kernels), a few ulps, which the relaxation sweeps carry along but do not
amplify."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models import assembly as ja
from cfd2_tpu.ops import blockell as jb
from cfd2_tpu.ops import schur as jsch
from cfd2_tpu.runtime import state as js
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models import assembly as ta
from cfd2_tpu_torch.ops import blockell as tb
from cfd2_tpu_torch.ops import schur as tsch
from cfd2_tpu_torch.runtime import state as ts
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode
from torch_parity import clear_jax_banded_map

torch.set_num_threads(1)
RTOL = 1e-5
FIELDS = ("A_diag", "A_off", "rhs", "P_diag", "P_off", "diag_u_inv",
          "diag_v_inv", "diag_p_inv")


def _meshes(kind):
    out = []
    for mod in (jmesh, tmesh):
        geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
        if kind == "delaunay":
            out.append(mod.generate_delaunay_mesh(
                geo, 0.06, 0.06, 1.2, (3.0, 1.0), seed=2))
        else:
            out.append(mod.generate_cut_cell_mesh(
                geo, 0.05, 0.05, 1.2, (3.0, 1.0)))
    return out


@pytest.fixture(scope="module", params=["delaunay", "structured"])
def setup(request):
    """Both packages' meshes, prepared states and block systems; the JAX
    state is prepared from random fields and carried into the port."""
    hj, ht = _meshes(request.param)
    jm, tm = jencode(hj), tencode(ht, device="cpu")
    if request.param == "delaunay":
        assert tm.banded and not tm.structured
        jm = clear_jax_banded_map(jm)
        tm = replace(tm, banded=False, bd_k=None)
    rng = np.random.default_rng(0)
    N = jm.num_cells
    valid = np.asarray(jm.c_valid)
    rnd = lambda *s: (rng.standard_normal((N,) + s) * valid.reshape(
        (N,) + (1,) * len(s))).astype(np.float32)
    jstate = js.initial_state(jm)
    jstate = replace(
        jstate, u=rnd(2) * 0.5 + np.float32(0.8) * valid[:, None],
        u_old=rnd(2), u_old_old=rnd(2), p=rnd(), d_p=np.abs(rnd()) * 1e-2,
        grad_p=rnd(2), time=np.float32(0.05))
    jparams = js.SolverParams.default(dt=0.01, viscosity=0.01)
    tparams = params_from_arrays(
        {f: np.asarray(getattr(jparams, f)) for f in ts.PARAMS_FIELDS}, "cpu")
    tstate = state_from_arrays(
        {f: np.asarray(getattr(jstate, f)) for f in ts.STATE_FIELDS}, "cpu")
    cfg = js.SolverConfig()
    tcfg = ts.SolverConfig()
    jprep = jax.jit(ja.prepare, static_argnames=("config",))(
        jm, jstate, jparams, cfg)
    tprep = ta.prepare(tm, tstate, tparams, tcfg)
    jsys = ja.assemble_coupled(jm, jprep, jparams, cfg)
    tsys = ta.assemble_coupled(tm, tprep, tparams, tcfg)
    return dict(jm=jm, tm=tm, jstate=jstate, tstate=tstate, jparams=jparams,
                tparams=tparams, jprep=jprep, tprep=tprep, jsys=jsys,
                tsys=tsys, rng=rng, valid=valid)


def _close(name, got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (name, err, scale)


def test_compute_fluxes(setup):
    s = setup
    got = ta.compute_fluxes(s["tm"], s["tstate"], s["tparams"],
                            s["tstate"].time)
    ref = ja.compute_fluxes(s["jm"], s["jstate"], s["jparams"],
                            s["jstate"].time)
    _close("fluxes", got, ref)


@pytest.mark.parametrize("field", ["fluxes", "d_p", "grad_p", "grad_u",
                                   "grad_v"])
def test_prepare(setup, field):
    """On the generic mesh without a map the state keeps one flux per face,
    as in the JAX package; on the structured one, slot fluxes."""
    _close(field, getattr(setup["tprep"], field),
           getattr(setup["jprep"], field))


@pytest.mark.parametrize("field", FIELDS)
def test_assemble_coupled(setup, field):
    _close(field, getattr(setup["tsys"], field),
           getattr(setup["jsys"], field))


def _x(setup, *shape):
    v = setup["valid"].reshape((-1,) + (1,) * len(shape))
    return (setup["rng"].standard_normal(
        (setup["jm"].num_cells,) + shape) * v).astype(np.float32)


def test_block_spmv(setup):
    x = _x(setup, 3)
    _close("Ax", tb.block_spmv(setup["tsys"], setup["tm"], torch.as_tensor(x)),
           jb.block_spmv(setup["jsys"], setup["jm"], jnp.asarray(x)))


def test_scalar_spmv(setup):
    x = _x(setup)
    t, j = setup["tsys"], setup["jsys"]
    _close("Px", tb.scalar_spmv(t.P_diag, t.P_off, setup["tm"],
                                torch.as_tensor(x)),
           jb.scalar_spmv(j.P_diag, j.P_off, setup["jm"], jnp.asarray(x)))


def test_chebyshev_pressure_solve(setup):
    b = _x(setup)
    _close("z_p", tsch.chebyshev_pressure_solve(
        setup["tsys"], setup["tm"], torch.as_tensor(b), 0.8, 20),
        jsch.chebyshev_pressure_solve(setup["jsys"], setup["jm"],
                                      jnp.asarray(b), 0.8, 20))


def test_block_jacobi_preconditioner(setup):
    r = _x(setup, 3)
    got = tsch.block_jacobi_preconditioner(setup["tsys"], torch.as_tensor(r))
    _close("z", got, jsch.block_jacobi_preconditioner(setup["jsys"],
                                                      jnp.asarray(r)))
    assert torch.isfinite(got).all()      # every block is invertible


@pytest.mark.parametrize("mom_sweeps", [1, 3])
def test_schur_preconditioner(setup, mom_sweeps):
    r = _x(setup, 3)
    _close("z", tsch.schur_preconditioner(
        setup["tsys"], setup["tm"], torch.as_tensor(r), 0.8, 20,
        mom_sweeps=mom_sweeps),
        jsch.schur_preconditioner(setup["jsys"], setup["jm"], jnp.asarray(r),
                                  0.8, 20, mom_sweeps=mom_sweeps))
