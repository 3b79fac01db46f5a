"""assemble_ell, ellsys.spmv and ellsys.schur_precond of the port against
cfd2_tpu's on one random state on a Delaunay and on a slot-capped Voronoi
mesh, and prepare's banded branch (with the bitwise flux antisymmetry).

Tolerance: 1e-5 relative to each plane's (or vector's) largest magnitude.
Both sides run the same float32 expressions in the same order; what differs
is the order of the per-row sums over slots (XLA's reductions and the Pallas
window walk against PyTorch's CPU reductions), a few ulps of the largest
term.  The Schur preconditioner chains 2 x 8 Jacobi sweeps and three dots;
its bound is the same because the sweeps contract (diagonally dominant
momentum block)."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd2_tpu.mesh import (ChannelWithObstacle, generate_delaunay_mesh,
                           generate_voronoi_mesh)
from cfd2_tpu.models import assembly as ja
from cfd2_tpu.ops import ellsys as jel
from cfd2_tpu.runtime import state as js
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models import assembly as ta
from cfd2_tpu_torch.ops import ellsys as tel
from cfd2_tpu_torch.runtime import state as ts
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode

torch.set_num_threads(1)
RTOL = 1e-5
PLANES = ("off_mom", "off_up", "off_vp", "off_pu", "off_pv", "off_pp",
          "P_off", "diag_u", "diag_up", "diag_vp", "diag_pu", "diag_pv",
          "diag_pp", "P_diag", "diag_u_inv", "diag_p_inv", "rhs")


@pytest.fixture(scope="module", params=["delaunay", "voronoi"])
def setup(request):
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    gen = {"delaunay": generate_delaunay_mesh,
           "voronoi": generate_voronoi_mesh}[request.param]
    mesh = gen(geo, 0.06, 0.06, 1.2, (3.0, 1.0), seed=2)
    jm = jencode(mesh)
    tm = tencode(mesh, device="cpu")
    if request.param == "voronoi":
        assert tm.bd_k == 8
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
    tstate = state_from_arrays(
        {f: np.asarray(getattr(jstate, f)) for f in ts.STATE_FIELDS}, "cpu")
    tparams = params_from_arrays(
        {f: np.asarray(getattr(jparams, f)) for f in ts.PARAMS_FIELDS}, "cpu")
    return jm, tm, jstate, tstate, jparams, tparams


def _close(name, got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (name, err, scale)


@pytest.fixture(scope="module")
def prepared(setup):
    jm, tm, jstate, tstate, jparams, tparams = setup
    jp = ja.prepare(jm, jstate, jparams, js.SolverConfig())
    tp = ta.prepare(tm, tstate, tparams, ts.SolverConfig())
    return jp, tp


def test_prepare_banded_branch(setup, prepared):
    jm, tm = setup[0], setup[1]
    jp, tp = prepared
    assert tuple(tp.fluxes.shape) == (tm.num_cells, tm.max_faces)
    for f in ("fluxes", "d_p", "grad_p", "grad_u", "grad_v"):
        _close(f, getattr(tp, f), getattr(jp, f))


def test_banded_slot_fluxes_exact_antisymmetry(setup, prepared):
    """Per-face mass-flux antisymmetry is BITWISE exact on the banded path
    (the two sides of a face interpolate with each other's own lambda)."""
    tm = setup[1]
    flux = prepared[1].fluxes.numpy()
    ckf = tm.ck_face.numpy()
    ent = np.argwhere((tm.ck_mask.numpy() > 0)
                      & (tm.ck_is_boundary.numpy() == 0))
    face_of = ckf[ent[:, 0], ent[:, 1]]
    order = np.argsort(face_of, kind="stable")
    ent = ent[order]
    assert (face_of[order][0::2] == face_of[order][1::2]).all()
    fa = flux[ent[0::2, 0], ent[0::2, 1]]
    fb = flux[ent[1::2, 0], ent[1::2, 1]]
    assert np.abs(fa).max() > 0
    assert np.abs(fa + fb).max() == 0.0          # bitwise


@pytest.mark.parametrize("scheme,time_scheme", [(0, 0), (1, 1), (2, 0)],
                         ids=["upwind-euler", "sou-bdf2", "quick-euler"])
def test_assemble_ell_planes(setup, prepared, scheme, time_scheme):
    jm, tm, _, _, jparams, tparams = setup
    jp, tp = prepared
    jes = ja.assemble_ell(jm, jp, jparams, js.SolverConfig(
        scheme=scheme, time_scheme=time_scheme))
    tes = ta.assemble_ell(tm, tp, tparams, ts.SolverConfig(
        scheme=scheme, time_scheme=time_scheme))
    for f in PLANES:
        _close(f, getattr(tes, f), getattr(jes, f))
    # pad slots carry zero coefficients (what the full-K walk relies on)
    pad = tm.ck_mask.numpy() == 0
    for f in PLANES[:7]:
        assert float(np.abs(getattr(tes, f).numpy()[pad]).max(initial=0)) == 0


@pytest.fixture(scope="module")
def systems(setup, prepared):
    jm, tm, _, _, jparams, tparams = setup
    jes = ja.assemble_ell(jm, prepared[0], jparams, js.SolverConfig())
    tes = ta.assemble_ell(tm, prepared[1], tparams, ts.SolverConfig())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, jm.num_cells)).astype(np.float32)
    return jes, tes, x


def test_spmv(setup, systems):
    jm, tm = setup[0], setup[1]
    jes, tes, x = systems
    _close("spmv", tel.spmv(tes, tm, torch.as_tensor(x)),
           jel.spmv(jes, jm, jnp.asarray(x)))


@pytest.mark.parametrize("mom_sweeps", [1, 2, 8])
def test_schur_precond_chebyshev(setup, systems, mom_sweeps):
    """mom_sweeps 1 and 2 take the per-sweep exact dots, 8 the one-call
    sweeps, which on the Voronoi mesh drop the slots beyond bd_k on both
    sides."""
    jm, tm = setup[0], setup[1]
    jes, tes, x = systems
    ref = jel.schur_precond(jes, jm, jnp.asarray(x), 1.2, 6,
                            mom_sweeps=mom_sweeps)
    got = tel.schur_precond(tes, tm, torch.as_tensor(x), 1.2, 6,
                            mom_sweeps=mom_sweeps)
    _close(f"schur m{mom_sweeps}", got, ref)


def test_momentum_solve_takes_the_sweeps_kernel_rule(setup, systems):
    from cfd2_tpu_torch.ops import banded_kernels as bk
    tm = setup[1]
    _, tes, x = systems
    r_u, r_v = torch.as_tensor(x[0]), torch.as_tensor(x[1])
    got = tel._momentum_solve(tes, tm, r_u, r_v, 8)
    want = bk.banded_jacobi_sweeps_ref((r_u, r_v), tes.diag_u_inv,
                                       tes.off_mom, tm.ck_neighbor, 8,
                                       k_cap=tm.bd_k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
