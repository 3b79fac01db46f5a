"""The multilevel (locally-refined quadtree) layout of the port against
cfd2_tpu on the JAX suite's refined mesh (tests/test_multilevel.py: channel
with obstacle, min_cell 0.02 / max_cell 0.04, 3,915 cells, levels 50x150
and 25x75 = 9,375 device cells):

* the encode: level grids, slot maps, the W/S mirror mask, the hanging-face
  entry pairs and exceptions, equal after the same host-order map; the
  banded/block decision;
* ``gather`` (one gather through ``ck_neighbor`` in the port; the two-window
  kernel, or per-level shifts plus the exception scatter, in JAX);
* the slot fluxes of ``prepare``, with exact per-face antisymmetry;
* the fine-grid-embedded multigrid: its levels and one pressure-solve
  application on the same assembly;
* one step on the block path, with both packages' banded maps removed (no
  refined mesh of the suite lacks one).

Tolerances: index maps and masks exactly equal; gathers exact (a gather
does no arithmetic); fluxes, gradients and the pressure-solve application
within 1e-5 of their largest magnitude (the same f32 expressions, summed in
another order); the step as in tests/test_torch_block_steps.py."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models import assembly as ja
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu.ops import amg as jamg
from cfd2_tpu.runtime import state as js
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.models import assembly as ta
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.ops import amg as tamg
from cfd2_tpu_torch.runtime import device_mesh as tdm
from cfd2_tpu_torch.runtime import state as ts
from torch_parity import assert_step_matches, clear_banded_pair, \
    clear_jax_banded_map

torch.set_num_threads(1)
RTOL = 1e-5
EXACT = ("ck_neighbor", "ck_mask", "ck_mirror", "ck_face", "ck_boundary",
         "c_valid", "grid_of_cell", "ml_pair_cell_a", "ml_pair_slot_a",
         "ml_pair_cell_b", "ml_pair_slot_b")


def _host(mod, min_cell, max_cell):
    geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return mod.generate_cut_cell_mesh(geo, min_cell, max_cell, 1.2,
                                      (3.0, 1.0))


@pytest.fixture(scope="module")
def meshes():
    hj, ht = _host(jmesh, 0.02, 0.04), _host(tmesh, 0.02, 0.04)
    return hj, ht, jencode(hj), tdm.encode_mesh(ht, device="cpu")


@pytest.fixture(scope="module")
def prepared(meshes):
    """Both packages' prepared states and block systems from the same
    random fields (zero on holes)."""
    hj, _, jm, tm = meshes
    rng = np.random.default_rng(1)
    u0 = rng.standard_normal((hj.num_cells, 2)) * 0.1
    jstate = js.initial_state(jm, u0=u0)
    jstate = replace(jstate, p=np.asarray(jm.from_host_order(jnp.asarray(
        rng.standard_normal(hj.num_cells).astype(np.float32)))),
        time=np.float32(0.05))
    jparams = js.SolverParams.default(dt=0.005)
    cfg = js.SolverConfig()
    jprep = jax.jit(ja.prepare, static_argnames=("config",))(
        jm, jstate, jparams, cfg)
    tparams = params_from_arrays(
        {f: np.asarray(getattr(jparams, f)) for f in ts.PARAMS_FIELDS}, "cpu")
    tstate = state_from_arrays(
        {f: np.asarray(getattr(jstate, f)) for f in ts.STATE_FIELDS}, "cpu")
    tprep = ta.prepare(tm, tstate, tparams, ts.SolverConfig())
    return dict(jprep=jprep, tprep=tprep, jparams=jparams, tparams=tparams,
                jsys=ja.assemble_coupled(jm, jprep, jparams, cfg),
                tsys=ta.assemble_coupled(tm, tprep, tparams,
                                         ts.SolverConfig()))


def _close(name, got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (name, err, scale)


def test_layout(meshes):
    _, _, jm, tm = meshes
    assert tm.multilevel and not tm.structured
    assert tm.ml_levels == jm.ml_levels == ((50, 150), (25, 75))
    assert tuple(np.cumsum([0] + [ny * nx for ny, nx in tm.ml_levels[:-1]])
                 ) == jm.ml_offsets
    assert tm.num_cells == jm.num_cells == 9375
    assert tm.max_faces == jm.max_faces
    assert tm.num_host_cells == 3915


@pytest.mark.parametrize("field", EXACT)
def test_encode_maps_equal(meshes, field):
    _, _, jm, tm = meshes
    got, ref = getattr(tm, field).numpy(), np.asarray(getattr(jm, field))
    assert got.shape == ref.shape and np.array_equal(got, ref), field


def test_hanging_face_sources_in_ck_neighbor(meshes):
    """The JAX package's gather overrides its per-level shifts at the
    hanging-face entries (``ml_exc_*``); the port gathers through
    ``ck_neighbor`` alone, which must hold the same sources there."""
    _, _, jm, tm = meshes
    cell, slot = np.asarray(jm.ml_exc_cell), np.asarray(jm.ml_exc_slot)
    assert len(cell) > 0
    assert np.array_equal(tm.ck_neighbor.numpy()[cell, slot],
                          np.asarray(jm.ml_exc_src))


def test_hanging_face_pairs_are_distinct(meshes):
    """The negated-flux scatter has one target per internal face, so it is
    deterministic (no duplicate (cell, slot) among the b entries)."""
    tm = meshes[3]
    b = np.stack([tm.ml_pair_cell_b.numpy(), tm.ml_pair_slot_b.numpy()], 1)
    assert len(b) > 0 and len(np.unique(b, axis=0)) == len(b)


@pytest.mark.parametrize("sizes,multilevel,banded", [
    ((0.02, 0.04), True, True), ((0.05, 0.2), True, True),
    ((0.005, 0.04), False, True)])
def test_layout_and_banded_decision(sizes, multilevel, banded):
    """Both meshes of the suite take the multilevel banded path (the JAX
    package builds a two-window map); 0.005/0.04 breaks the 6x rule and
    takes the generic layout."""
    hj, ht = _host(jmesh, *sizes), _host(tmesh, *sizes)
    jm, tm = jencode(hj), tdm.encode_mesh(ht, device="cpu")
    assert tm.multilevel == jm.multilevel == multilevel
    assert tm.banded == jm.banded == banded


def test_host_order_round_trip_over_holes(meshes):
    hj, _, _, tm = meshes
    x = torch.arange(hj.num_cells, dtype=torch.float32)
    dev = tm.from_host_order(x)
    assert torch.equal(tm.to_host_order(dev), x)
    assert float(dev[tm.c_valid == 0].abs().max()) == 0.0


@pytest.mark.parametrize("mapped", [True, False])
def test_gather(meshes, mapped):
    """With its two-window map JAX gathers ck_neighbor exactly; without it
    (per-level shifts plus the exception scatter) it agrees on every
    internal entry, the only ones with nonzero coefficients."""
    hj, _, jm, tm = meshes
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((hj.num_cells, 2)).astype(np.float32)
    got = tm.gather(tm.from_host_order(torch.as_tensor(xh))).numpy()
    if not mapped:
        jm = clear_jax_banded_map(jm)
    ref = np.asarray(jm.gather(jm.from_host_order(jnp.asarray(xh))))
    if mapped:
        assert np.array_equal(got, ref)
    else:
        sel = (tm.ck_mask.numpy() > 0) & (tm.ck_is_boundary.numpy() == 0)
        assert np.array_equal(got[sel], ref[sel])


@pytest.mark.parametrize("field", ["fluxes", "d_p", "grad_p", "grad_u",
                                   "grad_v"])
def test_prepare(prepared, field):
    _close(field, getattr(prepared["tprep"], field),
           getattr(prepared["jprep"], field))


def test_slot_flux_conservation(meshes, prepared):
    """Exact per-face antisymmetry (JAX's test_slot_flux_conservation):
    mirrored same-level faces by shift, hanging faces by the pair scatter."""
    tm = meshes[3]
    flux = prepared["tprep"].fluxes.numpy()
    sel = (tm.ck_mask.numpy() > 0) & (tm.ck_is_boundary.numpy() == 0)
    sums = np.zeros(tm.num_faces)
    np.add.at(sums, tm.ck_face.numpy()[sel], flux[sel])
    assert np.abs(flux[sel]).max() > 0 and np.abs(sums).max() == 0.0


def test_multilevel_amg_levels(meshes):
    _, _, jm, tm = meshes
    jh, th = jamg.build_hierarchy_for_mesh(jm), tamg.build_hierarchy_for_mesh(tm)
    assert isinstance(th, tamg.MultilevelAmg)
    assert isinstance(jh, jamg.MultilevelAmg)
    assert th.ml_levels == jh.ml_levels
    assert [(l.fine_grid, l.grid) for l in th.fine.levels] == \
        [(l.fine_grid, l.grid) for l in jh.fine.levels]
    for tl, jl in zip(th.fine.levels, jh.fine.levels):
        assert np.array_equal(tl.rap_target.numpy(), np.asarray(jl.rap_target))
    for f in ("diag_valid2", "internal2"):
        assert np.array_equal(getattr(th.fine, f).numpy(),
                              np.asarray(getattr(jh.fine, f)))
    assert np.array_equal(th.outlet_e2.numpy(), np.asarray(jh.outlet_e2))


def test_pressure_solve_application(meshes, prepared):
    _, _, jm, tm = meshes
    jh, th = jamg.build_hierarchy_for_mesh(jm), tamg.build_hierarchy_for_mesh(tm)
    jps = jamg.make_pressure_solve(
        jh, jm, prepared["jsys"],
        coeff=prepared["jparams"].density * prepared["jprep"].d_p)
    tps = tamg.make_pressure_solve(
        th, tm, prepared["tsys"],
        coeff=prepared["tparams"].density * prepared["tprep"].d_p)
    rng = np.random.default_rng(3)
    r = rng.standard_normal(tm.num_cells).astype(np.float32)
    got = tps(torch.as_tensor(r))
    _close("z", got, jps(jnp.asarray(r)))
    holes = tm.c_valid.numpy() == 0
    assert np.array_equal(got.numpy()[holes], r[holes])   # identity there


def test_block_path_step_without_map(meshes):
    """The block path with the fine-grid-embedded multigrid: both packages'
    maps removed, one step from the inlet column."""
    hj, ht = meshes[0], meshes[1]
    jsol, t = JSolver(hj), TSolver(ht, device="cpu")
    clear_banded_pair(jsol, t)
    for s, h in ((jsol, hj), (t, ht)):
        s.set_dt(0.01)
        s.set_precond_type(1)
        u0 = np.zeros((h.num_cells, 2))
        u0[h.cell_cx < 0.1, 0] = 1.0
        s.set_u(u0)
    assert isinstance(t._get_amg(), tamg.MultilevelAmg)
    jsol.step()
    t.step()
    assert_step_matches(jsol, t, "block", lin_per_outer=2, p_rel=1e-4)
