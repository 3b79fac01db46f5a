"""The port's structured multigrid against cfd2_tpu.ops.amg on a real small
pressure system (the setup of tests/test_pallas.py's V-cycle test).

The hierarchy's index maps are the same NumPy code and must be equal.
Level values and one V-cycle agree to 1e-5 of the result's scale: both run
the same float32 arithmetic; the 2x2 block sums and the dense LU take their
sums in another order."""

import numpy as np
import pytest
import torch

from cfd2_tpu.mesh import ChannelWithObstacle, generate_cut_cell_mesh
from cfd2_tpu.models.assembly import assemble_stencil as j_assemble
from cfd2_tpu.models.assembly import prepare as j_prepare
from cfd2_tpu.ops import amg as jamg
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu.runtime.state import SolverConfig, SolverParams, initial_state
from cfd2_tpu_torch.ops import amg as tamg
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.025, 0.025, 1.2, (3.0, 1.0))
    jm = jencode(mesh)
    tm = tencode(mesh, device="cpu")
    params = SolverParams.default(dt=0.005)
    state = initial_state(jm, u0=np.full((jm.num_host_cells, 2), [0.1, 0.0]))
    state = j_prepare(jm, state, params, SolverConfig())
    ss = j_assemble(jm, state, params, SolverConfig())
    jh = jamg.build_structured_hierarchy(jm)
    th = tamg.build_structured_hierarchy(tm)
    P_diag2, P_off2 = np.array(ss.P_diag2), np.array(ss.P_off2)
    return jh, th, P_diag2, P_off2


def _rel(got, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    return float(np.abs(got.numpy() - ref).max()) / scale


def test_hierarchy_shapes_and_rap_targets_equal(setup):
    jh, th, _, _ = setup
    assert len(th.levels) == len(jh.levels) >= 3
    for a, b in zip(jh.levels, th.levels):
        assert tuple(a.fine_grid) == tuple(b.fine_grid)
        assert tuple(a.grid) == tuple(b.grid)
        assert b.rap_target.dtype == torch.int32
        np.testing.assert_array_equal(b.rap_target.numpy(),
                                      np.asarray(a.rap_target))
    np.testing.assert_array_equal(th.diag_valid2.numpy(),
                                  np.asarray(jh.diag_valid2))
    np.testing.assert_array_equal(th.internal2.numpy(),
                                  np.asarray(jh.internal2))


def test_level_grids_of_the_1m_hierarchy():
    """The 589x1765 grid coarsens to 7 smoothed levels and a 5x14 dense
    solve (14 leg launches per V-cycle)."""
    levels = tamg._structured_levels(
        589, 1765, np.ones((589 * 1765, 4), bool),
        np.ones(589 * 1765, bool), "cpu")
    assert [lv.fine_grid for lv in levels] == [
        (589, 1765), (295, 883), (148, 442), (74, 221), (37, 111),
        (19, 56), (10, 28)]
    assert levels[-1].grid == (5, 14)


def test_level_values_agree(setup):
    jh, th, P_diag2, P_off2 = setup
    jv = jamg.compute_structured_level_values2(jh, P_diag2, P_off2)
    tv = tamg.compute_structured_level_values2(
        th, torch.as_tensor(P_diag2), torch.as_tensor(P_off2))
    assert len(jv) == len(tv)
    for (jd, jo), (td, to) in zip(jv, tv):
        assert _rel(td, jd) < 1e-5
        assert _rel(to, jo) < 1e-5


def test_dense_coarse_solve_agrees(setup):
    jh, th, P_diag2, P_off2 = setup
    jv = jamg.compute_structured_level_values2(jh, P_diag2, P_off2)
    dc, oc = (np.array(a) for a in jv[-1])
    cols = jamg._GridOps(jh.levels[-1].grid).neighbor_cols()
    jf = jamg._dense_factor(dc.reshape(-1), np.moveaxis(oc.reshape(4, -1), 0, 1),
                            cols)
    tf = tamg._dense_factor(torch.as_tensor(dc.reshape(-1)),
                            torch.as_tensor(oc.reshape(4, -1).T),
                            tamg._GridOps(th.levels[-1].grid).neighbor_cols())
    rng = np.random.default_rng(3)
    b = rng.standard_normal(dc.size).astype(np.float32)
    ref = jamg._dense_solve_factored(jf, b)
    got = tamg._dense_solve_factored(tf, torch.as_tensor(b))
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("level", ["2", "1", "0"])
def test_v_cycle_agrees(setup, monkeypatch, level):
    """One structured_v_cycle of the port, through each smoother route
    (the routes run their plain versions on the CPU), against the JAX
    package's default (jnp stencil) cycle."""
    jh, th, P_diag2, P_off2 = setup
    jv = jamg.compute_structured_level_values2(jh, P_diag2, P_off2)
    dc, oc = jv[-1]
    jf = jamg._dense_factor(
        np.asarray(dc).reshape(-1),
        np.moveaxis(np.asarray(oc).reshape(4, -1), 0, 1),
        jamg._GridOps(jh.levels[-1].grid).neighbor_cols())
    ny, nx = jh.levels[0].fine_grid
    rng = np.random.default_rng(7)
    b = rng.standard_normal(ny * nx).astype(np.float32)
    x0 = np.zeros(ny * nx, np.float32)
    monkeypatch.delenv("CFD2_PALLAS", raising=False)
    ref = jamg.structured_v_cycle(jh, jv, b, x0, coarse_factors=jf)

    monkeypatch.setenv("CFD2_PALLAS", level)
    tv = tamg.compute_structured_level_values2(
        th, torch.as_tensor(P_diag2), torch.as_tensor(P_off2))
    got = tamg.structured_v_cycle(th, tv, torch.as_tensor(b),
                                  torch.as_tensor(x0))
    assert _rel(got, ref) < 1e-5


def _port_level_values(setup):
    _, th, P_diag2, P_off2 = setup
    return tamg.compute_structured_level_values2(
        th, torch.as_tensor(P_diag2), torch.as_tensor(P_off2))


def _port_cycle(setup, tv, sweeps=1):
    th = setup[1]
    ny, nx = th.levels[0].fine_grid
    b = np.random.default_rng(11).standard_normal(ny * nx).astype(np.float32)
    return tamg.structured_v_cycle(th, tv, torch.as_tensor(b),
                                   torch.zeros(ny * nx), sweeps=sweeps)


@pytest.mark.parametrize("sweeps,fused", [(1, True), (2, False)])
def test_v_cycle_takes_the_fused_legs_at_smoother_level_2(
        setup, monkeypatch, sweeps, fused):
    """At smoother level 2 and sweeps == 1 every level's down leg returns
    the restricted residual and its up leg adds the prolongation (2 leg
    calls per level, no separate grid transfer); with more sweeps the legs
    are unfused and the transfers plain."""
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    calls = {"restrict_to": 0, "add_prolong": 0, "plain": 0,
             "restrict2": 0, "prolong2": 0}
    leg, restrict2, prolong2 = sk.rbgs_leg, sk.restrict2, sk.prolong2

    def spy_leg(*a, **k):
        kind = next((n for n in ("restrict_to", "add_prolong")
                     if k.get(n) is not None), "plain")
        calls[kind] += 1
        return leg(*a, **k)

    def spy(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    tv = _port_level_values(setup)
    monkeypatch.setenv("CFD2_PALLAS", "2")
    monkeypatch.setattr(sk, "rbgs_leg", spy_leg)
    monkeypatch.setattr(sk, "restrict2", spy("restrict2", restrict2))
    monkeypatch.setattr(sk, "prolong2", spy("prolong2", prolong2))
    _port_cycle(setup, tv, sweeps)
    L = len(setup[1].levels)
    if fused:
        # On the CPU the wrapper itself composes the plain transfers.
        assert calls == {"restrict_to": L, "add_prolong": L, "plain": 0,
                         "restrict2": L, "prolong2": L}
    else:
        assert calls == {"restrict_to": 0, "add_prolong": 0, "plain": 2 * L,
                         "restrict2": L, "prolong2": L}


def test_fused_v_cycle_equals_the_plain_stencil_cycle(setup, monkeypatch):
    """On the CPU the fused legs are the plain leg composed with the plain
    transfers, so smoother levels 2 and 0 give the same bits."""
    tv = _port_level_values(setup)
    monkeypatch.setenv("CFD2_PALLAS", "2")
    fused = _port_cycle(setup, tv)
    monkeypatch.setenv("CFD2_PALLAS", "0")
    assert torch.equal(fused, _port_cycle(setup, tv))


@pytest.mark.parametrize("sweeps", [1, 2])
def test_v_cycle_half_sweeps_take_the_level_planes(setup, monkeypatch,
                                                   sweeps):
    """At smoother level 1 each smooth is 2 * sweeps half-sweeps on the
    level's own (4, ny, nx) coefficient planes (no per-smooth transpose):
    the first writes a new tensor, the rest update it in place."""
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    tv = tamg.structured_level_values_2d(setup[1], _port_level_values(setup))
    planes = {o.data_ptr(): d.shape for d, o in tv[:-1]}
    calls = []
    half = sk.rbgs_half_sweep

    def spy(xg, diag2, off2, bg, parity, in_place=False):
        calls.append((off2.data_ptr(), tuple(off2.shape), parity, in_place))
        return half(xg, diag2, off2, bg, parity, in_place=in_place)

    monkeypatch.setenv("CFD2_PALLAS", "1")
    monkeypatch.setattr(sk, "rbgs_half_sweep", spy)
    _port_cycle(setup, tv, sweeps)
    L = len(setup[1].levels)
    assert len(calls) == 2 * L * 2 * sweeps
    for ptr, shape, _, _ in calls:
        assert ptr in planes and shape == (4,) + tuple(planes[ptr])
    per_smooth = [(k % 2, k > 0) for k in range(2 * sweeps)]
    assert [c[2:] for c in calls] == per_smooth * (2 * L)


def test_half_sweep_cycle_equals_the_plain_stencil_cycle(setup, monkeypatch):
    """On the CPU the half-sweeps are the plain colour updates, so smoother
    levels 1 and 0 give the same bits."""
    tv = _port_level_values(setup)
    monkeypatch.setenv("CFD2_PALLAS", "1")
    half = _port_cycle(setup, tv)
    monkeypatch.setenv("CFD2_PALLAS", "0")
    assert torch.equal(half, _port_cycle(setup, tv))
