"""The aggregation AMG of the port against cfd2_tpu.ops.amg on a Delaunay
and on a slot-capped Voronoi mesh: the hierarchy's index maps must be
identical (same greedy scan over the same device cell order), the Galerkin
level values and the V-cycle agree to float32 roundoff.

Tolerances: level values are sums of the same float32 terms in another
order (XLA's segment_sum against the port's in-order sum per coarse slot):
1e-5 of each level's largest magnitude.  A V-cycle chains, per level, two smoothings, a residual, a
restriction and a prolongation, and ends in a dense LU of a matrix with a
near-null constant mode; roundoff of the coarse right-hand side is amplified
by the coarse solve, so its output is held to 1e-4 of its largest
magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd2_tpu.mesh import (ChannelWithObstacle, generate_delaunay_mesh,
                           generate_voronoi_mesh)
from cfd2_tpu.ops import amg as jamg
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.ops import amg as tamg
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode

torch.set_num_threads(1)


class _Sys:
    """What make_pressure_solve reads of a system."""

    def __init__(self, P_diag, P_off, conv):
        self.P_diag = conv(P_diag)
        self.P_off = conv(P_off)
        self.diag_p_inv = conv(1.0 / P_diag)


@pytest.fixture(scope="module", params=["delaunay", "voronoi"])
def setup(request):
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    gen = {"delaunay": generate_delaunay_mesh,
           "voronoi": generate_voronoi_mesh}[request.param]
    mesh = gen(geo, 0.04, 0.04, 1.2, (3.0, 1.0), seed=1)
    jm = jencode(mesh)
    tm = tencode(mesh, device="cpu")
    jh = jamg.build_hierarchy_for_mesh(jm)
    th = tamg.build_hierarchy_for_mesh(tm)
    # A pressure-like M-matrix on the mesh's pattern: negative off-diagonals
    # on internal slots, weakly dominant diagonal, identity padding rows.
    rng = np.random.default_rng(0)
    internal = (np.asarray(jm.ck_mask)
                * (1.0 - np.asarray(jm.ck_is_boundary))).astype(np.float32)
    P_off = (-(0.5 + rng.random(internal.shape)) * internal).astype(
        np.float32)
    P_diag = (-P_off.sum(axis=1)
              + 0.05 * rng.random(jm.num_cells)).astype(np.float32)
    P_diag = np.where(np.asarray(jm.c_valid) > 0, P_diag, 1.0).astype(
        np.float32)
    b = (rng.standard_normal(jm.num_cells)
         * np.asarray(jm.c_valid)).astype(np.float32)
    return jm, tm, jh, th, P_diag, P_off, b


def _close(name, got, ref, rtol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (name, err, scale)


def test_hierarchy_maps_are_identical(setup):
    _, _, jh, th, *_ = setup
    assert isinstance(th, tamg.AmgHierarchy)
    assert len(th.levels) == len(jh.levels) >= 2
    for li, (jl, tl) in enumerate(zip(jh.levels, th.levels)):
        assert (tl.n, tl.k) == (jl.n, jl.k), li
        for name in ("ell_neighbor", "rap_target", "members"):
            got = getattr(tl, name)
            assert got.dtype == torch.int32 and got.is_contiguous()
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jl, name)),
                err_msg=f"level {li} {name}")
        np.testing.assert_array_equal(tl.agg.numpy()[:, 0],
                                      np.asarray(jl.agg))
        np.testing.assert_array_equal(tl.members_mask.numpy(),
                                      np.asarray(jl.members_mask))


@pytest.mark.parametrize("passes", [1, 2])
def test_build_hierarchy_passes(setup, passes):
    jm, tm = setup[0], setup[1]
    args = [jm.amg_host[k] for k in ("ck_neighbor", "ck_mask", "c_valid")]
    jh = jamg.build_hierarchy(*args, agg_passes=passes)
    th = tamg.build_hierarchy(*args, agg_passes=passes, device="cpu")
    assert [l.n for l in th.levels] == [l.n for l in jh.levels]
    for jl, tl in zip(jh.levels, th.levels):
        np.testing.assert_array_equal(tl.agg.numpy()[:, 0],
                                      np.asarray(jl.agg))


def test_python_aggregation_scan_equals_native(setup):
    from cfd2_tpu_torch.mesh import native
    tm = setup[1]
    ngh = tm.amg_host["ck_neighbor"].astype(np.int64)
    mask = (tm.amg_host["ck_mask"] > 0) \
        & (ngh != np.arange(len(ngh))[:, None])
    res = native.amg_aggregate(ngh, mask)
    if res is None:
        pytest.skip("native library unavailable: nothing to compare")
    saved, native.amg_aggregate = native.amg_aggregate, lambda *a: None
    try:
        agg, num = tamg._aggregate_ell(ngh, mask)
    finally:
        native.amg_aggregate = saved
    assert num == res[1]
    np.testing.assert_array_equal(agg, res[0])


def test_compute_level_values(setup):
    _, _, jh, th, P_diag, P_off, _ = setup
    jv = jamg.compute_level_values(jh, jnp.asarray(P_diag),
                                   jnp.asarray(P_off))
    tv = tamg.compute_level_values(th, torch.as_tensor(P_diag),
                                   torch.as_tensor(P_off))
    assert len(tv) == len(jv) == len(th.levels) + 1
    for li, ((jd, jo), (td, to)) in enumerate(zip(jv, tv)):
        _close(f"diag {li}", td, jd, 1e-5)
        _close(f"off {li}", to, jo, 1e-5)
        assert td.is_contiguous() and to.is_contiguous()


def test_level_values_add_in_a_fixed_order(setup):
    """Each coarse entry is the sum of its finer values in ascending flat
    order, accumulated in float32: the same bits on every run."""
    _, _, _, th, P_diag, P_off, _ = setup
    tv = tamg.compute_level_values(th, torch.as_tensor(P_diag),
                                   torch.as_tensor(P_off))
    lvl = th.levels[0]
    flat = np.concatenate([P_diag, P_off.reshape(-1)])
    target = lvl.rap_target.numpy()
    want = np.zeros(lvl.n * (lvl.k + 1) + 1, np.float32)
    for i in np.argsort(target, kind="stable"):
        want[target[i]] = np.float32(want[target[i]] + flat[i])
    want = want[:-1].reshape(lvl.n, lvl.k + 1)
    np.testing.assert_array_equal(tv[1][0].numpy(), want[:, 0])
    np.testing.assert_array_equal(tv[1][1].numpy(), want[:, 1:])
    assert int(lvl.rap_lengths.sum()) == len(flat)


@pytest.mark.parametrize("opts", [
    {}, {"smoother": "jacobi", "smooth_arg": 2},
    {"smoother": "cheb", "smooth_arg": 2},
    {"smoother": "cheb", "smooth_arg": 3, "overcorrect": 1.5}],
    ids=["jacobi1", "jacobi2", "cheb2", "cheb3-over1.5"])
def test_v_cycle(setup, opts):
    jm, tm, jh, th, P_diag, P_off, b = setup
    jv = jamg.compute_level_values(jh, jnp.asarray(P_diag),
                                   jnp.asarray(P_off))
    tv = tamg.compute_level_values(th, torch.as_tensor(P_diag),
                                   torch.as_tensor(P_off))
    x0 = (b / P_diag).astype(np.float32)
    ref = jamg.v_cycle(jh, jv, jm, jnp.asarray(b), jnp.asarray(x0), **opts)
    got = tamg.v_cycle(th, tv, tm, torch.as_tensor(b), torch.as_tensor(x0),
                       **opts)
    _close("v_cycle", got, ref, 1e-4)
    # the cycle reduces the residual of the level-0 system
    A = lambda x: P_diag * x + (P_off * x[tm.ck_neighbor.numpy()]).sum(1)
    assert np.linalg.norm(b - A(got.numpy())) < np.linalg.norm(b - A(x0))


@pytest.mark.parametrize("frozen", [False, True], ids=["fresh", "frozen"])
def test_make_pressure_solve(setup, frozen):
    jm, tm, jh, th, P_diag, P_off, b = setup
    jsys = _Sys(P_diag, P_off, jnp.asarray)
    tsys = _Sys(P_diag, P_off, torch.as_tensor)
    jf = tf = None
    if frozen:
        # frozen coarse operators from a slightly different assembly
        jf = jamg.coarse_level_values(jh, jnp.asarray(P_diag * 1.1),
                                      jnp.asarray(P_off * 1.1))
        tf = tamg.coarse_level_values(th, torch.as_tensor(P_diag * 1.1),
                                      torch.as_tensor(P_off * 1.1))
        for (jd, jo), (td, to) in zip(jf[0], tf[0]):
            _close("frozen diag", td, jd, 1e-5)
            _close("frozen off", to, jo, 1e-5)
    opts = {"smoother": "cheb", "smooth_arg": 2}
    jps = jamg.make_pressure_solve(jh, jm, jsys, cycle_opts=opts, frozen=jf)
    tps = tamg.make_pressure_solve(th, tm, tsys, cycle_opts=opts, frozen=tf)
    _close("pressure_solve", tps(torch.as_tensor(b)), jps(jnp.asarray(b)),
           1e-4)


def test_frozen_from_the_same_assembly_is_bitwise_the_fresh_solve(setup):
    _, tm, _, th, P_diag, P_off, b = setup
    tsys = _Sys(P_diag, P_off, torch.as_tensor)
    fz = tamg.coarse_level_values(th, tsys.P_diag, tsys.P_off)
    fresh = tamg.make_pressure_solve(th, tm, tsys)(torch.as_tensor(b))
    froze = tamg.make_pressure_solve(th, tm, tsys, frozen=fz)(
        torch.as_tensor(b))
    assert torch.equal(fresh, froze)


def test_tiny_mesh_pools_its_padding_cells():
    """47 cells pad to 128 device cells; the 81 padding cells go to one
    trash aggregate without restriction members, as in the JAX package."""
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_delaunay_mesh(geo, 0.3, 0.3, 1.2, (3.0, 1.0))
    assert mesh.num_cells <= 100
    jh = jamg.build_hierarchy_for_mesh(jencode(mesh))
    th = tamg.build_hierarchy_for_mesh(tencode(mesh, device="cpu"))
    assert [l.n for l in th.levels] == [l.n for l in jh.levels]
    np.testing.assert_array_equal(th.levels[0].agg.numpy()[:, 0],
                                  np.asarray(jh.levels[0].agg))
    trash = th.levels[0].n - 1
    assert (th.levels[0].agg.numpy()[mesh.num_cells:, 0] == trash).all()
    assert float(th.levels[0].members_mask[trash].sum()) == 0.0


@pytest.mark.parametrize("overcorrect", [1.0, 1.5])
def test_prolong_add_matches_the_jax_update(setup, overcorrect):
    """The fused prolongation's plain version against the JAX package's
    ``xs + overcorrect * xs_c[agg]`` on every level's aggregate map:
    bitwise at 1.0 (the product is exact); at 1.5 within one ulp of the
    result, since XLA may contract the product and the sum into an FMA."""
    from cfd2_tpu_torch.ops import banded_kernels as bk
    _, _, jh, th, *_ = setup
    rng = np.random.default_rng(21)
    for jl, tl in zip(jh.levels, th.levels):
        n_fine = tl.agg.shape[0]
        xs = rng.standard_normal(n_fine).astype(np.float32)
        xc = rng.standard_normal(tl.n).astype(np.float32)
        ref = np.asarray(jnp.asarray(xs)
                         + overcorrect * jnp.asarray(xc)[jl.agg])
        got = bk.banded_prolong_add(torch.as_tensor(xs), torch.as_tensor(xc),
                                    tl.agg, overcorrect).numpy()
        if overcorrect == 1.0:
            np.testing.assert_array_equal(got, ref)
        else:
            ulp = np.spacing(np.abs(ref).astype(np.float32))
            assert (np.abs(got - ref) <= ulp).all()


@pytest.mark.parametrize("overcorrect", [1.0, 1.5])
def test_v_cycle_prolongs_through_the_fused_update(setup, monkeypatch,
                                                   overcorrect):
    """Each level's prolongation is one banded_prolong_add call (no separate
    gather), with the cycle's overcorrection, and gives the bits of the
    eager gather, product and sum."""
    from cfd2_tpu_torch.ops import banded_kernels as bk
    _, tm, _, th, P_diag, P_off, b = setup
    tv = tamg.compute_level_values(th, torch.as_tensor(P_diag),
                                   torch.as_tensor(P_off))
    x0 = torch.as_tensor((b / P_diag).astype(np.float32))
    calls = {"banded_gather": 0, "banded_prolong_add": []}
    gather, prolong = bk.banded_gather, bk.banded_prolong_add

    def spy_gather(*a, **k):
        calls["banded_gather"] += 1
        return gather(*a, **k)

    def spy_prolong(base, x, idx, alpha):
        calls["banded_prolong_add"].append(alpha)
        return prolong(base, x, idx, alpha)

    def eager(base, x, idx, alpha):
        return base + alpha * gather(x, idx)[:, 0]

    monkeypatch.setattr(bk, "banded_gather", spy_gather)
    monkeypatch.setattr(bk, "banded_prolong_add", spy_prolong)
    got = tamg.v_cycle(th, tv, tm, torch.as_tensor(b), x0,
                       overcorrect=overcorrect)
    assert calls == {"banded_gather": 0,
                     "banded_prolong_add": [overcorrect] * len(th.levels)}
    monkeypatch.setattr(bk, "banded_prolong_add", eager)
    assert torch.equal(got, tamg.v_cycle(th, tv, tm, torch.as_tensor(b), x0,
                                         overcorrect=overcorrect))
