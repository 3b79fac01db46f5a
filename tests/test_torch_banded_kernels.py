"""The banded kernels' plain versions (what the port's wrappers run on CPU
tensors) against cfd2_tpu.ops.banded_gather, whose Pallas kernels run in
interpret mode on the CPU, and the DeviceMesh methods built on them against
the JAX package's on the same meshes.

Tolerances: the gather is a copy, so it must be exact.  The dots and the
Jacobi sweeps run the same float32 products on both sides and differ in the
order of the per-row sum over slots (the Pallas walk accumulates window by
window, PyTorch reduces along the slot axis), a few ulps of the largest
term: 1e-5 relative to each output's largest magnitude.  On the slot-capped
Voronoi mesh the port's dot walks all K slots where the JAX package walks 8
and adds a COO correction: the same terms in another order, same bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd2_tpu.mesh import (ChannelWithObstacle, generate_delaunay_mesh,
                           generate_voronoi_mesh)
from cfd2_tpu.ops import banded_gather as jbg
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.ops import banded_kernels as bk
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode

torch.set_num_threads(1)
RTOL = 1e-5

# (M, n_src, K, half-width of the band)
MAPS = {
    "mesh_k3": (512, 512, 3, 60),
    "mesh_k9": (384, 384, 9, 60),
    "restriction": (200, 1400, 7, 40),
    "prolongation": (600, 200, 1, 3),
}
PRODS = {
    "spmv": (3, 6, (((0, 0), (1, 2)), ((0, 1), (2, 2)),
                    ((3, 0), (4, 1), (5, 2)))),
    "mom2": (2, 1, (((0, 0),), ((0, 1),))),
    "schur_rhs": (2, 2, (((0, 0), (1, 1)),)),
    "grad": (1, 2, (((0, 0),), ((1, 0),))),
    "scalar": (1, 1, (((0, 0),),)),
}


def _map(name):
    M, n_src, K, band = MAPS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    centre = (np.arange(M) * (n_src / M)).astype(np.int64)[:, None]
    idx = np.clip(centre + rng.integers(-band, band + 1, (M, K)), 0,
                  n_src - 1)
    lane, sel, base, W = jbg.build_banded_map(idx, n_src)
    planes = (jnp.asarray(lane), jnp.asarray(sel), jnp.asarray(base), W)
    return idx, n_src, planes, rng


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= rtol * scale


@pytest.mark.parametrize("tail", [None, 2, 6])
@pytest.mark.parametrize("name", list(MAPS))
def test_gather_matches_banded_gather_nk(name, tail):
    idx, n_src, (lane, sel, base, W), rng = _map(name)
    shape = (n_src,) if tail is None else (n_src, tail)
    x = rng.standard_normal(shape).astype(np.float32)
    ref = jbg.banded_gather_nk(jnp.asarray(x), lane, sel, base, W,
                               m_out=idx.shape[0])
    got = bk.banded_gather(_t(x), _t(idx, torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("form", list(PRODS))
@pytest.mark.parametrize("name", ["mesh_k3", "mesh_k9", "restriction"])
def test_dot_matches_banded_dot(name, form):
    idx, n_src, (lane, sel, base, W), rng = _map(name)
    n_x, n_off, prods = PRODS[form]
    xs = [rng.standard_normal(n_src).astype(np.float32) for _ in range(n_x)]
    offs = [rng.standard_normal(idx.shape).astype(np.float32)
            for _ in range(n_off)]
    ref = jbg.banded_dot(tuple(map(jnp.asarray, xs)),
                         tuple(map(jnp.asarray, offs)), lane, sel, base, W,
                         prods, m_out=idx.shape[0])
    got = bk.banded_dot([_t(x) for x in xs], [_t(o) for o in offs],
                        _t(idx, torch.int32), prods)
    assert len(got) == len(ref) == len(prods)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("sweeps", [1, 3, 8])
@pytest.mark.parametrize("name", ["mesh_k3", "mesh_k9"])
def test_sweeps_match_banded_jacobi_sweeps(name, sweeps):
    idx, n, (lane, sel, base, W), rng = _map(name)
    K = idx.shape[1]
    rs = [rng.standard_normal(n).astype(np.float32) for _ in range(2)]
    dinv = (1.0 / (1.0 + rng.random(n))).astype(np.float32)
    off = (rng.standard_normal((n, K)) * 0.5 / K).astype(np.float32)
    ref = jbg.banded_jacobi_sweeps(tuple(map(jnp.asarray, rs)),
                                   jnp.asarray(dinv), jnp.asarray(off), lane,
                                   sel, base[:, None], W, sweeps, m_out=n)
    got = bk.banded_jacobi_sweeps([_t(r) for r in rs], _t(dinv), _t(off),
                                  _t(idx, torch.int32), sweeps)
    for g, r in zip(got, ref):
        _close(g, r)


def test_sweeps_equal_the_per_sweep_dot_loop():
    """banded_jacobi_sweeps computes ellsys._momentum_solve's loop."""
    idx, n, _, rng = _map("mesh_k3")
    ti = _t(idx, torch.int32)
    r = _t(rng.standard_normal(n))
    dinv = _t(1.0 / (1.0 + rng.random(n)))
    off = _t(rng.standard_normal(idx.shape) * 0.1)
    z = dinv * r
    for _ in range(4):
        (s,) = bk.banded_dot((z,), (off,), ti, (((0, 0),),))
        z = dinv * (r - s)
    (got,) = bk.banded_jacobi_sweeps((r,), dinv, off, ti, 5)
    _close(got, z.numpy())


def test_k_cap_drops_the_slots_beyond_it():
    idx, n, _, rng = _map("mesh_k9")
    ti = _t(idx, torch.int32)
    r = _t(rng.standard_normal(n))
    dinv = _t(1.0 / (1.0 + rng.random(n)))
    off = _t(rng.standard_normal(idx.shape) * 0.05)
    (capped,) = bk.banded_jacobi_sweeps((r,), dinv, off, ti, 4, k_cap=8)
    off8 = off.clone()
    off8[:, 8:] = 0.0
    (zeroed,) = bk.banded_jacobi_sweeps((r,), dinv, off8, ti, 4)
    (full,) = bk.banded_jacobi_sweeps((r,), dinv, off, ti, 4)
    _close(capped, zeroed.numpy())
    assert float((capped - full).abs().max()) > 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    x = torch.zeros(4)
    with pytest.raises(ValueError):
        bk.banded_jacobi_sweeps((x,), x, torch.zeros(4, 2), idx, 0)
    with pytest.raises(ValueError):
        bk.banded_gather(x.to("meta"), idx.to("meta"))


# ----------------------------------------------------------------------
# DeviceMesh.gather / banded_dot / banded_jacobi_sweeps on real meshes.


@pytest.fixture(scope="module", params=["delaunay", "voronoi"])
def meshes(request):
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    gen = {"delaunay": generate_delaunay_mesh,
           "voronoi": generate_voronoi_mesh}[request.param]
    mesh = gen(geo, 0.06, 0.06, 1.2, (3.0, 1.0), seed=2)
    jm = jencode(mesh)
    tm = tencode(mesh, device="cpu")
    assert jm.banded and tm.banded
    assert jm.bd_k == tm.bd_k
    if request.param == "voronoi":
        assert tm.bd_k == 8 and tm.max_faces > 8   # the slot-capped map
    return jm, tm


def test_mesh_gather(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(5)
    for shape in ((jm.num_cells,), (jm.num_cells, 6)):
        x = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(tm.gather(_t(x)).numpy(),
                                      np.asarray(jm.gather(jnp.asarray(x))))


def _masked_off(jm, rng, scale=0.2):
    """Coefficients that are zero on pad slots (the assembly invariant)."""
    return (rng.standard_normal((jm.num_cells, jm.max_faces)) * scale
            * np.asarray(jm.ck_mask)).astype(np.float32)


def test_mesh_banded_dot(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(6)
    n_x, n_off, prods = PRODS["spmv"]
    xs = [rng.standard_normal(jm.num_cells).astype(np.float32)
          for _ in range(n_x)]
    offs = [_masked_off(jm, rng) for _ in range(n_off)]
    ref = jm.banded_dot(tuple(map(jnp.asarray, xs)),
                        tuple(map(jnp.asarray, offs)), prods)
    got = tm.banded_dot([_t(x) for x in xs], [_t(o) for o in offs], prods)
    for g, r in zip(got, ref):
        _close(g, r)


def test_mesh_jacobi_sweeps(meshes):
    """On the capped Voronoi map both sides drop the slots >= bd_k."""
    jm, tm = meshes
    rng = np.random.default_rng(7)
    n = jm.num_cells
    rs = [rng.standard_normal(n).astype(np.float32) for _ in range(2)]
    dinv = (1.0 / (1.0 + rng.random(n))).astype(np.float32)
    off = _masked_off(jm, rng, 0.5 / jm.max_faces)
    ref = jm.banded_jacobi_sweeps(tuple(map(jnp.asarray, rs)),
                                  jnp.asarray(dinv), jnp.asarray(off), 8)
    got = tm.banded_jacobi_sweeps([_t(r) for r in rs], _t(dinv), _t(off), 8)
    for g, r in zip(got, ref):
        _close(g, r)
    assert jm.banded_sweeps_fit(2) == tm.banded_sweeps_fit(2)
