"""The banded kernels' plain versions (what the port's wrappers run on CPU
tensors) against cfd2_tpu.ops.banded_gather, whose Pallas kernels run in
interpret mode on the CPU, and the DeviceMesh methods built on them against
the JAX package's on the same meshes.

Tolerances: the gather is a copy, so it must be exact.  The dots and the
Jacobi sweeps run the same float32 products on both sides and differ in the
order of the per-row sum over slots (the Pallas walk accumulates window by
window, the plain versions add the slots in order), a few ulps of the largest
term: 1e-5 relative to each output's largest magnitude.  On the slot-capped
Voronoi mesh the port's dot walks all K slots where the JAX package walks 8
and adds a COO correction: the same terms in another order, same bound.

The plain dot does the card's arithmetic: each slot's further products
added by a fused multiply-add, as nvcc contracts the kernel's
``s += o * x``, and as XLA contracts the JAX package's on the CPU.  Two
tests pin it: the emulated multiply-add is correctly rounded, and at the
403k Delaunay case's length the plain spmv's float32 error is XLA's and
under that of every product rounded on its own (the plain version before,
whose larger residual error held that case's later step-2 solves at the
restart cap)."""

import jax
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


@pytest.mark.parametrize("tail", [None, 2, 3, 6])
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


# Every product list the solver passes (ellsys.spmv, _mom_dot2,
# chebyshev_pressure_solve, schur_precond twice; amg._ONE_DOT), with the
# numbers of operands and planes it passes them with.
SOLVER_PRODS = {
    "spmv": (3, 6, (((0, 0), (1, 2)), ((0, 1), (2, 2)),
                    ((3, 0), (4, 1), (5, 2)))),
    "mom2": (2, 1, (((0, 0),), ((0, 1),))),
    "scalar": (1, 1, (((0, 0),),)),
    "schur_rhs": (2, 2, (((0, 0), (1, 1)),)),
    "grad": (1, 2, (((0, 0),), ((1, 0),))),
}


@pytest.mark.parametrize("name", list(SOLVER_PRODS))
def test_solver_product_lists_map_to_named_forms(name):
    n_x, n_off, prods = SOLVER_PRODS[name]
    assert bk.dot_form(prods, n_x, n_off) == name
    # Lists where the solver passes tuples name the same form.
    assert bk.dot_form([list(map(list, p)) for p in prods], n_x, n_off) == name
    assert bk.DOT_FORMS[name] == (n_x, n_off, prods)


def test_amg_one_dot_is_the_scalar_form():
    from cfd2_tpu_torch.ops import amg as tamg
    assert bk.dot_form(tamg._ONE_DOT, 1, 1) == "scalar"


@pytest.mark.parametrize("n_x,n_off,prods", [
    (2, 2, (((1, 0), (0, 1)),)),               # schur_rhs with planes swapped
    (2, 1, (((0, 1),), ((0, 0),))),            # mom2 with outputs swapped
    (2, 2, (((0, 0),),)),                      # scalar with spare operands
    (3, 6, (((0, 0), (1, 2)), ((0, 1), (2, 2)))),   # spmv without its p row
])
def test_unknown_product_lists_map_to_the_generic_form(n_x, n_off, prods):
    assert bk.dot_form(prods, n_x, n_off) == "generic"
    idx, n_src, _, rng = _map("mesh_k3")
    xs = [_t(rng.standard_normal(n_src)) for _ in range(n_x)]
    offs = [_t(rng.standard_normal(idx.shape)) for _ in range(n_off)]
    got = bk.banded_dot(xs, offs, _t(idx, torch.int32), prods)
    assert len(got) == len(prods)


@pytest.mark.parametrize("n_x,n_off,prods", [
    (1, 1, (((1, 0),),)),            # names no plane
    (1, 1, (((0, 1),),)),            # names no operand
    (4, 1, (((0, 0),),)),            # too many operands
    (1, 1, (((0, 0),),) * 4),        # too many outputs
])
def test_dot_plan_refuses_bad_lists(n_x, n_off, prods):
    with pytest.raises(ValueError):
        bk.dot_form(prods, n_x, n_off)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    x = torch.zeros(4)
    with pytest.raises(ValueError):
        bk.banded_jacobi_sweeps((x,), x, torch.zeros(4, 2), idx, 0)
    with pytest.raises(ValueError):
        bk.banded_gather(x.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError):
        bk.banded_prolong_add(x.to("meta"), x.to("meta"), idx.to("meta"), 1.0)


@pytest.mark.parametrize("alpha", [1.0, 1.5])
def test_prolong_add_is_the_eager_gather_product_and_sum(alpha):
    idx, n_src, _, rng = _map("prolongation")
    ti = _t(idx, torch.int32)
    base = _t(rng.standard_normal(idx.shape[0]))
    x = _t(rng.standard_normal(n_src))
    got = bk.banded_prolong_add(base, x, ti, alpha)
    assert torch.equal(got, base + alpha * bk.banded_gather(x, ti)[:, 0])
    assert torch.equal(got, bk.banded_prolong_add_ref(base, x, ti, alpha))


def _launch_path(monkeypatch):
    """Drive the CUDA branch of the wrappers with CPU tensors up to the
    build, which raises: what a wrapper refuses, it refuses before that."""
    from cfd2_tpu_torch.ops import _build
    monkeypatch.setattr(bk, "_cuda_or_cpu", lambda t: True)

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)


@pytest.mark.parametrize("C", [2, 6])
def test_gather_refuses_a_misaligned_even_width(monkeypatch, C):
    """Even widths are read as float2: a view that starts at an odd float
    is refused; the same data at an aligned start reaches the launch."""
    _launch_path(monkeypatch)
    idx = torch.zeros((4, 3), dtype=torch.int32)
    raw = torch.zeros(5 * 6 + 2)
    with pytest.raises(ValueError, match="aligned"):
        bk.banded_gather(raw[1:1 + 5 * C].view(5, C), idx)
    with pytest.raises(RuntimeError, match="nvcc"):
        bk.banded_gather(raw[2:2 + 5 * C].view(5, C), idx)
    with pytest.raises(RuntimeError, match="nvcc"):   # odd C: no float2
        bk.banded_gather(raw[1:1 + 5 * 3].view(5, 3), idx)


@pytest.mark.parametrize("case", ["wide_map", "base_shape", "x_2d",
                                  "strided_base", "idx_int64"])
def test_prolong_add_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    _launch_path(monkeypatch)
    idx = torch.zeros((6, 1), dtype=torch.int32)
    base, x = torch.zeros(6), torch.zeros(4)
    args = {"wide_map": (base, x, torch.zeros((6, 2), dtype=torch.int32)),
            "base_shape": (torch.zeros(5), x, idx),
            "x_2d": (base, torch.zeros(4, 1), idx),
            "strided_base": (torch.zeros(12)[::2], x, idx),
            "idx_int64": (base, x, idx.long())}[case]
    with pytest.raises((ValueError, TypeError)):
        bk.banded_prolong_add(*args, 1.0)


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


def test_fma_is_correctly_rounded():
    """``banded_kernels.fma`` against the exact a * b + c rounded to
    float32 (Python fractions), on seeded values and on sums that a plain
    float64 evaluation would round twice: one bit past a float32 midpoint,
    either sign, and the midpoint itself (ties to even)."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal(2000).astype(np.float32)
               * np.float32(10.0) ** rng.integers(-6, 6, 2000)
               for _ in range(3))
    e = np.float32(1 + 2 ** -12)
    a = np.concatenate([a, [e, -e, e, e]]).astype(np.float32)
    b = np.concatenate([b, [e, e, e, e]]).astype(np.float32)
    c = np.concatenate([c, [2 ** -80, -2 ** -80, -2 ** -80, 0.0]]
                       ).astype(np.float32)
    got = bk.fma(_t(a), _t(b), _t(c)).numpy()

    def rounded(x):   # the float32 nearest the fraction x, ties to even
        f = np.float32(float(x))
        cands = [np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))]
        return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                         int(v.view(np.uint32)) & 1))

    want = [rounded(Fraction(float(x)) * Fraction(float(y))
                    + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(want, np.float32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert not np.array_equal(naive[-4:], got[-4:])


def test_plain_spmv_rounds_as_the_card_at_full_size():
    """The spmv product form of the plain dot at the 403k Delaunay case's
    map shape (403,584 rows x 3 slots), its pressure row's three products
    cancelling as continuity makes them: the norm of its float32 error is
    XLA's contracted arithmetic's (within 2%), and every product rounded on
    its own (the plain version before) errs by 30% more."""
    rng = np.random.default_rng(3)
    M, K = 403_584, 3
    idx = rng.integers(0, M, (M, K)).astype(np.int32)
    xs = [rng.standard_normal(M).astype(np.float32) for _ in range(3)]
    g = [x[idx] for x in xs]
    offs = [rng.standard_normal((M, K)).astype(np.float32) for _ in range(5)]
    t = offs[3].astype(np.float64) * g[0] + offs[4] * g[1]
    offs.append((-(t / g[2]) * (1 + 1e-3 * rng.standard_normal((M, K))))
                .astype(np.float32))
    pairs = ((3, 0), (4, 1), (5, 2))
    exact = sum(offs[o].astype(np.float64) * g[c] for o, c in pairs).sum(1)

    def err(v):
        return (np.linalg.norm(np.asarray(v, np.float64) - exact)
                / np.linalg.norm(exact))

    got = bk.banded_dot([_t(x) for x in xs], [_t(o) for o in offs],
                        _t(idx, torch.int32), PRODS["spmv"][2])[2]
    ps = [offs[o] * g[c] for o, c in pairs]
    separate = ps[0] + ps[1] + ps[2]
    xla = jax.jit(lambda o, g: sum(o[i] * g[c] for i, c in pairs))(offs, g)
    slots = lambda s: s[:, 0] + s[:, 1] + s[:, 2]
    assert err(got.numpy()) <= 1.02 * err(slots(np.asarray(xla)))
    assert err(slots(separate)) >= 1.3 * err(got.numpy())


def test_plain_sweeps_take_a_zero_slot_cap():
    """A slot cap of 0 leaves every sweep the seed: z = dinv * r (the
    kernels take it; the plain versions' in-order slot sum must too)."""
    idx, n, _, rng = _map("mesh_k3")
    r = _t(rng.standard_normal(n))
    dinv = _t(1.0 / (1.0 + rng.random(n)))
    off = _t(rng.standard_normal(idx.shape))
    (got,) = bk.banded_jacobi_sweeps_ref((r,), dinv, off, _t(idx, torch.int32),
                                         3, k_cap=0)
    assert torch.equal(got, dinv * r)
