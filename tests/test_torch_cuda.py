"""The CUDA kernels against their plain versions on a GPU.  Marked ``cuda``;
skipped where no GPU is present (chip_smoke.py runs the same comparisons on
the card as part of its phases).  Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

import torch_spatial_ranks as ranks
from cfd2_tpu_torch.ops import banded_kernels as bk
from cfd2_tpu_torch.ops import stencil_kernels as sk

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _grid_system(ny, nx, seed, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return (t(rng.uniform(1, 2, (ny, nx))),
            t(rng.standard_normal((4, ny, nx)) * 0.1),
            t(rng.standard_normal((ny, nx))),
            t(rng.standard_normal((ny, nx))))


@pytest.mark.parametrize("ny,nx,sweeps", [(37, 53, 1), (37, 53, 2),
                                          (16, 24, 1), (300, 128, 1)])
def test_leg_kernel_matches_plain(cuda, ny, nx, sweeps):
    diag2, off2, x, b = _grid_system(ny, nx, 0, cuda)
    before = sk.LAUNCHES["rbgs_leg"]
    gx, gr = sk.rbgs_leg(x, diag2, off2, b, sweeps, residual=True)
    rx, rr = sk.rbgs_leg_ref(x, diag2, off2, b, sweeps, residual=True)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["rbgs_leg"] == before + 1
    assert float((gx - rx).abs().max()) <= TOL
    assert float((gr - rr).abs().max()) <= TOL


@pytest.mark.parametrize("ny,nx", [(37, 53), (16, 24), (19, 56), (10, 28),
                                   (74, 111), (5, 3), (300, 128)])
def test_fused_leg_kernels_match_plain_composition(cuda, ny, nx):
    """Both fused forms against the plain leg composed with the plain grid
    transfers, on odd and even grids; one launch each."""
    diag2, off2, x, b = _grid_system(ny, nx, 3, cuda)
    coarse = sk.coarse_grid_of((ny, nx))
    xc = _rand(coarse, 4, cuda)
    before = sk.LAUNCHES["rbgs_leg"]
    gx, gb = sk.rbgs_leg(x, diag2, off2, b, restrict_to=coarse)
    up = sk.rbgs_leg(x, diag2, off2, b, add_prolong=xc)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["rbgs_leg"] == before + 2
    rx, rr = sk.rbgs_leg_ref(x, diag2, off2, b, 1, residual=True)
    assert float((gx - rx).abs().max()) <= TOL
    assert float((gb - sk.restrict2(rr, coarse)).abs().max()) <= TOL
    ref_up = sk.rbgs_leg_ref(x + sk.prolong2(xc, (ny, nx)), diag2, off2, b, 1)
    assert float((up - ref_up).abs().max()) <= TOL


@pytest.mark.parametrize("ny,nx", [(400, 1400), (295, 883), (75, 133)])
def test_leg_kernel_tile_shapes_agree(cuda, ny, nx):
    """Every tile shape of the leg kernel computes the same leg: grids on
    which it takes its 16x64, 16x32 and 4x32 tile."""
    diag2, off2, x, b = _grid_system(ny, nx, 5, cuda)
    gx, gr = sk.rbgs_leg(x, diag2, off2, b, residual=True)
    rx, rr = sk.rbgs_leg_ref(x, diag2, off2, b, 1, residual=True)
    torch.cuda.synchronize()
    assert float((gx - rx).abs().max()) <= TOL
    assert float((gr - rr).abs().max()) <= TOL


def test_fused_leg_refuses_bad_input(cuda):
    diag2, off2, x, b = _grid_system(16, 24, 2, cuda)
    with pytest.raises(ValueError):
        sk.rbgs_leg(x, diag2, off2, b, sweeps=2, restrict_to=(8, 12))
    with pytest.raises(TypeError):
        sk.rbgs_leg(x, diag2, off2, b,
                    add_prolong=torch.zeros(8, 12, device=cuda).double())
    with pytest.raises(ValueError):
        sk.rbgs_leg(x, diag2, off2, b,
                    add_prolong=torch.zeros(8, 12))   # on the CPU


@pytest.mark.parametrize("ny,nx", [(37, 53), (16, 24), (19, 56), (10, 28),
                                   (5, 3), (589, 1765)])
@pytest.mark.parametrize("parity", [0, 1])
def test_half_sweep_kernel_matches_plain(cuda, parity, ny, nx):
    """The planar half-sweep on odd and even grids, into a new tensor and
    in place; the other colour is copied (or left) bit for bit."""
    diag2, off2, x, b = _grid_system(ny, nx, 1, cuda)
    before = sk.LAUNCHES["rbgs_half_sweep"]
    got = sk.rbgs_half_sweep(x, diag2, off2, b, parity)
    xi = x.clone()
    inplace = sk.rbgs_half_sweep(xi, diag2, off2, b, parity, in_place=True)
    ref = sk.rbgs_half_sweep_ref(x, diag2, off2, b, parity)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["rbgs_half_sweep"] == before + 2
    assert inplace is xi
    other = (sk._color2(ny, nx, cuda) + parity) % 2 == 1
    for g in (got, xi):
        assert float((g - ref).abs().max()) <= TOL
        assert torch.equal(g[other], x[other])


def test_half_sweep_pair_matches_the_leg(cuda):
    diag2, off2, x, b = _grid_system(589, 1765, 6, cuda)
    got = sk.smooth_rbgs_half_sweeps(diag2, off2, x, b)
    ref = sk.rbgs_leg_ref(x, diag2, off2, b, 1)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= TOL


def test_wrapper_refuses_bad_input(cuda):
    diag2, off2, x, b = _grid_system(16, 24, 2, cuda)
    with pytest.raises(TypeError):
        sk.rbgs_leg(x.double(), diag2, off2, b)
    with pytest.raises(ValueError):
        sk.rbgs_leg(x.T, diag2, off2, b)
    with pytest.raises(ValueError):
        sk.rbgs_half_sweep(x, diag2, off2.transpose(1, 2).contiguous()
                           .transpose(1, 2), b, 0)
    with pytest.raises(ValueError):
        sk.rbgs_half_sweep(x, diag2, off2[:, :, :23], b, 0)


# ----------------------------------------------------------------------
# The stencil kernels (csrc/stencil.cu): bit-equal to their plain versions.

STENCIL_GRIDS = [(7, 19), (37, 53), (300, 128), (589, 1765)]


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("ny,nx", STENCIL_GRIDS)
def test_stencil_kernels_equal_plain_bit_for_bit(cuda, ny, nx, halo):
    """All four kernels, the predict at sweeps 1-14 (one launch of temporal
    tiles up to 12, one per sweep above), with and without halo rows:
    max-abs error 0."""
    p = ranks.stencil_tensors((ny, nx), 40 + ny, cuda)
    kw = dict(halo=ranks.made_up_halo if halo else None,
              sweeps=tuple(range(1, 15)))
    got = ranks.stencil_kernels(p, **kw)
    ref = ranks.stencil_kernels(p, plain=True, **kw)
    for key, r in ref.items():
        np.testing.assert_array_equal(got[key], r, err_msg=key)


# The streamed predict's edge cases: one cell, one row, one column, grids
# narrower and shorter than one band, ragged last bands and row blocks in
# both directions, and the two full-size grids of the structured path.
MOMENTUM_GRIDS = [(1, 1), (1, 300), (300, 1), (5, 7), (19, 243), (37, 485),
                  (130, 250), (589, 1765), (834, 2500)]


@pytest.mark.parametrize("ny,nx", MOMENTUM_GRIDS)
def test_momentum_jacobi_equals_plain_at_every_sweep_count(cuda, ny, nx):
    """The one-launch predict at sweeps 1-12 against momentum_jacobi_ref:
    torch.equal, one launch per call."""
    p = ranks.stencil_tensors((ny, nx), 70 + ny, cuda)
    r2, dinv, off = p["r"][:2], p["diag_u_inv2"], p["off_mom"]
    for sweeps in range(1, sk.TILE_MAX_SWEEPS + 1):
        before = sk.LAUNCHES["momentum_jacobi"]
        got = sk.momentum_jacobi(r2, dinv, off, sweeps)
        assert sk.LAUNCHES["momentum_jacobi"] == before + 1
        ref = sk.momentum_jacobi_ref(r2, dinv, off, sweeps)
        assert torch.equal(got, ref), (ny, nx, sweeps)


def test_stencil_kernels_count_their_launches(cuda):
    p = ranks.stencil_tensors((37, 53), 3, cuda)
    offs = tuple(p[k] for k in ("off_mom", "off_up", "off_vp", "off_pu",
                                "off_pv", "off_pp"))
    diags = tuple(p[k] for k in ("diag_u2", "diag_up2", "diag_vp2",
                                 "diag_pu2", "diag_pv2", "diag_pp2"))
    sk.reset_launches()
    sk.coupled_spmv(p["x"], offs, diags)
    sk.schur_rhs(p["r"][2], p["z"], p["diag_pu2"], p["diag_pv2"],
                 p["off_pu"], p["off_pv"])
    sk.pressure_gradient(p["zp"], p["diag_up2"], p["diag_vp2"], p["off_up"],
                         p["off_vp"])
    for sweeps in (1, 2, 8, 12, 14):
        sk.momentum_jacobi(p["r"][:2], p["diag_u_inv2"], p["off_mom"], sweeps)
        sk.momentum_jacobi(p["r"][:2], p["diag_u_inv2"], p["off_mom"], sweeps,
                           halo=ranks.made_up_halo)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["coupled_spmv"] == 1
    assert sk.LAUNCHES["schur_rhs"] == sk.LAUNCHES["pressure_gradient"] == 1
    assert sk.LAUNCHES["momentum_jacobi"] == ((1 + 1 + 1 + 1 + 14)
                                              + (1 + 2 + 8 + 12 + 14))


def test_stencil_wrappers_refuse_bad_input(cuda):
    p = ranks.stencil_tensors((16, 24), 4, cuda)
    offs = tuple(p[k] for k in ("off_mom", "off_up", "off_vp", "off_pu",
                                "off_pv", "off_pp"))
    diags = tuple(p[k] for k in ("diag_u2", "diag_up2", "diag_vp2",
                                 "diag_pu2", "diag_pv2", "diag_pp2"))
    before = dict(sk.LAUNCHES)
    with pytest.raises(TypeError):
        sk.coupled_spmv(p["x"].to(torch.bfloat16), offs, diags)
    with pytest.raises(ValueError):
        sk.coupled_spmv(p["x"], offs[:5] + (offs[5].transpose(1, 2)
                                             .contiguous().transpose(1, 2),),
                        diags)
    with pytest.raises(ValueError):
        sk.momentum_jacobi(p["r"][:2], p["diag_u_inv2"][:, :23],
                           p["off_mom"], 8)
    with pytest.raises(ValueError):
        sk.schur_rhs(p["r"][2], p["z"], p["diag_pu2"], p["diag_pv2"],
                     p["off_pu"], p["off_pv"], below=p["z"][:, :1])
    with pytest.raises(TypeError):
        sk.pressure_gradient(p["zp"].double(), p["diag_up2"], p["diag_vp2"],
                             p["off_up"], p["off_vp"])
    assert sk.LAUNCHES == before
    # Mis-shaped halo rows come back from the exchange after the seed's
    # launch, and are refused before the first sweep's.
    with pytest.raises(ValueError):
        sk.momentum_jacobi(p["r"][:2], p["diag_u_inv2"], p["off_mom"], 8,
                           halo=lambda z: (z[:, :1], z[:, :2]))
    assert sk.LAUNCHES == {**before,
                           "momentum_jacobi": before["momentum_jacobi"] + 1}


def test_preconditioner_dispatch_on_the_card(cuda):
    """schur_precond_planar on a float32 system on the card goes through
    the four kernels (one Schur right-hand side, one gradient, two
    predicts) and equals the plain sequence bit for bit; its bf16 form
    launches none of them."""
    from cfd2_tpu_torch.ops import stencil_system as st
    p = ranks.stencil_tensors((37, 53), 5, cuda)
    fields = {k: p[k] for k in ("off_mom", "off_up", "off_vp", "off_pu",
                                "off_pv", "off_pp", "diag_u2", "diag_up2",
                                "diag_vp2", "diag_pu2", "diag_pv2",
                                "diag_pp2", "diag_u_inv2")}
    p_off = -0.2 * torch.ones((4, 37, 53), device=cuda)
    ss = st.StencilSystem(grid=(37, 53), P_off2=p_off,
                          P_diag2=torch.full((37, 53), 2.0, device=cuda),
                          diag_p_inv2=torch.full((37, 53), 0.5, device=cuda),
                          rhs=torch.zeros((37 * 53, 3), device=cuda),
                          **fields)
    sk.reset_launches()
    got = st.schur_precond_planar(ss, p["r"], 1.2, 4, mom_sweeps=8)
    assert sk.LAUNCHES["schur_rhs"] == sk.LAUNCHES["pressure_gradient"] == 1
    assert sk.LAUNCHES["momentum_jacobi"] == 2
    z = sk.momentum_jacobi_ref(p["r"][:2], p["diag_u_inv2"], p["off_mom"], 8)
    rhs = sk.schur_rhs_ref(p["r"][2], z, p["diag_pu2"], p["diag_pv2"],
                           p["off_pu"], p["off_pv"])
    zp = st.chebyshev_pressure_solve2(ss, rhs, 1.2, 4)
    g = sk.pressure_gradient_ref(zp, p["diag_up2"], p["diag_vp2"],
                                 p["off_up"], p["off_vp"])
    gz = sk.momentum_jacobi_ref(g, p["diag_u_inv2"], p["off_mom"], 8)
    assert torch.equal(got, torch.stack([z[0] - gz[0], z[1] - gz[1], zp]))
    sk.reset_launches()
    ss16 = st.cast_coeffs(ss, torch.bfloat16)
    st.schur_precond_planar(ss16, p["r"].to(torch.bfloat16), 1.2, 4,
                            mom_sweeps=8)
    torch.cuda.synchronize()
    assert all(v == 0 for v in sk.LAUNCHES.values())


# ----------------------------------------------------------------------
# The banded kernels (csrc/banded.cu).

BANDED_MAPS = [(5000, 5000, 1), (5000, 5000, 3), (4096, 4096, 9),
               (5000, 700, 1), (700, 5000, 17)]
DOT_FORMS = bk.DOT_FORMS
# A list the solver never passes: the kernel's generic instantiation.
DOT_OTHER = (2, 2, (((1, 0), (0, 1)), ((1, 1),)))


def _band_map(M, n_src, K, seed, device):
    rng = np.random.default_rng(seed)
    centre = (np.arange(M) * (n_src / M)).astype(np.int64)[:, None]
    idx = centre + rng.integers(-300, 301, (M, K))
    idx = np.sort(np.clip(idx, 0, n_src - 1), axis=1)
    return torch.as_tensor(idx.astype(np.int32), device=device)


def _rand(shape, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32),
        device=device)


@pytest.mark.parametrize("tail", [None, 2, 3, 6])
@pytest.mark.parametrize("M,n_src,K", BANDED_MAPS)
def test_gather_kernel_matches_plain(cuda, M, n_src, K, tail):
    idx = _band_map(M, n_src, K, 0, cuda)
    x = _rand((n_src,) if tail is None else (n_src, tail), 1, cuda)
    before = bk.LAUNCHES["banded_gather"]
    got = bk.banded_gather(x, idx)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["banded_gather"] == before + 1
    assert torch.equal(got, bk.banded_gather_ref(x, idx))


@pytest.mark.parametrize("start", [0, 1, 2, 3])
@pytest.mark.parametrize("M,K", [(4097, 1), (1001, 3), (3, 1)])
def test_gather_scalar_takes_index_views_at_any_offset(cuda, M, K, start):
    """C = 1 reads four indices at a time where idx is 16-byte aligned and
    one at a time where a view starts elsewhere; both are exact, with the
    ragged tail of M * K not a multiple of 4."""
    raw = _band_map(M * K + 4, 900, 1, 20, cuda).reshape(-1)
    idx = raw[start:start + M * K].view(M, K)
    x = _rand((900,), 21, cuda)
    got = bk.banded_gather(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, bk.banded_gather_ref(x, idx))


@pytest.mark.parametrize("alpha", [1.0, 1.5])
@pytest.mark.parametrize("M,n_src", [(5000, 700), (403584, 59490),
                                     (59490, 5227), (300, 7)])
def test_prolong_add_kernel_is_the_eager_update_bit_for_bit(cuda, M, n_src,
                                                           alpha):
    idx = _band_map(M, n_src, 1, 14, cuda)
    base, x = _rand((M,), 15, cuda), _rand((n_src,), 16, cuda)
    before = bk.LAUNCHES["banded_gather"]
    got = bk.banded_prolong_add(base, x, idx, alpha)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["banded_gather"] == before + 1
    assert torch.equal(got, base + alpha * x[idx[:, 0].long()])
    assert torch.equal(got, bk.banded_prolong_add_ref(base, x, idx, alpha))


@pytest.mark.parametrize("form", list(DOT_FORMS))
@pytest.mark.parametrize("M,n_src,K", BANDED_MAPS)
def test_dot_kernel_matches_plain(cuda, M, n_src, K, form):
    n_x, n_off, prods = DOT_FORMS[form]
    idx = _band_map(M, n_src, K, 2, cuda)
    xs = [_rand((n_src,), 3 + c, cuda) for c in range(n_x)]
    offs = [_rand((M, K), 10 + p, cuda, 0.3) for p in range(n_off)]
    before = bk.LAUNCHES["banded_dot"]
    got = bk.banded_dot(xs, offs, idx, prods)
    ref = bk.banded_dot_ref(xs, offs, idx, prods)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["banded_dot"] == before + 1
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= TOL


@pytest.mark.parametrize("M,n_src,K", BANDED_MAPS + [(300, 300, 2),
                                                     (500, 4000, 26)])
def test_generic_dot_kernel_matches_plain(cuda, M, n_src, K):
    n_x, n_off, prods = DOT_OTHER
    assert bk.dot_form(prods, n_x, n_off) == "generic"
    idx = _band_map(M, n_src, K, 12, cuda)
    xs = [_rand((n_src,), 13 + c, cuda) for c in range(n_x)]
    offs = [_rand((M, K), 15 + p, cuda, 0.3) for p in range(n_off)]
    got = bk.banded_dot(xs, offs, idx, prods)
    ref = bk.banded_dot_ref(xs, offs, idx, prods)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= TOL


@pytest.mark.parametrize("sweeps", [1, 3, 8])
@pytest.mark.parametrize("K,cap", [(3, None), (9, None), (9, 8)])
def test_sweeps_kernel_matches_plain(cuda, K, cap, sweeps):
    n = 4096
    idx = _band_map(n, n, K, 4, cuda)
    rs = [_rand((n,), 5 + c, cuda) for c in range(2)]
    dinv = 1.0 / (1.0 + _rand((n,), 7, cuda).abs())
    off = _rand((n, K), 8, cuda, 0.5 / K)
    before = bk.LAUNCHES["banded_jacobi_sweeps"]
    got = bk.banded_jacobi_sweeps(rs, dinv, off, idx, sweeps, k_cap=cap)
    ref = bk.banded_jacobi_sweeps_ref(rs, dinv, off, idx, sweeps, k_cap=cap)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["banded_jacobi_sweeps"] == before + 1
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= TOL


def _sweeps_case(n, K, C, seed, cuda):
    idx = _band_map(n, n, K, seed, cuda)
    rs = [_rand((n,), seed + 1 + c, cuda) for c in range(C)]
    dinv = 1.0 / (1.0 + _rand((n,), seed + 5, cuda).abs())
    off = _rand((n, K), seed + 6, cuda, 0.5 / K)
    return rs, dinv, off, idx


def _streamed_plan(n):
    """The streamed form at a grid of every SM's blocks."""
    props = torch.cuda.get_device_properties(0)
    blocks = max(1, min(props.multi_processor_count, -(-n // 1024)))
    return bk.SweepsPlan("streamed", blocks, -(-n // blocks), 0, 0)


@pytest.mark.parametrize("form", ["planned", "streamed"])
@pytest.mark.parametrize("sweeps", [1, 2, 3, 8])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("n,K,cap", [(4096, 3, None), (5001, 9, 8),
                                     (200_001, 6, 4), (403_584, 3, None),
                                     (600_000, 6, None), (1000, 3, 0)])
def test_sweeps_kernel_forms_match_plain(cuda, n, K, cap, C, sweeps, form):
    """Both forms of the one launch over C = 1..4, odd and even sweep
    counts, slot caps below K (0 among them), row counts that are not a
    multiple of a block's, and every register instantiation of the resident
    form (1, 2, 4 and 8 rows per thread at these shapes)."""
    rs, dinv, off, idx = _sweeps_case(n, K, C, 30, cuda)
    kc = K if cap is None else cap
    plan = (bk.device_sweeps_plan(cuda, n, K, C, kc) if form == "planned"
            else _streamed_plan(n))
    before = bk.LAUNCHES["banded_jacobi_sweeps"]
    got = bk.launch_sweeps(rs, dinv, off, idx, sweeps, kc, plan)
    ref = bk.banded_jacobi_sweeps_ref(rs, dinv, off, idx, sweeps, k_cap=cap)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["banded_jacobi_sweeps"] == before + 1
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= TOL


def test_sweeps_kernel_equals_the_per_sweep_dots_bit_for_bit(cuda):
    """The one launch rounds each product and sum as banded_dot's mom2
    form and the eager updates do: the momentum predict's two paths give
    the same bits."""
    rs, dinv, off, idx = _sweeps_case(600_000, 6, 2, 40, cuda)
    z = [dinv * r for r in rs]
    for _ in range(7):
        su, sv = bk.banded_dot(z, (off,), idx, (((0, 0),), ((0, 1),)))
        z = [dinv * (rs[0] - su), dinv * (rs[1] - sv)]
    got = bk.banded_jacobi_sweeps(rs, dinv, off, idx, 8)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, z))


def test_sweeps_refuses_a_grid_the_card_cannot_hold(cuda):
    """A resident grid of more blocks than the SMs hold at once is refused
    by the cooperative launch; the wrapper raises, counts nothing, and the
    next launch runs."""
    n, K = 600_000, 6
    rs, dinv, off, idx = _sweeps_case(n, K, 2, 50, cuda)
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    rows = -(-n // blocks)
    plan = bk.SweepsPlan("resident", blocks, rows, 8 * K * rows, 2)
    before = bk.LAUNCHES["banded_jacobi_sweeps"]
    with pytest.raises(RuntimeError, match="cooperative"):
        bk.launch_sweeps(rs, dinv, off, idx, 8, K, plan)
    assert bk.LAUNCHES["banded_jacobi_sweeps"] == before
    got = bk.banded_jacobi_sweeps(rs, dinv, off, idx, 8)
    ref = bk.banded_jacobi_sweeps_ref(rs, dinv, off, idx, 8)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= TOL


def test_banded_wrappers_refuse_bad_input(cuda):
    idx = _band_map(256, 256, 3, 9, cuda)
    x = _rand((256,), 10, cuda)
    off = _rand((256, 3), 11, cuda)
    with pytest.raises(TypeError):
        bk.banded_gather(x.double(), idx)
    with pytest.raises(TypeError):
        bk.banded_gather(x, idx.long())
    with pytest.raises(ValueError):
        bk.banded_dot((x,), (off.T.contiguous().T,), idx, (((0, 0),),))
    with pytest.raises(ValueError):
        bk.banded_dot((x,), (off,), idx, (((1, 0),),))
    with pytest.raises(ValueError):
        bk.banded_jacobi_sweeps((x,), x, off, idx, 3, k_cap=4)
    # float2 rows need an 8-byte aligned operand; a strided one is refused.
    raw = _rand((256 * 6 + 2,), 12, cuda)
    for C in (2, 6):
        with pytest.raises(ValueError, match="aligned"):
            bk.banded_gather(raw[1:1 + 256 * C].view(256, C), idx)
        got = bk.banded_gather(raw[2:2 + 256 * C].view(256, C), idx)
        assert torch.equal(got, bk.banded_gather_ref(
            raw[2:2 + 256 * C].view(256, C), idx))
    with pytest.raises(ValueError):
        bk.banded_gather(raw[:512].view(256, 2).T.contiguous().T, idx)
    agg = idx[:, :1].contiguous()
    with pytest.raises(ValueError):
        bk.banded_prolong_add(x, x, idx, 1.0)          # K != 1
    with pytest.raises(ValueError):
        bk.banded_prolong_add(raw[:512:2], x, agg, 1.0)  # strided base
    with pytest.raises(TypeError):
        bk.banded_prolong_add(x.double(), x, agg, 1.0)


# ----------------------------------------------------------------------
# The solver's options and entry points on the card (chip_smoke.py phase
# 9's comparisons on the small meshes, through its own helpers).


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _chip_smoke()
_SMALL_RUNS = [(structured, label, opts, mode)
               for structured in (True, False)
               for label, opts, mode in _SMOKE._small_option_runs(structured)]


@pytest.fixture(scope="module")
def small_solvers():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return {structured: make for make, structured in _SMOKE._small_solvers()}


@pytest.mark.parametrize(
    "structured,label,opts,mode", _SMALL_RUNS,
    ids=[f"{'cutcell' if r[0] else 'delaunay'}-{r[1].replace(' ', '_')}"
         for r in _SMALL_RUNS])
def test_option_step_card_matches_cpu(cuda, small_solvers, structured,
                                      label, opts, mode):
    """One step with the option on the card and on the CPU: equal outer
    counts (within 2 with Anderson mixing), u within 1e-4 * max|u|, the
    path's kernels launched on the card."""
    _SMOKE._options_card_vs_cpu(small_solvers[structured], label, opts,
                                mode, structured)


def test_async_reader_lands_cuda_tensors(cuda):
    from cfd2_tpu_torch.runtime.async_reader import AsyncFieldReader
    r = AsyncFieldReader(depth=2)
    xs = [torch.arange(1000, dtype=torch.float32, device=cuda) * (i + 1)
          for i in range(4)]
    for x in xs:
        r.start_read(x.max())
    assert float(r.get_last_value()) == float(xs[1].max())   # depth 2
    r.start_read(xs[0])
    np.testing.assert_array_equal(r.flush(), xs[0].cpu().numpy())
    r.start_read(xs[3].sum())
    torch.cuda.synchronize()
    assert r.poll() and float(r.get_last_value()) == float(xs[3].sum())


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """Saved from the card, loaded onto it: the same bits, and one more
    step of each solver bit-equal."""
    make = _SMOKE._small_solvers()[0][0]
    s = make("cuda")
    s.step()
    s.save_checkpoint(tmp_path / "ck.npz")
    fresh = make("cuda")
    fresh.load_checkpoint(tmp_path / "ck.npz")
    assert fresh.state.u.device.type == "cuda"
    assert torch.equal(fresh.state.u, s.state.u)
    s.step()
    fresh.step()
    assert torch.equal(fresh.state.u, s.state.u)
    assert torch.equal(fresh.state.p, s.state.p)


# ----------------------------------------------------------------------
# The generic-mesh paths on the card (chip_smoke.py phase 10(c)'s
# comparisons, through its own helpers).


@pytest.fixture(scope="module")
def generic_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return _SMOKE._generic_runs()


@pytest.mark.parametrize("i", range(5), ids=[
    "multilevel-amg", "cutcell-block-jacobi", "cutcell-chebyshev",
    "unbanded-delaunay-amg", "tiny-grid-amg"])
def test_generic_path_step_card_matches_cpu(cuda, generic_runs, i):
    """One step on the card and on the CPU: equal outer counts (or one
    0-iteration outer apart under block-Jacobi), u within 1e-4 * max|u|,
    the path's kernels launched on the card."""
    cases, _ = generic_runs
    assert len(cases) == 5
    _SMOKE._generic_card_vs_cpu(*cases[i])


def test_simple_step_card_matches_cpu(cuda, generic_runs):
    _SMOKE._simple_card_vs_cpu(generic_runs[1])


# ----------------------------------------------------------------------
# The application layer on the card (chip_smoke.py phase 11's checks at
# small sizes): forces, the Simulation, batched cases and the CLI.


def test_forces_card_match_cpu(cuda):
    """The same state on both devices: (Fx, Fy) within 1e-5 of the larger
    component (float32 sums in another order)."""
    from cfd2_tpu_torch.utils.forces import body_force, obstacle_face_mask
    make = _SMOKE._small_solvers()[0][0]
    s = make("cuda")
    s.step()
    cpu = make("cpu")
    cpu.state = type(s.state)(**{k: v.cpu() for k, v in
                                 vars(s.state).items()})
    mask = obstacle_face_mask(s.mesh)
    np.testing.assert_array_equal(mask, obstacle_face_mask(cpu.mesh))
    f_gpu = body_force(s.mesh, s.state, s.params, mask).cpu().numpy()
    f_cpu = body_force(cpu.mesh, cpu.state, cpu.params, mask).numpy()
    assert f_gpu[0] > 0
    assert np.abs(f_gpu - f_cpu).max() <= 1e-5 * np.abs(f_cpu).max()


def test_app_simulation_card_matches_cpu(cuda):
    """Two app steps with dt pinned on the card and on the CPU: equal
    outers, u within 1e-4 * max|u|, rbgs_leg launched on the card, and
    Cd/Cl within 1e-3 of the drag: the pressure, which carries the force,
    agrees to 1e-3 of its maximum (tests/torch_parity.py says why)."""
    from cfd2_tpu_torch.app import Simulation
    kw = dict(geometry="channel", cell_size=0.025, adaptive=False, precond=1)
    gpu, cpu = Simulation(device="cuda", **kw), Simulation(device="cpu", **kw)
    sk.reset_launches()
    for i in range(2):
        gpu.run(1)
        cpu.run(1)
        og, oc = (int(s.solver.state.outer_iters) for s in (gpu, cpu))
        assert og == oc, (i, og, oc)
        ug, uc = gpu.solver.get_u(), cpu.solver.get_u()
        err, lim = np.abs(ug - uc).max(), 1e-4 * np.abs(uc).max()
        assert err <= lim, (i, err, lim)
    assert sk.LAUNCHES["rbgs_leg"] > 0
    (cdg, clg), (cdc, clc) = gpu.force_coefficients(), \
        cpu.force_coefficients()
    assert abs(cdg - cdc) <= 1e-3 * abs(cdc), (cdg, cdc)
    assert abs(clg - clc) <= 1e-3 * abs(cdc), (clg, clc, cdc)


def test_batched_step_on_the_card_equals_single_steps(cuda):
    from dataclasses import fields
    from cfd2_tpu_torch.models.coupled import step
    from cfd2_tpu_torch.parallel import batched_step, shard_batch
    make = _SMOKE._small_solvers()[0][0]
    s = make("cuda")
    amg = s._get_amg()
    states = [s.state]
    s.step()
    states.append(s.state)
    b = type(s.state)(**{f.name: torch.stack([getattr(st, f.name)
                                              for st in states])
                         for f in fields(type(s.state))})
    out = batched_step(s.mesh, shard_batch(b, ["cuda"]), s.params,
                       s.config, amg=amg)
    for i, st in enumerate(states):
        ref = step(s.mesh, st, s.params, s.config, amg)
        assert int(out.outer_iters[i]) == int(ref.outer_iters)
        assert float((out.u[i] - ref.u).abs().max()) <= 1e-6


def test_app_cli_on_the_card(cuda):
    import json
    import subprocess
    import sys
    from pathlib import Path
    out = subprocess.run(
        [sys.executable, "-m", "cfd2_tpu_torch.app", "--cell-size", "0.05",
         "--precond", "1", "--steps", "2", "--forces", "--profile"],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "device: cuda" in out.stdout and "Cd=" in out.stdout
    assert "finite=True" in out.stdout
    launches = json.loads(
        out.stdout.split("kernel launches: ")[1].splitlines()[0])
    assert launches["rbgs_leg"] > 0


def test_row_sharded_step_on_the_card_equals_one_process(cuda):
    """Two gloo ranks sharing the card step the 4,636-cell mesh row-sharded
    (blocks of 20 rows, structured multigrid): equal outer counts on both
    ranks and against one process on the card, u within 1e-5, and every
    rank launched rbgs_leg."""
    from cfd2_tpu_torch.mesh import ChannelWithObstacle, \
        generate_cut_cell_mesh
    from cfd2_tpu_torch.models.coupled import step
    from cfd2_tpu_torch.ops.amg import build_hierarchy_for_mesh
    from cfd2_tpu_torch.parallel.launch import run_ranks
    from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
    from cfd2_tpu_torch.runtime.state import SolverConfig, SolverParams, \
        initial_state
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.025, 0.025, 1.2, (3.0, 1.0))
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.025, 0] = 1.0
    dm = encode_mesh(mesh, device=cuda, pad_rows_to=2)
    one = step(dm, initial_state(dm, u0=u0),
               SolverParams.default(dt=0.001, device=cuda),
               SolverConfig(precond_type=1), build_hierarchy_for_mesh(dm))
    res = run_ranks(ranks.sharded_steps_over, 2, device="cuda", timeout=300,
                    args=((2,), (), mesh, 2, u0, 0.001,
                          dict(precond_type=1), True))
    rs = [r[2] for r in res]
    assert "staged through host memory" in rs[0]["transport"]
    assert rs[0]["outer"] == rs[1]["outer"] == int(one.outer_iters)
    assert rs[0]["lin"] == rs[1]["lin"]
    assert all(r["rbgs_leg"] > 0 for r in rs)
    u = np.concatenate([r["u"] for r in rs])
    assert np.abs(u - one.u.cpu().numpy()).max() < 1e-5


@pytest.mark.parametrize("name,run", [
    ("CFD2_PALLAS=1", dict(config=dict(precond_type=1), pallas="1")),
    ("precond_mom_adi=1", dict(config=dict(precond_type=1,
                                           precond_mom_adi=1))),
])
def test_row_sharded_option_on_the_card_equals_one_process(cuda, name, run):
    """Two gloo ranks sharing the card step the 4,636-cell mesh row-sharded
    under the half-sweep V-cycle (``rbgs_half_sweep`` on both ranks, at one
    process's launches per FGMRES iteration) and with the ADI predict (its
    column solves on blocks of 20 rows plus 15 ghost rows, ``rbgs_leg`` on
    both ranks): equal outer counts on both ranks and against one process
    on the card, u within 1e-5."""
    from cfd2_tpu_torch.mesh import ChannelWithObstacle, \
        generate_cut_cell_mesh
    from cfd2_tpu_torch.ops.amg import build_hierarchy_for_mesh
    from cfd2_tpu_torch.parallel.launch import run_ranks
    from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
    from cfd2_tpu_torch.runtime.state import SolverParams, initial_state
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.025, 0.025, 1.2, (3.0, 1.0))
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.025, 0] = 1.0
    dm = encode_mesh(mesh, device=cuda, pad_rows_to=2)
    one = ranks.option_run(dm, initial_state(dm, u0=u0),
                           SolverParams.default(dt=0.001, device=cuda),
                           build_hierarchy_for_mesh(dm), **run)
    res = run_ranks(ranks.option_runs_over, 2, device="cuda", timeout=300,
                    args=((2,), mesh, 2, u0, 0.001, {name: run}))
    rs = [r[2][name] for r in res]
    assert rs[0]["outer"] == rs[1]["outer"] == one["outer"]
    assert rs[0]["lin"] == rs[1]["lin"]
    kernel = "rbgs_half_sweep" if run.get("pallas") else "rbgs_leg"
    for r in rs:
        assert r["launches"][kernel] > 0
        assert r["launches"][kernel] * sum(one["lin"]) \
            == one["launches"][kernel] * sum(r["lin"])
    u = np.concatenate([r["u"] for r in rs])
    assert np.abs(u - one["u"]).max() < 1e-5
