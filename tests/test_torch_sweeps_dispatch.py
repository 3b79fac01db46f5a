"""The one-call momentum sweeps of the port: the launch plan of its CUDA
kernel (a pure function of the map's shape and the card's limits, reached
here without a card), and the dispatch of the banded Schur preconditioner,
which takes the one call on every map without a slot cap where the JAX
package's 12 MiB TPU memory rule would take one dot per sweep.

The step is held to the JAX package's step with that rule forced off on
both sides, on a refined quadtree mesh (multilevel layout, no slot cap):
outer and FGMRES counts equal, u within 1e-5 of its largest magnitude (the
JAX package's per-sweep dots and the port's one call sum the same products
in the same slot order; what differs is each package's reduction order,
a few ulps per sum, and the solves end where the JAX package's do).  The
port's own per-sweep step computes the same sums with the same operations
on the CPU, so it must equal the one-call step exactly."""

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.models.coupled import CoupledSolver as JSolver
from cfd2_tpu.runtime.device_mesh import DeviceMesh as JMesh
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.ops import banded_kernels as bk
from cfd2_tpu_torch.ops import ellsys as tel
from cfd2_tpu_torch.runtime.device_mesh import DeviceMesh as TMesh

torch.set_num_threads(1)
H100_SMS = 132
SMEM = bk.SMEM_PER_BLOCK_MAX


# ----------------------------------------------------------------------
# The launch plan.


@pytest.mark.parametrize("n,K,k_cap,want", [
    # the 403,491-cell Delaunay mesh: 3,058 rows of 24 bytes per block
    (403_584, 3, None, ("resident", 132, 3_058, 73_392, 4)),
    # the multilevel layout of the 132,080-cell refined mesh
    (600_000, 6, None, ("resident", 132, 4_546, 218_208, 8)),
    # the slot-capped Voronoi mesh (K = 9, bd_k = 8): a block per 1,024
    # rows, each row's first 8 slots
    (115_584, 9, 8, ("resident", 113, 1_023, 65_472, 1)),
    # the next multilevel size: 873 KB of rows per SM do not fit
    (2_400_000, 6, None, ("streamed", 264, 9_091, 0, 0)),
    # a small mesh: a block per 1,024 rows
    (5_843, 3, None, ("resident", 6, 974, 23_376, 1)),
])
def test_plan_at_the_paths_shapes(n, K, k_cap, want):
    plan = bk.sweeps_plan(n, K, 2, k_cap, H100_SMS, SMEM, streamed_per_sm=2)
    assert tuple(plan) == want


def test_plan_never_exceeds_the_cards_shared_memory():
    """Over many shapes and limits: the rows cover n, a resident block's
    rows fit its registers and its shared memory, which never exceeds
    232,448 bytes, even where the caller reports more."""
    rng = np.random.default_rng(0)
    forms = set()
    for _ in range(2000):
        n = int(rng.integers(1, 5_000_000))
        K = int(rng.integers(1, 27))
        k_cap = None if rng.random() < 0.5 else int(rng.integers(0, K + 1))
        n_sm = int(rng.choice([1, 8, 66, 114, 132]))
        smem = int(rng.choice([49_152, 101_376, SMEM, 400_000]))
        C = int(rng.integers(1, bk.MAX_RHS + 1))
        plan = bk.sweeps_plan(n, K, C, k_cap, n_sm, smem,
                              streamed_per_sm=int(rng.integers(1, 3)))
        kc = K if k_cap is None else k_cap
        forms.add(plan.form)
        assert plan.blocks * plan.rows_per_block >= n
        assert (plan.blocks - 1) * plan.rows_per_block < n
        assert plan.smem_bytes <= min(smem, SMEM)
        if plan.form == "resident":
            assert plan.blocks <= n_sm
            assert plan.rows_per_thread in bk.SWEEPS_ROWS_PER_THREAD
            assert plan.rows_per_block <= (plan.rows_per_thread
                                           * bk.SWEEPS_THREADS)
            assert plan.smem_bytes == 8 * kc * plan.rows_per_block
        else:
            assert plan.smem_bytes == 0 and plan.rows_per_thread == 0
    assert forms == {"resident", "streamed"}


def test_plan_refuses_more_right_hand_sides_than_the_kernel_takes():
    with pytest.raises(ValueError):
        bk.sweeps_plan(1000, 3, bk.MAX_RHS + 1, None, H100_SMS, SMEM)


# ----------------------------------------------------------------------
# The dispatch on a multilevel step.


def _host(mod):
    geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return mod.generate_cut_cell_mesh(geo, 0.025, 0.05, 1.2, (3.0, 1.0))


def _start(s, mesh):
    s.set_dt(0.01)
    s.set_precond_type(1)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < 0.1, 0] = 1.0
    s.set_u(u0)


def _per_sweep(es, mesh, r_u, r_v, sweeps):
    """The per-sweep loop of ``ellsys._momentum_solve``."""
    z_u, z_v = es.diag_u_inv * r_u, es.diag_u_inv * r_v
    for _ in range(sweeps - 1):
        su, sv = tel._mom_dot2(es, mesh, z_u, z_v)
        z_u = es.diag_u_inv * (r_u - su)
        z_v = es.diag_u_inv * (r_v - sv)
    return z_u, z_v


def _counting(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)

    def wrap(name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in names:
        monkeypatch.setattr(module, name, wrap(name))
    return calls


def _counts(s):
    return int(s.state.outer_iters), int(s.state.linear_iters_total)


def test_uncapped_step_takes_the_one_call_above_the_rule(monkeypatch):
    asked = []
    monkeypatch.setattr(JMesh, "banded_sweeps_fit",
                        lambda self, c: asked.append(c) or False)
    monkeypatch.setattr(TMesh, "banded_sweeps_fit", lambda self, c: False)
    h = _host(jmesh)
    jsol = JSolver(h)
    _start(jsol, h)
    assert jsol.mesh.multilevel and jsol.mesh.banded
    jsol.step()
    assert asked, "the JAX step did not ask its rule: a cached trace"
    ju = jsol.get_u()

    th = _host(tmesh)
    one = TSolver(th, device="cpu")
    _start(one, th)
    assert one.mesh.multilevel and one.mesh.banded and one.mesh.bd_k is None
    calls = _counting(monkeypatch, bk, ("banded_jacobi_sweeps",))
    dots = _counting(monkeypatch, tel, ("_mom_dot2",))
    one.step()
    assert calls["banded_jacobi_sweeps"] == 2 * _counts(one)[1] > 0
    assert dots["_mom_dot2"] == 0
    assert _counts(one) == _counts(jsol)
    scale = float(np.abs(ju).max())
    assert np.abs(one.get_u() - ju).max() <= 1e-5 * scale

    monkeypatch.setattr(tel, "_momentum_solve", _per_sweep)
    loop = TSolver(th, device="cpu")
    _start(loop, th)
    loop.step()
    assert dots["_mom_dot2"] > 0
    assert _counts(loop) == _counts(one)
    assert np.array_equal(loop.get_u(), one.get_u())
