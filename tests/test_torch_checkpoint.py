"""Checkpoints and the asynchronous reader of the port
(cfd2_tpu_torch/runtime/checkpoint.py, async_reader.py): a ``.npz`` that
either package writes loads in the other with the same arrays, a solver
resumed from its checkpoint steps bit for bit as the one that wrote it, and
the reader lands what it was given (on the CPU: the pinned-memory CUDA
path is in tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from cfd2_tpu.runtime import checkpoint as jck
from cfd2_tpu_torch.models.coupled import CoupledSolver as TSolver
from cfd2_tpu_torch.runtime import checkpoint as tck
from cfd2_tpu_torch.runtime.async_reader import AsyncFieldReader
from cfd2_tpu_torch.runtime.state import PARAMS_FIELDS, STATE_FIELDS
from torch_parity import channel_mesh, start_from_inlet, warm_jax_solver

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return channel_mesh()


@pytest.fixture(scope="module")
def warm(mesh):
    return warm_jax_solver(mesh, steps=1)


def _same(port_obj, jax_obj, names):
    for f in names:
        got = getattr(port_obj, f).numpy()
        ref = np.asarray(getattr(jax_obj, f))
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)


def test_npz_checkpoints_cross_between_packages(tmp_path, warm):
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jck.save_checkpoint(str(jpath), warm.state, warm.params)
    state, params = tck.load_checkpoint(jpath, device="cpu")
    _same(state, warm.state, STATE_FIELDS)
    _same(params, warm.params, PARAMS_FIELDS)
    tck.save_checkpoint(tpath, state, params)
    jstate, jparams = jck.load_checkpoint(str(tpath))
    _same(state, jstate, STATE_FIELDS)
    _same(params, jparams, PARAMS_FIELDS)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)


def test_old_checkpoint_without_linear_iters_total(tmp_path, warm):
    arrs = {f"state.{f}": np.asarray(getattr(warm.state, f))
            for f in STATE_FIELDS if f != "linear_iters_total"}
    np.savez(tmp_path / "old.npz", **arrs)
    state, params = tck.load_checkpoint(tmp_path / "old.npz", device="cpu")
    assert params is None
    assert state.linear_iters_total.dtype == torch.int32
    assert int(state.linear_iters_total) == 0


def test_resumed_solver_steps_bit_equal(tmp_path, mesh):
    s = TSolver(mesh, device="cpu")
    start_from_inlet(s, mesh)
    s.step()
    s.save_checkpoint(tmp_path / "ck.npz")
    r = TSolver(mesh, device="cpu")
    r.set_precond_type(1)
    r.load_checkpoint(tmp_path / "ck.npz")
    s.step()
    r.step()
    for f in STATE_FIELDS:
        assert torch.equal(getattr(r.state, f), getattr(s.state, f)), f


def test_async_reader_and_max_velocity(mesh):
    s = TSolver(mesh, device="cpu")
    start_from_inlet(s, mesh)
    vmax = s.max_velocity_device()
    assert isinstance(vmax, torch.Tensor) and vmax.shape == ()
    assert float(vmax) == pytest.approx(
        float(np.linalg.norm(s.get_u(), axis=1).max()))
    r = AsyncFieldReader(depth=2)
    assert r.get_last_value() is None and not r.poll()
    r.start_read(vmax)
    r.start_read(s.state.u)
    r.start_read(s.state.p)       # beyond depth: the oldest lands
    assert float(r.get_last_value()) == float(vmax)
    assert r.poll()               # CPU reads land at once
    np.testing.assert_array_equal(r.get_last_value(), s.state.p.numpy())
    r.start_read(s.state.u)
    np.testing.assert_array_equal(r.flush(), s.state.u.numpy())
    r.reset()
    assert r.get_last_value() is None and r.flush() is None


# ----------------------------------------------------------------------
# The distributed pair (the JAX package's orbax pair): round trips 1 -> 1,
# 4 ranks -> 1 process and 4 ranks -> 2 ranks, every field equal to the
# .npz pair's and to the JAX package's .npz of the same state.


@pytest.fixture(scope="module")
def dcp_written(tmp_path_factory, warm):
    """The warm JAX state as a JAX .npz, the port's state loaded from it,
    and that state written as a distributed checkpoint by 4 gloo ranks,
    each its own rows."""
    import torch_spatial_ranks as ranks
    from cfd2_tpu_torch.parallel.launch import run_ranks
    d = tmp_path_factory.mktemp("dcp")
    jck.save_checkpoint(str(d / "jax.npz"), warm.state, warm.params)
    state, params = tck.load_checkpoint(d / "jax.npz", device="cpu")
    grid = tuple(warm.mesh.grid_shape)
    assert grid[0] % 4 == 0
    rows = run_ranks(ranks.dcp_save, 4, device="cpu", timeout=120,
                     args=(d / "jax.npz", grid, d / "ck4"))
    assert rows == [grid[0] * grid[1] // 4] * 4
    return d, state, params, grid


def test_dcp_round_trip_in_one_process(tmp_path, warm):
    state, params = tck.load_checkpoint(_jax_npz(tmp_path, warm),
                                        device="cpu")
    tck.save_checkpoint_dcp(tmp_path / "ck1", state, params)
    got, got_p = tck.load_checkpoint_dcp(tmp_path / "ck1", device="cpu")
    _same(got, warm.state, STATE_FIELDS)
    _same(got_p, warm.params, PARAMS_FIELDS)


def test_dcp_from_four_ranks_loads_in_one_process(dcp_written, warm):
    d, state, params, _ = dcp_written
    got, got_p = tck.load_checkpoint_dcp(d / "ck4", device="cpu")
    _same(got, warm.state, STATE_FIELDS)
    _same(got_p, warm.params, PARAMS_FIELDS)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(state, f)), f


def test_dcp_from_four_ranks_loads_into_two(dcp_written, warm):
    import torch_spatial_ranks as ranks
    from cfd2_tpu_torch.parallel.launch import run_ranks
    d, state, params, grid = dcp_written
    res = run_ranks(ranks.dcp_load, 2, device="cpu", timeout=120,
                    args=(grid, d / "ck4"))
    for f in STATE_FIELDS:
        ref = np.asarray(getattr(warm.state, f))
        if ref.ndim >= 1 and ref.shape[0] == grid[0] * grid[1]:
            got = np.concatenate([r["state"][f] for r in res])
            assert [r["cells"] for r in res] == [
                (0, ref.shape[0] // 2), (ref.shape[0] // 2, ref.shape[0])]
        else:
            got = res[1]["state"][f]
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    for f in PARAMS_FIELDS:
        np.testing.assert_array_equal(res[0]["params"][f],
                                      np.asarray(getattr(warm.params, f)))


def _jax_npz(tmp_path, warm):
    path = tmp_path / "jax.npz"
    jck.save_checkpoint(str(path), warm.state, warm.params)
    return path
