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
