"""The port's structured encode against cfd2_tpu.runtime.device_mesh.

Both encoders compute every geometric factor in NumPy float64 and round to
float32 once, so the encoded arrays must be equal exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from cfd2_tpu.mesh import ChannelWithObstacle, generate_cut_cell_mesh
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode
from cfd2_tpu_torch.runtime.device_mesh import resolve_device

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(1, 1), (4, 8)],
                ids=["unpadded", "padded"])
def meshes(request):
    pad_r, pad_c = request.param
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.05, 0.05, 1.2, (3.0, 1.0))
    a = jencode(mesh, pad_rows_to=pad_r, pad_cols_to=pad_c)
    b = tencode(mesh, device="cpu", pad_rows_to=pad_r, pad_cols_to=pad_c)
    assert a.structured and b.structured
    return mesh, a, b


def test_metadata_equal(meshes):
    _, a, b = meshes
    for f in ("num_cells", "num_faces", "max_faces", "num_host_cells",
              "grid_shape"):
        assert getattr(a, f) == getattr(b, f), f


def test_encoded_arrays_equal(meshes):
    _, a, b = meshes
    n = 0
    for f in dataclasses.fields(type(b)):
        vb = getattr(b, f.name)
        if not isinstance(vb, torch.Tensor):
            continue
        va = np.asarray(getattr(a, f.name))
        assert vb.dtype in (torch.float32, torch.int32, torch.bool), f.name
        np.testing.assert_array_equal(vb.numpy(), va, err_msg=f.name)
        n += 1
    assert n >= 30


def test_amg_host_copies_equal(meshes):
    _, a, b = meshes
    assert a.amg_host.keys() == b.amg_host.keys()
    for k in a.amg_host:
        np.testing.assert_array_equal(a.amg_host[k], b.amg_host[k])


def test_gather_and_shifts_equal(meshes):
    _, a, b = meshes
    rng = np.random.default_rng(0)
    for tail in ((), (2,)):
        x = rng.standard_normal((a.num_cells,) + tail).astype(np.float32)
        np.testing.assert_array_equal(
            b.gather(torch.as_tensor(x)).numpy(),
            np.asarray(a.gather(x)))
    v = rng.standard_normal(a.num_cells).astype(np.float32)
    np.testing.assert_array_equal(
        b.shift_from_west(torch.as_tensor(v)).numpy(),
        np.asarray(a.shift_from_west(v)))
    np.testing.assert_array_equal(
        b.shift_from_south(torch.as_tensor(v)).numpy(),
        np.asarray(a.shift_from_south(v)))


def test_host_order_round_trip(meshes):
    mesh, a, b = meshes
    rng = np.random.default_rng(1)
    u = rng.standard_normal((mesh.num_cells, 2)).astype(np.float32)
    dev = b.from_host_order(torch.as_tensor(u))
    np.testing.assert_array_equal(dev.numpy(),
                                  np.asarray(a.from_host_order(u)))
    np.testing.assert_array_equal(b.to_host_order(dev).numpy(), u)
    # Solid (masked) device cells get zeros.
    solid = b.c_valid.numpy() == 0
    assert solid.any()
    assert (dev.numpy()[solid] == 0).all()


def test_resolve_device_explicit_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
