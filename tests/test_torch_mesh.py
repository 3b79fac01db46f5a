"""The port's own copy of the host mesh pipeline produces the same meshes as
cfd2_tpu.mesh (NumPy float64 on both sides, so equality is exact)."""

import dataclasses

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh

torch.set_num_threads(1)


def _geometries(mod):
    return {
        "channel_obstacle": mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2),
        "rect_channel": mod.RectangularChannel(2.0, 1.0),
        "backwards_step": mod.BackwardsStep(3.0, 1.0, 0.5, 0.5),
    }


@pytest.mark.parametrize("geo", ["channel_obstacle", "rect_channel",
                                 "backwards_step"])
@pytest.mark.parametrize("cells", [(0.05, 0.05), (0.03, 0.12)])
def test_cut_cell_mesh_arrays_identical(geo, cells):
    dom = (3.0, 1.0) if geo != "rect_channel" else (2.0, 1.0)
    a = jmesh.generate_cut_cell_mesh(_geometries(jmesh)[geo], *cells, 1.2,
                                     dom)
    b = tmesh.generate_cut_cell_mesh(_geometries(tmesh)[geo], *cells, 1.2,
                                     dom)
    assert a.num_cells == b.num_cells and a.num_cells > 0
    for f in dataclasses.fields(type(a)):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def test_sdf_identical():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 3.5, 500)
    y = rng.uniform(-0.5, 1.5, 500)
    for name, g in _geometries(jmesh).items():
        h = _geometries(tmesh)[name]
        np.testing.assert_array_equal(g.sdf(x, y), h.sdf(x, y))
