"""The port's unstructured mesh generators and the generic branch of its
encode_mesh against cfd2_tpu's on the same geometry and seed.

Both packages run the same NumPy / scipy / native code on the host in
float64, so the generated meshes must be equal array for array, and the
integer layout (device cell order, sorted slots, forward-filled pads, the
banded decision, the slot cap) must be identical.  Geometry planes are
compared after the cast to float32 on both sides, to 1e-6 relative to each
plane's largest magnitude (they come out bitwise equal; the bound only
allows for a differing final cast)."""

import numpy as np
import pytest
import torch

import cfd2_tpu.mesh as jmesh
import cfd2_tpu_torch.mesh as tmesh
from cfd2_tpu.mesh import native as jnative
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.mesh import native as tnative
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh as tencode

torch.set_num_threads(1)

MESH_ARRAYS = ("vx", "vy", "v_fixed", "face_v1", "face_v2", "face_owner",
               "face_neighbor", "face_boundary", "face_nx", "face_ny",
               "face_area", "face_cx", "face_cy", "cell_cx", "cell_cy",
               "cell_vol", "cell_faces", "cell_face_offsets")
INT_FIELDS = ("f_owner", "f_neighbor", "f_neighbor_safe", "f_boundary",
              "grid_of_cell", "ck_face", "ck_neighbor", "ck_boundary")
FLOAT_FIELDS = ("f_area", "f_nx", "f_ny", "f_cx", "f_cy", "f_lambda",
                "f_dist_cc", "c_cx", "c_cy", "c_vol", "c_valid", "ck_mask",
                "ck_sign", "ck_is_boundary", "ck_nx", "ck_ny", "ck_area",
                "ck_lam", "ck_lam_other", "ck_dist_proj", "ck_dist", "ck_rx",
                "ck_ry", "ck_dcdx", "ck_dcdy")
CASES = [("delaunay", 0.06, 0), ("delaunay", 0.05, 3), ("voronoi", 0.06, 2),
         ("voronoi", 0.05, 0)]


def _pair(kind, h, seed):
    out = []
    for mod in (jmesh, tmesh):
        geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
        gen = getattr(mod, f"generate_{kind}_mesh")
        out.append(gen(geo, h, h, 1.2, (3.0, 1.0), seed=seed))
    return out


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{k}-{h}-seed{s}" for k, h, s in CASES])
def pair(request):
    return _pair(*request.param)


def test_native_library_is_shared():
    """Both packages load the one native library; the parity below then
    compares like with like (native sampler on both sides)."""
    assert jnative.available() == tnative.available()
    if tnative.available():
        assert tnative.build() == "present"


def test_serial_build_flags_follow_the_makefile():
    """The build without OpenMP passes the Makefile's own flags minus
    ``-fopenmp``, read from the Makefile, so the two cannot drift apart."""
    import os
    import re
    with open(os.path.join(tnative._NATIVE_DIR, "Makefile")) as f:
        own = re.search(r"^CXXFLAGS\s*\?=\s*(.*)$", f.read(), re.M).group(1)
    flags = tnative._serial_flags().split()
    assert "-fopenmp" in own.split() and "-fopenmp" not in flags
    assert flags == [w for w in own.split() if w != "-fopenmp"]


def test_generators_give_the_same_mesh(pair):
    jm, tm = pair
    assert jm.num_cells == tm.num_cells and jm.num_faces == tm.num_faces
    assert tm.validate() == []
    for name in MESH_ARRAYS:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)


def test_generic_encode_matches(pair):
    jm, tm = pair
    jd = jencode(jm)
    td = tencode(tm, device="cpu")
    assert not td.structured and td.grid_shape is None
    assert (td.num_cells, td.num_faces, td.max_faces, td.num_host_cells) == \
        (jd.num_cells, jd.num_faces, jd.max_faces, jd.num_host_cells)
    assert td.num_cells % 128 == 0
    assert td.banded == jd.banded and td.banded
    assert td.bd_k == jd.bd_k
    for name in INT_FIELDS:
        got = getattr(td, name)
        assert got.dtype == torch.int32 and got.is_contiguous(), name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jd, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(td.f_internal.numpy(),
                                  np.asarray(jd.f_internal))
    for name in FLOAT_FIELDS:
        ref = np.asarray(getattr(jd, name))
        got = getattr(td, name).numpy()
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got - ref).max()) <= 1e-6 * scale, name
    for name, ref in jd.amg_host.items():
        np.testing.assert_array_equal(td.amg_host[name], ref, err_msg=name)


def test_slot_cap_is_set_on_a_polygonal_mesh():
    """Voronoi cells reach 9+ faces on a few cells only: K > 8, bd_k = 8."""
    _, tm = _pair("voronoi", 0.05, 0)
    td = tencode(tm, device="cpu")
    assert td.max_faces > 8 and td.bd_k == 8
    occ = td.ck_mask.numpy()[:, 8:].sum()
    assert 0 < occ <= 0.05 * td.num_cells


def test_pad_slots_repeat_the_last_real_neighbor(pair):
    _, tm = pair
    td = tencode(tm, device="cpu")
    ngh = td.ck_neighbor.numpy()
    mask = td.ck_mask.numpy() > 0
    assert (np.diff(mask.astype(int), axis=1) <= 0).all()   # prefix occupancy
    cnt = mask.sum(axis=1)
    rows = np.nonzero(cnt > 0)[0]
    last = ngh[rows, cnt[rows] - 1]
    for k in range(ngh.shape[1]):
        pad = ~mask[rows, k]
        assert (ngh[rows, k][pad] == last[pad]).all()
    empty = np.nonzero(cnt == 0)[0]                          # padding cells
    assert (ngh[empty] == empty[:, None]).all()
    # Occupied slots are sorted by neighbor id.
    real = np.where(mask, ngh.astype(np.int64), np.iinfo(np.int64).max)
    assert (np.diff(real, axis=1) >= 0).all()


def test_host_order_round_trip(pair):
    _, tm = pair
    td = tencode(tm, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((tm.num_cells, 2))
                        .astype(np.float32))
    dev = td.from_host_order(x)
    assert dev.shape == (td.num_cells, 2)
    assert torch.equal(td.to_host_order(dev), x)
    assert float(dev[td.c_valid == 0].abs().sum()) == 0.0   # padding cells


def test_face_major_fluxes_are_signed_per_slot(pair):
    """slot_fluxes of a face-major field: one owner-outward value per face,
    gathered per slot and negated on the neighbor's side."""
    _, tm = pair
    td = tencode(tm, device="cpu")
    rng = np.random.default_rng(1)
    ff = torch.as_tensor(rng.standard_normal(td.num_faces).astype(np.float32))
    got = td.slot_fluxes(ff).numpy()
    want = ff.numpy()[td.ck_face.numpy()] * td.ck_sign.numpy()
    np.testing.assert_array_equal(got, want)
    slot = torch.zeros((td.num_cells, td.max_faces))
    assert td.slot_fluxes(slot) is slot


def test_smooth_matches():
    """Mesh.smooth (Laplacian smoothing with SDF projection) on a cut-cell
    mesh, where the app applies it."""
    out = []
    for mod in (jmesh, tmesh):
        geo = mod.ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
        m = mod.generate_cut_cell_mesh(geo, 0.1, 0.1, 1.2, (3.0, 1.0))
        m.smooth(geo, 0.0, 5)
        out.append(m)
    for name in ("vx", "vy", "cell_cx", "cell_cy", "cell_vol", "face_area"):
        np.testing.assert_array_equal(getattr(out[1], name),
                                      getattr(out[0], name), err_msg=name)
