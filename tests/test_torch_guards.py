"""Guards of the port's boundaries: it never imports JAX or the JAX package,
its entry points never quietly fall back to the CPU, the layouts and paths
that are not ported raise instead of taking another path, and the
developed-state loader reproduces bench.py's masking."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dataclasses import replace

from cfd2_tpu_torch import ChannelWithObstacle, CoupledSolver, \
    encode_mesh, generate_cut_cell_mesh, generate_delaunay_mesh
from cfd2_tpu_torch.convert import load_developed_state
from cfd2_tpu_torch.runtime import device_mesh as tdm

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "cfd2_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "cfd2_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_package_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['cfd2_tpu'] = None; "
            "import cfd2_tpu_torch, cfd2_tpu_torch.convert, "
            "cfd2_tpu_torch.ops.amg, cfd2_tpu_torch.ops.fgmres, "
            "cfd2_tpu_torch.ops.banded_kernels, "
            "cfd2_tpu_torch.ops.banded_maps, cfd2_tpu_torch.ops.ellsys, "
            "cfd2_tpu_torch.mesh.native, cfd2_tpu_torch.mesh.voronoi, "
            "cfd2_tpu_torch.profile_step; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def small_mesh():
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    return generate_cut_cell_mesh(geo, 0.1, 0.1, 1.2, (3.0, 1.0))


def test_solver_without_device_runs_on_cuda_or_raises(small_mesh):
    """device=None means CUDA; with no GPU it raises instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        assert CoupledSolver(small_mesh).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CoupledSolver(small_mesh)


def test_new_modules_are_scanned():
    names = {p.name for p in PORT_FILES}
    assert {"banded_kernels.py", "banded_maps.py", "ellsys.py", "native.py",
            "delaunay.py", "voronoi.py", "chip_smoke.py"} <= names


def test_refined_quadtree_mesh_still_raises():
    """The multilevel layout is not ported: encode_mesh must say so, not
    send the mesh down the generic path."""
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.05, 0.2, 1.2, (3.0, 1.0))
    assert mesh.cell_level.max() != mesh.cell_level.min()
    assert tdm._multilevel_layout(mesh) is not None
    with pytest.raises(NotImplementedError, match="multilevel"):
        encode_mesh(mesh, device="cpu")


def test_unbanded_index_map_is_detected():
    """A neighbor map with no locality admits none of the JAX package's
    banded maps: banded is False and the slot cap does not apply."""
    rng = np.random.default_rng(0)
    n, k = 8192, 9
    ck = np.sort(rng.integers(0, n, (n, k)), axis=1)
    occ = np.ones((n, k), bool)
    occ[:, 8] = rng.random(n) < 0.01
    assert tdm._banded_decision(ck, occ, n) == (False, None)
    band = np.clip(np.arange(n)[:, None] + np.arange(k)[None, :] - 4, 0,
                   n - 1)
    assert tdm._banded_decision(band, occ, n) == (True, 8)
    assert tdm._banded_decision(band[:, :3], occ[:, :3], n) == (True, None)


def test_generic_mesh_without_banded_map_raises():
    """Such a mesh takes the block-ELL path in the JAX package; the port
    raises at every entry rather than taking another path."""
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_delaunay_mesh(geo, 0.1, 0.1, 1.2, (3.0, 1.0))
    s = CoupledSolver(mesh, device="cpu")
    assert s.mesh.banded
    s.mesh = replace(s.mesh, banded=False)
    x = torch.zeros(s.mesh.num_cells)
    off = torch.zeros((s.mesh.num_cells, s.mesh.max_faces))
    with pytest.raises(NotImplementedError):
        s.mesh.gather(x)
    with pytest.raises(NotImplementedError):
        s.mesh.banded_dot((x,), (off,), (((0, 0),),))
    with pytest.raises(NotImplementedError):
        s.mesh.banded_jacobi_sweeps((x,), x, off, 3)
    for precond in (0, 1):
        s.set_precond_type(precond)
        with pytest.raises(NotImplementedError):
            s.step()


def test_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    """For a CUDA tensor a banded wrapper launches its kernel or raises;
    it never calls its plain version.  Without a GPU the launch path is
    driven with meta tensors up to the build, which must raise."""
    from cfd2_tpu_torch.ops import _build, banded_kernels as bk

    def boom(*a, **k):
        raise AssertionError("plain version reached")

    for name in ("banded_gather_ref", "banded_dot_ref",
                 "banded_jacobi_sweeps_ref"):
        monkeypatch.setattr(bk, name, boom)
    monkeypatch.setattr(bk, "_cuda_or_cpu", lambda t: True)

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)
    idx = torch.zeros((4, 2), dtype=torch.int32)
    x = torch.zeros(4)
    off = torch.zeros((4, 2))
    with pytest.raises(RuntimeError, match="nvcc"):
        bk.banded_gather(x, idx)
    with pytest.raises(RuntimeError, match="nvcc"):
        bk.banded_dot((x,), (off,), idx, (((0, 0),),))
    with pytest.raises(RuntimeError, match="nvcc"):
        bk.banded_jacobi_sweeps((x,), x, off, idx, 3)


def test_load_developed_state(tmp_path, small_mesh):
    s = CoupledSolver(small_mesh, device="cpu")
    ny, nx = s.mesh.grid_shape
    rng = np.random.default_rng(0)
    u = rng.standard_normal((ny, nx, 2)).astype(np.float16)
    p = rng.standard_normal((ny, nx)).astype(np.float16)
    meta = {"viscosity": 0.0025, "grid": [ny, nx]}
    path = tmp_path / "dev.npz"
    np.savez(path, u=u, p=p, meta=json.dumps(meta))
    got = load_developed_state(s, path)
    assert got["viscosity"] == 0.0025
    valid = s.mesh.c_valid.numpy()
    want_u = u.astype(np.float32).reshape(-1, 2) * valid[:, None]
    np.testing.assert_array_equal(s.state.u.numpy(), want_u)
    np.testing.assert_array_equal(
        s.state.p.numpy(), p.astype(np.float32).reshape(-1) * valid)
    for f in ("u_old", "u_old_old", "prev_u"):
        assert torch.equal(getattr(s.state, f), s.state.u)
    assert float(s.params.viscosity) == pytest.approx(0.0025)

    np.savez(path, u=u, p=p, meta=json.dumps({**meta, "grid": [1, 2]}))
    with pytest.raises(ValueError):
        load_developed_state(s, path)


def test_developed_checkpoint_in_repo_matches_main_grid():
    with np.load(ROOT / "bench_developed_1m.npz") as d:
        meta = json.loads(str(d["meta"]))
        assert d["u"].shape == (589, 1765, 2)
    assert meta["grid"] == [589, 1765]
