"""Guards of the port's boundaries: it never imports JAX or the JAX package,
its entry points never quietly fall back to the CPU, and the developed-state
loader reproduces bench.py's masking."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd2_tpu_torch import ChannelWithObstacle, CoupledSolver, \
    generate_cut_cell_mesh
from cfd2_tpu_torch.convert import load_developed_state

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
            "cfd2_tpu_torch.ops.amg, cfd2_tpu_torch.ops.fgmres; "
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
