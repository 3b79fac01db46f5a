"""Guards of the port's boundaries: it never imports JAX or the JAX package,
its entry points never quietly fall back to the CPU, every mesh takes the
layout and path the JAX package gives it (the fused banded products refuse
a mesh without a banded map), and the developed-state loader reproduces
bench.py's masking."""

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
            "cfd2_tpu_torch.runtime.checkpoint, "
            "cfd2_tpu_torch.runtime.async_reader, "
            "cfd2_tpu_torch.profile_step, cfd2_tpu_torch.ops.blockell, "
            "cfd2_tpu_torch.ops.schur, cfd2_tpu_torch.ops.krylov, "
            "cfd2_tpu_torch.ops.host_krylov, "
            "cfd2_tpu_torch.models.pressure_poisson, "
            "cfd2_tpu_torch.app, cfd2_tpu_torch.app.__main__, "
            "cfd2_tpu_torch.utils, cfd2_tpu_torch.utils.forces, "
            "cfd2_tpu_torch.runtime.profiling, cfd2_tpu_torch.viz, "
            "cfd2_tpu_torch.viz.live_server, cfd2_tpu_torch.parallel, "
            "cfd2_tpu_torch.parallel.batch, cfd2_tpu_torch.parallel.spatial, "
            "cfd2_tpu_torch.parallel.launch, "
            "cfd2_tpu_torch.tools.developed_cases, "
            "cfd2_tpu_torch.tools.make_developed_unstructured, "
            "cfd2_tpu_torch.tools.validate_turek, "
            "cfd2_tpu_torch.tools.stiff_water, "
            "cfd2_tpu_torch.tools.make_developed, "
            "cfd2_tpu_torch.tools.make_developed_2m, "
            "cfd2_tpu_torch.tools.measure_strouhal; "
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
            "delaunay.py", "voronoi.py", "chip_smoke.py", "checkpoint.py",
            "async_reader.py", "blockell.py", "schur.py", "krylov.py",
            "host_krylov.py", "pressure_poisson.py", "forces.py",
            "metrics.py", "profiling.py", "driver.py", "fluids.py",
            "__main__.py", "renderer.py", "html_viewer.py", "live_server.py",
            "batch.py", "spatial.py", "launch.py"} <= names


def test_refined_quadtree_mesh_takes_the_multilevel_layout():
    """encode_mesh lays a refined quadtree mesh out on its level grids, as
    the JAX package does, and does not send it down the generic path: the
    same levels, slot maps and banded decision."""
    from cfd2_tpu.mesh import ChannelWithObstacle as JGeo
    from cfd2_tpu.mesh import generate_cut_cell_mesh as jgen
    from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_cut_cell_mesh(geo, 0.05, 0.2, 1.2, (3.0, 1.0))
    assert mesh.cell_level.max() != mesh.cell_level.min()
    assert tdm._multilevel_layout(mesh) is not None
    dm = encode_mesh(mesh, device="cpu")
    jm = jencode(jgen(JGeo(3.0, 1.0, (1.0, 0.5), 0.2), 0.05, 0.2, 1.2,
                      (3.0, 1.0)))
    assert dm.multilevel and not dm.structured
    assert dm.ml_levels == jm.ml_levels and dm.banded == jm.banded
    for f in ("ck_neighbor", "ck_mirror", "ml_pair_cell_b", "grid_of_cell"):
        assert np.array_equal(getattr(dm, f).numpy(),
                              np.asarray(getattr(jm, f))), f


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


def test_generic_mesh_without_banded_map_takes_the_block_path():
    """Such a mesh takes the block-ELL path, as in the JAX package: its
    gather runs through the banded gather (here its plain version), the
    fused banded products still refuse it (the JAX package never calls them
    there), and one step in either mode agrees with cfd2_tpu's (the
    tolerances of tests/test_torch_block_steps.py)."""
    from cfd2_tpu.mesh import ChannelWithObstacle as JGeo
    from cfd2_tpu.mesh import generate_delaunay_mesh as jgen
    from cfd2_tpu.models.coupled import CoupledSolver as JSolver
    from torch_parity import assert_step_matches, clear_banded_pair
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    mesh = generate_delaunay_mesh(geo, 0.1, 0.1, 1.2, (3.0, 1.0))
    jmesh = jgen(JGeo(3.0, 1.0, (1.0, 0.5), 0.2), 0.1, 0.1, 1.2, (3.0, 1.0))
    s = CoupledSolver(mesh, device="cpu")
    assert s.mesh.banded
    s.mesh = replace(s.mesh, banded=False)
    x = torch.arange(s.mesh.num_cells, dtype=torch.float32)
    off = torch.zeros((s.mesh.num_cells, s.mesh.max_faces))
    assert torch.equal(s.mesh.gather(x), x[s.mesh.ck_neighbor.long()])
    with pytest.raises(NotImplementedError):
        s.mesh.banded_dot((x,), (off,), (((0, 0),),))
    with pytest.raises(NotImplementedError):
        s.mesh.banded_jacobi_sweeps((x,), x, off, 3)
    for precond in (0, 1):
        for mode in ("fused", "host"):
            js, t = JSolver(jmesh), CoupledSolver(mesh, device="cpu")
            clear_banded_pair(js, t)
            for sol, h in ((js, jmesh), (t, mesh)):
                sol.set_dt(0.005)
                sol.set_precond_type(precond)
                u0 = np.zeros((h.num_cells, 2))
                u0[h.cell_cx < 0.1, 0] = 1.0
                sol.set_u(u0)
            js.step(mode=mode)
            t.step(mode=mode)
            assert not t.mesh.banded and int(t.state.outer_iters) > 0
            assert_step_matches(js, t, (precond, mode), lin_per_outer=2,
                                p_rel=1e-3 if precond == 0 else 1e-4)


def test_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    """For a CUDA tensor a banded wrapper launches its kernel or raises;
    it never calls its plain version.  Without a GPU the launch path is
    driven with meta tensors up to the build, which must raise."""
    from cfd2_tpu_torch.ops import _build, banded_kernels as bk

    def boom(*a, **k):
        raise AssertionError("plain version reached")

    for name in ("banded_gather_ref", "banded_prolong_add_ref",
                 "banded_dot_ref", "banded_jacobi_sweeps_ref"):
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
        bk.banded_prolong_add(x, x, torch.zeros((4, 1), dtype=torch.int32),
                              1.5)
    with pytest.raises(RuntimeError, match="nvcc"):
        bk.banded_dot((x,), (off,), idx, (((0, 0),),))
    with pytest.raises(RuntimeError, match="nvcc"):
        bk.banded_jacobi_sweeps((x,), x, off, idx, 3)

    # The gathers of the multilevel layout, of a generic mesh without a
    # banded map and of its face-parallel fluxes go through the wrapper.
    from cfd2_tpu_torch.models.assembly import compute_fluxes
    from cfd2_tpu_torch.ops.blockell import scalar_spmv
    from cfd2_tpu_torch.runtime.state import SolverParams, initial_state
    geo = ChannelWithObstacle(3.0, 1.0, (1.0, 0.5), 0.2)
    ml = encode_mesh(generate_cut_cell_mesh(geo, 0.05, 0.2, 1.2, (3.0, 1.0)),
                     device="cpu")
    gen = replace(encode_mesh(generate_delaunay_mesh(
        geo, 0.1, 0.1, 1.2, (3.0, 1.0)), device="cpu"), banded=False)
    for dm in (ml, gen):
        xs = torch.zeros(dm.num_cells)
        with pytest.raises(RuntimeError, match="nvcc"):
            dm.gather(xs)
        with pytest.raises(RuntimeError, match="nvcc"):
            scalar_spmv(xs, torch.zeros((dm.num_cells, dm.max_faces)), dm,
                        xs)
    state = initial_state(gen)
    with pytest.raises(RuntimeError, match="nvcc"):
        compute_fluxes(gen, state, SolverParams.default(device="cpu"),
                       state.time)
    with pytest.raises(RuntimeError, match="nvcc"):
        gen.slot_fluxes(state.fluxes)


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


# ----------------------------------------------------------------------
# chip_smoke.py states some of the package's facts itself (it also times
# checkouts that predate them); here they are held against the package.


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["scalar", "mom2", "schur_rhs", "grad",
                                  "spmv"])
def test_chip_smoke_names_the_package_dot_forms(name):
    from cfd2_tpu_torch.ops import banded_kernels as bk
    smoke = _chip_smoke()
    assert set(smoke.DOT_FORMS) == set(bk.DOT_FORMS)
    assert smoke.DOT_FORMS[name] == bk.DOT_FORMS[name]
    n_x, n_off, prods = smoke.DOT_FORMS[name]
    assert bk.dot_form(prods, n_x, n_off) == name
    assert bk.dot_form(smoke.DOT_OTHER[2], *smoke.DOT_OTHER[:2]) == "generic"


def test_chip_smoke_level_grids_follow_the_package():
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    smoke = _chip_smoke()
    grids, coarsest = smoke.level_grids(*smoke.MAIN_GRID)
    assert [g[0] for g in grids] == [589, 295, 148, 74, 37, 19, 10]
    for fine, coarse in zip(grids, grids[1:] + [coarsest]):
        assert smoke.coarse_of(fine) == sk.coarse_grid_of(fine) == coarse


def test_chip_smoke_refuses_a_tree_outside_the_checkout(tmp_path, capsys):
    smoke = _chip_smoke()
    (tmp_path / "cfd2_tpu_torch").mkdir()
    before = list(sys.path)
    assert smoke.main(["--tree", str(tmp_path)]) == 2
    assert sys.path == before
    assert "not a checkout inside" in capsys.readouterr().err
    # Inside the checkout, but no package there.
    assert smoke.main(["--tree", str(ROOT / "tests")]) == 2
