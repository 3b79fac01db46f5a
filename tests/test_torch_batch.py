"""The port's batched cases (cfd2_tpu_torch/parallel/batch.py): each of B = 3
cases of a batched step, a parameter sweep and a batched multi-step equals
its own single step, exactly (the cases run one after another through the
same step on the same inputs), on a batch as made and as placed by
shard_batch; a batch on another device than the mesh, or placed over two
devices, is refused.  The port's sweep_step also equals the JAX package's
(vmapped) sweep_step on the same three cases, carried across with
convert.py, within the bounds of tests/torch_parity.py."""

from dataclasses import fields

import numpy as np
import pytest
import torch

import jax

from cfd2_tpu.mesh import RectangularChannel as JRectangularChannel
from cfd2_tpu.mesh import generate_cut_cell_mesh as j_generate
from cfd2_tpu.parallel.batch import sweep_step as j_sweep_step
from cfd2_tpu.runtime import state as js
from cfd2_tpu.runtime.device_mesh import encode_mesh as jencode
from cfd2_tpu_torch.convert import params_from_arrays, state_from_arrays
from cfd2_tpu_torch.mesh import RectangularChannel, generate_cut_cell_mesh
from cfd2_tpu_torch.models.coupled import multi_step, step
from cfd2_tpu_torch.parallel import (batched_initial_state,
                                     batched_multi_step, batched_step,
                                     shard_batch)
from cfd2_tpu_torch.parallel.batch import batched_params, sweep_step
from cfd2_tpu_torch.runtime.device_mesh import encode_mesh
from cfd2_tpu_torch.runtime.state import PARAMS_FIELDS, STATE_FIELDS, \
    SolverConfig, SolverParams, SolverState, initial_state

torch.set_num_threads(1)
B = 3


@pytest.fixture(scope="module")
def setup():
    geo = RectangularChannel(length=2.0, height=1.0)
    mesh = generate_cut_cell_mesh(geo, 0.125, 0.125, 1.2, (2.0, 1.0))
    dm = encode_mesh(mesh, device="cpu")
    u0s = []
    for k in range(B):
        u0 = np.zeros((mesh.num_cells, 2))
        u0[mesh.cell_cx < 0.25, 0] = 1.0 + 0.25 * k
        u0s.append(u0)
    singles = [initial_state(dm, u0=u0) for u0 in u0s]
    bstate = SolverState(**{f.name: torch.stack([getattr(s, f.name)
                                                 for s in singles])
                            for f in fields(SolverState)})
    return dm, singles, bstate


def _equal(got: SolverState, i: int, want: SolverState):
    for f in fields(SolverState):
        assert torch.equal(getattr(got, f.name)[i], getattr(want, f.name)), \
            (i, f.name)


def test_batched_initial_state(setup):
    dm, singles, _ = setup
    b = batched_initial_state(dm, batch=B)
    assert b.u.shape == (B, dm.num_cells, 2) and b.time.shape == (B,)
    one = initial_state(dm)
    for i in range(B):
        _equal(b, i, one)


@pytest.mark.parametrize("devices", [None, ["cpu"]],
                         ids=["as made", "placed"])
def test_batched_step_cases_equal_single_steps(setup, devices):
    dm, singles, bstate = setup
    config = SolverConfig()
    params = SolverParams.default(dt=0.01, device="cpu")
    arg = bstate if devices is None else shard_batch(bstate, devices)
    out = batched_step(dm, arg, params, config)
    assert isinstance(out, SolverState) and out.u.shape[0] == B
    for i, s in enumerate(singles):
        ref = step(dm, s, params, config)
        assert int(ref.outer_iters) > 0
        _equal(out, i, ref)
    assert not torch.equal(out.u[0], out.u[-1])


def test_sweep_step_cases_equal_single_steps(setup):
    """Per-case viscosities: each case equals a single step with that
    viscosity, and different viscosities give different fields."""
    dm, singles, bstate = setup
    config = SolverConfig()
    base = SolverParams.default(dt=0.01, device="cpu")
    viscs = [0.001, 0.01, 0.05]
    bparams = batched_params(base, {"viscosity": viscs})
    assert bparams.viscosity.shape == (B,) and bparams.dt.ndim == 0
    out = sweep_step(dm, bstate, bparams, config)
    for i, (s, nu) in enumerate(zip(singles, viscs)):
        p = SolverParams.default(dt=0.01, viscosity=nu, device="cpu")
        _equal(out, i, step(dm, s, p, config))
    same = SolverState(**{f.name: torch.stack([getattr(singles[0], f.name)]
                                               * B)
                          for f in fields(SolverState)})
    u = sweep_step(dm, same, bparams, config).u
    assert (u[0] - u[-1]).abs().max() > 1e-5
    with pytest.raises(ValueError, match="cases"):
        sweep_step(dm, bstate, batched_params(base, {"viscosity": viscs[:2]}),
                   config)


def test_batched_multi_step_cases_equal_single_runs(setup):
    dm, singles, bstate = setup
    config = SolverConfig()
    params = SolverParams.default(dt=0.01, device="cpu")
    out, metrics = batched_multi_step(dm, bstate, params, config, 2)
    assert metrics["outer_iters"].shape == (B, 2)
    for i, s in enumerate(singles):
        ref, ref_m = multi_step(dm, s, params, config, 2)
        _equal(out, i, ref)
        for k, v in ref_m.items():
            assert torch.equal(metrics[k][i], v), k


def test_shard_on_another_device_is_refused(setup):
    dm, _, bstate = setup
    meta = SolverState(**{f.name: getattr(bstate, f.name).to("meta")
                          for f in fields(SolverState)})
    with pytest.raises(ValueError, match="mesh"):
        batched_step(dm, meta, SolverParams.default(device="cpu"),
                     SolverConfig())
    for devices in ([], ["cpu", "cpu"]):
        with pytest.raises(ValueError, match="devices"):
            shard_batch(bstate, devices)


VISCS = [0.001, 0.01, 0.05]


@pytest.fixture(scope="module")
def jax_sweep():
    """The JAX package's sweep_step over three cases of the 0.125 channel
    (three inlet speeds, three viscosities, every params field broadcast to
    (B,) as tests/test_parallel.py does), and the same inputs carried into
    the port: (port mesh, port batched state, port batched params, JAX
    output as numpy fields)."""
    geo = JRectangularChannel(length=2.0, height=1.0)
    mesh = j_generate(geo, 0.125, 0.125, 1.2, (2.0, 1.0))
    jm = jencode(mesh)
    singles = []
    for k in range(B):
        u0 = np.zeros((mesh.num_cells, 2))
        u0[mesh.cell_cx < 0.25, 0] = 1.0 + 0.25 * k
        singles.append(js.initial_state(jm, u0=u0))
    jb = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *singles)
    base = js.SolverParams.default(dt=0.01)
    jp = jax.tree.map(lambda x: jax.numpy.broadcast_to(x, (B,) + x.shape),
                      base)
    jp = js.SolverParams(**{**{f: getattr(jp, f) for f in PARAMS_FIELDS},
                            "viscosity": jax.numpy.asarray(
                                VISCS, jax.numpy.float32)})
    out = j_sweep_step(jm, jb, jp, js.SolverConfig())
    tb = state_from_arrays({f: np.asarray(getattr(jb, f))
                            for f in STATE_FIELDS}, "cpu")
    tp = params_from_arrays({f: np.asarray(getattr(jp, f))
                             for f in PARAMS_FIELDS}, "cpu")
    want = {f: np.asarray(getattr(out, f)) for f in
            ("u", "p", "outer_iters", "linear_iters_total", "time")}
    return encode_mesh(mesh, device="cpu"), tb, tp, want


def test_sweep_step_equals_jax_sweep_step(jax_sweep):
    """Bounds of tests/torch_parity.py (it says why): equal outer counts,
    FGMRES iterations within 1 per outer, u within 1e-4 * max|u| and p
    within 1e-3 * max|p| of the JAX case, per case."""
    dm, tb, tp, want = jax_sweep
    assert tp.viscosity.shape == (B,) and tp.dt.shape == (B,)
    out = sweep_step(dm, tb, tp, SolverConfig())
    for i in range(B):
        jo, to = int(want["outer_iters"][i]), int(out.outer_iters[i])
        assert to == jo > 0, (i, to, jo)
        jl, tl = int(want["linear_iters_total"][i]), \
            int(out.linear_iters_total[i])
        assert abs(tl - jl) <= jo, (i, tl, jl)
        for f, rel in (("u", 1e-4), ("p", 1e-3)):
            ref = want[f][i]
            got = getattr(out, f)[i].numpy()
            assert np.isfinite(got).all(), (i, f)
            assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), (i, f)
        assert float(out.time[i]) == pytest.approx(float(want["time"][i]))
    assert np.abs(want["u"][0] - want["u"][-1]).max() > 1e-5


# ----------------------------------------------------------------------
# Cases over ranks: tests/test_parallel.py:37-57 shards 8 cases over 8
# devices; here 8 cases split over 4 gloo ranks on the CPU (2 each).

RANK_CASES, RANK_WORLD = 8, 4
RANK_VISCS = [0.001, 0.002, 0.005, 0.01, 0.02, 0.03, 0.05, 0.1]


def test_cases_over_ranks_equal_single_steps_and_jax():
    """Each rank steps its own cases with its own mesh; gathered back,
    every rank sees every case, each bit-equal to the port's single step of
    that case (same code, same inputs, one CPU thread) and within 1e-5 of
    the JAX package's batched_step sharded over 8 devices (the JAX test's
    bound)."""
    from jax.sharding import Mesh as JMesh
    import torch_spatial_ranks as ranks
    from cfd2_tpu.parallel.batch import batched_step as j_batched_step
    from cfd2_tpu.parallel.batch import shard_batch as j_shard_batch
    from cfd2_tpu_torch.parallel.launch import run_ranks

    geo = JRectangularChannel(length=2.0, height=1.0)
    mesh = j_generate(geo, 0.125, 0.125, 1.2, (2.0, 1.0))
    u0s = []
    for k in range(RANK_CASES):
        u0 = np.zeros((mesh.num_cells, 2))
        u0[mesh.cell_cx < 0.25, 0] = 1.0 + 0.25 * k
        u0s.append(u0)
    res = run_ranks(ranks.batch_cases, RANK_WORLD, device="cpu", timeout=180,
                    args=(mesh, u0s, RANK_VISCS))
    for r in res:
        assert r["batched"]["local"] == RANK_CASES // RANK_WORLD
        for kind in ("batched", "sweep"):
            for key in ("u", "p", "outer", "lin"):
                np.testing.assert_array_equal(r[kind][key], res[0][kind][key])
    got = res[0]

    dm = encode_mesh(mesh, device="cpu")
    config = SolverConfig()
    for k, u0 in enumerate(u0s):
        s = initial_state(dm, u0=u0)
        one = step(dm, s, SolverParams.default(dt=0.01, device="cpu"),
                   config)
        np.testing.assert_array_equal(got["batched"]["u"][k], one.u.numpy())
        assert got["batched"]["outer"][k] == int(one.outer_iters) > 0
        nu = step(dm, s, SolverParams.default(dt=0.01, viscosity=RANK_VISCS[k],
                                              device="cpu"), config)
        np.testing.assert_array_equal(got["sweep"]["u"][k], nu.u.numpy())

    jm = jencode(mesh)
    jb = jax.tree.map(lambda *xs: jax.numpy.stack(xs),
                      *[js.initial_state(jm, u0=u0) for u0 in u0s])
    devs = JMesh(np.array(jax.devices("cpu")[:8]), axis_names=("batch",))
    jout = j_batched_step(jm, j_shard_batch(jb, devs),
                          js.SolverParams.default(dt=0.01), js.SolverConfig())
    ju = np.asarray(jout.u)
    np.testing.assert_array_equal(np.asarray(jout.outer_iters),
                                  got["batched"]["outer"])
    assert np.abs(got["batched"]["u"] - ju).max() < 1e-5
