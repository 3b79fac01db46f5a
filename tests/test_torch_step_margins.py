"""``tests/torch_step_margins.py`` on another case and state than the 403k
Delaunay default (``--case``, ``--state``), on the CPU at a few thousand
cells: a refined quadtree channel cut from ``refined_132k_rest`` (0.02 /
0.04 in place of 0.0025 / 0.005), two steps taken and the third step's
input saved by ``developed_cases.save_step_input``, as ``chip_smoke.py``
phase 10(a) saves the card's.

``cpu-step`` takes that step from the saved state and saves each outer's
input: its outers and FGMRES iterations equal those of the solver that
wrote the state, taking its own third step (the same step in the same
arithmetic), and it writes one file per outer.  ``replay`` then solves a
saved outer again with the port's operators and reports its cycles, and
compares its directions with a saved replay's (``--against``).  The
defaults still name the 403k case and the card's committed 403k state."""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import torch_step_margins as tsm
from cfd2_tpu_torch.tools import developed_cases as dc
from cfd2_tpu_torch.tools import mesh_cache

torch.set_num_threads(2)
SMALL = "refined_small_rest"


@pytest.fixture
def small_case(monkeypatch, tmp_path):
    """The reduced refined case in the case table, its mesh cached under
    ``tmp_path``; its state after two steps saved there.  Returns (case,
    state path, the writer's third step)."""
    monkeypatch.setattr(mesh_cache, "CACHE", str(tmp_path / "cache"))
    case = replace(dc.CASES["refined_132k_rest"], name=SMALL, min_cell=0.02,
                   max_cell=0.04, cells=0)
    monkeypatch.setitem(dc.CASES, SMALL, case)
    s, _ = dc.make_solver(case, device="cpu")
    dc.run_steps(s, 2)
    state = tmp_path / "step2.npz"
    dc.save_step_input(s, state, case=SMALL, step=2)
    return case, state, dc.run_steps(s, 1)[0]


def test_case_and_state_options_drive_the_small_refined_step(small_case,
                                                             tmp_path,
                                                             capsys):
    case, state, ref = small_case
    outers = tmp_path / "outers"
    assert tsm.main(["--case", SMALL, "--state", str(state), "cpu-step",
                     "--save-outers", str(outers), "--threads", "2"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["its"] == ref["its"] and len(got["cycles"]) == ref["outers"]
    assert sorted(p.name for p in outers.iterdir()) == [
        f"outer{k}.npz" for k in range(ref["outers"])]
    with np.load(outers / "outer0.npz") as d:
        assert set(d.files) == set(dc.STEP_INPUT_FIELDS)
        assert d["u"].shape == (dc.case_mesh(case).num_cells, 2)

    saved = tmp_path / "replay.npz"
    assert tsm.main(["--case", SMALL, "--state", str(state), "replay",
                     str(outers), "--outer", "1", "--device", "cpu",
                     "--save", str(saved)]) == 0
    out = capsys.readouterr().out
    assert "\nouter 1 on cpu" in out and "float64" in out
    with np.load(saved) as d:
        assert {"b", "x0", "r0", "z0", "x", "prepare d_p",
                "assemble_ell rhs"} <= set(d.files)
        n_fields = len(d.files)

    # The same replay against its own saved directions: equal bits.
    assert tsm.main(["--case", SMALL, "--state", str(state), "replay",
                     str(outers), "--outer", "1", "--device", "cpu",
                     "--against", str(saved)]) == 0
    compared = [ln for ln in capsys.readouterr().out.splitlines()
                if "of the entries differ" in ln]
    assert len(compared) == n_fields    # all but x, and pc on its r0
    assert all("max-abs 0.000e+00" in ln and "0.0000 of the entries" in ln
               for ln in compared), compared


def test_defaults_name_the_403k_case_and_its_committed_state():
    assert tsm.CASE == "delaunay_403k_rest"
    assert dc.card_step2_path(tsm.CASE) == (
        tsm.ROOT / "cfd2_tpu_torch" / "data" / "delaunay_403k_step2_card.npz")
    assert dc.card_step2_path(tsm.CASE).exists()
    assert dc.card_step2_path("refined_132k_rest").exists()
