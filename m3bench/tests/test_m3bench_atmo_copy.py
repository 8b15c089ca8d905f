"""An atmospheric small copy through the harness on the CPU: ``large`` (a
numu and a nue beam sample and an atmospheric one through layered PREM) cut
to a few thousand events gains its cells as new files and entries and runs
them, with the control and without. Without the control ``correct`` is not
asserted: it holds the program's PREM paths to the reference's own."""
from __future__ import annotations

import json

import pytest

import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def atmo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("atmo")
    tiny.make_copy(tmp, base="large")
    return tmp


@pytest.fixture(scope="module")
def beam_checks(tmp_path_factory):
    """The names of the checks that the beam copy's cell gives (its control
    run), by cell."""
    tmp = tmp_path_factory.mktemp("beam")
    tiny.make_copy(tmp)
    assert "n_atmo" not in json.loads((tmp / "m3bench/configs/tiny.json").read_text())
    names: dict = {}

    def of(cell):
        if cell not in names:
            rc, res, err = tiny.run_cell(tmp, cell, control=1)
            assert rc == 0, err
            names[cell] = set(res["checks"])
        return names[cell]
    return of


@pytest.mark.parametrize("control", [1, 0], ids=["control", "program"])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_atmospheric_copy_runs_through_the_harness(atmo, beam_checks, cell, control):
    spec = json.loads((atmo / "m3bench/configs/tiny.json").read_text())
    assert spec["n_atmo"] == 1500 and spec["atmo_cosz_grid_size"] > 1
    before = {p: p.read_bytes() for p in (tiny.REPO / "m3bench").rglob("*.py")}
    rc, res, err = tiny.run_cell(atmo, cell, control=control)
    assert rc == 0, err
    assert set(res) == KEYS and list(res)[-1] == "checks"
    assert set(res["checks"]) == beam_checks(cell)
    if control:
        assert res["correct"] is False, res["checks"]
    rate = "chain_steps_per_s" if cell.endswith("mr2t2") else "grad_evals_per_s"
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert "check" in err.strip().splitlines()[-1]
    assert before == {p: p.read_bytes() for p in before}
