"""The cell ``large700.mr2t2`` on the CPU: a small copy of ``large700``
(beam2det's beam samples and three atmospheric samples through layered
PREM, cut to a few thousand events) runs ``tiny.mr2t2`` through the harness
and reads correct, and its control does not; the layered oscillation's
frozen floor (``osc_counts.py``) by hand; and the two metrics that read the
program's stamp ``osc_layered``, fed a hand-built record."""
from __future__ import annotations

import json
import types

import numpy as np
import pytest

import tiny
from m3bench import counts, osc_counts, program_trace
from m3bench.run import HERE, _load


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("large700")
    tiny.make_copy(tmp, base="large700")
    return tmp


@pytest.mark.parametrize("control", [0, 1], ids=["program", "control"])
def test_large700_copy_is_correct_and_its_control_is_not(copy, control):
    spec = json.loads((copy / "m3bench/configs/tiny.json").read_text())
    assert spec["n_atmo"] == 1500 and spec["n_params"] == 700
    rc, res, err = tiny.run_cell(copy, "tiny.mr2t2", control=control)
    assert rc == 0, err
    assert res["correct"] is (not control), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _inputs(cosz, n_e=7, n_samples=2):
    """Inputs with ``n_samples`` atmospheric samples on one grid and a beam one."""
    atmo = {"kind": "atmo", "e_grid": np.geomspace(0.5, 100.0, n_e),
            "cosz_grid": np.asarray(cosz, np.float64), "production_height_km": 15.0}
    beam = types.SimpleNamespace(osc={"kind": "beam", "e_grid": np.ones(3)})
    return types.SimpleNamespace(
        samples=[beam] + [types.SimpleNamespace(osc=dict(atmo)) for _ in range(n_samples)])


def test_layered_floor_by_hand():
    # Through the core: air and 9 shells (5 products); down-going: air (1).
    cosz, n_e, chains = [-1.0, 0.5], 7, 3
    inputs = _inputs(cosz, n_e)
    assert osc_counts.layered_grids(inputs) == [(n_e, [10, 1])]
    n_bytes, ops = osc_counts.layered(inputs, chains)
    assert n_bytes == 2 * chains * 2 * n_e * 9 * 4
    assert ops == 2 * chains * n_e * 216 * (5 + 1)
    assert osc_counts.layered(_inputs(cosz, n_e, n_samples=0), chains) == (0.0, 0.0)


def _read(monkeypatch, name, layers, inputs):
    record = types.SimpleNamespace(steps=10, layers={"mr2t2.step": layers}, counts={}, spans={})
    monkeypatch.setattr(program_trace, "tracing",
                        lambda: types.SimpleNamespace(last_chunk=lambda: record))
    monkeypatch.setattr(osc_counts, "run_inputs", lambda: inputs)
    metric = _load(HERE / "metrics" / f"{name}.py", f"test_{name}")
    ctx = types.SimpleNamespace(steps=10, n_chains=512)
    return metric.read(ctx)


def test_run_inputs_finds_the_harness_runs_inputs():
    """``run_inputs`` finds the inputs a caller's frame holds as ``inputs``,
    as ``run.main`` holds them while it reads the per-layer metrics; a
    rename there fails here rather than leave the floor unread."""
    from m3bench import run

    assert "inputs" in run.main.__code__.co_varnames

    def harness(held):
        inputs = held
        return inputs, (lambda: osc_counts.run_inputs())()

    held, found = harness(_inputs([-1.0], 5, 1))
    assert found is held
    assert osc_counts.run_inputs() is None  # no frame of this test holds any


@pytest.mark.parametrize("name", ["osc_layered_ms_per_step.mr2t2", "osc_layered_roofline.mr2t2"])
def test_layered_metrics_read_the_stamp(monkeypatch, name):
    inputs = _inputs(np.linspace(-0.99, 0.99, 20), 50, 3)
    got = _read(monkeypatch, name, {"osc": 2.0, "osc_layered": 4.0, "base": 1.0}, inputs)
    if name.startswith("osc_layered_ms"):
        assert got == 4.0
    else:
        want = 100.0 * counts.floor_s(*osc_counts.layered(inputs, 512)) / 4e-3
        assert got == pytest.approx(want, rel=1e-12) and 0.0 < got < 100.0
    # A beam-only model's step has no such stamp; without inputs no floor.
    assert _read(monkeypatch, name, {"osc": 2.0, "base": 1.0}, inputs) is None
    if name.endswith("roofline.mr2t2"):
        assert _read(monkeypatch, name, {"osc_layered": 4.0}, _inputs([-1.0], 50, 0)) is None
        inputs = None
        assert _read(monkeypatch, name, {"osc_layered": 4.0}, inputs) is None
