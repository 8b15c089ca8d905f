"""The per-layer metrics that read the program's own tracing
(``program_trace.py``): each fed a hand-built trace and program record with
known values, and each giving None where there is nothing to read (no such
module in the program, a record of another chunk, no span in the trace)."""
from __future__ import annotations

import types

import pytest

from m3bench import program_trace
from m3bench.run import HERE, _load
from m3bench.trace import Trace

STEPS = 10


def _record(steps=STEPS):
    return types.SimpleNamespace(
        index=3, steps=steps,
        layers={"mr2t2.step": {"start": 0.001, "propose": 0.2, "prior": 0.5, "osc": 0.75,
                               "base": 2.0, "reweight": 6.0, "stat": 0.25, "accept": 0.1},
                "hmc.prologue": {"prologue": 0.3},
                "hmc.iteration": {"forward": 0.01, "base": 1.0, "backward": 7.5,
                                  "leapfrog": 0.2}},
        counts={"program": {"host_reads": 16, "host_read_bytes": 1000}},
        spans={})


def _trace():
    host = [("user_annotation", "runner.replay.mr2t2.step", 0.0, 300.0),
            ("user_annotation", "runner.replay.mr2t2.step", 400.0, 200.0),
            ("user_annotation", "runner.collect", 900.0, 1500.0),
            ("user_annotation", "runner.callback", 2400.0, 500.0),
            ("user_annotation", "hmc.length_read", 3000.0, 4000.0),
            ("cuda_runtime", "runner.replay.not_a_span", 0.0, 9e9),
            ("user_annotation", "runner.chunk", 0.0, 9e9)]
    return Trace(device=[("k", 0.0, 10.0)], host=host, window_s=0.01)


def _fake_program(record, build_s=12.5):
    return types.SimpleNamespace(last_chunk=lambda: record,
                                 setup_seconds=lambda prefix: build_s if prefix == "build."
                                 else None)


def _read(monkeypatch, name, program, trace):
    monkeypatch.setattr(program_trace, "tracing", lambda: program)
    metric = _load(HERE / "metrics" / f"{name}.py", f"test_{name}")
    return metric.read(types.SimpleNamespace(trace=trace, steps=STEPS))


KNOWN = {
    "glue_ms_per_step.mr2t2": 0.5 + 2.0 + 0.25,
    "osc_ms_per_step.mr2t2": 0.75,
    "graph_launch_ms_per_step.mr2t2": (300.0 + 200.0) * 1e-3 / STEPS,
    "chunk_end_ms_per_step.mr2t2": (1500.0 + 500.0) * 1e-3 / STEPS,
    "backward_ms_per_eval.chees": 7.5,
    "host_wait_ms_per_step.chees": 4000.0 * 1e-3 / STEPS,
    "host_reads_per_step.chees": 16 / STEPS,
    "model_build_s": 12.5,
}
#: The metrics that read the trace's spans, the others the program's record.
FROM_TRACE = {"graph_launch_ms_per_step.mr2t2", "chunk_end_ms_per_step.mr2t2",
              "host_wait_ms_per_step.chees"}


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_metric_reads_the_known_value(monkeypatch, name):
    got = _read(monkeypatch, name, _fake_program(_record()), _trace())
    assert got == pytest.approx(KNOWN[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_metric_is_none_where_there_is_nothing_to_read(monkeypatch, name):
    empty = Trace(device=[], host=[], window_s=0.01)
    if name in FROM_TRACE:
        assert _read(monkeypatch, name, _fake_program(_record()), empty) is None
    elif name == "model_build_s":
        assert _read(monkeypatch, name, None, _trace()) is None
        assert _read(monkeypatch, name, _fake_program(None, None), _trace()) is None
    else:
        assert _read(monkeypatch, name, None, _trace()) is None
        assert _read(monkeypatch, name, _fake_program(None), _trace()) is None
        # A record of a chunk other than the traced one.
        assert _read(monkeypatch, name, _fake_program(_record(steps=STEPS + 1)),
                     _trace()) is None


def test_program_module_is_found_and_a_missing_one_reads_none(monkeypatch):
    import sys

    mod = program_trace.tracing()
    assert mod is not None and hasattr(mod, "last_chunk")
    import mach3_tpu_torch.core

    monkeypatch.delattr(mach3_tpu_torch.core, "tracing")
    monkeypatch.setitem(sys.modules, "mach3_tpu_torch.core.tracing", None)  # import fails
    assert program_trace.tracing() is None
