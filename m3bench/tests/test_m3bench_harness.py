"""The harness on the CPU: a copy of the benchmark gains a configuration, a
traffic mix, a cell and a metric as new files and entries and runs them;
the last line's keys; no result without a card; the reference against the
program's CPU path; and each fault that a cell can have, planted in the
program underneath a run, comes out as not correct."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    tiny.make_copy(tmp)
    return tmp


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_new_cell_runs_from_new_files(copy, cell):
    before = {p: p.read_bytes() for p in (tiny.REPO / "m3bench").rglob("*.py")}
    rc, res, err = tiny.run_cell(copy, cell)
    assert rc == 0, err
    assert set(res) == KEYS and list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    rate = "chain_steps_per_s" if cell.endswith("mr2t2") else "grad_evals_per_s"
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert "check" in err.strip().splitlines()[-1]
    assert before == {p: p.read_bytes() for p in before}


def test_traced_run_finds_the_new_metric(copy):
    rc, res, err = tiny.run_cell(copy, "tiny.mr2t2", trace=1)
    assert rc == 0, err
    assert res["metrics"]["tiny_steps"]["value"] == 2.0
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res) == KEYS | {"breakdown"} and list(res)[-1] == "checks"


def test_no_result_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "m3bench", "--workload", "beam1det.mr2t2",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tiny.REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(tiny.REPO / "m3bench", tmp_path / "m3bench")
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "m3bench", "--workload", "beam1det.mr2t2",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("config", ["beam2det", "beam1det", "large"])
def test_reference_against_the_programs_cpu_path(config):
    """The reference agrees with the program at a tiny size: on a beam
    sample as it stands, on an atmospheric sample fed the program's own
    PREM layer paths (the witness of the rest of the sample's likelihood).
    The program's paths against the reference's own are what an atmospheric
    cell's ``correct`` compares; the reference's paths and layered
    propagation have tests of their own (``test_m3bench_reference_osc.py``)."""
    from m3bench import port
    from m3bench.fault_prem import program_paths
    from m3bench.reference.likelihood import F64, Reference, spline_tables
    from m3bench.reference.params import read
    from m3bench.run import _load
    from m3bench.samplers.mr2t2 import initial_thetas

    torch.set_num_threads(2)
    spec = json.loads((tiny.REPO / "m3bench" / "configs" / f"{config}.json").read_text())
    spec.update(n_numu=1500, n_nue=500, n_atmo=1500, n_beam_generated=4000)
    gen = _load(tiny.REPO / "m3bench" / "configs" / f"{config}.py", f"t_{config}")
    inputs = gen.build(spec, 99)
    params = read(inputs.trees)
    tables = spline_tables(inputs)
    inputs.data = Reference(inputs, "cpu", tables).asimov(torch.as_tensor(params.prefit))
    model = port.build_model(inputs, "cpu")
    theta = torch.as_tensor(initial_thetas(params, 4, np.random.default_rng(0), 0.3))
    with torch.no_grad():
        prog = model.total_nll_batch_parts(theta)[2]
    ref = Reference(inputs, "cpu", tables)
    for s in ref.samples:
        if s.osc["kind"] == "atmo":
            s.paths = program_paths(s.osc["cosz_grid"], s.osc["production_height_km"])
    grids: dict = {}
    want = torch.stack([s.nll(theta, grids, F64) for s in ref.samples], 1)
    gap = (prog - want).abs().amax(0)
    assert [s.osc["kind"] for s in ref.samples].count("atmo") == (config == "large")
    for i, s in enumerate(ref.samples):
        assert float(gap[i]) < 1e-2, (s.name, s.osc["kind"], float(gap[i]))


def test_beam_configurations_have_no_parameter_that_only_the_prior_reads():
    """Every parameter of a beam configuration is read by some sample: a
    spline with events, a norm whose cuts select events, an energy scale,
    or an oscillation parameter. The events are the configuration's own
    counts (a flux bin holds few); the splines are cut to eight, whose
    events a tiny size shows as well as the full."""
    from m3bench.reference.params import norm_matches, read
    from m3bench.run import _load

    for config in ("beam2det", "beam1det"):
        spec = json.loads((tiny.REPO / "m3bench" / "configs" / f"{config}.json").read_text())
        gen = _load(tiny.REPO / "m3bench" / "configs" / f"{config}.py", f"p_{config}")
        inputs = gen.build(dict(spec, n_numu=1500, n_nue=500, n_beam_generated=4000), 7)
        assert inputs.n_params == spec["n_params"]
        assert sum(s.n_bins for s in inputs.samples) == spec["n_bins"]
        inputs = gen.build(dict(spec, n_splines=8), 7)
        params = read(inputs.trees)
        read_by = {sp.param_index for s in inputs.samples for sp in s.splines}
        read_by |= {s.shift[0] for s in inputs.samples if s.shift} | set(inputs.osc_param_index)
        for s in inputs.samples:
            read_by |= {int(i) for i in norm_matches(params, s)[1]}
        assert read_by == set(range(inputs.n_params)), sorted(set(range(inputs.n_params)) - read_by)


# Faults planted in the program underneath a run ------------------------------

def _unchanged_mr2t2(monkeypatch):
    from mach3_tpu_torch.fitters import mcmc

    real = mcmc.make_step_fn_args

    def make(config, *a, **k):
        step = real(config, *a, **k)

        def faulty(model, state, **kw):
            new, out = step(model, state, **kw)
            out = dict(out, theta=state.theta, nll=state.nll)
            return mcmc.ChainState(theta=state.theta, nll=state.nll, generator=new.generator,
                                   step=new.step, n_accepted=new.n_accepted,
                                   adaptive=new.adaptive), out
        return faulty
    monkeypatch.setattr(mcmc, "make_step_fn_args", make)


def _unchanged_chees(monkeypatch):
    import dataclasses

    from mach3_tpu_torch.fitters import hmc

    real = hmc.HMC.epilogue

    def faulty(self, state, traj, u=None):
        new, out = real(self, state, traj, u=u)
        out = dict(out, theta=state.theta, logp=state.logp)
        return dataclasses.replace(new, theta=state.theta, logp=state.logp), out
    monkeypatch.setattr(hmc.HMC, "epilogue", faulty)


def _half_of_the_chains(monkeypatch):
    from mach3_tpu_torch.fitters import mcmc

    real = mcmc._update_adaptive

    def faulty(ad, theta, step, config, acc_prob, *a, **k):
        half = theta.shape[0] // 2
        return real(ad, theta[:half], step, config, acc_prob[:half], *a, **k)
    monkeypatch.setattr(mcmc, "_update_adaptive", faulty)


def _half_of_the_events(monkeypatch):
    from mach3_tpu_torch.samples.sample import SampleModel

    real = SampleModel._base_weight

    def faulty(self, thetas, grids, norm):
        w = real(self, thetas, grids, norm)
        half = w.shape[1] // 2
        return torch.cat([2.0 * w[:, :half], torch.zeros_like(w[:, half:])], 1)
    monkeypatch.setattr(SampleModel, "_base_weight", faulty)


def _altered_answer(monkeypatch):
    from mach3_tpu_torch.fitters.model import FitModel

    real_parts = FitModel.total_nll_batch_parts
    real_logp = FitModel.log_posterior_batch

    def parts(self, thetas, *a, **k):
        total, prior, sample = real_parts(self, thetas, *a, **k)
        return total + 0.5 * (torch.arange(len(total)) == 0), prior, sample

    def logp(self, thetas, *a, **k):
        return real_logp(self, thetas, *a, **k) + 0.5 * (torch.arange(len(thetas)) == 0)
    monkeypatch.setattr(FitModel, "total_nll_batch_parts", parts)
    monkeypatch.setattr(FitModel, "log_posterior_batch", logp)


FAULTS = {"tiny.mr2t2": [_unchanged_mr2t2, _half_of_the_chains, _half_of_the_events,
                         _altered_answer],
          "tiny.chees": [_unchanged_chees, _half_of_the_events, _altered_answer]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_planted_fault_is_not_correct(copy, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, res, err = tiny.run_cell(copy, cell)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(copy, cell):
    rc, res, err = tiny.run_cell(copy, cell, control=1)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]
