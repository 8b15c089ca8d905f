"""``mach3-mcmc-torch`` (``mach3_tpu_torch/cli/mcmc.py``) on the CPU: the YAML
experiment of ``tutorial/experiment_files.py`` at 3,000 events with 4
chains, held in RAM and streamed, a kill and a resume that reproduce an
uninterrupted run bit for bit, and chain files the JAX package reads."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mach3_tpu.diagnostics.chain_io import load_chain as jload_chain
from mach3_tpu_torch.cli import mcmc as cli_mcmc
from mach3_tpu_torch.core import tracing
from mach3_tpu_torch.core.exceptions import ConfigError
from mach3_tpu_torch.diagnostics.chain_io import load_chain
from mach3_tpu_torch.tutorial.experiment_files import write_experiment

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ADAPTIVE = ["AdaptionOptions:Settings:StartUpdate:5", "AdaptionOptions:Settings:StartThrow:20",
            "AdaptionOptions:Settings:UpdateStep:10"]


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    return str(write_experiment(tmp_path_factory.mktemp("exp"), n_events=3000, seed=7))


def _argv(experiment, steps, autosave, extra=(), overrides=()):
    return [experiment, f"General:MCMC:NSteps:{steps}", "General:MCMC:NChains:4",
            f"General:MCMC:AutoSave:{autosave}", *ADAPTIVE, *overrides, "--device", "cpu",
            "--seed", "5", *extra]


def test_hold_in_ram_chain_read_by_both_packages(experiment, tmp_path):
    out = str(tmp_path / "chain.npz")
    assert cli_mcmc.main(_argv(experiment, 60, 20, ["--stream", "off", "-o", out])) == 0
    assert os.path.exists(out + ".ckpt") and not os.path.isdir(out + ".d")
    draws, meta, _ = load_chain(out)
    jdraws, jmeta, _ = jload_chain(out)
    assert draws["theta"].shape == jdraws["theta"].shape == (60, 4, 19)
    np.testing.assert_array_equal(draws["theta"], jdraws["theta"])
    assert meta["names"] == jmeta["names"] and len(meta["names"]) == 19
    assert "Experiment" in meta["config"] and len(meta["prefit"]) == 19
    assert np.isfinite(draws["nll"]).all() and draws["accepted"].any()
    assert draws["step_time"].shape == (60,)


def test_streaming_mode(experiment, tmp_path):
    out = str(tmp_path / "stream.npz")
    assert cli_mcmc.main(_argv(experiment, 60, 20, ["--stream", "on", "-o", out])) == 0
    parts = sorted(p for p in os.listdir(out + ".d") if p.startswith("part-"))
    assert parts == ["part-00000.npz", "part-00001.npz", "part-00002.npz"]
    draws, meta, _ = load_chain(out)
    assert draws["theta"].shape[0] == 60 and meta["n_steps"] == 60
    assert jload_chain(out)[0]["theta"].shape == (60, 4, 19)
    # auto: a threshold below the chain's size streams too
    auto = str(tmp_path / "auto.npz")
    assert cli_mcmc.main(_argv(experiment, 40, 20, ["-o", auto],
                               overrides=["General:MCMC:StreamThresholdMB:0.001"])) == 0
    assert os.path.isdir(auto + ".d")


def test_kill_and_resume_is_bit_identical(experiment, tmp_path):
    """SIGKILL a fit between autosaves, resume from its checkpoint: the
    whole chain equals an uninterrupted run's with the same seed."""
    out_b = str(tmp_path / "b.npz")
    cmd = [sys.executable, "-m", "mach3_tpu_torch.cli.mcmc",
           *_argv(experiment, 100000, 20, ["--stream", "off", "-o", out_b])]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    t0 = time.time()
    try:
        while time.time() - t0 < 300:
            if os.path.exists(out_b + ".ckpt"):
                break
            assert proc.poll() is None, "the fit exited before any autosave"
            time.sleep(0.1)
    finally:
        proc.kill()
        proc.wait()
    assert os.path.exists(out_b + ".ckpt"), "no autosave within the window"
    s_done = load_chain(out_b)[0]["theta"].shape[0]
    assert s_done >= 20 and s_done % 20 == 0
    total = s_done + 40
    assert cli_mcmc.main(_argv(experiment, total, 20,
                               ["--stream", "off", "-o", out_b, "--checkpoint", out_b + ".ckpt"])) == 0
    out_a = str(tmp_path / "a.npz")
    assert cli_mcmc.main(_argv(experiment, total, 20, ["--stream", "off", "-o", out_a])) == 0
    a, b = load_chain(out_a)[0], load_chain(out_b)[0]
    assert a["theta"].shape == b["theta"].shape == (total, 4, 19)
    for k in ("theta", "nll", "accepted"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a resume of the finished fit has nothing left to run
    assert cli_mcmc.main(_argv(experiment, total, 20,
                               ["-o", out_b, "--checkpoint", out_b + ".ckpt"])) == 0


def test_toy_delayed_and_the_algorithms_not_ported(tmp_path):
    out = str(tmp_path / "toy.npz")
    assert cli_mcmc.main(["General:MCMC:NSteps:20", "General:MCMC:NChains:3",
                          "General:MCMC:AutoSave:10", "General:FittingAlgorithm:DelayedMR2T2",
                          "Toy:NEvents:800", "--device", "cpu", "-o", out]) == 0
    draws, meta, _ = load_chain(out)
    assert draws["theta"].shape == (20, 3, 16) and "delayed_accept" in draws
    assert meta["names"][0].startswith("xsec_")
    with pytest.raises(ConfigError, match="not a sampler"):
        cli_mcmc.main(["General:FittingAlgorithm:PSO", "Toy:NEvents:800", "--device", "cpu",
                       "-o", str(tmp_path / "p.npz")])
    assert cli_mcmc.main(["--experiment", "nope", "--device", "cpu"]) == 2


def test_profile_writes_a_trace(experiment, tmp_path):
    """``--profile DIR``: the profiler's trace of the second chunk, with the
    program's spans in it, and the program's own spans, counters and chunk
    records (``core/tracing.py``) in ``spans.json``."""
    out, prof = str(tmp_path / "c.npz"), str(tmp_path / "prof")
    # spans.json holds the process's span totals: count this run's chunks
    # from what earlier tests in the process left.
    chunks_before = tracing.totals().get("runner.chunk")
    chunks_before = 0 if chunks_before is None else chunks_before.count
    assert cli_mcmc.main(_argv(experiment, 30, 10, ["-o", out, "--profile", prof])) == 0
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    assert load_chain(out)[0]["theta"].shape[0] == 30
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"runner.chunk", "runner.collect", "runner.callback"} <= names
    with open(os.path.join(prof, "spans.json")) as f:
        spans = json.load(f)
    assert set(spans) == {"spans", "counters", "chunks"}
    assert spans["spans"]["runner.chunk"]["count"] - chunks_before == 3
    assert "build.sample" in spans["spans"] and "launches" in spans["counters"]
    assert [c["steps"] for c in spans["chunks"][-3:]] == [10, 10, 10]
    assert not tracing.is_on()
