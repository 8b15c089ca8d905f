"""The program's tracing (``mach3_tpu_torch/core/tracing.py``) on the CPU:
spans and their parents and chunk ids in the eager loop, the counter
registry and the capture's replay accounting (none of the program's own
counts), the layered oscillation's stamp after every
constant-density grid, chains that tracing leaves
bit for bit as they were, no ``record_function`` and no host read while it
is off, and the model build's set-up spans (``--profile``'s ``spans.json``
is ``test_torch_cli.py``'s).
The device stamps are the card's (``test_torch_tracing_cuda.py``); on the
CPU a stamp records nothing."""
import numpy as np
import pytest
import torch

from mach3_tpu_torch.core import tracing
from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig
from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
from mach3_tpu_torch.kernels.launch import LAUNCHES
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

MCMC = MCMCConfig(chunk_size=5, adaptive=True, adaption_start_update=2, adaption_start_throw=4,
                  adaption_update_step=3)
CHEES = HMCConfig(step_size=0.02, chunk_size=3, adapt_steps=4, adapt_trajectory=True,
                  max_leapfrog=4, initial_traj_length=0.06)


@pytest.fixture(scope="module")
def toy():
    return build_toy(n_events=1500, seed=5, e_grid_size=20, device="cpu")


@pytest.fixture()
def traced():
    tracing.enable()
    yield
    tracing.enable(False)


def _init(model, n_chains=4):
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).numpy()
    th = flat.prefit.numpy() + 0.05 * sig * np.random.default_rng(1).normal(
        size=(n_chains, len(sig)))
    lo, hi = flat.low_bound.numpy(), flat.up_bound.numpy()
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


def test_spans_nest_under_their_chunk(toy, traced):
    """Each chunk is a ``runner.chunk`` span; the refresh, the copy and the
    callback open inside it and carry its id; the chunk's record holds its
    steps and its spans' seconds."""
    n0 = len(tracing.chunks())
    fit = MR2T2(toy.model, MCMC, _init(toy.model), seed=3)
    fit.run(n_steps=12, callback=lambda done, state, host: None)
    records = tracing.chunks()[n0:]
    assert [r.steps for r in records] == [5, 5, 2]
    ids = [r.index for r in records]
    assert ids == list(range(ids[0], ids[0] + 3))
    spans = [s for s in tracing.recent() if s[4] in ids]
    for name, start, end, parent, chunk in spans:
        assert end >= start
        assert parent == (None if name == "runner.chunk" else "runner.chunk"), name
    by_chunk = {i: [s[0] for s in spans if s[4] == i] for i in ids}
    for i in ids:
        assert by_chunk[i][-1] == "runner.chunk"
        assert {"runner.collect", "runner.callback"} <= set(by_chunk[i])
    # Refreshes at steps 4, 7 and 10: in the first and second chunks.
    assert [by_chunk[i].count("runner.refresh") for i in ids] == [1, 2, 0]
    for r in records:
        assert set(r.spans) >= {"runner.chunk", "runner.collect", "runner.callback"}
        assert r.spans["runner.chunk"] >= r.spans["runner.collect"]
        assert r.layers == {}  # no stamp on the CPU


def test_capture_counts_are_replayed():
    """What every registry entry counts during a capture is taken back out
    and added again by each replay; the program's own counts are not."""
    entry = tracing.counters("test.entry", ("a",))
    before = dict(LAUNCHES)
    reads = tracing.PROGRAM.get("host_reads", 0)
    seen = tracing.CaptureCounts()
    entry["a"] += 2
    LAUNCHES["reweight_shifted"] += 1
    tracing.count("host_reads")
    seen.close()
    assert entry["a"] == 0 and dict(LAUNCHES) == before
    assert tracing.PROGRAM["host_reads"] == reads + 1
    assert seen.of(entry) == {"a": 2} and seen.of(LAUNCHES) == {"reweight_shifted": 1}
    for _ in range(3):
        seen.replay()
    assert entry["a"] == 6 and LAUNCHES["reweight_shifted"] == before[
        "reweight_shifted"] + 3
    assert seen.of(tracing.PROGRAM) == {}


def test_layered_grids_follow_the_constant_density_ones(monkeypatch):
    """The stamp ``osc_layered`` falls between the last constant-density
    grid and the first layered one, whatever the samples' order; a model
    without a layered grid takes no such stamp."""
    from mach3_tpu_torch.fitters.model import FitModel
    from mach3_tpu_torch.samples.sample import AtmoOscConfig, OscConfig
    from mach3_tpu_torch.tutorial.large import build_large

    model = build_large(n_numu=600, n_nue=300, n_atmo=600, e_grid_size=10, atmo_e_grid_size=6,
                        atmo_cosz_grid_size=6, asimov=False, device="cpu").model
    marks = []
    monkeypatch.setattr(tracing, "stamp", marks.append)
    for cls, name in ((OscConfig, "beam"), (AtmoOscConfig, "layered")):
        def grids(self, thetas, real=cls.prob_grids, name=name):
            marks.append(name)
            return real(self, thetas)
        monkeypatch.setattr(cls, "prob_grids", grids)
    th = model.prefit_vector()[None]
    samples = list(model.samples)  # numu_beam, nue_beam (one beam grid), atmo
    for order, want in ((samples, ["osc", "beam", "osc_layered", "layered"]),
                        (samples[::-1], ["osc", "beam", "osc_layered", "layered"]),
                        (samples[:2], ["osc", "beam"])):
        marks.clear()
        FitModel(model.priors, order, model.slices, model.flat)._shared_osc_tables(th)
        assert marks == want


def test_registry_holds_the_launches_and_a_samplers_evaluations(toy):
    fit = HMC(toy.model, CHEES, _init(toy.model), seed=1, graph=False)
    names = tracing.snapshot()
    assert names["launches"] == dict(LAUNCHES)
    assert any(n.startswith("hmc.evals") and v == {"logp": 1, "grad": 0}
               for n, v in names.items())
    assert isinstance(LAUNCHES, dict) and fit.n_logp_evals == 1


@pytest.mark.parametrize("kind", ["mr2t2", "chees"])
def test_tracing_leaves_the_chains_bit_for_bit(toy, kind):
    """One seed with tracing off and on: the same draws, the same state."""
    runs = []
    for on in (False, True):
        tracing.enable(on)
        try:
            if kind == "mr2t2":
                fit = MR2T2(toy.model, MCMC, _init(toy.model), seed=7)
            else:
                fit = HMC(toy.model, CHEES, _init(toy.model), seed=7)
            runs.append((fit, fit.run(n_steps=8)))
        finally:
            tracing.enable(False)
    (a, oa), (b, ob) = runs
    assert oa.keys() == ob.keys()
    for k in oa:
        if k != "step_time":
            np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
    assert torch.equal(a.state.generator.get_state(), b.state.generator.get_state())
    assert torch.equal(a.state.theta, b.state.theta)


def test_off_calls_no_record_function_and_reads_nothing_more(toy, monkeypatch):
    """Tracing off under no profiler: no ``record_function``, and the host
    reads of a run are the same as with tracing on."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    fit = HMC(toy.model, CHEES, _init(toy.model), seed=2)
    reads = []
    for on in (False, True):
        tracing.enable(on)
        try:
            before = dict(tracing.PROGRAM)
            fit.run(n_steps=6, callback=lambda *a: None)
            reads.append({k: v - before.get(k, 0) for k, v in tracing.PROGRAM.items()})
        finally:
            tracing.enable(False)
        if not on:
            assert calls == []
    assert reads[0] == reads[1]
    assert calls == []  # on, but no profiler records: spans without record_function
    from torch.profiler import profile

    with profile():
        fit.run(n_steps=3, collect=False)
    assert "runner.chunk" in calls and "hmc.length_read" in calls
    assert tracing.poll() is False  # the profiler has stopped


def test_stamp_outside_a_capture_records_nothing():
    tracing.stamp("prior")  # no collector: a no-op
    assert tracing._STATE.stamps is None


def test_model_build_spans_are_kept_with_tracing_off():
    """The model build's set-up spans are kept always; the outermost of a
    family counts once."""
    before = tracing.totals()
    build_toy(n_events=600, seed=2, e_grid_size=10, device="cpu")
    after = tracing.totals()
    grew = {n: after[n].count - (before[n].count if n in before else 0) for n in after}
    assert grew["build.table"] == 2 and grew["build.sample"] == 2 and grew["build.osc"] >= 1
    assert tracing.setup_seconds("build.") == pytest.approx(
        sum(t.outer_seconds for n, t in after.items() if n.startswith("build.")))
    inner = tracing.setup_span("build.inner")(lambda: None)
    tracing.setup_span("build.outer")(inner)()
    t = tracing.totals()
    assert t["build.inner"].outer_seconds == 0 < t["build.inner"].seconds
    assert t["build.outer"].outer_seconds == t["build.outer"].seconds
    assert tracing.setup_seconds("nothing.") is None
