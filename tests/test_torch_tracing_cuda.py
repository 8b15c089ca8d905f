"""The program's tracing on the card (``core/tracing.py``): device stamps
captured as event-record nodes of the samplers' CUDA graphs, the layers'
device ms they give, and the host's spans and read counts.

Every test here needs a CUDA device and nvcc and skips without one. The
toy's reweight kernel (K1) adds its histograms with float atomics in an
order that changes from run to run, so a graph step and an eager step from
one state agree on the NLL to its last bits, not bit for bit: θ, the
decisions, the draws and the launches are compared exactly, with one chain
allowed to decide otherwise where its two acceptance probabilities
straddle its threshold (``tests/test_torch_graph.py``'s rule).
"""
import dataclasses

import numpy as np
import pytest
import torch

from mach3_tpu_torch.core import tracing
from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig
from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
from mach3_tpu_torch.kernels.launch import LAUNCHES
from mach3_tpu_torch.tutorial.toy import build_toy

N_CHAINS = 32
CONFIG = dict(chunk_size=10, adaptive=True, adaption_start_update=1, adaption_start_throw=5,
              adaption_update_step=5, robbins_monro=False)
#: The layers an MR2T2 step of the toy stamps (two samples, one oscillation
#: signature), in stream order.
MR2T2_LAYERS = ["start", "propose", "prior", "osc", "base", "reweight", "stat", "base",
                "reweight", "stat", "accept", "adapt", "write"]
CHEES = HMCConfig(step_size=0.02, chunk_size=4, adapt_steps=6, mass_start_update=0,
                  mass_update_every=2, adapt_trajectory=True, max_leapfrog=6,
                  initial_traj_length=0.06)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture()
def toy(cuda_device):
    return build_toy(n_events=4000, seed=3, e_grid_size=40, device=cuda_device)


@pytest.fixture()
def traced():
    tracing.enable()
    yield
    tracing.enable(False)


def _init(model, n_chains, seed=0):
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).cpu().numpy()
    lo, hi = flat.low_bound.cpu().numpy(), flat.up_bound.cpu().numpy()
    th = flat.prefit.cpu().numpy() + 0.05 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


def _snapshot(state):
    gen = torch.Generator(device=state.theta.device)
    gen.set_state(state.generator.get_state())

    def clone(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).clone() for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})

    return dataclasses.replace(clone(state), generator=gen, adaptive=clone(state.adaptive))


@pytest.mark.cuda
def test_stamped_graph_step_equals_an_unstamped_eager_step(toy):
    """Each step of the stamped graph (tracing off: the stamps are captured
    always) against one eager step from its state with no stamp taken:
    the same θ, decisions and draws, and the same kernel launches."""
    init = _init(toy.model, N_CHAINS)
    fg = MR2T2(toy.model, MCMCConfig(**CONFIG), init, seed=5)
    fe = MR2T2(toy.model, MCMCConfig(**CONFIG), init, seed=5, graph=False)
    fg.run(n_steps=1)
    assert [layer for layer, _ in fg._graph.stamps.marks] == MR2T2_LAYERS + ["end"]
    flipped = 0
    for _ in range(12):
        fe.state = _snapshot(fg.state)
        before = dict(LAUNCHES)
        g = fg.run(n_steps=1)
        on_graph = {k: LAUNCHES[k] - before[k] for k in before}
        before = dict(LAUNCHES)
        e = fe.run(n_steps=1)
        assert fe._eager_stamps is None
        assert on_graph == {k: LAUNCHES[k] - before[k] for k in before}
        assert torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state())
        flips = g["accepted"][0] != e["accepted"][0]
        flipped += int(flips.sum())
        if flips.any():
            gap = np.abs(np.log(g["acc_prob"][0, flips]) - np.log(e["acc_prob"][0, flips]))
            assert gap.max() < 1e-3
        np.testing.assert_array_equal(g["theta"][0, ~flips], e["theta"][0, ~flips])
        np.testing.assert_allclose(g["nll"][0, ~flips], e["nll"][0, ~flips], rtol=0, atol=1e-4)
    assert flipped <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [True, False])
def test_layer_ms_are_positive_and_sum_to_the_step(toy, traced, graph):
    """The layers' device ms of a chunk's last step, from the graph's
    captured stamps or from the eager step's: each named layer took time,
    and together they are the time from the first stamp to the last."""
    fit = MR2T2(toy.model, MCMCConfig(**CONFIG), _init(toy.model, N_CHAINS), seed=1,
                graph=graph)
    fit.run(n_steps=15)
    record = tracing.last_chunk()
    assert record.steps == 5
    (name, layers), = record.layers.items()
    assert name == "mr2t2.step"
    # The eager step has no copy into a graph's static state ("write").
    want = MR2T2_LAYERS if graph else MR2T2_LAYERS[:-1]
    assert list(layers) == list(dict.fromkeys(want))
    assert all(v > 0 for k, v in layers.items() if k != "start"), layers
    marks = (fit._graph.stamps if graph else fit._eager_stamps).marks
    whole = marks[0][1].elapsed_time(marks[-1][1])
    assert sum(layers.values()) == pytest.approx(whole, rel=1e-4, abs=2e-3)
    if graph:
        assert record.spans["runner.replay.mr2t2.step"] > 0
        assert record.counts["program"]["graph_replays"] == 5


@pytest.mark.cuda
def test_chees_reads_its_length_once_a_step(toy, traced):
    """A dynamic ChEES step reads its length on the host once (the span
    ``hmc.length_read``, one host read of 8 bytes); a run reads its step
    counter once more; the three graphs' stamps give the backward pass's
    device ms of the last iteration."""
    fit = HMC(toy.model, CHEES, _init(toy.model, 8), seed=2)
    fit.run(n_steps=4, collect=False)  # captures
    reads0 = dict(tracing.PROGRAM)
    n_spans = tracing.totals()["hmc.length_read"].count
    fit.run(n_steps=8, collect=False)
    torch.cuda.synchronize()
    assert tracing.totals()["hmc.length_read"].count - n_spans == 8
    assert tracing.PROGRAM["host_reads"] - reads0["host_reads"] == 1 + 8
    assert tracing.PROGRAM["host_read_bytes"] - reads0["host_read_bytes"] == 4 + 8 * 8
    out = fit.run(n_steps=4)
    record = tracing.last_chunk()
    assert set(record.layers) == {"hmc.prologue", "hmc.iteration", "hmc.epilogue"}
    it = record.layers["hmc.iteration"]
    assert it["backward"] > 0 and it["forward"] >= 0 and it["leapfrog"] > 0
    # The lengths, the step counter, the outputs' copies (not step_time).
    assert record.counts["program"]["host_reads"] == 4 + 1 + len(out) - 1
