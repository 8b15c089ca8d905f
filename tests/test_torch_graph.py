"""MR2T2 and DelayedMR2T2 chunks as replayed CUDA graphs, on the card.

Every test here needs a CUDA device and nvcc (the samplers' default on the
card is the graph; it has no CPU mode) and skips without one. On the card
the toy's reweight kernel (K1) adds its histograms with float atomics in an
order that changes from run to run, so two runs of the same chains agree
to the NLL's last bits, not bit for bit: a chain whose accept test falls
within that of its threshold may decide differently, and the tests allow
one such chain. The generator's state must match exactly: a replay draws
what the eager step draws.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mach3_tpu_torch.fitters import mcmc
from mach3_tpu_torch.fitters.delayed import DelayedConfig, DelayedMR2T2
from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
from mach3_tpu_torch.kernels.launch import LAUNCHES
from mach3_tpu_torch.tutorial.toy import build_toy

N_CHAINS = 32
# Robbins-Monro off: its scale reads the acceptance probability, which would
# carry the atomics' last bits into every later proposal.
CONFIG = dict(chunk_size=10, adaptive=True, adaption_start_update=1, adaption_start_throw=5,
              adaption_update_step=5, robbins_monro=False)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture()
def toy(cuda_device):
    return build_toy(n_events=4000, seed=3, e_grid_size=40, device=cuda_device)


def _init(model, n_chains, seed=0):
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).cpu().numpy()
    lo, hi = flat.low_bound.cpu().numpy(), flat.up_bound.cpu().numpy()
    th = flat.prefit.cpu().numpy() + 0.05 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


def _agree(a: dict, b: dict, max_flipped: int = 1) -> int:
    """Chains whose accept decisions match at every step have bit-identical
    θ; at most ``max_flipped`` chains differ, each first where the two
    acceptance probabilities straddle its threshold by no more than the
    NLL's rounding allows. Returns the number of such chains."""
    flips = a["accepted"] != b["accepted"]
    diverged = flips.any(0)
    assert diverged.sum() <= max_flipped, diverged.sum()
    for c in np.flatnonzero(diverged):
        s = np.flatnonzero(flips[:, c])[0]
        assert abs(np.log(a["acc_prob"][s, c]) - np.log(b["acc_prob"][s, c])) < 1e-3
    np.testing.assert_array_equal(a["theta"][:, ~diverged], b["theta"][:, ~diverged])
    return int(diverged.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pooled", "per_chain", "delayed"])
def test_graph_matches_eager(toy, kind):
    """The graph's chunks against the eager loop from one generator state:
    same draws (the generators end in the same state), same decisions, θ
    and adaptive moments, across refresh steps and a last chunk shorter than
    the captured length."""
    init = _init(toy.model, N_CHAINS)
    if kind == "delayed":
        cfg = DelayedConfig(**CONFIG, max_rejections=1, decay_rate=0.3)
        make = DelayedMR2T2
    else:
        cfg = MCMCConfig(**CONFIG, adaption_mode=kind)
        make = MR2T2
    runs = {}
    for graph in (True, False):
        fit = make(toy.model, cfg, init, seed=5, graph=graph)
        runs[graph] = (fit, fit.run(n_steps=37))
    (fg, g), (fe, e) = runs[True], runs[False]
    assert fg._graph is not None and fe._graph is None
    assert torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state())
    assert int(fg.state.step) == int(fe.state.step) == 37
    assert g["theta"].shape == e["theta"].shape == (37, N_CHAINS, toy.model.n_params)
    if _agree(g, e) == 0:
        for f in ("mean", "cov", "chol"):
            assert torch.equal(getattr(fg.state.adaptive, f), getattr(fe.state.adaptive, f))
    if kind == "delayed":
        assert g["delayed_accept"].any()


def _snapshot(state):
    """A copy of a sampler state that no run touches."""
    gen = torch.Generator(device=state.theta.device)
    gen.set_state(state.generator.get_state())

    def clone(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).clone() for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})

    return dataclasses.replace(clone(state), generator=gen, adaptive=clone(state.adaptive))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pooled", "per_chain"])
def test_graph_step_matches_eager_with_robbins_monro(toy, mode):
    """Robbins-Monro on, as users run it: each graph step against one eager
    step from the graph's state before it, across the refreshes at steps 5
    and 10. The draws and θ of chains that decide alike are bit-identical;
    the log-scales differ by γ_t times the difference of the acceptance
    probabilities they read, plus rounding; where every chain decided alike
    so do the moments and the throw matrix."""
    init = _init(toy.model, N_CHAINS)
    cfg = MCMCConfig(**dict(CONFIG, robbins_monro=True), adaption_mode=mode)
    fg = MR2T2(toy.model, cfg, init, seed=6)
    fe = MR2T2(toy.model, cfg, init, seed=6, graph=False)
    flipped = 0
    for t in range(1, 13):
        fe.state = _snapshot(fg.state)
        g, e = fg.run(n_steps=1), fe.run(n_steps=1)
        assert torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state())
        flips = g["accepted"][0] != e["accepted"][0]
        flipped += int(flips.sum())
        assert flipped <= 1
        if flips.any():
            gap = np.abs(np.log(g["acc_prob"][0, flips]) - np.log(e["acc_prob"][0, flips]))
            assert gap.max() < 1e-3
        np.testing.assert_array_equal(g["theta"][0, ~flips], e["theta"][0, ~flips])
        if mode == "per_chain":
            d_acc = np.abs(g["acc_prob"][0] - e["acc_prob"][0])
        else:
            d_acc = abs(g["acc_prob"][0].mean() - e["acc_prob"][0].mean())
        d_scale = (fg.state.adaptive.log_scale - fe.state.adaptive.log_scale).abs().cpu().numpy()
        assert np.all(d_scale <= 2.0 / t**0.66 * d_acc + 1e-14), (t, d_scale, d_acc)
        if not flips.any():
            for f in ("mean", "cov", "chol"):
                assert torch.equal(getattr(fg.state.adaptive, f), getattr(fe.state.adaptive, f))


@pytest.mark.cuda
def test_graph_launches_count_replays(toy):
    """Each replay adds the launches its capture saw: two K1 launches per
    MR2T2 step, four per delayed step with one retry; the capture itself
    counts none."""
    init = _init(toy.model, N_CHAINS)
    for make, cfg, per_step in (
            (MR2T2, MCMCConfig(**CONFIG), 2),
            (DelayedMR2T2, DelayedConfig(**CONFIG, max_rejections=1), 4)):
        fit = make(toy.model, cfg, init, seed=1)
        before = LAUNCHES["reweight_shifted"]
        fit.run(n_steps=10, collect=False)
        # The warm-up before the capture is one real step.
        assert LAUNCHES["reweight_shifted"] - before == 11 * per_step
        assert fit._graph.launches == {"reweight_shifted": per_step}
        before = LAUNCHES["reweight_shifted"]
        fit.run(n_steps=25, collect=False)
        torch.cuda.synchronize()
        assert LAUNCHES["reweight_shifted"] - before == 25 * per_step


@pytest.mark.cuda
def test_graph_refuses_a_swapped_model(toy, cuda_device):
    init = _init(toy.model, 8)
    fit = MR2T2(toy.model, MCMCConfig(chunk_size=5), init, seed=2)
    fit.run(n_steps=5, collect=False)
    other = build_toy(n_events=4000, seed=3, e_grid_size=40, device=cuda_device).model
    fit.model = other
    with pytest.raises(ValueError, match="captured"):
        fit.run(n_steps=5, collect=False)
    fit.model = toy.model
    fit.run(n_steps=5, collect=False)
    assert int(fit.state.step) == 10


@pytest.mark.cuda
def test_graph_resumes_a_replaced_state(toy):
    """A state set from outside (a checkpoint, another fitter's) is copied
    into the graph's static tensors and the chains go on from it."""
    init = _init(toy.model, 8)
    cfg = MCMCConfig(**CONFIG)
    a = MR2T2(toy.model, cfg, init, seed=4)
    a.run(n_steps=10, collect=False)
    b = MR2T2(toy.model, cfg, init, seed=9)
    b.run(n_steps=3, collect=False)
    snap = dataclasses.replace(a.state, generator=torch.Generator(device=a.state.theta.device))
    snap.generator.set_state(a.state.generator.get_state())
    snap = dataclasses.replace(snap, **{f: getattr(a.state, f).clone()
                                        for f in ("theta", "nll", "step", "n_accepted")})
    b.state = snap
    out_b = b.run(n_steps=10)
    out_a = a.run(n_steps=10)
    assert int(b.state.step) == 20 and b.state is b._graph.state
    _agree(out_a, out_b)


@pytest.mark.cuda
def test_capture_with_a_host_sync_raises(toy):
    """A step that reads a device value on the host cannot be captured: the
    runner raises instead of falling back to the eager loop."""
    inner = mcmc.make_step_fn_args(MCMCConfig())

    def syncing_step(model, state, **kw):
        float(state.nll.sum())
        return inner(model, state, **kw)

    fit = MR2T2(toy.model, MCMCConfig(chunk_size=5), _init(toy.model, 8), seed=2)
    fit._step = syncing_step
    with pytest.raises(RuntimeError, match="graph=False"):
        fit.run(n_steps=5, collect=False)
