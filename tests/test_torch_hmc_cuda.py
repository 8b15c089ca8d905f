"""HMC, MALA and ChEES-HMC chunks as replayed CUDA graphs, on the card.

Every test here needs a CUDA device and nvcc and skips without one. Each
gradient evaluation runs K1 forward (float atomics into the histograms),
the backward kernel and the gathers' backward kernel, so a graph step and
an eager step from the same state agree to the likelihood's last bits,
not bit for bit. The tests shadow each graph step
with one eager step from the graph's state before it: the draws (the
generators' states) must match exactly; a chain may decide differently
only where its two log α differ by at most NEAR_TIE; θ of the others
within THETA_TOL prior widths, and the step size and trajectory time within
ADAPT_TOL. K1's atomic order moves a toy NLL by ~1e-5 (``chip_smoke.py``),
and with it each log α, the mean acceptance probability that dual
averaging reads (log ε moves by √t / 0.05 x that / (t + 10), below 1e-4)
and the gradient's last bits, which a few leapfrog steps carry into θ at
~1e-6 prior widths.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig, SegmentedStep
from mach3_tpu_torch.fitters.mcmc import GraphChunk
from mach3_tpu_torch.kernels.launch import LAUNCHES
from mach3_tpu_torch.tutorial.toy import build_toy

N_CHAINS = 32
NEAR_TIE = 1e-3
THETA_TOL = 1e-4  # x each parameter's prior width
ADAPT_TOL = 1e-4
BASE = dict(step_size=0.02, chunk_size=4, adapt_steps=6, mass_start_update=0,
            mass_update_every=2)
MODES = {
    "jittered": dict(n_leapfrog=4, jitter_trajectory=True),
    "mala": dict(n_leapfrog=1, jitter_trajectory=False, target_accept=0.574),
    "chees": dict(adapt_trajectory=True, max_leapfrog=6, initial_traj_length=0.06),
    "chees_static": dict(adapt_trajectory=True, max_leapfrog=6, initial_traj_length=0.06,
                         chees_static_bound=True),
}
# The toy's two samples: a forward and a backward kernel each, and the
# backwards of each sample's two gathers (its norm product and its
# oscillation weights).
PER_EVAL = {"reweight_shifted": 2, "reweight_backward": 2, "gather_backward": 4}


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
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo)), sig


def _snapshot(state):
    gen = torch.Generator(device=state.theta.device)
    gen.set_state(state.generator.get_state())
    return dataclasses.replace(state, generator=gen, **{
        f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_graph_step_matches_eager(toy, mode):
    """12 graph steps (three chunks, a mass refresh, the end of adaptation
    at step 6), each shadowed by an eager step from the graph's state."""
    init, sig = _init(toy.model, N_CHAINS)
    cfg = HMCConfig(**BASE, **MODES[mode])
    fg = HMC(toy.model, cfg, init, seed=6)
    fe = HMC(toy.model, cfg, init, seed=6, graph=False)
    flipped = 0
    for t in range(1, 13):
        fe.state = _snapshot(fg.state)
        g, e = fg.run(n_steps=1), fe.run(n_steps=1)
        assert int(fg.state.step) == int(fe.state.step) == t
        assert torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state())
        np.testing.assert_array_equal(g["n_leapfrog"], e["n_leapfrog"])
        flips = g["accepted"][0] != e["accepted"][0]
        flipped += int(flips.sum())
        if flips.any():
            gap = np.abs(np.log(g["accept_prob"][0, flips]) - np.log(e["accept_prob"][0, flips]))
            assert gap.max() <= NEAR_TIE, (t, gap)
        d_theta = np.abs(g["theta"][0, ~flips] - e["theta"][0, ~flips]) / sig
        assert d_theta.max() <= THETA_TOL, (t, d_theta.max())
        for f in ("log_eps", "log_eps_bar", "log_traj", "log_traj_bar"):
            d = abs(float(getattr(fg.state, f)) - float(getattr(fe.state, f)))
            assert d <= ADAPT_TOL, (t, f, d)
    assert flipped <= 1
    assert isinstance(fg._graph, SegmentedStep if mode == "chees" else GraphChunk)
    assert fe._graph is None
    assert int(fg.state.n_accepted.sum()) > 0


def _host_reads(fit, n_steps):
    """Reads of a device value on the host (``aten::_local_scalar_dense``)
    during a run of ``n_steps`` that keeps no draws."""
    from torch.profiler import profile

    with profile() as prof:
        fit.run(n_steps=n_steps, collect=False)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key == "aten::_local_scalar_dense")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_graph_launches_evaluations_and_reads(toy, mode):
    """Each replay adds the kernel launches and the evaluations its capture
    saw (the warm-up before a capture is one real call); a run reads the
    step counter once, and a dynamic ChEES step its length once more."""
    init, _ = _init(toy.model, 8)
    cfg = HMCConfig(**BASE, **MODES[mode])
    fit = HMC(toy.model, cfg, init, seed=1)
    launches0 = dict(LAUNCHES)
    fit.run(n_steps=5, collect=False)
    n_grad = fit.n_grad_evals
    assert {k: LAUNCHES[k] - launches0[k] for k in PER_EVAL} == {
        k: v * n_grad for k, v in PER_EVAL.items()}
    iters = fit._iterations
    if mode == "chees":
        assert fit._graph.launches == PER_EVAL  # one iteration's
    else:
        assert n_grad == 6 * iters
        assert fit._graph.launches == {k: v * iters for k, v in PER_EVAL.items()}
    launches0, grads0 = dict(LAUNCHES), fit.n_grad_evals
    out = fit.run(n_steps=8)
    torch.cuda.synchronize()
    n_grad = fit.n_grad_evals - grads0
    assert n_grad == ((out["n_leapfrog"][:, 0] + 1).sum() if mode == "chees" else 8 * iters)
    assert {k: LAUNCHES[k] - launches0[k] for k in PER_EVAL} == {
        k: v * n_grad for k, v in PER_EVAL.items()}
    assert _host_reads(fit, 8) == 1 + (8 if mode == "chees" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True])
def test_capture_with_a_host_read_raises(toy, segmented):
    """A step that reads a device value on the host cannot be captured: the
    runner raises instead of falling back to the eager loop."""
    init, _ = _init(toy.model, 8)
    fit = HMC(toy.model, HMCConfig(**BASE, **MODES["chees" if segmented else "jittered"]),
              init, seed=2)
    inner = fit.iterate

    def reading_iterate(state, traj):
        float(traj.theta.sum())
        return inner(state, traj)

    fit.iterate = reading_iterate
    with pytest.raises(RuntimeError, match="graph=False"):
        fit.run(n_steps=2, collect=False)
    # The failed capture left no generator marked as capturing.
    torch.randn(4, device=toy.model.flat.prefit.device)
    torch.randn(4, generator=fit.state.generator, device=fit.state.theta.device)
