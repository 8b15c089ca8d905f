"""Parallel tempering, the ensemble sampler and PSO as replayed CUDA graphs
against their eager loops, on the card.

Every test here needs a CUDA device and nvcc (the fitters' default on the
card is the graph, which has no CPU mode) and skips without one. The toy's
reweight kernel (K1) adds its histograms with float atomics in an order that
changes from run to run, so an NLL's last bits differ between two runs of
the same chains and a decision that close to its threshold may differ: the
tests allow one such walker. The generators' states must match exactly: a
replay draws what the eager step draws.
"""
import numpy as np
import pytest
import torch

from mach3_tpu_torch.fitters.ensemble import EnsembleConfig, EnsembleSampler
from mach3_tpu_torch.fitters.pso import PSOConfig, run_pso
from mach3_tpu_torch.fitters.tempering import ParallelTempering, PTConfig
from mach3_tpu_torch.kernels.launch import LAUNCHES
from mach3_tpu_torch.tutorial.toy import build_octant_toy, build_toy


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _start(model, n, frac=0.05):
    flat = model.flat
    chol = flat.chol.cpu().numpy()
    w = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = flat.low_bound.cpu().numpy(), flat.up_bound.cpu().numpy()
    th = flat.prefit.cpu().numpy() + frac * w * np.random.default_rng(0).normal(
        size=(n, len(w)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


@pytest.mark.cuda
@pytest.mark.parametrize("beta_zero", [False, True], ids=["geometric", "beta-zero"])
def test_pt_graph_matches_eager(cuda_device, beta_zero):
    """PT chunks against the eager loop from one state, Robbins-Monro held
    (its scales read the acceptance probabilities, which carry the atomics'
    order): the generators end alike; θ of every walker column (one walker
    at every level: swaps mix a column) whose decisions all agree is
    bit-identical; at most one column decides differently. The graph's run
    launches K1 twice more (the capture's warm-up step)."""
    model = build_octant_toy(n_events=4000, e_grid_size=40, device=cuda_device).model
    n_w, n_t, n_s = 16, 4, 25
    init = _start(model, n_w)
    cfg = PTConfig(n_temps=n_t, max_temp=16.0, chunk_size=10, beta_zero=beta_zero,
                   robbins_monro=False)
    runs = {}
    for graph in (True, False):
        fit = ParallelTempering(model, cfg, init, seed=4, graph=graph)
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        runs[graph] = (fit, fit.run(n_steps=n_s), dict(LAUNCHES))
    (fg, g, lg), (fe, e, le) = runs[True], runs[False]
    assert fg._graph is not None and fe._graph is None
    assert le["reweight_shifted"] == 2 * n_s and lg["reweight_shifted"] == 2 * (n_s + 1)
    assert torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state())
    flips = g["accepted"] != e["accepted"]
    bad = flips.reshape(n_s, n_t, n_w).any((0, 1))
    assert bad.sum() <= 1
    keep = ~np.tile(bad, n_t)
    assert np.array_equal(g["theta"][:, keep], e["theta"][:, keep])
    if not bad.any():
        assert torch.equal(fg.state.swap_accepts, fe.state.swap_accepts)
        assert torch.equal(fg.state.swap_attempts, fe.state.swap_attempts)
    np.testing.assert_allclose(g["nll"][:, keep], e["nll"][:, keep], rtol=1e-6, atol=1e-3)


@pytest.mark.cuda
def test_pt_graph_state_nll_is_its_theta(cuda_device):
    """After graphed chunks with Robbins-Monro on, each chain's prior and
    sample NLLs are those of its θ evaluated anew (within the atomics'
    order), and the counters moved."""
    model = build_toy(n_events=4000, seed=3, e_grid_size=40, device=cuda_device).model
    pt = ParallelTempering(model, PTConfig(n_temps=3, max_temp=9.0, chunk_size=20),
                           _start(model, 8), seed=1)
    pt.run(n_steps=60)
    total = model.total_nll_batch(pt.state.theta)
    torch.testing.assert_close(pt.state.prior_nll + pt.state.sample_nll, total, rtol=0,
                               atol=1e-3)
    assert int(pt.state.step) == 60 and int(pt.state.swap_attempts.sum()) == 60
    assert not torch.equal(pt.state.log_scale, torch.zeros_like(pt.state.log_scale))


@pytest.mark.cuda
def test_ensemble_graph_matches_eager(cuda_device):
    """Ensemble chunks against the eager loop from one state: generators
    alike; every walker's θ bit-identical up to the first step where a
    walker decided differently (a flip then spreads through the partners),
    at which at most one walker did."""
    model = build_toy(n_events=4000, seed=3, e_grid_size=40, device=cuda_device).model
    init = _start(model, 64)
    runs = {}
    for graph in (True, False):
        s = EnsembleSampler(model, EnsembleConfig(chunk_size=10), init, seed=6, graph=graph)
        runs[graph] = (s, s.run(n_steps=25))
    (sg, g), (se, e) = runs[True], runs[False]
    assert sg._graph is not None and se._graph is None
    assert torch.equal(sg.state.generator.get_state(), se.state.generator.get_state())
    flips = g["accepted"] != e["accepted"]
    steps = np.flatnonzero(flips.any(1))
    first = steps[0] if len(steps) else flips.shape[0]
    if len(steps):
        assert flips[first].sum() <= 1
    assert np.array_equal(g["theta"][:first], e["theta"][:first])
    assert 0 < g["accepted"].mean() < 1


@pytest.mark.cuda
def test_pso_graph_matches_eager(cuda_device):
    """The swarm's iterations as graphs and eagerly from the same seed: the
    best-χ² histories agree (a tie of two particles' χ² within the atomics'
    order is all that could part them)."""
    model = build_toy(n_events=4000, seed=3, e_grid_size=40, device=cuda_device).model
    cfg = PSOConfig(n_particles=16, n_iterations=30, chunk_size=10)
    g = run_pso(model, cfg, seed=2, graph=True)
    e = run_pso(model, cfg, seed=2, graph=False)
    np.testing.assert_allclose(g.history, e.history, rtol=1e-6, atol=1e-6)
    assert g.chi2 <= g.initial_chi2 and g.history.shape == (30,)
