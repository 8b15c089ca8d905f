"""The port's ensemble sampler and particle swarm against
``mach3_tpu/fitters/ensemble.py`` and ``pso.py``.

* The stretch move in lockstep with JAX's ``EnsembleSampler`` on the toy at
  1,500 events (JAX's XLA route against the port's plain route) for 8
  steps, JAX's draws injected (stretch uniforms, partner indices, accept
  uniforms from its own key splits): every accept decision identical, θ
  within 1e-5 prior widths, NLLs within 5e-3 + 1e-3·|NLL|.
* The swarm in lockstep with JAX's ``run_pso`` for 6 iterations, the initial
  scatter, the velocities and the pulls' uniforms injected: the best-χ²
  history within twice the NLL budget, the best point within 1e-5 prior
  widths.
* Walker validation, a Gaussian target's moments, the factory's
  ``Ensemble`` and ``PSO`` branches.
* On the card: ``tests/test_torch_fitters_graph.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.fitters import ensemble as jensemble
from mach3_tpu.fitters import pso as jpso
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.core.config import Config
from mach3_tpu_torch.fitters.ensemble import (
    EnsembleConfig,
    EnsembleSampler,
    EnsembleState,
    make_ensemble_step_fn,
)
from mach3_tpu_torch.fitters.factory import make_fitter
from mach3_tpu_torch.fitters.minimize import chi2_batch
from mach3_tpu_torch.fitters.model import FitModel
from mach3_tpu_torch.fitters.pso import PSOConfig, PSOResult, run_pso
from mach3_tpu_torch.params.parameterset import ParameterSet
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

TOY = dict(n_events=1500, seed=11, e_grid_size=30)
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3
THETA_WIDTHS = 1e-5


@pytest.fixture(scope="module")
def jtoy():
    return jbuild_toy(**TOY, use_pallas=False)


@pytest.fixture(scope="module")
def ttoy():
    return build_toy(**TOY, device="cpu")


def _widths(model):
    chol = model.flat.chol.numpy()
    w = np.sqrt(np.diag(chol @ chol.T))
    return np.where(w > 0, w, 1.0)


def _start(model, n, seed, frac=0.05):
    flat = model.flat
    lo, hi = flat.low_bound.numpy(), flat.up_bound.numpy()
    th = flat.prefit.numpy() + frac * _widths(model) * np.random.default_rng(seed).normal(
        size=(n, model.n_params))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


def _gauss_model():
    params = []
    for name, prefit, err in (("a", 1.0, 0.5), ("b", -2.0, 1.5)):
        params.append({"Systematic": {
            "Names": {"FancyName": name}, "ParameterValues": {"PreFitValue": prefit},
            "StepScale": {"MCMC": 0.5}, "Error": err, "ParameterBounds": [-50, 50],
            "Type": "Norm"}})
    return FitModel.build([ParameterSet.from_config({"Systematics": params}, name="g")], [])


# ------------------------------------------------------------ ensemble
def _jax_half_draws(key, m, n_ref):
    """JAX's draws of one half-update (ensemble.py:45-55)."""
    k_z, k_pick, k_u = jax.random.split(key, 3)
    return {"u_z": torch.from_numpy(np.array(jax.random.uniform(k_z, (m,), jnp.float64))),
            "pick": torch.from_numpy(np.array(jax.random.randint(k_pick, (m,), 0, n_ref))).long(),
            "u": torch.from_numpy(np.array(jax.random.uniform(k_u, (m,), jnp.float64)))}


def test_ensemble_lockstep_with_jax(jtoy, ttoy):
    n_steps, n_walkers = 8, 32
    init = _start(ttoy.model, n_walkers, seed=4, frac=0.3)
    jsampler = jensemble.EnsembleSampler(jtoy.model, jensemble.EnsembleConfig(
        chunk_size=n_steps), init, seed=12)
    jout = jsampler.run(n_steps=n_steps)
    # JAX's keys for this run (ensemble.py:90-93).
    _, sub = jax.random.split(jax.random.key(12))
    keys = jax.random.split(sub, n_steps)

    tm = ttoy.model
    cfg = EnsembleConfig(chunk_size=n_steps)
    sampler = EnsembleSampler(tm, cfg, init, seed=12)
    step = make_ensemble_step_fn(cfg, tm.n_params)
    state, widths, half = sampler.state, _widths(tm), n_walkers // 2
    jtotal = jax.jit(lambda m, t: m.total_nll_batch(t))
    prev, j_nll = init, np.asarray(jtotal(jtoy.model, jnp.asarray(init)))
    for s in range(n_steps):
        k1, k2 = jax.random.split(keys[s])
        draws = (_jax_half_draws(k1, half, half), _jax_half_draws(k2, half, half))
        t_nll = state.nll.numpy()
        state, out = step(tm, state, draws=draws)
        # Each decision clear of the gap between the packages' log α: they
        # agree by the numbers, not by the luck of the draws.
        for h, d in enumerate(draws):
            mine = slice(h * half, (h + 1) * half)
            ref = jout["theta"][s][:half] if h else prev[half:]
            z = (d["u_z"].numpy() * (np.sqrt(2.0) - np.sqrt(0.5)) + np.sqrt(0.5)) ** 2
            anchor = ref[d["pick"].numpy()]
            prop = anchor + z[:, None] * (prev[mine] - anchor)
            j_log = 15 * np.log(z) - (np.asarray(jtotal(jtoy.model, jnp.asarray(prop)))
                                      - j_nll[mine])
            t_log = 15 * np.log(z) - (tm.total_nll_batch(torch.from_numpy(prop)).numpy()
                                      - t_nll[mine])
            margin = np.abs(np.log(d["u"].numpy()) - j_log)
            assert (margin > np.abs(t_log - j_log)).all(), (s, h)
        j_nll = jout["nll"][s]
        j_acc = (jout["theta"][s] != prev).any(-1)
        np.testing.assert_array_equal(out["accepted"].numpy(), j_acc, err_msg=f"step {s + 1}")
        d = np.abs(out["theta"].numpy() - jout["theta"][s]) / widths
        assert d.max() <= THETA_WIDTHS, (s, d.max())
        np.testing.assert_allclose(out["nll"].numpy(), jout["nll"][s], rtol=NLL_RTOL,
                                   atol=NLL_ATOL)
        prev = jout["theta"][s]
    acc = state.n_accepted.numpy()
    np.testing.assert_array_equal(acc, np.asarray(jsampler._state[2]))
    assert 0 < acc.sum() < n_walkers * n_steps
    assert int(state.step) == n_steps


def test_ensemble_walker_validation(ttoy):
    with pytest.raises(ValueError, match="even"):
        EnsembleSampler(ttoy.model, EnsembleConfig(), np.zeros((33, 16)))
    with pytest.raises(ValueError, match="32"):
        EnsembleSampler(ttoy.model, EnsembleConfig(), np.zeros((30, 16)))


def test_ensemble_samples_gaussian():
    model = _gauss_model()
    init = np.random.default_rng(1).normal(size=(16, 2)) * 0.1 + [1.0, -2.0]
    sampler = EnsembleSampler(model, EnsembleConfig(chunk_size=500), init, seed=12)
    out = sampler.run(n_steps=3000)
    draws = out["theta"][1000:].reshape(-1, 2)
    np.testing.assert_allclose(draws.mean(0), [1.0, -2.0], atol=0.15)
    np.testing.assert_allclose(draws.std(0), [0.5, 1.5], rtol=0.12)
    assert 0.2 < sampler.acceptance_rate.mean() < 0.95
    assert isinstance(sampler.state, EnsembleState)
    assert sampler.online_rhat(out).shape == (2,)


def test_factory_builds_ensemble(ttoy):
    cfg = Config({"General": {"FittingAlgorithm": "Ensemble",
                              "MCMC": {"NSteps": 6, "NChains": 4, "AutoSave": 3},
                              "Ensemble": {"StretchA": 1.7}}})
    f = make_fitter(cfg, ttoy.model, seed=2)
    assert isinstance(f, EnsembleSampler) and f.config.stretch_a == 1.7
    assert f.state.theta.shape == (32, 16)  # NChains raised to 2·P walkers
    out = f.run()
    assert out["theta"].shape == (6, 32, 16) and np.isfinite(out["nll"]).all()


# ------------------------------------------------------------ swarm
def _jax_pso_draws(seed, n, p, iters):
    """JAX's draws of ``run_pso`` (pso.py:55-74): scatter and velocity
    normals, then per iteration the two pulls' uniforms."""
    k_init, k_vel, k_run = jax.random.split(jax.random.key(seed), 3)
    draws = {"x0": jax.random.normal(k_init, (n, p), jnp.float64),
             "v0": jax.random.normal(k_vel, (n, p), jnp.float64), "r1": [], "r2": []}
    for k in jax.random.split(k_run, iters):
        k1, k2 = jax.random.split(k)
        draws["r1"].append(jax.random.uniform(k1, (n, p), jnp.float64))
        draws["r2"].append(jax.random.uniform(k2, (n, p), jnp.float64))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def test_pso_lockstep_with_jax(jtoy, ttoy):
    cfg = dict(n_particles=8, n_iterations=6)
    want = jpso.run_pso(jtoy.model, jpso.PSOConfig(**cfg), seed=3)
    got = run_pso(ttoy.model, PSOConfig(**cfg), draws=_jax_pso_draws(3, 8, 16, 6))
    assert isinstance(got, PSOResult) and got.n_evaluations == 8 * 7
    np.testing.assert_allclose(got.history, want.history, rtol=NLL_RTOL, atol=2 * NLL_ATOL)
    assert got.chi2 == pytest.approx(want.chi2, rel=NLL_RTOL, abs=2 * NLL_ATOL)
    d = np.abs(got.x - want.x) / _widths(ttoy.model)
    assert d.max() <= THETA_WIDTHS, d.max()
    assert (np.diff(got.history) <= 0).all() and got.history[-1] < got.history[0]


def test_chi2_batch_is_sentinel_free(jtoy, ttoy):
    """χ² = 2 (quadratic prior without the sentinel + sample -logL), the
    JAX package's ``_chi2_of``, also outside the bounds."""
    from mach3_tpu.fitters.minimize import _chi2_of

    th = _start(ttoy.model, 3, seed=8, frac=0.5)
    th[2, 0] = -0.5  # a norm below its bound
    got = chi2_batch(ttoy.model, torch.from_numpy(th)).numpy()
    want = np.asarray(jax.jit(jax.vmap(lambda t: _chi2_of(jtoy.model, t)))(jnp.asarray(th)))
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL, atol=2 * NLL_ATOL)
    assert got[2] < 1e6


def test_pso_finds_gaussian_mode():
    res = run_pso(_gauss_model(), PSOConfig(n_particles=32, n_iterations=200), seed=3)
    np.testing.assert_allclose(res.x, [1.0, -2.0], atol=1e-2)
    assert res.chi2 < 1e-3 and res.history.shape == (200,)


def test_factory_builds_pso(ttoy):
    cfg = Config({"General": {"FittingAlgorithm": "PSO",
                              "PSO": {"Particles": 6, "Iterations": 4}}})
    runner = make_fitter(cfg, ttoy.model, seed=5)
    assert (runner.config.n_particles, runner.config.n_iterations) == (6, 4)
    res = runner.run()
    assert res.history.shape == (4,) and np.isfinite(res.chi2)
