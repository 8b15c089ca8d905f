"""The port's adaptive MR2T2 (Haario pooled and per chain, adaption blocks,
Robbins-Monro, annealing) against ``mach3_tpu/fitters/mcmc.py``.

* The moment update and the adaptive state's pieces on the same numpy
  inputs in f64: atol 1e-12 (the same arithmetic, summed in another order).
* A 6-step lockstep on the bridged toy against JAX's jitted step (Pallas in
  interpret mode), JAX's draws injected into the port. θ, the moments and
  the factor the proposals use agree within 1e-12 while every accept
  decision agrees;
  the NLLs within the production budget 5e-3 + 1e-3·|NLL| (JAX rounds its
  responses to bf16, ``test_torch_toy.py``). A refreshed Cholesky factor is
  held by what it reproduces (``_check_factor``) and JAX's then carried on,
  since six steps give a rank-deficient covariance whose factor is fixed
  only to ~1e-9. Each decision's margin
  |log u − log α| must exceed twice that budget (over the annealing
  temperature), so a decision that numerics could flip fails the test
  instead of passing unnoticed. Robbins-Monro is off in the free-running
  lockstep: its scale moves with the acceptance probability, which carries
  the NLL budget, and every later proposal would differ by it; the update
  itself is held in f64 below.
* The statistical behaviour of ``tests/test_adaptive.py`` and
  ``tests/test_mcmc.py`` on prior-only models, with the port's generator.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.fitters import mcmc as jmcmc
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.fitters import mcmc
from mach3_tpu_torch.fitters.mcmc import MR2T2, AdaptiveState, ChainState, MCMCConfig
from mach3_tpu_torch.fitters.model import FitModel
from mach3_tpu_torch.params.parameterset import ParameterSet

torch.set_num_threads(1)

TOY = dict(n_events=1500, seed=11, e_grid_size=30, flip_hierarchy=True)
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3


def _gauss_param(name, prefit, error, step=1.0, bounds=(-50, 50), corr=None):
    entry = {"Systematic": {
        "Names": {"FancyName": name}, "ParameterValues": {"PreFitValue": prefit},
        "StepScale": {"MCMC": step}, "Error": error, "ParameterBounds": list(bounds),
        "Type": "Norm"}}
    if corr:
        entry["Systematic"]["Correlations"] = [{k: v} for k, v in corr.items()]
    return entry


def _prior_only_model(params):
    ps = ParameterSet.from_config({"Systematics": params}, name="g")
    return FitModel.build([ps], []), ps


# ------------------------------------------------------------ moment update
def _states(mode, n_chains, n_params, rng):
    a = rng.normal(size=(n_params, n_params))
    cov0 = a @ a.T / n_params + np.eye(n_params)
    chol0 = np.linalg.cholesky(cov0)
    shape = (n_chains,) if mode == "per_chain" else ()
    arrays = dict(mean=np.zeros(shape + (n_params,)), cov=np.broadcast_to(cov0, shape + cov0.shape),
                  chol=np.broadcast_to(chol0, shape + cov0.shape), log_scale=np.zeros(shape))
    jad = jmcmc.AdaptiveState(n_updates=jnp.asarray(0, jnp.int32),
                              **{k: jnp.asarray(v) for k, v in arrays.items()})
    tad = AdaptiveState(n_updates=torch.tensor(0, dtype=torch.int32),
                        **{k: torch.tensor(np.array(v)) for k, v in arrays.items()})
    return jad, tad


@pytest.mark.parametrize("blocks", [None, ((0, 2), (2, 4))], ids=["joint", "blocks"])
@pytest.mark.parametrize("mode", ["pooled", "per_chain"])
def test_update_adaptive_matches_jax(mode, blocks):
    """Fourteen steps of ``_update_adaptive`` on the same θ and acceptance
    probabilities: the window is steps 3-12, the throw matrix refreshes at
    steps 9, 11 and 13 (each chain's moments then hold more samples than
    parameters, so the factor is well conditioned), Robbins-Monro moves the
    scale."""
    rng = np.random.default_rng(5)
    n_chains, n_params = 6, 5
    kw = dict(adaptive=True, adaption_mode=mode, adaption_start_update=3,
              adaption_start_throw=9, adaption_update_step=2, adaption_end_update=12,
              adaption_blocks=blocks, robbins_monro=True)
    jcfg, tcfg = jmcmc.MCMCConfig(**kw), MCMCConfig(**kw)
    jad, tad = _states(mode, n_chains, n_params, rng)
    jmask = jmcmc.adaption_block_mask(n_params, blocks)
    tmask = mcmc.adaption_block_mask(n_params, blocks)
    refreshed = []
    for step in range(1, 15):
        theta = rng.normal(size=(n_chains, n_params)) * np.arange(1, n_params + 1)
        acc = rng.uniform(size=n_chains)
        jad = jmcmc._update_adaptive(jad, jnp.asarray(theta), jnp.asarray(step, jnp.int32),
                                     jcfg, jnp.asarray(acc), jmask)
        refreshed.append(mcmc.refresh_due(tcfg, step))
        tad = mcmc._update_adaptive(tad, torch.tensor(theta), torch.tensor(step, dtype=torch.int32),
                                    tcfg, torch.tensor(acc), tmask)
        mcmc.refresh_throw_matrix(tad, tcfg, step)
        for f in ("mean", "cov", "chol", "log_scale"):
            np.testing.assert_allclose(getattr(tad, f).numpy(), np.asarray(getattr(jad, f)),
                                       rtol=0, atol=1e-12, err_msg=f"{f} at step {step}")
        assert int(tad.n_updates) == int(jad.n_updates)
    assert refreshed == [s >= 9 and s % 2 == 1 for s in range(1, 15)]
    assert int(tad.n_updates) == 10  # steps 3..12
    if blocks:
        cov = tad.cov.numpy()
        assert np.all(cov[..., :2, 2:] == 0) and np.all(cov[..., 4, :4] == 0)


def test_moment_update_matches_jax():
    rng = np.random.default_rng(1)
    mean, x = rng.normal(size=4), rng.normal(size=4)
    a = rng.normal(size=(4, 4))
    cov = a @ a.T
    for n in (0.0, 1.0, 7.0):
        jm, jc = jmcmc._moment_update(jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(n),
                                      jnp.asarray(x), jnp.outer(x, x))
        tm, tc = mcmc._moment_update(torch.tensor(mean), torch.tensor(cov), torch.tensor(n),
                                     torch.tensor(x), torch.outer(torch.tensor(x), torch.tensor(x)))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-12)


@pytest.mark.parametrize("blocks", [None, ((0, 2), (2, 5)), ((1, 3), (4, 6))])
def test_adaption_block_mask_matches_jax(blocks):
    want = jmcmc.adaption_block_mask(6, blocks)
    got = mcmc.adaption_block_mask(6, blocks)
    if blocks is None:
        assert want is None and got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        mcmc.adaption_block_mask(4, ((0, 9),))


@pytest.fixture(scope="module")
def jtoy():
    return jbuild_toy(**TOY, use_pallas=True)


def test_initial_cov_matches_jax(jtoy):
    want = jmcmc.MR2T2._initial_cov(types.SimpleNamespace(model=jtoy.model))
    got = MR2T2._initial_cov(types.SimpleNamespace(model=from_jax_model(jtoy.model)))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ lockstep
@pytest.fixture()
def interp(monkeypatch):
    from jax.experimental import pallas as pl

    from mach3_tpu.splines import pallas_reweight as pr

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    pr.fused_reweight_histogram_shifted.clear_cache()
    yield
    pr.fused_reweight_histogram_shifted.clear_cache()


def _start(model, n_chains, seed):
    flat = model._flat()
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + 0.05 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


def _jax_adaptive(jm, cfg, n_chains):
    """The adaptive state JAX's ``MR2T2.__init__`` seeds (mcmc.py:449-489)."""
    cov0 = jmcmc.MR2T2._initial_cov(types.SimpleNamespace(model=jm))
    n = cov0.shape[0]
    chol0 = np.linalg.cholesky(5.6644 / n * cov0 + 1e-12 * np.eye(n))
    if cfg.adaption_mode == "per_chain":
        return jmcmc.AdaptiveState(
            mean=jnp.zeros((n_chains, n)), cov=jnp.tile(jnp.asarray(cov0), (n_chains, 1, 1)),
            chol=jnp.tile(jnp.asarray(chol0), (n_chains, 1, 1)),
            n_updates=jnp.asarray(0, jnp.int32), log_scale=jnp.zeros((n_chains,)))
    return jmcmc.AdaptiveState(mean=jnp.zeros(n), cov=jnp.asarray(cov0),
                               chol=jnp.asarray(chol0), n_updates=jnp.asarray(0, jnp.int32),
                               log_scale=jnp.asarray(0.0))


def _jax_draws(key, n_chains, n_params, n_cols):
    """The draws of JAX's step from ``key`` (mcmc.py:246, :212-228;
    params/state.py for the fixed proposal): z, flip uniforms, accept
    uniforms."""
    _, k_prop, k_acc = jax.random.split(key, 3)
    key_n, key_f = jax.random.split(k_prop)
    z = np.array(jax.random.normal(key_n, (n_chains, n_cols), dtype=jnp.float64))
    flip_u = np.array(jax.random.uniform(key_f, (n_chains, n_params)))
    u = np.array(jax.random.uniform(k_acc, (n_chains,), dtype=jnp.float64))
    return z, flip_u, u


def _check_factor(got, want, cov_got, cov_want):
    """The refreshed throw matrix: lower triangular, and it reproduces the
    scaled covariance (plus the 1e-12 jitter) within 1e-12 of its largest
    entry, as JAX's does its own (the covariances agree within 1e-12).
    Entry by entry the two factors may differ by more: a refresh after one
    or two samples factors a covariance of rank 1 (per chain) or below P
    (pooled, 8 chains for 16 parameters), whose Cholesky factor rounding
    moves by up to ~1e-8."""
    d = cov_got.shape[-1]
    for f, cov in ((got, cov_got), (want, cov_want)):
        target = HAARIO / d * cov + 1e-12 * np.eye(d)
        assert np.all(np.triu(f, 1) == 0)
        recon = f @ np.swapaxes(f, -1, -2)
        assert np.all(np.abs(recon - target) <= 1e-12 * np.abs(target).max())


HAARIO = 5.6644

LOCKSTEP = {
    "pooled": dict(adaptive=True, adaption_mode="pooled"),
    "per_chain": dict(adaptive=True, adaption_mode="per_chain"),
    "annealed": dict(anneal_temp=8.0),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_adaptive_lockstep_with_jax(jtoy, interp, case):
    kw = dict(LOCKSTEP[case], adaption_start_update=1, adaption_start_throw=2,
              adaption_update_step=2, robbins_monro=False)
    jcfg, tcfg = jmcmc.MCMCConfig(**kw), MCMCConfig(**kw)
    jm = jtoy.model
    tm = from_jax_model(jm)
    n_chains, n_steps = 8, 6
    th = _start(jm, n_chains, seed=2)
    key = jax.random.key(7)
    jstate = jmcmc.ChainState(
        theta=jnp.asarray(th), nll=jax.jit(lambda m, t: m.total_nll_batch(t))(jm, jnp.asarray(th)),
        key=key, step=jnp.asarray(0, jnp.int32), n_accepted=jnp.zeros(n_chains, jnp.int32),
        adaptive=_jax_adaptive(jm, jcfg, n_chains) if jcfg.adaptive else None)
    tad = None
    if jstate.adaptive is not None:
        tad = AdaptiveState(**{f: torch.tensor(np.array(getattr(jstate.adaptive, f)))
                               for f in ("mean", "cov", "chol", "n_updates", "log_scale")})
    tstate = ChainState(theta=torch.tensor(th), nll=tm.total_nll_batch(torch.tensor(th)),
                        generator=torch.Generator(), step=torch.tensor(0, dtype=torch.int32),
                        n_accepted=torch.zeros(n_chains, dtype=torch.int32), adaptive=tad)
    seed_chol = None if tad is None else tad.chol.numpy().copy()  # refreshes write in place
    jstep = jax.jit(jmcmc.make_step_fn_args(jcfg))
    tstep = mcmc.make_step_fn_args(tcfg)
    n_cols = th.shape[1] if jcfg.adaptive else np.asarray(jm._flat().chol).shape[1]
    n_acc = 0
    for s in range(n_steps):
        z, flip_u, u = _jax_draws(jstate.key, n_chains, th.shape[1], n_cols)
        jnew, jout = jstep(jm, jstate)
        tnew, tout = tstep(tm, tstate, z=torch.tensor(z), flip_u=torch.tensor(flip_u),
                           u_acc=torch.tensor(u))
        mcmc.refresh_throw_matrix(tnew.adaptive, tcfg, s + 1)
        # Every decision clear of what the NLL budget could flip.
        j_acc = np.asarray(jout["acc_prob"])
        nll_scale = np.maximum(np.abs(np.asarray(jstate.nll)), np.abs(np.asarray(jout["nll"])))
        budget = 2 * (NLL_ATOL + NLL_RTOL * nll_scale)
        if tcfg.anneal_temp is not None:
            budget = budget / np.exp(-s / tcfg.anneal_temp)
        margin = np.abs(np.log(u) - np.log(np.maximum(j_acc, 1e-300)))
        assert (margin > budget).all(), (s, margin, budget)
        np.testing.assert_array_equal(tout["accepted"].numpy(), np.asarray(jout["accepted"]))
        n_acc += int(tout["accepted"].sum())
        np.testing.assert_allclose(tnew.theta.numpy(), np.asarray(jnew.theta), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tnew.nll.numpy(), np.asarray(jnew.nll), rtol=NLL_RTOL,
                                   atol=2 * NLL_ATOL)
        if tnew.adaptive is not None:
            for f in ("mean", "cov"):
                np.testing.assert_allclose(getattr(tnew.adaptive, f).numpy(),
                                           np.asarray(getattr(jnew.adaptive, f)), rtol=0,
                                           atol=1e-12, err_msg=f"{f} at step {s + 1}")
            assert int(tnew.adaptive.n_updates) == int(jnew.adaptive.n_updates) == s + 1
            j_chol = np.asarray(jnew.adaptive.chol)
            if mcmc.refresh_due(tcfg, s + 1):
                _check_factor(tnew.adaptive.chol.numpy(), j_chol, tnew.adaptive.cov.numpy(),
                              np.asarray(jnew.adaptive.cov))
                tnew.adaptive.chol = torch.tensor(np.array(j_chol))
            np.testing.assert_array_equal(tnew.adaptive.chol.numpy(), j_chol)
        assert int(tnew.step) == int(jnew.step) == s + 1
        jstate, tstate = jnew, tnew
    assert 0 < n_acc < n_chains * n_steps  # both outcomes were exercised
    np.testing.assert_array_equal(tstate.n_accepted.numpy(), np.asarray(jstate.n_accepted))
    if tstate.adaptive is not None:  # the factor was refreshed: it left its seed
        assert not np.allclose(tstate.adaptive.chol.numpy(), seed_chol)


# ------------------------------------------------------------ statistics
@pytest.mark.parametrize("mode", ["pooled", "per_chain"])
def test_adaptation_modes_recover_correlated_gaussian(mode):
    model, _ = _prior_only_model([
        _gauss_param("a", 0.0, 1.0, step=0.1, corr={"b": 0.8}),
        _gauss_param("b", 0.0, 2.0, step=0.1, corr={"a": 0.8})])
    cfg = MCMCConfig(adaptive=True, adaption_mode=mode, adaption_start_update=50,
                     adaption_start_throw=400, adaption_update_step=50, chunk_size=500)
    fitter = MR2T2(model, cfg, np.zeros((16, 2)), seed=3)
    out = fitter.run(n_steps=4000)
    cov = fitter.state.adaptive.cov.numpy()
    if mode == "per_chain":
        assert cov.shape == (16, 2, 2) and fitter.state.adaptive.log_scale.shape == (16,)
        cov = cov.mean(axis=0)
    truth = np.array([[1.0, 1.6], [1.6, 4.0]])
    assert np.allclose(cov, truth, rtol=0.5, atol=0.35), cov
    rho = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    assert 0.5 < rho < 0.95, rho
    draws = out["theta"][2000:].reshape(-1, 2)
    assert np.std(draws[:, 0]) == pytest.approx(1.0, rel=0.15)
    assert np.std(draws[:, 1]) == pytest.approx(2.0, rel=0.15)
    assert np.corrcoef(draws[:, 0], draws[:, 1])[0, 1] == pytest.approx(0.8, abs=0.1)
    assert fitter.acceptance_rate.mean() > 0.1


def test_annealing_cools_to_greedy():
    """acc = exp(-dL / exp(-step/T)): the sampler turns greedy as it cools."""
    model, _ = _prior_only_model([_gauss_param("a", 0.0, 1.0, step=3.0)])
    init = np.full((8, 1), 3.0)
    out_a = MR2T2(model, MCMCConfig(anneal_temp=100.0, chunk_size=200), init, seed=9).run(800)
    out_c = MR2T2(model, MCMCConfig(chunk_size=200), init, seed=9).run(800)
    assert out_a["accepted"][600:].mean() < out_c["accepted"][600:].mean()
    assert np.abs(out_a["theta"][-1]).mean() < 1.5


def test_adaption_blocks_zero_cross_block_covariance():
    model, _ = _prior_only_model(
        [_gauss_param(f"p{i}", 0.0, 1.0 + 0.2 * i, step=0.5) for i in range(6)])
    cfg = MCMCConfig(adaptive=True, adaption_start_update=10, adaption_start_throw=50,
                     adaption_update_step=50, adaption_blocks=((0, 3), (3, 6)), chunk_size=100)
    f = MR2T2(model, cfg, np.zeros((8, 6)), seed=3)
    f.run(300)
    cov = f.state.adaptive.cov.numpy()
    assert np.all(cov[:3, 3:] == 0.0) and np.all(cov[3:, :3] == 0.0)
    assert np.any(cov[:3, :3] != 0.0) and np.any(cov[3:, 3:] != 0.0)
    chol = f.state.adaptive.chol.numpy()
    assert np.all(chol[3:, :3] == 0.0)  # the refreshed factor is block-diagonal too


def test_out_of_bounds_never_accepted():
    model, _ = _prior_only_model([_gauss_param("a", 0.0, 5.0, step=1.0, bounds=(-1, 1))])
    for cfg in (MCMCConfig(chunk_size=200),
                MCMCConfig(chunk_size=200, adaptive=True, adaption_start_update=10,
                           adaption_start_throw=50, adaption_update_step=50)):
        out = MR2T2(model, cfg, np.zeros((4, 1)), seed=7).run(1000)
        assert np.all(np.abs(out["theta"]) <= 1.0)


def test_run_zero_steps_returns_empty():
    model, _ = _prior_only_model([_gauss_param("a", 0.0, 1.0)])
    f = MR2T2(model, MCMCConfig(n_steps=0, chunk_size=5), np.zeros((4, 1)), seed=0)
    assert f.run() == {}
    assert f.run(n_steps=-3) == {}
    assert int(f.state.step) == 0


def test_adaptive_with_pca_raises():
    params = [_gauss_param(f"p{i}", 0.0, 1.0, corr={f"p{i ^ 1}": 0.99}) for i in range(4)]
    ps = ParameterSet.from_config({"Systematics": params}, name="g")
    ps.construct_pca(0.05)
    model = FitModel.build([ps], [])
    assert model.priors[0].chol.shape[0] != model.priors[0].chol.shape[1]
    with pytest.raises(ValueError, match="PCA"):
        MR2T2(model, MCMCConfig(adaptive=True), np.zeros((2, 4)))
    MR2T2(model, MCMCConfig(), np.zeros((2, 4)))  # PCA alone is fine


def test_eager_is_the_cpu_default_and_graph_needs_cuda():
    model, _ = _prior_only_model([_gauss_param("a", 0.0, 1.0)])
    assert MR2T2(model, MCMCConfig(), np.zeros((2, 1))).graph is False
    with pytest.raises(ValueError, match="CUDA"):
        MR2T2(model, MCMCConfig(), np.zeros((2, 1)), graph=True)


@pytest.mark.parametrize("mode", ["pooled", "per_chain"])
def test_refresh_writes_the_factor_in_place(mode):
    """The throw matrix's refresh after a step writes the factor into the
    buffer the state holds (a captured step reads that buffer), row-major
    as it was seeded: ``cholesky_ex`` returns column-major factors, whose
    per-chain product with the normals would sum in another order."""
    model, _ = _prior_only_model(
        [_gauss_param(f"p{i}", 0.0, 1.0 + 0.3 * i, step=0.5) for i in range(5)])
    cfg = MCMCConfig(adaptive=True, adaption_mode=mode, adaption_start_update=1,
                     adaption_start_throw=10, adaption_update_step=10, chunk_size=7)
    f = MR2T2(model, cfg, np.zeros((6, 5)), seed=1)
    chol = f.state.adaptive.chol
    seed, ptr, stride = chol.clone(), chol.data_ptr(), chol.stride()
    f.run(n_steps=9, collect=False)
    assert torch.equal(f.state.adaptive.chol, seed)  # no refresh before step 10
    f.run(n_steps=11, collect=False)  # refreshes at steps 10 and 20, the last
    got = f.state.adaptive.chol
    assert got is chol and got.data_ptr() == ptr and got.stride() == stride
    assert got.is_contiguous() and not torch.equal(got, seed)
    assert torch.equal(got, mcmc.refreshed_chol(f.state.adaptive, cfg))
