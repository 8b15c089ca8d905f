"""The port's delayed-rejection MR2T2 against ``mach3_tpu/fitters/delayed.py``.

* One delayed step (one retry) on the bridged toy in lockstep with JAX's
  jitted step (Pallas in interpret mode), JAX's draws injected: the fixed
  proposal (JAX draws per chain and per handler block, the port one
  whole-vector batch: the same numbers in the same places) and the adaptive
  one. Decisions, first-attempt and delayed, agree; θ within 1e-12; NLLs
  within the production budget 5e-3 + 1e-3·|NLL| (``test_torch_toy.py``);
  each first-attempt decision's margin |log u − log α| clears twice it.
* The DRAM ratio and its guards against JAX's expression
  (``delayed.py:124-131``) on values that reach each guard.
* Delayed + adaptive adapts (``tests/test_adaptive.py``), on a prior-only
  model with the port's generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.fitters import delayed as jdelayed
from mach3_tpu.fitters import mcmc as jmcmc
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.fitters.delayed import (
    DelayedConfig,
    DelayedMR2T2,
    dram_acceptance,
    make_delayed_step_fn_args,
)
from mach3_tpu_torch.fitters.mcmc import AdaptiveState, ChainState, refresh_throw_matrix
from mach3_tpu_torch.fitters.model import FitModel
from mach3_tpu_torch.params.parameterset import ParameterSet

from test_torch_adaptive import _gauss_param, _jax_adaptive, _start, interp, jtoy  # noqa: F401

torch.set_num_threads(1)

NLL_ATOL, NLL_RTOL = 5e-3, 1e-3


def _jax_delayed_draws(jm, key, cfg, n_chains, adaptive):
    """JAX's draws of one delayed step from ``key`` (delayed.py:101-160):
    per attempt 4-way splits; the adaptive throw as mcmc.adaptive_propose
    draws it, the fixed one per chain and per handler block."""
    n_params = jm.n_params
    out = []
    for attempt in range(cfg.max_rejections + 1):
        key, k_prop, k_u, k_delay = jax.random.split(key, 4)
        if adaptive:
            key_n, key_f = jax.random.split(k_prop)
            z = np.array(jax.random.normal(key_n, (n_chains, n_params), dtype=jnp.float64))
            flip_u = np.array(jax.random.uniform(key_f, (n_chains, n_params)))
        else:
            z = np.zeros((n_chains, n_params))
            flip_u = np.zeros((n_chains, n_params))
            for c, kc in enumerate(jax.random.split(k_prop, n_chains)):
                for prior, (start, size), kb in zip(
                        jm.priors, jm.slices, jax.random.split(kc, len(jm.priors))):
                    kn, kf = jax.random.split(kb)
                    k_cols = np.asarray(prior.chol).shape[1]
                    z[c, start:start + k_cols] = np.array(
                        jax.random.normal(kn, (k_cols,), jnp.float64))
                    flip_u[c, start:start + size] = np.array(jax.random.uniform(kf, (size,)))
        d = {"z": torch.tensor(z), "flip_u": torch.tensor(flip_u),
             "u": torch.tensor(np.array(jax.random.uniform(k_u, (n_chains,), jnp.float64)))}
        if attempt < cfg.max_rejections:
            d["u_delay"] = torch.tensor(np.array(
                jax.random.uniform(k_delay, (n_chains,), jnp.float64)))
        out.append(d)
    return out


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_delayed_step_lockstep_with_jax(jtoy, interp, adaptive):
    # A first throw that is mostly rejected, a retry at a tenth of it (the
    # fixed proposal throws at the prior's width, the adaptive one at 0.6 of it).
    kw = dict(max_rejections=1, decay_rate=0.1, initial_scale=1.0 if adaptive else 0.3,
              delay_probability=0.9,
              adaptive=adaptive,
              adaption_start_update=1, adaption_start_throw=1, adaption_update_step=1,
              robbins_monro=True)
    jcfg, tcfg = jdelayed.DelayedConfig(**kw), DelayedConfig(**kw)
    jm = jtoy.model
    tm = from_jax_model(jm)
    n_chains = 32
    th = _start(jm, n_chains, seed=4)
    key = jax.random.key(21)
    jstate = jmcmc.ChainState(
        theta=jnp.asarray(th), nll=jax.jit(lambda m, t: m.total_nll_batch(t))(jm, jnp.asarray(th)),
        key=key, step=jnp.asarray(0, jnp.int32), n_accepted=jnp.zeros(n_chains, jnp.int32),
        adaptive=_jax_adaptive(jm, jcfg, n_chains) if adaptive else None)
    tad = None
    if adaptive:
        tad = AdaptiveState(**{f: torch.tensor(np.array(getattr(jstate.adaptive, f)))
                               for f in ("mean", "cov", "chol", "n_updates", "log_scale")})
    tstate = ChainState(theta=torch.tensor(th), nll=tm.total_nll_batch(torch.tensor(th)),
                        generator=torch.Generator(), step=torch.tensor(0, dtype=torch.int32),
                        n_accepted=torch.zeros(n_chains, dtype=torch.int32), adaptive=tad)
    draws = _jax_delayed_draws(jm, key, jcfg, n_chains, adaptive)
    jnew, jout = jax.jit(jdelayed.make_delayed_step_fn_args(jcfg))(jm, jstate)
    tnew, tout = make_delayed_step_fn_args(tcfg)(tm, tstate, draws=draws)
    refresh_throw_matrix(tnew.adaptive, tcfg, 1)

    j_acc = np.asarray(jout["acc_prob"])
    budget = 2 * (NLL_ATOL + NLL_RTOL * np.abs(np.asarray(jstate.nll)))
    margin = np.abs(np.log(draws[0]["u"].numpy()) - np.log(np.maximum(j_acc, 1e-300)))
    assert (margin > budget).all(), (margin, budget)
    for k in ("accepted", "delayed_accept"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    assert tout["delayed_accept"].any() and (~tout["accepted"]).any()
    np.testing.assert_allclose(tnew.theta.numpy(), np.asarray(jnew.theta), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tnew.nll.numpy(), np.asarray(jnew.nll), rtol=NLL_RTOL,
                               atol=2 * NLL_ATOL)
    np.testing.assert_array_equal(tnew.n_accepted.numpy(), np.asarray(jnew.n_accepted))
    if adaptive:
        for f in ("mean", "cov"):
            np.testing.assert_allclose(getattr(tnew.adaptive, f).numpy(),
                                       np.asarray(getattr(jnew.adaptive, f)), rtol=0, atol=1e-12)


def _jax_dram(nll0, min_nll, nll_prop):
    """``delayed.py:124-131`` of the JAX package, as it stands there."""
    num = jnp.maximum(0.0, jnp.exp(min_nll - nll_prop) - 1.0)
    den = jnp.exp(min_nll - nll0) - 1.0
    standard = jnp.minimum(1.0, jnp.exp(jnp.minimum(nll0 - nll_prop, 0.0)))
    ratio = jnp.where(den <= 0.0, 1.0, jnp.minimum(num / jnp.where(den == 0, 1.0, den), 1.0))
    inf_guard = jnp.isinf(num) | jnp.isinf(den)
    return jnp.where(inf_guard, standard, ratio)


def test_dram_ratio_and_guards_match_jax():
    rng = np.random.default_rng(0)
    nll0 = np.concatenate([rng.uniform(0, 50, 40), [10.0, 10.0, 10.0, 10.0, 10.0, 5.0, 5.0]])
    min_nll = np.concatenate([nll0[:40] + rng.uniform(-1, 5, 40),
                              [10.0, 8.0, 2000.0, 12.0, 1234567890.0, 5.0 + 1e-300, 4.0]])
    nll_prop = np.concatenate([nll0[:40] + rng.uniform(-2, 6, 40),
                               [11.0, 9.0, 3.0, -900.0, 11.0, 6.0, 3.0]])
    want = np.asarray(_jax_dram(jnp.asarray(nll0), jnp.asarray(min_nll), jnp.asarray(nll_prop)))
    got = dram_acceptance(torch.tensor(nll0), torch.tensor(min_nll), torch.tensor(nll_prop))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    assert got[40] == 1.0 and got[41] == 1.0  # den == 0, den < 0: ratio 1
    assert got[42] == 1.0 and got[43] == 1.0  # a term overflows: standard, downhill
    assert float(got[44]) == pytest.approx(np.exp(-1.0))  # both overflow: standard, uphill
    assert ((got >= 0) & (got <= 1)).all()


def test_delayed_adaptive_actually_adapts():
    """Moments update, the throw matrix leaves its seed, the covariance
    approaches the target, and Robbins-Monro recovers a workable
    acceptance from a bad 0.05 scale."""
    ps = ParameterSet.from_config({"Systematics": [_gauss_param("a", 0.0, 1.0, step=0.05),
                                                   _gauss_param("b", 0.0, 3.0, step=0.05)]},
                                  name="g")
    model = FitModel.build([ps], [])
    cfg = DelayedConfig(adaptive=True, adaption_start_update=50, adaption_start_throw=300,
                        adaption_update_step=50, chunk_size=500, max_rejections=1,
                        decay_rate=0.25)
    fitter = DelayedMR2T2(model, cfg, np.zeros((16, 2)), seed=4)
    chol0 = fitter.state.adaptive.chol.clone()
    out = fitter.run(n_steps=3000)
    ad = fitter.state.adaptive
    assert int(ad.n_updates) > 2000
    assert not torch.allclose(ad.chol, chol0)
    cov = ad.cov.numpy()
    assert cov[0, 0] == pytest.approx(1.0, rel=0.4)
    assert cov[1, 1] == pytest.approx(9.0, rel=0.4)
    assert fitter.acceptance_rate.mean() > 0.1
    assert out["delayed_accept"].any()
    per_chain = DelayedMR2T2(model, DelayedConfig(
        adaptive=True, adaption_mode="per_chain", adaption_start_update=20,
        adaption_start_throw=100, adaption_update_step=50, chunk_size=250),
        np.zeros((8, 2)), seed=5)
    per_chain.run(n_steps=1000)
    assert per_chain.state.adaptive.cov.shape == (8, 2, 2)
    assert np.all(per_chain.state.adaptive.cov.numpy()[:, 0, 0] > 0.3)
