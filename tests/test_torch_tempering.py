"""The port's parallel tempering against ``mach3_tpu/fitters/tempering.py``.

* The ladder and ``pt_betas`` (``beta_zero``'s ``ValueError`` included):
  equal.
* The PT step in lockstep with JAX's ``make_pt_step_fn_args`` for 20 steps,
  JAX's draws (from its own key splits) injected: on the bimodal model of
  ``tests/test_tempering.py`` (one norm matched twice, a Poisson bin) and on
  a small octant toy (JAX's XLA route against the port's plain route;
  Robbins-Monro off there, since its scales move with the acceptance
  probabilities, which carry the NLL budget into every later throw; on the
  bimodal model it runs, the scales' gap held below Σ γ_t·|Δ acceptance|). Every
  accept and swap decision identical, each accept decision's margin
  |log u − log α| above the gap between the two packages' log α; θ within
  1e-5 prior widths (Robbins-Monro moves each level's
  scale by the acceptance probabilities, which carry the NLL budget); NLLs
  within 5e-3 + 1e-3·|NLL|; counters equal.
* The statistics of JAX's tests on the bimodal model with the port's
  generator; checkpoint and exact resume on the CPU; the factory's PT
  branch; ``cold_chain``; ``mach3-mcmc-torch`` storing the cold level with
  ``log_evidence`` in the metadata.
* On the card: ``tests/test_torch_fitters_graph.py``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.fitters import tempering as jtempering
from mach3_tpu.fitters.model import FitModel as JFitModel
from mach3_tpu.params.parameterset import ParameterSet as JParameterSet
from mach3_tpu.samples.events import EventData as JEventData
from mach3_tpu.samples.events import build_sample_model as jbuild_sample_model
from mach3_tpu.samples.teststats import TestStatistic as JTestStatistic
from mach3_tpu.tutorial.toy import build_octant_toy as jbuild_octant_toy
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.core.config import Config
from mach3_tpu_torch.diagnostics.chain_io import load_chain, load_checkpoint, save_checkpoint
from mach3_tpu_torch.fitters import tempering
from mach3_tpu_torch.fitters.factory import make_fitter
from mach3_tpu_torch.fitters.tempering import ParallelTempering, PTConfig, PTState, pt_betas

torch.set_num_threads(1)

THETA_STAR = 2.0
N_EVENTS = 100
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3
THETA_WIDTHS = 1e-5


def _param(name, prefit, error, step, bounds=(-50, 50)):
    return {"Systematic": {
        "Names": {"FancyName": name}, "ParameterValues": {"PreFitValue": prefit},
        "StepScale": {"MCMC": step}, "Error": error, "ParameterBounds": list(bounds),
        "Type": "Norm"}}


@pytest.fixture(scope="module")
def jbimodal():
    """``tests/test_tempering.py``'s bimodal model: event weight θ², data
    N·θ*², modes at ±θ*."""
    ps = JParameterSet.from_config({"Systematics": [_param("mu", 0.0, 3.0, step=0.1)]},
                                   name="bi")
    ev = JEventData(
        kinematics={"x": np.full(N_EVENTS, 0.5)}, mode=np.zeros(N_EVENTS, np.int32),
        target=np.full(N_EVENTS, 8, np.int32), pdg=np.full(N_EVENTS, 14, np.int32),
        preosc_pdg=np.full(N_EVENTS, 14, np.int32), mc_weight=np.ones(N_EVENTS))
    sm = jbuild_sample_model(
        "bi", ev, var_order=["x"], binning_edges=[np.array([0.0, 1.0])], binning_vars=["x"],
        n_total_params=1, norm_idx=np.zeros((N_EVENTS, 2), np.int32),
        test_statistic=JTestStatistic.POISSON,
    ).with_data(np.array([N_EVENTS * THETA_STAR**2]))
    return JFitModel.build([ps], [sm])


@pytest.fixture(scope="module")
def bimodal(jbimodal):
    return from_jax_model(jbimodal)


@pytest.fixture(scope="module")
def joctant():
    return jbuild_octant_toy(n_events=1500, seed=7, e_grid_size=30, use_pallas=False)


def _mode_fractions(draws):
    flat = draws.reshape(-1)
    return float(np.mean(flat < -1.0)), float(np.mean(flat > 1.0))


# ------------------------------------------------------------ ladder
@pytest.mark.parametrize("n_temps,max_temp", [(1, 4.0), (2, 9.0), (5, 16.0), (8, 64.0)])
def test_ladder_matches_jax(n_temps, max_temp):
    np.testing.assert_array_equal(tempering.temperature_ladder(n_temps, max_temp),
                                  jtempering.temperature_ladder(n_temps, max_temp))
    for bz in (False, True):
        kw = dict(n_temps=n_temps, max_temp=max_temp, beta_zero=bz)
        if bz and n_temps < 3:
            with pytest.raises(ValueError):
                pt_betas(PTConfig(**kw))
            with pytest.raises(ValueError):
                jtempering.pt_betas(jtempering.PTConfig(**kw))
            continue
        np.testing.assert_array_equal(pt_betas(PTConfig(**kw)),
                                      jtempering.pt_betas(jtempering.PTConfig(**kw)))


# ------------------------------------------------------------ lockstep
def _jax_pt_draws(key, n_chains, n_cols, n_params, n_temps, n_walkers):
    """The draws of JAX's PT step from ``key`` (tempering.py:131-141, 176;
    params/state.py:172-183): z, flip uniforms, accept and swap uniforms."""
    _, k_prop, k_acc, k_swap = jax.random.split(key, 4)
    key_n, key_f = jax.random.split(k_prop)
    z = np.array(jax.random.normal(key_n, (n_chains, n_cols), dtype=jnp.float64))
    flip_u = np.array(jax.random.uniform(key_f, (n_chains, n_params)))
    u = np.array(jax.random.uniform(k_acc, (n_chains,), dtype=jnp.float64))
    u_s = np.array(jax.random.uniform(k_swap, (n_temps - 1, n_walkers), dtype=jnp.float64))
    return z, flip_u, u, u_s


def _lockstep(jm, tm, cfg_kw, init, n_steps, seed):
    jcfg, tcfg = jtempering.PTConfig(**cfg_kw), PTConfig(**cfg_kw)
    jpt = jtempering.ParallelTempering(jm, jcfg, init, seed=seed)
    tpt = ParallelTempering(tm, tcfg, init, seed=seed)
    jst, tst = jpt.state, tpt.state
    n_t, n_w = tcfg.n_temps, tpt.n_walkers
    widths = np.sqrt(np.diag(tm.flat.chol.numpy() @ tm.flat.chol.numpy().T))
    widths = np.where(widths > 0, widths, 1.0)
    jstep = jax.jit(jtempering.make_pt_step_fn_args(jcfg, n_w))
    tstep = tempering.make_pt_step_fn_args(tcfg, n_w)
    n_cols = np.asarray(jm._flat().chol).shape[1]
    n_acc = n_swaps = 0
    scale_gap = np.zeros(n_t)
    for s in range(n_steps):
        z, flip_u, u, u_s = _jax_pt_draws(jst.key, init.shape[0] * n_t, n_cols, tm.n_params,
                                          n_t, n_w)
        jnew, jout = jstep(jm, jst)
        tnew, tout = tstep(tm, tst, z=torch.from_numpy(z), flip_u=torch.from_numpy(flip_u),
                           u_acc=torch.from_numpy(u), u_swap=torch.from_numpy(u_s))
        # Every accept decision clear of the gap between the two log α: the
        # decisions agree by the numbers, not by the luck of the draws.
        j_log = np.log(np.maximum(np.asarray(jout["acc_prob"]), 1e-300))
        t_log = np.log(np.maximum(tout["acc_prob"].numpy(), 1e-300))
        assert (np.abs(np.log(u) - j_log) > np.abs(t_log - j_log)).all(), s
        np.testing.assert_array_equal(tout["accepted"].numpy(), np.asarray(jout["accepted"]))
        np.testing.assert_array_equal(tnew.swap_accepts.numpy(), np.asarray(jnew.swap_accepts))
        np.testing.assert_array_equal(tnew.swap_attempts.numpy(), np.asarray(jnew.swap_attempts))
        np.testing.assert_array_equal(tnew.n_accepted.numpy(), np.asarray(jnew.n_accepted))
        assert int(tnew.step) == int(jnew.step) == s + 1
        d_theta = np.abs(tnew.theta.numpy() - np.asarray(jnew.theta)) / widths
        assert d_theta.max() <= THETA_WIDTHS, (s, d_theta.max())
        for f in ("prior_nll", "sample_nll"):
            np.testing.assert_allclose(getattr(tnew, f).numpy(), np.asarray(getattr(jnew, f)),
                                       rtol=NLL_RTOL, atol=NLL_ATOL, err_msg=f"{f} at {s + 1}")
        # Robbins-Monro: the scales part by at most γ_t x the level-mean
        # acceptance probabilities' difference each step (the clip only narrows).
        d_acc = np.abs(tout["acc_prob"].numpy() - np.asarray(jout["acc_prob"]))
        scale_gap += 2.0 / (s + 1) ** 0.66 * d_acc.reshape(n_t, n_w).mean(1)
        d_scale = np.abs(tnew.log_scale.numpy() - np.asarray(jnew.log_scale))
        assert (d_scale <= scale_gap + 1e-14).all(), (s, d_scale, scale_gap)
        n_acc += int(tout["accepted"].sum())
        n_swaps = int(tnew.swap_accepts.sum())
        jst, tst = jnew, tnew
    assert 0 < n_acc < init.shape[0] * n_t * n_steps  # both outcomes exercised
    assert n_swaps > 0  # swaps exercised
    return tst


def test_pt_step_lockstep_bimodal(jbimodal, bimodal):
    init = np.array([[2.0], [-2.0], [1.5], [2.5]])
    _lockstep(jbimodal, bimodal, dict(n_temps=4, max_temp=64.0), init, 20, seed=5)


@pytest.mark.parametrize("beta_zero", [False, True], ids=["geometric", "beta-zero"])
def test_pt_step_lockstep_octant_toy(joctant, beta_zero):
    tm = from_jax_model(joctant.model)
    flat = joctant.model._flat()
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    rng = np.random.default_rng(1)
    init = np.clip(np.asarray(flat.prefit) + 0.1 * sig * rng.normal(size=(4, len(sig))),
                   lo + 1e-9, hi - 1e-9)
    _lockstep(joctant.model, tm, dict(n_temps=3, max_temp=16.0, swap_every=2,
                                      beta_zero=beta_zero, robbins_monro=False), init, 20, seed=3)


# ------------------------------------------------------------ statistics
def test_parallel_tempering_mixes_between_modes(bimodal):
    init = np.full((8, 1), THETA_STAR)  # every walker in the + mode
    pt = ParallelTempering(bimodal, PTConfig(n_temps=6, max_temp=64.0, chunk_size=500), init,
                           seed=5)
    out = pt.run(n_steps=4000)
    neg, pos = _mode_fractions(pt.cold_chain(out)["theta"][1000:])
    assert neg > 0.15 and pos > 0.15
    assert neg + pos > 0.8
    assert np.all(pt.swap_acceptance > 0.05)
    assert np.all(pt.acceptance_rate.reshape(6, 8).mean(axis=1) > 0.05)


def test_cold_level_preserves_prior_moments():
    from mach3_tpu_torch.fitters.model import FitModel
    from mach3_tpu_torch.params.parameterset import ParameterSet

    ps = ParameterSet.from_config({"Systematics": [_param("a", 0.5, 1.0, step=1.0),
                                                   _param("b", -1.0, 2.0, step=1.0)]}, name="g")
    model = FitModel.build([ps], [])
    pt = ParallelTempering(model, PTConfig(n_temps=4, max_temp=16.0, chunk_size=500),
                           np.tile(ps.prefit, (16, 1)), seed=7)
    cold = pt.cold_chain(pt.run(n_steps=3000))["theta"][500:].reshape(-1, 2)
    np.testing.assert_allclose(cold.mean(axis=0), [0.5, -1.0], atol=0.15)
    np.testing.assert_allclose(cold.std(axis=0), [1.0, 2.0], rtol=0.12)


def test_cold_chain_and_outputs(bimodal):
    pt = ParallelTempering(bimodal, PTConfig(n_temps=3, max_temp=9.0, chunk_size=7),
                           np.full((4, 1), THETA_STAR), seed=2)
    out = pt.run(n_steps=10)
    assert out["theta"].shape == (10, 12, 1) and out["sample_nll"].shape == (10, 12)
    cold = pt.cold_chain(out)
    assert cold["theta"].shape == (10, 4, 1) and cold["step_time"].shape == (10,)
    np.testing.assert_array_equal(cold["nll"], out["nll"][:, :4])
    # The state's NLLs are those of its θ.
    total = bimodal.total_nll_batch(pt.state.theta)
    torch.testing.assert_close(pt.state.prior_nll + pt.state.sample_nll, total, rtol=1e-12,
                               atol=1e-9)
    assert pt.online_rhat(out).shape == (1,)
    with pytest.raises(ValueError, match="beta_zero"):
        pt.log_evidence(out)


def test_pretiled_init(bimodal):
    init = np.linspace(-2.0, 2.0, 6)[:, None]
    pt = ParallelTempering(bimodal, PTConfig(n_temps=3), init, pretiled=True)
    assert pt.n_walkers == 2
    np.testing.assert_array_equal(pt.state.theta.numpy(), init)
    with pytest.raises(ValueError):
        ParallelTempering(bimodal, PTConfig(n_temps=4), init, pretiled=True)


def test_checkpoint_resume_exact(tmp_path, bimodal):
    cfg = PTConfig(n_temps=3, max_temp=9.0, chunk_size=20)
    init = np.full((4, 1), THETA_STAR)
    a = ParallelTempering(bimodal, cfg, init, seed=11)
    a.run(n_steps=40)
    ckpt = str(tmp_path / "pt.ckpt")
    save_checkpoint(ckpt, a, ["mu"])
    b = ParallelTempering(bimodal, cfg, init, seed=999)
    load_checkpoint(ckpt, b)
    out_a, out_b = a.run(n_steps=30), b.run(n_steps=30)
    for k in ("theta", "nll", "sample_nll", "accepted"):
        np.testing.assert_array_equal(out_a[k], out_b[k])
    for f in ("swap_accepts", "swap_attempts", "log_scale", "n_accepted", "step"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


@pytest.mark.parametrize("algo", ["ParallelTempering", "PTMCMC", "PT"])
def test_factory_builds_parallel_tempering(bimodal, algo):
    cfg = Config({"General": {"FittingAlgorithm": algo, "MCMC": {"NSteps": 10, "NChains": 4},
                              "PT": {"NTemps": 3, "MaxTemp": 9.0, "SwapEvery": 2,
                                     "ScaleThrows": False, "BetaZero": True}}})
    f = make_fitter(cfg, bimodal, seed=1)
    assert isinstance(f, ParallelTempering) and isinstance(f.state, PTState)
    assert (f.config.n_temps, f.config.max_temp, f.config.swap_every) == (3, 9.0, 2)
    assert f.config.beta_zero and not f.config.scale_throws
    out = f.run(n_steps=10)
    assert out["theta"].shape == (10, 12, 1)


def test_cli_stores_cold_level_and_evidence(tmp_path):
    from mach3_tpu_torch.cli import mcmc as cli

    out = str(tmp_path / "chain.npz")
    args = ["Toy:NEvents:1500", "General:FittingAlgorithm:PT", "General:PT:NTemps:3",
            "General:PT:BetaZero:true", "General:PT:MaxTemp:16", "General:MCMC:NChains:4",
            "General:MCMC:NSteps:20", "General:MCMC:AutoSave:10", "--device", "cpu",
            "--stream", "off", "-o", out]
    assert cli.main(args) == 0
    draws, meta, _ = load_chain(out)
    assert draws["theta"].shape == (20, 4, 16)  # the cold level only
    assert draws["sample_nll"].shape == (20, 4)
    assert np.isfinite(meta["log_evidence"])
    _, _, ck = load_chain(out + ".ckpt")
    assert ck["st.theta"].shape == (12, 16) and int(ck["st.step"]) == 20
    # A resume runs the remaining steps and keeps the chain file's cold level.
    args2 = [a.replace("NSteps:20", "NSteps:30") for a in args] + ["--checkpoint", out + ".ckpt"]
    assert cli.main(args2) == 0
    draws2, meta2, _ = load_chain(out)
    assert draws2["theta"].shape == (30, 4, 16)
    np.testing.assert_array_equal(draws2["theta"][:20], draws["theta"])
    assert "log_evidence" in meta2
    json.dumps(meta2)
