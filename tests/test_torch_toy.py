"""The port's toy, bridge, likelihood and MR2T2 step vs the JAX package.

* Same fixture: the port's ``build_toy`` draws the same numpy random numbers
  as JAX's, so events, tables and indices are equal; the Asimov data agree
  within the production budget (JAX's build evaluates splines with bf16
  deviations, the port in f32).
* Bridge: per-chain NLL parts of JAX's toy through the port. The prior is
  the same f64 arithmetic (rtol 1e-12). The sample NLLs are held to the f32
  oracle NLL (JAX pieces, ``eval_dense(exact=True)``) within
  1e-4 + 1e-6·|NLL|: histogram bins hold ~1e5 weighted events, f32 sums of
  them differ by ~1e-7 relative, which moves a near-prefit NLL by ~1e-5. To
  JAX's production (Pallas, interpret mode) NLLs the budget is
  5e-3 + 1e-3·|NLL|: its bf16 response rounding moves the histograms by up
  to ~8e-4 relative here, and the NLLs by up to ~5e-4.
* One MR2T2 step in lockstep: the draws of JAX's key splits
  (``mcmc.py:246``, ``state.py:172-183``) are injected into the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.fitters.mcmc import ChainState as JChainState
from mach3_tpu.fitters.mcmc import MCMCConfig as JMCMCConfig
from mach3_tpu.fitters.mcmc import make_step_fn_args as jmake_step
from mach3_tpu.params.state import propose_step_batch as jpropose
from mach3_tpu.samples.binning import histogram as jhistogram
from mach3_tpu.splines import pallas_reweight as pr
from mach3_tpu.splines.eval import eval_dense as jeval_dense
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.fitters.mcmc import MR2T2, ChainState, MCMCConfig, make_step_fn_args
from mach3_tpu_torch.params.state import propose_step_batch
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

TOY = dict(n_events=1500, seed=11, e_grid_size=30, flip_hierarchy=True)
PROD_BUDGET = 2e-3  # histogram-level f32-vs-bf16 budget (test_torch_reweight.py)
NLL_ORACLE_ATOL, NLL_ORACLE_RTOL = 1e-4, 1e-6
NLL_PROD_ATOL, NLL_PROD_RTOL = 5e-3, 1e-3


@pytest.fixture(scope="module")
def jtoy():
    return jbuild_toy(**TOY, use_pallas=True)


@pytest.fixture(scope="module")
def ttoy():
    return build_toy(**TOY, device="cpu")


@pytest.fixture()
def interp(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    pr.fused_reweight_histogram_shifted.clear_cache()
    yield
    pr.fused_reweight_histogram_shifted.clear_cache()


def _thetas(model, n_chains=6, seed=0):
    """Prefit + 5% prior-sigma jitter inside the bounds; chain 0 sits at
    prefit, chain 1 near the delta_cp circular bound (index 13)."""
    flat = model._flat()
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + 0.05 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    th = np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    th[0] = np.asarray(flat.prefit)
    th[1, 13] = 3.1
    return th


def _eq(a, b):
    assert np.array_equal(np.asarray(a), b.cpu().numpy())


@pytest.mark.parametrize("i", [0, 1], ids=["numu", "nue"])
def test_build_toy_same_fixture(jtoy, ttoy, i):
    js, ts = jtoy.samples[i], ttoy.samples[i]
    assert js.name == ts.name and js.n_bins == ts.n_bins
    assert ts.kernel_route.variant == js.kernel_route.variant == "shifted"
    _eq(js.kin, ts.kin)
    _eq(js.mc_weight, ts.mc_weight)
    _eq(js.norm_idx, ts.norm_idx)
    _eq(js.norm_s, ts.norm_s)
    _eq(js.norm_applied, ts.norm_applied)
    _eq(js.shift_static_base, ts.shift_static_base)
    assert np.array_equal(np.asarray(js.kernel_shift[2], np.float32), ts.shift_edges.numpy())
    _, j_param, _, j_stride, j_axis = js.kernel_shift
    assert ts.kernel_shift == ("scale", j_param, j_stride, j_axis)
    for f in ("coeffs", "knots_x", "n_knots", "param_index"):
        _eq(getattr(js.spline_table, f), getattr(ts.spline_table, f))
    for f in ("e_grid", "event_grid_idx", "event_channel", "chan_alpha", "chan_beta",
              "chan_anti", "nc_mask", "osc_param_idx"):
        _eq(getattr(js.osc, f), getattr(ts.osc, f))
    _eq(js.binning.edges, ts.binning.edges)
    data_j = np.asarray(js.data)
    np.testing.assert_allclose(ts.data.numpy(), data_j, rtol=PROD_BUDGET,
                               atol=1e-6 * np.abs(data_j).max())


def test_build_toy_same_priors(jtoy, ttoy):
    jf = jtoy.model._flat()
    for f in ("prefit", "inv_cov", "chol", "step_scale", "low_bound", "up_bound", "flat_prior",
              "fixed", "circ_mask", "circ_low", "circ_high", "flip_mask", "flip_point"):
        _eq(getattr(jf, f), getattr(ttoy.model.flat, f))
    assert ttoy.model.slices == jtoy.model.slices
    assert ttoy.model.osc_groups == jtoy.model.osc_groups == (0, 0)
    assert ttoy.names == jtoy.names


def _oracle_nll(js, thetas, grids):
    """f32-oracle sample NLL [C] from JAX pieces: exact spline eval, the
    shift formed in f32 as the kernels form it."""
    row = js.shifts[0].var_row

    def one(theta, g):
        w = (js.mc_weight * js._norm_weights(theta)
             * jeval_dense(js.spline_table, theta, exact=True) * js._osc_weights(theta, g))
        v = theta[js.shifts[0].param_index].astype(jnp.float32)
        kin = js.kin.at[row].set(js.kin[row] * (1.0 + v))
        mc, w2 = jhistogram(w, js.binning.find_bins(kin), js.n_bins)
        return js._stat_sum(mc, w2)

    return jax.vmap(one)(thetas, grids)


def test_bridge_nll_parts(jtoy, interp):
    th = _thetas(jtoy.model)
    jm = jtoy.model
    j_total, j_prior, j_samples = jax.jit(lambda m, t: m.total_nll_batch_parts(t))(
        jm, jnp.asarray(th))
    grids = jax.vmap(jm.samples[0].osc_prob_grids)(jnp.asarray(th))
    oracle = np.stack([np.asarray(_oracle_nll(s, jnp.asarray(th), grids)) for s in jm.samples], 1)

    tm = from_jax_model(jm)
    assert [s.kernel_route.variant for s in tm.samples] == ["shifted", "shifted"]
    total, prior, samples = tm.total_nll_batch_parts(torch.from_numpy(th))
    assert total.shape == (6,) and prior.shape == (6, 2) and samples.shape == (6, 2)
    np.testing.assert_allclose(prior.numpy(), np.asarray(j_prior), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(samples.numpy(), oracle, rtol=NLL_ORACLE_RTOL, atol=NLL_ORACLE_ATOL)
    np.testing.assert_allclose(samples.numpy(), np.asarray(j_samples),
                               rtol=NLL_PROD_RTOL, atol=NLL_PROD_ATOL)
    np.testing.assert_allclose(total.numpy(), np.asarray(j_total),
                               rtol=NLL_PROD_RTOL, atol=2 * NLL_PROD_ATOL)


def test_mr2t2_step_lockstep(jtoy, interp):
    jm = jtoy.model
    th = _thetas(jm, n_chains=8, seed=1)
    nll0 = jax.jit(lambda m, t: m.total_nll_batch(t))(jm, jnp.asarray(th))
    key = jax.random.key(123)
    jstate = JChainState(theta=jnp.asarray(th), nll=nll0, key=key,
                         step=jnp.asarray(0, jnp.int32),
                         n_accepted=jnp.zeros(8, jnp.int32))
    jnew, jout = jax.jit(jmake_step(JMCMCConfig()))(jm, jstate)

    # JAX's draws, by its own key splits
    _, k_prop, k_acc = jax.random.split(key, 3)
    key_norm, key_flip = jax.random.split(k_prop)
    n_par = th.shape[1]
    z = np.array(jax.random.normal(key_norm, (8, n_par), dtype=jnp.float64))
    flip_u = np.array(jax.random.uniform(key_flip, (8, n_par)))
    u_acc = np.array(jax.random.uniform(k_acc, (8,), dtype=jnp.float64))
    j_prop = np.asarray(jpropose(jm._flat(), jnp.asarray(th), k_prop))

    tm = from_jax_model(jm)
    t_prop = propose_step_batch(tm.flat, torch.from_numpy(th), z=torch.from_numpy(z),
                                flip_u=torch.from_numpy(flip_u)).numpy()
    np.testing.assert_allclose(t_prop, j_prop, rtol=0, atol=1e-12)
    assert (np.sign(t_prop[:, 15]) != np.sign(th[:, 15])).any()  # a mass-ordering flip

    tstate = ChainState(theta=torch.from_numpy(th), nll=tm.total_nll_batch(torch.from_numpy(th)),
                        generator=torch.Generator(), step=0,
                        n_accepted=torch.zeros(8, dtype=torch.int32))
    tnew, tout = make_step_fn_args(MCMCConfig(record_breakdown=True))(
        tm, tstate, z=torch.from_numpy(z), flip_u=torch.from_numpy(flip_u),
        u_acc=torch.from_numpy(u_acc))
    t_nll_prop = tout["prior_nll_parts"].sum(1) + tout["sample_nll_parts"].sum(1)
    j_nll_prop, _, _ = jax.jit(lambda m, t: m.total_nll_batch_parts(t))(jm, jnp.asarray(j_prop))
    np.testing.assert_allclose(t_nll_prop.numpy(), np.asarray(j_nll_prop),
                               rtol=NLL_PROD_RTOL, atol=2 * NLL_PROD_ATOL)
    clear = np.abs(u_acc - np.asarray(jout["acc_prob"])) > 1e-6
    assert clear.sum() >= 6
    accepted = tout["accepted"].numpy()
    assert np.array_equal(accepted[clear], np.asarray(jout["accepted"])[clear])
    assert tnew.step == 1 and int(tnew.n_accepted.sum()) == int(accepted.sum())
    np.testing.assert_allclose(tnew.theta.numpy()[clear], np.asarray(jnew.theta)[clear],
                               rtol=0, atol=1e-12)


def test_mr2t2_short_run(ttoy):
    """50 steps x 16 chains from the port's own toy and generator, throws at
    0.2 of the prior scale (the toy's prior-scale throws are accepted ~2% of
    the time here): finite, and the chains move."""
    model = build_toy(**{**TOY, "n_events": 600}, device="cpu").model
    model.flat.step_scale.mul_(0.2)
    init = _thetas_port(model, 16)
    fitter = MR2T2(model, MCMCConfig(chunk_size=25), init, seed=3)
    seen = []
    out = fitter.run(50, callback=lambda done, state, chunk: seen.append(done))
    assert seen == [25, 50]
    assert out["theta"].shape == (50, 16, 16) and out["step_time"].shape == (50,)
    assert np.isfinite(out["nll"]).all() and np.isfinite(out["theta"]).all()
    acc = out["accepted"].mean()
    assert 0.05 < acc < 0.95
    np.testing.assert_allclose(fitter.acceptance_rate.mean(), acc)


def _thetas_port(model, n_chains):
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).numpy()
    lo, hi = flat.low_bound.numpy(), flat.up_bound.numpy()
    th = flat.prefit.numpy() + 0.05 * sig * np.random.default_rng(0).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
