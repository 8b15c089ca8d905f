"""The port's reference-scale fixture (``tutorial/large.py``) vs the JAX
package's, at the CPU-test size of ``tests/test_large.py`` (4,000 / 1,500 /
3,000 events, energy grid 40, atmospheric grid 20 x 8), bf16 tables.

* Same fixture: the port draws the same numpy random numbers, so events,
  norm matches, spline tables and oscillation indices are equal before the
  shared route's event layout (both built on the plain route), exactly.
  The JAX side is built on the port's PREM paths (``jax_prem.py``: the port
  repairs the way up, which the JAX package's paths get wrong).
* Layout: the shared-route samples hold JAX's events reordered and padded
  with zero-weight copies; every plan lists exactly its tiles' active
  parameters (``test_torch_shared.py`` holds the helpers).
* Likelihood, built natively and by the bridge from JAX's Pallas-routed
  model (sorted and padded for JAX's own tile, laid out again by the port):
  - against JAX production (its XLA route, which rounds every response
    deviation to bf16 as its kernels do): histograms within 2e-3 relative
    (+1e-6·max), per-sample and total NLLs within 5e-3 + 1e-3·|NLL|, the
    budgets of ``test_torch_toy.py``;
  - against the f32 oracle built from JAX pieces (``eval_dense(exact=True)``,
    its oscillation grids, its f32 statistic): 1e-4 + 1e-5·|NLL| — f32 sums
    of a few hundred events per bin in another order, and the per-bin f32
    statistic of ``low_memory`` evaluated by two libraries.
  The largest gaps measured are written in ROADMAP Queue 3.
* Asimov data at prefit: the port's total NLL through its kernel route is 0
  to 1e-6, as ``tests/test_large.py`` asserts for JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_prem import repaired_paths

from mach3_tpu.fitters.model import FitModel as JFitModel
from mach3_tpu.samples.binning import histogram as jhistogram
from mach3_tpu.splines.eval import eval_dense as jeval_dense
from mach3_tpu.tutorial.large import build_large as jbuild_large
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.splines.monolith import dense_table_activity
from mach3_tpu_torch.tutorial.large import build_large

torch.set_num_threads(1)

SIZE = dict(n_numu=4000, n_nue=1500, n_atmo=3000, e_grid_size=40, atmo_e_grid_size=20,
            atmo_cosz_grid_size=8, low_memory=True, seed=7)
NAMES = ["numu_beam", "nue_beam", "atmo"]
PROD_BUDGET = 2e-3
NLL_PROD_ATOL, NLL_PROD_RTOL = 5e-3, 1e-3
NLL_ORACLE_ATOL, NLL_ORACLE_RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def port():
    return build_large(**SIZE, device="cpu")


@pytest.fixture(scope="module")
def port_plain():
    return build_large(**SIZE, use_kernel=False, asimov=False, device="cpu")


@pytest.fixture(scope="module")
def jax_plain():
    with repaired_paths():
        return jbuild_large(**SIZE, use_pallas=False, asimov=False)


@pytest.fixture(scope="module")
def jax_routed(port):
    """JAX's Pallas-routed (sorted, padded) model carrying the port's Asimov
    data, so both sides score the same observed histograms."""
    with repaired_paths():
        j = jbuild_large(**SIZE, use_pallas=True, asimov=False)
    samples = [s.with_data(t.data.numpy()) for s, t in zip(j.samples, port.samples)]
    return JFitModel.build([j.xsec, j.osc], samples)


def _thetas(model, n_chains=5, seed=0):
    """Prefit + 5% prior-sigma jitter inside the bounds; chain 0 at prefit."""
    flat = model._flat()
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + 0.05 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    th = np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    th[0] = np.asarray(flat.prefit)
    return th


@pytest.fixture(scope="module")
def reference(jax_routed):
    """JAX's numbers at the test chains: production histograms and NLLs
    (XLA route), f32-oracle NLLs, both from one set of JAX oscillation
    grids."""
    th = jnp.asarray(_thetas(jax_routed))
    grids_of = jax.jit(lambda s, t: jax.vmap(s.osc_prob_grids)(t))
    cache, out = {}, {}
    for i, s in enumerate(jax_routed.samples):
        g = jax_routed.osc_groups[i]
        if g not in cache:
            cache[g] = grids_of(jax_routed.samples[g], th)
        grids = cache[g]
        mc, w2 = jax.jit(lambda s, t, g: jax.vmap(s.reweight)(t, g))(s, th, grids)
        nll = jax.jit(lambda s, t, g: s.log_likelihood_batch_xla(t, g))(s, th, grids)
        out[s.name] = dict(mc=np.asarray(mc), w2=np.asarray(w2), nll=np.asarray(nll),
                           oracle=np.asarray(_oracle_nll(s, th, grids)))
    prior = np.asarray(jax.jit(lambda m, t: jax.vmap(m.prior_nll_breakdown)(t))(jax_routed, th))
    return np.array(th), out, prior  # writable: torch.from_numpy shares it


@jax.jit
def _oracle_nll(js, thetas, grids):
    """f32-oracle sample NLL [C] from JAX pieces: exact spline eval, the
    static bins or the shift formed in f32 as the kernels form it."""

    def one(theta, g):
        w = (js.mc_weight * js._norm_weights(theta)
             * jeval_dense(js.spline_table, theta, exact=True) * js._osc_weights(theta, g))
        if js.static_bins is not None:
            bins = js.static_bins
        else:
            row = js.shifts[0].var_row
            v = theta[js.shifts[0].param_index].astype(jnp.float32)
            bins = js.binning.find_bins(js.kin.at[row].set(js.kin[row] * (1.0 + v)))
        mc, w2 = jhistogram(w, bins, js.n_bins)
        return js._stat_sum(mc, w2)

    return jax.vmap(one)(thetas, grids)


def _eq(a, b):
    a = np.asarray(a)
    b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
    assert np.array_equal(a.astype(b.dtype), b)


@pytest.mark.parametrize("i", [0, 1, 2], ids=NAMES)
def test_build_large_same_fixture_before_layout(jax_plain, port_plain, i):
    js, ts = jax_plain.samples[i], port_plain.samples[i]
    assert js.name == ts.name == NAMES[i] and js.n_bins == ts.n_bins
    assert ts.kernel_route.variant == "xla" and ts.hist_plan_ptr is None
    for f in ("kin", "mc_weight", "norm_idx", "norm_s", "norm_applied"):
        _eq(getattr(js, f), getattr(ts, f))
    for f in ("coeffs", "knots_x", "n_knots", "param_index"):
        _eq(getattr(js.spline_table, f), getattr(ts.spline_table, f))
    assert ts.spline_table.coeffs.dtype == torch.bfloat16
    fields = (("event_flat_idx", "layer_lengths", "layer_rho", "rho_unique", "rho_idx")
              if NAMES[i] == "atmo" else ("e_grid", "event_grid_idx", "event_channel"))
    for f in fields + ("chan_alpha", "chan_beta", "chan_anti", "nc_mask", "osc_param_idx"):
        _eq(getattr(js.osc, f), getattr(ts.osc, f))
    if NAMES[i] == "atmo":
        assert ts.osc.z_groups == js.osc.z_groups and len(ts.osc.z_groups) > 1
    if js.static_bins is not None:
        _eq(js.static_bins, ts.static_bins)
    assert ts.stat_dtype == torch.float32


def test_build_large_same_priors(jax_plain, port):
    jf = jax_plain.model._flat()
    for f in ("prefit", "inv_cov", "chol", "step_scale", "low_bound", "up_bound"):
        _eq(getattr(jf, f), getattr(port.model.flat, f))
    assert port.model.n_params == 101 and port.names == jax_plain.names
    assert port.model.osc_groups == jax_plain.model.osc_groups == (0, 0, 2)


@pytest.mark.parametrize("i", [0, 2], ids=["numu_beam", "atmo"])
def test_shared_layout_keeps_the_events(port_plain, port, i):
    """The laid-out sample holds the plain build's events (reordered, with
    zero-weight pads), its table rows (parameters regrouped) and a plan that
    lists exactly each tile's active parameters."""
    ps, ks = port_plain.samples[i], port.samples[i]
    assert ks.kernel_route.variant == "shared" and ks.n_events % 256 == 0
    real = ks.mc_weight != 0
    assert int(real.sum()) == ps.n_events
    assert np.array_equal(_sorted_columns(ps.kin.numpy()), _sorted_columns(ks.kin[:, real].numpy()))
    assert torch.isclose(ps.mc_weight.double().sum(), ks.mc_weight.double().sum(), rtol=1e-12)
    perm = ks.spline_table.param_index.argsort()
    assert torch.equal(ks.spline_table.param_index[perm], ps.spline_table.param_index.sort().values)
    act = dense_table_activity(ks.spline_table)
    act[:, ~real.numpy()] = False
    ptr, idx = ks.hist_plan_ptr.numpy(), ks.hist_plan_idx.numpy()
    for t in range(len(ptr) - 1):
        listed = set(idx[ptr[t]:ptr[t + 1]].tolist())
        assert listed == set(np.flatnonzero(act[:, t * 256:(t + 1) * 256].any(1)).tolist())


def _sorted_columns(kin):
    return kin[:, np.lexsort(kin)]


def test_asimov_nll_zero_at_prefit(port):
    nll = port.model.total_nll_batch(port.model.prefit_vector()[None])
    assert abs(float(nll[0])) < 1e-6


def _check_nlls(model, reference):
    th, ref, prior = reference
    tables = model._shared_osc_tables(torch.from_numpy(th))
    total, t_prior, parts = model.total_nll_batch_parts(torch.from_numpy(th))
    np.testing.assert_allclose(t_prior.numpy(), prior, rtol=1e-12, atol=1e-12)
    for i, s in enumerate(model.samples):
        r = ref[s.name]
        mc, w2 = s.reweight_batch(torch.from_numpy(th), tables[i])
        for got, want in ((mc, r["mc"]), (w2, r["w2"])):
            np.testing.assert_allclose(got.numpy(), want, rtol=PROD_BUDGET,
                                       atol=1e-6 * np.abs(want).max(), err_msg=s.name)
        np.testing.assert_allclose(parts[:, i].numpy(), r["oracle"], rtol=NLL_ORACLE_RTOL,
                                   atol=NLL_ORACLE_ATOL, err_msg=s.name)
        np.testing.assert_allclose(parts[:, i].numpy(), r["nll"], rtol=NLL_PROD_RTOL,
                                   atol=NLL_PROD_ATOL, err_msg=s.name)
    want_total = prior.sum(1) + sum(r["nll"] for r in ref.values())
    np.testing.assert_allclose(total.numpy(), want_total, rtol=NLL_PROD_RTOL,
                               atol=3 * NLL_PROD_ATOL)


def test_nll_native_matches_jax(port, reference):
    assert [s.kernel_route.variant for s in port.model.samples] == ["shared", "shifted", "shared"]
    _check_nlls(port.model, reference)


def test_nll_bridged_matches_jax(jax_routed, reference):
    model = from_jax_model(jax_routed)
    assert [s.kernel_route.variant for s in model.samples] == ["shared", "shifted", "shared"]
    assert all(s.n_events % 256 == 0 for s in model.samples if s.hist_plan_ptr is not None)
    _check_nlls(model, reference)


def test_kernel_route_matches_plain_route(port):
    """The shared/shifted routes (plain versions on the CPU) and the plain
    route of the same model agree to f32 summation order."""
    th = torch.from_numpy(_thetas_port(port.model))
    tables = port.model._shared_osc_tables(th)
    for i, s in enumerate(port.model.samples):
        a = s.log_likelihood_batch(th, tables[i])
        b = s._stat_sum(*s.reweight_batch_plain(th, tables[i]))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6, err_msg=s.name)


def _thetas_port(model, n_chains=4):
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).numpy()
    th = flat.prefit.numpy() + 0.05 * sig * np.random.default_rng(3).normal(
        size=(n_chains, len(sig)))
    lo, hi = flat.low_bound.numpy(), flat.up_bound.numpy()
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
