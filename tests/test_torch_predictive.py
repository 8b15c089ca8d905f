"""The port's posterior predictive (``diagnostics/predictive.py``) against
``mach3_tpu/diagnostics/predictive.py``.

The JAX package vmaps one toy at a time through its single-chain XLA
reweight; the port puts the toys on the chain axis of each sample's batched
route (its plain version on the CPU). The models are those of the JAX tests
(``tests/test_aux.py:212-305``) and a small toy, carried across by
``bridge.from_jax_model``; JAX's per-toy Poisson draws (``res.fluctuated``)
and its battery's draws (recomputed from its spectra with
``np.random.default_rng(seed + 1)``, as it draws them) are injected.
Tolerances: spectra and by-mode spectra within the histogram budget 2e-3
relative (+1e-6 of the largest bin); every NLL (``llh_data``, ``llh_draw``,
the battery's) within 5e-3 + 1e-3·|NLL|, and the rate-only NLLs within
that plus the histogram budget of each sample's total rate μ times the
slope |1 − N/μ| of its Poisson -logL (a rate NLL moves by about that much
per event of μ, and μ reaches thousands); a p-value's indicator equal on
every toy whose two NLLs differ by more than twice that budget; per-bin
p-values equal (they read only the injected draws and the data).
"""
import numpy as np
import pytest
import torch

from mach3_tpu.diagnostics import predictive as jpred
from mach3_tpu.fitters import FitModel as JFitModel
from mach3_tpu.params.parameterset import ParameterSet as JParameterSet
from mach3_tpu.samples.events import EventData as JEventData
from mach3_tpu.samples.events import build_sample_model as jbuild_sample_model
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.diagnostics import predictive
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

HIST_RTOL, HIST_ATOL_FRAC = 2e-3, 1e-6
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3
BATTERY = ("llh_fluctpred_vs_draw", "llh_data_vs_fluctdraw", "llh_fluctdata_vs_draw",
           "llh_fluctdraw_vs_pred", "llh_rate_data", "llh_rate_fluct")


def _simple_ps():
    return JParameterSet.from_config({"Systematics": [
        {"Systematic": {"Names": {"FancyName": n}, "ParameterValues": {"PreFitValue": 1.0},
                        "StepScale": {"MCMC": 1.0}, "Error": 0.1, "ParameterBounds": [0, 2],
                        "Type": "Norm"}}
        for n in ["a", "b"]]})


def _jax_norm_model(seed: int, modes: bool, data_scale: float = 1.0):
    """The JAX tests' one-sample model (2,000 events, x ~ N(1, 0.4), 10
    bins, one norm scaling every event), Asimov data at θ = (1, 1) times
    ``data_scale``; with ``modes`` three random interaction modes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n = 2000
    mode = rng.integers(0, 3, size=n).astype(np.int32) if modes else np.zeros(n, np.int32)
    ev = JEventData(kinematics={"x": rng.normal(1.0, 0.4, n)}, mode=mode,
                    target=np.full(n, 12, np.int32), pdg=np.full(n, 14, np.int32),
                    preosc_pdg=np.full(n, 14, np.int32), mc_weight=np.full(n, 0.1))
    sm = jbuild_sample_model("s", ev, var_order=["x"], binning_edges=[np.linspace(0, 2, 11)],
                             binning_vars=["x"], n_total_params=2,
                             norm_idx=np.zeros((n, 1), np.int64))
    sm = sm.with_data(sm.asimov_data(jnp.asarray([1.0, 1.0])))
    if data_scale != 1.0:
        sm = sm.with_data(np.asarray(sm.data) * data_scale)
    return JFitModel.build([_simple_ps()], [sm]), mode, rng


def _battery_draws(jres, jmodel, n_toys: int, seed: int):
    """The battery's (fluctuated predictive, fluctuated data) draws of the
    JAX run, recomputed as it draws them from its returned spectra."""
    npr = np.random.default_rng(seed + 1)
    fp, fd = [], []
    for i, s in enumerate(jmodel.samples):
        pred = jres.spectra[i].mean(axis=0)
        data = np.asarray(s.data)
        fp.append(npr.poisson(np.maximum(pred, 0.0)[None, :].repeat(n_toys, 0)))
        fd.append(npr.poisson(np.maximum(data, 0.0)[None, :].repeat(n_toys, 0)))
    return fp, fd


def _nll_tol(ref, extra=0.0):
    return NLL_ATOL + NLL_RTOL * np.abs(ref) + extra


def _rate_tol(jres, jmodel, fluct: bool):
    """The rate-only NLLs' extra tolerance [T]: each sample's total rate μ
    moved by the histogram budget, through the slope |1 − N/μ| of the
    Poisson -logL of its count N (the data's total, or the draw's)."""
    out = 0.0
    for i, s in enumerate(jmodel.samples):
        mu = jres.spectra[i].sum(1).astype(np.float64)
        n = jres.fluctuated[i].sum(1) if fluct else float(np.asarray(s.data).sum())
        out = out + np.abs(1.0 - n / mu) * HIST_RTOL * mu
    return out


def _nll_close(got, ref, what, extra=0.0):
    gap = np.abs(got - ref)
    tol = _nll_tol(ref, extra)
    assert np.all(gap <= tol), f"{what}: worst {np.max(gap / tol):.3f} of the budget"


def _indicator_equal(got_a, got_b, ref_a, ref_b, what, extra=0.0):
    """(a > b) equal to JAX's on every toy whose margin exceeds the budget."""
    margin = np.abs(ref_a - ref_b) > 2 * _nll_tol(ref_b, extra)
    assert margin.sum() > 0.5 * len(margin), what
    np.testing.assert_array_equal((got_a > got_b)[margin], (ref_a > ref_b)[margin], what)


def _hist_close(got, ref, what):
    ref = np.asarray(ref, np.float64)
    tol = HIST_RTOL * np.abs(ref) + HIST_ATOL_FRAC * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= tol), what


def _against_jax(jmodel, toys, seed, categories=None, chunk=None):
    jres = jpred.run_predictive(jmodel, toys, seed=seed, categories=categories)
    model = from_jax_model(jmodel, device="cpu")
    res = predictive.run_predictive(
        model, toys, seed=seed, chunk=chunk, categories=categories, draws=jres.fluctuated,
        battery_draws=_battery_draws(jres, jmodel, len(toys), seed))
    for i in range(len(jmodel.samples)):
        _hist_close(res.spectra[i], jres.spectra[i], f"spectra {i}")
        np.testing.assert_array_equal(res.fluctuated[i], jres.fluctuated[i])
        np.testing.assert_array_equal(res.p_value_per_bin[i], jres.p_value_per_bin[i])
        if categories is not None:
            assert res.spectra_by_mode[i].shape == jres.spectra_by_mode[i].shape
            _hist_close(res.spectra_by_mode[i], jres.spectra_by_mode[i], f"by mode {i}")
    _nll_close(res.llh_data, jres.llh_data, "llh_data")
    _nll_close(res.llh_draw, jres.llh_draw, "llh_draw")
    _indicator_equal(res.llh_draw, res.llh_data, jres.llh_draw, jres.llh_data, "p_value")
    rate = {"llh_rate_data": _rate_tol(jres, jmodel, False),
            "llh_rate_fluct": _rate_tol(jres, jmodel, True)}
    for k in BATTERY:
        _nll_close(getattr(res, k), getattr(jres, k), k, rate.get(k, 0.0))
    _indicator_equal(res.llh_fluctpred_vs_draw, res.llh_data, jres.llh_fluctpred_vs_draw,
                     jres.llh_data, "p_value_fluct_pred")
    _indicator_equal(res.llh_fluctdata_vs_draw, res.llh_data, jres.llh_fluctdata_vs_draw,
                     jres.llh_data, "p_value_fluct_data")
    _indicator_equal(res.llh_rate_fluct, res.llh_rate_data, jres.llh_rate_fluct,
                     jres.llh_rate_data, "p_value_rate",
                     rate["llh_rate_data"] + rate["llh_rate_fluct"])
    np.testing.assert_allclose(res.llh_data_per_sample.sum(1), res.llh_data, rtol=1e-12)
    return res, jres, model


@pytest.mark.parametrize("data_scale", [1.0, 1.5], ids=["asimov", "data-x1.5"])
def test_calibration_model_matches_jax(data_scale):
    """``tests/test_aux.py::test_predictive_pvalue_calibrated``'s model and
    toys (200, seed 1), Asimov and with the data x 1.5."""
    jmodel, _, rng = _jax_norm_model(3, modes=False, data_scale=data_scale)
    toys = np.tile(np.array([1.0, 1.0]), (200, 1)) + 0.02 * rng.normal(size=(200, 2))
    res, jres, _ = _against_jax(jmodel, toys, seed=1, chunk=64)
    if data_scale == 1.0:
        assert 0.3 < res.p_value <= 1.0
    else:
        assert res.p_value < 0.1


def test_by_mode_model_matches_jax():
    """``test_predictive_by_mode_and_per_bin``'s model: three modes, 100
    toys, seed 2; the by-mode spectra sum to the spectra."""
    jmodel, modes, rng = _jax_norm_model(9, modes=True)
    toys = np.tile(np.array([1.0, 1.0]), (100, 1)) + 0.02 * rng.normal(size=(100, 2))
    res, _, _ = _against_jax(jmodel, toys, seed=2, categories=[modes])
    assert res.spectra_by_mode[0].shape == (100, 3, 10)
    np.testing.assert_allclose(res.spectra_by_mode[0].sum(1), res.spectra[0], rtol=1e-5)


@pytest.fixture(scope="module")
def toy_pair():
    jtoy = jbuild_toy(n_events=3000, seed=5, e_grid_size=30)
    rng = np.random.default_rng(4)
    prefit = np.asarray(jtoy.model.prefit_vector())
    sig = np.sqrt(np.diag(np.asarray(jtoy.model.flat.chol) @ np.asarray(jtoy.model.flat.chol).T))
    chain = prefit + 0.3 * sig * rng.normal(size=(40, 6, len(prefit)))
    toys = predictive.draw_parameter_sets(chain, 96, np.random.default_rng(8))
    return jtoy, toys


def test_toy_matches_jax_across_chunks(toy_pair):
    """The small toy (two samples on the shifted route, laid out) with its
    interaction modes as categories: in chunks of 40 (three chunks for 96
    toys) against JAX, then equal to one chunk."""
    jtoy, toys = toy_pair
    res, jres, model = _against_jax(jtoy.model, toys, seed=3, categories=jtoy.event_modes,
                                    chunk=40)
    assert [s.kernel_route.variant for s in model.samples] == ["shifted", "shifted"]
    assert res.chunk == 40
    one = predictive.run_predictive(
        model, toys, seed=3, categories=jtoy.event_modes, draws=jres.fluctuated,
        battery_draws=_battery_draws(jres, jtoy.model, len(toys), 3))
    assert one.chunk >= len(toys)
    for a, b in zip(res.spectra + res.spectra_by_mode, one.spectra + one.spectra_by_mode):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
    for k in ("llh_data", "llh_draw") + BATTERY:
        np.testing.assert_allclose(getattr(res, k), getattr(one, k), rtol=1e-9)


def test_draw_parameter_sets_equal(toy_pair):
    jtoy, _ = toy_pair
    chain = np.random.default_rng(1).normal(size=(50, 4, 16))
    a = predictive.draw_parameter_sets(chain, 30, np.random.default_rng(2), burn_in=0.3)
    b = jpred.draw_parameter_sets(chain, 30, np.random.default_rng(2), burn_in=0.3)
    np.testing.assert_array_equal(a, b)


def test_by_mode_does_not_depend_on_the_layout():
    """The same toy laid out for the shifted kernel and not laid out (the
    plain route): by-mode spectra, spectra and NLLs alike within f32
    summation order."""
    kw = dict(n_events=2500, seed=6, e_grid_size=30, device="cpu")
    laid, plain = build_toy(**kw), build_toy(**kw, use_kernel=False)
    assert laid.model.samples[0].event_perm is not None
    assert plain.model.samples[0].event_perm is None
    toys = laid.model.prefit_vector().numpy() + 0.01 * np.random.default_rng(0).normal(
        size=(20, laid.model.n_params))
    a = predictive.run_predictive(laid.model, toys, seed=1, categories=laid.event_modes)
    b = predictive.run_predictive(plain.model, toys, seed=1, categories=plain.event_modes)
    for x, y in zip(a.spectra_by_mode + a.spectra, b.spectra_by_mode + b.spectra):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6 * np.abs(y).max())
    np.testing.assert_allclose(a.llh_data, b.llh_data, rtol=1e-6)


def test_own_draws_seeded_and_calibrated():
    """Without injection: the same seed gives the same draws, another seed
    others; the JAX test's calibration holds on the port's own draws
    (Asimov p in (0.3, 1], data x 1.5 below 0.1)."""
    jmodel, _, rng = _jax_norm_model(3, modes=False)
    toys = np.tile(np.array([1.0, 1.0]), (200, 1)) + 0.02 * rng.normal(size=(200, 2))
    model = from_jax_model(jmodel, device="cpu")
    a = predictive.run_predictive(model, toys, seed=1)
    b = predictive.run_predictive(model, toys, seed=1)
    c = predictive.run_predictive(model, toys, seed=2)
    np.testing.assert_array_equal(a.fluctuated[0], b.fluctuated[0])
    np.testing.assert_array_equal(a.llh_fluctpred_vs_draw, b.llh_fluctpred_vs_draw)
    assert not np.array_equal(a.fluctuated[0], c.fluctuated[0])
    # Poisson: mean and variance of (draw - mc) over toys and bins
    d = a.fluctuated[0] - a.spectra[0]
    assert abs(d.mean()) < 0.1 * np.sqrt(a.spectra[0].mean())
    assert d.var() / a.spectra[0].mean() == pytest.approx(1.0, abs=0.1)
    assert 0.3 < a.p_value <= 1.0
    bad, _, _ = _jax_norm_model(3, modes=False, data_scale=1.5)
    assert predictive.run_predictive(from_jax_model(bad, device="cpu"), toys, seed=1).p_value < 0.1


def test_injection_shapes_checked():
    jmodel, _, _ = _jax_norm_model(3, modes=False)
    model = from_jax_model(jmodel, device="cpu")
    toys = np.ones((5, 2))
    with pytest.raises(ValueError, match="draws"):
        predictive.run_predictive(model, toys, draws=[np.zeros((4, 10))])
    with pytest.raises(ValueError, match="categories"):
        predictive.run_predictive(model, toys, categories=[np.zeros(2000), np.zeros(2000)])
