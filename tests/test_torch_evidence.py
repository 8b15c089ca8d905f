"""The port's evidence estimators (``diagnostics/evidence.py``) against the
JAX package's, and parallel tempering's evidence against a closed form.

* Stepping-stone and thermodynamic estimates on the same random arrays and
  ladders: equal to 1e-12 (the same numpy code on the same inputs);
  ``log_prior_mass`` of the same priors read from the port's tensors: 1e-12.
* ``tests/test_evidence.py``'s linear-Gaussian fit (norm systematics, a
  Gaussian statistic) has a closed-form evidence; the port's β = 0 PT run
  reproduces it within the JAX test's gates (stepping-stone 0.5,
  thermodynamic 2.0), at a third of its length (1,000 steps).
"""
import numpy as np
import pytest
import torch

from mach3_tpu.core.config import Config as JConfig
from mach3_tpu.diagnostics import evidence as jevidence
from mach3_tpu.fitters.model import FitModel as JFitModel
from mach3_tpu.params.parameterset import ParameterSet as JParameterSet
from mach3_tpu.params.parameterset import ParamType as JParamType
from mach3_tpu.samples.events import EventData as JEventData
from mach3_tpu.samples.events import build_sample_model as jbuild_sample_model
from mach3_tpu.samples.events import match_norm_params as jmatch_norm_params
from mach3_tpu.samples.teststats import TestStatistic as JTestStatistic
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.core.config import Config
from mach3_tpu_torch.diagnostics import evidence
from mach3_tpu_torch.fitters.factory import make_fitter
from mach3_tpu_torch.fitters.tempering import ParallelTempering, PTConfig, pt_betas
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

N_PARAMS = 4
N_BINS = 8


def _config():
    systematics = []
    for i in range(N_PARAMS):
        syst = {
            "Names": {"FancyName": f"n{i}"}, "ParameterValues": {"PreFitValue": 1.0},
            "StepScale": {"MCMC": 0.8}, "Error": 0.10 + 0.02 * (i % 2),
            "ParameterBounds": [-3.0, 5.0], "Type": "Norm", "ParameterGroup": "Xsec",
            "Mode": [i],
        }
        if i + 1 < N_PARAMS:
            syst["Correlations"] = [{f"n{i+1}": 0.25}]
        if i > 0:
            syst.setdefault("Correlations", []).append({f"n{i-1}": 0.25})
        systematics.append({"Systematic": syst})
    return {"Systematics": systematics}


@pytest.fixture(scope="module")
def linear_fit():
    """(JAX model, the port's model, closed-form log Z, prior covariance):
    ``tests/test_evidence.py``'s fixture."""
    rng = np.random.default_rng(123)
    ps = JParameterSet.from_config(JConfig(_config()), name="xsec")
    n = 2000
    x = np.clip(rng.normal(1.0, 0.4, n), 0.05, 1.95)
    mode = rng.integers(0, N_PARAMS, n).astype(np.int32)
    ev = JEventData(kinematics={"x": x}, mode=mode, target=np.full(n, 12, np.int32),
                    pdg=np.full(n, 14, np.int32), preosc_pdg=np.full(n, 14, np.int32),
                    mc_weight=rng.uniform(0.5, 1.5, n) * 0.05)
    edges = np.linspace(0.0, 2.0, N_BINS + 1)
    norm_metas = [(m, m.index) for m in ps.of_type(JParamType.NORM)]
    sample = jbuild_sample_model(
        "lin", ev, var_order=["x"], binning_edges=[edges], binning_vars=["x"],
        n_total_params=N_PARAMS, norm_idx=jmatch_norm_params(ev, norm_metas, "lin"),
        test_statistic=JTestStatistic.GAUSSIAN)
    bins = np.digitize(x, edges) - 1
    a = np.zeros((N_BINS, N_PARAMS))
    np.add.at(a, (bins, mode), ev.mc_weight)
    theta_star = 1.0 + 0.2 * rng.normal(size=N_PARAMS)
    data = a @ theta_star
    jm = JFitModel.build([ps], [sample.with_data(data)])

    sigma2 = np.maximum(data, 1.0)
    c0 = np.asarray(ps.covariance)
    cov_d = np.diag(sigma2) + a @ c0 @ a.T
    r = data - a @ np.ones(N_PARAMS)
    _, logdet = np.linalg.slogdet(cov_d)
    mvn = -0.5 * (r @ np.linalg.solve(cov_d, r) + logdet + N_BINS * np.log(2 * np.pi))
    log_z = 0.5 * np.sum(np.log(2 * np.pi * sigma2)) + mvn
    return jm, from_jax_model(jm), float(log_z), c0


@pytest.mark.parametrize("shape", [(50, 4), (40, 6, 3), (30, 10, 8)])
def test_estimators_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    n_t = shape[1]
    betas = np.concatenate([np.geomspace(1.0, 0.01, n_t - 1), [0.0]])
    e = rng.gamma(3.0, 2.0, size=shape) + 5.0
    e[0, 1] = np.inf  # a non-finite draw is dropped
    for ours, theirs in ((evidence.stepping_stone_log_evidence,
                          jevidence.stepping_stone_log_evidence),
                         (evidence.thermodynamic_log_evidence,
                          jevidence.thermodynamic_log_evidence)):
        assert ours(e, betas) == pytest.approx(theirs(e, betas), rel=1e-12, abs=1e-12)
    with pytest.raises(ValueError):
        evidence.stepping_stone_log_evidence(e, betas[:-1])


def test_estimators_on_analytic_rungs():
    betas = np.array([1.0, 0.5, 0.25, 0.0])
    e = np.full((100, 4, 2), 3.7)
    assert evidence.stepping_stone_log_evidence(e, betas) == pytest.approx(-3.7, rel=1e-12)
    assert evidence.thermodynamic_log_evidence(e, betas) == pytest.approx(-3.7, rel=1e-12)


def test_log_prior_mass_matches_jax(linear_fit):
    jm, tm, _, c0 = linear_fit
    assert evidence.log_prior_mass(tm) == pytest.approx(jevidence.log_prior_mass(jm), rel=1e-12)
    _, logdet = np.linalg.slogdet(c0)
    assert evidence.log_prior_mass(tm) == pytest.approx(
        0.5 * N_PARAMS * np.log(2 * np.pi) + 0.5 * logdet, rel=1e-10)


def test_log_prior_mass_toy_matches_jax():
    """The toy has flat bounded priors (sin²θ23, δCP) beside Gaussian ones."""
    jt = jbuild_toy(n_events=500, seed=3, e_grid_size=20, use_pallas=False)
    tt = build_toy(n_events=500, seed=3, e_grid_size=20, device="cpu")
    assert evidence.log_prior_mass(tt.model) == pytest.approx(
        jevidence.log_prior_mass(jt.model), rel=1e-12)
    assert evidence.log_prior_mass(tt.model.flat) == evidence.log_prior_mass(tt.model)


def test_pt_evidence_matches_closed_form(linear_fit):
    _, model, log_z, _ = linear_fit
    init = 1.0 + 0.1 * np.random.default_rng(7).normal(size=(16, N_PARAMS))
    pt = ParallelTempering(model, PTConfig(n_steps=1000, chunk_size=500, n_temps=10,
                                           max_temp=300.0, beta_zero=True), init, seed=11)
    out = pt.run()
    ss = pt.log_evidence(out, method="stepping_stone")
    assert ss == pytest.approx(log_z, abs=0.5), (ss, log_z)
    ti = pt.log_evidence(out, method="thermodynamic")
    assert ti == pytest.approx(log_z, abs=2.0), (ti, log_z)
    raw = pt.log_evidence(out, method="stepping_stone", normalise_prior=False)
    assert raw - ss == pytest.approx(evidence.log_prior_mass(model), rel=1e-10)


def test_factory_beta_zero_key(linear_fit):
    _, model, _, _ = linear_fit
    cfg = Config({"General": {"FittingAlgorithm": "PT",
                              "MCMC": {"NSteps": 4, "AutoSave": 4, "NChains": 4},
                              "PT": {"NTemps": 4, "BetaZero": True, "MaxTemp": 16.0}}})
    pt = make_fitter(cfg, model)
    assert pt.config.beta_zero is True
    assert pt_betas(pt.config)[-1] == 0.0
    out = pt.run()
    assert np.isfinite(pt.log_evidence(out, burn_frac=0.0))


def test_log_evidence_requires_beta_zero(linear_fit):
    _, model, _, _ = linear_fit
    pt = ParallelTempering(model, PTConfig(n_steps=4, chunk_size=4, n_temps=4, max_temp=16.0),
                           np.ones((4, N_PARAMS)))
    out = pt.run()
    assert "sample_nll" in out
    with pytest.raises(ValueError, match="beta_zero"):
        pt.log_evidence(out)
