"""The port's posterior processing (``diagnostics/processor.py``,
``oscprocessor.py``, ``chaintools.py``, ``statutils.py``: numpy copies of the
JAX package's modules) against ``mach3_tpu/diagnostics`` on the same draws.
Both sides run the same numpy code, so every result is equal (tolerance 0),
the Gaussian fit (scipy's ``curve_fit``) included."""
import dataclasses

import numpy as np
import pytest
import torch

from mach3_tpu.diagnostics import chaintools as jct
from mach3_tpu.diagnostics import oscprocessor as josc
from mach3_tpu.diagnostics import processor as jproc
from mach3_tpu.diagnostics import statutils as jsu
from mach3_tpu_torch.diagnostics import chaintools as ct
from mach3_tpu_torch.diagnostics import oscprocessor as osc
from mach3_tpu_torch.diagnostics import processor as proc
from mach3_tpu_torch.diagnostics import statutils as su

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def draws():
    """[S, C, P] draws: Gaussian, skewed (gamma), bimodal and a narrow one."""
    rng = np.random.default_rng(0)
    s, c = 3000, 4
    return np.stack([rng.normal(1.0, 0.5, (s, c)), rng.gamma(2.0, 0.3, (s, c)),
                     np.where(rng.random((s, c)) < 0.3, -1.0, 1.5) + 0.2 * rng.normal(size=(s, c)),
                     rng.normal(0.0, 1e-3, (s, c))], axis=-1)


def _pair(d, **kw):
    names = ["a", "b", "c", "d"]
    return proc.ChainProcessor(d, names=names, **kw), jproc.ChainProcessor(d, names=names, **kw)


@pytest.mark.parametrize("kw", [dict(), dict(burn_in=100, thin=3), dict(burn_in=0.5)],
                         ids=["default", "int-burn-thin", "half"])
def test_chain_processor_matches_jax(draws, kw):
    p, j = _pair(draws, **kw)
    np.testing.assert_array_equal(p.flat, j.flat)
    assert p.burn_in == j.burn_in
    for i in range(4):
        assert dataclasses.asdict(p.summary(i)) == dataclasses.asdict(j.summary(i))
        for mass in (0.6827, 0.9545):
            assert p.credible_interval(i, mass) == j.credible_interval(i, mass)
        for a, b in zip(p.posterior_1d(i, bins=40), j.posterior_1d(i, bins=40)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p.covariance(), j.covariance())
    np.testing.assert_array_equal(p.correlation(), j.correlation())
    for a, b in zip(p.credible_region_2d(0, 2), j.credible_region_2d(0, 2)):
        np.testing.assert_array_equal(a, b)
    assert p.bayes_factor(2, (0, 5), (-5, 0)) == j.bayes_factor(2, (0, 5), (-5, 0))
    assert p.savage_dickey(0, 1.0, 0.4) == j.savage_dickey(0, 1.0, 0.4)


def test_reweight_and_thin_match_jax(draws):
    p, j = _pair(draws)

    def lw(t):
        return -0.5 * ((t[0] - 1.2) / 0.3) ** 2

    pr, jr = p.reweight(lw), j.reweight(lw)
    np.testing.assert_array_equal(pr.weights, jr.weights)
    assert dataclasses.asdict(pr.summary(0)) == dataclasses.asdict(jr.summary(0))
    pt, jt = p.thin(4), j.thin(4)
    np.testing.assert_array_equal(pt.flat, jt.flat)
    np.testing.assert_array_equal(pt.weights, jt.weights)


def test_osc_processor_matches_jax():
    rng = np.random.default_rng(1)
    n = 4000
    d = np.stack([rng.normal(0.307, 0.01, n), rng.normal(0.022, 0.001, n),
                  rng.normal(0.561, 0.04, n), rng.uniform(-np.pi, np.pi, n),
                  np.where(rng.random(n) < 0.7, 2.5e-3, -2.5e-3)], axis=1)
    names = ["osc_sin2th12", "osc_sin2th13", "osc_sin2th23", "osc_delta_cp", "osc_dm2_31"]
    p = osc.OscProcessor(d, names, burn_in=0)
    j = josc.OscProcessor(d, names, burn_in=0)
    for flat_sin in (False, True):
        a, b = p.jarlskog_analysis(flat_sin), j.jarlskog_analysis(flat_sin)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, f.name
    assert p.ordering_octant_table() == j.ordering_octant_table()
    np.testing.assert_array_equal(p.flat_sin_dcp_weights(), j.flat_sin_dcp_weights())
    args = [np.array([0.307]), np.array([0.022]), np.array([0.5]), np.array([np.pi / 2])]
    assert osc.jarlskog(*args)[0] == josc.jarlskog(*args)[0] == pytest.approx(0.033, abs=0.004)


def test_chaintools_match_jax():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(500, 6))
    a = rng.normal(size=(6, 6))
    inv_cov = a @ a.T + 6 * np.eye(6)
    prefit = rng.normal(size=6)
    groups = {"g1": [0, 2], "g2": [1, 3, 5]}
    pa = ct.penalty_terms(d, prefit, inv_cov, groups)
    pb = jct.penalty_terms(d, prefit, inv_cov, groups)
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
    for sig in ({1: 0.5, 4: 2.0}, np.linspace(0, 1, 6)):
        np.testing.assert_array_equal(ct.smear_chain(d, sig, seed=3), jct.smear_chain(d, sig, seed=3))
    for old, new in ((None, (0.1, 0.5)), ((0.0, 1.0), (0.3, 0.2)), ((0.0, 1.0), None)):
        np.testing.assert_array_equal(ct.reweight_to_new_prior(d, 2, old, new),
                                      jct.reweight_to_new_prior(d, 2, old, new))


def test_statutils_match_jax():
    rng = np.random.default_rng(3)
    for b in (0.5, 2.0, 5.0, 20.0, 50.0, 500.0, 1e4, 1e7):
        assert su.jeffreys_scale(b) == jsu.jeffreys_scale(b)
        assert su.dunne_kaboth_scale(b) == jsu.dunne_kaboth_scale(b)
    assert su.bic(123.4, 7, 1000) == jsu.bic(123.4, 7, 1000)
    mc, w2, data = rng.gamma(2.0, 5.0, 30), rng.gamma(2.0, 1.0, 30), rng.poisson(10.0, 30)
    mc[3], w2[3] = 0.0, 0.0
    np.testing.assert_array_equal(su.n_effective(mc, w2), jsu.n_effective(mc, w2))
    np.testing.assert_array_equal(su.barlow_beeston_beta(data, mc, w2),
                                  jsu.barlow_beeston_beta(data, mc, w2))
    assert su.bonferroni(0.02, 10) == jsu.bonferroni(0.02, 10)
    x = rng.normal(size=400)
    assert su.anderson_darling(x) == jsu.anderson_darling(x)
    assert su.runs_test(x) == jsu.runs_test(x)
    a = rng.normal(size=(5, 5))
    cov_a, cov_t = a @ a.T + np.eye(5), np.diag(rng.uniform(0.5, 2.0, 5))
    assert su.suboptimality(cov_a, cov_t) == jsu.suboptimality(cov_a, cov_t)
    p_, q_ = rng.random(20), rng.random(20)
    assert su.kl_divergence(p_, q_) == jsu.kl_divergence(p_, q_)
    pv = rng.random(8)
    assert su.fisher_combined_pvalue(pv) == jsu.fisher_combined_pvalue(pv)
