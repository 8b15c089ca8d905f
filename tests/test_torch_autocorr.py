"""The port's chain diagnostics (``diagnostics/autocorr.py``, torch f64)
against ``mach3_tpu/diagnostics/autocorr.py`` on the same f64 arrays, and
the properties ``tests/test_diagnostics.py`` checks on synthetic chains with
known autocorrelation. Every function agrees with JAX's within rtol 1e-10
(autocorrelations, which pass through zero, within 1e-12 absolute as well);
ESS taken in chunks of columns equals ESS taken at once."""
import numpy as np
import pytest
import torch

from mach3_tpu.diagnostics import autocorr as jac
from mach3_tpu_torch.diagnostics import autocorr as ac

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12
CPU = dict(device="cpu")


def _ar1(n, phi, size=1, seed=0):
    """AR(1) chain with known integrated autocorrelation time (1+phi)/(1-phi)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, size))
    e = rng.normal(size=(n, size))
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    return x


@pytest.fixture(scope="module")
def chains():
    """[S, C, P] chains: a random walk plus noise (long autocorrelation), an
    AR(1) block and a constant column; and a 2-D [S, P] chain."""
    rng = np.random.default_rng(0)
    x = 0.1 * np.cumsum(rng.normal(size=(900, 3, 4)), 0) + rng.normal(size=(900, 3, 4))
    x[:, :, 1] = _ar1(900, 0.7, size=3, seed=1)
    x[:, 2, 3] = 0.25
    return {"3d": x, "2d": _ar1(1500, 0.5, size=5, seed=2)}


def _t(x):
    return x.cpu().numpy()


@pytest.mark.parametrize("shape", ["3d", "2d"])
@pytest.mark.parametrize("fn", ["effective_sample_size", "geweke", "batched_means",
                                "batched_means_variance_ratio"])
def test_matches_jax(chains, shape, fn):
    x = chains[shape]
    got = _t(getattr(ac, fn)(x, **CPU))
    ref = np.asarray(getattr(jac, fn)(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", ["3d", "2d"])
@pytest.mark.parametrize("max_lag", [None, 37])
def test_autocorrelation_and_tau_match_jax(chains, shape, max_lag):
    x = chains[shape]
    rho = _t(ac.autocorrelation_fft(x, max_lag=max_lag, **CPU))
    ref = np.asarray(jac.autocorrelation_fft(x, max_lag=max_lag))
    np.testing.assert_allclose(rho, ref, rtol=RTOL, atol=ATOL)
    for c in (5.0, 3.0):
        tau = _t(ac.integrated_autocorr_time(torch.as_tensor(ref), c=c))
        np.testing.assert_allclose(tau, np.asarray(jac.integrated_autocorr_time(ref, c=c)),
                                   rtol=RTOL)


@pytest.mark.parametrize("shape", ["3d", "2d"])
def test_power_spectrum_matches_jax(chains, shape):
    f, p = ac.power_spectrum(chains[shape], **CPU)
    jf, jp = jac.power_spectrum(chains[shape])
    np.testing.assert_allclose(_t(f), np.asarray(jf), rtol=RTOL)
    np.testing.assert_allclose(_t(p), np.asarray(jp), rtol=RTOL, atol=ATOL * np.abs(jp).max())


def test_acceptance_trace_matches_jax():
    acc = np.random.default_rng(3).random((1234, 5)) < 0.3
    np.testing.assert_array_equal(ac.acceptance_rate_trace(acc, 50),
                                  jac.acceptance_rate_trace(acc, 50))


@pytest.mark.parametrize("chunk_bytes", [1, 16 * 2049 * 3, ac.CHUNK_BYTES])
def test_chunked_equals_unchunked(chains, chunk_bytes):
    """1 byte: one series a chunk; 16 x 2049 x 3: three columns (nfft 4096
    for 1,500 steps); the default: all at once."""
    x = chains["2d"]
    assert ac.series_per_chunk(1500, chunk_bytes) == {1: 1, 16 * 2049 * 3: 3}.get(
        chunk_bytes, ac.series_per_chunk(1500))
    whole = ac.integrated_autocorr_time(ac.autocorrelation_fft(x, **CPU))
    np.testing.assert_array_equal(_t(ac.effective_sample_size(x, chunk_bytes=chunk_bytes, **CPU)),
                                  _t(1500 / whole.clamp(min=1.0)))
    # Geweke's FFTs of the two windows in other batch sizes: last-bit rounding
    np.testing.assert_allclose(_t(ac.geweke(x, chunk_bytes=chunk_bytes, **CPU)),
                               _t(ac.geweke(x, **CPU)), rtol=1e-13)


def test_device_of_a_tensor_and_the_default():
    """A tensor chain stays on its device; an array goes to the card by
    default, which raises where there is none."""
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(200, 3)))
    assert ac.effective_sample_size(x).device == x.device
    assert ac.effective_sample_size(x).dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ac.effective_sample_size(x.numpy())


# ------------------------------------ properties (tests/test_diagnostics.py)
def test_autocorrelation_of_ar1():
    phi = 0.8
    rho = _t(ac.autocorrelation_fft(_ar1(200_000, phi), max_lag=20, **CPU))[:, 0]
    assert np.allclose(rho, phi ** np.arange(20), atol=0.03)


def test_ess_of_iid_is_n():
    x = np.random.default_rng(1).normal(size=(20_000, 3))
    assert np.all(_t(ac.effective_sample_size(x, **CPU)) > 0.8 * 20_000)


def test_ess_of_correlated_chain():
    ess = float(_t(ac.effective_sample_size(_ar1(100_000, 0.9, seed=2), **CPU))[0])
    assert ess == pytest.approx(100_000 / 19.0, rel=0.25)


def test_geweke_flags_nonstationarity():
    stat = np.random.default_rng(7).normal(size=(20_000, 1))
    assert abs(float(_t(ac.geweke(stat, **CPU))[0])) < 3.0
    burn = stat.copy()
    burn[:2000] += 4.0  # un-burned start
    assert abs(float(_t(ac.geweke(burn, **CPU))[0])) > 4.0


def test_batched_means_shape():
    x = np.random.default_rng(8).normal(size=(1000, 5))
    bm = _t(ac.batched_means(x, 10, **CPU))
    assert bm.shape == (10, 5)
    assert np.allclose(bm.mean(axis=0), x[:1000].mean(axis=0), atol=1e-10)


def test_power_spectrum_white_noise_flat():
    _, p = ac.power_spectrum(np.random.default_rng(9).normal(size=(4096, 1)), **CPU)
    p = _t(p)
    assert p[: len(p) // 4].mean() == pytest.approx(p[-len(p) // 4:].mean(), rel=0.2)


def test_ar1_tau_of_many_series():
    """Many AR(1) series at once (the envelope's ESS gate in small): the
    mean τ over the series within 3% of (1+φ)/(1-φ)."""
    phi = 0.6
    tau = 5000 / _t(ac.effective_sample_size(_ar1(5000, phi, size=400, seed=5), **CPU))
    assert tau.mean() == pytest.approx((1 + phi) / (1 - phi), rel=0.03)
