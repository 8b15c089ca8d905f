"""The analysis path on the card: the posterior predictive through the
reweight kernels against the plain route, and the chain diagnostics on the
device against numpy in f64.

Every test here needs a CUDA device and nvcc and skips without one; the file
imports no jax, so it runs on the card's machine. Tolerances: spectra as the
forward kernels are held (rtol 2e-5, atol 1e-6 of the largest bin), the
NLLs through each bin's statistic moved by that much (+1e-4), ESS, Geweke
and batched means within 1e-9 relative of numpy.
"""
import numpy as np
import pytest
import torch

from mach3_tpu_torch.diagnostics import autocorr
from mach3_tpu_torch.diagnostics.predictive import run_predictive
from mach3_tpu_torch.kernels.launch import LAUNCHES
from mach3_tpu_torch.samples.teststats import get_test_stat_fn
from mach3_tpu_torch.tutorial.toy import build_toy

K_RTOL, K_ATOL_FRAC, NLL_ATOL = 2e-5, 1e-6, 1e-4


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the reweight kernels have no CPU mode)")
    return torch.device("cuda")


def _nll_tol(sample, mc):
    """[T] NLL tolerance: each bin's statistic moved by the histogram
    tolerance of mc (either sign; w2 taken as mc), summed over bins."""
    stat = get_test_stat_fn(sample.test_statistic)
    mc = torch.as_tensor(mc, dtype=torch.float64)
    data = sample.data.cpu()
    tol = K_RTOL * mc.abs() + K_ATOL_FRAC * mc.abs().max()
    base = stat(data, mc, mc)
    moved = [(stat(data, mc + sgn * tol, mc) - base).abs() for sgn in (1, -1)]
    return (torch.maximum(*moved).sum(-1) + NLL_ATOL).numpy()


def _toys(model, n, seed=0):
    flat = model.flat
    sig = np.sqrt(np.diag((flat.chol @ flat.chol.T).cpu().numpy()))
    th = flat.prefit.cpu().numpy() + 0.1 * sig * np.random.default_rng(seed).normal(
        size=(n, len(sig)))
    lo, hi = flat.low_bound.cpu().numpy(), flat.up_bound.cpu().numpy()
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 300], ids=["one-chunk", "chunks-of-300"])
def test_predictive_kernel_route_vs_plain(cuda_device, chunk):
    """1,000 toys of the 20,000-event toy: K1 once per sample and chunk,
    spectra and NLLs against the same toys on the plain route (the toy
    built without a kernel, not laid out), the same draws injected; the
    by-mode spectra (plain ops on either build) sum to the spectra."""
    kw = dict(n_events=20_000, seed=3, e_grid_size=60, device=cuda_device)
    toy, plain = build_toy(**kw), build_toy(**kw, use_kernel=False)
    toys = _toys(toy.model, 1000)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    res = run_predictive(toy.model, toys, seed=2, chunk=chunk, categories=toy.event_modes)
    n_chunks = -(-1000 // res.chunk)
    assert LAUNCHES["reweight_shifted"] == 2 * n_chunks
    ref = run_predictive(plain.model, toys, seed=2, chunk=chunk, categories=plain.event_modes,
                         draws=res.fluctuated)
    for got, want in zip(res.spectra, ref.spectra):
        tol = K_RTOL * np.abs(want) + K_ATOL_FRAC * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol)
    for got, want in zip(res.spectra_by_mode, ref.spectra_by_mode):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    for bym, spec in zip(res.spectra_by_mode, res.spectra):
        np.testing.assert_allclose(bym.sum(1), spec, rtol=K_RTOL, atol=K_ATOL_FRAC * spec.max())
    for i, s in enumerate(toy.model.samples):
        gap = np.abs(res.llh_data_per_sample[:, i] - ref.llh_data_per_sample[:, i])
        assert np.all(gap <= _nll_tol(s, ref.spectra[i]))
    with torch.no_grad():
        parts = toy.model.total_nll_batch_parts(torch.as_tensor(toys, device=cuda_device))[2]
    np.testing.assert_allclose(res.llh_data_per_sample, parts.cpu().numpy(), rtol=1e-6,
                               atol=NLL_ATOL)


def _np_tau(x):
    """numpy f64 reference of the integrated autocorrelation time of each
    column of x [S, N] (``autocorrelation_fft`` + ``integrated_autocorr_time``)."""
    s = x.shape[0]
    x = x - x.mean(0, keepdims=True)
    nfft = 1 << int(np.ceil(np.log2(2 * s)))
    f = np.fft.rfft(x, n=nfft, axis=0)
    acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:min(s - 1, 1000)]
    rho = acf / np.maximum(acf[0:1], 1e-30)
    cum = 2.0 * np.cumsum(rho, axis=0) - 1.0
    ok = np.arange(rho.shape[0])[:, None] >= 5.0 * cum
    first = np.where(ok.any(0), np.argmax(ok, axis=0), rho.shape[0] - 1)
    return np.take_along_axis(cum, first[None], axis=0)[0]


def _np_geweke(x):
    s = x.shape[0]
    a, b = x[: int(0.1 * s)], x[int(0.5 * s):]

    def spectral_var(y):
        return y.var(0, ddof=1) * _np_tau(y) / y.shape[0]

    return (a.mean(0) - b.mean(0)) / np.sqrt(np.maximum(spectral_var(a) + spectral_var(b), 1e-30))


@pytest.mark.cuda
def test_ess_on_the_device_vs_numpy(cuda_device):
    """ESS of 3,000 AR(1) series x 2,000 steps in chunks of 64 series and at
    once, Geweke and batched means, against numpy f64."""
    rng = np.random.default_rng(1)
    phi = rng.uniform(0.0, 0.95, 3000)
    x = np.zeros((2000, 3000))
    e = rng.normal(size=x.shape)
    for t in range(1, 2000):
        x[t] = phi * x[t - 1] + e[t]
    want = 2000 / np.maximum(_np_tau(x), 1.0)
    chunk = 16 * (4096 // 2 + 1) * 64
    for cb in (chunk, autocorr.CHUNK_BYTES):
        got = autocorr.effective_sample_size(x, device=cuda_device, chunk_bytes=cb)
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-9)
    bm = autocorr.batched_means(x, device=cuda_device).cpu().numpy()
    np.testing.assert_allclose(bm, x.reshape(20, 100, 3000).mean(1), rtol=1e-9, atol=1e-12)
    z = autocorr.geweke(x, device=cuda_device).cpu().numpy()
    np.testing.assert_allclose(z, _np_geweke(x), rtol=1e-9, atol=1e-12)
