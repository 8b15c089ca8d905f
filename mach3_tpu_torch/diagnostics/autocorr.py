"""Chain convergence diagnostics: autocorrelation, ESS, batched means, Geweke,
power spectrum, acceptance tracking (port of
``mach3_tpu/diagnostics/autocorr.py``).

The equivalent of the reference ``MCMCProcessor::DiagMCMC`` suite
(``Fitters/MCMCProcessor.cpp:3346-4472``) and its CUDA autocorrelation kernel
(``Fitters/gpuMCMCProcessorUtils.cu``: one thread per (param, lag)). Every
diagnostic is a batched ``torch.fft`` / reduction over a chain array
``[S, ...]`` (steps first), in f64 on ``device``: by default the device of
a tensor chain, else the card (``core.device.target_device`` raises without
one; pass ``device="cpu"`` on the CPU). Results are f64 tensors there.

The series of a chain are its columns ``[S, N]``. :func:`effective_sample_size`
and :func:`geweke` take them in chunks of columns whose ``rfft`` output stays
within ``chunk_bytes`` (default :data:`CHUNK_BYTES`): at the 700-parameter
envelope (10,000 steps x 128 chains x 700 parameters, nfft 32,768) the whole
output would be ~23 GB of complex128.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import target_device
from ..core.precision import ATYPE

#: Bound on one chunk's ``rfft`` output (complex128), bytes.
CHUNK_BYTES = 2 << 30


def _chain(chain, device) -> torch.Tensor:
    """``chain`` as an f64 tensor on ``device`` (default: a tensor's own
    device, else the card)."""
    if device is None:
        device = chain.device if isinstance(chain, torch.Tensor) else "cuda"
    return torch.as_tensor(chain, dtype=ATYPE, device=target_device(device))


def _nfft(s: int) -> int:
    return 1 << int(np.ceil(np.log2(2 * s)))


def series_per_chunk(n_steps: int, chunk_bytes: int = CHUNK_BYTES) -> int:
    """Columns of an [n_steps, N] chain taken together: their ``rfft``
    output (complex128, nfft // 2 + 1 rows) within ``chunk_bytes``."""
    return max(1, chunk_bytes // (16 * (_nfft(n_steps) // 2 + 1)))


def autocorrelation_fft(chain, max_lag: int | None = None, device=None) -> torch.Tensor:
    """Normalised autocorrelation via FFT (``AutoCorrelation_FFT``,
    ``MCMCProcessor.cpp:3647``): chain [S, ...] -> rho [L, ...]."""
    chain = _chain(chain, device)
    s = chain.shape[0]
    if max_lag is None:
        max_lag = min(s - 1, 1000)
    x = chain - chain.mean(0, keepdim=True)
    nfft = _nfft(s)
    f = torch.fft.rfft(x, n=nfft, dim=0)
    del x
    power = torch.view_as_real(f).square().sum(-1)  # f * conj(f), real
    del f
    acf = torch.fft.irfft(power, n=nfft, dim=0)[:max_lag]
    return acf / acf[0:1].clamp(min=1e-30)


def integrated_autocorr_time(rho, c: float = 5.0) -> torch.Tensor:
    """Sokal self-consistent window: tau = 1 + 2 sum rho, window M: M >= c*tau.

    rho: [L, ...] -> tau [...] (on rho's device)."""
    rho = torch.as_tensor(rho, dtype=ATYPE)
    cum = 2.0 * torch.cumsum(rho, 0) - 1.0  # tau estimate per window
    lags = torch.arange(rho.shape[0], dtype=ATYPE, device=rho.device).reshape(
        (-1,) + (1,) * (rho.ndim - 1))
    # first window where lag >= c * tau_window
    ok = lags >= c * cum
    first = torch.argmax(ok.to(torch.uint8), 0)
    first = torch.where(ok.any(0), first, rho.shape[0] - 1)
    return torch.gather(cum, 0, first[None])[0]


def _tau_columns(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Integrated autocorrelation time of each column of x [S, N], in
    chunks of :func:`series_per_chunk` columns."""
    n = x.shape[1]
    step = series_per_chunk(x.shape[0], chunk_bytes)
    tau = torch.empty(n, dtype=ATYPE, device=x.device)
    for a in range(0, n, step):
        tau[a:a + step] = integrated_autocorr_time(autocorrelation_fft(x[:, a:a + step]))
    return tau


def effective_sample_size(chain, device=None, chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """ESS = S / tau per parameter (``CalculateESS``, ``MCMCProcessor.cpp:3949``).

    chain [S, ...] -> ess [...]; the series in chunks within ``chunk_bytes``."""
    chain = _chain(chain, device)
    s = chain.shape[0]
    tau = _tau_columns(chain.reshape(s, -1), chunk_bytes)
    return (s / tau.clamp(min=1.0)).reshape(chain.shape[1:])


def batched_means(chain, n_batches: int = 20, device=None) -> torch.Tensor:
    """Batched means (``BatchedMeans``, ``MCMCProcessor.cpp:4047``):
    chain [S, ...] -> [n_batches, ...]."""
    chain = _chain(chain, device)
    s = chain.shape[0]
    usable = (s // n_batches) * n_batches
    return chain[:usable].reshape((n_batches, usable // n_batches) + chain.shape[1:]).mean(1)


def batched_means_variance_ratio(chain, n_batches: int = 20, device=None) -> torch.Tensor:
    """Ratio of batch-mean variance to naive variance/S — ~1 for iid, >1 for
    correlated chains (the reference plots batched means for this purpose)."""
    chain = _chain(chain, device)
    bm = batched_means(chain, n_batches)
    s = chain.shape[0]
    var_bm = torch.var(bm, 0, correction=1) * (s // n_batches)
    var = torch.var(chain, 0, correction=1)
    return var_bm / var.clamp(min=1e-30)


def geweke(chain, first: float = 0.1, last: float = 0.5, device=None,
           chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """Geweke z-score (``GewekeDiagnostic``, ``MCMCProcessor.cpp:4339``):
    compare means of the first 10% and last 50% of the chain, normalised by
    spectral std estimates. chain [S, ...] -> z [...]."""
    chain = _chain(chain, device)
    s = chain.shape[0]
    a = chain[: int(first * s)]
    b = chain[int((1.0 - last) * s):]

    def spectral_var(x):
        # variance inflated by the integrated autocorrelation time
        tau = _tau_columns(x.reshape(x.shape[0], -1), chunk_bytes).reshape(x.shape[1:])
        return torch.var(x, 0, correction=1) * tau / x.shape[0]

    return (a.mean(0) - b.mean(0)) / torch.sqrt(
        (spectral_var(a) + spectral_var(b)).clamp(min=1e-30))


def power_spectrum(chain, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain power spectrum (``PowerSpectrumAnalysis``, ``MCMCProcessor.cpp:4219``):
    returns (frequencies [S//2], P(f) [S//2, ...])."""
    chain = _chain(chain, device)
    s = chain.shape[0]
    x = chain - chain.mean(0, keepdim=True)
    power = torch.fft.rfft(x, dim=0).abs() ** 2 / s
    freqs = torch.fft.rfftfreq(s, dtype=ATYPE, device=chain.device)
    return freqs[1:], power[1:]


def acceptance_rate_trace(accepted: np.ndarray, window: int = 100) -> np.ndarray:
    """Windowed acceptance-rate trace (``AcceptanceProbabilities``,
    ``MCMCProcessor.cpp:4472``): accepted [S, ...] (0/1) -> [S//window, ...]
    (numpy on the host)."""
    accepted = np.asarray(accepted, np.float64)
    s = (accepted.shape[0] // window) * window
    return accepted[:s].reshape((-1, window) + accepted.shape[1:]).mean(axis=1)
