"""Prior/posterior predictive distributions and Bayesian p-values (port of
``mach3_tpu/diagnostics/predictive.py``).

The equivalent of ``Fitters/PredictiveThrower.cpp`` and the p-value
machinery of ``Fitters/SampleSummary.cpp``: draw parameter sets from a chain
(or the prior), reweight every sample per toy, build predictive spectra, and
compute posterior-predictive p-values from the (LLH(data|toy),
LLH(fluctuation|toy)) comparison.

The JAX package vmaps one toy at a time through its single-chain XLA
reweight. Here the toys are chains: each chunk of at most ``chunk`` toys
(default ``fitters.scans.default_max_points``: a [toys, events] f32 array of
the largest sample within 2 GiB) is one ``FitModel._shared_osc_tables`` and
one ``SampleModel.reweight_batch`` per sample, so the predictive runs each
sample's reweight kernel on the card. Poisson draws come from a
``torch.Generator`` on the model's device seeded with ``seed`` (the JAX
package draws the per-toy fluctuations from a JAX key and the battery's from
``np.random.default_rng(seed + 1)``); ``draws`` and ``battery_draws`` inject
them instead. By-mode spectra are filled from ``SampleModel.event_weights``
with an ``index_add_`` on ``bin + category·(B + 1)``, the categories
gathered into each sample's event layout through ``event_perm``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.precision import ATYPE, FTYPE
from ..fitters.model import FitModel
from ..fitters.scans import CHUNK_BYTES, default_max_points
from ..samples.projection import laid_out
from ..samples.sample import SampleModel
from ..samples.teststats import get_test_stat_fn, poisson_llh

_log = get_logger("predictive")


@dataclasses.dataclass
class PredictiveResult:
    spectra: list[np.ndarray]  # per sample: [T, B] toy MC spectra
    fluctuated: list[np.ndarray]  # per sample: [T, B] Poisson-fluctuated draws
    llh_data: np.ndarray  # [T] -logL(data | toy)
    llh_draw: np.ndarray  # [T] -logL(fluctuated | toy)
    p_value: float  # P(llh_draw > llh_data)
    p_value_per_sample: np.ndarray  # [n_samples]
    # Per-bin Bayesian p-values (SampleSummary's bin-by-bin comparison,
    # ``Fitters/SampleSummary.h:23-80``): P(fluctuated >= data) per bin.
    p_value_per_bin: list[np.ndarray] | None = None  # per sample: [B]
    # By-mode predictive spectra (SampleSummary's by-mode breakdowns):
    # per sample [T, M+1, B] (last row = unknown/sentinel category).
    spectra_by_mode: list[np.ndarray] | None = None
    # SampleSummary's full fluctuated-throw battery
    # (``Fitters/SampleSummary.h:264-321`` branch inventory), per throw [T]:
    llh_fluctpred_vs_draw: np.ndarray | None = None  # Fluctuated Predictive vs Draw
    llh_data_vs_fluctdraw: np.ndarray | None = None  # Data vs Fluctuated Draw
    llh_fluctdata_vs_draw: np.ndarray | None = None  # Fluctuated Data vs Draw
    llh_fluctdraw_vs_pred: np.ndarray | None = None  # Fluctuated Draw vs Predictive
    llh_rate_data: np.ndarray | None = None  # rate-only: -logL(total rate)
    llh_rate_fluct: np.ndarray | None = None
    # p-values in both fluctuation directions + rate-only
    p_value_fluct_pred: float | None = None  # P(FluctPred-vs-Draw > Data-vs-Draw)
    p_value_fluct_data: float | None = None  # P(FluctData-vs-Draw > Data-vs-Draw)
    p_value_rate: float | None = None  # P(rate(FluctDraw) llh > rate(Data) llh)
    # This package's: the per-sample parts [T, S] of llh_data, and the toys
    # per batched call.
    llh_data_per_sample: np.ndarray | None = None
    chunk: int | None = None

    def predictive_mean(self, sample: int) -> np.ndarray:
        return self.spectra[sample].mean(axis=0)

    def predictive_band(self, sample: int, quantiles=(0.16, 0.84)) -> np.ndarray:
        return np.quantile(self.spectra[sample], quantiles, axis=0)

    def violin(self, sample: int, quantiles: np.ndarray | None = None) -> np.ndarray:
        """[Q, B] per-bin quantiles of the toy spectra — the reference's
        violin spectra (``SampleSummary``/``PredictiveThrower`` violins) in
        array form (each bin's column is the violin body)."""
        q = np.linspace(0.025, 0.975, 39) if quantiles is None else np.asarray(quantiles)
        return np.quantile(self.spectra[sample], q, axis=0)


def draw_parameter_sets(
    chain_theta: np.ndarray, n_toys: int, rng: np.random.Generator, burn_in: float = 0.2
) -> np.ndarray:
    """Sample toy parameter vectors from chain draws [S, C, P] (with burn-in),
    matching ``PredictiveThrower``'s random chain-entry draws."""
    s = chain_theta.shape[0]
    flat = chain_theta[int(burn_in * s) :].reshape(-1, chain_theta.shape[-1])
    idx = rng.integers(0, len(flat), size=n_toys)
    return flat[idx]


def _by_mode_spectra(sample: SampleModel, thetas: torch.Tensor, osc_grids: tuple | None,
                     category: torch.Tensor, n_cats: int) -> torch.Tensor:
    """Σw per (toy, category, bin) [T, n_cats, B] f32 from the sample's
    per-event weights (``SampleModel.event_weights``, plain torch ops) and
    ``category`` [E] in the sample's layout: one ``index_add_`` on
    ``bin + category·(B + 1)``, whose slot B of each category takes the
    garbage bin and is dropped. Pad events weigh 0. The toys go in rows
    whose [rows, E] int64 bins stay within ``CHUNK_BYTES``."""
    nb, nb1 = sample.n_bins, sample.n_bins + 1
    rows = max(1, CHUNK_BYTES // (8 * sample.n_events))
    parts = []
    for a in range(0, thetas.shape[0], rows):
        th = thetas[a:a + rows]
        grids = None if osc_grids is None else tuple(g[a:a + rows] for g in osc_grids)
        w, bins = sample.event_weights(th, grids)
        t = w.shape[0]
        bins = bins.long()
        slot = torch.where((bins >= 0) & (bins < nb), bins, nb) + category[None] * nb1
        slot = slot + torch.arange(t, device=w.device)[:, None] * (n_cats * nb1)
        out = torch.zeros(t * n_cats * nb1, dtype=FTYPE, device=w.device)
        out.index_add_(0, slot.reshape(-1), w.to(FTYPE).reshape(-1))
        parts.append(out.reshape(t, n_cats, nb1)[..., :nb])
    return torch.cat(parts)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def run_predictive(
    model: FitModel,
    toys_theta: np.ndarray,
    seed: int = 0,
    chunk: int | None = None,
    categories: list[np.ndarray] | None = None,
    draws: list[np.ndarray] | None = None,
    battery_draws: tuple[list[np.ndarray], list[np.ndarray]] | None = None,
) -> PredictiveResult:
    """Posterior- (or prior-) predictive analysis over toy parameter vectors
    [T, NP], on the model's device.

    ``categories`` optionally gives per-sample [E] int labels in the
    builder's event order (e.g. analysis modes from ``core.modes``); when
    set, per-toy spectra are also broken down by category (the reference
    ``SampleSummary`` by-mode machinery). Labels must be in [0, M]; M is
    treated as the unknown sentinel. ``draws`` (per sample [T, B]) replaces
    the per-toy Poisson draws and ``battery_draws`` = (fluctuated
    predictive, fluctuated data), each per sample [T, B], the battery's.
    """
    dev = model.flat.prefit.device
    samples = list(model.samples)
    toys_theta = np.asarray(toys_theta)
    n_toys = toys_theta.shape[0]
    chunk = chunk or default_max_points(model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = [(n_toys, s.n_bins) for s in samples]
    for name, given in [("draws", draws)] + [("battery_draws", b) for b in battery_draws or ()]:
        if given is not None and [np.shape(g) for g in given] != shapes:
            raise ValueError(f"{name} must hold one [T, B] array per sample")

    cat_dev = None
    if categories is not None:
        if len(categories) != len(samples):
            raise ValueError("categories must have one [E] array per sample")
        n_cats = max(int(np.max(np.asarray(c))) for c in categories) + 1
        cat_dev = [torch.as_tensor(laid_out(s, c), dtype=torch.long, device=dev)
                   for s, c in zip(samples, categories)]

    stats = [get_test_stat_fn(s.test_statistic) for s in samples]
    data = [s.data.to(ATYPE) for s in samples]
    spec, w2s, fluct, by_mode = ([[] for _ in samples] for _ in range(4))
    ps_data, ps_draw = [], []
    with torch.no_grad():
        for at in range(0, n_toys, chunk):
            th = torch.as_tensor(toys_theta[at:at + chunk], dtype=ATYPE, device=dev)
            tables = model._shared_osc_tables(th)
            d_parts, f_parts = [], []
            for i, s in enumerate(samples):
                mc, w2 = s.reweight_batch(th, tables[i])
                if cat_dev is not None:
                    by_mode[i].append(_by_mode_spectra(s, th, tables[i], cat_dev[i], n_cats))
                mc64, w264 = mc.to(ATYPE), w2.to(ATYPE)
                if draws is None:
                    dr = torch.poisson(mc64.clamp(min=0.0), generator=gen)
                else:
                    dr = torch.as_tensor(draws[i][at:at + chunk], dtype=ATYPE, device=dev)
                d_parts.append(stats[i](data[i], mc64, w264).sum(-1))
                f_parts.append(stats[i](dr, mc64, w264).sum(-1))
                spec[i].append(mc)
                w2s[i].append(w2)
                fluct[i].append(dr)
            ps_data.append(torch.stack(d_parts, 1))
            ps_draw.append(torch.stack(f_parts, 1))

        spec = [torch.cat(x) for x in spec]
        w2s = [torch.cat(x) for x in w2s]
        fluct = [torch.cat(x) for x in fluct]
        ps_data, ps_draw = torch.cat(ps_data), torch.cat(ps_draw)
        battery = _battery(samples, stats, data, spec, w2s, fluct, ps_data.sum(1), gen,
                           battery_draws)

    ps_data, ps_draw = _host(ps_data), _host(ps_draw)
    llh_data, llh_draw = ps_data.sum(1), ps_draw.sum(1)
    p_value = float(np.mean(llh_draw > llh_data))
    _log.info("Predictive p-value: %.3f over %d toys in chunks of %d", p_value, n_toys, chunk)
    spectra = [_host(x) for x in spec]
    fluctuated = [_host(x) for x in fluct]
    # Bin-by-bin Bayesian p-value: the predictive distribution of the
    # fluctuated bin content vs the observed count (SampleSummary per-bin
    # comparison); 0.5-credit at equality keeps discrete counts unbiased.
    p_per_bin = []
    for f, d in zip(fluctuated, data):
        d = _host(d)[None, :]
        p_per_bin.append((f > d).mean(axis=0) + 0.5 * (f == d).mean(axis=0))
    return PredictiveResult(
        spectra=spectra,
        fluctuated=fluctuated,
        llh_data=llh_data,
        llh_draw=llh_draw,
        p_value=p_value,
        p_value_per_sample=(ps_draw > ps_data).mean(axis=0),
        p_value_per_bin=p_per_bin,
        spectra_by_mode=None if cat_dev is None else [_host(torch.cat(b)) for b in by_mode],
        llh_data_per_sample=ps_data,
        chunk=chunk,
        **battery,
    )


def _battery(samples, stats, data, spec, w2s, fluct, llh_data, gen, given) -> dict:
    """SampleSummary's fluctuated-throw battery (``Fitters/SampleSummary.h:264-321``)
    on the device. "Predictive" = the mean toy spectrum; fluctuations are
    Poisson draws of (Draw, Predictive, Data), the latter two from ``gen``
    (per sample: predictive, then data) unless ``given``."""
    dev = llh_data.device
    n_toys = llh_data.shape[0]
    zero = torch.zeros(n_toys, dtype=ATYPE, device=dev)
    l_fp_draw, l_data_fd, l_fd_draw, l_fdraw_pred, l_rate_data, l_rate_fl = (
        zero.clone() for _ in range(6))
    for i, stat in enumerate(stats):
        mc_t, w2_t, fl_t = spec[i].to(ATYPE), w2s[i].to(ATYPE), fluct[i]
        pred = spec[i].mean(0).to(ATYPE)  # predictive-mean spectrum [B]
        w2_pred = w2s[i].mean(0).to(ATYPE)
        if given is None:
            fluct_pred = torch.poisson(pred.clamp(min=0.0).expand(n_toys, -1).contiguous(),
                                       generator=gen)
            fluct_data = torch.poisson(data[i].clamp(min=0.0).expand(n_toys, -1).contiguous(),
                                       generator=gen)
        else:
            fluct_pred = torch.as_tensor(given[0][i], dtype=ATYPE, device=dev)
            fluct_data = torch.as_tensor(given[1][i], dtype=ATYPE, device=dev)
        l_fp_draw += stat(fluct_pred, mc_t, w2_t).sum(-1)
        l_data_fd += stat(data[i][None, :], fl_t, w2_t).sum(-1)
        l_fd_draw += stat(fluct_data, mc_t, w2_t).sum(-1)
        l_fdraw_pred += stat(fl_t, pred[None, :], w2_pred[None, :]).sum(-1)
        # rate-only comparison (SampleSummary's "using rate only" branches):
        # Stirling Poisson -logL of the TOTAL event count (the full
        # normalised form — comparisons mix different observed counts, so
        # the N-dependent terms must be kept)
        rate_mc = mc_t.sum(1)
        l_rate_data += poisson_llh(torch.full_like(rate_mc, float(data[i].sum())), rate_mc)
        l_rate_fl += poisson_llh(fl_t.sum(1), rate_mc)
    out = dict(llh_fluctpred_vs_draw=l_fp_draw, llh_data_vs_fluctdraw=l_data_fd,
               llh_fluctdata_vs_draw=l_fd_draw, llh_fluctdraw_vs_pred=l_fdraw_pred,
               llh_rate_data=l_rate_data, llh_rate_fluct=l_rate_fl)
    out = {k: _host(v) for k, v in out.items()}
    ld = _host(llh_data)
    out.update(
        p_value_fluct_pred=float(np.mean(out["llh_fluctpred_vs_draw"] > ld)),
        p_value_fluct_data=float(np.mean(out["llh_fluctdata_vs_draw"] > ld)),
        p_value_rate=float(np.mean(out["llh_rate_fluct"] > out["llh_rate_data"])),
    )
    return out
