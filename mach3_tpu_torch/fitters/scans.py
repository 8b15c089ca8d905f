"""Likelihood scans, sigma variations and per-component timing (port of
``mach3_tpu/fitters/scans.py``; ``FitterBase``'s validation tools).

* ``RunLLHScan`` (``Fitters/FitterBase.cpp:622-885``): 1-D scans of the
  total, per-sample and penalty -logL of each parameter.
* ``Run2DLLHScan`` (``:936``) and ``RunLLHMap`` (``:1039``): 2-D and n-D
  grids.
* ``RunSigmaVar`` (``:1387``): each parameter's ±σ spectra of one sample.
* ``GetStepScaleBasedOnLLHScan`` (``:887``): step scales from the scans.
* ``DragRace`` (``:461-520``): seconds per call of each component.

The JAX package vmaps its single-chain likelihood over the grid points.
Here the grid points are chains: each chunk of at most ``max_points`` points
is one batched call (``FitModel.total_nll_batch_parts``,
``SampleModel.reweight_batch``), so the scans run each sample's reweight
kernel on the card. The default chunk keeps a [points, events] f32 array of
the largest sample under 2 GiB.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.precision import ATYPE
from ..params.state import propose_step_batch
from .model import FitModel

_log = get_logger("scans")

#: The default chunk's bound on one [points, events] f32 array, bytes.
CHUNK_BYTES = 2 << 30


def default_max_points(model: FitModel) -> int:
    """Grid points per batched call: a [points, E] f32 array of the
    largest sample (E its events) within ``CHUNK_BYTES``."""
    e_max = max((s.n_events for s in model.samples), default=1)
    return max(1, CHUNK_BYTES // (4 * e_max))


def _prior_sigma_bounds(model: FitModel, idx: int) -> tuple[float, float, float]:
    """(prior error, low bound, high bound) of parameter ``idx``, from its
    handler's throw factor (as the JAX package takes it)."""
    for prior, (start, size) in zip(model.priors, model.slices):
        if start <= idx < start + size:
            local = idx - start
            chol = prior.chol.cpu().numpy()
            err = float(np.sqrt((chol @ chol.T)[local, local]))
            return err, float(prior.low_bound[local]), float(prior.up_bound[local])
    raise IndexError(f"parameter {idx} outside the model's {model.n_params}")


def _scan_grid(model: FitModel, indices: Sequence[int], n_points: int,
               n_sigma: float) -> np.ndarray:
    """[len(indices), n_points] scan values: prefit ± n_sigma prior errors,
    clipped to the bounds."""
    prefit = model.prefit_vector().cpu().numpy()
    grids = []
    for idx in indices:
        err, lo, hi = _prior_sigma_bounds(model, idx)
        grids.append(np.linspace(max(prefit[idx] - n_sigma * err, lo),
                                 min(prefit[idx] + n_sigma * err, hi), n_points))
    return np.stack(grids)


def _points(model: FitModel, columns: Sequence[int] | np.ndarray, values: np.ndarray
            ) -> torch.Tensor:
    """θ [N, NP] at prefit with ``values`` [N, k] set in ``columns`` (one
    list for all points, or [N, k] per point), on the model's device."""
    prefit = model.prefit_vector().cpu().numpy()
    th = np.tile(prefit, (values.shape[0], 1))
    cols = np.broadcast_to(np.asarray(columns), values.shape)
    np.put_along_axis(th, cols, values, axis=1)
    return torch.as_tensor(th, dtype=ATYPE, device=model.flat.prefit.device)


def _chunked(fn: Callable, thetas: torch.Tensor, max_points: int) -> list:
    """``fn`` over ``thetas`` in chunks of at most ``max_points`` rows; the
    per-chunk outputs (tuples of tensors) concatenated on the host."""
    outs = []
    with torch.no_grad():
        for i in range(0, thetas.shape[0], max_points):
            res = fn(thetas[i:i + max_points])
            outs.append(tuple(r.cpu().numpy() for r in (res if isinstance(res, tuple) else (res,))))
    return [np.concatenate(parts) for parts in zip(*outs)]


def llh_scan_1d(model: FitModel, indices: Sequence[int] | None = None, n_points: int = 41,
                n_sigma: float = 3.0, max_points: int | None = None) -> dict[str, np.ndarray]:
    """1-D scans of the requested parameters (default all): {"values" [P, N],
    "total" [P, N], "penalty" [P, N] (the prior -logL with its out-of-bounds
    sentinel), "samples" [P, N, n_samples]} (the reference's
    ``LLHScanBySample``); total = penalty + the samples' sum."""
    if indices is None:
        indices = list(range(model.n_params))
    grid = _scan_grid(model, indices, n_points, n_sigma)
    thetas = _points(model, np.repeat(indices, n_points)[:, None], grid.reshape(-1, 1))

    def parts(th):
        _, prior_parts, sample_parts = model.total_nll_batch_parts(th)
        return prior_parts.sum(1), sample_parts

    penalty, samples = _chunked(parts, thetas, max_points or default_max_points(model))
    penalty = penalty.reshape(len(indices), n_points)
    samples = samples.reshape(len(indices), n_points, -1)
    return {"values": grid, "total": penalty + samples.sum(-1), "penalty": penalty,
            "samples": samples}


def llh_scan_2d(model: FitModel, index_x: int, index_y: int, n_points: int = 31,
                n_sigma: float = 3.0, max_points: int | None = None) -> dict[str, np.ndarray]:
    """2-D scan of a parameter pair (``Run2DLLHScan``): total -logL [N, N]."""
    gx = _scan_grid(model, [index_x], n_points, n_sigma)[0]
    gy = _scan_grid(model, [index_y], n_points, n_sigma)[0]
    xx, yy = np.meshgrid(gx, gy, indexing="ij")
    thetas = _points(model, [index_x, index_y], np.stack([xx.reshape(-1), yy.reshape(-1)], 1))
    (total,) = _chunked(model.total_nll_batch, thetas, max_points or default_max_points(model))
    return {"x": gx, "y": gy, "total": total.reshape(n_points, n_points)}


def llh_map(model: FitModel, indices: Sequence[int], points_per_axis: int = 11,
            n_sigma: float = 2.0, max_points: int | None = None) -> dict[str, np.ndarray]:
    """n-D grid of the total -logL (``RunLLHMap``), the full cartesian
    product: use few axes."""
    grids = _scan_grid(model, indices, points_per_axis, n_sigma)
    mesh = np.meshgrid(*grids, indexing="ij")
    flat = np.stack([m.reshape(-1) for m in mesh], axis=1)
    thetas = _points(model, list(indices), flat)
    (total,) = _chunked(model.total_nll_batch, thetas, max_points or default_max_points(model))
    return {"grids": grids, "total": total.reshape([points_per_axis] * len(indices))}


def step_scale_from_scan(scan: dict[str, np.ndarray], target_dllh: float = 0.5) -> np.ndarray:
    """Per-parameter step scales from the scans (``GetStepScaleBasedOnLLHScan``):
    the width where ΔLLH crosses ``target_dllh`` on both sides of the
    minimum, over the scan's width (at least 1e-3; 1 where it does not
    cross on both sides)."""
    values, total = scan["values"], scan["total"]
    scales = np.ones(values.shape[0])
    for p in range(values.shape[0]):
        t = total[p] - total[p].min()
        imin = int(np.argmin(t))
        above = np.nonzero(t > target_dllh)[0]
        right = above[above > imin]
        left = above[above < imin]
        if len(right) and len(left):
            width = values[p][right[0]] - values[p][left[-1]]
            full = values[p][-1] - values[p][0]
            scales[p] = max(width / full, 1e-3)
    return scales


def sigma_variations(model: FitModel, sample_index: int = 0,
                     sigmas: Sequence[float] = (-3, -1, 0, 1, 3),
                     indices: Sequence[int] | None = None,
                     max_points: int | None = None) -> dict[str, np.ndarray]:
    """±σ spectra (``RunSigmaVar``): each parameter at prefit + s·σ (σ its
    prior error, clipped to the bounds), the others at prefit; one sample's
    predicted histogram on its route. Returns {"sigmas" [S], "values" [P, S],
    "hists" [P, S, B]}."""
    if indices is None:
        indices = list(range(model.n_params))
    prefit = model.prefit_vector().cpu().numpy()
    grid = []
    for idx in indices:
        err, lo, hi = _prior_sigma_bounds(model, idx)
        grid.append([np.clip(prefit[idx] + s * err, lo, hi) for s in sigmas])
    grid = np.asarray(grid)
    sample = model.samples[sample_index]
    thetas = _points(model, np.repeat(indices, len(sigmas))[:, None], grid.reshape(-1, 1))
    (hists,) = _chunked(lambda th: sample.reweight_batch(th)[0], thetas,
                        max_points or default_max_points(model))
    return {"sigmas": np.asarray(sigmas), "values": grid,
            "hists": hists.reshape(len(indices), len(sigmas), -1)}


def drag_race(model: FitModel, n_laps: int = 20, n_chains: int = 8) -> dict[str, float]:
    """Seconds per call (``DragRace``) of each sample's reweight and
    likelihood over a chain batch at prefit, the batched proposal and the
    prior: CUDA events on the card, the host clock on the CPU. Each is
    called once before its laps."""
    theta = model.prefit_vector()[None, :].repeat(n_chains, 1)
    dev = theta.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timings: dict[str, float] = {}

    def timeit(name, fn):
        fn()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_laps):
                fn()
            stop.record()
            stop.synchronize()
            timings[name] = start.elapsed_time(stop) / 1e3 / n_laps
        else:
            t0 = time.perf_counter()
            for _ in range(n_laps):
                fn()
            timings[name] = (time.perf_counter() - t0) / n_laps

    with torch.no_grad():
        for s in model.samples:
            timeit(f"reweight[{s.name}]", lambda s=s: s.reweight_batch(theta))
            timeit(f"likelihood[{s.name}]", lambda s=s: s.log_likelihood_batch(theta))
        timeit("propose", lambda: propose_step_batch(model.flat, theta, gen))
        timeit("prior_nll", lambda: model.prior_nll_breakdown(theta).sum(1))
    for name, t in timings.items():
        _log.info("DragRace %-28s %.3f ms/call (%d chains)", name, 1e3 * t, n_chains)
    return timings
