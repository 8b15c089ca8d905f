"""Sample projections and event-rate breakdowns for plotting (port of
``mach3_tpu/samples/projection.py``).

The equivalent of the reference's plotting/projection API on samples
(``Samples/SampleHandlerFD.h:104-144``: 1D projections by mode / oscillation
channel / kinematic selection; event-rate tables in
``SampleHandlerFD.cpp:2029``). Weights come from
:meth:`SampleModel.event_weights` at one θ on the sample's device (the full
per-event product: MC weight, norms, splines, oscillation, TF1 and weight
functions; the JAX module's product leaves out the last two); the
categorical splits happen host-side in numpy.

A laid-out sample (``splines/plan.py``: events permuted, padded with
zero-weight copies) is read back in the builder's order through
``SampleModel.event_perm`` / ``event_pad``: per-event arrays given here
(``category``, ``select``) and returned (:func:`event_weights`) are in that
order, as the JAX package has them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import ATYPE
from .sample import SampleModel


def builder_order(sample: SampleModel, x: np.ndarray) -> np.ndarray:
    """Per-event values [..., E] of a (possibly laid-out) sample in the
    builder's event order, pad events dropped."""
    if sample.event_perm is None:
        return x
    perm = sample.event_perm.cpu().numpy()
    real = ~sample.event_pad.cpu().numpy()
    src = perm[real]
    if not np.array_equal(np.sort(src), np.arange(len(src))):
        raise ValueError(f"{sample.name}: event_perm is not a permutation of the builder's events")
    out = np.empty(x.shape[:-1] + (len(src),), x.dtype)
    out[..., src] = x[..., real]
    return out


def laid_out(sample: SampleModel, x) -> np.ndarray:
    """Per-event values [E] in the builder's order gathered into the
    sample's layout (a pad event takes the value of the event it copies)."""
    x = np.asarray(x)
    if sample.event_perm is None:
        return x
    return x[sample.event_perm.cpu().numpy()]


def _at(sample: SampleModel, params) -> torch.Tensor:
    """θ [NP] (a tensor or an array) as a batch of one on the sample's device."""
    if not isinstance(params, torch.Tensor):
        params = torch.from_numpy(np.array(params, np.float64))
    return params.to(dtype=ATYPE, device=sample.kin.device)[None]


def event_weights(sample: SampleModel, params) -> np.ndarray:
    """Full per-event weight product at the given parameters [E], in the
    builder's order."""
    with torch.no_grad():
        w, _ = sample.event_weights(_at(sample, params))
    return builder_order(sample, w[0].cpu().numpy())


def project(
    sample: SampleModel,
    params,
    var_row: int,
    edges: np.ndarray,
    category: np.ndarray | None = None,
    select: np.ndarray | None = None,
) -> dict:
    """1D projection of the reweighted sample onto one kinematic variable.

    category: optional [E] int labels (e.g. interaction mode) -> stacked
    per-category histograms; select: optional [E] bool pre-selection (both
    in the builder's order). Kinematics are taken at the given parameters
    (functional shifts applied).
    """
    w = event_weights(sample, params)
    with torch.no_grad():
        kin = sample._shifted_kinematics(_at(sample, params))[0, var_row]
    kin = builder_order(sample, kin.cpu().numpy())
    if select is not None:
        w = np.where(select, w, 0.0)
    total, _ = np.histogram(kin, bins=edges, weights=w)
    out = {"edges": np.asarray(edges), "total": total}
    if category is not None:
        cats = np.unique(category)
        out["categories"] = {}
        for c in cats:
            h, _ = np.histogram(kin[category == c], bins=edges, weights=w[category == c])
            out["categories"][int(c)] = h
    return out


def event_rate_table(
    samples: list[SampleModel],
    params,
    categories: list[np.ndarray] | None = None,
) -> dict:
    """Integrated event rates per sample (and per category), the reference's
    printed rate tables."""
    out = {}
    for i, s in enumerate(samples):
        w = event_weights(s, params)
        entry = {"total": float(w.sum())}
        if categories is not None and categories[i] is not None:
            for c in np.unique(categories[i]):
                entry[f"cat_{int(c)}"] = float(w[categories[i] == c].sum())
        out[s.name] = entry
    return out
