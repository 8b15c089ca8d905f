"""The frozen yardstick of work: the bytes and float32 operations that a
step's reweighting needs, counted from the configuration's inputs and the
run's chain states, never from the program's tensors or launches.

Bytes: each input read once and each output written once. The spline
table is read as each parameter's 4 coefficient rows at the distinct
segments its chains are in, on the events where its response is not the
identity (an identity multiplies by exactly 1 and needs no read). Operations:
7 per evaluated (chain, event, parameter) response in the forward (one
Horner step of three fused multiply-adds and the product), 3 per (chain,
event) (w² and the two sums) and 2 per (chain, matched normalisation); 14
per response and 6 per (chain, event) in the backward. A floor is the larger
of bytes over the memory bandwidth and operations over the float32 peak.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: NVIDIA H100 SXM (data sheet, at 700 W): HBM3 bandwidth, float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
_ITEMSIZE = {"bfloat16": 2, "float32": 4, "float64": 8}


@dataclasses.dataclass
class SampleWork:
    """What one sample's reweighting needs, from its inputs."""

    name: str
    n_events: int
    n_bins: int
    n_axes: int
    shifted: bool
    params: np.ndarray  # [P_s] θ index of each spline parameter
    pairs: np.ndarray  # [P_s] events with a non-identity response
    n_matches: int  # (event, normalisation) matches
    n_norms: int  # normalisations that match an event of the sample
    coef_bytes: int  # bytes of one coefficient


def sample_work(inputs, params) -> list[SampleWork]:
    from .fixtures import KNOT_HIGH, KNOT_LOW
    from .reference.params import norm_matches

    out = []
    size = _ITEMSIZE[inputs.precision["tables"]]
    for s in inputs.samples:
        pairs = [int((~np.all(np.clip(sp.y_knots, KNOT_LOW, KNOT_HIGH) == 1.0, axis=1)).sum())
                 for sp in s.splines]
        ev, par = norm_matches(params, s)
        out.append(SampleWork(s.name, s.n_events, s.n_bins, len(s.edges), s.shift is not None,
                              np.array([sp.param_index for sp in s.splines], np.int64),
                              np.array(pairs, np.int64), len(ev), len(np.unique(par)), size))
    return out


def distinct_segments(theta: np.ndarray, knots: np.ndarray) -> np.ndarray:
    """[C, P] -> [P] number of distinct spline segments among the chains."""
    below = (knots[None, None, :] < theta[..., None]).sum(-1)
    seg = np.clip(below - 1, 0, len(knots) - 2)
    return np.array([len(np.unique(seg[:, j])) for j in range(theta.shape[1])])


def _coefficients(w: SampleWork, nseg: np.ndarray) -> int:
    return int((nseg[w.params] * 4 * w.pairs).sum()) * w.coef_bytes


def forward(w: SampleWork, n_chains: int, nseg: np.ndarray) -> tuple[float, float]:
    """(bytes, operations) of one sample's forward reweight-and-histogram
    call: the coefficients, the base weight [C, E] f32, the bin source (a
    bin per event, or the shifted variable and the other axes' part),
    segment and offset per (chain, parameter), the matched norms' indices
    and values, the two [C, B] f32 histograms written."""
    c, e = n_chains, w.n_events
    n_bytes = (_coefficients(w, nseg) + 4 * c * e + 4 * e * (2 if w.shifted else 1)
               + 8 * c * len(w.params) + 4 * w.n_matches + 4 * c * (w.n_norms + 1)
               + 2 * 4 * c * w.n_bins)
    ops = c * (7 * int(w.pairs.sum()) + 3 * e + 2 * w.n_matches)
    return float(n_bytes), float(ops)


def backward(w: SampleWork, n_chains: int, nseg: np.ndarray) -> tuple[float, float]:
    """(bytes, operations) of one sample's backward call: the forward's
    inputs but the norms, the histograms' two cotangents read, the base
    weight's [C, E] and the offsets' [C, P_s] cotangents written."""
    c, e, p = n_chains, w.n_events, len(w.params)
    n_bytes = (_coefficients(w, nseg) + 4 * c * e + 4 * e * (2 if w.shifted else 1)
               + 8 * c * p + 2 * 4 * c * w.n_bins + 4 * c * (e + p))
    ops = c * (14 * int(w.pairs.sum()) + 6 * e)
    return float(n_bytes), float(ops)


def floor_s(n_bytes: float, ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)


def step(works: list[SampleWork], n_chains: int, n_params: int, nseg: np.ndarray,
         gradient: bool) -> tuple[float, float]:
    """(bytes, operations) that one step needs as a whole (MR2T2: one
    likelihood of the proposals; ``gradient``: one batched evaluation and
    its gradient): each sample's table rows at the chains' segments read
    once, its events' MC weight and binned kinematics, the matched norms'
    indices, θ [C, P] f64 read, the histograms [C, B] and the NLLs [C]
    written (the gradient [C, P] f64 too); the forward's operations (and
    the backward's)."""
    c = n_chains
    n_bytes = 8.0 * c * n_params + 8.0 * c + (8.0 * c * n_params if gradient else 0.0)
    ops = 0.0
    for w in works:
        n_bytes += (_coefficients(w, nseg) + 4 * w.n_events * (1 + w.n_axes)
                    + 4 * w.n_matches + 2 * 4 * c * w.n_bins)
        ops += c * (7 * int(w.pairs.sum()) + 3 * w.n_events + 2 * w.n_matches)
        if gradient:
            ops += c * (14 * int(w.pairs.sum()) + 6 * w.n_events)
    return n_bytes, ops
