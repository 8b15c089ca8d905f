"""The frozen yardstick by hand on a small generated sample: identity
responses are skipped, each byte is counted once, and a floor is the larger
of its two terms."""
from __future__ import annotations

import json

import numpy as np
import pytest

from m3bench import counts
from m3bench.fixtures import SIGMA_KNOTS, SampleInputs, SplineInputs
from m3bench.reference.params import read

TREE = {"Systematics": [
    {"Systematic": {"Names": {"FancyName": "n0"}, "ParameterValues": {"PreFitValue": 1.0},
                    "StepScale": {"MCMC": 0.1}, "Error": 0.1, "ParameterBounds": [0, 3],
                    "Type": "Norm", "Mode": [0]}},
    {"Systematic": {"Names": {"FancyName": "s0"}, "ParameterValues": {"PreFitValue": 0.0},
                    "StepScale": {"MCMC": 0.1}, "Error": 1.0, "ParameterBounds": [-3, 3],
                    "Type": "Spline", "Mode": [0]}},
    {"Systematic": {"Names": {"FancyName": "s1"}, "ParameterValues": {"PreFitValue": 0.0},
                    "StepScale": {"MCMC": 0.1}, "Error": 1.0, "ParameterBounds": [-3, 3],
                    "Type": "Spline"}}]}


class _Inputs:
    precision = {"tables": "bfloat16"}
    trees = [TREE]


def _sample() -> SampleInputs:
    e = 6
    mode = np.array([0, 0, 1, 1, 0, 1], np.int32)
    y = np.ones((3, 5))
    y[0] = [0.9, 0.95, 1.0, 1.05, 1.1]  # event 0: a real response
    y[2] = [1.2, 1.1, 1.0, 0.9, 0.8]  # event 4: a real response; event 1 stays 1 (identity)
    ones = np.ones((2, 5))
    ones[1] = [0.8, 0.9, 1.0, 1.1, 1.3]
    return SampleInputs(
        "s", {"e_true": np.ones(e, np.float32), "e_reco": np.ones(e, np.float32)}, mode,
        np.full(e, 12, np.int32), np.full(e, 14, np.int32), np.full(e, 14, np.int32),
        np.ones(e, np.float32), ("e_true", "e_reco"), [np.linspace(0, 2, 5)], ("e_reco",),
        [SplineInputs(1, "Linear", np.array([0, 1, 4]), y),
         SplineInputs(2, "Linear", np.array([2, 3]), ones)],
        {"kind": "beam"}, None)


def test_sample_work_skips_identities_and_counts_matches():
    inp = _Inputs()
    inp.samples = [_sample()]
    (w,) = counts.sample_work(inp, read([TREE]))
    assert list(w.pairs) == [2, 1]  # event 1 of s0 and event 2 of s1 are identities
    assert w.n_matches == 3 and w.n_norms == 1  # n0 matches the mode-0 events 0, 1, 4
    assert w.coef_bytes == 2 and w.n_bins == 4 and not w.shifted


def test_distinct_segments():
    theta = np.array([[0.0, -2.0, 0.5], [0.0, 2.0, 0.7], [0.0, -0.5, -5.0]])
    # knots -3 -1 0 1 3: 0 lies in segment 1 (knots strictly below, minus one)
    assert list(counts.distinct_segments(theta, SIGMA_KNOTS)) == [1, 3, 2]


def test_forward_and_backward_count_each_byte_once():
    inp = _Inputs()
    inp.samples = [_sample()]
    (w,) = counts.sample_work(inp, read([TREE]))
    nseg = np.array([1, 2, 3])  # per θ index
    c = 4
    coef = (2 * 4 * 2 + 3 * 4 * 1) * 2
    fwd_bytes = coef + 4 * c * 6 + 4 * 6 + 8 * c * 2 + 4 * 3 + 4 * c * 2 + 2 * 4 * c * 4
    assert counts.forward(w, c, nseg) == (fwd_bytes, c * (7 * 3 + 3 * 6 + 2 * 3))
    bwd_bytes = coef + 4 * c * 6 + 4 * 6 + 8 * c * 2 + 2 * 4 * c * 4 + 4 * c * (6 + 2)
    assert counts.backward(w, c, nseg) == (bwd_bytes, c * (14 * 3 + 6 * 6))
    step_bytes, step_ops = counts.step([w], c, 3, nseg, gradient=False)
    assert step_bytes == 8 * c * 3 + 8 * c + coef + 4 * 6 * 2 + 4 * 3 + 2 * 4 * c * 4
    assert step_ops == c * (7 * 3 + 3 * 6 + 2 * 3)
    g_bytes, g_ops = counts.step([w], c, 3, nseg, gradient=True)
    assert g_bytes == step_bytes + 8 * c * 3
    assert g_ops == step_ops + c * (14 * 3 + 6 * 6)


@pytest.mark.parametrize("n_bytes,ops,want", [
    (3.35e12, 1.0, 1.0), (1.0, 67e12, 1.0), (6.7e12, 67e12, 2.0), (3.35e9, 134e12, 2.0)])
def test_floor_is_the_larger_term(n_bytes, ops, want):
    assert counts.floor_s(n_bytes, ops) == pytest.approx(want)


def test_configured_samples_have_their_stated_shapes():
    spec = json.loads(open(counts.__file__.replace("counts.py", "configs/large700.json")).read())
    assert spec["n_params"] == 700 and spec["n_bins"] == 5364
