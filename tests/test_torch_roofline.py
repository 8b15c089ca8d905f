"""Roofline accounting (``mach3_tpu_torch/diagnostics/roofline.py``) vs the
JAX package's ``diagnostics/roofline.py``: under JAX's peaks the port's
report of a bridged model equals JAX's, component by component, though the
port's samples are laid out and padded anew (the port's one added key, the
f64 lower bound, aside); the two roofline laws and the components' sum hold
(``tests/test_large.py:126-150``); the defaults are the H100's peaks."""
import pytest
import torch

from mach3_tpu.diagnostics import roofline as jroofline
from mach3_tpu.tutorial.large import build_large as jbuild_large
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.diagnostics import roofline

torch.set_num_threads(1)

LARGE = dict(n_numu=4000, n_nue=1500, n_atmo=3000, e_grid_size=40, atmo_e_grid_size=20,
             atmo_cosz_grid_size=8)


@pytest.fixture(scope="module")
def models():
    jtoy = jbuild_toy(n_events=2000, seed=7, e_grid_size=40).model
    jlarge = jbuild_large(**LARGE, low_memory=True).model
    return {"toy": (jtoy, from_jax_model(jtoy)), "large": (jlarge, from_jax_model(jlarge))}


@pytest.mark.parametrize("name", ["toy", "large"])
def test_report_equals_jax_under_jax_peaks(models, name):
    jmodel, tmodel = models[name]
    assert any(s.event_pad is not None and bool(s.event_pad.any()) for s in tmodel.samples)
    want = jroofline.report(jmodel, n_chains=128, measured_step_ms=25.0)
    got = roofline.report(tmodel, n_chains=128, measured_step_ms=25.0,
                          hbm_gbps=jroofline.V5E_HBM_GBPS, mxu_tflops=jroofline.V5E_BF16_TFLOPS)
    assert got.pop("f64_lower_bound_ms") == round(
        got["f64_transcendentals_per_step"] / 34e12 * 1e3, 4)
    assert set(got) == set(want)
    assert list(got["components"]) == list(want["components"])
    for comp, vals in want["components"].items():
        assert got["components"][comp] == vals, comp
    assert {k: v for k, v in got.items() if k != "components"} == {
        k: v for k, v in want.items() if k != "components"}


def test_roofline_laws_and_h100_defaults(models):
    _, tmodel = models["large"]
    rep = roofline.report(tmodel, n_chains=128, measured_step_ms=25.0)
    assert rep["hbm_gbytes_per_step"] > 0 and rep["memory_floor_ms"] > 0
    # The JAX package's selector-contraction count: 2 C P K4 E operations,
    # which at the H100's 20 operations a byte outweigh the bytes.
    assert rep["mxu_floor_ms"] > rep["memory_floor_ms"]
    names = set(rep["components"])
    for s in tmodel.samples:
        assert {f"{s.name}:base_w", f"{s.name}:llh", f"{s.name}:kernel"} <= names
    assert any(n.endswith(":osc") for n in names)
    assert 0 < rep["fraction_of_memory_floor"] <= 1.5
    total = sum(c["floor_ms"] for c in rep["components"].values())
    assert abs(total - rep["combined_floor_ms"]) < 0.01 + 0.01 * total
    # Each component's floor is the larger of its laws at the H100's peaks.
    for comp in roofline.model_budget(tmodel, 128):
        t_mem = comp.hbm_bytes / 3.35e12
        t_ops = comp.mxu_flops / 67e12
        assert comp.floor_ms() == pytest.approx(1e3 * max(t_mem, t_ops), rel=1e-12)
    assert (roofline.H100_HBM_GBPS, roofline.H100_F32_TFLOPS, roofline.H100_F64_TFLOPS) == (
        3350.0, 67.0, 34.0)
    # The f64 transcendentals at one operation each: a lower bound, in no floor.
    assert rep["f64_lower_bound_ms"] == round(
        rep["f64_transcendentals_per_step"] / 34e12 * 1e3, 4)
    # The counts read real events: the port's own layout pads are left out.
    for s in tmodel.samples:
        assert roofline.real_events(s) == int((~s.event_pad).sum()) < s.n_events
    assert roofline.report(tmodel, 64)["hbm_gbytes_per_step"] < rep["hbm_gbytes_per_step"]
