"""The port's scans (``fitters/scans.py``) and ``mach3-llhscan-torch``
against ``mach3_tpu/fitters/scans.py``.

JAX vmaps its single-chain likelihood over the grid; the port puts the grid
points on the chain axis of its batched route, in chunks of ``max_points``
(here smaller than each grid, so that every scan crosses chunks). On the
toy at 1,500 events: grids equal; penalties (the prior with its sentinel)
within 1e-12; per-sample and total NLLs within the production budget
5e-3 + 1e-3·|NLL|; sigma-variation spectra within the histogram budget 2e-3
(+1e-6 of the largest bin); ``step_scale_from_scan`` equal on equal input.
"""
import numpy as np
import pytest
import torch

from mach3_tpu.fitters import scans as jscans
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.cli import llhscan
from mach3_tpu_torch.fitters import scans
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

TOY = dict(n_events=1500, seed=11, e_grid_size=30)
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3
HIST_BUDGET = 2e-3


@pytest.fixture(scope="module")
def jtoy():
    return jbuild_toy(**TOY, use_pallas=False)


@pytest.fixture(scope="module")
def ttoy():
    return build_toy(**TOY, device="cpu")


@pytest.fixture(scope="module")
def scan1d(jtoy, ttoy):
    idx = [0, 5, 9, 12, 13, 15]  # a norm, a spline, the energy scale, sin²θ23, δCP, Δm²31
    kw = dict(indices=idx, n_points=7, n_sigma=3.0)
    return jscans.llh_scan_1d(jtoy.model, **kw), scans.llh_scan_1d(ttoy.model, **kw,
                                                                   max_points=10)


def test_llh_scan_1d_matches_jax(scan1d):
    want, got = scan1d
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["values"], want["values"])
    np.testing.assert_allclose(got["penalty"], want["penalty"], rtol=1e-12, atol=1e-12)
    assert got["samples"].shape == want["samples"].shape == (6, 7, 2)
    np.testing.assert_allclose(got["samples"], want["samples"], rtol=NLL_RTOL, atol=NLL_ATOL)
    np.testing.assert_allclose(got["total"], want["total"], rtol=NLL_RTOL, atol=2 * NLL_ATOL)
    np.testing.assert_array_equal(got["total"], got["penalty"] + got["samples"].sum(-1))
    # The Asimov minimum: each scan is least at its point nearest the prefit
    # value (the centre, but for δCP's grid, clipped at its bound).
    prefit = np.array([1.0, 0.0, 0.0, 0.561, -1.601, 2.51e-3])
    nearest = np.abs(got["values"] - prefit[:, None]).argmin(1)
    np.testing.assert_array_equal(got["total"].argmin(1), nearest)


def test_scan_chunking_is_invisible(ttoy):
    """Chunks of 1, 3 or all points give the same scan."""
    kw = dict(indices=[1, 12], n_points=5)
    whole = scans.llh_scan_1d(ttoy.model, **kw, max_points=1000)
    for m in (1, 3):
        part = scans.llh_scan_1d(ttoy.model, **kw, max_points=m)
        for k in whole:
            np.testing.assert_allclose(part[k], whole[k], rtol=1e-12, atol=1e-12)


def test_step_scale_from_scan_matches_jax(scan1d):
    want, got = scan1d
    for target in (0.05, 0.5):
        np.testing.assert_array_equal(scans.step_scale_from_scan(want, target),
                                      jscans.step_scale_from_scan(want, target))
    s = scans.step_scale_from_scan(got, 0.05)
    assert s.shape == (6,) and ((s >= 1e-3) & (s <= 1.0)).all()


def test_llh_scan_2d_matches_jax(jtoy, ttoy):
    want = jscans.llh_scan_2d(jtoy.model, 12, 15, n_points=5)
    got = scans.llh_scan_2d(ttoy.model, 12, 15, n_points=5, max_points=7)
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_allclose(got["total"], want["total"], rtol=NLL_RTOL, atol=2 * NLL_ATOL)
    assert np.unravel_index(np.argmin(got["total"]), (5, 5)) == (2, 2)


def test_llh_map_matches_jax(jtoy, ttoy):
    want = jscans.llh_map(jtoy.model, [0, 9, 12], points_per_axis=3)
    got = scans.llh_map(ttoy.model, [0, 9, 12], points_per_axis=3, max_points=4)
    for gw, gg in zip(want["grids"], got["grids"]):
        np.testing.assert_array_equal(gg, gw)
    assert got["total"].shape == (3, 3, 3)
    np.testing.assert_allclose(got["total"], want["total"], rtol=NLL_RTOL, atol=2 * NLL_ATOL)


@pytest.mark.parametrize("sample_index", [0, 1])
def test_sigma_variations_match_jax(jtoy, ttoy, sample_index):
    idx = [0, 4, 6, 9, 12]
    want = jscans.sigma_variations(jtoy.model, sample_index=sample_index, indices=idx)
    got = scans.sigma_variations(ttoy.model, sample_index=sample_index, indices=idx,
                                 max_points=6)
    np.testing.assert_array_equal(got["sigmas"], want["sigmas"])
    np.testing.assert_array_equal(got["values"], want["values"])
    assert got["hists"].shape == want["hists"].shape == (5, 5, ttoy.samples[sample_index].n_bins)
    np.testing.assert_allclose(got["hists"], want["hists"], rtol=HIST_BUDGET,
                               atol=1e-6 * np.abs(want["hists"]).max())


def test_default_max_points(ttoy):
    e = max(s.n_events for s in ttoy.model.samples)
    assert scans.default_max_points(ttoy.model) == (2 << 30) // (4 * e)


def test_drag_race_runs(ttoy):
    t = scans.drag_race(ttoy.model, n_laps=2, n_chains=4)
    names = {f"{k}[{s.name}]" for s in ttoy.samples for k in ("reweight", "likelihood")}
    assert set(t) == names | {"propose", "prior_nll"}
    assert all(v > 0 for v in t.values())


def test_llhscan_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "scan.npz"
    rc = llhscan.main(["Toy:NEvents:1500", "Toy:Seed:11", "--device", "cpu", "--points", "5",
                       "--scan-2d", "osc_sin2th23", "osc_dm2_31", "--sigma-var",
                       "-o", str(out)])
    assert rc == 0 and f"wrote {out}" in capsys.readouterr().out
    with np.load(out) as f:
        assert len(f["names"]) == 16
        assert f["scan1d_total"].shape == (16, 5) and f["scan1d_samples"].shape == (16, 5, 2)
        assert f["scan2d_total"].shape == (21, 21)
        assert f["sigvar_numu_sample_hists"].shape == (16, 5, 30)
        assert f["sigvar_nue_sample_hists"].shape == (16, 5, 15)
        assert np.isfinite(f["scan1d_total"]).all()
