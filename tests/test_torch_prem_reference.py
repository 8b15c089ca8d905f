"""The port's atmospheric oscillation against the benchmark's plain
reference (``m3bench/reference``: plain torch in float64 that imports
nothing of the port), on the CPU and with no JAX: the JAX package's PREM
paths lose the innermost shell's exit on the way up, which the port repairs
(ROADMAP, deliberate differences).

* Paths: ``osc/prem.py:path_through_earth`` against ``reference.osc
  .prem_paths``, segment by segment (length, density, electron fraction)
  within 1e-9 km, on large700's 20 grid zeniths, cosZ -1 and 0⁻, and chords
  whose impact parameter lies 1e-6 km inside and outside each shell, from
  production heights of 0, 15 and 25 km.
* Probabilities: ``atmospheric_probabilities`` (float64) and the grids of an
  ``AtmoOscConfig`` as a float32 configuration builds them (float32
  matrices, float64 phases) against ``reference.osc.layered`` on the
  reference's paths, at seeded oscillation parameters drawn from their
  priors, neutrinos and antineutrinos, energies through the mantle's MSW
  resonance (3-8 GeV).
* Likelihood: each sample's NLL of the port's model of a small copy of
  ``large700`` (the benchmark's inputs at 1,500 atmospheric events a
  sample) against the reference's on its own paths, at 16 seeded points
  near the prefit point.
* Sharing: the copy's three atmospheric samples compute one layered grid a
  likelihood.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from m3bench.fixtures import osc_tree
from m3bench.reference import osc as ref_osc
from m3bench.reference.params import read
from mach3_tpu_torch.osc import prem, prob
from mach3_tpu_torch.samples.events import EventData, build_atmo_osc_config
from mach3_tpu_torch.samples.sample import AtmoOscConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
#: large700's atmospheric zenith grid (``m3bench/configs/large700.py``).
GRID = np.linspace(-0.99, 0.99, 20)
RADII = [s[0] for s in ref_osc.PREM]


def _boundary_zeniths(r_det=ref_osc.EARTH_RADIUS_KM):
    """The zeniths of chords to a detector at the surface whose impact
    parameter lies 1e-6 km inside and outside each shell's radius."""
    b = np.array([r + d for r in RADII for d in (-1e-6, 1e-6) if r + d < r_det])
    return -np.sqrt(1.0 - (b / r_det) ** 2)


def _zeniths():
    """The grid, cosZ -1, 0⁻ and just below the horizon, and the boundary
    zeniths."""
    return np.concatenate([GRID, [-1.0, np.nextafter(0.0, -1.0), -1e-4], _boundary_zeniths()])


@pytest.mark.parametrize("height", [0.0, 15.0, 25.0])
def test_paths_equal_the_reference(height):
    cosz = _zeniths()
    lengths, rho, ye = prem.path_through_earth(cosz, production_height_km=height)
    shell = {r * y: (r, y) for _, r, y in ref_osc.PREM}
    for i, (want_l, want_yr) in enumerate(ref_osc.prem_paths(cosz, height)):
        keep = [j for j, x in enumerate(want_l) if x > 0]
        got = lengths[i] > 0
        assert got.sum() == len(keep), (cosz[i], lengths[i], want_l)
        np.testing.assert_allclose(lengths[i][got], np.take(want_l, keep), rtol=0, atol=1e-9)
        for r, y, yr in zip(rho[i][got], ye[i][got], np.take(want_yr, keep)):
            if yr == 0.0:  # air
                assert r == 0.0
            else:
                assert abs(r - shell[yr][0]) <= 1e-9 and abs(y - shell[yr][1]) <= 1e-9


def _thetas(n=8, seed=5):
    """Oscillation parameters from their priors (``m3bench``'s osc tree):
    Gaussian ones about the prefit point, flat ones (sin²θ23, δCP) uniform
    inside their bounds."""
    p = read([osc_tree()])
    rng = np.random.default_rng(seed)
    th = np.where(p.flat, rng.uniform(p.low, p.high, (n, 6)),
                  p.prefit + p.error * rng.normal(size=(n, 6)))
    return np.clip(th, p.low, p.high)


#: Through the mantle's MSW resonance (3-8 GeV), with lower and higher energies.
ENERGIES = np.concatenate([np.geomspace(0.5, 2.5, 4), np.linspace(3.0, 8.0, 11), [15.0, 60.0]])
#: float64 matrices and phases: the reference's own precision (measured 9e-14).
ATOL_F64 = 1e-10
#: float32 eigenvectors and products (unit roundoff 6e-8, up to 9 chained
#: 3x3 products) with float64 phases, as a float32 configuration runs them
#: (measured 1.1e-5).
ATOL_F32 = 5e-5


def _atmo_config(cosz, dtype):
    """An ``AtmoOscConfig`` on the (E, cosZ) grid as a configuration builds
    it (unique densities, zenith groups), θ's first six entries its
    oscillation parameters."""
    n = 4
    ev = EventData(kinematics={"e_true": np.full(n, 5.0), "cos_zenith": np.full(n, -0.5)},
                   mode=np.zeros(n, np.int32), target=np.full(n, 12, np.int32),
                   pdg=np.full(n, 14, np.int32), preosc_pdg=np.full(n, 14, np.int32),
                   mc_weight=np.ones(n))
    return build_atmo_osc_config(ev, ENERGIES, cosz, list(range(6)), dtype=dtype)


@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
@pytest.mark.parametrize("how", ["f64_wrapper", "f32_config"])
def test_probabilities_equal_the_reference(how, anti):
    cosz = np.concatenate([[-1.0], GRID, _boundary_zeniths()])
    th = _thetas()
    assert (np.abs(th[:, 3]) > 0.01).all()  # δCP away from 0
    want = ref_osc.layered(torch.from_numpy(th), torch.from_numpy(ENERGIES),
                           ref_osc.prem_paths(cosz, prem.PRODUCTION_HEIGHT_KM), anti).numpy()
    if how == "f64_wrapper":
        got = prem.atmospheric_probabilities(prob.OscParams.from_array(torch.from_numpy(th)),
                                             ENERGIES, cosz, antineutrino=anti).numpy()
        atol = ATOL_F64
    else:
        grids = _atmo_config(cosz, torch.float32).prob_grids(torch.from_numpy(th))
        got = grids[int(anti)].numpy()
        atol = ATOL_F32
    assert got.shape == want.shape == (len(th), len(cosz), len(ENERGIES), 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# A small copy of large700 through the port and the reference -----------------

#: The largest |NLL| gap a sample may show. The port's model runs the
#: configuration's stated precision (bf16 tables, float32 responses, sums,
#: oscillation and statistic) against the reference's float64: measured
#: 6.8e-4 (a nue sample; atmospheric ones 3.6e-4), 15x below this, which
#: lies 7x below the cell's ``nll_gap`` limit (0.07). The paths' fault moves the
#: atmospheric samples' NLLs by several units.
NLL_ATOL = 1e-2
SAMPLES = ["numu_a", "nue_a", "numu_b", "nue_b", "atmo_a", "atmo_b", "atmo_c"]


@pytest.fixture(scope="module")
def large700():
    """The inputs of ``large700`` at the benchmark test's small size
    (``m3bench/tests/tiny.make_copy``'s cuts), their Asimov data from the
    reference, the port's model and the reference."""
    from m3bench import port
    from m3bench.reference.likelihood import Reference, spline_tables
    from m3bench.run import _load

    spec = json.loads((REPO / "m3bench/configs/large700.json").read_text())
    spec.update(n_numu=1500, n_nue=500, n_atmo=1500, n_beam_generated=4000)
    inputs = _load(REPO / "m3bench/configs/large700.py", "prem_large700").build(spec,
                                                                               2_200_000_017)
    params = read(inputs.trees)
    tables = spline_tables(inputs)
    inputs.data = Reference(inputs, "cpu", tables).asimov(torch.as_tensor(params.prefit))
    return inputs, params, port.build_model(inputs, "cpu"), Reference(inputs, "cpu", tables)


def test_sample_nlls_equal_the_reference(large700):
    from m3bench.reference.likelihood import F64
    from m3bench.samplers.mr2t2 import initial_thetas

    inputs, params, model, ref = large700
    theta = torch.as_tensor(initial_thetas(params, 16, np.random.default_rng(3), 0.3))
    with torch.no_grad():
        got = model.total_nll_batch_parts(theta)[2]
    grids: dict = {}
    want = torch.stack([s.nll(theta, grids, F64) for s in ref.samples], 1)
    assert [s.name for s in ref.samples] == SAMPLES
    gaps = dict(zip(SAMPLES, (got - want).abs().amax(0).tolist()))
    assert max(gaps.values()) < NLL_ATOL, gaps


def test_atmospheric_samples_share_one_layered_grid(large700, monkeypatch):
    """The three atmospheric samples of the copy share one oscillation
    configuration: a likelihood computes its layered grids once."""
    _, params, model, _ = large700
    calls = []
    prob_grids = AtmoOscConfig.prob_grids

    def counted(self, thetas):
        calls.append(self)
        return prob_grids(self, thetas)

    monkeypatch.setattr(AtmoOscConfig, "prob_grids", counted)
    th = torch.as_tensor(np.tile(params.prefit, (5, 1)))
    with torch.no_grad():
        model.total_nll_batch_parts(th)
    assert len(calls) == 1
