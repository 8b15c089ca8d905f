"""Atmospheric oscillation of the port (``osc/prem.py``,
``probabilities_layered``, ``AtmoOscConfig``, ``build_atmo_osc_config``)
vs the JAX package.

* PREM path geometry (numpy): a geometry check of the port's own. The port
  repairs the way up, which the JAX package's paths get wrong (they lose
  the innermost shell's exit), so the JAX side below is built on the port's
  paths (``jax_prem.py``); ``test_torch_prem_reference.py`` holds the paths
  to the benchmark's plain reference.
* Probabilities through the layered earth, f32 matrix work with f64
  phases (the atmospheric default), chain-batched in the port: within
  5e-6 absolute — f32 3x3 products summed in another order (the port
  chains the layers as complex matmuls), measured ~1e-6.
* ``AtmoOscConfig``: the builder's indices, unique densities and zenith
  groups are JAX's exactly; per-event weights with and without ``z_groups``
  and with production-height averaging within the same 5e-6.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_prem import repaired_paths

from mach3_tpu.osc import prem as jprem
from mach3_tpu.osc import prob as jprob
from mach3_tpu.samples.events import EventData as JEventData
from mach3_tpu.samples.events import build_atmo_osc_config as jbuild_atmo
from mach3_tpu_torch.osc import prem, prob
from mach3_tpu_torch.samples.events import EventData, build_atmo_osc_config
from mach3_tpu_torch.samples.sample import AtmoOscConfig

torch.set_num_threads(1)

ATOL = 5e-6
COSZ = np.linspace(-0.99, 0.99, 8)
E_GRID = np.geomspace(0.5, 100.0, 20)
THETAS = np.array([
    [0.307, 0.022, 0.561, -1.601, 7.42e-5, 2.51e-3],
    [0.290, 0.025, 0.450, 0.700, 7.60e-5, -2.45e-3],  # inverted ordering
    [0.320, 0.020, 0.600, 3.000, 7.30e-5, 2.60e-3],
])


def _z_groups(lengths):
    nseg = np.maximum((lengths > 0).sum(-1), 1)
    if nseg.ndim == 2:
        nseg = nseg.max(0)
    return tuple((tuple(int(i) for i in np.nonzero(nseg == n)[0]), int(n))
                 for n in sorted(set(nseg.tolist())))


def test_path_through_earth_is_jax_s():
    """The chord's geometry: the segments add up to the chord from the
    production point to the detector; up-going, one air segment and then
    every crossed shell twice but the innermost, which is crossed once, its
    densities (and, for a detector at the surface, its lengths) mirrored
    about the chord's midpoint; down-going, one air segment. The name is
    kept for the test's id: the paths are no longer JAX's, whose way up
    loses the innermost shell's exit."""
    cosz = np.concatenate([COSZ, [-1.0, -0.5]])
    radii = np.array([s[0] for s in prem.PREM_COARSE])
    rhos = [s[1] for s in prem.PREM_COARSE]
    for h, depth in ((15.0, 0.0), (25.0, 1.0)):
        lengths, rho, ye = prem.path_through_earth(cosz, production_height_km=h,
                                                   detector_depth_km=depth)
        r_det, r_prod = prem.EARTH_RADIUS_KM - depth, prem.EARTH_RADIUS_KM + h
        chord = np.sqrt(r_prod**2 - r_det**2 * (1 - cosz**2)) - r_det * cosz
        np.testing.assert_allclose(lengths.sum(1), chord, rtol=1e-12)
        for cz, ls, rs, ys in zip(cosz, lengths, rho, ye):
            n = int((ls > 0).sum())
            assert (ls[n:] == 0).all() and rs[0] == 0.0 and ys[0] == 0.5  # air first
            if cz >= 0:
                assert n == 1
                continue
            earth_l, earth_rho = ls[1:n], list(rs[1:n])
            crossed = radii[radii > r_det * np.sqrt(1 - cz**2)]
            assert earth_rho == earth_rho[::-1]
            assert [earth_rho.count(r) for r in rhos[-len(crossed):]] == [1] + [2] * (
                len(crossed) - 1)
            if depth == 0.0:
                np.testing.assert_allclose(earth_l, earth_l[::-1], rtol=1e-9)
        assert (lengths[cosz < 0] > 0).sum(1).max() == 2 * len(radii)  # through the core


@pytest.mark.parametrize("grouped", [False, True], ids=["all_layers", "z_groups"])
@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
def test_probabilities_layered_match_jax(grouped, anti):
    lengths, rho, ye = prem.path_through_earth(COSZ)
    rho_eff = rho * ye / 0.5
    zg = _z_groups(lengths) if grouped else None
    want = np.stack([
        np.asarray(jprob.probabilities_layered(
            jprob.OscParams.from_array(jnp.asarray(t)), jnp.asarray(E_GRID),
            jnp.asarray(lengths), jnp.asarray(rho_eff), antineutrino=anti,
            dtype=jnp.float32, z_groups=zg))
        for t in THETAS
    ])
    got = prob.probabilities_layered(
        prob.OscParams.from_array(torch.from_numpy(THETAS)), torch.from_numpy(E_GRID),
        torch.from_numpy(lengths), torch.from_numpy(rho_eff), antineutrino=anti,
        dtype=torch.float32, z_groups=zg,
    ).numpy()
    assert got.shape == (3, len(COSZ), len(E_GRID), 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)  # unitarity, rows


def test_atmospheric_probabilities_wrapper():
    got = prem.atmospheric_probabilities(
        prob.OscParams.from_array(torch.from_numpy(THETAS[0])), E_GRID, COSZ).numpy()
    with repaired_paths():
        want = np.asarray(jprem.atmospheric_probabilities(
            jprob.OscParams.from_array(jnp.asarray(THETAS[0])), E_GRID, COSZ))
    assert got.shape == (len(COSZ), len(E_GRID), 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)  # f64 on both sides


def _events(n=400, seed=0):
    rng = np.random.default_rng(seed)
    preosc = rng.choice([14, -14, 12, -12], size=n)
    det = np.where(rng.random(n) < 0.2, np.sign(preosc) * 12, preosc)
    kin = {"e_true": np.clip(0.5 * (1 + rng.pareto(1.7, n)), 0.5, 100.0),
           "cos_zenith": rng.uniform(-1, 1, n)}
    kw = dict(kinematics=kin, mode=rng.integers(0, 4, n).astype(np.int32),
              target=np.full(n, 12, np.int32), pdg=det.astype(np.int32),
              preosc_pdg=preosc.astype(np.int32), mc_weight=np.ones(n))
    return EventData(**kw), JEventData(**kw)


HEIGHTS = dict(production_heights=[10.0, 15.0, 25.0], height_weights=[0.25, 0.5, 0.25])


@pytest.mark.parametrize("case", ["fixed_height", "height_average"])
def test_atmo_osc_config_matches_jax(case):
    ev, jev = _events()
    kw = dict(e_grid=E_GRID, cosz_grid=COSZ, osc_param_gidx=list(range(2, 8)), nc_modes=[3])
    if case == "height_average":
        kw.update(HEIGHTS)
    cfg = build_atmo_osc_config(ev, **kw)
    with repaired_paths():
        jcfg = jbuild_atmo(jev, **kw)
    for f in ("e_grid", "layer_lengths", "layer_rho", "rho_unique", "rho_idx", "event_flat_idx",
              "chan_alpha", "chan_beta", "chan_anti", "nc_mask", "osc_param_idx"):
        assert np.array_equal(getattr(cfg, f).numpy(), np.asarray(getattr(jcfg, f))), f
    assert cfg.z_groups == jcfg.z_groups and len(cfg.z_groups) > 1
    order = [i for idxs, _ in cfg.z_groups for i in idxs]  # held as buffers, made once
    assert cfg.z_order.tolist() == order
    assert cfg.z_order[cfg.z_inverse].tolist() == list(range(len(order)))
    if case == "height_average":
        assert cfg.layer_lengths.shape[0] == 3
        np.testing.assert_array_equal(cfg.height_weights.numpy(), np.asarray(jcfg.height_weights))

    thetas = np.zeros((2, 8))
    thetas[:, 2:] = THETAS[1:]
    got = cfg.weights(torch.from_numpy(thetas)).numpy()
    want = np.stack([np.asarray(jcfg.weights(jnp.asarray(t), ev.n_events)) for t in thetas])
    assert got.shape == (2, ev.n_events) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got[:, ev.mode == 3] == 1.0).all()  # NC events do not oscillate

    # without the zenith partition: the same weights
    flat = AtmoOscConfig(
        cfg.e_grid, cfg.layer_lengths, cfg.layer_rho, cfg.event_flat_idx, cfg.chan_alpha,
        cfg.chan_beta, cfg.chan_anti, cfg.nc_mask, cfg.osc_param_idx,
        rho_unique=cfg.rho_unique, rho_idx=cfg.rho_idx, height_weights=cfg.height_weights,
    )
    np.testing.assert_allclose(flat.weights(torch.from_numpy(thetas)).numpy(), got,
                               rtol=0, atol=1e-6)
    assert flat.z_order is None and flat.z_inverse is None
    assert flat.share_signature() != cfg.share_signature()


def test_atmo_grids_shared_by_signature():
    """Two samples on one (E, cosZ) grid compute it once per step
    (``FitModel._shared_osc_tables``), and take_events keeps the grid."""
    from mach3_tpu_torch.fitters.model import FitModel

    ev, _ = _events()
    kw = dict(e_grid=E_GRID, cosz_grid=COSZ, osc_param_gidx=list(range(2, 8)))
    a, b = build_atmo_osc_config(ev, **kw), build_atmo_osc_config(ev, **kw)
    perm = np.arange(ev.n_events)[::-1].copy()
    c = a.take_events(perm)
    assert a.share_signature() == b.share_signature() == c.share_signature()
    assert torch.equal(c.event_flat_idx, a.event_flat_idx.flip(0))
    samples = [types.SimpleNamespace(osc_share_signature=o.share_signature) for o in (a, b, c)]
    assert FitModel._compute_osc_groups(samples) == (0, 0, 0)
