"""PREM earth model and atmospheric neutrino path geometry (port of
``mach3_tpu/osc/prem.py``).

For each zenith angle the chord from the production point to the detector is
cut into segments through concentric density shells: the (layer_lengths,
layer_rho) inputs of :func:`mach3_tpu_torch.osc.prob.probabilities_layered`.
The geometry is numpy, computed once per zenith binning on the host, as in
the JAX package; only the per-step 3-flavour evolution runs on the device.

The way up departs from the JAX package on purpose: its
``path_through_earth`` lists every crossed radius but the innermost there,
so the innermost shell's exit is lost and the shell outside it runs on
(9 of 20 zeniths of a -0.99..0.99 grid lack a layer). Here the way up lists
every crossed radius but the surface's, as the way down does, and a path is
air and then a palindrome of 2k - 1 shells. ``tests/test_torch_prem_reference.py``
holds the paths, probabilities and atmospheric likelihoods to the
benchmark's plain reference (``m3bench/reference/osc.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import ATYPE

EARTH_RADIUS_KM = 6371.0
#: Default production height of atmospheric neutrinos (km above surface).
PRODUCTION_HEIGHT_KM = 15.0

#: Coarse PREM shells: (outer radius [km], density [g/cm^3], electron fraction).
#: Standard 4-zone averaging of Dziewonski & Anderson 1981.
PREM_COARSE = (
    (1221.5, 13.0, 0.4656),  # inner core
    (3480.0, 11.3, 0.4656),  # outer core
    (5701.0, 5.0, 0.4957),  # lower mantle
    (6346.6, 3.9, 0.4957),  # upper mantle / transition
    (6371.0, 2.6, 0.4957),  # crust
)


def path_through_earth(
    cos_zenith: np.ndarray,
    shells: tuple = PREM_COARSE,
    production_height_km: float = PRODUCTION_HEIGHT_KM,
    detector_depth_km: float = 0.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chord decomposition for each zenith angle.

    cos_zenith: [NZ] (cosZ = 1 down-going from above, -1 up-going through the
    core). Returns (lengths [NZ, NL], rho [NZ, NL], ye [NZ, NL]) zero-padded;
    segments ordered from production to detector: air, then each crossed
    shell going in, the innermost once, and each going out.
    """
    cos_zenith = np.atleast_1d(np.asarray(cos_zenith, np.float64))
    r_det = EARTH_RADIUS_KM - detector_depth_km
    r_prod = EARTH_RADIUS_KM + production_height_km

    radii = np.array([s[0] for s in shells])
    rhos = np.array([s[1] for s in shells])
    yes = np.array([s[2] for s in shells])

    max_segments = 2 * len(shells) + 1
    nz = len(cos_zenith)
    lengths = np.zeros((nz, max_segments))
    rho_out = np.zeros((nz, max_segments))
    ye_out = np.full((nz, max_segments), 0.5)

    for i, cz in enumerate(cos_zenith):
        # Straight line to the detector with direction cosine cz (law of
        # cosines in the Earth-centred frame).
        s_total = np.sqrt(r_prod**2 - r_det**2 * (1.0 - cz**2)) - r_det * cz
        segs: list[tuple[float, float, float]] = []
        if cz >= 0:
            # Down-going: the whole path is air (rho 0) for a surface detector.
            segs.append((s_total, 0.0, 0.5))
        else:
            b = r_det * np.sqrt(1.0 - cz**2)  # impact parameter of the chord
            s_air = s_total - (np.sqrt(EARTH_RADIUS_KM**2 - b**2) - r_det * cz)
            if s_air > 0:
                segs.append((s_air, 0.0, 0.5))
            # The chord crosses every shell with radius > b: the boundaries
            # inside the surface on the way down (outermost first), then the
            # same radii mirrored on the way up to the detector. The innermost
            # crossed shell is entered and left once.
            crossing = radii[radii > b]
            half = {r: np.sqrt(r**2 - b**2) for r in crossing}
            surf_half = np.sqrt(EARTH_RADIUS_KM**2 - b**2)
            det_pos = surf_half + np.sqrt(max(r_det**2 - b**2, 0.0))
            bounds = []
            shells_desc = sorted(crossing)[::-1]  # outermost first
            for r in shells_desc[1:]:
                bounds.append(surf_half - half[r])
            for r in sorted(crossing)[:-1]:
                bounds.append(surf_half + half[r])
            bounds = sorted(set(b_ for b_ in bounds if 0.0 < b_ < det_pos))
            positions = [0.0] + bounds + [det_pos]
            for p0, p1 in zip(positions[:-1], positions[1:]):
                x = 0.5 * (p0 + p1) - surf_half
                r_mid = np.sqrt(b**2 + x**2)
                shell_idx = min(np.searchsorted(radii, r_mid), len(radii) - 1)
                segs.append((p1 - p0, rhos[shell_idx], yes[shell_idx]))
        for j, (length, rho, ye) in enumerate(segs[:max_segments]):
            lengths[i, j] = length
            rho_out[i, j] = rho
            ye_out[i, j] = ye
    return lengths, rho_out, ye_out


def atmospheric_probabilities(
    params,
    energies,
    cos_zeniths: np.ndarray,
    antineutrino: bool = False,
    shells: tuple = PREM_COARSE,
) -> torch.Tensor:
    """P[..., NZ, NE, 3, 3] over an (E, cosZ) grid: the table the sample
    layer gathers per event. The per-segment electron fraction is folded into
    an effective density ``rho * ye / 0.5``, so ``ye=0.5`` below is exact."""
    from .prob import probabilities_layered

    lengths, rho, ye = path_through_earth(cos_zeniths, shells)
    return probabilities_layered(
        params,
        torch.as_tensor(energies, dtype=ATYPE),
        torch.from_numpy(lengths),
        torch.from_numpy(rho * (ye / 0.5)),
        ye=0.5,
        antineutrino=antineutrino,
    )
