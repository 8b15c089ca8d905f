"""The frozen yardstick of the layered oscillation: the bytes and float32
operations that one step's layered (atmospheric) probability grids need,
counted from the configuration's atmospheric samples (their energy and
zenith grids and production height) and the reference's own PREM paths,
never from the program, so that it reads the same work whatever computes
the grids.

Bytes: the grids written once, [C, NZ, NE, 3, 3] float32 for neutrinos and
for antineutrinos. Operations: 216 float32 operations (27 complex
multiply-adds) per 3x3 complex product, ⌈n/2⌉ products per zenith, energy,
chain and neutrino or antineutrino for a path of n layers: the earth's part
of a path is palindromic, so a scheme may form half of it and mirror it,
and each layer's operator takes a product to form. Samples with the same
grids and height share one grid's work. A floor is ``counts.floor_s`` of
the two.

The per-layer metrics' context carries each sample's reweighting work but
not its oscillation grids: :func:`run_inputs` finds the run's inputs in the
frames of the harness's run that reads the metric."""
from __future__ import annotations

import sys

from .reference.osc import prem_paths

#: float32 operations of one 3x3 complex matrix product (27 complex
#: multiply-adds of 8 real operations each).
OPS_PER_PRODUCT = 216


def run_inputs():
    """The inputs (:class:`~m3bench.fixtures.Inputs`) of the run whose
    frame, or a caller's, holds them as ``inputs`` (``run.main``'s), else
    None."""
    frame = sys._getframe(1)
    while frame is not None:
        inputs = frame.f_locals.get("inputs")
        if inputs is not None and hasattr(inputs, "samples"):
            return inputs
        frame = frame.f_back
    return None


def layered_grids(inputs) -> list[tuple[int, list[int]]]:
    """(energies, layers of each zenith's path) of each distinct layered
    grid of the atmospheric samples of ``inputs``."""
    grids = {}
    for s in inputs.samples:
        o = s.osc
        if o["kind"] != "atmo":
            continue
        key = (o["e_grid"].tobytes(), o["cosz_grid"].tobytes(), o["production_height_km"])
        if key not in grids:
            paths = prem_paths(o["cosz_grid"], o["production_height_km"])
            grids[key] = (len(o["e_grid"]), [len(lengths) for lengths, _ in paths])
    return list(grids.values())


def layered(inputs, n_chains: int) -> tuple[float, float]:
    """(bytes, operations) of one step's layered grids at ``n_chains``."""
    n_bytes = ops = 0.0
    for n_e, layers in layered_grids(inputs):
        n_bytes += 2 * n_chains * len(layers) * n_e * 9 * 4
        ops += 2 * n_chains * n_e * OPS_PER_PRODUCT * sum((n + 1) // 2 for n in layers)
    return n_bytes, ops
