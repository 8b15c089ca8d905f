"""Oscillation-specific posterior processing.

Port of ``mach3_tpu/diagnostics/oscprocessor.py`` (numpy on the host), the
equivalent of ``Fitters/OscProcessor.h/.cpp``: Jarlskog-invariant
posterior (including the flat-sin(deltaCP) prior reweighting and normal/
inverted-ordering splits) and deltaCP/ordering probability tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .processor import ChainProcessor


def jarlskog(
    sin2th12: np.ndarray, sin2th13: np.ndarray, sin2th23: np.ndarray, dcp: np.ndarray
) -> np.ndarray:
    """J = s12 c12 s13 c13^2 s23 c23 sin(dcp) from sin^2 posteriors
    (``OscProcessor`` Jarlskog computation)."""
    s12 = np.sqrt(sin2th12)
    c12 = np.sqrt(1.0 - sin2th12)
    s13 = np.sqrt(sin2th13)
    c13sq = 1.0 - sin2th13
    s23 = np.sqrt(sin2th23)
    c23 = np.sqrt(1.0 - sin2th23)
    return s12 * c12 * s13 * c13sq * s23 * c23 * np.sin(dcp)


@dataclasses.dataclass
class JarlskogResult:
    j: np.ndarray  # per-draw Jarlskog invariant
    weights: np.ndarray
    j_no: np.ndarray  # draws with dm31 > 0
    j_io: np.ndarray  # draws with dm31 < 0
    p_normal_ordering: float
    p_cp_conserving_excluded: dict  # credible masses excluding J = 0


class OscProcessor(ChainProcessor):
    """ChainProcessor + oscillation extras. Parameter names must include the
    sin^2 angles, delta_cp, and dm2_31 (configurable)."""

    def __init__(
        self,
        draws,
        names,
        th12: str = "osc_sin2th12",
        th13: str = "osc_sin2th13",
        th23: str = "osc_sin2th23",
        dcp: str = "osc_delta_cp",
        dm31: str = "osc_dm2_31",
        **kwargs,
    ):
        super().__init__(draws, names=names, **kwargs)
        self._idx = {k: self.names.index(v) for k, v in
                     dict(th12=th12, th13=th13, th23=th23, dcp=dcp, dm31=dm31).items()}

    def flat_sin_dcp_weights(self) -> np.ndarray:
        """Reweight a flat-in-deltaCP chain to flat-in-sin(deltaCP)
        (``OscProcessor`` prior reweighting): w = |cos(deltaCP)|."""
        dcp = self.flat[:, self._idx["dcp"]]
        return np.abs(np.cos(dcp))

    def jarlskog_analysis(
        self, flat_sin_dcp_prior: bool = False, credible=(0.6827, 0.9545, 0.9973)
    ) -> JarlskogResult:
        f = self.flat
        j = jarlskog(
            f[:, self._idx["th12"]],
            f[:, self._idx["th13"]],
            f[:, self._idx["th23"]],
            f[:, self._idx["dcp"]],
        )
        w = self.weights.copy()
        if flat_sin_dcp_prior:
            w = w * self.flat_sin_dcp_weights()
        dm31 = f[:, self._idx["dm31"]]
        no = dm31 > 0
        p_no = float(w[no].sum() / w.sum())

        # Is J = 0 (CP conservation) outside the HPD credible interval?
        counts, edges = np.histogram(j, bins=200, weights=w)
        centers = 0.5 * (edges[:-1] + edges[1:])
        order = np.argsort(counts)[::-1]
        excl = {}
        for mass in credible:
            acc, included = 0.0, np.zeros(len(counts), bool)
            target = mass * counts.sum()
            for i in order:
                included[i] = True
                acc += counts[i]
                if acc >= target:
                    break
            zero_bin = np.searchsorted(edges, 0.0) - 1
            inside = 0 <= zero_bin < len(counts) and included[zero_bin]
            excl[mass] = not inside
        return JarlskogResult(
            j=j,
            weights=w,
            j_no=j[no],
            j_io=j[~no],
            p_normal_ordering=p_no,
            p_cp_conserving_excluded=excl,
        )

    def ordering_octant_table(self) -> dict:
        """2x2 posterior-probability table: (NO/IO) x (lower/upper octant)
        (``OscProcessor`` deltaCP pie-chart inputs)."""
        f = self.flat
        w = self.weights
        no = f[:, self._idx["dm31"]] > 0
        upper = f[:, self._idx["th23"]] > 0.5
        total = w.sum()
        return {
            "NO_lower": float(w[no & ~upper].sum() / total),
            "NO_upper": float(w[no & upper].sum() / total),
            "IO_lower": float(w[~no & ~upper].sum() / total),
            "IO_upper": float(w[~no & upper].sum() / total),
        }
