"""Parameter-set construction from YAML systematics definitions.

Equivalent of the reference's ``ParameterHandlerBase`` YAML parsing
(``Parameters/ParameterHandlerBase.cpp:277-357``) and the typed-parameter layer
of ``ParameterHandlerGeneric`` (``Parameters/ParameterHandlerGeneric.cpp:44-80``).

This module runs at load time in numpy and produces:

* a :class:`ParameterSet` of names + typed metadata used to wire samples, and
* a :class:`mach3_tpu_torch.params.state.PriorModel` of static device arrays consumed
  by the MCMC step (inverse covariance, Cholesky throw matrix, bounds,
  circular/flip proposal tables).

The YAML schema matches the reference: each entry is ``Systematic`` with
``Names.FancyName``, ``ParameterValues.PreFitValue``, ``Error``, ``StepScale.MCMC``,
``ParameterBounds``, ``FlatPrior``, ``FixParam``, ``Correlations`` (reciprocal,
checked), ``SpecialProposal.{CircularBounds,FlipParameter}``, ``Type``
(Norm/Spline/Functional/Osc), ``ParameterGroup``, ``SampleNames``, ``Mode``,
``NeutrinoFlavour``, ``TargetNuclei``, ``KinematicCuts``, ``SplineInformation``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping, Sequence

import numpy as np

from ..core.config import Config
from ..core.exceptions import ConfigError
from ..core.logging import get_logger

_log = get_logger("params")

_INF = 9e9  # effectively-unbounded sentinel used when YAML gives one-sided bounds


class ParamType(enum.Enum):
    """Mirrors ``SystematicType`` (``Parameters/ParameterStructs.h:279-285``)."""

    NORM = "Norm"
    SPLINE = "Spline"
    FUNCTIONAL = "Functional"
    OSC = "Osc"


class SplineInterpolation(enum.Enum):
    """Mirrors ``SplineInterpolation`` (``Splines/SplineStructs.h``)."""

    TSPLINE3 = "TSpline3"
    LINEAR = "Linear"
    MONOTONIC = "Monotonic"
    AKIMA = "Akima"
    KOCHANEK_BARTELS = "KochanekBartels"


@dataclasses.dataclass
class KinematicCut:
    """A selection on a kinematic variable (``Samples/SampleStructs.h:149``)."""

    variable: str
    low: float
    high: float


@dataclasses.dataclass
class ParamMeta:
    """Typed per-parameter metadata (norm/spline/func/osc applicability)."""

    name: str
    index: int
    ptype: ParamType
    group: str = ""
    sample_names: list[str] = dataclasses.field(default_factory=list)
    modes: list[int] = dataclasses.field(default_factory=list)
    pdgs: list[int] = dataclasses.field(default_factory=list)
    preosc_pdgs: list[int] = dataclasses.field(default_factory=list)
    targets: list[int] = dataclasses.field(default_factory=list)
    kinematic_cuts: list[KinematicCut] = dataclasses.field(default_factory=list)
    # Spline-type extras (``ParameterHandlerGeneric.cpp:259-280``)
    spline_name: str = ""
    spline_interpolation: SplineInterpolation = SplineInterpolation.TSPLINE3
    spline_knot_low: float = -_INF
    spline_knot_high: float = _INF
    spline_modes: list[int] = dataclasses.field(default_factory=list)

    def applies_to_sample(self, sample_name: str) -> bool:
        return not self.sample_names or sample_name in self.sample_names


def _parse_bounds(raw: Any) -> tuple[float, float]:
    if raw is None:
        return (-_INF, _INF)
    lo, hi = float(raw[0]), float(raw[1])
    return (lo, hi)


def _parse_kinematic_cuts(raw: Any) -> list[KinematicCut]:
    cuts: list[KinematicCut] = []
    if not raw:
        return cuts
    for entry in raw:
        for var, bounds in dict(entry).items():
            cuts.append(KinematicCut(var, float(bounds[0]), float(bounds[1])))
    return cuts


class ParameterSet:
    """All systematic parameters of one handler, with typed metadata.

    Also provides group fix/free queries analogous to
    ``ParameterHandlerGeneric.h:100-124`` and per-sample filtered views
    analogous to ``GetSplineParsFromSampleName`` etc.
    """

    def __init__(
        self,
        names: Sequence[str],
        prefit: np.ndarray,
        errors: np.ndarray,
        step_scales: np.ndarray,
        low_bounds: np.ndarray,
        up_bounds: np.ndarray,
        flat_prior: np.ndarray,
        fixed: np.ndarray,
        covariance: np.ndarray,
        meta: Sequence[ParamMeta],
        circ_mask: np.ndarray,
        circ_low: np.ndarray,
        circ_high: np.ndarray,
        flip_mask: np.ndarray,
        flip_point: np.ndarray,
        name: str = "params",
    ):
        self.name = name
        self.names = list(names)
        self.prefit = prefit
        self.errors = errors
        self.step_scales = step_scales
        self.low_bounds = low_bounds
        self.up_bounds = up_bounds
        self.flat_prior = flat_prior
        self.fixed = fixed
        self.covariance = covariance
        self.meta = list(meta)
        self.circ_mask = circ_mask
        self.circ_low = circ_low
        self.circ_high = circ_high
        self.flip_mask = flip_mask
        self.flip_point = flip_point
        self.global_step_scale = 1.0
        # Proposal (throw) matrix — defaults to the prior covariance but can
        # be overridden wholesale or per sub-block, mirroring the reference's
        # SetThrowMatrix / throw-matrix sub-block file overrides
        # (``Parameters/ParameterHandlerBase.cpp:158-236``).
        self._throw_matrix: np.ndarray | None = None
        # PCA-reduced proposal basis (``ConstructPCA``,
        # ``Parameters/ParameterHandlerBase.h:311``): when set, the proposal
        # Cholesky becomes the rectangular [P, K] PCA throw factor.
        self.pca = None  # params.pca.PCAResult | None

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise ConfigError(f"Parameter '{name}' not in set '{self.name}'") from None

    def of_type(self, ptype: ParamType, sample_name: str | None = None) -> list[ParamMeta]:
        out = [m for m in self.meta if m.ptype is ptype]
        if sample_name is not None:
            out = [m for m in out if m.applies_to_sample(sample_name)]
        return out

    def groups(self) -> list[str]:
        seen: dict[str, None] = {}
        for m in self.meta:
            seen.setdefault(m.group)
        return list(seen)

    def fix_parameter(self, name_or_index: str | int) -> None:
        i = name_or_index if isinstance(name_or_index, int) else self.index_of(name_or_index)
        self.fixed[i] = True

    def free_parameter(self, name_or_index: str | int) -> None:
        i = name_or_index if isinstance(name_or_index, int) else self.index_of(name_or_index)
        self.fixed[i] = False

    def fix_group(self, group: str) -> None:
        for m in self.meta:
            if m.group == group:
                self.fixed[m.index] = True

    # ------------------------------------------------- throw-matrix override
    @property
    def throw_matrix(self) -> np.ndarray:
        """Proposal covariance: the prior covariance unless overridden."""
        return self.covariance if self._throw_matrix is None else self._throw_matrix

    def set_throw_matrix(self, matrix: np.ndarray) -> None:
        """Replace the full proposal covariance (``SetThrowMatrix``,
        ``Parameters/ParameterHandlerBase.cpp:1104+``). Must be pos-def of
        matching dimension; made pos-def with diagonal inflation if needed."""
        matrix = np.asarray(matrix, np.float64)
        if matrix.shape != (len(self), len(self)):
            raise ConfigError(
                f"Throw matrix shape {matrix.shape} != ({len(self)}, {len(self)})"
            )
        self._throw_matrix = make_pos_def(matrix)

    def set_throw_submatrix(
        self, names: Sequence[str], submatrix: np.ndarray
    ) -> None:
        """Override the proposal covariance for a named sub-block, zeroing its
        correlations with the rest (the reference's throw-matrix sub-block
        override from file, ``Parameters/ParameterHandlerBase.cpp:158-236``)."""
        idx = np.asarray([self.index_of(n) for n in names], np.int64)
        submatrix = np.asarray(submatrix, np.float64)
        if submatrix.shape != (len(idx), len(idx)):
            raise ConfigError(
                f"Sub-matrix shape {submatrix.shape} != ({len(idx)}, {len(idx)})"
            )
        full = np.array(self.throw_matrix, np.float64)
        full[np.ix_(idx, idx)] = submatrix
        # Cross terms between the overridden block and everything else are no
        # longer meaningful — zero them, as the reference does when splicing.
        rest = np.setdiff1d(np.arange(len(self)), idx)
        full[np.ix_(idx, rest)] = 0.0
        full[np.ix_(rest, idx)] = 0.0
        self._throw_matrix = make_pos_def(full)

    # ------------------------------------------------------------------ PCA
    def construct_pca(
        self, threshold: float, first: int = 0, last: int | None = None
    ) -> None:
        """Decompose (a sub-block of) the throw matrix and walk the chain in
        the reduced basis (``ConstructPCA``, ``PCAHandler.cpp:25-130``; config
        keys ``PCAThreshold`` / ``PCAParams`` in ``MaCh3Factory.h:80-85``).

        The proposal Cholesky becomes the rectangular [P, K] factor; the
        Gaussian prior is still evaluated in parameter space with the full
        covariance, exactly like the reference.
        """
        from .pca import construct_pca as _construct

        self.pca = _construct(
            self.throw_matrix, threshold=threshold, first=first, last=last
        )

    def set_throw_matrix_from_file(self, path: str, key: str = "matrix") -> None:
        """Load a (sub-)throw matrix from an npz file with ``matrix`` and
        optional ``names`` arrays; with names present only that block is
        overridden."""
        with np.load(path, allow_pickle=False) as f:
            matrix = f[key]
            names = [str(n) for n in f["names"]] if "names" in f.files else None
        if names is None:
            self.set_throw_matrix(matrix)
        else:
            self.set_throw_submatrix(names, matrix)

    # ------------------------------------------------------- construction
    @classmethod
    def from_config(cls, cfg: Config | Mapping[str, Any], name: str = "params") -> "ParameterSet":
        if not isinstance(cfg, Config):
            cfg = Config(cfg)
        systematics = cfg.get("Systematics")
        n = len(systematics)
        if n <= 0:
            raise ConfigError("Systematics list is empty")

        names: list[str] = []
        prefit = np.zeros(n)
        errors = np.ones(n)
        step_scales = np.ones(n)
        low_bounds = np.full(n, -_INF)
        up_bounds = np.full(n, _INF)
        flat_prior = np.zeros(n, dtype=bool)
        fixed = np.zeros(n, dtype=bool)
        circ_mask = np.zeros(n, dtype=bool)
        circ_low = np.zeros(n)
        circ_high = np.zeros(n)
        flip_mask = np.zeros(n, dtype=bool)
        flip_point = np.zeros(n)
        meta: list[ParamMeta] = []
        correlations: list[dict[str, float]] = []

        for i, entry in enumerate(systematics):
            p = Config(entry).sub("Systematic")
            fancy = p.get("Names.FancyName")
            names.append(fancy)
            prefit[i] = float(p.get("ParameterValues.PreFitValue"))
            step_scales[i] = float(p.get("StepScale.MCMC"))
            errors[i] = float(p.get("Error"))
            if errors[i] <= 0:
                raise ConfigError(f"Error for param {fancy}({i}) is not positive: {errors[i]}")
            low_bounds[i], up_bounds[i] = _parse_bounds(p.get("ParameterBounds", None))
            flat_prior[i] = bool(p.get("FlatPrior", False))
            fixed[i] = bool(p.get("FixParam", False))

            sp = p.get("SpecialProposal", None)
            if sp is not None:
                sp = Config(sp)
                circ = sp.get("CircularBounds", None)
                flip = sp.get("FlipParameter", None)
                if circ is None and flip is None:
                    raise ConfigError(f"SpecialProposal for {fancy} enables nothing")
                if circ is not None:
                    circ_mask[i] = True
                    circ_low[i], circ_high[i] = float(circ[0]), float(circ[1])
                    if circ_low[i] < low_bounds[i] or circ_high[i] > up_bounds[i]:
                        raise ConfigError(
                            f"Circular bounds for {fancy} exceed physical bounds"
                        )
                if flip is not None:
                    flip_mask[i] = True
                    flip_point[i] = float(flip)
                    if circ is not None:
                        lo, hi = circ_low[i], circ_high[i]
                        fl, fh = 2 * flip_point[i] - lo, 2 * flip_point[i] - hi
                        if min(fl, fh) < lo or max(fl, fh) > hi:
                            raise ConfigError(
                                f"Flip point for {fancy} leaves circular bounds"
                            )

            correlations.append({})
            for corr_entry in p.get("Correlations", []) or []:
                for other, rho in dict(corr_entry).items():
                    correlations[i][other] = float(rho)

            ptype = ParamType(p.get("Type", "Norm"))
            m = ParamMeta(
                name=fancy,
                index=i,
                ptype=ptype,
                group=str(p.get("ParameterGroup", "")),
                sample_names=list(p.get("SampleNames", []) or []),
                modes=[int(x) for x in p.get("Mode", []) or []],
                pdgs=[int(x) for x in p.get("NeutrinoFlavour", []) or []],
                preosc_pdgs=[int(x) for x in p.get("NeutrinoFlavourUnosc", []) or []],
                targets=[int(x) for x in p.get("TargetNuclei", []) or []],
                kinematic_cuts=_parse_kinematic_cuts(p.get("KinematicCuts", None)),
            )
            if ptype is ParamType.SPLINE:
                sp_info = Config(p.get("SplineInformation", {}) or {})
                m.spline_name = str(sp_info.get("SplineName", fancy))
                m.spline_interpolation = SplineInterpolation(
                    sp_info.get("InterpolationType", "TSpline3")
                )
                m.spline_knot_low = float(sp_info.get("SplineKnotLowBound", -_INF))
                m.spline_knot_high = float(sp_info.get("SplineKnotUpBound", _INF))
                m.spline_modes = [int(x) for x in sp_info.get("Mode", []) or []]
            meta.append(m)

        cov = _build_covariance(names, errors, correlations)
        cov = make_pos_def(cov)

        return cls(
            names,
            prefit,
            errors,
            step_scales,
            low_bounds,
            up_bounds,
            flat_prior,
            fixed,
            cov,
            meta,
            circ_mask,
            circ_low,
            circ_high,
            flip_mask,
            flip_point,
            name=name,
        )


def _build_covariance(
    names: Sequence[str], errors: np.ndarray, correlations: Sequence[dict[str, float]]
) -> np.ndarray:
    """Assemble the prior covariance from per-parameter errors and pairwise
    correlations, enforcing reciprocity (``ParameterHandlerBase.cpp:322-353``)."""
    n = len(names)
    index = {nm: i for i, nm in enumerate(names)}
    cov = np.diag(errors**2).astype(np.float64)
    for i in range(n):
        for other, rho in correlations[i].items():
            if other not in index:
                raise ConfigError(f"Correlation partner '{other}' of {names[i]} unknown")
            j = index[other]
            back = correlations[j].get(names[i])
            if back is None:
                raise ConfigError(
                    f"Correlation not reciprocal between {names[i]} and {other}"
                )
            if abs(back - rho) > np.finfo(np.float32).eps:
                raise ConfigError(
                    f"Correlations disagree between {names[i]} and {other}: {rho} vs {back}"
                )
            cov[i, j] = cov[j, i] = rho * errors[i] * errors[j]
    return cov


def make_pos_def(cov: np.ndarray, max_tries: int = 50) -> np.ndarray:
    """Nudge a symmetric matrix to positive-definiteness
    (reference ``ParameterHandlerBase.cpp`` ``MakePosDef``): scale up the
    diagonal slightly until Cholesky succeeds."""
    cov = 0.5 * (cov + cov.T)
    eps = 0.0
    for _ in range(max_tries):
        try:
            np.linalg.cholesky(cov + eps * np.diag(np.diag(cov)))
            if eps > 0:
                _log.warning("Covariance made pos-def with diagonal inflation %.2e", eps)
            return cov + eps * np.diag(np.diag(cov))
        except np.linalg.LinAlgError:
            eps = max(eps * 10.0, 1e-12)
    raise ConfigError("Could not make covariance positive definite")
