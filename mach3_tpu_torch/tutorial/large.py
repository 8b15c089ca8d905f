"""The reference-scale fixture: a 3-sample, 101-parameter, ~450k-event fit
(port of ``build_large`` in ``mach3_tpu/tutorial/large.py``, built without
jax).

* ``numu_beam``: 2-D (E_reco x theta_reco) binning, 48 x 24 = 1,152 bins, no
  functional shift -> static bins -> the shared kernel.
* ``nue_beam``: 60k events, 30 E_reco bins, one energy-scale shift on the
  binned axis -> the shifted kernel with P > 16 (the TPU's K3).
* ``atmo``: 200k events, 2-D (log E_reco x cosZ_reco), 40 x 25 = 1,000 bins,
  layered-PREM oscillation over an (E, cosZ) grid, static bins -> the shared
  kernel.

Parameters: 30 normalisations (flux by E_true bin, xsec by mode x target, NC
and nubar), 64 splines cycling the five interpolation families, mode- and
sample-filtered, one energy scale, 6 oscillation parameters. The numpy random
calls are the JAX package's, in the same order, so ``build_large(seed=s)``
gives the same events, norm matches and spline tables there and here (before
the shared route's event layout). The Asimov data come from the port's plain
route at the prefit point. ``build_large700`` waits (ROADMAP).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import Config
from ..core.device import target_device
from ..core.logging import get_logger
from ..fitters.model import FitModel
from ..params.parameterset import ParameterSet, ParamType
from ..samples.events import (
    EventData,
    build_atmo_osc_config,
    build_osc_config,
    build_sample_model,
    match_norm_params,
)
from ..samples.sample import SampleModel, ShiftSpec
from ..samples.teststats import TestStatistic
from ..splines.monolith import SplineParamSpec, build_dense_table
from .toy import MODE_CCDIS, MODE_CCQE, MODE_CCRES, MODE_NC, osc_config_yaml

_log = get_logger("large")

BASELINE_KM = 295.0
DENSITY = 2.6

_FAMILIES = ["TSpline3", "Linear", "Monotonic", "Akima", "KochanekBartels"]
_MODES = [MODE_CCQE, MODE_CCRES, MODE_CCDIS, MODE_NC]

BEAM_SAMPLES = ["numu_beam", "nue_beam"]
ATMO_SAMPLES = ["atmo"]


def large_xsec_config(n_splines: int = 64) -> dict:
    """Systematics YAML tree at reference scale (schema of
    ``Parameters/ParameterHandlerBase.cpp:277-317``)."""
    systematics = []

    def norm(name, error, **extra):
        syst = {
            "Names": {"FancyName": name},
            "ParameterValues": {"PreFitValue": 1.0},
            "StepScale": {"MCMC": 0.05},
            "Error": error,
            "ParameterBounds": [0.0, 3.0],
            "Type": "Norm",
            "ParameterGroup": "Flux" if name.startswith("flux") else "Xsec",
        }
        syst.update(extra)
        systematics.append({"Systematic": syst})

    # Flux norms in E_true bins (the reference's flux covariance block).
    beam_edges = np.linspace(0.0, 3.0, 9)
    for b in range(8):
        norm(
            f"flux_numu_{b}", 0.08,
            NeutrinoFlavourUnosc=[14, -14],
            KinematicCuts=[{"e_true": [float(beam_edges[b]), float(beam_edges[b + 1])]}],
            SampleNames=BEAM_SAMPLES,
        )
    nue_edges = np.linspace(0.0, 3.0, 5)
    for b in range(4):
        norm(
            f"flux_nue_{b}", 0.10,
            NeutrinoFlavourUnosc=[12, -12],
            KinematicCuts=[{"e_true": [float(nue_edges[b]), float(nue_edges[b + 1])]}],
            SampleNames=BEAM_SAMPLES,
        )
    atmo_edges = np.geomspace(0.5, 100.0, 9)
    for b in range(8):
        norm(
            f"flux_atmo_{b}", 0.12,
            KinematicCuts=[{"e_true": [float(atmo_edges[b]), float(atmo_edges[b + 1])]}],
            SampleNames=ATMO_SAMPLES,
        )
    # Xsec norms by mode x target, plus NC and nubar.
    for mode, mname in [(MODE_CCQE, "ccqe"), (MODE_CCRES, "ccres"),
                        (MODE_CCDIS, "ccdis"), (MODE_NC, "nc")]:
        for tgt, tname in [(12, "C"), (16, "O")]:
            norm(f"norm_{mname}_{tname}", 0.12, Mode=[mode], TargetNuclei=[tgt])
    norm("norm_nc_extra", 0.30, Mode=[MODE_NC])
    norm("norm_nubar", 0.10, NeutrinoFlavour=[-12, -14, -16])

    # Spline systematics cycling interpolation families, mode affinities and
    # sample applicability (every third beam-only, every third atmo-only).
    for i in range(n_splines):
        syst = {
            "Names": {"FancyName": f"spl_{i:03d}"},
            "ParameterValues": {"PreFitValue": 0.0},
            "StepScale": {"MCMC": 0.1},
            "Error": 0.2 + 0.1 * (i % 3),
            "ParameterBounds": [-3.0, 3.0],
            "Type": "Spline",
            "ParameterGroup": "Xsec",
            "Mode": [_MODES[i % 4]],
            "SplineInformation": {
                "SplineName": f"spl_{i:03d}",
                "InterpolationType": _FAMILIES[i % 5],
            },
        }
        if i % 3 == 1:
            syst["SampleNames"] = BEAM_SAMPLES
        elif i % 3 == 2:
            syst["SampleNames"] = ATMO_SAMPLES
        systematics.append({"Systematic": syst})

    # One functional energy-scale parameter for the nue sample.
    systematics.append(
        {
            "Systematic": {
                "Names": {"FancyName": "escale_nue"},
                "ParameterValues": {"PreFitValue": 0.0},
                "StepScale": {"MCMC": 0.2},
                "Error": 0.02,
                "ParameterBounds": [-0.3, 0.3],
                "Type": "Functional",
                "ParameterGroup": "Detector",
                "SampleNames": ["nue_beam"],
            }
        }
    )
    return {"Systematics": systematics}


@dataclasses.dataclass
class LargeExperiment:
    xsec: ParameterSet
    osc: ParameterSet
    samples: list[SampleModel]
    model: FitModel
    names: list[str]

    @property
    def n_params(self) -> int:
        return self.model.n_params


def _beam_events(rng: np.random.Generator, n: int) -> EventData:
    e_true = rng.gamma(shape=3.0, scale=0.25, size=n) + 0.05
    e_reco = np.clip(e_true * (1.0 + 0.08 * rng.normal(size=n)), 0.01, None)
    theta_reco = np.abs(rng.normal(0.0, 15.0, n)) + rng.uniform(0, 5, n)
    mode = rng.choice(_MODES, p=[0.45, 0.25, 0.15, 0.15], size=n)
    target = rng.choice([12, 16], p=[0.6, 0.4], size=n)
    preosc = rng.choice([14, 12, -14], p=[0.90, 0.03, 0.07], size=n)
    det = preosc.copy()
    numu_idx = np.nonzero(np.abs(preosc) == 14)[0]
    appearance = rng.random(len(numu_idx)) < 0.25
    det[numu_idx[appearance]] = np.sign(preosc[numu_idx[appearance]]) * 12
    weight = np.where(np.abs(preosc) == 14,
                      np.where(np.abs(det) == 12, 1 / 0.25, 1 / 0.75), 1.0)
    weight = weight * 50.0 / np.sqrt(np.maximum(e_true, 0.05))
    return EventData(
        kinematics={"e_true": e_true, "e_reco": e_reco, "theta_reco": theta_reco},
        mode=mode.astype(np.int32),
        target=target.astype(np.int32),
        pdg=det.astype(np.int32),
        preosc_pdg=preosc.astype(np.int32),
        mc_weight=(weight / n * 2e5).astype(np.float64),
    )


def _atmo_events(rng: np.random.Generator, n: int) -> EventData:
    # Power-law atmospheric flux, up/down symmetric zenith.
    e_true = 0.5 * (1.0 + rng.pareto(1.7, size=n))
    e_true = np.clip(e_true, 0.5, 100.0)
    e_reco = np.clip(e_true * (1.0 + 0.15 * rng.normal(size=n)), 0.3, 120.0)
    cosz = rng.uniform(-1.0, 1.0, n)
    cosz_reco = np.clip(cosz + 0.08 * rng.normal(size=n), -1.0, 1.0)
    mode = rng.choice(_MODES, p=[0.40, 0.25, 0.20, 0.15], size=n)
    target = rng.choice([12, 16], p=[0.5, 0.5], size=n)
    preosc = rng.choice([14, -14, 12, -12], p=[0.40, 0.30, 0.18, 0.12], size=n)
    det = preosc.copy()
    mu_idx = np.nonzero(np.abs(preosc) == 14)[0]
    appearance = rng.random(len(mu_idx)) < 0.15
    det[mu_idx[appearance]] = np.sign(preosc[mu_idx[appearance]]) * 12
    weight = np.where(np.abs(preosc) == 14,
                      np.where(np.abs(det) == 12, 1 / 0.15, 1 / 0.85), 1.0)
    weight = weight * (e_true / 2.0) ** (-1.0)
    return EventData(
        kinematics={
            "e_true": e_true,
            "e_reco": e_reco,
            "cos_zenith": cosz,
            "cosz_reco": cosz_reco,
        },
        mode=mode.astype(np.int32),
        target=target.astype(np.int32),
        pdg=det.astype(np.int32),
        preosc_pdg=preosc.astype(np.int32),
        mc_weight=(weight / n * 1e5).astype(np.float64),
    )


def _spline_specs_for(
    rng: np.random.Generator, events: EventData, xsec: ParameterSet, sample_name: str
) -> list[SplineParamSpec]:
    """Spline specs for one sample: every spline param that applies to the
    sample gets per-event responses on its affected-mode events."""
    sigma = np.array([-3.0, -1.0, 0.0, 1.0, 3.0])
    specs = []
    for meta in xsec.of_type(ParamType.SPLINE):
        if not meta.applies_to_sample(sample_name):
            continue
        mask = np.isin(events.mode, meta.modes) if meta.modes else np.ones(
            events.n_events, bool
        )
        affected = np.nonzero(mask)[0]
        if len(affected) == 0:
            continue
        n = len(affected)
        slope = 0.06 * (1.0 + 0.3 * rng.normal(size=n))
        curv = 0.008 * rng.normal(size=n)
        y = 1.0 + slope[:, None] * sigma[None, :] + curv[:, None] * sigma[None, :] ** 2
        y = np.clip(y, 0.0, None)
        y[:, 2] = 1.0
        specs.append(
            SplineParamSpec(
                name=meta.name,
                param_index=meta.index,
                x_knots=sigma,
                event_ids=affected,
                y_knots=y,
                interpolation=meta.spline_interpolation,
                knot_low=0.0,
                knot_high=9.0,
            )
        )
    return specs


def _subset(events: EventData, idx: np.ndarray) -> EventData:
    return EventData(
        kinematics={k: v[idx] for k, v in events.kinematics.items()},
        mode=events.mode[idx],
        target=events.target[idx],
        pdg=events.pdg[idx],
        preosc_pdg=events.preosc_pdg[idx],
        mc_weight=events.mc_weight[idx],
    )


def build_large(
    n_numu: int = 250_000,
    n_nue: int = 60_000,
    n_atmo: int = 200_000,
    n_splines: int = 64,
    seed: int = 2026,
    test_statistic: TestStatistic = TestStatistic.BARLOW_BEESTON,
    low_memory: bool = False,
    use_kernel: bool | str = "auto",
    e_grid_size: int = 160,
    atmo_e_grid_size: int = 50,
    atmo_cosz_grid_size: int = 20,
    numu_bins: tuple[int, int] = (48, 24),
    atmo_bins: tuple[int, int] = (40, 25),
    asimov: bool = True,
    device: str | torch.device = "cuda",
) -> LargeExperiment:
    """Build the reference-scale experiment: host arrays on the CPU, the
    model returned on ``device`` (the card by default, raising when none is
    visible; ``device="cpu"`` keeps it on the CPU). Defaults give 101
    parameters and 2,182 bins over three samples. ``low_memory`` stores the
    spline tables in bf16 and evaluates the per-bin statistic in f32 (the
    reference's ``_LOW_MEMORY_STRUCTS_`` analogue, ``Manager/Core.h:27-41``)."""
    dev = target_device(device)
    rng = np.random.default_rng(seed)
    xsec = ParameterSet.from_config(Config(large_xsec_config(n_splines)), name="xsec")
    osc = ParameterSet.from_config(Config(osc_config_yaml()), name="osc")
    n_xsec = len(xsec)
    n_total = n_xsec + len(osc)
    osc_gidx = list(range(n_xsec, n_xsec + 6))
    norm_metas = [(m, m.index) for m in xsec.of_type(ParamType.NORM)]
    escale_idx = xsec.index_of("escale_nue")
    stat_dtype = torch.float32 if low_memory else None

    beam = _beam_events(rng, n_numu + n_nue)
    is_numu_sel = (np.abs(beam.pdg) == 14) & (beam.mode != MODE_NC)
    # the nue selection is capped at n_nue events to keep the stated sizes
    nue_take = np.nonzero((np.abs(beam.pdg) == 12) | (beam.mode == MODE_NC))[0][:n_nue]
    e_grid = np.linspace(0.05, 3.0, e_grid_size)

    def beam_osc(sub):
        # Beam baseline: λL ~ a few rad, f32 phases exact to ~1e-7 rad.
        return build_osc_config(sub, e_grid, osc_gidx, baseline=BASELINE_KM, density=DENSITY,
                                nc_modes=[MODE_NC], phase_dtype=torch.float32)

    samples: list[SampleModel] = []
    common = dict(n_total_params=n_total, test_statistic=test_statistic,
                  stat_dtype=stat_dtype, use_kernel=use_kernel)

    sub = _subset(beam, np.nonzero(is_numu_sel)[0][:n_numu])
    table = build_dense_table(_spline_specs_for(rng, sub, xsec, "numu_beam"), sub.n_events,
                              low_memory=low_memory)
    samples.append(build_sample_model(
        "numu_beam", sub,
        var_order=["e_true", "e_reco", "theta_reco"],
        binning_edges=[np.linspace(0.0, 3.0, numu_bins[0] + 1),
                       np.linspace(0.0, 60.0, numu_bins[1] + 1)],
        binning_vars=["e_reco", "theta_reco"],
        norm_idx=match_norm_params(sub, norm_metas, "numu_beam"),
        spline_table=table, osc=beam_osc(sub), **common,
    ))

    sub = _subset(beam, nue_take)
    table = build_dense_table(_spline_specs_for(rng, sub, xsec, "nue_beam"), sub.n_events,
                              low_memory=low_memory)
    samples.append(build_sample_model(
        "nue_beam", sub,
        var_order=["e_true", "e_reco", "theta_reco"],
        binning_edges=[np.linspace(0.0, 3.0, 31)],
        binning_vars=["e_reco"],
        norm_idx=match_norm_params(sub, norm_metas, "nue_beam"),
        spline_table=table, osc=beam_osc(sub),
        shifts=(ShiftSpec.scale(escale_idx, var_row=1),),  # e_reco
        **common,
    ))

    atmo = _atmo_events(rng, n_atmo)
    table = build_dense_table(_spline_specs_for(rng, atmo, xsec, "atmo"), atmo.n_events,
                              low_memory=low_memory)
    samples.append(build_sample_model(
        "atmo", atmo,
        var_order=["e_true", "e_reco", "cos_zenith", "cosz_reco"],
        binning_edges=[np.geomspace(0.3, 120.0, atmo_bins[0] + 1),
                       np.linspace(-1.0, 1.0, atmo_bins[1] + 1)],
        binning_vars=["e_reco", "cosz_reco"],
        norm_idx=match_norm_params(atmo, norm_metas, "atmo"),
        spline_table=table,
        osc=build_atmo_osc_config(
            atmo,
            e_grid=np.geomspace(0.5, 100.0, atmo_e_grid_size),
            cosz_grid=np.linspace(-0.99, 0.99, atmo_cosz_grid_size),
            osc_param_gidx=osc_gidx,
            nc_modes=[MODE_NC],
        ),
        **common,
    ))

    model = FitModel.build([xsec, osc], samples)
    _log.info("large fixture: %d params, %s events, %s bins", model.n_params,
              [s.n_events for s in samples], [s.n_bins for s in samples])
    if asimov:
        prefit = model.prefit_vector()
        with torch.no_grad():
            for s in samples:
                s.set_data(s.asimov_data(prefit))
    model.to(dev)
    names = [f"xsec_{n}" for n in xsec.names] + [f"osc_{n}" for n in osc.names]
    return LargeExperiment(xsec=xsec, osc=osc, samples=samples, model=model, names=names)
