"""Config-driven factories (port of ``mach3_tpu/fitters/factory.py``;
``Fitters/MaCh3Factory.cpp``).

* :func:`make_fitter` — fitter by ``General.FittingAlgorithm``
  (``MaCh3FitterFactory``, ``MaCh3Factory.cpp:5-38``): MR2T2, DelayedMR2T2,
  HMC / NUTS / MALA, Ensemble, ParallelTempering (PTMCMC, PT), PSO and the
  minimiser, with the JAX package's config keys,
* :func:`manager_from_args` — Config from argv with ``Key:Sub:Value``
  overrides and ``--override second.yaml`` merging (``MaCh3Factory.cpp:41-80``),
* :func:`make_parameter_set` — covariance factory: YAML + fixed params + step
  scales + PCA (``MaCh3CovarianceFactory``, ``MaCh3Factory.h:69-120``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.config import Config, load_configs
from ..core.exceptions import ConfigError
from ..params.parameterset import ParameterSet
from .delayed import DelayedConfig, DelayedMR2T2
from .ensemble import EnsembleConfig, EnsembleSampler
from .hmc import HMC, HMCConfig
from .mcmc import MR2T2, MCMCConfig
from .model import FitModel
from .pso import PSOConfig, run_pso
from .tempering import ParallelTempering, PTConfig


def manager_from_args(argv: Sequence[str]) -> Config:
    """argv: [config.yaml, ..., --override extra.yaml, Key:Sub:Value, ...]."""
    files: list[str] = []
    overrides: list[str] = []
    override_files: list[str] = []
    it = iter(argv)
    for a in it:
        if a == "--override":
            override_files.append(next(it))
        elif a.endswith((".yaml", ".yml")):
            files.append(a)
        elif ":" in a:
            overrides.append(a)
        else:
            raise ConfigError(f"Unrecognised argument: {a}")
    cfg = load_configs(files)
    for f in override_files:
        cfg.merge(Config.from_file(f))
    cfg.override(*overrides)
    return cfg


def make_parameter_set(
    cfg: Config,
    name: str = "params",
    fixed: Sequence[str] = (),
    step_scale: float | None = None,
    pca_threshold: float | None = None,
    pca_params: tuple[int, int] | None = None,
) -> ParameterSet:
    """Covariance factory (``MaCh3CovarianceFactory``, ``MaCh3Factory.h:69-120``).
    PCA follows the reference config: ``PCAThreshold`` (absent/-1 = off) and
    ``PCAParams: [first, last]`` (-999 = full range), read from the YAML
    unless given."""
    ps = ParameterSet.from_config(cfg, name=name)
    for pname in fixed:
        ps.fix_parameter(pname)
    if step_scale is not None:
        ps.global_step_scale = step_scale
    if pca_threshold is None:
        raw = cfg.get("PCAThreshold", -1)
        pca_threshold = float(raw) if raw is not None else -1.0
    if pca_params is None:
        raw = cfg.get("PCAParams", [-999, -999]) or [-999, -999]
        pca_params = (int(raw[0]), int(raw[1]))
    if pca_threshold > 0:
        first = 0 if pca_params[0] == -999 else pca_params[0]
        last = None if pca_params[1] == -999 else pca_params[1]
        ps.construct_pca(pca_threshold, first=first, last=last)
    return ps


def _mcmc_section(cfg: Config) -> Config:
    return cfg.sub("General").sub("MCMC") if cfg.has("General.MCMC") else Config({})


def _mcmc_config(cfg: Config) -> MCMCConfig:
    g = _mcmc_section(cfg)
    adaption = cfg.get("AdaptionOptions.Settings", {}) or {}
    return MCMCConfig(
        n_steps=int(g.get("NSteps", 10000)),
        chunk_size=int(g.get("AutoSave", 500)),
        anneal_temp=g.get("AnnealTemp", None),
        adaptive=bool(cfg.get("AdaptionOptions.Covariance", {}) or adaption),
        adaption_mode=str(adaption.get("Mode", "pooled")),
        adaption_start_throw=int(adaption.get("StartThrow", 1000)),
        adaption_start_update=int(adaption.get("StartUpdate", 100)),
        adaption_end_update=int(adaption.get("EndUpdate", 1_000_000)),
        adaption_update_step=int(adaption.get("UpdateStep", 100)),
        adaption_blocks=_adaption_blocks(cfg),
        record_breakdown=bool(g.get("RecordLLHBreakdown", False)),
    )


def _adaption_blocks(cfg: Config):
    """``AdaptionOptions.Covariance.MatrixBlocks`` — flat (lb, ub) index pairs
    per block (``AdaptiveMCMCHandler.cpp:121-135``)."""
    blocks = cfg.get("AdaptionOptions.Covariance.MatrixBlocks", None)
    if not blocks:
        return None
    return tuple(tuple(int(x) for x in b) for b in blocks)


class _PSORunner:
    """``run()`` of the particle swarm (``fitters/pso.py``)."""

    def __init__(self, model: FitModel, config: PSOConfig, seed: int):
        self.model, self.config, self.seed = model, config, seed

    def run(self):
        return run_pso(self.model, self.config, seed=self.seed)


class _MinimizerRunner:
    """``run()`` of the L-BFGS-B fit with Hesse (``fitters/minimize.py``)."""

    def __init__(self, model: FitModel):
        self.model = model

    def run(self):
        from .minimize import run_minimizer

        return run_minimizer(self.model)


def make_fitter(cfg: Config, model: FitModel, init_theta: np.ndarray | None = None,
                seed: int = 0):
    """Fitter by ``General.FittingAlgorithm`` (default MR2T2), with
    ``General.MCMC.NChains`` chains at the prefit point unless ``init_theta``
    is given."""
    algo = str(cfg.get("General.FittingAlgorithm", "MR2T2"))
    n_chains = int(cfg.get("General.MCMC.NChains", 8))
    if init_theta is None:
        init_theta = np.tile(model.prefit_vector().cpu().numpy(), (n_chains, 1))
    g = _mcmc_section(cfg)

    if algo in ("MR2T2", "MCMC"):
        return MR2T2(model, _mcmc_config(cfg), init_theta, seed=seed)
    if algo == "DelayedMR2T2":
        base = _mcmc_config(cfg)
        dc = DelayedConfig(
            **{f: getattr(base, f) for f in base.__dataclass_fields__},
            decay_rate=float(g.get("DecayRate", 0.1)),
            max_rejections=int(g.get("MaxRejections", 1)),
            initial_scale=float(g.get("InitialScale", 1.0)),
            delay_probability=float(g.get("DelayProbability", 1.0)),
        )
        return DelayedMR2T2(model, dc, init_theta, seed=seed)
    if algo in ("HMC", "NUTS", "MALA"):
        if algo == "MALA":
            # Metropolis-adjusted Langevin: HMC with exactly one leapfrog step;
            # optimal acceptance 0.574 (Roberts & Rosenthal).
            hc = HMCConfig(n_steps=int(g.get("NSteps", 1000)), n_leapfrog=1,
                           jitter_trajectory=False, step_size=float(g.get("StepSize", 0.01)),
                           target_accept=float(g.get("TargetAccept", 0.574)))
        else:
            hc = HMCConfig(
                n_steps=int(g.get("NSteps", 1000)),
                n_leapfrog=int(g.get("NLeapfrog", 16)),
                step_size=float(g.get("StepSize", 0.01)),
                target_accept=float(g.get("TargetAccept", 0.8)),
                # ChEES cross-chain trajectory adaptation (the NUTS answer).
                adapt_trajectory=bool(g.get("AdaptTrajectory", algo == "NUTS")),
                max_leapfrog=int(g.get("MaxLeapfrog", 128)),
            )
        return HMC(model, hc, init_theta, seed=seed)
    if algo == "Ensemble":
        ec = EnsembleConfig(n_steps=int(g.get("NSteps", 10000)),
                            chunk_size=int(g.get("AutoSave", 500)),
                            stretch_a=float(cfg.get("General.Ensemble.StretchA", 2.0)))
        n_walkers = max(n_chains, 2 * model.n_params)
        if init_theta.shape[0] != n_walkers:
            reps = -(-n_walkers // init_theta.shape[0])
            init_theta = np.tile(init_theta, (reps, 1))[:n_walkers]
            rng = np.random.default_rng(seed)
            init_theta = init_theta + 1e-4 * rng.normal(size=init_theta.shape)
        return EnsembleSampler(model, ec, init_theta, seed=seed)
    if algo in ("ParallelTempering", "PTMCMC", "PT"):
        pc = PTConfig(
            n_steps=int(g.get("NSteps", 1000)),
            chunk_size=int(g.get("AutoSave", 100)),
            n_temps=int(cfg.get("General.PT.NTemps", 8)),
            max_temp=float(cfg.get("General.PT.MaxTemp", 64.0)),
            swap_every=int(cfg.get("General.PT.SwapEvery", 1)),
            scale_throws=bool(cfg.get("General.PT.ScaleThrows", True)),
            beta_zero=bool(cfg.get("General.PT.BetaZero", False)),
        )
        return ParallelTempering(model, pc, init_theta, seed=seed)
    if algo == "PSO":
        return _PSORunner(model, PSOConfig(
            n_particles=int(cfg.get("General.PSO.Particles", 64)),
            n_iterations=int(cfg.get("General.PSO.Iterations", 500))), seed)
    if algo in ("Minuit2", "Minimizer", "LBFGS"):
        return _MinimizerRunner(model)
    raise ConfigError(f"Unknown fitting algorithm '{algo}'")
