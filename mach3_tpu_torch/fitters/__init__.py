from .delayed import DelayedConfig, DelayedMR2T2
from .ensemble import EnsembleConfig, EnsembleSampler
from .factory import make_fitter, make_parameter_set, manager_from_args
from .mcmc import MR2T2, AdaptiveState, ChainState, MCMCConfig, make_step_fn_args
from .model import FitModel
from .pso import PSOConfig, PSOResult, run_pso
from .scans import (
    drag_race,
    llh_map,
    llh_scan_1d,
    llh_scan_2d,
    sigma_variations,
    step_scale_from_scan,
)
from .tempering import ParallelTempering, PTConfig, PTState, pt_betas, temperature_ladder

__all__ = [
    "DelayedConfig",
    "DelayedMR2T2",
    "EnsembleConfig",
    "EnsembleSampler",
    "make_fitter",
    "make_parameter_set",
    "manager_from_args",
    "MR2T2",
    "AdaptiveState",
    "ChainState",
    "MCMCConfig",
    "make_step_fn_args",
    "FitModel",
    "PSOConfig",
    "PSOResult",
    "run_pso",
    "drag_race",
    "llh_map",
    "llh_scan_1d",
    "llh_scan_2d",
    "sigma_variations",
    "step_scale_from_scan",
    "ParallelTempering",
    "PTConfig",
    "PTState",
    "pt_betas",
    "temperature_ladder",
]
