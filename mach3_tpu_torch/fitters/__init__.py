from .delayed import DelayedConfig, DelayedMR2T2
from .factory import make_fitter, make_parameter_set, manager_from_args
from .mcmc import MR2T2, AdaptiveState, ChainState, MCMCConfig, make_step_fn_args
from .model import FitModel

__all__ = [
    "DelayedConfig",
    "DelayedMR2T2",
    "make_fitter",
    "make_parameter_set",
    "manager_from_args",
    "MR2T2",
    "AdaptiveState",
    "ChainState",
    "MCMCConfig",
    "make_step_fn_args",
    "FitModel",
]
