from .mcmc import MR2T2, ChainState, MCMCConfig, make_step_fn_args
from .model import FitModel

__all__ = ["MR2T2", "ChainState", "MCMCConfig", "make_step_fn_args", "FitModel"]
