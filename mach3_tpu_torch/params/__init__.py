from .parameterset import (
    KinematicCut,
    ParamMeta,
    ParamType,
    ParameterSet,
    SplineInterpolation,
    make_pos_def,
)
from .state import PriorModel, circular_wrap, prior_logl, propose_step_batch

__all__ = [
    "KinematicCut",
    "ParamMeta",
    "ParamType",
    "ParameterSet",
    "SplineInterpolation",
    "make_pos_def",
    "PriorModel",
    "circular_wrap",
    "prior_logl",
    "propose_step_batch",
]
