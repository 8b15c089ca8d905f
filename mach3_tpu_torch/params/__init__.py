from .parameterset import (
    KinematicCut,
    ParamMeta,
    ParamType,
    ParameterSet,
    SplineInterpolation,
    make_pos_def,
)
from .state import (
    PriorModel,
    circular_wrap,
    count_out_of_bounds,
    get_likelihood,
    prior_logl,
    propose_step,
    propose_step_batch,
)

__all__ = [
    "KinematicCut",
    "ParamMeta",
    "ParamType",
    "ParameterSet",
    "SplineInterpolation",
    "make_pos_def",
    "PriorModel",
    "circular_wrap",
    "count_out_of_bounds",
    "get_likelihood",
    "prior_logl",
    "propose_step",
    "propose_step_batch",
]
