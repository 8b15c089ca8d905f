from .config import Config, load_configs, merge_trees
from .exceptions import ConfigError, MaCh3Error
from .logging import get_logger
from .precision import ATYPE, FTYPE, ITYPE, LARGE_LOGL, LOW_MC_BOUND, disable_tf32

__all__ = [
    "Config",
    "load_configs",
    "merge_trees",
    "ConfigError",
    "MaCh3Error",
    "get_logger",
    "ATYPE",
    "FTYPE",
    "ITYPE",
    "LARGE_LOGL",
    "LOW_MC_BOUND",
    "disable_tf32",
]
