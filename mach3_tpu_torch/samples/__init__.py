"""Samples: binning, test statistics, routing, the sample likelihood and its
construction. Only the leaf modules are re-exported here (``splines.reweight``
imports ``samples.binning``); import ``samples.sample`` / ``samples.events``
directly."""
from .binning import SampleBinning, histogram
from .teststats import (
    TestStatistic,
    barlow_beeston_llh,
    dembinski_abdelmotteleb_llh,
    gaussian_llh,
    get_test_stat_fn,
    icecube_llh,
    pearson_llh,
    poisson_llh,
)

__all__ = [
    "SampleBinning",
    "histogram",
    "TestStatistic",
    "barlow_beeston_llh",
    "dembinski_abdelmotteleb_llh",
    "gaussian_llh",
    "get_test_stat_fn",
    "icecube_llh",
    "pearson_llh",
    "poisson_llh",
]
