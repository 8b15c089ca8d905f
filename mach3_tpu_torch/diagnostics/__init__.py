"""Chain storage, convergence, evidence and posterior diagnostics (port of
``mach3_tpu/diagnostics``, exporting what it exports). The autocorrelation
family runs in torch on a device (``autocorr``); the rest is numpy on the
host. ``predictive``, ``chaintools``, ``oscprocessor`` and ``statutils`` are
imported by module, as in the JAX package."""
from .autocorr import (
    acceptance_rate_trace,
    autocorrelation_fft,
    batched_means,
    batched_means_variance_ratio,
    effective_sample_size,
    geweke,
    integrated_autocorr_time,
    power_spectrum,
)
from .chain_io import (
    ChainShardWriter,
    combine_chains,
    iter_chain_shards,
    load_chain,
    load_checkpoint,
    save_chain,
    save_checkpoint,
)
from .evidence import log_prior_mass, stepping_stone_log_evidence, thermodynamic_log_evidence
from .processor import ChainProcessor, PosteriorSummary
from .rhat import StreamingRhat, folded_rhat, rank_normalised_rhat, rhat, split_rhat

__all__ = [
    "acceptance_rate_trace",
    "autocorrelation_fft",
    "batched_means",
    "batched_means_variance_ratio",
    "effective_sample_size",
    "geweke",
    "integrated_autocorr_time",
    "power_spectrum",
    "ChainShardWriter",
    "combine_chains",
    "iter_chain_shards",
    "load_chain",
    "load_checkpoint",
    "save_chain",
    "save_checkpoint",
    "log_prior_mass",
    "stepping_stone_log_evidence",
    "thermodynamic_log_evidence",
    "ChainProcessor",
    "PosteriorSummary",
    "StreamingRhat",
    "folded_rhat",
    "rank_normalised_rhat",
    "rhat",
    "split_rhat",
]
