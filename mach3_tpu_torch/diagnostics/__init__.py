"""Chain storage, convergence and evidence diagnostics (port of
``mach3_tpu/diagnostics``: ``chain_io``, ``rhat`` and ``evidence`` so far;
numpy on the host)."""
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
from .rhat import StreamingRhat, folded_rhat, rank_normalised_rhat, rhat, split_rhat

__all__ = [
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
    "StreamingRhat",
    "folded_rhat",
    "rank_normalised_rhat",
    "rhat",
    "split_rhat",
]
