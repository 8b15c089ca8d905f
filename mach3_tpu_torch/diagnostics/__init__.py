"""Chain storage and convergence diagnostics (port of ``mach3_tpu/diagnostics``:
``chain_io`` and ``rhat`` so far; numpy on the host)."""
from .chain_io import (
    ChainShardWriter,
    combine_chains,
    iter_chain_shards,
    load_chain,
    load_checkpoint,
    save_chain,
    save_checkpoint,
)
from .rhat import StreamingRhat, folded_rhat, rank_normalised_rhat, rhat, split_rhat

__all__ = [
    "ChainShardWriter",
    "combine_chains",
    "iter_chain_shards",
    "load_chain",
    "load_checkpoint",
    "save_chain",
    "save_checkpoint",
    "StreamingRhat",
    "folded_rhat",
    "rank_normalised_rhat",
    "rhat",
    "split_rhat",
]
