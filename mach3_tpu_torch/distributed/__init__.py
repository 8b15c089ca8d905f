"""Fits split over processes: a (chains x events) mesh on ``torch.distributed``
(port of ``mach3_tpu/distributed``)."""
from .mesh import (
    CHAIN_AXIS,
    EVENT_AXIS,
    chain_state_sharding,
    make_mesh,
    shard_fit_model,
)

__all__ = [
    "CHAIN_AXIS",
    "EVENT_AXIS",
    "chain_state_sharding",
    "make_mesh",
    "shard_fit_model",
]
