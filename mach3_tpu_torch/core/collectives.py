"""The collectives of a sharded step (``torch.distributed``).

A step on a (chains x events) mesh (``distributed/``) sums its partial
histograms over the event shards and averages the pooled adaptive moments
over the chain shards. Each reduction packs its tensors into one buffer per
dtype, so a step issues one all-reduce per reduction and dtype: each NCCL
call is a launch, and the sums are the same.

NCCL reduces the card's tensors in place, inside a CUDA graph too. Gloo
reduces them as well (it stages them through the host itself, a sync, so
never inside a graph).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor summed over the ranks of ``group``: new tensors of the
    same shapes, from one all-reduce per dtype over the packed buffer."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view(tensors[i].shape)
            at += n
    return out


def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor averaged over the ranks of ``group`` (a sum, then a
    division: gloo has no average)."""
    n = dist.get_world_size(group)
    return [t / n for t in all_reduce_sum(tensors, group)]
