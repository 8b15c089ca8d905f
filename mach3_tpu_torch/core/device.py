"""The device a builder puts its model on: the card, unless the caller asks
for the CPU; device fills, and a gather whose backward a CUDA graph can
hold."""
from __future__ import annotations

import numpy as np
import torch


def target_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``. Raises when it names a CUDA device
    and none is visible: the builders call this before any work, so a run
    without a card stops at once instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is visible; "
            "pass device='cpu' to build on the CPU"
        )
    return dev


def as_device_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor, an array, a list or a number) as a ``dtype`` tensor
    on ``device``, as ``torch.as_tensor`` makes it. A Python or numpy scalar
    is filled in on the device (``torch.full``), not copied from the host, so
    that a CUDA graph can capture the call; an array or a list is copied
    from the host, which a graph cannot capture."""
    if isinstance(x, (int, float, np.number)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def take(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x`` indexed along ``dim`` by the integer tensor ``index`` (any
    shape, which replaces that axis), as ``x[..., index, ...]`` but through
    ``index_select``: its backward is an atomic ``index_add``, which a CUDA
    graph can hold, where advanced indexing's (``index_put_`` with
    accumulate) sorts the indices on the card."""
    dim = dim % x.dim()
    out = x.index_select(dim, index.reshape(-1))
    return out.reshape(x.shape[:dim] + index.shape + x.shape[dim + 1:])
