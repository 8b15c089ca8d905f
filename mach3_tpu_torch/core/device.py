"""The device a builder puts its model on: the card, unless the caller asks
for the CPU."""
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
