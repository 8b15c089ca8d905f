"""The device a builder puts its model on: the card, unless the caller asks
for the CPU."""
from __future__ import annotations

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
