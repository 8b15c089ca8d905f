"""The device a builder puts its model on: the card, unless the caller asks
for the CPU; device fills, and a gather and a product whose backward a CUDA
graph can hold."""
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


class _LastAxisProduct(torch.autograd.Function):
    """``x.prod(-1)`` whose backward reads nothing on the host. ``prod``'s
    own asks the host whether any factor is zero, which a CUDA graph cannot
    hold; this one takes its formula, grad · result / x, where x ≠ 0 (the
    same bits) and the product of the other factors where x = 0."""

    @staticmethod
    def forward(ctx, x):
        out = x.prod(-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        # The other factors' product from running products from both ends,
        # as elementwise multiplies: the axis is short (a few norms), and a
        # scan along it takes hundreds of times longer on the card.
        xs = x.unbind(-1)
        before = [torch.ones_like(xs[0])]
        for f in xs[:-1]:
            before.append(before[-1] * f)
        after = [torch.ones_like(xs[0])]
        for f in xs[:0:-1]:
            after.append(after[-1] * f)
        others = torch.stack([b * a for b, a in zip(before, after[::-1])], -1)
        g = grad.unsqueeze(-1)
        return torch.where(x == 0, g * others, g * (out.unsqueeze(-1) / x))


def prod_last(x: torch.Tensor) -> torch.Tensor:
    """The product over the last axis, ``x.prod(-1)``, with a backward that
    a CUDA graph can hold."""
    return _LastAxisProduct.apply(x)
