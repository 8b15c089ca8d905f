"""The likelihood's event-sized gathers, differentiable, with a backward that
is one hand-written kernel on the card.

Two gathers read a small per-chain table at every event:

* :func:`norm_product` — the norm product, ``take(norm_ext, 1,
  norm_idx).prod(-1)``: each event's matched norm values [C, S] (S = NA + 1
  slots, the last the padding slot's 1.0) multiplied over the event's W
  columns;
* :func:`event_gather` — the oscillation weights' flat gather,
  ``table.index_select(1, idx)`` from a chain's [C, NC·NE] (beam) or
  [C, NC·NZ·NE] (atmospheric) channel table.

Their forwards are exactly those ops. Their backwards
(:func:`norm_product_backward`, :func:`event_gather_backward`) reduce an
event-sized cotangent into the table's few slots, per chain:
``index_select``'s own backward is an atomic ``index_add`` whose adds land
on a few hot addresses (the norm table has tens of slots, the events are
~10^5), and the norm product's materialised several [C, E, W] tensors
before it. On a CUDA tensor the backward launches ``csrc/gather_backward.cu``
(built at first use by ``kernels/build.py``), which reads the sample's own
index, sums in shared memory, combines the lanes of a warp that read one
slot, and adds in a fixed order, so that its result is bit-identical from
run to run. On a CPU tensor it runs the plain version beside it
(:func:`norm_product_backward_ref`, :func:`event_gather_backward_ref`:
``prod``'s derivative and ``index_add``).

On the card the kernel takes every f32 table whose block of chains fits its
shared memory (:func:`kernel_blocking`), and the backward raises for an
f64 table or a norm wider than :data:`MAX_WIDTH`. Two cases take the plain
version there, ``index_add`` included, and count
``LAUNCHES["gather_backward_fallback"]``: a table too wide for a block
(an atmospheric table, thousands of slots a chain, where atomics find
little contention), decided from its shape before any launch; and a
backward that builds a graph of its own (``create_graph``: the minimiser's
second derivatives), which needs the plain version's differentiable ops.
Each kernel launch counts ``LAUNCHES["gather_backward"]``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.device import take
from ..core.precision import FTYPE
from ..splines.reweight import LAUNCHES, _library, _raise_on

#: The kernel's limits (``csrc/gather_backward.cu``): a block's shared memory
#: for its chains' sums (and the product's factors), the widest norm
#: product.
SMEM_BUDGET = 64 * 1024
MAX_WIDTH = 8
#: A block's chains (the kernel's tile: two warps of 4) and events, for the
#: norm product and for the gather: the fastest at beam1det's four gathers,
#: 128 chains, among 8 or 16 chains by 256-4,096 events (an H100 at 700 W:
#: 0.12-0.18 ms for numu_beam's norm product, 0.05-0.09 ms for its gather).
BLOCK_CHAINS = 8
PRODUCT_BLOCK_EVENTS, GATHER_BLOCK_EVENTS = 1024, 2048

_C_VOIDP = ctypes.c_void_p
_C_INT = ctypes.c_int
_ARGTYPES = [_C_VOIDP] * 4 + [_C_INT] * 7 + [_C_VOIDP]


def kernel_blocking(n_slots: int, product: bool) -> tuple[int, int] | None:
    """(chains, events) of a block of the kernel for a table of ``n_slots``
    slots a chain, or None where the block's sums do not fit its shared
    memory (an atmospheric table: the gather then takes ``index_add``)."""
    if BLOCK_CHAINS * 4 * n_slots * (2 if product else 1) > SMEM_BUDGET:
        return None
    return BLOCK_CHAINS, PRODUCT_BLOCK_EVENTS if product else GATHER_BLOCK_EVENTS


def _takes_kernel(g: torch.Tensor, n_slots: int, dtype: torch.dtype, width: int,
                  product: bool) -> tuple[int, int] | None:
    """The block of the kernel for this call, or None for the plain version:
    every CPU call, and on the card a table too wide for a block (counted).
    Raises on the card for what the kernel does not take."""
    if g.device.type == "cpu":
        return None
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    if width > MAX_WIDTH or g.dtype != FTYPE or dtype != FTYPE:
        raise ValueError(f"the gathers' kernel takes f32 tables and at most {MAX_WIDTH} "
                         f"columns, not {dtype} by {width} (cotangent {g.dtype})")
    blocking = kernel_blocking(n_slots, product)
    if blocking is None:
        LAUNCHES["gather_backward_fallback"] += 1
    return blocking


def _launch(g: torch.Tensor, table: torch.Tensor | None, idx: torch.Tensor, n_slots: int,
            width: int, blocking: tuple[int, int]) -> torch.Tensor:
    """The kernel's [C, S] f32 sums (its partials summed over event blocks);
    ``table`` [C, S] the product's factors, or None for the plain gather;
    ``idx`` [E] or [E, W] int64."""
    lib = _library("gather_backward", _ARGTYPES)
    g, idx = g.contiguous(), idx.contiguous()
    c, e = g.shape
    if idx.dtype != torch.long or idx.numel() != e * width:
        raise ValueError(f"index {tuple(idx.shape)} {idx.dtype} is not {width} int64 "
                         f"columns of {e} events")
    if table is not None:
        table = table.contiguous()
    chains, events = blocking
    partial = torch.empty((-(-e // events), c, n_slots), dtype=FTYPE, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.m3_gather_backward(g.data_ptr(), None if table is None else table.data_ptr(),
                                    idx.data_ptr(), partial.data_ptr(), c, e, n_slots, width,
                                    int(table is not None), chains, events, stream)
    _raise_on(lib, rc, "gather_backward")
    LAUNCHES["gather_backward"] += 1
    return partial.sum(0)


def _other_factors(x: torch.Tensor) -> torch.Tensor:
    """[..., W] -> [..., W]: each factor's product of the others, from
    running products from both ends (no division: exact for a zero), in the
    kernel's order."""
    xs = x.unbind(-1)
    before, running = [], torch.ones_like(xs[0])
    for f in xs:
        before.append(running)
        running = running * f
    others, running = [None] * len(xs), torch.ones_like(xs[0])
    for w in range(len(xs) - 1, -1, -1):
        others[w] = before[w] * running
        running = running * xs[w]
    return torch.stack(others, -1)


def norm_product_backward_ref(g: torch.Tensor, norm_ext: torch.Tensor,
                              norm_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the norm product's backward, on any device: [C, S]
    Σ over events and columns of g · ∂(Π_w x_w)/∂x_w (x the gathered
    factors) added by ``index_add``. The derivative is ``prod``'s own,
    g · Π / x, where x ≠ 0, so that the plain route's gradients keep native
    autograd's bits, and the other factors' product where x = 0; the kernel
    forms the other factors' product everywhere, which differs by rounding."""
    x = take(norm_ext, 1, norm_idx)
    gu, zero = g.unsqueeze(-1), x == 0
    # x where it is not 0, so that a second derivative finds no 0 / 0 there
    quotient = x.prod(-1, keepdim=True) / torch.where(zero, 1.0, x)
    contrib = torch.where(zero, gu * _other_factors(x), gu * quotient)
    out = torch.zeros_like(norm_ext)
    return out.index_add_(1, norm_idx.reshape(-1), contrib.reshape(g.shape[0], -1))


def event_gather_backward_ref(g: torch.Tensor, shape, dtype: torch.dtype,
                              idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather's backward, on any device: ``index_add``
    of g into a zero table of ``shape`` and ``dtype`` (``index_select``'s own
    backward)."""
    return torch.zeros(shape, dtype=dtype, device=g.device).index_add_(1, idx, g.to(dtype))


def _graph_wanted(g: torch.Tensor) -> bool:
    """Whether this backward builds a graph of its own (``create_graph``):
    then the plain version runs, and on the card it counts as a fallback."""
    if not torch.is_grad_enabled():
        return False
    if g.device.type == "cuda":
        LAUNCHES["gather_backward_fallback"] += 1
    return True


def norm_product_backward(g: torch.Tensor, norm_ext: torch.Tensor,
                          norm_idx: torch.Tensor) -> torch.Tensor:
    """The norm product's backward [C, S] from its cotangent g [C, E]: the
    kernel on the card, the plain version on the CPU, for a too wide table
    or under ``create_graph``."""
    width = norm_idx.shape[1]
    blocking = None if _graph_wanted(g) else _takes_kernel(
        g, norm_ext.shape[1], norm_ext.dtype, width, True)
    if blocking is None:
        return norm_product_backward_ref(g, norm_ext, norm_idx)
    return _launch(g, norm_ext, norm_idx, norm_ext.shape[1], width, blocking)


def event_gather_backward(g: torch.Tensor, shape, dtype: torch.dtype,
                          idx: torch.Tensor) -> torch.Tensor:
    """The gather's backward, a table of ``shape`` and ``dtype`` from its
    cotangent g [C, E]: the kernel on the card, ``index_add`` on the CPU,
    for a too wide table or under ``create_graph``."""
    blocking = None if _graph_wanted(g) else _takes_kernel(g, shape[1], dtype, 1, False)
    if blocking is None:
        return event_gather_backward_ref(g, shape, dtype, idx)
    return _launch(g, None, idx, shape[1], 1, blocking)


class _NormProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, norm_ext, norm_idx):
        ctx.save_for_backward(norm_ext)
        ctx.norm_idx = norm_idx
        return take(norm_ext, 1, norm_idx).prod(-1)

    @staticmethod
    def backward(ctx, g):
        (norm_ext,) = ctx.saved_tensors
        return norm_product_backward(g, norm_ext, ctx.norm_idx), None


class _EventGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.table = (table.shape, table.dtype)
        ctx.idx = idx
        return table.index_select(1, idx)

    @staticmethod
    def backward(ctx, g):
        return event_gather_backward(g, *ctx.table, ctx.idx), None


def norm_product(norm_ext: torch.Tensor, norm_idx: torch.Tensor) -> torch.Tensor:
    """[C, E] Π_w norm_ext[c, norm_idx[e, w]] (exactly ``take(norm_ext, 1,
    norm_idx).prod(-1)``), differentiable in ``norm_ext`` [C, S] f32;
    ``norm_idx`` [E, W] int64."""
    return _NormProduct.apply(norm_ext, norm_idx)


def event_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[C, E] table[c, idx[e]] (exactly ``table.index_select(1, idx)``),
    differentiable in ``table`` [C, S] f32; ``idx`` [E] int64."""
    return _EventGather.apply(table, idx)
