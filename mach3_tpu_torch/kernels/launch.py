"""How the port launches a hand-written CUDA kernel, and the count of its
launches.

Every entry of ``csrc/<stem>.cu`` is ``extern "C" int m3_<entry>(...)``:
its arguments are pointers and ``int``\\ s, the CUDA stream last, and it
returns a ``cudaError_t`` (0 on success) that the library's
``m3_error_string`` names. :func:`launch` loads the library
(``build.load_library``, built at first use), passes each Python value as
what it is in C, appends the device's current stream, raises on a non-zero
return and counts the launch in :data:`LAUNCHES`. The kernel wrappers
(``splines/``, ``samples/gather.py``, ``osc/layered.py``) check their
arguments against the kernel's contract and allocate its outputs; they ask
:func:`on_card` whether a call launches at all.

Nothing here runs at import time: the CPU tests import this module on
machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from ..core import tracing
from .build import load_library

#: Launches of each CUDA kernel since its count was last set to 0 (an entry
#: of the tracing registry, ``core.tracing.counters``), keyed by entry; the
#: deterministic per-chain entry ``m3_reweight_perchain_det`` counts as
#: ``reweight_perchain_blockdiag``. Only a CUDA launch adds to a count; the
#: plain versions do not, but for ``gather_backward_fallback`` (the gathers'
#: backwards on the card that took ``index_add`` by their shape) and
#: ``osc_layered_fallback`` (layered grids on the card that took the plain
#: path: a gradient or float64 call).
LAUNCHES = tracing.counters("launches", ("reweight_shifted", "reweight_shared",
                                         "reweight_perchain", "reweight_perchain_blockdiag",
                                         "reweight_backward", "gather_backward",
                                         "gather_backward_fallback", "osc_layered",
                                         "osc_layered_fallback"))

_INT_RANGE = range(-2**31, 2**31)


def on_card(x: torch.Tensor) -> bool:
    """Whether a call on ``x``'s device launches a kernel: False on the CPU
    (the plain version runs), True on a CUDA device. Raises for any other
    device."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {x.device}")


def _c_arg(a):
    """``a`` as the C argument of an entry: a tensor its data pointer, None
    a NULL pointer, a bool or an integer a C int, a ctypes array as it is."""
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if a is None:
        return ctypes.c_void_p()
    if isinstance(a, ctypes.Array):
        return a
    try:
        v = operator.index(a)
    except TypeError:
        raise TypeError(f"a kernel takes tensors, None, ints and ctypes arrays, "
                        f"not {type(a).__name__}") from None
    if v not in _INT_RANGE:
        raise ValueError(f"{v} does not fit a C int")
    return ctypes.c_int(v)


def launch(stem: str, entry: str, device: torch.device, *args, count: str | None = None) -> None:
    """Call ``m3_<entry>`` of ``csrc/<stem>.cu`` with ``args`` and the
    current stream of ``device``; raise ``RuntimeError`` with the library's
    error string on a non-zero return, else add 1 to
    ``LAUNCHES[count or entry]``."""
    lib = load_library(stem)
    c_args = [_c_arg(a) for a in args]
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = getattr(lib, f"m3_{entry}")(*c_args, stream)
    if rc != 0:
        error = lib.m3_error_string
        error.restype = ctypes.c_char_p
        raise RuntimeError(f"{entry} kernel launch failed: {error(rc).decode()} ({rc})")
    LAUNCHES[count or entry] += 1
