"""The fused spline-reweight + Σw/Σw² histogram kernels and their plain
versions.

* ``fused_reweight_histogram_shifted``: per-chain shifted-axis binning.
  Port of the TPU kernels K1 ``_kernel_maskreduce_shifted`` and K3
  ``_kernel_shifted_blocked`` (``mach3_tpu/splines/pallas_reweight.py``; K3
  is K1 with P streamed in VMEM blocks, which the CUDA kernel's list of work
  items per event tile makes unnecessary), under the activity plan of
  ``plan.shifted_layout`` when the caller has one. CUDA source
  ``csrc/reweight_shifted.cu``.
* ``fused_reweight_histogram_shared``: static bins, events laid out in tiles
  by ``splines/plan.py``, a histogram window and a list of active parameters
  per tile. Port of K2 ``_kernel_shared_blocked_sorted``; under
  ``plan.trivial_plan`` (every parameter, the whole bin axis) it computes
  K4a ``_kernel_shared`` and K4b ``_kernel_shared_blocked``. CUDA source
  ``csrc/reweight_shared.cu``.
* ``fused_reweight_histogram``: per-chain bins given as input [C, E]. Port
  of K5 ``_kernel_maskreduce`` (``hist="maskreduce"``, float atomics) and of
  K5b ``_kernel`` (``hist="blockdiag"``, another histogram with the same
  output: here a deterministic one). CUDA source
  ``csrc/reweight_perchain.cu``.

They serve the sampling path (norm product in the shifted and shared
kernels) and, with the norm left out, the forward of the differentiable
path, whose backward kernel (K6a and K6b fused) lives in ``splines/grad.py``.

On a CUDA tensor a wrapper launches its hand-written kernel (built at first
use by ``kernels/build.py``); on a CPU tensor it runs the plain PyTorch
version beside it (``*_ref``). There is no fallback: a CUDA call that cannot
build or launch the kernel raises.

Differences from the JAX production route, by design:
* spline responses are evaluated in f32 from ``(seg, t)`` — four coefficient
  rows and a Horner step — instead of a bf16-rounded deviation dot over the
  [C, P, K4] selector;
* the norm product keeps the TPU kernel's semantics: ``log|ext|`` floored at
  1e-30, so a zero norm gives a ~1e-30 weight, not an exact 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.precision import FTYPE
from ..samples.binning import count_edges_le, histogram
from .eval import spline_product
from .plan import EVENT_TILE

#: Shift kinds the kernel knows: name -> (code in the kernel, torch function
#: of (value [C, 1], x [1, E])). Each is formed in f32 in the order written,
#: one rounding per operation, as the kernel forms it (``__fadd_rn`` /
#: ``__fmul_rn``), so both bin an event on an edge alike.
SHIFT_KINDS = {
    "scale": (0, lambda v, x: x * (1.0 + v)),
    "offset": (1, lambda v, x: x + v),
    "scale_about_one": (2, lambda v, x: 1.0 + (x - 1.0) * (1.0 + v)),
}

#: Bin-count limit of the shifted kernel's shared-memory histogram (``routing.py``).
MAX_BINS = 512
MAX_EDGES = 1025
MAX_PARAMS = 256
MAX_NORM = 256
#: Bin-count limit of the shared kernel.
MAX_SHARED_BINS = 4096
#: The tile of the shared and shifted kernels (``csrc/spline_response.cuh``):
#: ``EVENT_TILE`` events (one per thread) by ``CHAIN_TILE`` chains, whose
#: coefficient rows pass through a ring of ``RING_STAGES`` stages of
#: ``ITEMS_PER_STAGE`` (parameter, segment) items in shared memory; a table
#: has at most ``MAX_KNOTS`` knots, and its rows start on 16-byte boundaries.
CHAIN_TILE = 16
RING_STAGES = 3
ITEMS_PER_STAGE = 4
MAX_KNOTS = 64
ROW_ALIGN = 16
#: A block's shared memory on Hopper.
MAX_SMEM = 232448

#: Launches of each CUDA kernel since its count was last set to 0, the
#: backward of ``splines/grad.py`` included. Only a CUDA launch adds to a
#: count; the plain versions do not.
LAUNCHES = {"reweight_shifted": 0, "reweight_shared": 0, "reweight_perchain": 0,
            "reweight_perchain_blockdiag": 0, "reweight_backward": 0}
#: Histogram forms of ``fused_reweight_histogram``.
HIST_FORMS = ("maskreduce", "blockdiag")
#: Events per block of the per-chain kernels (``csrc/reweight_perchain.cu``):
#: the deterministic form writes one partial histogram per such tile.
PERCHAIN_EVENTS_PER_BLOCK = 2048

_C_VOIDP = ctypes.c_void_p
_C_INT = ctypes.c_int


def norm_weight(norm_ext: torch.Tensor, norm_s: torch.Tensor) -> torch.Tensor:
    """Plain in-kernel-semantics norm product: [C, NA1] x [NA1, E] -> [C, E]
    ``exp(log|ext| @ S) · (−1)^(neg @ S)``, |ext| floored at 1e-30."""
    logext = torch.log(norm_ext.abs().clamp(min=1e-30))
    lw = logext @ norm_s
    pw = (norm_ext < 0).to(FTYPE) @ norm_s
    sign = 1.0 - 2.0 * (pw - 2.0 * torch.floor(pw * 0.5))
    return torch.exp(lw) * sign


def fused_reweight_histogram_shifted_ref(
    seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges, *,
    n_bins, shift_kind, stride_j, n_axis_j, plan_ptr=None, plan_idx=None,
    norm_ext=None, norm_s=None,
):
    """Plain PyTorch version of the kernel, on any device: every parameter
    (the plan only skips exact identities). Same arguments and results as
    :func:`fused_reweight_histogram_shifted`."""
    w = spline_product(coeffs, seg, t, base_w)
    if norm_ext is not None:
        w = w * norm_weight(norm_ext, norm_s)
    bins = shifted_bins_ref(shift_vals, x_nom, static_base, edges, n_bins=n_bins,
                            shift_kind=shift_kind, stride_j=stride_j, n_axis_j=n_axis_j)
    return histogram(w, bins, n_bins)


def shifted_bins_ref(shift_vals, x_nom, static_base, edges, *, n_bins, shift_kind, stride_j,
                     n_axis_j) -> torch.Tensor:
    """[C, E] int32 bins of the shifted route, as the kernels form them in
    f32 (``csrc/spline_response.cuh`` ``shifted_bin``): ``static_base +
    stride_j·idx`` with idx the shifted value's axis bin, ``n_bins`` (dropped)
    where idx ∉ [0, n_axis_j) or ``static_base`` < 0."""
    x = SHIFT_KINDS[shift_kind][1](shift_vals[:, None], x_nom[None, :])
    idx = count_edges_le(edges, x) - 1
    valid = (idx >= 0) & (idx < n_axis_j) & (static_base >= 0)
    return torch.where(valid, static_base + idx * stride_j, n_bins)


_INT_ARGS = ("seg", "static_base", "bins", "tile_start", "tile_width", "plan_ptr", "plan_idx",
             "nz")


def _check_tensors(named: dict, norm_ext, norm_s) -> None:
    """Type, device, contiguity and dtype of every tensor argument."""
    if (norm_ext is None) != (norm_s is None):
        raise ValueError("norm_ext and norm_s come together or not at all")
    if norm_ext is not None:
        named.update(norm_ext=norm_ext, norm_s=norm_s)
    dev = named["seg"].device if isinstance(named["seg"], torch.Tensor) else None
    for name, x in named.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, seg on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = (torch.int32,) if name in _INT_ARGS else (FTYPE,)
        if name == "coeffs":
            want = (FTYPE, torch.bfloat16)
        if x.dtype not in want:
            raise TypeError(f"{name} has dtype {x.dtype}, the kernel takes {want}")


def _check_shapes(named: dict, shapes: dict, coeffs, base_w, norm_ext, norm_s) -> tuple[int, int, int]:
    """Shapes against the table's (P, K4, E) and base_w's C; returns (C, P, E)."""
    if coeffs.dim() != 3 or coeffs.shape[1] % 4:
        raise ValueError(f"coeffs must be [P, K*4, E], got {tuple(coeffs.shape)}")
    p, _, e = coeffs.shape
    c = base_w.shape[0] if base_w.dim() == 2 else -1
    shapes = {k: tuple(c if d == "C" else p if d == "P" else e if d == "E" else d for d in v)
              for k, v in shapes.items()}
    if norm_ext is not None:
        na1 = norm_s.shape[0]
        shapes.update(norm_ext=(c, na1), norm_s=(na1, e))
        if na1 > MAX_NORM:
            raise ValueError(f"{na1} norm slots > {MAX_NORM}")
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, expected {shape}")
    if c < 1 or e < 1:
        raise ValueError(f"empty batch: C={c}, E={e}")
    if not 1 <= p <= MAX_PARAMS:
        raise ValueError(f"P={p} spline params outside [1, {MAX_PARAMS}]")
    return c, p, e


def tile_core_smem(coeffs: torch.Tensor, na1: int) -> int:
    """Bytes of shared memory the tile core of a block takes for this table
    and ``na1`` norm slots (``m3::core_bytes`` of ``csrc/spline_response.cuh``
    plus the norm arrays); the kernel's histogram comes on top."""
    p, k4 = coeffs.shape[0], coeffs.shape[1]
    ring = RING_STAGES * ITEMS_PER_STAGE * 4 * EVENT_TILE * coeffs.element_size()
    items = p * min(k4 // 4, CHAIN_TILE)
    core = ring + p * CHAIN_TILE * 8 + (2 * p + 1) * 4 + items * 8
    return -(-core // 16) * 16 + 2 * CHAIN_TILE * na1 * 4


def _check_tile_core(coeffs: torch.Tensor, norm_s, hist_bytes: int) -> None:
    """What the tile core asks of a table: at most ``MAX_KNOTS`` knots and a
    block's shared memory (``hist_bytes`` of it the kernel's histogram)
    within the card's."""
    if coeffs.shape[1] // 4 > MAX_KNOTS:
        raise ValueError(f"{coeffs.shape[1] // 4} knots > {MAX_KNOTS}")
    smem = tile_core_smem(coeffs, 0 if norm_s is None else norm_s.shape[0]) + hist_bytes
    if smem > MAX_SMEM:
        raise ValueError(f"a block needs {smem} bytes of shared memory > {MAX_SMEM}")


def _check_row_alignment(coeffs: torch.Tensor) -> None:
    """Rows of a table on the card start on ``ROW_ALIGN``-byte boundaries
    (the kernels' 16-byte asynchronous copies); a laid-out table has them,
    its E being a multiple of ``EVENT_TILE``. There is no slower path for a
    table that has not."""
    pitch = coeffs.shape[2] * coeffs.element_size()
    if pitch % ROW_ALIGN or coeffs.data_ptr() % ROW_ALIGN:
        raise ValueError(
            f"the kernel copies coefficient rows {ROW_ALIGN} bytes at a time: the table's row "
            f"pitch ({pitch} bytes for E={coeffs.shape[2]}) and base pointer must be multiples "
            f"of {ROW_ALIGN}; lay the sample out (splines/plan.py pads E to {EVENT_TILE})")


def _check_plan(named: dict, plan_ptr, plan_idx, n_events: int) -> bool:
    """Adds an activity plan to ``named`` and checks its shape; False when
    there is none."""
    if (plan_ptr is None) != (plan_idx is None):
        raise ValueError("plan_ptr and plan_idx come together or not at all")
    if plan_ptr is None:
        return False
    named.update(plan_ptr=plan_ptr, plan_idx=plan_idx)
    n_tiles = -(-n_events // EVENT_TILE)
    if tuple(plan_ptr.shape) != (n_tiles + 1,) or plan_idx.dim() != 1:
        raise ValueError(f"plan_ptr must be [{n_tiles + 1}] and plan_idx 1-D, got "
                         f"{tuple(plan_ptr.shape)} and {tuple(plan_idx.shape)}")
    return True


def _check(seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges,
           n_bins, shift_kind, n_axis_j, plan_ptr, plan_idx, norm_ext, norm_s) -> bool:
    named = dict(seg=seg, t=t, coeffs=coeffs, base_w=base_w, shift_vals=shift_vals,
                 x_nom=x_nom, static_base=static_base, edges=edges)
    has_plan = _check_plan(named, plan_ptr, plan_idx, base_w.shape[-1])
    _check_tensors(named, norm_ext, norm_s)
    shapes = dict(seg=("C", "P"), t=("C", "P"), base_w=("C", "E"), shift_vals=("C",),
                  x_nom=("E",), static_base=("E",), edges=(n_axis_j + 1,))
    _check_shapes(named, shapes, coeffs, base_w, norm_ext, norm_s)
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_BINS}]")
    if not 2 <= n_axis_j + 1 <= MAX_EDGES:
        raise ValueError(f"{n_axis_j + 1} edges outside [2, {MAX_EDGES}]")
    if shift_kind not in SHIFT_KINDS:
        raise ValueError(f"shift kind {shift_kind!r} unknown to the kernel ({sorted(SHIFT_KINDS)})")
    _check_tile_core(coeffs, norm_s,
                     4 * (CHAIN_TILE * (2 * n_bins + 2) + edges.shape[0] + 2 * EVENT_TILE))
    return has_plan


def _library(stem: str, argtypes: list, entry: str | None = None):
    """The library of ``csrc/<stem>.cu`` with the argument types of its entry
    ``m3_<entry>`` (default ``m3_<stem>``) set."""
    from ..kernels.build import load_library

    lib = load_library(stem)
    fn = getattr(lib, f"m3_{entry or stem}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _C_INT
        lib.m3_error_string.argtypes = [_C_INT]
        lib.m3_error_string.restype = ctypes.c_char_p
    return lib


_SHIFTED_ARGTYPES = (
    [_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] * 5 + [_C_INT] + [_C_VOIDP] * 4
    + [_C_INT] + [_C_VOIDP] * 2 + [_C_INT] * 10 + [_C_VOIDP]
)
_PERCHAIN_ARGTYPES = [_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] * 4 + [_C_INT] * 5 + [_C_VOIDP]
_PERCHAIN_DET_ARGTYPES = [_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] * 3 + [_C_INT] * 6 + [_C_VOIDP]
_SHARED_ARGTYPES = (
    [_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] * 6 + [_C_INT] + [_C_VOIDP] * 2
    + [_C_INT] + [_C_VOIDP] * 2 + [_C_INT] * 7 + [_C_VOIDP]
)


def _raise_on(lib, rc: int, stem: str) -> None:
    if rc != 0:
        msg = lib.m3_error_string(rc).decode()
        raise RuntimeError(f"{stem} kernel launch failed: {msg} ({rc})")


def fused_reweight_histogram_shifted(
    seg: torch.Tensor,  # [C, P] i32 — spline segment per (chain, param)
    t: torch.Tensor,  # [C, P] f32 — local coordinate in that segment
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16
    base_w: torch.Tensor,  # [C, E] f32 — mc_weight x osc (x norm when not in-kernel)
    shift_vals: torch.Tensor,  # [C] f32 — per-chain shift-parameter value
    x_nom: torch.Tensor,  # [E] f32 — nominal values of the shifted variable
    static_base: torch.Tensor,  # [E] i32 — static-axis bin contribution (-1 invalid)
    edges: torch.Tensor,  # [n_axis_j + 1] f32 — edges of the shifted axis
    *,
    n_bins: int,
    shift_kind: str,
    stride_j: int,
    n_axis_j: int,
    plan_ptr: torch.Tensor | None = None,  # [T + 1] i32 — CSR offsets (tiles of EVENT_TILE)
    plan_idx: torch.Tensor | None = None,  # [nnz] i32 — each tile's active spline params
    norm_ext: torch.Tensor | None = None,  # [C, NA1] f32 extended norm values
    norm_s: torch.Tensor | None = None,  # [NA1, E] f32 match counts
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mc [C, n_bins], w2 [C, n_bins]) f32. Launches the CUDA kernel for CUDA
    tensors, runs the plain version for CPU tensors, raises otherwise. A
    plan (``plan.shifted_layout``) must list every parameter that is not the
    identity on some event of a tile; without one the kernel reads every
    parameter on every tile."""
    has_plan = _check(seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges,
                      n_bins, shift_kind, n_axis_j, plan_ptr, plan_idx, norm_ext, norm_s)
    kwargs = dict(n_bins=n_bins, shift_kind=shift_kind, stride_j=stride_j,
                  n_axis_j=n_axis_j, norm_ext=norm_ext, norm_s=norm_s)
    dev = seg.device
    if dev.type == "cpu":
        return fused_reweight_histogram_shifted_ref(
            seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges, **kwargs
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_row_alignment(coeffs)
    lib = _library("reweight_shifted", _SHIFTED_ARGTYPES)
    c, p = seg.shape
    k4, e = coeffs.shape[1], coeffs.shape[2]
    mc = torch.zeros((c, n_bins), dtype=FTYPE, device=dev)
    w2 = torch.zeros((c, n_bins), dtype=FTYPE, device=dev)
    has_norm = norm_ext is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_reweight_shifted(
            seg.data_ptr(), t.data_ptr(), coeffs.data_ptr(),
            int(coeffs.dtype == torch.bfloat16),
            base_w.data_ptr(), shift_vals.data_ptr(), x_nom.data_ptr(),
            static_base.data_ptr(), edges.data_ptr(), edges.shape[0],
            plan_ptr.data_ptr() if has_plan else None,
            plan_idx.data_ptr() if has_plan else None,
            norm_ext.data_ptr() if has_norm else None,
            norm_s.data_ptr() if has_norm else None,
            norm_s.shape[0] if has_norm else 0,
            mc.data_ptr(), w2.data_ptr(),
            c, p, k4, e, n_bins, stride_j, n_axis_j,
            SHIFT_KINDS[shift_kind][0], EVENT_TILE, CHAIN_TILE, stream,
        )
    _raise_on(lib, rc, "reweight_shifted")
    LAUNCHES["reweight_shifted"] += 1
    return mc, w2


def fused_reweight_histogram_shared_ref(
    seg, t, coeffs, base_w, bins, *, n_bins, tile_start=None, tile_width=None,
    plan_ptr=None, plan_idx=None, nbl=None, norm_ext=None, norm_s=None,
):
    """Plain PyTorch version of the shared kernel, on any device: every
    parameter, no window (the plan only skips exact identities), a bin
    outside [0, n_bins) dropped. Same arguments and results as
    :func:`fused_reweight_histogram_shared`."""
    w = spline_product(coeffs, seg, t, base_w)
    if norm_ext is not None:
        w = w * norm_weight(norm_ext, norm_s)
    return histogram(w, _dropped_outside(bins, n_bins).expand(w.shape), n_bins)


def _dropped_outside(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``bins`` as int64 with every bin outside [0, n_bins) at the garbage
    bin ``n_bins``, which :func:`histogram` drops."""
    b = bins.long()
    return torch.where((b >= 0) & (b < n_bins), b, n_bins)


def _check_shared(seg, t, coeffs, base_w, bins, n_bins, tile_start, tile_width, plan_ptr,
                  plan_idx, nbl, norm_ext, norm_s):
    named = dict(seg=seg, t=t, coeffs=coeffs, base_w=base_w, bins=bins, tile_start=tile_start,
                 tile_width=tile_width, plan_ptr=plan_ptr, plan_idx=plan_idx)
    _check_tensors(named, norm_ext, norm_s)
    n_tiles = -(-base_w.shape[-1] // EVENT_TILE)
    shapes = dict(seg=("C", "P"), t=("C", "P"), base_w=("C", "E"), bins=("E",),
                  tile_start=(n_tiles,), tile_width=(n_tiles,), plan_ptr=(n_tiles + 1,))
    _check_shapes(named, shapes, coeffs, base_w, norm_ext, norm_s)
    if plan_idx.dim() != 1:
        raise ValueError(f"plan_idx must be 1-D, got {tuple(plan_idx.shape)}")
    if not 1 <= n_bins <= MAX_SHARED_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_SHARED_BINS}]")
    if not isinstance(nbl, int) or not 1 <= nbl <= n_bins:
        raise ValueError(f"window nbl={nbl!r} outside [1, n_bins={n_bins}]")
    _check_tile_core(coeffs, norm_s, 4 * (CHAIN_TILE * (2 * nbl + 1) + EVENT_TILE))


def fused_reweight_histogram_shared(
    seg: torch.Tensor,  # [C, P] i32 — spline segment per (chain, param)
    t: torch.Tensor,  # [C, P] f32 — local coordinate in that segment
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16, events in plan order
    base_w: torch.Tensor,  # [C, E] f32 — mc_weight x osc (x norm when not in-kernel)
    bins: torch.Tensor,  # [E] i32 — static bins (outside [0, n_bins) dropped)
    *,
    n_bins: int,
    tile_start: torch.Tensor,  # [T] i32 — window start of each tile of EVENT_TILE events
    tile_width: torch.Tensor,  # [T] i32 — window width of each tile (<= nbl)
    plan_ptr: torch.Tensor,  # [T + 1] i32 — CSR offsets into plan_idx
    plan_idx: torch.Tensor,  # [nnz] i32 — each tile's active spline params
    nbl: int,  # widest window in bins (sizes the shared-memory histogram)
    norm_ext: torch.Tensor | None = None,  # [C, NA1] f32 extended norm values
    norm_s: torch.Tensor | None = None,  # [NA1, E] f32 match counts
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mc [C, n_bins], w2 [C, n_bins]) f32. Launches the CUDA kernel for
    CUDA tensors, runs the plain version for CPU tensors, raises otherwise.
    The plan (``splines/plan.py``) must list every parameter that is not the
    identity on some event of a tile; a tile's window only decides which
    bins the kernel sums in shared memory."""
    _check_shared(seg, t, coeffs, base_w, bins, n_bins, tile_start, tile_width, plan_ptr,
                  plan_idx, nbl, norm_ext, norm_s)
    dev = seg.device
    if dev.type == "cpu":
        return fused_reweight_histogram_shared_ref(
            seg, t, coeffs, base_w, bins, n_bins=n_bins, norm_ext=norm_ext, norm_s=norm_s
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_row_alignment(coeffs)
    lib = _library("reweight_shared", _SHARED_ARGTYPES)
    c, p = seg.shape
    k4, e = coeffs.shape[1], coeffs.shape[2]
    mc = torch.zeros((c, n_bins), dtype=FTYPE, device=dev)
    w2 = torch.zeros((c, n_bins), dtype=FTYPE, device=dev)
    has_norm = norm_ext is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_reweight_shared(
            seg.data_ptr(), t.data_ptr(), coeffs.data_ptr(),
            int(coeffs.dtype == torch.bfloat16),
            base_w.data_ptr(), bins.data_ptr(), tile_start.data_ptr(),
            tile_width.data_ptr(), plan_ptr.data_ptr(), plan_idx.data_ptr(), nbl,
            norm_ext.data_ptr() if has_norm else None,
            norm_s.data_ptr() if has_norm else None,
            norm_s.shape[0] if has_norm else 0,
            mc.data_ptr(), w2.data_ptr(),
            c, p, k4, e, n_bins, EVENT_TILE, CHAIN_TILE, stream,
        )
    _raise_on(lib, rc, "reweight_shared")
    LAUNCHES["reweight_shared"] += 1
    return mc, w2


def fused_reweight_histogram_ref(seg, t, coeffs, base_w, bins, *, n_bins, hist="maskreduce"):
    """Plain PyTorch version of both per-chain kernels, on any device. Same
    arguments and results as :func:`fused_reweight_histogram`."""
    w = spline_product(coeffs, seg, t, base_w)
    return histogram(w, _dropped_outside(bins, n_bins), n_bins)


def fused_reweight_histogram(
    seg: torch.Tensor,  # [C, P] i32 — spline segment per (chain, param)
    t: torch.Tensor,  # [C, P] f32 — local coordinate in that segment
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16
    base_w: torch.Tensor,  # [C, E] f32 — mc_weight x osc x norm (x TF1 x weight fns)
    bins: torch.Tensor,  # [C, E] i32 — per-chain bins (outside [0, n_bins) dropped)
    *,
    n_bins: int,
    hist: str = "maskreduce",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mc [C, n_bins], w2 [C, n_bins]) f32 over per-chain bins. ``hist``
    picks the kernel: ``"maskreduce"`` (K5: shared-memory float atomics) or
    ``"blockdiag"`` (K5b: per-warp histograms summed in a fixed order, the
    same result on every run). Launches the CUDA kernel for CUDA tensors,
    runs the plain version for CPU tensors, raises otherwise."""
    named = dict(seg=seg, t=t, coeffs=coeffs, base_w=base_w, bins=bins)
    _check_tensors(named, None, None)
    c, p, e = _check_shapes(named, dict(seg=("C", "P"), t=("C", "P"), base_w=("C", "E"),
                                        bins=("C", "E")), coeffs, base_w, None, None)
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_BINS}]")
    if hist not in HIST_FORMS:
        raise ValueError(f"hist={hist!r}: the per-chain kernels are {HIST_FORMS}")
    dev = seg.device
    if dev.type == "cpu":
        return fused_reweight_histogram_ref(seg, t, coeffs, base_w, bins, n_bins=n_bins, hist=hist)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    k4 = coeffs.shape[1]
    bf16 = int(coeffs.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if hist == "maskreduce":
            lib = _library("reweight_perchain", _PERCHAIN_ARGTYPES)
            mc = torch.zeros((c, n_bins), dtype=FTYPE, device=dev)
            w2 = torch.zeros((c, n_bins), dtype=FTYPE, device=dev)
            rc = lib.m3_reweight_perchain(
                seg.data_ptr(), t.data_ptr(), coeffs.data_ptr(), bf16, base_w.data_ptr(),
                bins.data_ptr(), mc.data_ptr(), w2.data_ptr(), c, p, k4, e, n_bins, stream)
            _raise_on(lib, rc, "reweight_perchain")
            LAUNCHES["reweight_perchain"] += 1
            return mc, w2
        lib = _library("reweight_perchain", _PERCHAIN_DET_ARGTYPES, entry="reweight_perchain_det")
        n_tiles = -(-e // PERCHAIN_EVENTS_PER_BLOCK)
        partial = torch.empty((n_tiles, 2, c, n_bins), dtype=FTYPE, device=dev)
        rc = lib.m3_reweight_perchain_det(
            seg.data_ptr(), t.data_ptr(), coeffs.data_ptr(), bf16, base_w.data_ptr(),
            bins.data_ptr(), partial.data_ptr(), n_tiles, c, p, k4, e, n_bins, stream)
    _raise_on(lib, rc, "reweight_perchain_det")
    LAUNCHES["reweight_perchain_blockdiag"] += 1
    mc, w2 = partial.sum(0)
    return mc, w2
