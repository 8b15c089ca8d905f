"""Fused spline reweight + shifted-axis binning + Σw/Σw² histogram.

Port of the TPU kernel K1, ``mach3_tpu/splines/pallas_reweight.py``
``_kernel_maskreduce_shifted`` (reached through its
``fused_reweight_histogram_shifted``). On a CUDA tensor the wrapper launches
the hand-written kernel ``csrc/reweight_shifted.cu`` (built at first use by
``kernels/build.py``); on a CPU tensor it runs the plain PyTorch version
``fused_reweight_histogram_shifted_ref`` beside it. There is no fallback: a
CUDA call that cannot build or launch the kernel raises.

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

#: Shift kinds the kernel knows: name -> (code in the kernel, torch function
#: of (value [C, 1], x [1, E])). Formed in f32 (1 + v first, then the
#: product), as the kernel forms it.
SHIFT_KINDS = {"scale": (0, lambda v, x: x * (1.0 + v))}

#: Bin-count limit of the kernel's shared-memory histogram (``routing.py``).
MAX_BINS = 512
MAX_EDGES = 1025
MAX_PARAMS = 256
MAX_NORM = 256

#: Launches of the CUDA kernel since the count was last set to 0. Only the
#: CUDA launch adds to it; the plain version does not.
LAUNCHES = 0

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
    n_bins, shift_kind, stride_j, n_axis_j, norm_ext=None, norm_s=None,
):
    """Plain PyTorch version of the kernel, on any device. Same arguments and
    results as :func:`fused_reweight_histogram_shifted`."""
    w = spline_product(coeffs, seg, t, base_w)
    if norm_ext is not None:
        w = w * norm_weight(norm_ext, norm_s)
    x = SHIFT_KINDS[shift_kind][1](shift_vals[:, None], x_nom[None, :])
    idx = count_edges_le(edges, x) - 1
    valid = (idx >= 0) & (idx < n_axis_j) & (static_base >= 0)
    bins = torch.where(valid, static_base + idx * stride_j, n_bins)
    return histogram(w, bins, n_bins)


def _check(seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges,
           n_bins, shift_kind, n_axis_j, norm_ext, norm_s):
    named = dict(seg=seg, t=t, coeffs=coeffs, base_w=base_w, shift_vals=shift_vals,
                 x_nom=x_nom, static_base=static_base, edges=edges)
    if (norm_ext is None) != (norm_s is None):
        raise ValueError("norm_ext and norm_s come together or not at all")
    if norm_ext is not None:
        named.update(norm_ext=norm_ext, norm_s=norm_s)
    dev = seg.device
    for name, x in named.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, seg on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = (torch.int32,) if name in ("seg", "static_base") else (FTYPE,)
        if name == "coeffs":
            want = (FTYPE, torch.bfloat16)
        if x.dtype not in want:
            raise TypeError(f"{name} has dtype {x.dtype}, the kernel takes {want}")
    if coeffs.dim() != 3 or coeffs.shape[1] % 4:
        raise ValueError(f"coeffs must be [P, K*4, E], got {tuple(coeffs.shape)}")
    p, _, e = coeffs.shape
    c = base_w.shape[0] if base_w.dim() == 2 else -1
    shapes = dict(seg=(c, p), t=(c, p), base_w=(c, e), shift_vals=(c,), x_nom=(e,),
                  static_base=(e,), edges=(n_axis_j + 1,))
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
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_BINS}]")
    if not 2 <= n_axis_j + 1 <= MAX_EDGES:
        raise ValueError(f"{n_axis_j + 1} edges outside [2, {MAX_EDGES}]")
    if p > MAX_PARAMS:
        raise ValueError(f"P={p} spline params > {MAX_PARAMS}")
    if shift_kind not in SHIFT_KINDS:
        raise ValueError(f"shift kind {shift_kind!r} unknown to the kernel ({sorted(SHIFT_KINDS)})")


def _library():
    from ..kernels.build import load_library

    lib = load_library("reweight_shifted")
    fn = lib.m3_reweight_shifted
    if fn.argtypes is None:
        fn.argtypes = (
            [_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] * 5 + [_C_INT] + [_C_VOIDP] * 2
            + [_C_INT] + [_C_VOIDP] * 2 + [_C_INT] * 8 + [_C_VOIDP]
        )
        fn.restype = _C_INT
        lib.m3_error_string.argtypes = [_C_INT]
        lib.m3_error_string.restype = ctypes.c_char_p
    return lib


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
    norm_ext: torch.Tensor | None = None,  # [C, NA1] f32 extended norm values
    norm_s: torch.Tensor | None = None,  # [NA1, E] f32 match counts
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mc [C, n_bins], w2 [C, n_bins]) f32. Launches the CUDA kernel for CUDA
    tensors, runs the plain version for CPU tensors, raises otherwise."""
    _check(seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges,
           n_bins, shift_kind, n_axis_j, norm_ext, norm_s)
    kwargs = dict(n_bins=n_bins, shift_kind=shift_kind, stride_j=stride_j,
                  n_axis_j=n_axis_j, norm_ext=norm_ext, norm_s=norm_s)
    dev = seg.device
    if dev.type == "cpu":
        return fused_reweight_histogram_shifted_ref(
            seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges, **kwargs
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = _library()
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
            norm_ext.data_ptr() if has_norm else None,
            norm_s.data_ptr() if has_norm else None,
            norm_s.shape[0] if has_norm else 0,
            mc.data_ptr(), w2.data_ptr(),
            c, p, k4, e, n_bins, stride_j, n_axis_j,
            SHIFT_KINDS[shift_kind][0], stream,
        )
    if rc != 0:
        msg = lib.m3_error_string(rc).decode()
        raise RuntimeError(f"reweight_shifted kernel launch failed: {msg} ({rc})")
    global LAUNCHES
    LAUNCHES += 1
    return mc, w2
