"""The fused spline-reweight + Σw/Σw² histogram kernels and their plain
versions.

* ``fused_reweight_histogram_shifted``: per-chain shifted-axis binning.
  Port of the TPU kernels K1 ``_kernel_maskreduce_shifted`` and K3
  ``_kernel_shifted_blocked`` (``mach3_tpu/splines/pallas_reweight.py``; K3
  is K1 with P streamed in VMEM blocks, which the CUDA kernel's list of work
  items per event tile makes unnecessary), under the activity plan of
  ``plan.shifted_layout`` when the caller has one. CUDA source
  ``csrc/reweight_shifted.cu``, the same kernel as the per-chain form's.
* ``fused_reweight_histogram_shared``: static bins, events laid out in tiles
  by ``splines/plan.py``, a histogram window and a list of active parameters
  per tile. Port of K2 ``_kernel_shared_blocked_sorted``; under
  ``plan.trivial_plan`` (every parameter, the whole bin axis) it computes
  K4a ``_kernel_shared`` and K4b ``_kernel_shared_blocked``. CUDA source
  ``csrc/reweight_shared.cu``.
* ``fused_reweight_histogram``: per-chain bins, formed in the kernel from a
  :class:`PerchainBins` bin map (named shifts of the binned axes) or given
  as input [C, E] (shifts that are torch code). Port of K5
  ``_kernel_maskreduce`` (``hist="maskreduce"``, float atomics) and of K5b
  ``_kernel`` (``hist="blockdiag"``, another histogram with the same output:
  here a deterministic one), under the activity plan of
  ``plan.shifted_layout`` when the caller has one. CUDA source
  ``csrc/reweight_shifted.cu`` (entries ``m3_reweight_perchain`` and
  ``m3_reweight_perchain_det``).

They serve the sampling path (norm product in the kernels) and, with the
norm left out, the forward of the differentiable path, whose backward kernel
(K6a and K6b fused) lives in ``splines/grad.py``.

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
import dataclasses

import torch

from ..core import tracing
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

#: Bin-count limit of the per-chain kernel's shared-memory histogram
#: (``routing.py``); edges of one binned axis.
MAX_BINS = 512
MAX_EDGES = 1025
#: A bin map's limits (``csrc/spline_response.cuh`` ``BinMap``): shifted
#: binned axes, shifts on them, entries of its cell map.
MAX_MAP_AXES = 4
MAX_MAP_SHIFTS = 8
MAX_MAP_CELLS = 8192
MAX_PARAMS = 256
MAX_NORM = 256
#: Bin-count limit of the shared kernel.
MAX_SHARED_BINS = 4096
#: The tile of the shared and shifted kernels (``csrc/spline_response.cuh``):
#: ``EVENT_TILE`` events (one per thread) by ``CHAIN_TILE`` chains, whose
#: coefficient rows pass through a ring of ``RING_STAGES`` stages of
#: ``ITEMS_PER_STAGE`` (parameter, segment) items in shared memory (the
#: per-chain kernel's for an f32 table: ``PERCHAIN_F32_RINGS``, see
#: :func:`perchain_smem`); a table
#: has at most ``MAX_KNOTS`` knots, and its rows start on 16-byte boundaries.
CHAIN_TILE = 16
RING_STAGES = 3
PERCHAIN_F32_RINGS = ((2, 4), (2, 2))  # (stages, items per stage): the large ring, the small
ITEMS_PER_STAGE = 4
MAX_KNOTS = 64
ROW_ALIGN = 16
#: A block's shared memory on Hopper, and what a kernel of the per-chain
#: binning keeps of it for its bin map's description (``m3::BinMap``).
MAX_SMEM = 232448
BIN_MAP_BYTES = 116

#: Launches of each CUDA kernel since its count was last set to 0, the
#: backwards of ``splines/grad.py`` and ``samples/gather.py`` and the layered
#: oscillation of ``osc/layered.py`` included (an entry of the tracing
#: registry, ``core.tracing.counters``). Only a CUDA launch adds to a count;
#: the plain versions do not, but for ``gather_backward_fallback`` (the
#: gathers' backwards on the card that took ``index_add`` by their shape) and
#: ``osc_layered_fallback`` (layered grids on the card that took the plain
#: path: a gradient or float64 call).
LAUNCHES = tracing.counters("launches", ("reweight_shifted", "reweight_shared",
                                         "reweight_perchain", "reweight_perchain_blockdiag",
                                         "reweight_backward", "gather_backward",
                                         "gather_backward_fallback", "osc_layered",
                                         "osc_layered_fallback"))
#: Histogram forms of ``fused_reweight_histogram``.
HIST_FORMS = ("maskreduce", "blockdiag")
#: Event tiles a block of the per-chain kernel walks: the atomics form
#: flushes its histogram once for them; the deterministic form writes one
#: partial histogram per such run of tiles (2048 events, so that the partials
#: stay few).
PERCHAIN_TILES = 2
PERCHAIN_DET_TILES = 8

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
    f32 (a bin map of one axis, ``csrc/spline_response.cuh``): ``static_base +
    stride_j·idx`` with idx the shifted value's axis bin, ``n_bins`` (dropped)
    where idx ∉ [0, n_axis_j) or ``static_base`` < 0."""
    x = SHIFT_KINDS[shift_kind][1](shift_vals[:, None], x_nom[None, :])
    idx = count_edges_le(edges, x) - 1
    valid = (idx >= 0) & (idx < n_axis_j) & (static_base >= 0)
    return torch.where(valid, static_base + idx * stride_j, n_bins)


@dataclasses.dataclass(frozen=True)
class PerchainBins:
    """Per-chain bins as a bin map that the kernels evaluate per (chain,
    event) (``csrc/spline_response.cuh`` ``perchain_bin``): the binned axes
    that named shifts move, each binned by its edges after its shifts, plus
    the part of the flat index the other axes give, through the cell map of
    a hyper-rectangle binning. :func:`perchain_bins_ref` is its plain form,
    equal to the plain binning of the shifted kinematics
    (``SampleModel._perchain_bins``)."""

    shift_vals: torch.Tensor  # [C, NSH] f32 — each shift's value per chain
    kin: torch.Tensor  # [V, E] f32 — nominal kinematics; rows named by ``axes``
    static_base: torch.Tensor  # [E] i32 — the unshifted axes' flat part (-1 out of range)
    edges: torch.Tensor  # [NA, K] f32 — each shifted axis's edges, +inf padded
    cell_to_bin: torch.Tensor | None  # [n_cells] i32 — flat cell -> bin (n_bins: a gap)
    axes: tuple  # ((kin row, n_edges, stride), ...) per shifted axis
    shifts: tuple  # ((axis, kind), ...) grouped by axis, each axis's in the order they apply

    def bins(self, n_bins: int) -> torch.Tensor:
        """The [C, E] int32 bins of the plain route (``n_bins``: dropped)."""
        return perchain_bins_ref(self, n_bins)

    def tensors(self) -> dict:
        """The tensors the kernels read, by name (``cell_to_bin`` when there
        is one)."""
        named = dict(shift_vals=self.shift_vals, kin=self.kin, static_base=self.static_base,
                     edges=self.edges)
        if self.cell_to_bin is not None:
            named["cell_to_bin"] = self.cell_to_bin
        return named

    def descriptor(self):
        """The host descriptor of ``m3::parse_bin_map``: n_axes, n_shifts,
        edge pitch, n_cells, (row, n_edges, stride) per axis, (axis, kind
        code) per shift, as a ctypes int array."""
        n_cells = 0 if self.cell_to_bin is None else self.cell_to_bin.shape[0]
        desc = [len(self.axes), len(self.shifts), self.edges.shape[1], n_cells]
        desc += [v for ax in self.axes for v in ax]
        desc += [v for a, kind in self.shifts for v in (a, SHIFT_KINDS[kind][0])]
        return (_C_INT * len(desc))(*desc)

    def smem_floats(self) -> int:
        """Floats of shared memory the map takes in a block of the forward
        kernel (:func:`bin_map_floats`)."""
        n_cells = 0 if self.cell_to_bin is None else self.cell_to_bin.shape[0]
        return bin_map_floats(len(self.axes), self.edges.shape[1], len(self.shifts), n_cells)


def bin_map_floats(n_axes: int, edge_pitch: int, n_shifts: int, n_cells: int) -> int:
    """Floats of shared memory a bin map takes in a block of the forward
    kernel: the edges, 16 chains' shift factors, 256 events' rows and static
    parts, the cells."""
    return n_axes * edge_pitch + n_shifts * CHAIN_TILE + (n_axes + 1) * EVENT_TILE + n_cells


def perchain_bins_ref(bins: PerchainBins, n_bins: int) -> torch.Tensor:
    """[C, E] int32 bins of a bin map as the kernels form them in f32
    (``csrc/spline_response.cuh`` ``perchain_bin``): each shifted axis's row
    moved by its shifts in order, ``idx = #(edges <= x) − 1``, ``static_base +
    Σ stride·idx`` through the cell map; ``n_bins`` (dropped) where some idx
    ∉ [0, n_edges − 1) or ``static_base`` < 0, and for a gap cell."""
    c = bins.shift_vals.shape[0]
    valid = (bins.static_base >= 0).expand(c, -1)
    flat = bins.static_base.expand(c, -1)
    for a, (row, n_edges, stride) in enumerate(bins.axes):
        x = bins.kin[row].expand(c, -1)
        for j, (axis, kind) in enumerate(bins.shifts):
            if axis == a:
                x = SHIFT_KINDS[kind][1](bins.shift_vals[:, j, None], x)
        idx = count_edges_le(bins.edges[a, :n_edges], x) - 1
        valid = valid & (idx >= 0) & (idx < n_edges - 1)
        flat = flat + idx * stride
    if bins.cell_to_bin is not None:
        flat = bins.cell_to_bin[torch.where(valid, flat, 0).long()]
    return torch.where(valid, flat, n_bins).to(torch.int32)


_INT_ARGS = ("seg", "static_base", "bins", "tile_start", "tile_width", "plan_ptr", "plan_idx",
             "nz", "cell_to_bin")


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


def tile_core_smem(coeffs: torch.Tensor, na1: int,
                   ring: tuple[int, int] = (RING_STAGES, ITEMS_PER_STAGE)) -> int:
    """Bytes of shared memory the tile core of a block takes for this table
    and ``na1`` norm slots (``m3::core_bytes`` of ``csrc/spline_response.cuh``
    plus the norm arrays); the kernel's histogram comes on top."""
    p, k4 = coeffs.shape[0], coeffs.shape[1]
    ring = ring[0] * ring[1] * 4 * EVENT_TILE * coeffs.element_size()
    items = p * min(k4 // 4, CHAIN_TILE)
    core = ring + p * CHAIN_TILE * 8 + (2 * p + 1) * 4 + items * 8
    return -(-core // 16) * 16 + 2 * CHAIN_TILE * na1 * 4


def perchain_smem(coeffs: torch.Tensor, na1: int, hist_bytes: int) -> int:
    """Bytes of shared memory a block of the per-chain kernel
    (``csrc/reweight_shifted.cu``) takes: its tile core and ``hist_bytes``
    more. An f32 table's ring is the large one unless that leaves room for
    fewer than four resident blocks, as the kernel picks it."""
    if coeffs.dtype != FTYPE:
        return tile_core_smem(coeffs, na1) + hist_bytes
    large, small = (tile_core_smem(coeffs, na1, ring) + hist_bytes for ring in PERCHAIN_F32_RINGS)
    return large if 4 * large <= MAX_SMEM else small


def _check_tile_core(coeffs: torch.Tensor, norm_s, hist_bytes: int,
                     perchain: bool = False) -> None:
    """What the tile core asks of a table: at most ``MAX_KNOTS`` knots and a
    block's shared memory (``hist_bytes`` of it the kernel's histogram)
    within the card's."""
    if coeffs.shape[1] // 4 > MAX_KNOTS:
        raise ValueError(f"{coeffs.shape[1] // 4} knots > {MAX_KNOTS}")
    na1 = 0 if norm_s is None else norm_s.shape[0]
    smem = (perchain_smem(coeffs, na1, hist_bytes) if perchain
            else tile_core_smem(coeffs, na1) + hist_bytes)
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
    _check_tile_core(coeffs, norm_s, BIN_MAP_BYTES
                     + 4 * (CHAIN_TILE * (2 * n_bins + 2) + edges.shape[0] + 2 * EVENT_TILE),
                     perchain=True)
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
_PERCHAIN_HEAD = ([_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] * 7 + [ctypes.POINTER(_C_INT)]
                  + [_C_VOIDP] * 4 + [_C_INT] * 9 + [_C_VOIDP])
_PERCHAIN_ARGTYPES = _PERCHAIN_HEAD + [_C_VOIDP] * 2
_PERCHAIN_DET_ARGTYPES = _PERCHAIN_HEAD + [_C_VOIDP]
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


def fused_reweight_histogram_ref(seg, t, coeffs, base_w, bins, *, n_bins, hist="maskreduce",
                                 plan_ptr=None, plan_idx=None, norm_ext=None, norm_s=None):
    """Plain PyTorch version of both per-chain kernels, on any device: every
    parameter (the plan only skips exact identities), a bin map's bins by
    :func:`perchain_bins_ref`. Same arguments and results as
    :func:`fused_reweight_histogram`."""
    w = spline_product(coeffs, seg, t, base_w)
    if norm_ext is not None:
        w = w * norm_weight(norm_ext, norm_s)
    if isinstance(bins, PerchainBins):
        bins = bins.bins(n_bins)
    return histogram(w, _dropped_outside(bins, n_bins), n_bins)


def _check_bin_source(named: dict, shapes: dict, bins) -> int:
    """Adds the per-chain bin source to ``named`` and ``shapes`` and checks a
    bin map against the kernels' limits; returns the floats of shared memory
    the map takes in a block (0 for bins given as [C, E])."""
    if not isinstance(bins, PerchainBins):
        named["bins"] = bins
        shapes["bins"] = ("C", "E")
        return 0
    named.update(bins.tensors())
    n_rows, pitch = bins.kin.shape[0], bins.edges.shape[-1]
    shapes.update(shift_vals=("C", len(bins.shifts)), kin=(n_rows, "E"), static_base=("E",),
                  edges=(len(bins.axes), pitch))
    if bins.cell_to_bin is not None:
        shapes["cell_to_bin"] = (bins.cell_to_bin.shape[0],)
        if bins.cell_to_bin.shape[0] > MAX_MAP_CELLS:
            raise ValueError(f"{bins.cell_to_bin.shape[0]} cells > {MAX_MAP_CELLS}")
    if not 1 <= len(bins.axes) <= MAX_MAP_AXES or len(bins.shifts) > MAX_MAP_SHIFTS:
        raise ValueError(f"a bin map of {len(bins.axes)} axes and {len(bins.shifts)} shifts: the "
                         f"kernels take 1-{MAX_MAP_AXES} and at most {MAX_MAP_SHIFTS}")
    for row, n_edges, stride in bins.axes:
        if not (0 <= row < n_rows and 2 <= n_edges <= min(pitch, MAX_EDGES) and stride >= 0):
            raise ValueError(f"bin map axis (row {row}, {n_edges} edges, stride {stride}) "
                             f"outside {n_rows} rows, [2, {min(pitch, MAX_EDGES)}] edges")
    axes = [a for a, _ in bins.shifts]
    if axes != sorted(axes) or any(not 0 <= a < len(bins.axes) for a in axes):
        raise ValueError(f"bin map shifts must be grouped by axis in ascending order: {axes}")
    for _, kind in bins.shifts:
        if kind not in SHIFT_KINDS:
            raise ValueError(f"shift kind {kind!r} unknown to the kernel ({sorted(SHIFT_KINDS)})")
    return bins.smem_floats()


def perchain_smem_bytes(n_bins: int, map_floats: int, given: bool, det: bool) -> int:
    """Shared memory a block of the per-chain kernel takes besides its tile
    core (``tile_core_smem``): the [16][2·B + 1] histogram, a bin map's
    ``map_floats`` and its description, and the parked bins [256][17] of
    bins ``given`` as input or of the deterministic tail ``det``."""
    parked = EVENT_TILE * (CHAIN_TILE + 1) if (given or det) else 0
    return BIN_MAP_BYTES + 4 * (CHAIN_TILE * (2 * n_bins + 1) + map_floats + parked)


def fused_reweight_histogram(
    seg: torch.Tensor,  # [C, P] i32 — spline segment per (chain, param)
    t: torch.Tensor,  # [C, P] f32 — local coordinate in that segment
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16, any row pitch
    base_w: torch.Tensor,  # [C, E] f32 — mc_weight x osc (x norm unless in-kernel) x TF1 x fns
    bins,  # PerchainBins, or [C, E] i32 per-chain bins (outside [0, n_bins) dropped)
    *,
    n_bins: int,
    hist: str = "maskreduce",
    plan_ptr: torch.Tensor | None = None,  # [T + 1] i32 — CSR offsets (tiles of EVENT_TILE)
    plan_idx: torch.Tensor | None = None,  # [nnz] i32 — each tile's active spline params
    norm_ext: torch.Tensor | None = None,  # [C, NA1] f32 extended norm values
    norm_s: torch.Tensor | None = None,  # [NA1, E] f32 match counts
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mc [C, n_bins], w2 [C, n_bins]) f32 over per-chain bins, formed in the
    kernel from a :class:`PerchainBins` map or given. ``hist`` picks the
    histogram: ``"maskreduce"`` (K5: shared-memory float atomics) or
    ``"blockdiag"`` (K5b: per-chain sums in a fixed order, the same result
    on every run). Launches the CUDA kernel for CUDA tensors, runs the plain
    version for CPU tensors, raises otherwise. A plan
    (``plan.shifted_layout``) must list every parameter that is not the
    identity on some event of a tile; without one the kernel reads every
    parameter on every tile."""
    named = dict(seg=seg, t=t, coeffs=coeffs, base_w=base_w)
    shapes = dict(seg=("C", "P"), t=("C", "P"), base_w=("C", "E"))
    map_floats = _check_bin_source(named, shapes, bins)
    has_plan = _check_plan(named, plan_ptr, plan_idx, base_w.shape[-1])
    _check_tensors(named, norm_ext, norm_s)
    c, p, e = _check_shapes(named, shapes, coeffs, base_w, norm_ext, norm_s)
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_BINS}]")
    if hist not in HIST_FORMS:
        raise ValueError(f"hist={hist!r}: the per-chain kernels are {HIST_FORMS}")
    by_map, det = isinstance(bins, PerchainBins), hist == "blockdiag"
    _check_tile_core(coeffs, norm_s, perchain_smem_bytes(n_bins, map_floats, not by_map, det),
                     perchain=True)
    dev = seg.device
    if dev.type == "cpu":
        return fused_reweight_histogram_ref(seg, t, coeffs, base_w, bins, n_bins=n_bins,
                                            hist=hist, norm_ext=norm_ext, norm_s=norm_s)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if by_map:
        cells = bins.cell_to_bin
        source = (None, bins.kin.data_ptr(), bins.shift_vals.data_ptr(),
                  bins.static_base.data_ptr(), bins.edges.data_ptr(),
                  None if cells is None else cells.data_ptr(), bins.descriptor())
    else:
        source = (bins.data_ptr(),) + (None,) * 6
    has_norm = norm_ext is not None
    entry = "reweight_perchain_det" if det else "reweight_perchain"
    lib = _library("reweight_shifted", _PERCHAIN_DET_ARGTYPES if det else _PERCHAIN_ARGTYPES,
                   entry=entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (seg.data_ptr(), t.data_ptr(), coeffs.data_ptr(),
                int(coeffs.dtype == torch.bfloat16), base_w.data_ptr(), *source,
                plan_ptr.data_ptr() if has_plan else None,
                plan_idx.data_ptr() if has_plan else None,
                norm_ext.data_ptr() if has_norm else None,
                norm_s.data_ptr() if has_norm else None,
                norm_s.shape[0] if has_norm else 0,
                c, p, coeffs.shape[1], e, n_bins, EVENT_TILE, CHAIN_TILE,
                PERCHAIN_DET_TILES if det else PERCHAIN_TILES, stream)
        if det:
            n_blocks = -(-(-(-e // EVENT_TILE)) // PERCHAIN_DET_TILES)
            partial = torch.empty((n_blocks, 2, c, n_bins), dtype=FTYPE, device=dev)
            rc = lib.m3_reweight_perchain_det(*head, partial.data_ptr())
        else:
            mc = torch.zeros((c, n_bins), dtype=FTYPE, device=dev)
            w2 = torch.zeros((c, n_bins), dtype=FTYPE, device=dev)
            rc = lib.m3_reweight_perchain(*head, mc.data_ptr(), w2.data_ptr())
    _raise_on(lib, rc, entry)
    if not det:
        LAUNCHES["reweight_perchain"] += 1
        return mc, w2
    LAUNCHES["reweight_perchain_blockdiag"] += 1
    mc, w2 = partial.sum(0)
    return mc, w2
