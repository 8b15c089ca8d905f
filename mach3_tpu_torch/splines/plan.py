"""Build-time event layout and tile plan of the shared and shifted routes
(port of the layout step of ``mach3_tpu/samples/events.py:428-598`` and of its
helpers ``param_block_order`` / ``event_block_signature`` /
``param_block_plan`` / ``hist_tile_plan`` / ``plan_window_cuts``,
``splines/pallas_reweight.py``).

The shared-bins kernel (``csrc/reweight_shared.cu``) takes its events in
tiles of ``EVENT_TILE`` and, per tile, a histogram window (start and width
in bins) and a list of the spline parameters that are not the identity on
any event of the tile. This module builds that layout once, in numpy, from
the table's activity pattern (``dense_table_activity``) and the static bins:

1. parameters are regrouped so that those with equal activity patterns sit
   together (the JAX package's order, kept so the tables compare);
2. events get a group id, their pattern over those parameter groups, and are
   sorted by (group, static bin, oscillation index);
3. each group is cut into tiles that never straddle a group and never span
   more than ``MAX_WINDOW`` bins, and each cut is padded to ``EVENT_TILE``
   with zero-weight copies of its last event;
4. per tile: the window (start, width) and the CSR list of active
   parameters.

A tile's active list is exact: the parameters active on some event of the
tile, nothing else (an inactive pair multiplies by exactly 1.0).

The shifted-axis kernel (``csrc/reweight_shifted.cu``) finds each event's bin
per chain, so its layout (:func:`shifted_layout`) has no bin sort and no
window: steps 1 and 2 without the bin key (events keep their order within a
group), each group padded to ``EVENT_TILE``, and the CSR list of step 4.
Every row of a laid-out table starts on a 16-byte boundary (``EVENT_TILE``
events of 2 or 4 bytes), which the kernels' 16-byte asynchronous copies need.

Sizes follow the CUDA kernels, not the TPU's VMEM (no VMEM budget and none of
the JAX package's v5e cost constants). A block of either kernel is one tile of
256 events (one per thread) by 16 chains; beside the ring that stages its
coefficient rows (24 KB for a bf16 table) the shared kernel keeps a
[16][2·nbl + 1] f32 histogram in shared memory, nbl being the widest window of
the sample. The window is chosen so: a window starts at its tile's smallest
bin rounded down to ``WINDOW_ALIGN`` and is as wide as the tile's bins reach;
a tile is cut early only where it would reach past ``MAX_WINDOW`` = 256 bins,
which bounds the histogram at 32 KB of shared memory (three blocks to an SM
with the ring). The kernel zeroes and flushes only a tile's own width, so a
wide ``nbl`` costs shared memory but no work, and fewer cuts mean fewer padded
tiles. The kernel stays right whatever the window: a bin outside it goes
straight to the global histogram.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Events per tile: threads per block of the shared kernel (one event each).
EVENT_TILE = 256
#: Window starts are multiples of this many bins.
WINDOW_ALIGN = 32
#: Widest window the planner asks for.
MAX_WINDOW = 256


@dataclasses.dataclass
class SharedLayout:
    """The layout of one shared-route or shifted-route sample.

    param_perm [P]: new parameter order; event_perm [E'] and pad_mask [E']:
    the events (old indices, pads repeat the last event of their cut), E' a
    multiple of ``EVENT_TILE``; plan_ptr [T + 1], plan_idx [nnz] (int32):
    each tile's active parameters; tile_start [T], tile_width [T] and nbl:
    the shared kernel's histogram windows (None on the shifted route)."""

    param_perm: np.ndarray
    event_perm: np.ndarray
    pad_mask: np.ndarray
    plan_ptr: np.ndarray
    plan_idx: np.ndarray
    n_groups: int
    tile_start: np.ndarray | None = None
    tile_width: np.ndarray | None = None
    nbl: int | None = None

    @property
    def n_tiles(self) -> int:
        return len(self.plan_ptr) - 1

    def mean_active(self) -> float:
        """Mean number of active parameters per tile."""
        return float(np.diff(self.plan_ptr).mean()) if self.n_tiles else 0.0


def param_order(act: np.ndarray) -> np.ndarray:
    """Parameter permutation grouping identical activity patterns, in the
    order of each pattern's first parameter (``param_block_order``)."""
    groups: dict[bytes, list[int]] = {}
    for i in range(act.shape[0]):
        groups.setdefault(np.packbits(act[i]).tobytes(), []).append(i)
    return np.asarray([i for g in groups.values() for i in g], np.int64)


def event_groups(act: np.ndarray) -> np.ndarray:
    """[E] group id per event: its activity over the groups of parameters
    with identical patterns (events of one interaction mode share one)."""
    if act.shape[0] == 0:
        return np.zeros(act.shape[1], np.int64)
    _, first = np.unique(np.packbits(act, axis=1), axis=0, return_index=True)
    reps = act[np.sort(first)]  # [G, E]: one row per parameter group
    _, gid = np.unique(np.packbits(reps, axis=0).T, axis=0, return_inverse=True)
    return gid.reshape(-1).astype(np.int64)


def window_cuts(bins_g: np.ndarray, window: int = MAX_WINDOW,
                event_tile: int = EVENT_TILE) -> list[tuple[int, int]]:
    """(start, end) ranges into one group's bin-sorted events: each at most
    ``event_tile`` long and within ``window`` bins of its aligned start."""
    out = []
    n = len(bins_g)
    i = 0
    while i < n:
        start = (int(bins_g[i]) // WINDOW_ALIGN) * WINDOW_ALIGN
        j = int(np.searchsorted(bins_g, start + window, side="left"))
        j = max(min(j, i + event_tile, n), i + 1)
        out.append((i, j))
        i = j
    return out


def tile_active(act: np.ndarray, event_tile: int = EVENT_TILE):
    """(plan_ptr [T + 1], plan_idx [nnz]) int32: the CSR list of the
    parameters active on some event of each tile of ``event_tile`` events
    (the last may be short), in ascending order within a tile."""
    p, e = act.shape
    n_tiles = -(-e // event_tile)
    padded = np.zeros((p, n_tiles * event_tile), bool)
    padded[:, :e] = act
    tile_act = padded.reshape(p, n_tiles, event_tile).any(axis=2)  # [P, T]
    tiles, params = np.nonzero(tile_act.T)
    ptr = np.zeros(n_tiles + 1, np.int32)
    np.add.at(ptr, tiles + 1, 1)
    return np.cumsum(ptr).astype(np.int32), params.astype(np.int32)


def tile_plan(act: np.ndarray, bins: np.ndarray, n_bins: int, event_tile: int = EVENT_TILE):
    """(tile_start [T], tile_width [T], plan_ptr [T + 1], plan_idx [nnz],
    nbl) for events in tiles of ``event_tile`` (the last may be short). A
    tile's window starts at its smallest real bin (< n_bins) rounded down to
    ``WINDOW_ALIGN`` and reaches its largest; nbl is the widest window."""
    n_tiles = -(-act.shape[1] // event_tile)
    starts = np.zeros(n_tiles, np.int32)
    widths = np.zeros(n_tiles, np.int32)
    for t in range(n_tiles):
        tb = bins[t * event_tile:(t + 1) * event_tile]
        tb = tb[(tb >= 0) & (tb < n_bins)]
        if tb.size:
            starts[t] = (int(tb.min()) // WINDOW_ALIGN) * WINDOW_ALIGN
            widths[t] = int(tb.max()) - starts[t] + 1
    nbl = max(1, int(widths.max(initial=0)))
    return (starts, widths, *tile_active(act, event_tile), nbl)


def trivial_active(n_events: int, n_params: int, event_tile: int = EVENT_TILE):
    """(plan_ptr, plan_idx) with every parameter active in every tile."""
    n_tiles = max(1, -(-n_events // event_tile))
    ptr = (np.arange(n_tiles + 1) * n_params).astype(np.int32)
    return ptr, np.tile(np.arange(n_params, dtype=np.int32), n_tiles)


def trivial_plan(n_events: int, n_params: int, n_bins: int, event_tile: int = EVENT_TILE):
    """Every parameter active in every tile and every window the whole bin
    axis: the function of the TPU's wide shared kernels K4a/K4b
    (``_kernel_shared``, ``_kernel_shared_blocked``) on the shared kernel."""
    ptr, idx = trivial_active(n_events, n_params, event_tile)
    n_tiles = len(ptr) - 1
    return (np.zeros(n_tiles, np.int32), np.full(n_tiles, n_bins, np.int32), ptr, idx, n_bins)


def shared_layout(act: np.ndarray, bins: np.ndarray, n_bins: int,
                  osc_key: np.ndarray | None = None,
                  event_tile: int = EVENT_TILE) -> SharedLayout:
    """Steps 1-4 of the module docstring. act [P, E] bool (original order),
    bins [E] static bins (``n_bins`` = garbage), osc_key [E] the secondary
    sort key (per-event oscillation gather index)."""
    p, e = act.shape
    pperm = param_order(act)
    act = act[pperm]
    gid = event_groups(act)
    key = np.zeros(e, np.int64) if osc_key is None else np.asarray(osc_key, np.int64)
    pieces = _group_pieces(np.lexsort((key, bins, gid)), gid)
    cuts = [idx[i0:j0] for idx in pieces
            for i0, j0 in window_cuts(bins[idx], MAX_WINDOW, event_tile)]
    perm, pad_mask = _padded(cuts, event_tile)
    act_sorted = act[:, perm]
    act_sorted[:, pad_mask] = False
    starts, widths, ptr, idx, nbl = tile_plan(act_sorted, bins[perm], n_bins, event_tile)
    return SharedLayout(pperm, perm, pad_mask, ptr, idx, len(pieces), starts, widths, nbl)


def shifted_layout(act: np.ndarray, event_tile: int = EVENT_TILE) -> SharedLayout:
    """The layout of a sample without static bins (module docstring): act
    [P, E] bool in the original order. Events keep their order within an
    activity group; no window."""
    pperm = param_order(act)
    act = act[pperm]
    gid = event_groups(act)
    pieces = _group_pieces(np.argsort(gid, kind="stable"), gid)
    perm, pad_mask = _padded(pieces, event_tile)
    act_sorted = act[:, perm]
    act_sorted[:, pad_mask] = False
    return SharedLayout(pperm, perm, pad_mask, *tile_active(act_sorted, event_tile),
                        n_groups=len(pieces))


def _group_pieces(order: np.ndarray, gid: np.ndarray) -> list[np.ndarray]:
    """``order`` (events sorted by group first) split at the group changes."""
    if len(order) == 0:
        return []
    return np.split(order, np.flatnonzero(np.diff(gid[order])) + 1)


def _padded(cuts: list[np.ndarray], event_tile: int) -> tuple[np.ndarray, np.ndarray]:
    """(event_perm, pad_mask): the cuts one after another, each padded to a
    multiple of ``event_tile`` with copies of its last event."""
    take, pad = [], []
    for seg in cuts:
        n_pad = -len(seg) % event_tile
        take += [seg, np.full(n_pad, seg[-1])]
        pad += [np.zeros(len(seg), bool), np.ones(n_pad, bool)]
    if not take:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    return np.concatenate(take).astype(np.int64), np.concatenate(pad)
