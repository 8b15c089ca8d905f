"""The program's own tracing: host spans, device stamps and counters.

* :func:`span` is a host span: name, start, end, the span it opened inside
  and the chunk it belongs to (``runner.chunk``'s index). While a
  ``torch.profiler`` records, it also opens ``record_function(name)``, so
  the span lands in the profiler's trace beside the device operations, on
  their clock. Spans are kept in memory: totals per name and the newest
  :data:`RECENT` records.
* :func:`stamp` marks where a layer begins on the device stream: a timing
  event, recorded as an event-record node when a CUDA graph captures it. A
  layer's device time is the time from its stamp to the next one, summed
  over its intervals. Stamps are taken only inside :func:`stamping` (a
  capture, or an eager step while tracing is on); elsewhere a stamp does
  nothing.
* :func:`count` adds to the counter registry. Each entry is a dict of counts
  (:func:`counters`): the kernels' launches (``kernels.launch.LAUNCHES``), a
  sampler's evaluations, and :data:`PROGRAM` (host reads and their bytes,
  graph replays and captures, kernel builds and loads). A CUDA graph's
  capture records what every entry counted while capturing, and each replay
  adds it again (:class:`CaptureCounts`).

Tracing is on while a ``torch.profiler`` records (``ChunkedSampler.run``
checks once a chunk, :func:`poll`) or after :func:`enable`. On, each chunk
of a sampler leaves a :class:`ChunkRecord`: its spans' totals, its counts,
and the per-layer device milliseconds of the last replay of each captured
graph (of the last step, in the eager loop on the card), read after the
chunk's copy to the host. Off, a per-step or per-replay span costs one flag
check and nothing calls ``record_function`` or reads an event. Set-up spans
(:func:`setup_span`: the model's build, graph captures, kernel builds) and
the host-read counter are kept always.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import time
import weakref

import torch

#: Span records kept, the newest (totals per name are kept for all).
RECENT = 4096
#: Chunk records kept, the newest.
CHUNKS = 64


class Counts(dict):
    """One entry of the counter registry: counts by name. A plain dict to
    its readers; the registry holds it as long as its owner does."""


_REGISTRY: "weakref.WeakValueDictionary[str, Counts]" = weakref.WeakValueDictionary()
_SERIAL = itertools.count()


def counters(name: str, keys=()) -> Counts:
    """A new entry of the registry, its counts ``keys`` at 0. Entries of one
    ``name`` are told apart by a serial number (a sampler's, say)."""
    entry = Counts((k, 0) for k in keys)
    _REGISTRY[name if name not in _REGISTRY else f"{name}#{next(_SERIAL)}"] = entry
    return entry


#: The program's own counts: ``host_reads`` and ``host_read_bytes`` (blocking
#: device-to-host reads on the sampling path), ``graph_replays``,
#: ``graph_captures``, ``kernel_builds`` (nvcc ran) and ``kernel_loads``.
PROGRAM = counters("program")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to :data:`PROGRAM`'s count ``name``."""
    PROGRAM[name] = PROGRAM.get(name, 0) + n


def snapshot() -> dict:
    """{entry name: a copy of its counts} of every live entry."""
    return {name: dict(entry) for name, entry in list(_REGISTRY.items())}


class CaptureCounts:
    """What every entry of the registry but :data:`PROGRAM` (whose counts are
    host work, which no replay does again) counts between its making and
    :meth:`close` (a CUDA graph's capture), taken back out at the close (a
    capture runs nothing) and added again by each :meth:`replay`."""

    def __init__(self):
        self._before = [(entry, dict(entry)) for entry in list(_REGISTRY.values())
                        if entry is not PROGRAM]
        self.seen: list = []

    def close(self) -> None:
        for entry, before in self._before:
            seen = {k: v - before.get(k, 0) for k, v in entry.items() if v != before.get(k, 0)}
            if seen:
                self.seen.append((entry, seen))
            for k in entry:
                entry[k] = before.get(k, 0)

    def of(self, entry: Counts) -> dict:
        """The counts one replay adds to ``entry``."""
        return next((dict(seen) for e, seen in self.seen if e is entry), {})

    def replay(self) -> None:
        for entry, seen in self.seen:
            for k, v in seen.items():
                entry[k] += v


# ------------------------------------------------------------------ spans
@dataclasses.dataclass
class SpanTotal:
    count: int = 0
    seconds: float = 0.0
    #: Seconds of the spans of this name opened inside no span of their own
    #: family (the name's first dotted part): ``build.sample`` inside
    #: ``build.osc`` adds to its ``seconds`` but not here.
    outer_seconds: float = 0.0


@dataclasses.dataclass
class ChunkRecord:
    """One chunk of a sampler while tracing was on."""

    index: int  # ``runner.chunk``'s index, the chunk id of its spans
    steps: int = 0
    #: {span name: seconds} of the spans that closed inside the chunk.
    spans: dict = dataclasses.field(default_factory=dict)
    #: {registry entry: {count: added during the chunk}}.
    counts: dict = dataclasses.field(default_factory=dict)
    #: {graph name: {layer: device ms}} of the last replay of each graph.
    layers: dict = dataclasses.field(default_factory=dict)


class _State:
    def __init__(self):
        self.forced = False  # enable()
        self.on = False  # forced, or a profiler records (poll())
        self.profiling = False  # a profiler records: spans open record_function
        self.stack: list[str] = []
        self.totals: dict[str, SpanTotal] = {}
        self.recent: collections.deque = collections.deque(maxlen=RECENT)
        self.chunks: collections.deque = collections.deque(maxlen=CHUNKS)
        self.chunk: ChunkRecord | None = None
        self.n_chunks = 0
        self.stamps: "Stamps | None" = None


_STATE = _State()


def _profiler_recording() -> bool:
    return bool(torch._C._autograd._profiler_enabled())


def poll() -> bool:
    """Tracing's state, read anew: on while a profiler records or after
    :func:`enable`. The samplers call it once a chunk."""
    _STATE.profiling = _profiler_recording()
    _STATE.on = _STATE.forced or _STATE.profiling
    return _STATE.on


def enable(on: bool = True) -> None:
    """Turn tracing on (off: ``enable(False)``) for the rest of the process."""
    _STATE.forced = on
    poll()


def is_on() -> bool:
    return _STATE.on


class _Span:
    __slots__ = ("name", "start", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = None
        if _STATE.on and _STATE.profiling:
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        _STATE.stack.append(self.name)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        stack = _STATE.stack
        stack.pop()
        if self.record is not None:
            self.record.__exit__(*exc)
        seconds = end - self.start
        total = _STATE.totals.get(self.name)
        if total is None:
            total = _STATE.totals[self.name] = SpanTotal()
        total.count += 1
        total.seconds += seconds
        family = self.name.split(".", 1)[0] + "."
        if not any(s.startswith(family) for s in stack):
            total.outer_seconds += seconds
        chunk = _STATE.chunk
        if chunk is not None:
            chunk.spans[self.name] = chunk.spans.get(self.name, 0.0) + seconds
        _STATE.recent.append((self.name, self.start, end, stack[-1] if stack else None,
                              None if chunk is None else chunk.index))
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A host span named ``name`` (a context manager), kept while tracing
    is on."""
    return _Span(name) if _STATE.on else _OFF


def setup_span(name: str):
    """Decorate a set-up function: each call is the span ``name``, kept
    whether tracing is on or off."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with _Span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def totals() -> dict[str, SpanTotal]:
    """{span name: a copy of its totals} since the process started."""
    return {n: dataclasses.replace(t) for n, t in _STATE.totals.items()}


def recent() -> list[tuple]:
    """The newest span records: (name, start, end, parent name, chunk id),
    ``time.perf_counter`` seconds, in the order they closed."""
    return list(_STATE.recent)


def setup_seconds(prefix: str) -> float | None:
    """Seconds of the process's spans named ``prefix``... that opened inside
    no span of their family (the model's build: ``"build."``); None
    without any."""
    found = [t.outer_seconds for n, t in _STATE.totals.items() if n.startswith(prefix)]
    return sum(found) if found else None


# ------------------------------------------------------------- host reads
def to_host(x: torch.Tensor):
    """``x`` as a numpy array; a read from the device counts as a host read
    of its bytes."""
    if x.device.type != "cpu":
        count("host_reads")
        count("host_read_bytes", x.numel() * x.element_size())
    return x.cpu().numpy()


def read_int(x: torch.Tensor) -> int:
    """``int(x)`` of a 0-d tensor, counted as :func:`to_host` counts."""
    if x.device.type != "cpu":
        count("host_reads")
        count("host_read_bytes", x.element_size())
    return int(x)


# ----------------------------------------------------------------- stamps
class Stamps:
    """The ordered device stamps of one captured graph (or one eager step):
    (layer, timing event) in stream order, the last named ``end``."""

    def __init__(self, name: str, external: bool):
        self.name = name
        self.external = external
        self.marks: list[tuple[str, torch.cuda.Event]] = []

    def add(self, layer: str) -> None:
        event = torch.cuda.Event(enable_timing=True, external=self.external)
        event.record()
        self.marks.append((layer, event))

    def layer_ms(self) -> dict[str, float]:
        """{layer: device ms from each of its stamps to the next, summed}
        of the last time the stamps were recorded (all must have been)."""
        out: dict[str, float] = {}
        for (layer, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[layer] = out.get(layer, 0.0) + a.elapsed_time(b)
        return out


def stamp(layer: str) -> None:
    """Mark where ``layer`` begins on the current stream (inside
    :func:`stamping`; elsewhere nothing)."""
    stamps = _STATE.stamps
    if stamps is not None:
        stamps.add(layer)


@contextlib.contextmanager
def stamping(name: str, external: bool = False):
    """Collect the stamps taken inside into a :class:`Stamps` (yielded),
    the first ``start``, the last ``end``. ``external``: as nodes of the CUDA
    graph being captured."""
    outer = _STATE.stamps
    stamps = _STATE.stamps = Stamps(name, external)
    stamps.add("start")
    try:
        yield stamps
        stamps.add("end")
    finally:
        _STATE.stamps = outer


# ----------------------------------------------------------------- chunks
@contextlib.contextmanager
def chunk():
    """One chunk of a sampler: while tracing is on, the ``runner.chunk``
    span and a :class:`ChunkRecord` (yielded; None while off) of its spans,
    counts and steps, kept once the chunk ends."""
    if not _STATE.on:
        yield None
        return
    record = ChunkRecord(index=_STATE.n_chunks)
    _STATE.n_chunks += 1
    before = snapshot()
    outer, _STATE.chunk = _STATE.chunk, record
    try:
        with _Span("runner.chunk"):
            yield record
    finally:
        _STATE.chunk = outer
    for name, counts in snapshot().items():
        seen = {k: v - before.get(name, {}).get(k, 0) for k, v in counts.items()}
        seen = {k: v for k, v in seen.items() if v}
        if seen:
            record.counts[name] = seen
    _STATE.chunks.append(record)


def chunks() -> list[ChunkRecord]:
    """The kept chunk records, oldest first."""
    return list(_STATE.chunks)


def last_chunk() -> ChunkRecord | None:
    return _STATE.chunks[-1] if _STATE.chunks else None


def summary() -> dict:
    """Span totals, the registry's counts and the kept chunk records."""
    return {"spans": {n: dataclasses.asdict(t) for n, t in sorted(_STATE.totals.items())},
            "counters": snapshot(),
            "chunks": [dataclasses.asdict(c) for c in _STATE.chunks]}


def write(path: str) -> None:
    """:func:`summary` as JSON into ``path``."""
    with open(path, "w") as f:
        json.dump(summary(), f, indent=1)
