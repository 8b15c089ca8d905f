"""What the program traces itself (``mach3_tpu_torch.core.tracing``), as the
per-layer metrics read it: its spans in the traced run's profiler trace
(``record_function`` ranges, on the device operations' clock) and its own
record of the traced chunk (the layers' device stamps, its counters). Each
reader gives None where there is nothing to read: a program without that
module, a chunk it did not record, a span it did not open."""
from __future__ import annotations


def tracing():
    """The program's tracing module, or None."""
    try:
        from mach3_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing


def chunk(ctx):
    """The program's record of the traced chunk (the last chunk it
    recorded, if it ran the traced steps), or None."""
    mod = tracing()
    record = mod.last_chunk() if mod is not None else None
    return record if record is not None and record.steps == ctx.steps else None


def span_ms(ctx, *prefixes: str) -> float | None:
    """Milliseconds of the program's spans whose name starts with one of
    ``prefixes`` in the traced run's trace, summed; None without any."""
    found = [d for c, n, _, d in ctx.trace.host
             if c == "user_annotation" and n.startswith(prefixes)]
    return 1e-3 * sum(found) if found else None


def graph_layer_ms(ctx, graph: str, *layers: str) -> float | None:
    """Device ms of ``layers`` in the last replay of the program's graph
    ``graph`` in the traced chunk, from its stamps; None without them."""
    record = chunk(ctx)
    if record is None or graph not in record.layers:
        return None
    found = [record.layers[graph][k] for k in layers if k in record.layers[graph]]
    return sum(found) if found else None
