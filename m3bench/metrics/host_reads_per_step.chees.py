"""Blocking device-to-host reads a ChEES step: the program's ``host_reads``
counter over the traced chunk (the lengths, the chunk's copy, the step
counter), over its steps."""
from ..program_trace import chunk


def read(ctx):
    record = chunk(ctx)
    if record is None or not record.steps:
        return None
    return record.counts.get("program", {}).get("host_reads", 0) / record.steps
