"""Host ms a step at the chunks' ends: the program's ``runner.collect`` (the
outputs' copy to the host) and ``runner.callback`` spans in the traced
steps, over the steps."""
from ..program_trace import span_ms


def read(ctx):
    ms = span_ms(ctx, "runner.collect", "runner.callback")
    return ms / ctx.steps if ms is not None and ctx.steps else None
