"""Host ms a step in the launch of the step's CUDA graph: the program's
``runner.replay`` spans in the traced steps, over the steps."""
from ..program_trace import span_ms


def read(ctx):
    ms = span_ms(ctx, "runner.replay")
    return ms / ctx.steps if ms is not None and ctx.steps else None
