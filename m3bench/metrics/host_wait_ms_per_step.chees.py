"""Host ms a ChEES step blocked on the card at the read of the trajectory's
length: the program's ``hmc.length_read`` spans in the traced steps, over
the steps."""
from ..program_trace import span_ms


def read(ctx):
    ms = span_ms(ctx, "hmc.length_read")
    return ms / ctx.steps if ms is not None and ctx.steps else None
