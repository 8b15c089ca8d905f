"""Host calls that put work on the card (kernel and graph launches, copies,
fills) per traced MR2T2 step: the chunk runner's dispatch."""


def read(ctx):
    return ctx.trace.launches() / ctx.steps if ctx.steps else None
