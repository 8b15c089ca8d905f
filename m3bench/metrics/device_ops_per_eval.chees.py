"""Device operations per batched gradient evaluation (one leapfrog
iteration of every chain: forward and backward) in the traced ChEES steps."""


def read(ctx):
    n = ctx.trace.count()
    return n / ctx.units if n and ctx.units else None
