"""Device operations (kernels, copies, fills) per traced MR2T2 step: how
finely the likelihood's glue is cut."""


def read(ctx):
    n = ctx.trace.count()
    return n / ctx.steps if n and ctx.steps else None
