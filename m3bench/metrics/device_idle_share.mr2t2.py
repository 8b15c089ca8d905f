"""Share of the traced window in which no operation ran on the device."""


def read(ctx):
    busy, _ = ctx.trace.busy()
    return 1.0 - busy / ctx.trace.window_s if busy > 0 else None
