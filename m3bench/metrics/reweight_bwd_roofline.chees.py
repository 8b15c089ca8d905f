"""The backward reweight kernel's share of its floor: the frozen count of
each launch's bytes and operations (``counts.backward``) over the device
time that the trace gives the kernel named here, in percent."""
from .. import counts

KERNELS = ("reweight_backward_kernel",)


def read(ctx):
    seconds = ctx.trace.device_seconds(KERNELS)
    if seconds <= 0:
        return None
    floor = sum(n * counts.floor_s(*counts.backward(w, ctx.n_chains, nseg))
                for n, nseg in zip(ctx.units_per_step, ctx.segments) for w in ctx.works)
    return 100.0 * floor / seconds
