"""The forward reweight kernels' share of their floor: the frozen count of
each launch's bytes and operations (``counts.forward``) over the device time
that the trace gives the kernels named here, in percent."""
from .. import counts

KERNELS = ("reweight_shared_kernel", "reweight_perchain_kernel")


def read(ctx):
    seconds = ctx.trace.device_seconds(KERNELS)
    if seconds <= 0:
        return None
    floor = sum(counts.floor_s(*counts.forward(w, ctx.n_chains, nseg))
                for nseg in ctx.segments for w in ctx.works)
    return 100.0 * floor / seconds
