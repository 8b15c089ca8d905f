"""The whole gradient evaluation's share of the card's peak: the floor of a
batched evaluation with its gradient (``counts.step``) over the measured
milliseconds a batched evaluation of the unprofiled window took, in percent."""
from .. import counts


def read(ctx):
    floors = [counts.floor_s(*counts.step(ctx.works, ctx.n_chains, ctx.n_params, nseg, True))
              for nseg in ctx.segments]
    return 100.0 * (sum(floors) / len(floors)) / (ctx.ms_per_unit / 1e3)
