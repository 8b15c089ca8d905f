"""The whole MR2T2 step's share of the card's peak: the step's floor
(``counts.step``: its inputs read once, its outputs written once, the
operations its responses, products, sums and statistic need) over the
measured milliseconds a step of the unprofiled window took, in percent."""
from .. import counts


def read(ctx):
    floors = [counts.floor_s(*counts.step(ctx.works, ctx.n_chains, ctx.n_params, nseg, False))
              for nseg in ctx.segments]
    return 100.0 * (sum(floors) / len(floors)) / (ctx.ms_per_unit / 1e3)
