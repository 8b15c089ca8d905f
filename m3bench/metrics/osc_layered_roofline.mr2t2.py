"""The layered oscillation grids' share of their floor: the frozen count of
one step's layered grids (``osc_counts.layered``: the grids written, the
half path's 3x3 complex products) over the program's stamp ``osc_layered``
in the last replay of the step's graph in the traced chunk, in percent."""
from .. import counts, osc_counts
from ..program_trace import graph_layer_ms


def read(ctx):
    ms = graph_layer_ms(ctx, "mr2t2.step", "osc_layered")
    inputs = osc_counts.run_inputs()
    if not ms or inputs is None or not osc_counts.layered_grids(inputs):
        return None
    return 100.0 * counts.floor_s(*osc_counts.layered(inputs, ctx.n_chains)) / (ms / 1e3)
