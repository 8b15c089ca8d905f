"""Device ms of the layered (atmospheric) oscillation grids in one MR2T2
step: the program's stamp ``osc_layered`` (from the first layered grid,
after every constant-density one, to the first sample's base weight) in the
last replay of the step's graph in the traced chunk."""
from ..program_trace import graph_layer_ms


def read(ctx):
    return graph_layer_ms(ctx, "mr2t2.step", "osc_layered")
