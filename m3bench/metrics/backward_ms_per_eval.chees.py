"""Device ms of the backward pass in one batched gradient evaluation: the
program's stamp ``backward`` (from just before ``autograd.grad`` to after
it: the gathers' backward, the backward kernel, the glue's backward) in the
last replay of ChEES's iteration graph in the traced chunk."""
from ..program_trace import graph_layer_ms


def read(ctx):
    return graph_layer_ms(ctx, "hmc.iteration", "backward")
