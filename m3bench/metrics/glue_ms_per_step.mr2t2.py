"""Device ms of the likelihood's glue in one MR2T2 step: the program's
stamps ``prior`` (the prior), ``base`` (each sample's base weight, bins and
kernel arguments) and ``stat`` (each sample's test statistic) in the last
replay of the step's graph in the traced chunk."""
from ..program_trace import graph_layer_ms


def read(ctx):
    return graph_layer_ms(ctx, "mr2t2.step", "prior", "base", "stat")
