"""Host seconds of the program's model build: the process's outermost
``build.*`` spans (the dense spline tables, the sample models, the
oscillation configurations)."""
from ..program_trace import tracing


def read(ctx):
    mod = tracing()
    return mod.setup_seconds("build.") if mod is not None else None
