"""Card time a step in the program's ``optim.adam`` span, Adam over the
Gaussian fields and the decoder (``model/optim.py:adam_update``,
``tensor_adam_update``): the span's device self time summed over the traced
window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "train", "optim.adam")
