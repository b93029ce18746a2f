"""Card time a step in the program's ``decoder`` span, the speed-up decoder's
1x1 product (``model/decoder.py:apply_decoder``): the span's device self
time summed over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "train", "decoder")
