"""Card time a step in the program's ``loss.resize`` span, the feature map's
align_corners resize to the teacher's size
(``train/losses.py:resize_bilinear_from_tiles``): the span's device self
time summed over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "train", "loss.resize")
