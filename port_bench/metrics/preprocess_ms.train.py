"""Card time a step in the program's ``raster.preprocess`` span,
``ops/rasterize.py:_prep_view``: the projection, the colours from SH, the
tile rectangles and the cull: the span's device self time summed over the
traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "train", "raster.preprocess")
