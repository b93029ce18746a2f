"""Card time a step in the program's ``raster.binning`` span,
``ops/binning.py:bin_gaussians_batch``: the instance expansion, the (tile,
depth) sort and the tile counts: the span's device self time summed over
the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "train", "raster.binning")
