"""(Gaussian, tile) instances a view, in millions: the binning's
totals before the capacity cap, which the program keeps as
``raster.instances`` in the traced window."""
from port_bench.harness import program_trace


def read(ctx):
    n = program_trace.counted(ctx, "serve", "raster.instances")
    return None if n is None else n / 1e6
