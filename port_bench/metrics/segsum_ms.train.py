"""Card time a step in the program's ``raster.segment_sum`` span, the
per-entry gradient rows summed per Gaussian (``ops/segment.py:SegmentPlan``
in ``_Composite.backward``): the span's device self time summed over the
traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "train", "raster.segment_sum")
