"""Card time a view in the program's ``sam.select`` spans of the automatic
mask generator (``encoders/sam_decode.py:auto_masks``): each point batch's
IoU and stability filters, boxes, uncrop and crop-edge test, each crop's
box NMS and the records' boxes, with the host's reads among them: the
spans' device self time summed over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "sam.select")
