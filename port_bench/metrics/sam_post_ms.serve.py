"""Card time a view in the program's ``sam.postprocess`` spans, each point
batch's mask logits upsampled to SAM's input size, cropped and resized to
the image (``encoders/sam_decode.py:postprocess_masks``): the spans'
device self time summed over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "sam.postprocess")
