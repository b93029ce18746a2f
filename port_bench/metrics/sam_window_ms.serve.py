"""Card time an image in the program's ``sam.window_block`` spans, the
windowed blocks of ViT-H (28 of 32; hooks on the ``transformers`` blocks,
``encoders/sam_encoder.py:_span_blocks``): the spans' device self time
summed over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "sam.window_block")
