"""Card time an image in the program's ``sam.global_block`` spans, the
global blocks of ViT-H (7, 15, 23 and 31, attention over all 4,096 tokens;
hooks on the ``transformers`` blocks): the spans' device self time summed
over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "sam.global_block")
