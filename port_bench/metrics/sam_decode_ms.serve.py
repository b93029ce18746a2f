"""Card time a view in the program's ``sam.decode`` spans, each call of
SAM's model on an embedding (the image's positional encoding, the prompt
encoder and the two-way mask decoder on a batch of point prompts; a hook
on the ``transformers`` model, ``encoders/sam_encoder.py:_span_blocks``):
the spans' device self time summed over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "sam.decode")
