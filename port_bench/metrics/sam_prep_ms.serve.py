"""Card time an image in the program's ``sam.preprocess`` span
(``encoders/sam_encoder.py:encode_image``): the processor's resize,
rescale, normalisation and padding on the host, then the upload. Its device
self time is the span's window on the card's clock, so it holds the upload's
copy and the stretch the card waits for the host: the span's device self
time summed over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "sam.preprocess")
