"""Card time an image in the program's ``lseg.preprocess`` spans
(``encoders/lseg_net.py:encode_features``): the upload of the float32
image, its normalisation and each scale's resize. Its device self time is
the spans' window on the card's clock, so it holds the upload's copy and
the stretch the card waits for the host: summed over the traced window, in
ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "lseg.preprocess")
