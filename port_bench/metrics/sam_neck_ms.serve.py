"""Card time an image in the program's ``sam.neck`` span, the encoder's
neck (1x1 convolution 1280 -> 256, LayerNorm, 3x3 convolution, LayerNorm;
a hook on the ``transformers`` module; the crop after it is a view): the
span's device self time summed over the traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "sam.neck")
