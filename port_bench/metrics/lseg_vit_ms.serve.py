"""Card time an image in the program's ``lseg.block`` spans, the 24
global-attention blocks of LSeg's ViT-L/16 trunk
(``encoders/lseg_net.py``): the spans' device self time summed over the
traced window, in ms."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "lseg.block")
