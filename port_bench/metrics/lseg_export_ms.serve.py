"""Card time an image in the program's ``lseg.export`` span
(``encoders/lseg_net.py:export_features``): the fp16 cast, the stride
resize, the second cast and the copy to the host, whose end the host waits
for: the span's device self time summed over the traced window, in ms.
It mixes device work with the copy: the casts and the resize of the
float32 map run on the card inside the span, so a faster resize moves
this host-loop number too; the trace's kernels tell the two apart."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "serve", "lseg.export")
