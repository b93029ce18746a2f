"""Card time an image in LSeg's dense head (``encoders/lseg_net.py``): the
device self time of the program's ``lseg.reassemble`` (readouts, 1x1
convolutions, resamples), ``lseg.fusion`` (the ``layer*_rn`` convolutions
and the four RefineNets) and ``lseg.head`` (``head1``, the final upsample,
the resize back and the average) spans, summed over the traced window, in
ms."""
from port_bench.harness import program_trace

SPANS = ("lseg.reassemble", "lseg.fusion", "lseg.head")


def read(ctx):
    parts = [program_trace.span_ms(ctx, "serve", s) for s in SPANS]
    return None if None in parts else sum(parts)
