"""The mask decoder's share of the card's f32 peak: its counted operations
a view (yardstick/sam_decoder.py: the prompt encoder's and mask decoder's
products and transposed convolutions, whatever runs them) over the device
time a view of the program's ``sam.decode`` spans times 67 TFLOP/s, in %.
The work is bound by its operations (its bytes' bound is under 1% of
theirs)."""
from port_bench.harness import program_trace
from port_bench.yardstick.peaks import PEAK_F32_FLOPS


def read(ctx):
    ms = program_trace.span_ms(ctx, "serve", "sam.decode")
    t = ctx.get("traced")
    if ms is None or not ms > 0 or not t.get("sam_decode_ops"):
        return None
    per_view = t["sam_decode_ops"] / t["units"]
    return 100.0 * per_view / (ms / 1e3 * PEAK_F32_FLOPS)
