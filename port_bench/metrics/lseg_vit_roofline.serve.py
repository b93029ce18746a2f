"""The LSeg trunk's share of the card's f32 peak: its blocks' counted
operations an image (yardstick/lseg.py ``trunk_ops``: the projections,
q k^T, p v and the MLP, whatever runs them) over the device time an image
of the program's ``lseg.block`` spans times 67 TFLOP/s, in %. The blocks
are bound by their operations; library kernels run them (no hand-written
one)."""
from port_bench.harness import program_trace
from port_bench.yardstick.peaks import PEAK_F32_FLOPS


def read(ctx):
    ms = program_trace.span_ms(ctx, "serve", "lseg.block")
    t = ctx.get("traced")
    if ms is None or not ms > 0 or not t.get("trunk_ops"):
        return None
    per_image = t["trunk_ops"] / t["units"]
    return 100.0 * per_image / (ms / 1e3 * PEAK_F32_FLOPS)
