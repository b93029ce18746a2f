"""The whole view's share of the card's f32 peak: the view's counted
operations (yardstick/flops.py) over the traced window's time a view times
67 TFLOP/s, in %."""
from port_bench.yardstick.peaks import PEAK_F32_FLOPS


def read(ctx):
    t = ctx.get("traced")
    if ctx["kind"] != "serve" or t is None or not t["intervals"]:
        return None
    return 100.0 * t["ops"] / (t["window_s"] * PEAK_F32_FLOPS)
