"""The forward compositing kernel's share of its roofline: the least time
the card needs for the traced steps' forward work (yardstick/bounds.py,
counted from the reference's binning) over the kernel's device time, in %."""
from port_bench.harness import trace


def read(ctx):
    t = ctx.get("traced")
    if ctx["kind"] != "train" or t is None:
        return None
    us = trace.kernel_us(t["intervals"], "raster_forward")
    return 100.0 * t["fwd_bound_s"] / (us / 1e6) if us > 0 else None
