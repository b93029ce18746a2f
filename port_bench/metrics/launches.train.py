"""Device kernels a step in the traced window (copies and memsets left
out): the host's dispatch work."""
from port_bench.harness import trace


def read(ctx):
    t = ctx.get("traced")
    if ctx["kind"] != "train" or t is None or not t["intervals"]:
        return None
    return len(trace.kernels(t["intervals"])) / t["units"]
