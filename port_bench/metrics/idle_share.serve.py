"""Share of the traced window in which no operation ran on the card:
1 - union of the device's activity intervals / the window, in %."""


def read(ctx):
    t = ctx.get("traced")
    if ctx["kind"] != "serve" or t is None or not t["intervals"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
