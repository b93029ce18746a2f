"""The interactive frame's tail: the 95th percentile of the requests'
latencies over every request of the window, in milliseconds."""
import statistics


def read(ctx):
    lat = ctx.get("latencies_s")
    if ctx["kind"] != "serve" or not lat or len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
