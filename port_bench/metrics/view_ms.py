"""Novel-view throughput: the window's seconds over the views completed,
in milliseconds."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["units"]:
        return None
    return 1e3 * ctx["window_s"] / ctx["units"]
