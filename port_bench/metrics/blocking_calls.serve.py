"""Host calls that wait on the card a view (CUDA's sync debug mode over a
few views after the traced window)."""


def read(ctx):
    t = ctx.get("traced")
    if ctx["kind"] != "serve" or t is None:
        return None
    return t["blocking_per_unit"]
