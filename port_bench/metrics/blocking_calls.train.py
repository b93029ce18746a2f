"""Host calls that wait on the card a step (CUDA's sync debug mode over a
few steps after the traced window)."""


def read(ctx):
    t = ctx.get("traced")
    if ctx["kind"] != "train" or t is None:
        return None
    return t["blocking_per_unit"]
