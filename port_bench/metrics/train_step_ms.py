"""Time to train a scene: the window's seconds over the steps it
completed, in milliseconds (no synchronise per step)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    return 1e3 * ctx["window_s"] / ctx["units"]
