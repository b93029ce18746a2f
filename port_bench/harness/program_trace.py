"""Reading the program's own spans and counters of the traced window.

The program records them itself (``feature3dgs_tpu_torch/tracing.py``)
while the harness's profiler is active, and keeps the last session. A span
metric is the span's device self time (its window on the card's clock less
the part its child spans cover), summed over the window and divided by the
window's steps or views; a counter metric is the counter's sum divided the
same way. Each returns None for a cell of the other kind, for a program
without the module or without a session, and for a time off the card.
"""
from __future__ import annotations

import importlib


def _summary():
    try:
        tracing = importlib.import_module("feature3dgs_tpu_torch.tracing")
    except ImportError:
        return None
    session = tracing.last_session()
    return None if session is None else session.summary()


def _units(ctx: dict, kind: str):
    t = ctx.get("traced")
    if ctx["kind"] != kind or t is None or not t["units"]:
        return None
    return t["units"]


def span_ms(ctx: dict, kind: str, name: str):
    """Device self ms of span ``name`` a step or view."""
    units = _units(ctx, kind)
    s = _summary() if units else None
    if s is None or name not in s["spans"]:
        return None
    ms = s["spans"][name]["device_self_ms"]
    return None if ms is None else ms / units


def counted(ctx: dict, kind: str, prefix: str):
    """The summed counters whose names start with ``prefix``, a step or
    view."""
    units = _units(ctx, kind)
    s = _summary() if units else None
    if s is None:
        return None
    hits = [v for k, v in s["counters"].items() if k.startswith(prefix)]
    return sum(hits) / units if hits else None
