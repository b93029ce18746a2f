"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``port_bench/reference``), run once the window
has closed and the program's state is freed.

The cell's entry (``entries/<entry>.py``) works out the reference's
readings of what its run produced (``reference``) and the numbers compared
(``numbers``); its docstring says what each number is. Here they are run,
judged against the cell's limits, and, for calibration only, read again
with the control in the program's place.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from port_bench.harness import scene
from port_bench.reference import render as R


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in full f32, or in TF32 (the
    control)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def ref_cam(cfg, i, device) -> R.Cam:
    rot, t = scene.orbit(cfg, i)
    return R.make_cam(rot, t, cfg["fovx"], cfg["fovy"], cfg["width"],
                      cfg["height"], device)


def run(entry, cfg, traffic, seed, out: dict, device) -> dict:
    """The numbers compared, program against reference."""
    ref = entry.reference(cfg, traffic, seed, out, device)
    return entry.numbers(out["readings"], ref)


def control(entry, cfg, traffic, seed, out: dict, device) -> dict:
    """The same numbers with the reference computed in the precision below
    the configuration's (TF32 for its f32 with TF32 off) put in the
    program's place: {"tf32": numbers}. An entry with a ``frozen`` fault
    adds {"frozen": numbers} of the reference with that fault planted, and
    one with ``leaves`` each leaf's gaps ({"leaves": {"program", "tf32"}}).
    Their readings set the limits' upper ends. ``out`` gives the inputs
    the program's run drew."""
    ref = entry.reference(cfg, traffic, seed, out, device)
    low = entry.reference(cfg, traffic, seed, out, device, tf32=True)
    res = {"tf32": entry.numbers(low, ref)}
    if hasattr(entry, "frozen"):
        res["frozen"] = entry.numbers(
            entry.frozen(cfg, traffic, seed, out, device), ref)
    if hasattr(entry, "leaves"):
        res["leaves"] = {"program": entry.leaves(out["readings"], ref),
                         "tf32": entry.leaves(low, ref)}
    return res


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without its number, fails."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    for k in limits:
        if k not in checks:
            checks[k] = {"value": None, "limit": limits[k]}
    ok = all(c["value"] is not None and c["limit"] is not None
             and np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
