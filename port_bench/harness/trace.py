"""Reading a ``torch.profiler`` trace of the traced window: the device's
activity as intervals, their union, the kernels by name, and the idle gaps
named by what the host was doing.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch

WINDOW = "port_bench.window"
COPY_PREFIXES = ("Memcpy", "Memset")


@contextmanager
def profiled(device: torch.device, out: dict):
    """Profile the block; on exit ``out`` holds {"events": the profile's
    events, "window": (start_us, end_us) of the block on the profiler's
    clock, "host_s": its seconds on the host clock}. The block should end
    with the device synchronised."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        out["host_s"] = time.perf_counter() - t0
    from torch.autograd import DeviceType
    events = prof.events()
    win = [e for e in events
           if e.name == WINDOW and e.device_type == DeviceType.CPU]
    out["events"] = events
    out["window"] = ((win[0].time_range.start, win[0].time_range.end)
                     if win else None)


def device_intervals(events, window) -> list:
    """[(name, start_us, end_us)] of every device activity inside
    ``window`` (kernels, copies, memsets; not the ranges that
    ``record_function`` mirrors onto the device), clipped to it, in start
    order."""
    from torch.autograd import DeviceType
    lo, hi = window
    out = []
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == WINDOW
                or getattr(e, "is_user_annotation", False)):
            continue
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t > s:
            out.append((e.name, s, t))
    out.sort(key=lambda x: x[1])
    return out


def union(intervals) -> list:
    """Merged [(start, end)] of intervals given in start order."""
    merged = []
    for _, s, t in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def busy_us(intervals) -> float:
    return sum(t - s for s, t in union(intervals))


def kernels(intervals) -> list:
    return [x for x in intervals if not x[0].startswith(COPY_PREFIXES)]


def kernel_us(intervals, fragment: str) -> float:
    """Summed device time of activities whose name holds ``fragment``."""
    return sum(t - s for name, s, t in intervals if fragment in name)


def top_ops(intervals, k: int = 10) -> list:
    """[[name, seconds]] of the ``k`` device activities that took most time
    in all, largest first."""
    by = {}
    for name, s, t in intervals:
        by[name] = by.get(name, 0.0) + (t - s)
    ranked = sorted(by.items(), key=lambda x: -x[1])[:k]
    return [[name[:200], us / 1e6] for name, us in ranked]


def idle_gaps(events, intervals, window, k: int = 10) -> list:
    """[[host activity, seconds]] of the ``k`` longest stretches of the
    window with no device activity, each named by the innermost host
    operation running at its start."""
    from torch.autograd import DeviceType
    lo, hi = window
    gaps, at = [], lo
    for s, t in union(intervals):
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if hi > at:
        gaps.append((at, hi))
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    gaps = gaps[:k]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name != WINDOW]
    out = []
    for s, t in gaps:
        inner = [e for e in host
                 if e.time_range.start <= s < e.time_range.end]
        name = (min(inner, key=lambda e: e.time_range.end
                    - e.time_range.start).name if inner else "python")
        out.append([name[:200], (t - s) / 1e6])
    return out
