"""Measuring helpers shared by the bench CLIs (``cli/bench.py``,
``cli/bench_render.py``, ``cli/profile_step.py``, ``cli/bench_longrun.py``,
``cli/bench_scaling.py``), the stage micro-benchmarks
(``cli/micro_segsum.py``, ``cli/micro_expand.py``, ``cli/micro_pack.py``)
and ``chip_smoke.py``; the port of ``feature3dgs_tpu/bench_utils.py``.
``PEAK_BYTES`` and ``PEAK_F32_FLOPS`` are the card's data-sheet peaks that
every bound here is taken against.

Timing: eager PyTorch queues work on the card's stream and returns, so a
host clock without a synchronise measures the enqueue. ``profiled_step_ms``
synchronises, records a CUDA event on each side of one call, synchronises
again and reads the events' span, and takes the median over the calls. The
JAX helper's rule (the largest event of a profiler trace is the step) has
no counterpart here: an eager step is hundreds of kernels, none of which
spans it. On the CPU (asked for with ``device="cpu"``) the span is the host
clock's.

Profiling: ``profile_steps`` times steps alone, then runs as many under
``torch.profiler`` and groups the card's own events (kernels, copies,
memsets) by name, with the device busy time a step and the idle share
against the unprofiled step span.

Scenes: ``bench_scene`` is ``bench.py``'s (``bench.py:81-105``), numpy draws
in its order; ``orbit_view`` and ``camera`` make ``scripts/bench_render.py``'s
orbit cameras.
"""
from __future__ import annotations

import math
import statistics
import subprocess
import time
import warnings

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device

# H100 SXM data-sheet peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# bench.py's scene (bench.py:27-31) and camera (:95-103)
N_GAUSS, F_DIM, WIDTH, HEIGHT = 100_000, 128, 1216, 800
TAN_FOVX, TAN_FOVY = math.tan(0.6), math.tan(0.45)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_label(device: torch.device) -> str:
    """What a result line names as its device: the card's name and power
    limit, or "cpu"."""
    return card_line() if device.type == "cuda" else str(device)


def bytes_bound_ms(n_bytes: int) -> float:
    """The least milliseconds the card could take to move ``n_bytes`` of
    device memory, at ``PEAK_BYTES``."""
    return n_bytes / PEAK_BYTES * 1e3


def platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timing_method(device: torch.device) -> str:
    return "cuda_events" if device.type == "cuda" else "host_clock"


def step_span_ms(step, device: torch.device) -> float:
    """Milliseconds of one ``step()`` call, from a synchronised start to the
    end of everything it queued: CUDA events on the card, the host clock on
    the CPU."""
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        step()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def profiled_step_ms(step_and_block, n: int = 3, device=None) -> float:
    """Median over ``n`` calls of ``step_and_block()`` of each call's span
    (``step_span_ms``) on ``default_device(device)``."""
    dev = default_device(device)
    return statistics.median(step_span_ms(step_and_block, dev)
                             for _ in range(n))


def profile_steps(step, n: int, device=None) -> dict:
    """``n`` calls of ``step()`` timed alone (``step_span_ms``), then ``n``
    more under ``torch.profiler`` (whose host-side recording slows the
    calls it watches). Returns {"spans_ms": the unprofiled spans [n],
    "rows": [(median ms, count, name)] largest first, "busy_ms": device
    busy ms a call, "idle_share", "profile"}. On the card the rows are the
    device's own events (kernels, copies, memsets), ``busy_ms`` their summed
    time over ``n``, and the idle share 1 - busy_ms / the median unprofiled
    span; on the CPU the rows are the operators (nested ones overlap their
    callers, as the JAX table's do) and neither busy time nor idle share is
    measured (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = default_device(device)
    on_card = dev.type == "cuda"
    spans = [step_span_ms(step, dev) for _ in range(n)]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    with profile(activities=activities) as prof:
        for _ in range(n):
            step()
        synchronize(dev)
    kind = DeviceType.CUDA if on_card else DeviceType.CPU
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == kind:
            by_name.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    rows = sorted(((statistics.median(d), len(d), name)
                   for name, d in by_name.items()), reverse=True)
    busy = device_busy_ms(prof) / n if on_card else None
    return {"spans_ms": spans, "rows": rows, "busy_ms": busy,
            "idle_share": (None if busy is None
                           else 1.0 - busy / statistics.median(spans)),
            "profile": prof}


def device_busy_ms(prof) -> float:
    """The card's busy milliseconds in a finished profile: the sum of every
    device event's own time, as ``key_averages``' footer sums it."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def blocking_calls(step) -> int:
    """The host calls that block on the card while step() runs (CUDA's
    sync debug mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def camera(view, width, height, tan_x, tan_y, device=None):
    """The CameraView of a world-to-view matrix with the projection of
    ``bench.py`` (near 0.01, far 100) at the given field of view."""
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import transforms
    fovx, fovy = 2 * math.atan(tan_x), 2 * math.atan(tan_y)
    proj = transforms.projection_matrix(0.01, 100.0, fovx, fovy) @ view
    return camera_from_numpy(
        view, proj, transforms.camera_center_from_view(view).astype(np.float32),
        tan_x, tan_y, width, height, device)


def orbit_view(i):
    """scripts/bench_render.py's orbit: rotate about z by 0.05 * i (view 0
    is bench.py's camera at z = -5 looking down +z)."""
    from feature3dgs_tpu_torch.core import transforms
    c, s = math.cos(0.05 * i), math.sin(0.05 * i)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return transforms.world_to_view(rot, np.array([0.0, 0.0, 5.0]))


def bench_camera(width=WIDTH, height=HEIGHT, device=None, i: int = 0):
    """Orbit view ``i`` at bench.py's field of view (1.2 x 0.9 rad)."""
    return camera(orbit_view(i), width, height, TAN_FOVX, TAN_FOVY, device)


def bench_scene(device=None, n_gauss=N_GAUSS, f_dim=F_DIM, width=WIDTH,
                height=HEIGHT, teacher_dim=None):
    """bench.py's scene and targets (bench.py:81-105), numpy draws in its
    order: seed 0, ``n_gauss`` Gaussians in [-2, 2]^3, SH degree 3 (DC from
    random colors), opacity 0.5, ``f_dim`` channels ~ N(0, 0.1^2); then
    gt_image U(0,1) [height, width, 3] and a teacher ~ N(0, 0.1^2)
    [height/2, width/2, teacher_dim] (default ``f_dim``). Returns (params,
    state, gt_image, gt_feature) on ``default_device(device)``; the camera
    is ``bench_camera``."""
    from feature3dgs_tpu_torch.model import gaussians as G
    dev = default_device(device)
    teacher_dim = f_dim if teacher_dim is None else teacher_dim
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.0, 2.0, (n_gauss, 3)).astype(np.float32)
    cols = rng.rand(n_gauss, 3).astype(np.float32)
    params, state = G.create_from_pcd(
        pts, cols, max_sh_degree=3, feature_dim=f_dim, capacity=n_gauss,
        knn_mean_dists=np.full(n_gauss, 2e-4, np.float32), device=dev)
    params.semantic_feature = torch.from_numpy(
        rng.randn(n_gauss, 1, f_dim).astype(np.float32) * 0.1).to(dev)
    params.opacity = torch.zeros((n_gauss, 1), device=dev)
    state.active_sh_degree = 3
    gt_image = torch.from_numpy(
        rng.rand(height, width, 3).astype(np.float32)).to(dev)
    gt_feature = torch.from_numpy(
        rng.randn(height // 2, width // 2, teacher_dim).astype(np.float32)
        * 0.1).to(dev)
    return params, state, gt_image, gt_feature
