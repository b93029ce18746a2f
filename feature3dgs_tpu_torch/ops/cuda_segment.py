"""The compositing backward's segment-sum on the card: the wrapper of
ops/csrc/segment.cu.

One launch sums a row array of the backward kernel's per-entry rows
([L, C], gid_sorted order) into [N, C] per-Gaussian sums, reading each
Gaussian's rows where they lie through a ``SegmentPlan``'s ``order`` and
``bounds`` (``ops/segment.py``), and with them a rider of few channels
(the training step's geometric rows beside its feature rows). Bit-equal on
the card to the plain version, ``torch.segment_reduce(rows[order], "sum",
lengths=...)``: each channel's rows are added to 0 in plan order.
``team_plan`` (the lanes of a team and vectors a lane, from C and the
alignment) is a pure function, so the CPU tests reach it. The library is
built and opened by ``ops.kernel_lib`` with the signatures of
``LIBRARIES`` and called through ``ctypes`` on PyTorch's current stream.
``SEGMENT_LAUNCHES`` counts launches.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

from feature3dgs_tpu_torch.ops.kernel_lib import check, load, raise_on

# threads a block (THREADS in segment.cu)
THREADS = 256
# launches since import (or since a caller reset them)
SEGMENT_LAUNCHES = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
# {library: (signatures, constants)}, as ops.kernel_lib.load takes them
LIBRARIES = {"segment": (
    {"f3dgs_segment_sum": ([_p, _p, _i, _p, _p] + [_i] * 4 + [_p, _p, _i, _p],
                           _i),
     "f3dgs_segment_attributes": ([_i, _i, ctypes.POINTER(_i)], _i),
     "f3dgs_segment_threads": ([], _i)},
    {"f3dgs_segment_threads": THREADS})}


class TeamPlan(NamedTuple):
    vec4: bool      # 16-byte vectors (else floats)
    lanes: int      # lanes a team, and Gaussians it sums: a power of two,
                    # at most a warp
    per_lane: int   # vectors a lane a pass: 1, 2 or 4


def team_plan(channels: int, vec4: bool) -> TeamPlan:
    """The team that walks the rows of ``channels`` floats, read as float4
    (``vec4``) or float vectors: as many lanes as the row has vectors, up to
    a warp, then up to 4 vectors a lane (more passes past that)."""
    if channels < 1 or (vec4 and channels % 4):
        raise ValueError(f"{channels} channels cannot be read as "
                         f"{'float4' if vec4 else 'float'} vectors")
    nvec = channels // 4 if vec4 else channels
    lanes = min(32, 1 << (nvec - 1).bit_length())
    need = -(-nvec // lanes)
    return TeamPlan(vec4, lanes, 1 if need <= 1 else 2 if need <= 2 else 4)


def _library():
    return load("segment", *LIBRARIES["segment"])


def kernel_attributes(vec4: bool, per_lane: int) -> dict:
    """Registers and local-memory (spill) bytes a thread and resident
    blocks an SM of the instantiation on float4 or float vectors with
    ``per_lane`` vectors a lane."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    raise_on(lib, "segment_sum",
             lib.f3dgs_segment_attributes(int(vec4), per_lane, out))
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


def segment_sum_cuda(order: torch.Tensor, bounds: torch.Tensor,
                     rows: torch.Tensor, rider: torch.Tensor = None) -> tuple:
    """``rows`` [L, C] float32 -> [N, C], row g the sum of its rows
    ``order[bounds[g]:bounds[g + 1]]`` added in that order (zeros where the
    range is empty); the same for ``rider`` [L, C2] (None: none) in the
    same launch where C2 is no more than the lanes of the rows' team, in a
    launch of its own otherwise. Returns (sums of rows, sums of rider or
    None). ``order`` [L] and ``bounds`` [N + 1] are int64 (a
    ``SegmentPlan``'s: order holds row indices, bounds is non-decreasing
    within [0, L]); all contiguous, on one CUDA device. Shape, dtype and
    layout are checked before the device, so that the CPU tests reach each
    check; anything else raises."""
    if bounds.dim() != 1 or bounds.shape[0] < 1:
        raise ValueError(f"bounds must be [N + 1], got shape "
                         f"{tuple(bounds.shape)}")
    n, l = bounds.shape[0] - 1, order.shape[0] if order.dim() == 1 else -1
    dev = order.device
    check("order", order, torch.int64, (l,), dev)
    check("bounds", bounds, torch.int64, (n + 1,), dev)
    for name, x in (("rows", rows), ("rider", rider)):
        if x is None:
            continue
        if x.dim() != 2:
            raise ValueError(f"{name} must be [L, C], got shape "
                             f"{tuple(x.shape)}")
        check(name, x, torch.float32, (l, x.shape[1]), dev)
    if max(l, n) >= 2 ** 30:
        raise ValueError(f"{l} rows of {n} Gaussians: the kernel takes "
                         "fewer than 2^30 of each")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    out = torch.empty((n, rows.shape[1]), dtype=torch.float32, device=dev)
    if rider is None:
        if n and rows.shape[1]:
            _launch(order, bounds, rows, out)
        return out, None
    if not rows.shape[1]:
        return out, segment_sum_cuda(order, bounds, rider)[0]
    if rider.shape[1] > _team(rows).lanes:
        return (segment_sum_cuda(order, bounds, rows)[0],
                segment_sum_cuda(order, bounds, rider)[0])
    out2 = torch.empty((n, rider.shape[1]), dtype=torch.float32, device=dev)
    if n:
        _launch(order, bounds, rows, out, rider, out2)
    return out, out2


def _team(rows: torch.Tensor) -> TeamPlan:
    """The team of ``rows``: float4 vectors where each row starts on a
    16-byte boundary."""
    return team_plan(rows.shape[1], rows.shape[1] % 4 == 0
                     and rows.data_ptr() % 16 == 0)


def _launch(order, bounds, rows, out, rider=None, out2=None):
    """One launch on the current stream of ``rows``' device."""
    global SEGMENT_LAUNCHES
    lib = _library()
    plan = _team(rows)
    dev = rows.device
    switch = (contextlib.nullcontext() if dev.index ==
              torch.cuda.current_device() else torch.cuda.device(dev))
    with switch:
        err = lib.f3dgs_segment_sum(
            order.data_ptr(), bounds.data_ptr(), out.shape[0],
            rows.data_ptr(), out.data_ptr(), rows.shape[1], int(plan.vec4),
            plan.lanes.bit_length() - 1, plan.per_lane,
            None if rider is None else rider.data_ptr(),
            None if out2 is None else out2.data_ptr(),
            0 if rider is None else rider.shape[1],
            torch._C._cuda_getCurrentRawStream(dev.index))
    raise_on(lib, "segment_sum", err)
    SEGMENT_LAUNCHES += 1
