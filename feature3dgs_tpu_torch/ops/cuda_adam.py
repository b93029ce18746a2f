"""Adam on the card: the wrapper of ops/csrc/adam.cu.

One launch updates every tensor of a group in place (``model/optim.py``'s
seven GaussianParams fields, or the decoder's w and b): p, g, mu and nu
are read once and p, mu and nu written once, with no temporaries, bit-equal
on the card to the plain version ``model/optim.py:_adam_``. The library is
built and opened by ``ops.kernel_lib`` with the signatures of
``LIBRARIES`` and called through ``ctypes`` on PyTorch's current stream.

A launch is described by a table passed by value (``AdamTable``, the C
struct's mirror): each tensor's four pointers, element count, gradient
layout and learning rate, the prefix of the tensors' chunk counts, and b1,
1 - b1, b2, 1 - b2 and eps rounded to float32 as PyTorch rounds a Python
scalar. It is built anew on every call: densification rebinds the tensors
and capacity growth resizes them. ``adam_plan`` (chunks and grid),
``grad_layout`` and ``adam_table`` are pure functions, and
``adam_entries`` (the checks) takes tensors on any device, so the CPU
tests reach them. ``ADAM_LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from feature3dgs_tpu_torch.ops.kernel_lib import (check, check_aligned, load,
                                                  raise_on)

# elements a block updates (CHUNK in adam.cu) and tensors a launch
CHUNK = 4096
MAX_TENSORS = 16
# launches since import (or since a caller reset it)
ADAM_LAUNCHES = 0


class AdamTable(ctypes.Structure):
    """adam.cu's ``Table``, field for field."""
    _fields_ = [("p", ctypes.c_void_p * MAX_TENSORS),
                ("g", ctypes.c_void_p * MAX_TENSORS),
                ("m", ctypes.c_void_p * MAX_TENSORS),
                ("v", ctypes.c_void_p * MAX_TENSORS),
                ("n", ctypes.c_longlong * MAX_TENSORS),
                ("g_row_len", ctypes.c_longlong * MAX_TENSORS),
                ("g_row_stride", ctypes.c_longlong * MAX_TENSORS),
                ("lr", ctypes.c_float * MAX_TENSORS),
                ("chunk_end", ctypes.c_int * MAX_TENSORS),
                ("b1", ctypes.c_float), ("one_minus_b1", ctypes.c_float),
                ("b2", ctypes.c_float), ("one_minus_b2", ctypes.c_float),
                ("eps", ctypes.c_float)]


class AdamPlan(NamedTuple):
    chunk_end: tuple   # chunks of tensors 0..i, the total past the last one
    blocks: int        # one block a chunk


class AdamEntry(NamedTuple):
    p: int             # data pointers
    g: int
    m: int
    v: int
    n: int             # elements
    g_row_len: int     # grad_layout's pair
    g_row_stride: int
    lr: float


def adam_plan(counts) -> AdamPlan:
    """Chunks of CHUNK elements a tensor (the last one partial) and one
    block a chunk, for tensors of ``counts`` elements. Block b updates
    tensor k = the number of chunk ends at or below b, from element
    (b - chunk_end[k - 1]) * CHUNK."""
    if not 1 <= len(counts) <= MAX_TENSORS:
        raise ValueError(f"{len(counts)} tensors: a launch takes 1 to "
                         f"{MAX_TENSORS}")
    ends, total = [], 0
    for n in counts:
        if n < 0:
            raise ValueError(f"negative element count {n}")
        total += -(-n // CHUNK)
        ends.append(total)
    if total >= 2 ** 31:
        raise ValueError("sizes exceed the kernel's 32-bit grid")
    return AdamPlan(tuple(ends + [total] * (MAX_TENSORS - len(ends))), total)


def grad_layout(shape, strides, aligned: bool) -> tuple[int, int]:
    """How the kernel reads a gradient of ``shape`` and ``strides``
    (elements): (0, 0) as float4 when it is contiguous and 16-byte
    aligned; else (row length, row stride) of rows along the first
    dimension, each row contiguous, read element by element (autograd's
    slices of one torch.cat gradient). Raises on any other layout."""
    shape, strides = tuple(shape), tuple(strides)
    if not shape:
        shape, strides = (1,), (1,)
    row_len = 1
    for size, stride in zip(shape[:0:-1], strides[:0:-1]):
        if size != 1 and stride != row_len:
            raise ValueError(f"a gradient of shape {shape} and strides "
                             f"{strides}: the kernel takes rows at a stride, "
                             "each row contiguous")
        row_len *= size
    if shape[0] * row_len == 0:
        return 0, 0
    if (shape[0] == 1 or strides[0] == row_len) and aligned:
        return 0, 0
    return row_len, strides[0]


def adam_entries(params: dict, grads: dict, mu: dict, nu: dict, lrs: dict,
                 device: torch.device) -> list:
    """The launch's entries, after the checks: p, mu and nu contiguous
    float32 tensors of one shape on ``device``, 16-byte aligned; g float32
    of that shape there, in a layout ``grad_layout`` takes."""
    f32 = torch.float32
    entries = []
    for k, p in params.items():
        shape = tuple(p.shape)
        for name, x in ((k, p), (f"mu[{k}]", mu[k]), (f"nu[{k}]", nu[k])):
            check(name, x, f32, shape, device)
            check_aligned(name, x)
        g = grads[k]
        if g.device != device:
            raise ValueError(f"grad[{k}] is on {g.device}, expected {device}")
        if g.dtype != f32:
            raise ValueError(f"grad[{k}] has dtype {g.dtype}, expected {f32}")
        if tuple(g.shape) != shape:
            raise ValueError(f"grad[{k}] has shape {tuple(g.shape)}, "
                             f"expected {shape}")
        row_len, row_stride = grad_layout(g.shape, g.stride(),
                                          g.data_ptr() % 16 == 0)
        entries.append(AdamEntry(p.data_ptr(), g.data_ptr(), mu[k].data_ptr(),
                                 nu[k].data_ptr(), math.prod(shape), row_len,
                                 row_stride, float(lrs[k])))
    return entries


def adam_table(entries: list, plan: AdamPlan, b1: float, b2: float,
               eps: float) -> AdamTable:
    """The launch's table. ctypes rounds each scalar to float32 as PyTorch
    rounds a Python float; 1 - b1 and 1 - b2 are taken in double first, as
    the plain version's ``(1 - b1) * g`` takes them."""
    t = AdamTable()
    for i, e in enumerate(entries):
        t.p[i], t.g[i], t.m[i], t.v[i] = e.p, e.g, e.m, e.v
        t.n[i], t.g_row_len[i], t.g_row_stride[i] = (e.n, e.g_row_len,
                                                     e.g_row_stride)
        t.lr[i] = e.lr
    t.chunk_end[:] = plan.chunk_end
    t.b1, t.one_minus_b1, t.b2, t.one_minus_b2 = b1, 1 - b1, b2, 1 - b2
    t.eps = eps
    return t


_p, _i = ctypes.c_void_p, ctypes.c_int
# {library: (signatures, constants)}, as ops.kernel_lib.load takes them
LIBRARIES = {"adam": (
    {"f3dgs_adam": ([ctypes.POINTER(AdamTable), _i, _p, _p, _p], _i),
     "f3dgs_adam_chunk": ([], _i),
     "f3dgs_adam_max_tensors": ([], _i),
     "f3dgs_adam_table_bytes": ([], ctypes.c_size_t),
     "f3dgs_adam_attributes": ([ctypes.POINTER(_i)], _i)},
    {"f3dgs_adam_chunk": CHUNK, "f3dgs_adam_max_tensors": MAX_TENSORS,
     "f3dgs_adam_table_bytes": ctypes.sizeof(AdamTable)})}


def _library():
    return load("adam", *LIBRARIES["adam"])


def kernel_attributes() -> dict:
    """Registers and local-memory (spill) bytes a thread, and resident
    blocks an SM, of the kernel."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    raise_on(lib, "adam", lib.f3dgs_adam_attributes(out))
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


def adam_cuda_(params: dict, grads: dict, mu: dict, nu: dict,
               step: torch.Tensor, lrs: dict, keep: torch.Tensor | None, *,
               b1: float, b2: float, eps: float) -> None:
    """One Adam update of every tensor of ``params`` in place, in one
    launch, as ``model/optim.py:_adam_`` makes it: bias corrections from
    the int32 counter ``step`` (the count before this update), and where
    the 0-d bool ``keep`` is False nothing is written. The counter is read,
    not advanced: the caller advances it after the launch. Every tensor
    lies on one CUDA device (``adam_entries`` says in what layouts);
    anything else raises."""
    global ADAM_LAUNCHES
    dev = next(iter(params.values())).device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    entries = adam_entries(params, grads, mu, nu, lrs, dev)
    check("step", step, torch.int32, (), dev)
    if keep is not None:
        check("keep", keep, torch.bool, (), dev)
    plan = adam_plan([e.n for e in entries])
    if not plan.blocks:
        return
    table = adam_table(entries, plan, b1, b2, eps)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.f3dgs_adam(ctypes.byref(table), plan.blocks,
                             step.data_ptr(),
                             None if keep is None else keep.data_ptr(),
                             stream)
    raise_on(lib, "adam", err)
    ADAM_LAUNCHES += 1
