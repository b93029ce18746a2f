"""The feature loss's align_corners bilinear resize on the card, straight
from the rasterizer's tile layout: the wrapper of ops/csrc/resize.cu.

One forward launch maps the [T, P, F] feature tiles of a ``TileGrid`` to
the [out_h, out_w, F] map that ``train/losses.py`` compares with the
teacher, with the taps ``F.interpolate(mode="bilinear",
align_corners=True)`` computes in float32; one backward launch maps the
map's gradient back to a [T, P, F] tile gradient, every element written
(0 on the padded grid outside the crop), gathered in a fixed order with no
atomics. The plain version is ``tiles_to_image`` + ``F.interpolate``
(``train/losses.py:resize_bilinear_align_corners``). The library is built
and opened by ``ops.kernel_lib`` with the signatures of ``LIBRARIES`` and
called through ``ctypes`` on PyTorch's current stream. ``RESIZE_LAUNCHES``
and ``RESIZE_BWD_LAUNCHES`` count launches.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from feature3dgs_tpu_torch.ops.kernel_lib import check, load, raise_on

# launches since import (or since a caller reset them)
RESIZE_LAUNCHES = 0
RESIZE_BWD_LAUNCHES = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
# {library: (signatures, constants)}, as ops.kernel_lib.load takes them
LIBRARIES = {"resize": (
    {"f3dgs_resize_forward": ([_p, _p] + [_i] * 9 + [_p], _i),
     "f3dgs_resize_backward": ([_p, _p] + [_i] * 9 + [_p], _i),
     "f3dgs_resize_attributes": ([_i, _i, ctypes.POINTER(_i)], _i)},
    {})}


def _library():
    return load("resize", *LIBRARIES["resize"])


def kernel_attributes(backward: bool, vec4: bool = True) -> dict:
    """Registers and local-memory (spill) bytes a thread and resident
    blocks an SM of one kernel, on float4 or float channels."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    name = "resize_backward" if backward else "resize_forward"
    raise_on(lib, name, lib.f3dgs_resize_attributes(int(backward), int(vec4),
                                                    out))
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


def _checked(name: str, x: torch.Tensor, lead: tuple, out_h: int,
             out_w: int) -> int:
    """Raise unless ``x`` is a contiguous float32 CUDA tensor of shape
    ``lead`` + (F,) and the output has pixels; returns F.
    Shape, dtype and layout are checked before the device, so that the
    CPU tests reach each check."""
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size {out_h}x{out_w}: both must be >= 1")
    f = x.shape[-1] if x.dim() == len(lead) + 1 else -1
    check(name, x, torch.float32, (*lead, f), x.device)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{x.device}")
    return f


def _launch(fn_name: str, src: torch.Tensor, dst: torch.Tensor, grid,
            out_h: int, out_w: int):
    """Launch on the current stream of ``src``'s device. The raw stream
    handle, and a device switch only off the current device, keep the
    host's part of the call short, which the card waits out when it has
    run ahead of the host: on an H100 the wrapper took 21 us (29 under the
    profiler) against 36 (46) with ``torch.cuda.current_stream`` and a
    ``torch.cuda.device`` block."""
    lib = _library()
    dev = src.device
    switch = (contextlib.nullcontext() if dev.index ==
              torch.cuda.current_device() else torch.cuda.device(dev))
    with switch:
        err = getattr(lib, fn_name)(
            src.data_ptr(), dst.data_ptr(), src.shape[-1], grid.height,
            grid.width, out_h, out_w, grid.grid_x, grid.grid_y, grid.tile_w,
            grid.tile_h, torch._C._cuda_getCurrentRawStream(dev.index))
    raise_on(lib, fn_name[len("f3dgs_"):], err)


def resize_forward_cuda(tiles: torch.Tensor, grid, out_h: int,
                        out_w: int) -> torch.Tensor:
    """One launch: ``tiles`` [grid.num_tiles, grid.pixels_per_tile, F]
    float32, contiguous, on a CUDA device (the crop grid.height x
    grid.width at the padded grid's top left) -> [out_h, out_w, F], as
    ``F.interpolate(mode="bilinear", align_corners=True)`` of the image
    ``tiles_to_image`` assembles; anything else raises."""
    global RESIZE_LAUNCHES
    f = _checked("tiles", tiles, (grid.num_tiles, grid.pixels_per_tile),
                 out_h, out_w)
    out = torch.empty((out_h, out_w, f), dtype=torch.float32,
                      device=tiles.device)
    _launch("f3dgs_resize_forward", tiles, out, grid, out_h, out_w)
    RESIZE_LAUNCHES += 1
    return out


def resize_backward_cuda(g_out: torch.Tensor, grid, out_h: int,
                         out_w: int) -> torch.Tensor:
    """One launch: the gradient ``g_out`` [out_h, out_w, F] (float32,
    contiguous, CUDA) of ``resize_forward_cuda``'s output -> the gradient
    of its tiles, [grid.num_tiles, grid.pixels_per_tile, F], every element
    written: 0 on the padded grid outside the crop; anything else
    raises."""
    global RESIZE_BWD_LAUNCHES
    f = _checked("g_out", g_out, (out_h, out_w), out_h, out_w)
    g_tiles = torch.empty((grid.num_tiles, grid.pixels_per_tile, f),
                          dtype=torch.float32, device=g_out.device)
    _launch("f3dgs_resize_backward", g_out, g_tiles, grid, out_h, out_w)
    RESIZE_BWD_LAUNCHES += 1
    return g_tiles
