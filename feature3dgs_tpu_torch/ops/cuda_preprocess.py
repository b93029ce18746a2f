"""The per-Gaussian preprocess on the card: the wrapper of
ops/csrc/preprocess.cu.

One forward launch a view computes what ``ops/rasterize.py:_prep_view``
takes from ``core/projection.py:preprocess`` through the cull: pixel
means (with the ``ndc_offset`` added), depth, conic, the 3-sigma radius,
the colour from SH, the opacity-aware tile rectangle and the valid mask.
One backward launch gives the gradients of means, scales, rotations, the
SH stack and ``ndc_offset`` from the cotangents of xy, depth, conic and
rgb, recomputing the forward from the inputs. Both are bit-equal on the
card to their plain versions: the forward to ``preprocess`` +
``rect_radius`` + ``tile_rect``, the backward to
``core/projection.py:preprocess_backward``. The library is built and
opened by ``ops.kernel_lib`` with the signatures of ``LIBRARIES`` and
called through ``ctypes`` on PyTorch's current stream.

``preprocess_plan`` (threads, blocks, staged SH rows and their shared
memory) is a pure function, and ``INV_THREE`` / ``INV_ALPHA_MIN`` are the
float32 reciprocals PyTorch's CUDA division by a Python scalar multiplies
by, so the CPU tests reach them. ``PREPROCESS_LAUNCHES`` and
``PREPROCESS_BWD_LAUNCHES`` count launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from feature3dgs_tpu_torch.ops.composite import ALPHA_MIN
from feature3dgs_tpu_torch.ops.kernel_lib import (check, check_aligned, load,
                                                  raise_on)

# Gaussians a block (THREADS in preprocess.cu)
THREADS = 128
# launches since import (or since a caller reset them)
PREPROCESS_LAUNCHES = 0
PREPROCESS_BWD_LAUNCHES = 0
# x / s on the card, for a Python float s, is x times float32(1 / s), the
# reciprocal taken in double: rect_radius's radius / 3.0 and op / ALPHA_MIN
INV_THREE = float(np.float32(1.0 / 3.0))
INV_ALPHA_MIN = float(np.float32(1.0 / ALPHA_MIN))


class PreprocessPlan(NamedTuple):
    threads: int       # Gaussians a block, one a thread
    blocks: int
    sh_rows: int       # (degree + 1)^2 rows read of each Gaussian's M
    row_stride: int    # floats a staged Gaussian takes: 3 * rows, made odd
    shared_bytes: int  # the staged rows and the camera (37 floats)


def preprocess_plan(n: int, sh_degree: int, m_rows: int) -> PreprocessPlan:
    """The launch of either kernel over ``n`` Gaussians whose SH stack has
    ``m_rows`` rows, read to degree ``sh_degree``."""
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree must be in [0,4], got {sh_degree}")
    rows = (sh_degree + 1) ** 2
    if m_rows < rows:
        raise ValueError(f"an SH stack of {m_rows} rows cannot be read to "
                         f"degree {sh_degree} ({rows} rows)")
    if n < 0 or 4 * n >= 2 ** 31:
        raise ValueError(f"{n} Gaussians: the kernels take 0 to "
                         f"{2 ** 29 - 1}")
    stride = 3 * rows | 1
    return PreprocessPlan(THREADS, -(-n // THREADS), rows, stride,
                          4 * (THREADS * stride + 37))


_p, _i, _f, _ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
# {library: (signatures, constants)}, as ops.kernel_lib.load takes them
LIBRARIES = {"preprocess": (
    {"f3dgs_preprocess_forward": (
        [_i, _i, _i] + [_p] * 12 + [_i] * 6 + [_f] * 3 + [_p] * 10, _i),
     "f3dgs_preprocess_backward": (
         [_i, _i, _i] + [_p] * 10 + [_i, _i, _f]
         + [_p, _ll, _ll, _p, _ll, _p, _ll, _ll, _p, _ll, _ll] + [_p] * 6, _i),
     "f3dgs_preprocess_threads": ([], _i),
     "f3dgs_preprocess_attributes": ([_i, _i, ctypes.POINTER(_i)], _i)},
    {"f3dgs_preprocess_threads": THREADS})}


def _library():
    return load("preprocess", *LIBRARIES["preprocess"])


def kernel_attributes(backward: bool, sh_degree: int) -> dict:
    """Registers and local-memory (spill) bytes a thread, resident blocks an
    SM and static shared bytes a block of one kernel at one degree."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    name = "preprocess_backward" if backward else "preprocess_forward"
    raise_on(lib, name, lib.f3dgs_preprocess_attributes(
        int(backward), sh_degree, out))
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2], "shared_bytes": out[3]}


def _check_inputs(means3d, scales, rotations, shs, cam, sh_degree):
    """Device, dtype, shape, contiguity and alignment of what both kernels
    read, and the degree against the SH rows; returns (device, n,
    m_rows)."""
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    n = means3d.shape[0]
    m_rows = shs.shape[1] if shs.dim() == 3 else -1
    preprocess_plan(n, sh_degree, m_rows)
    f32 = torch.float32
    check("means3d", means3d, f32, (n, 3), dev)
    check("scales", scales, f32, (n, 3), dev)
    check("rotations", rotations, f32, (n, 4), dev)
    check_aligned("rotations", rotations)
    check("shs", shs, f32, (n, m_rows, 3), dev)
    check("view", cam.view, f32, (4, 4), dev)
    check("proj", cam.proj, f32, (4, 4), dev)
    check("campos", cam.campos, f32, (3,), dev)
    check("tan_fovx", cam.tan_fovx, f32, (), dev)
    check("tan_fovy", cam.tan_fovy, f32, (), dev)
    return dev, n, m_rows


def _camera_args(cam) -> list:
    return [cam.view.data_ptr(), cam.proj.data_ptr(), cam.campos.data_ptr(),
            cam.tan_fovx.data_ptr(), cam.tan_fovy.data_ptr()]


def _f32(x) -> float:
    """A Python scalar as PyTorch rounds it into a float32 op."""
    return float(np.float32(x))


def preprocess_forward_cuda(means3d, scales, rotations, shs, opacities, cam,
                            grid, *, sh_degree: int, scale_modifier=1.0,
                            ndc_offset=None, active_mask=None):
    """One launch over the view's Gaussians. Takes means3d [N,3], activated
    scales [N,3], normalised rotations [N,4] (16-byte aligned), the SH
    stack [N,M,3], activated opacities [N] (float32, contiguous CUDA
    tensors), the camera's tensors on the same device, its ``grid``
    (``ops.binning.TileGrid``), ``ndc_offset`` [N,2] and ``active_mask``
    [N] bool or None; anything else raises. Returns (xy [N,2], depth [N],
    conic [N,3], radius [N], rgb [N,3], rect_min [N,2] int32, rect_max
    [N,2] int32, pre_valid [N] bool, valid [N] bool): xy with the offset
    added, radius zero where pre_valid (in front, invertible, radius > 0)
    is False, valid = pre_valid, a tile touched and active."""
    global PREPROCESS_LAUNCHES
    dev, n, m_rows = _check_inputs(means3d, scales, rotations, shs, cam,
                                   sh_degree)
    f32 = torch.float32
    check("opacities", opacities, f32, (n,), dev)
    if ndc_offset is not None:
        check("ndc_offset", ndc_offset, f32, (n, 2), dev)
    if active_mask is not None:
        check("active_mask", active_mask, torch.bool, (n,), dev)
    empty = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype,
                                                  device=dev)
    i32 = torch.int32
    out = (empty(n, 2), empty(n), empty(n, 3), empty(n), empty(n, 3),
           empty(n, 2, dtype=i32), empty(n, 2, dtype=i32),
           empty(n, dtype=torch.bool), empty(n, dtype=torch.bool))
    if n == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    opt = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        err = lib.f3dgs_preprocess_forward(
            n, sh_degree, m_rows, means3d.data_ptr(), scales.data_ptr(),
            rotations.data_ptr(), shs.data_ptr(), opacities.data_ptr(),
            opt(ndc_offset), opt(active_mask), *_camera_args(cam),
            cam.width, cam.height, grid.grid_x, grid.grid_y, grid.tile_w,
            grid.tile_h, _f32(scale_modifier), INV_THREE, INV_ALPHA_MIN,
            *(x.data_ptr() for x in out), stream)
    raise_on(lib, "preprocess_forward", err)
    PREPROCESS_LAUNCHES += 1
    return out


def _cotangent(name, g, n, cols, dev):
    """(pointer, row stride, column stride) of a cotangent read in place at
    its strides; None reads zero."""
    if g is None:
        return None, 0, 0
    shape = (n, cols) if cols else (n,)
    if g.device != dev or g.dtype != torch.float32 or tuple(g.shape) != shape:
        raise ValueError(f"{name}: expected a float32 {shape} tensor on "
                         f"{dev}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    return g.data_ptr(), g.stride(0), (g.stride(1) if cols else 0)


def preprocess_backward_cuda(means3d, scales, rotations, shs, sh_degree: int,
                             scale_modifier, cam, valid, g_xy, g_depth,
                             g_conic, g_rgb, want_ndc_offset: bool = False):
    """One launch: the gradients of the forward's differentiable outputs
    (xy, depth, conic, rgb) with respect to means3d, scales, rotations, the
    SH stack and, if ``want_ndc_offset``, ndc_offset, with the signature of
    the plain version ``core/projection.py:preprocess_backward``. Takes the
    forward's inputs as ``preprocess_forward_cuda`` does, its ``valid`` [N]
    bool, and
    the cotangents g_xy [N,2], g_depth [N], g_conic [N,3], g_rgb [N,3]
    float32 on the same device at any strides (None = zero). Returns
    (g_means3d [N,3], g_scales [N,3], g_rotations [N,4], g_shs [N,M,3],
    g_ndc_offset [N,2] or None), each contiguous; rows that are not valid
    are exact zeros, and so are SH rows at and above (degree+1)^2."""
    global PREPROCESS_BWD_LAUNCHES
    dev, n, m_rows = _check_inputs(means3d, scales, rotations, shs, cam,
                                   sh_degree)
    check("valid", valid, torch.bool, (n,), dev)
    cots = [_cotangent(name, g, n, cols, dev) for name, g, cols in (
        ("g_xy", g_xy, 2), ("g_depth", g_depth, 0), ("g_conic", g_conic, 3),
        ("g_rgb", g_rgb, 3))]
    f32 = torch.float32
    g_means = torch.empty((n, 3), dtype=f32, device=dev)
    g_scales = torch.empty((n, 3), dtype=f32, device=dev)
    g_rots = torch.empty((n, 4), dtype=f32, device=dev)
    g_shs = torch.empty((n, m_rows, 3), dtype=f32, device=dev)
    g_ndc = (torch.empty((n, 2), dtype=f32, device=dev) if want_ndc_offset
             else None)
    if n == 0:
        return g_means, g_scales, g_rots, g_shs, g_ndc
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.f3dgs_preprocess_backward(
            n, sh_degree, m_rows, means3d.data_ptr(), scales.data_ptr(),
            rotations.data_ptr(), shs.data_ptr(), valid.data_ptr(),
            *_camera_args(cam), cam.width, cam.height, _f32(scale_modifier),
            *cots[0], *cots[1][:2], *cots[2], *cots[3], g_means.data_ptr(),
            g_scales.data_ptr(), g_rots.data_ptr(), g_shs.data_ptr(),
            None if g_ndc is None else g_ndc.data_ptr(), stream)
    raise_on(lib, "preprocess_backward", err)
    PREPROCESS_BWD_LAUNCHES += 1
    return g_means, g_scales, g_rots, g_shs, g_ndc
