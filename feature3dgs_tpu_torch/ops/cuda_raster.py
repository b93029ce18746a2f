"""Compositing on the card: the wrappers of ops/csrc/raster_forward.cu and
ops/csrc/raster_backward.cu.

The kernels replace ``feature3dgs_tpu/ops/pallas_raster.py:_fwd_kernel``
and ``_bwd_kernel``. ``ops.kernel_lib`` builds each source into its own
library with a plain C interface and opens it with the signatures of
``LIBRARIES``; the wrappers call it through ``ctypes`` on PyTorch's current
stream.

The launch plans live here as pure functions, so the CPU tests reach them:
``forward_plan`` (channel tiles a block accumulates in registers, channel
groups a tile, shared memory) and ``backward_plan`` (list entries staged per
pass over the cotangent rows, rows per ring stage, shared memory). Each
library exports the same shared-memory formula and the wrappers check that
the two agree.

``raster_forward_cuda`` and ``raster_backward_cuda`` launch their kernels on
CUDA tensors and raise on anything else; ``ops.rasterize`` runs the plain
versions (``ops.composite.composite_plain`` and
``composite_plain_backward``) for CPU tensors. ``alpha_matmul=True``
launches each kernel's alpha_matmul instantiation (the TPU kernels'
``alpha_mm`` mode; see ops/csrc/raster_common.cuh). ``FORWARD_LAUNCHES`` and
``BACKWARD_LAUNCHES`` count launches of the exact-mode kernels,
``FORWARD_MM_LAUNCHES`` and ``BACKWARD_MM_LAUNCHES`` those of the
alpha_matmul mode.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.ops.binning import TileGrid
from feature3dgs_tpu_torch.ops.composite import BackwardRows, CompositeOutput
from feature3dgs_tpu_torch.ops.kernel_lib import (check, check_aligned, load,
                                                  raise_on)

# list entries the kernels stage per step (CHUNK in the .cu sources)
KERNEL_CHUNK = 32
# launches of each kernel since import (or since a caller reset them)
FORWARD_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
FORWARD_MM_LAUNCHES = 0
BACKWARD_MM_LAUNCHES = 0
# the largest dynamic shared memory a Hopper block may use
MAX_SMEM_BYTES = 232448


class ForwardPlan(NamedTuple):
    channel_tiles: int   # 8-channel mma tiles a warp accumulates (NT)
    halves: int          # threads a pixel: 2 share one walk, 8 NT channels each
    groups: int          # channel groups of 8 * NT * halves a tile
    splits: int          # pixel splits a tile: groups * splits blocks a tile
    threads: int         # threads a block: halves x its pixels, whole warps
    smem_bytes: int


class BackwardPlan(NamedTuple):
    entries: int         # list entries whose weights are staged per pass
    ring_rows: int       # cotangent rows per stage of the cp.async ring
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


FORWARD_MAX_THREADS = 256


def forward_smem_bytes(threads: int, channel_tiles: int, halves: int,
                       alpha_matmul: bool) -> int:
    """Dynamic shared memory of a forward block of ``threads`` threads,
    ``halves`` a pixel (smem_bytes in raster_forward.cu): two stages of 32
    feature rows, the chunk's weights, two stages of splat scalars and ids,
    and what two threads of a pixel pass each other."""
    channels = 8 * channel_tiles * halves
    feat_stride = _round_up(channels, 32) + 8 if channels else 0
    geom_rows = 16 if alpha_matmul else 10
    pixels = threads // halves
    return 4 * (2 * KERNEL_CHUNK * feat_stride + KERNEL_CHUNK * (pixels + 8)
                + 2 * geom_rows * KERNEL_CHUNK + 2 * KERNEL_CHUNK
                + (pixels + 16 if halves == 2 else 0))


def forward_plan(p: int, f_dim: int, alpha_matmul: bool = False) -> ForwardPlan:
    """How the forward kernel splits a tile over blocks of at most 256
    threads. A warp keeps 8 * NT channels of its 32 pixels in registers for
    the whole list (NT = 1, 2, 4 or 8 by F). Up to 64 channels a block has
    one thread a pixel (up to 256 pixels); above, two threads a pixel in
    separate warps share the pixel's walk and hold 64 channels each, so a
    block owns up to 128 pixels x 128 channels and ceil(P / 128) pixel
    splits x ceil(F / 128) channel groups share a tile. F = 0 launches the
    walk alone."""
    if p <= 0 or p > 1024:
        raise ValueError(f"tile of {p} pixels: the kernel takes 1..1024")
    halves = 2 if f_dim > 64 else 1
    pixels = min(_round_up(p, 32), FORWARD_MAX_THREADS // halves)
    nt = 0
    if f_dim > 0:
        nt = 1
        while nt < 8 and 8 * nt < f_dim:
            nt *= 2
    groups = -(-f_dim // (8 * nt * halves)) if nt else 1
    threads = pixels * halves
    return ForwardPlan(nt, halves, groups, -(-p // pixels), threads,
                       forward_smem_bytes(threads, nt, halves, alpha_matmul))


def backward_smem_bytes(p: int, f_dim: int, alpha_matmul: bool, entries: int,
                        ring_rows: int) -> int:
    """Dynamic shared memory of a backward block (smem_bytes in
    raster_backward.cu): the three-stage ring of cotangent rows
    [g_feat | g_color | g_depth], the staged weights, the warps' partial
    sums, the staged splat scalars, ids and the warps' maxima."""
    g_stride = 8 * (-(-(f_dim + 4) // 8))
    g_stride += (8 - g_stride % 32) % 32
    geom_rows, part_cols = (18, 7) if alpha_matmul else (10, 6)
    return 4 * (3 * ring_rows * g_stride + entries * (p + 4)
                + (p // 32) * KERNEL_CHUNK * part_cols
                + (entries // KERNEL_CHUNK) * geom_rows * KERNEL_CHUNK
                + entries + 32)


def backward_plan(p: int, f_dim: int, alpha_matmul: bool = False
                  ) -> BackwardPlan:
    """How much the backward kernel stages: the weights of 64 list entries
    (two 32-entry walks) where shared memory allows, else 32, and the
    largest ring stage of 32, 16 or 8 cotangent rows that still fits. More
    staged entries come first: they halve the passes over the cotangents."""
    if p <= 0 or p > 1024 or p % 32:
        raise ValueError(f"tile of {p} pixels: the backward kernel needs a "
                         "multiple of 32 pixels, at most 1024")
    for entries in (64, 32):
        if entries > p:
            continue
        for ring_rows in (32, 16, 8):
            smem = backward_smem_bytes(p, f_dim, alpha_matmul, entries,
                                       ring_rows)
            if smem <= MAX_SMEM_BYTES:
                return BackwardPlan(entries, ring_rows, smem)
    raise ValueError(f"raster_backward: {f_dim} feature channels at {p}-pixel "
                     f"tiles need {smem} bytes of shared memory "
                     f"(> {MAX_SMEM_BYTES})")


_p, _i = ctypes.c_void_p, ctypes.c_int


def _tables(name: str, entry: list, n_plan: int) -> tuple:
    """(signatures, constants) of library ``name``: its launch ``entry``,
    its chunk, its shared-memory formula and its attributes query, each
    taking the ``n_plan`` ints of the launch plan."""
    return ({f"f3dgs_{name}": (entry, _i),
             f"f3dgs_{name}_chunk": ([], _i),
             f"f3dgs_{name}_smem_bytes": ([_i] * n_plan, ctypes.c_size_t),
             f"f3dgs_{name}_attributes": (
                 [_i] * n_plan + [ctypes.POINTER(_i)], _i)},
            {f"f3dgs_{name}_chunk": KERNEL_CHUNK})


# {library: (signatures, constants)}, as ops.kernel_lib.load takes them
LIBRARIES = {
    "raster_forward": _tables("raster_forward",
                              [_p] * 9 + [_i] * 12 + [_p] * 6, 4),
    "raster_backward": _tables("raster_backward",
                               [_p] * 15 + [_i] * 12 + [_p] * 3, 5)}


def _library(name: str):
    return load(name, *LIBRARIES[name])


def check_tile_lists(gid_sorted: torch.Tensor, tile_starts: torch.Tensor,
                     tile_counts: torch.Tensor, n_gauss: int):
    """Raise unless every tile's list ``[start, start + count)`` lies in
    ``gid_sorted`` and every id in it names one of ``n_gauss`` Gaussians.
    The kernel trusts these ranges; one host sync reads the verdict."""
    n_inst = gid_sorted.shape[0]
    # start > n_inst - count, not start + count > n_inst: no int32 overflow
    bad = ((tile_starts < 0) | (tile_counts < 0)
           | (tile_starts > n_inst - tile_counts)).any()
    if n_inst:
        lo, hi = torch.aminmax(gid_sorted)
        bad = bad | (lo < 0) | (hi >= n_gauss)
    tracing.count("host_wait.check_tile_lists")
    if bool(bad):
        raise ValueError(
            "tile lists out of range: each [tile_start, tile_start + "
            f"tile_count) must lie in the {gid_sorted.shape[0]} entries of "
            f"gid_sorted, and each id in [0, {n_gauss})")


def check_tile_partition(tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                         n_inst: int):
    """Raise unless the tiles' lists, in tile order, cover the ``n_inst``
    entries of gid_sorted exactly once (as ``ops.binning`` lays them out):
    the backward kernel writes one row per list entry and no other."""
    counts = tile_counts.long()
    bad = (tile_starts.long() != torch.cumsum(counts, 0) - counts).any()
    tracing.count("host_wait.check_tile_partition")
    if bool(bad | (counts.sum() != n_inst)):
        raise ValueError("tile lists must cover the entries of gid_sorted in "
                         "order, each exactly once")


def _check_splats(xy, conic, opacity, rgb, depth, feat, gid_sorted,
                  tile_starts, tile_counts, grid: TileGrid, *,
                  tile_base: int = 0, n_per_camera: int = 0):
    """Device, dtype, shape and contiguity of the splat inputs both kernels
    take; returns (device, N, F, T, P). With ``n_per_camera`` = N > 0 the
    per-camera inputs hold B * N rows and the tiles must lie in the B
    cameras' grids."""
    dev = xy.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    rows = xy.shape[0]
    n = n_per_camera or rows
    f_dim = feat.shape[-1] if feat.dim() == 2 else -1
    n_tiles = tile_starts.shape[0]
    if n_per_camera < 0 or rows % max(n, 1) or (
            n_per_camera and tile_base + n_tiles
            > rows // n_per_camera * grid.num_tiles):
        raise ValueError(
            f"{rows} rows of per-camera inputs do not cover tiles "
            f"{tile_base}..{tile_base + n_tiles} at {n_per_camera} Gaussians "
            f"a camera and {grid.num_tiles} tiles a camera")
    f32, i32 = torch.float32, torch.int32
    check("xy", xy, f32, (rows, 2), dev)
    check("conic", conic, f32, (rows, 3), dev)
    check("opacity", opacity, f32, (rows,), dev)
    check("rgb", rgb, f32, (rows, 3), dev)
    check("depth", depth, f32, (rows,), dev)
    check("feat", feat, f32, (n, f_dim), dev)
    check("gid_sorted", gid_sorted, i32, (gid_sorted.shape[0],), dev)
    check("tile_starts", tile_starts, i32, (n_tiles,), dev)
    check("tile_counts", tile_counts, i32, (n_tiles,), dev)
    return dev, n, f_dim, n_tiles, grid.pixels_per_tile


def _check_smem(lib, name: str, planned: int, *shape):
    """The library's own shared-memory formula must give the plan's bytes."""
    smem = getattr(lib, f"f3dgs_{name}_smem_bytes")(*shape)
    if smem != planned:
        raise RuntimeError(f"{name}: the plan reckons {planned} bytes of "
                           f"shared memory, the kernel {smem}")


def kernel_attributes(name: str, p: int, f_dim: int,
                      alpha_matmul: bool = False) -> dict:
    """Registers and local-memory (spill) bytes a thread, and resident blocks
    an SM, of the instantiation of kernel ``name`` ("raster_forward" or
    "raster_backward") that these shapes launch, with its plan."""
    lib = _library(name)
    if name == "raster_forward":
        plan = forward_plan(p, f_dim, alpha_matmul)
        shape = (plan.threads, plan.channel_tiles, plan.halves,
                 int(alpha_matmul))
    else:
        plan = backward_plan(p, f_dim, alpha_matmul)
        shape = (p, f_dim, int(alpha_matmul), plan.entries, plan.ring_rows)
    out = (ctypes.c_int * 3)()
    raise_on(lib, name, getattr(lib, f"f3dgs_{name}_attributes")(*shape, out))
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2], **plan._asdict()}


def raster_forward_cuda(xy, conic, opacity, rgb, depth, feat, gid_sorted,
                        tile_starts, tile_counts, grid: TileGrid, *,
                        tile_base: int = 0, n_per_camera: int = 0,
                        alpha_matmul: bool = False) -> CompositeOutput:
    """Composite every tile with the forward kernel. Per-Gaussian inputs
    xy [N,2], conic [N,3], opacity [N], rgb [N,3], depth [N], feat [N,F]
    f32; gid_sorted [L], tile_starts/tile_counts [T] int32, all contiguous
    CUDA tensors (anything else raises). Outputs are in tile layout
    ([T, P, ...]); tile t is global tile ``tile_base + t``.
    ``alpha_matmul`` launches the kernel's alpha_matmul mode (power as a
    six-term dot in tile-local coordinates).

    ``n_per_camera`` = N > 0: one launch over B cameras' stacked tile grids
    (``ops.binning.bin_gaussians_batch``); tile g belongs to camera
    g // grid.num_tiles, xy, conic, opacity, rgb and depth are [B*N, ...]
    and read at row b * N + id, and feat [N,F] is shared by all cameras
    (never copied per camera). The kernel addresses its outputs with 64-bit
    offsets and its input rows with 64-bit ones, so no batch size is
    refused for the size of its outputs; the check below holds only what
    stays int: the list's length, the tile index and the block count."""
    global FORWARD_LAUNCHES, FORWARD_MM_LAUNCHES
    dev, n, f_dim, n_tiles, p = _check_splats(
        xy, conic, opacity, rgb, depth, feat, gid_sorted, tile_starts,
        tile_counts, grid, tile_base=tile_base, n_per_camera=n_per_camera)
    plan = forward_plan(p, f_dim, alpha_matmul)
    check_aligned("feat", feat)
    lib = _library("raster_forward")
    _check_smem(lib, "raster_forward", plan.smem_bytes, plan.threads,
                plan.channel_tiles, plan.halves, int(alpha_matmul))
    if max(gid_sorted.shape[0], tile_base + n_tiles,
           n_tiles * plan.groups * plan.splits) >= 2 ** 31:
        raise ValueError("sizes exceed the kernel's 32-bit indexing")
    check_tile_lists(gid_sorted, tile_starts, tile_counts, n)

    f32 = torch.float32
    color = torch.empty((n_tiles, p, 3), dtype=f32, device=dev)
    feature = torch.empty((n_tiles, p, f_dim), dtype=f32, device=dev)
    depth_out = torch.empty((n_tiles, p), dtype=f32, device=dev)
    final_t = torch.empty((n_tiles, p), dtype=f32, device=dev)
    n_contrib = torch.empty((n_tiles, p), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.f3dgs_raster_forward(
            xy.data_ptr(), conic.data_ptr(), opacity.data_ptr(),
            rgb.data_ptr(), depth.data_ptr(), feat.data_ptr(),
            gid_sorted.data_ptr(), tile_starts.data_ptr(),
            tile_counts.data_ptr(), n_tiles, tile_base, n_per_camera,
            grid.grid_x, grid.grid_y, grid.tile_w, grid.tile_h, f_dim,
            plan.channel_tiles, plan.halves, plan.threads, int(alpha_matmul),
            color.data_ptr(),
            feature.data_ptr(), depth_out.data_ptr(), final_t.data_ptr(),
            n_contrib.data_ptr(), stream)
    raise_on(lib, "raster_forward", err)
    if n_tiles and alpha_matmul:
        FORWARD_MM_LAUNCHES += 1
    elif n_tiles:
        FORWARD_LAUNCHES += 1
    return CompositeOutput(color, feature, depth_out, final_t, n_contrib)


def raster_backward_cuda(xy, conic, opacity, rgb, depth, feat, gid_sorted,
                         tile_starts, tile_counts, grid: TileGrid, g_color,
                         g_feat, g_depth, g_final_t, final_t, n_contrib, *,
                         tile_base: int = 0, n_per_camera: int = 0,
                         feature_alpha_grad: bool = False,
                         alpha_matmul: bool = False,
                         check_lists: bool = True,
                         out: BackwardRows | None = None) -> BackwardRows:
    """Per-entry gradient rows of the forward compositing, from the backward
    kernel. Takes the forward's inputs, the pixel cotangents g_color
    [T,P,3], g_feat [T,P,F], g_depth [T,P], g_final_t [T,P] and the
    forward's final_t [T,P] f32 and n_contrib [T,P] int32, all contiguous
    CUDA tensors (anything else raises). Returns rows in gid_sorted order:
    geom [L,10] (x, y, conic a, b, c, opacity, r, g, b, depth) and feature
    [L,F]. The tiles' lists must cover gid_sorted exactly once, in order
    (``ops.binning``'s layout); ``check_lists`` verifies that and the ranges
    with one host sync, and the autograd path skips it because its forward
    checked the same lists. ``alpha_matmul`` must be the mode of the forward
    that made ``final_t`` and ``n_contrib``. ``out`` takes preallocated rows (the smoke
    check fills them with NaN to show that every row is written).

    ``tile_base`` and ``n_per_camera`` mean what they mean to
    ``raster_forward_cuda``: tile t is global tile ``tile_base + t``, and
    with ``n_per_camera`` = N > 0 the splat inputs are [B*N] stacks read at
    row b * N + id while feat [N,F] is shared. Everything else is indexed by
    the tiles and lists the call is given: a slice of the grid passes its
    own sub-range of gid_sorted with rebased starts (so the lists still
    cover it exactly once) and its own rows of the cotangents and saved
    state. The rows of a slice, or of one camera of a batch, are bit-equal
    to those of that camera's full launch."""
    global BACKWARD_LAUNCHES, BACKWARD_MM_LAUNCHES
    dev, n, f_dim, n_tiles, p = _check_splats(
        xy, conic, opacity, rgb, depth, feat, gid_sorted, tile_starts,
        tile_counts, grid, tile_base=tile_base, n_per_camera=n_per_camera)
    f32 = torch.float32
    check("g_color", g_color, f32, (n_tiles, p, 3), dev)
    check("g_feat", g_feat, f32, (n_tiles, p, f_dim), dev)
    for name, x in (("g_depth", g_depth), ("g_final_t", g_final_t),
                    ("final_t", final_t)):
        check(name, x, f32, (n_tiles, p), dev)
    check("n_contrib", n_contrib, torch.int32, (n_tiles, p), dev)
    plan = backward_plan(p, f_dim, alpha_matmul)
    check_aligned("g_feat", g_feat)
    n_inst = gid_sorted.shape[0]
    # row and pixel offsets are 64-bit in the kernel; what stays int is the
    # list's length and the tile index
    if max(n_inst, tile_base + n_tiles) >= 2 ** 31:
        raise ValueError("sizes exceed the kernel's 32-bit indexing")
    lib = _library("raster_backward")
    _check_smem(lib, "raster_backward", plan.smem_bytes, p, f_dim,
                int(alpha_matmul), plan.entries, plan.ring_rows)
    if check_lists:
        check_tile_lists(gid_sorted, tile_starts, tile_counts, n)
        check_tile_partition(tile_starts, tile_counts, n_inst)
    if out is None:
        out = BackwardRows(torch.empty((n_inst, 10), dtype=f32, device=dev),
                           torch.empty((n_inst, f_dim), dtype=f32, device=dev))
    check("out.geom", out.geom, f32, (n_inst, 10), dev)
    check("out.feature", out.feature, f32, (n_inst, f_dim), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.f3dgs_raster_backward(
            xy.data_ptr(), conic.data_ptr(), opacity.data_ptr(),
            rgb.data_ptr(), depth.data_ptr(), feat.data_ptr(),
            gid_sorted.data_ptr(), tile_starts.data_ptr(),
            tile_counts.data_ptr(), g_color.data_ptr(), g_feat.data_ptr(),
            g_depth.data_ptr(), g_final_t.data_ptr(), final_t.data_ptr(),
            n_contrib.data_ptr(), n_tiles, tile_base, n_per_camera,
            grid.grid_x, grid.grid_y, grid.tile_w, grid.tile_h, f_dim,
            int(feature_alpha_grad), int(alpha_matmul),
            plan.entries, plan.ring_rows, out.geom.data_ptr(),
            out.feature.data_ptr(), stream)
    raise_on(lib, "raster_backward", err)
    if n_tiles and alpha_matmul:
        BACKWARD_MM_LAUNCHES += 1
    elif n_tiles:
        BACKWARD_LAUNCHES += 1
    return out
