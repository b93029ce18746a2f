"""Training losses and the feature resize, in PyTorch.

Port of ``feature3dgs_tpu/train/losses.py`` (the original
utils/loss_utils.py:17-75 and train.py:98-105): L1/L2, PSNR, the 11-tap
Gaussian-window SSIM with zero padding, ``rgb_loss`` and the
align_corners=True bilinear resize that matches rendered feature maps to
the teacher map. Images are HWC, as in the JAX package. No Pallas kernel is
involved: the blur is a depthwise ``F.conv2d`` (full f32: the package turns
cuDNN's TF32 off) and the resize of an image is ``F.interpolate``. The
step's resize of the rasterizer's tile layout, ``resize_bilinear_from_tiles``,
is one CUDA kernel each way on the card (ops/cuda_resize.py) and
``tiles_to_image`` + ``F.interpolate`` on the CPU;
``resize_bilinear_from_tile_rows``, the tile-sharded step's partial resize,
applies the two-tap operator by gathers.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.ops.cuda_resize import (resize_backward_cuda,
                                                   resize_forward_cuda)
from feature3dgs_tpu_torch.ops.rasterize import tiles_to_image


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over flattened pixels (utils/image_utils.py:23-25)."""
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


@functools.lru_cache(maxsize=8)
def _gaussian_taps(window_size: int, sigma: float) -> np.ndarray:
    """Per-tap f32 weights, normalised in f64 as the JAX package's
    ``_gaussian_taps``."""
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Zero-padded separable Gaussian blur of [C, H, W], rows then columns,
    as depthwise convolutions."""
    c = x.shape[0]
    half = window_size // 2
    tracing.count("host_wait.ssim_taps")
    taps = torch.from_numpy(_gaussian_taps(window_size, sigma)).to(x.device)
    ky = taps.view(1, 1, window_size, 1).expand(c, 1, window_size, 1)
    kx = taps.view(1, 1, 1, window_size).expand(c, 1, 1, window_size)
    y = F.conv2d(x[None], ky, padding=(half, 0), groups=c)
    return F.conv2d(y, kx, padding=(0, half), groups=c)[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an HWC image pair (loss_utils.py:33-63). The five
    blurred maps go through one pair of depthwise convolutions."""
    a = img1.permute(2, 0, 1)
    b = img2.permute(2, 0, 1)
    c = a.shape[0]
    blurred = _blur(torch.cat([a, b, a * a, b * b, a * b], 0), window_size,
                    sigma)
    mu1, mu2, e11, e22, e12 = torch.split(blurred, c, 0)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = e11 - mu1_sq
    s2 = e22 - mu2_sq
    s12 = e12 - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = (((2 * mu12 + c1) * (2 * s12 + c2))
         / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return torch.mean(m)


@tracing.spanned("loss.rgb")
def rgb_loss(image: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2):
    """(1-λ)·L1 + λ·(1-SSIM) (train.py:105). Returns (loss, l1)."""
    ll1 = l1_loss(image, gt)
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt))
    return loss, ll1


def resize_bilinear_align_corners(img: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """HWC bilinear resize with align_corners=True (the original
    train.py:101 ``F.interpolate``), as
    ``feature3dgs_tpu/train/losses.py:resize_bilinear_align_corners``."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    chw = img.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(out_h, out_w), mode="bilinear",
                        align_corners=True)
    return out[0].permute(1, 2, 0)


class _ResizeFromTiles(torch.autograd.Function):
    """The tile-layout resize on the card: one forward launch reads the
    taps straight from the tiles, one backward launch writes the tiles'
    gradient in tile layout, every element (ops/csrc/resize.cu). Nothing
    is saved for the backward but the shapes."""

    @staticmethod
    def forward(ctx, tiles, grid, out_h, out_w):
        ctx.grid, ctx.out_hw = grid, (out_h, out_w)
        return resize_forward_cuda(tiles, grid, out_h, out_w)

    @staticmethod
    def backward(ctx, g_out):
        with tracing.span("loss.resize_backward"):
            g_tiles = resize_backward_cuda(g_out.contiguous(), ctx.grid,
                                           *ctx.out_hw)
        return g_tiles, None, None, None


def resize_bilinear_from_tiles(tiles: torch.Tensor, grid, out_h: int,
                               out_w: int) -> torch.Tensor:
    """align_corners bilinear resize of the rasterizer's tile layout
    [num_tiles, pixels_per_tile, C] to [out_h, out_w, C]. A CUDA tensor
    goes through ``_ResizeFromTiles`` (the kernels, which never assemble
    the image); a CPU tensor, and the same-size case (no resize), through
    ``tiles_to_image`` + ``resize_bilinear_align_corners``. Counters
    ``loss.resize_fused`` and ``loss.resize_plain`` count the views each
    path served."""
    if tiles.device.type == "cuda" and (grid.height, grid.width) != (
            out_h, out_w):
        tracing.count("loss.resize_fused")
        return _ResizeFromTiles.apply(tiles, grid, out_h, out_w)
    tracing.count("loss.resize_plain")
    return resize_bilinear_align_corners(tiles_to_image(tiles, grid), out_h,
                                         out_w)


@functools.lru_cache(maxsize=32)
def _interp_taps(n_in: int, n_out: int) -> tuple:
    """The align_corners=True operator of one axis as two taps an output:
    (lo, hi, w_lo, w_hi) numpy arrays, the weights rounded as the JAX
    package's ``_interp_matrix`` rounds them (positions in float64, the
    fraction in float32)."""
    if n_out == 1:
        zero = np.zeros(1, np.int64)
        return zero, zero, np.ones(1, np.float32), np.zeros(1, np.float32)
    ys = np.arange(n_out, dtype=np.float64) * ((n_in - 1) / (n_out - 1))
    lo = np.clip(np.floor(ys).astype(np.int64), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (ys - lo).astype(np.float32)
    return lo, hi, np.float32(1.0) - w, w


@functools.lru_cache(maxsize=64)
def _taps_in(n_in: int, n_out: int, o0: int, o1: int, first: int, end: int,
             device):
    """Index and weight tensors, on ``device``, of output rows [o0, o1) of
    the operator: the taps that read source rows [first, end), the others
    with weight 0 (and a clamped index). Cached: a step uploads nothing."""
    lo, hi, w_lo, w_hi = (x[o0:o1] for x in _interp_taps(n_in, n_out))
    n = max(end - first, 1)
    tracing.count("host_wait.resize_taps", 4)
    out = []
    for idx, w in ((lo, w_lo), (hi, w_hi)):
        inside = (idx >= first) & (idx < end)
        out.append(torch.from_numpy(np.clip(idx - first, 0, n - 1)).to(device))
        out.append(torch.from_numpy(np.where(inside, w, np.float32(0))).to(
            device))
    return out


def resize_bilinear_from_tile_rows(tiles_local: torch.Tensor, grid,
                                   out_h: int, out_w: int, row0: int,
                                   rows_loc: int, gy_pad: int) -> torch.Tensor:
    """Partial align_corners resize from a block of tile rows (port of
    ``feature3dgs_tpu/train/losses.py:resize_bilinear_from_tile_rows``).

    ``tiles_local`` [rows_loc * grid_x, P, C] holds tile rows
    [row0, row0 + rows_loc) of a tile grid padded to ``gy_pad`` rows (pad
    rows carry zero weight). Returns this block's additive share of the
    [out_h, out_w, C] map: summed over the blocks of a tile grid (the tile
    axis of a mesh), it is ``resize_bilinear_from_tiles`` of the whole grid
    up to float rounding. Only the output rows that read a pixel row of the
    block are computed, so the work shards with the tiles."""
    gx, th, tw = grid.grid_x, grid.tile_h, grid.tile_w
    c = tiles_local.shape[-1]
    if not 0 <= row0 <= row0 + rows_loc <= gy_pad:
        raise ValueError(f"tile rows {row0}..{row0 + rows_loc} outside a "
                         f"grid of {gy_pad}")
    y0 = row0 * th
    y1 = max(min((row0 + rows_loc) * th, grid.height), y0)
    block = tiles_local.reshape(rows_loc, gx, th, tw, c).permute(
        0, 2, 1, 3, 4).reshape(rows_loc * th, gx * tw, c)[: y1 - y0,
                                                        : grid.width]
    taps_y = _interp_taps(grid.height, out_h)
    lo, hi = taps_y[0], taps_y[1]
    reads = np.nonzero(((lo >= y0) & (lo < y1)) | ((hi >= y0) & (hi < y1)))[0]
    o0, o1 = (int(reads[0]), int(reads[-1]) + 1) if reads.size else (0, 0)
    i_lo, w_lo, i_hi, w_hi = _taps_in(grid.height, out_h, o0, o1, y0, y1,
                                      tiles_local.device)
    rows = (block.index_select(0, i_lo) * w_lo[:, None, None]
            + block.index_select(0, i_hi) * w_hi[:, None, None])
    x_lo, xw_lo, x_hi, xw_hi = _taps_in(grid.width, out_w, 0, out_w, 0,
                                        grid.width, tiles_local.device)
    out = (rows.index_select(1, x_lo) * xw_lo[None, :, None]
           + rows.index_select(1, x_hi) * xw_hi[None, :, None])
    return F.pad(out, (0, 0, 0, 0, o0, out_h - o1))
