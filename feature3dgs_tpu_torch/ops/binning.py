"""Tile binning: (Gaussian, tile) instance expansion and the (tile, depth)
sort, as plain PyTorch.

Port of ``feature3dgs_tpu/ops/binning.py``. The per-tile lists are the same
members in the same stable (tile, depth) order as the JAX package's: one
stable ``torch.sort`` on the int64 key ``tile << 32 | float_bits(depth)``
does it, because valid depths are > 0.2, where the float bits are monotone
(the original radix-sort key, rasterizer_impl.cu:104). Capacity overflow
drops whole Gaussians, highest index first, as in the JAX package.

The JAX package's per-tile 8-row filler entries and multiple-of-128 slab
capacity exist for TPU DMA alignment; the port has neither, so its
``tile_starts`` differ from JAX's while the lists and counts agree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TileGrid(NamedTuple):
    """Tile-grid geometry for an image."""

    width: int
    height: int
    tile_w: int
    tile_h: int

    @property
    def grid_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def grid_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_w * self.tile_h


class BinningResult(NamedTuple):
    gid_sorted: torch.Tensor   # [L] int32 Gaussian ids in (tile, depth) order
    tile_starts: torch.Tensor  # [T] int32 offsets into gid_sorted
    tile_counts: torch.Tensor  # [T] int32 list lengths (after the capacity cap)
    total: torch.Tensor        # scalar int64: instances before the cap
    num_tiles_touched: torch.Tensor  # [N] int32 per-Gaussian rect area


def expand_instances(rect_min: torch.Tensor, rect_max: torch.Tensor,
                     valid: torch.Tensor, grid: TileGrid, *,
                     instance_capacity: int):
    """One (Gaussian, tile) instance per tile of each valid Gaussian's rect,
    Gaussian-major and row-major within the rect (``duplicateWithKeys``).

    Returns (gid [L] int64, tile [L] int64, areas [N] int64, total scalar).
    Gaussians whose instances would end beyond ``instance_capacity`` are
    dropped whole; ``total`` counts instances before that cap."""
    widths = (rect_max[:, 0] - rect_min[:, 0]).long()
    heights = (rect_max[:, 1] - rect_min[:, 1]).long()
    areas = torch.where(valid, widths * heights, torch.zeros_like(widths))
    incl = torch.cumsum(areas, 0)
    total = incl[-1] if incl.numel() else areas.sum()
    # incl is monotone, so the Gaussians that fit are a prefix
    kept = torch.where(incl <= instance_capacity, areas,
                       torch.zeros_like(areas))
    n = areas.shape[0]
    gid = torch.repeat_interleave(
        torch.arange(n, device=areas.device), kept)
    local = (torch.arange(gid.shape[0], device=areas.device)
             - (incl - areas)[gid])
    w_g = widths[gid]
    ty = rect_min[gid, 1].long() + local // w_g
    tx = rect_min[gid, 0].long() + local % w_g
    tile = ty * grid.grid_x + tx
    return gid, tile, areas, total


def bin_gaussians(rect_min: torch.Tensor, rect_max: torch.Tensor,
                  depth: torch.Tensor, valid: torch.Tensor, grid: TileGrid, *,
                  instance_capacity: int) -> BinningResult:
    """Depth-sorted per-tile Gaussian lists in one flat array.

    rect_min/rect_max: [N,2] int32 tile rectangles (max exclusive) from
    core.projection.tile_rect; depth: [N] view-space z (> 0.2 where valid);
    valid: [N] bool."""
    gid, tile, areas, total = expand_instances(
        rect_min, rect_max, valid, grid, instance_capacity=instance_capacity)
    depth_bits = depth.to(torch.float32).view(torch.int32).long()[gid]
    key = (tile << 32) | depth_bits
    _, order = torch.sort(key, stable=True)
    gid_sorted = gid[order].to(torch.int32)
    counts = torch.bincount(tile, minlength=grid.num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    return BinningResult(
        gid_sorted=gid_sorted,
        tile_starts=starts.to(torch.int32),
        tile_counts=counts.to(torch.int32),
        total=total,
        num_tiles_touched=areas.to(torch.int32))

