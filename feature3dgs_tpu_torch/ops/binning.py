"""Tile binning: (Gaussian, tile) instance expansion and the (tile, depth)
sort, as plain PyTorch.

Port of ``feature3dgs_tpu/ops/binning.py``. The per-tile lists are the same
members in the same stable (tile, depth) order as the JAX package's: one
stable ``torch.sort`` on the int64 key ``tile << 32 | float_bits(depth)``
does it, because valid depths are > 0.2, where the float bits are monotone
(the original radix-sort key, rasterizer_impl.cu:104). Capacity overflow
drops whole Gaussians, highest index first, as in the JAX package. Several
cameras bin in one sort (``bin_gaussians_batch``: the tile key gains the
camera, ``b * T + tile``), with the capacity applied per camera as the JAX
package's vmap of ``bin_gaussians`` does (rasterize.py:364-369).
``sort_instances`` sorts the triples the instance exchange
(``parallel.sharded``) delivers to a tile owner.

The JAX package's per-tile 8-row filler entries and multiple-of-128 slab
capacity exist for TPU DMA alignment; the port has neither, so its
``tile_starts`` differ from JAX's while the lists and counts agree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from feature3dgs_tpu_torch import tracing


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
    tile_starts: torch.Tensor  # [T] ([B*T]) int32 offsets into gid_sorted
    tile_counts: torch.Tensor  # [T] ([B*T]) int32 list lengths (after the cap)
    total: torch.Tensor        # int64 instances before the cap: scalar, [B] batched
    num_tiles_touched: torch.Tensor  # [N] ([B,N]) int32 per-Gaussian rect area


def expand_instances(rect_min: torch.Tensor, rect_max: torch.Tensor,
                     valid: torch.Tensor, grid: TileGrid, *,
                     instance_capacity: int):
    """One (Gaussian, tile) instance per tile of each valid Gaussian's rect,
    for B cameras at once: camera-major, then Gaussian-major and row-major
    within the rect (``duplicateWithKeys``).

    rect_min/rect_max [B,N,2], valid [B,N]. Returns (row [L] int64 = b * N
    + Gaussian id, tile [L] int64 = b * T + the camera's tile, areas [B,N]
    int64, total [B]). The capacity is each camera's own: a camera keeps
    the prefix of its Gaussians whose instances fit in ``instance_capacity``
    and drops the rest whole; ``total`` counts instances before that cap."""
    n = valid.shape[1]
    widths = (rect_max[..., 0] - rect_min[..., 0]).long()
    heights = (rect_max[..., 1] - rect_min[..., 1]).long()
    areas = torch.where(valid, widths * heights, torch.zeros_like(widths))
    incl = torch.cumsum(areas, 1)
    total = incl[:, -1] if n else areas.sum(1)
    # incl is monotone, so the Gaussians that fit are a prefix per camera
    kept = torch.where(incl <= instance_capacity, areas,
                       torch.zeros_like(areas)).reshape(-1)
    # the output's length and the repeats' sign are read from the card
    tracing.count("host_wait.expand_instances", 2)
    row = torch.repeat_interleave(
        torch.arange(kept.shape[0], device=areas.device), kept)
    local = (torch.arange(row.shape[0], device=areas.device)
             - (torch.cumsum(kept, 0) - kept)[row])
    w_g = widths.reshape(-1)[row]
    rmin = rect_min.reshape(-1, 2)
    ty = rmin[row, 1].long() + local // w_g
    tx = rmin[row, 0].long() + local % w_g
    tile = (row // max(n, 1)) * grid.num_tiles + ty * grid.grid_x + tx
    return row, tile, areas, total


@tracing.spanned("raster.binning")
def bin_gaussians_batch(rect_min: torch.Tensor, rect_max: torch.Tensor,
                        depth: torch.Tensor, valid: torch.Tensor,
                        grid: TileGrid, *,
                        instance_capacity: int) -> BinningResult:
    """Depth-sorted per-tile lists of B cameras in one flat array.

    rect_min/rect_max [B,N,2] int32 tile rectangles, depth [B,N], valid
    [B,N]. One stable sort on ``(b * T + tile) << 32 | depth_bits`` makes
    one camera-major list over B * T tiles: ``tile_starts``/``tile_counts``
    are [B * T], ``total`` and ``num_tiles_touched`` per camera ([B],
    [B,N]); the ids in ``gid_sorted`` stay per-camera ids in [0, N). Each
    tile's list is, entry for entry, the one ``bin_gaussians`` gives for
    that camera alone: a camera's instances keep their own order, and the
    stable sort keeps it among equal keys."""
    b, n = valid.shape
    row, tile, areas, total = expand_instances(
        rect_min, rect_max, valid, grid, instance_capacity=instance_capacity)
    depth_bits = depth.to(torch.float32).view(torch.int32).long().reshape(-1)
    key = (tile << 32) | depth_bits[row]
    _, order = torch.sort(key, stable=True)
    gid_sorted = (row[order] % max(n, 1)).to(torch.int32)
    # bincount reads the ids' least and greatest from the card
    tracing.count("host_wait.bincount", 2)
    counts = torch.bincount(tile, minlength=b * grid.num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    return BinningResult(
        gid_sorted=gid_sorted,
        tile_starts=starts.to(torch.int32),
        tile_counts=counts.to(torch.int32),
        total=total,
        num_tiles_touched=areas.to(torch.int32))


def bin_gaussians(rect_min: torch.Tensor, rect_max: torch.Tensor,
                  depth: torch.Tensor, valid: torch.Tensor, grid: TileGrid, *,
                  instance_capacity: int) -> BinningResult:
    """Depth-sorted per-tile Gaussian lists of one camera in one flat array
    (``bin_gaussians_batch`` at B = 1).

    rect_min/rect_max: [N,2] int32 tile rectangles (max exclusive) from
    core.projection.tile_rect; depth: [N] view-space z (> 0.2 where valid);
    valid: [N] bool."""
    bins = bin_gaussians_batch(rect_min[None], rect_max[None], depth[None],
                               valid[None], grid,
                               instance_capacity=instance_capacity)
    return bins._replace(total=bins.total[0],
                         num_tiles_touched=bins.num_tiles_touched[0])


def sort_instances(tile_key: torch.Tensor, depth_key: torch.Tensor,
                   gid: torch.Tensor, t_tiles: int):
    """Stable (tile, depth) sort of (tile, depth, gid) triples that arrive
    unsorted, as the receiver of the instance exchange gets them (port of
    ``feature3dgs_tpu/ops/binning.py:sort_instances``).

    ``tile_key`` [L] holds tiles in [0, t_tiles) or the sentinel
    ``t_tiles`` (then gid is -1 and depth +inf); valid depths are > 0.2, so
    one stable sort on ``tile << 32 | float_bits(depth)`` orders them, and
    entries of equal tile and depth keep their arrival order. Returns
    (gid_sorted, tile_starts, tile_counts) in this module's layout: the
    sentinel entries sort past the last list and are cut off (one host
    read), so the ``t_tiles`` lists cover gid_sorted exactly once, in
    order, with no filler entries."""
    depth_bits = depth_key.to(torch.float32).view(torch.int32).long()
    key = (tile_key.long() << 32) | depth_bits
    _, order = torch.sort(key, stable=True)
    tracing.count("host_wait.bincount", 2)
    counts = torch.bincount(tile_key.long(), minlength=t_tiles + 1)[:t_tiles]
    starts = torch.cumsum(counts, 0) - counts
    tracing.count("host_wait.sort_instances")
    n_valid = int(counts.sum())
    return (gid[order[:n_valid]].to(torch.int32), starts.to(torch.int32),
            counts.to(torch.int32))


def tile_slices(gid_sorted: torch.Tensor, tile_starts: torch.Tensor,
                tile_counts: torch.Tensor, ranges) -> list:
    """The lists of each tile range [t0, t1) of ``ranges`` as a call over
    that slice of the grid takes them: (gid_sorted's sub-range, starts
    rebased to it, counts). The lists must lie in tile order and cover
    gid_sorted once (this module's layout), so tile t's list starts at
    entry ``tile_starts[t]`` and the lists of a range are one sub-range.
    One host read gets every range's two ends."""
    n_inst = gid_sorted.shape[0]
    starts = torch.cat([tile_starts.long(), tile_starts.new_full(
        (1,), n_inst, dtype=torch.long)])
    cuts = [t for r in ranges for t in r]
    if cuts:
        # the cuts' upload from pageable memory and the ends' read
        tracing.count("host_wait.tile_slices", 2)
    ends = starts[torch.tensor(cuts, dtype=torch.long,
                               device=starts.device)].tolist() if cuts else []
    out = []
    for (t0, t1), (a, b) in zip(ranges, zip(ends[::2], ends[1::2])):
        out.append((gid_sorted[a:b], (tile_starts[t0:t1] - a).to(torch.int32),
                    tile_counts[t0:t1]))
    return out
