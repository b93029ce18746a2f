"""Per-entry gradient rows -> per-Gaussian gradients, deterministically.

Port of the ``jax.ops.segment_sum`` in
``feature3dgs_tpu/ops/pallas_raster.py:_cp_bwd``: the compositing kernels
write one gradient row per (Gaussian, tile) entry of gid_sorted, and each
Gaussian's gradient is the sum of its rows. No float atomics (no
``index_add_``): a stable sort groups the rows by Gaussian, keeping their
(tile, depth) order, and ``torch.segment_reduce`` sums each group in that
order, so the same rows give the same bits. The JAX package's
``live_row_threshold`` has no counterpart: both versions of the backward
write every row.
"""
from __future__ import annotations

import torch


class SegmentPlan:
    """The grouping of gid_sorted's entries by Gaussian, shared by every
    row array of one backward: ``order`` [L] (stable sort of the ids) and
    ``lengths`` [N] (entries per Gaussian). No host sync."""

    def __init__(self, gid_sorted: torch.Tensor, n_gauss: int):
        ids, self.order = torch.sort(gid_sorted.long(), stable=True)
        bounds = torch.searchsorted(
            ids, torch.arange(n_gauss + 1, device=ids.device))
        self.lengths = bounds[1:] - bounds[:-1]

    def sum(self, rows: torch.Tensor) -> torch.Tensor:
        """[L, C] rows in gid_sorted order -> [N, C] sums per Gaussian
        (zeros for a Gaussian with no entry)."""
        return torch.segment_reduce(rows[self.order], "sum",
                                    lengths=self.lengths, unsafe=True)


def camera_rows(gid_sorted: torch.Tensor, tile_counts: torch.Tensor,
                n_per_camera: int, tiles_per_camera: int,
                tile_base: int = 0) -> torch.Tensor:
    """[L] int64 row b * N + id of each list entry in B cameras' [B*N]
    per-camera inputs, where b is the camera of the entry's tile (global
    tile ``tile_base + t``, ``tiles_per_camera`` a camera). The lists must
    cover gid_sorted once, in tile order. No host sync."""
    cams = ((torch.arange(tile_counts.shape[0], device=gid_sorted.device)
             + tile_base) // tiles_per_camera)
    return gid_sorted.long() + n_per_camera * torch.repeat_interleave(
        cams, tile_counts.long(), output_size=gid_sorted.shape[0])
