"""Per-entry gradient rows -> per-Gaussian gradients, deterministically.

Port of the ``jax.ops.segment_sum`` in
``feature3dgs_tpu/ops/pallas_raster.py:_cp_bwd``: the compositing kernels
write one gradient row per (Gaussian, tile) entry of gid_sorted, and each
Gaussian's gradient is the sum of its rows. No float atomics (no
``index_add_``): a stable sort groups the rows by Gaussian, keeping their
(tile, depth) order, and each group is summed serially in that order, so
the same rows give the same bits. On the card one kernel
(``ops/cuda_segment.py``) reads the rows where they lie; on the CPU
``torch.segment_reduce`` sums the rows gathered into that order, with the
same bits. The JAX package's ``live_row_threshold`` has no
counterpart: both versions of the backward write every row.
"""
from __future__ import annotations

import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.ops.cuda_segment import segment_sum_cuda


class SegmentPlan:
    """The grouping of gid_sorted's entries by Gaussian, shared by every
    row array of one backward: ``order`` [L] (stable sort of the ids) and
    ``bounds`` [N + 1] (where each Gaussian's entries start in ``order``).
    No host sync."""

    def __init__(self, gid_sorted: torch.Tensor, n_gauss: int):
        ids, self.order = torch.sort(gid_sorted.long(), stable=True)
        self.bounds = torch.searchsorted(
            ids, torch.arange(n_gauss + 1, device=ids.device))

    def sum(self, rows: torch.Tensor) -> torch.Tensor:
        """[L, C] rows in gid_sorted order -> [N, C] sums per Gaussian
        (zeros for a Gaussian with no entry)."""
        return self.sums(rows)[0]

    def sums(self, rows: torch.Tensor, rider: torch.Tensor = None) -> tuple:
        """(``sum`` of rows, ``sum`` of rider or None). CUDA arrays take the
        kernel, which sums a narrow rider in the rows' launch (the geometric
        rows beside the feature rows of a step); CPU arrays the plain
        ``segment_reduce``. Counters ``raster.segsum_fused`` and
        ``raster.segsum_plain`` count the row arrays each path summed."""
        arrays = 1 if rider is None else 2
        if rows.device.type == "cuda":
            tracing.count("raster.segsum_fused", arrays)
            return segment_sum_cuda(self.order, self.bounds, rows.contiguous(),
                                    None if rider is None
                                    else rider.contiguous())
        tracing.count("raster.segsum_plain", arrays)
        lengths = self.bounds.diff()
        return tuple(None if a is None else torch.segment_reduce(
            a[self.order], "sum", lengths=lengths, unsafe=True)
            for a in (rows, rider))


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
