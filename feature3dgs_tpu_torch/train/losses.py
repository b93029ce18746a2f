"""Loss-side image ops. This slice ports only the feature resize that
rendering uses (``scripts/render.py`` resizes rendered features to the
teacher map's size); the losses themselves come with training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
