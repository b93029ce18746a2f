"""Per-pixel oracle rasterizer: slow, simple, trusted.

Port of ``feature3dgs_tpu/ops/oracle.py:oracle_composite``: a direct
sequential transcription of the original compositing semantics
(forward.cu:261-396), one Python loop over ALL depth-sorted Gaussians with
per-pixel (T, done) carries, differentiated by ordinary autograd (no custom
backward). It shares no code with the tiled, chunked compositor
(``ops/composite.py:composite_plain`` and its CUDA kernels), so it is an
independent witness for both: forward pixels agree to float32 tolerance and
gradients agree.

Support: the original composites a Gaussian only on pixels of tiles inside
its bounding rect (getRect, auxiliary.h:46-56); the oracle applies the same
tile-rect test per pixel, so that it is comparable with the tiled path
rather than an "infinite support" idealization.

One loop step a Gaussian, each a few [H, W] tensors that autograd keeps:
use it at test and parity-check sizes, never at a full training scene.
"""
from __future__ import annotations

import torch

from feature3dgs_tpu_torch.core import projection as proj_lib
from feature3dgs_tpu_torch.ops.binning import TileGrid
from feature3dgs_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN, T_EPS


def oracle_composite(pre: proj_lib.Preprocessed, feat: torch.Tensor,
                     bg: torch.Tensor, grid: TileGrid,
                     feature_alpha_grad: bool = False) -> dict:
    """Sequential per-pixel compositing over depth-sorted Gaussians.

    Returns a dict with color [H,W,3], feature [H,W,F], depth [H,W] and
    final_T [H,W], on the device of ``pre``'s tensors.
    """
    h, w = grid.height, grid.width
    dtype, dev = pre.xy.dtype, pre.xy.device
    inf = torch.full_like(pre.depth, float("inf"))
    order = torch.argsort(torch.where(pre.valid, pre.depth, inf).detach(),
                          stable=True)

    rect_min, rect_max = proj_lib.tile_rect(
        pre.xy.detach(), pre.radius.detach(), grid.grid_x, grid.grid_y,
        grid.tile_w, grid.tile_h)
    area = ((rect_max[:, 0] - rect_min[:, 0])
            * (rect_max[:, 1] - rect_min[:, 1]))
    usable = pre.valid & (area > 0)

    px = torch.arange(w, dtype=dtype, device=dev)[None, :].expand(h, w)
    py = torch.arange(h, dtype=dtype, device=dev)[:, None].expand(h, w)
    tile_x = torch.div(px, grid.tile_w, rounding_mode="floor").to(torch.int32)
    tile_y = torch.div(py, grid.tile_h, rounding_mode="floor").to(torch.int32)

    # per-Gaussian rows in depth order, split once (one autograd node each)
    xs, ys = pre.xy[order].unbind(1)
    ca, cb, cc = pre.conic[order].unbind(1)
    opacity = pre.opacity[order].unbind(0)
    rgb = pre.rgb[order].unbind(0)
    depth = pre.depth[order].unbind(0)
    feats = feat[order].unbind(0)
    # the per-pixel tile-rect test of every Gaussian, [N, H, W] bool
    r0, r1 = rect_min[order], rect_max[order]
    in_rect = ((tile_x >= r0[:, 0, None, None])
               & (tile_x < r1[:, 0, None, None])
               & (tile_y >= r0[:, 1, None, None])
               & (tile_y < r1[:, 1, None, None])
               & usable[order][:, None, None])
    alpha_max = torch.tensor(ALPHA_MAX, dtype=dtype, device=dev)

    trans = torch.ones((h, w), dtype=dtype, device=dev)
    done = torch.zeros((h, w), dtype=torch.bool, device=dev)
    acc_c = torch.zeros((h, w, 3), dtype=dtype, device=dev)
    acc_f = torch.zeros((h, w, feat.shape[-1]), dtype=dtype, device=dev)
    acc_d = torch.zeros((h, w), dtype=dtype, device=dev)
    for g in range(order.shape[0]):
        dx = xs[g] - px
        dy = ys[g] - py
        power = -0.5 * (ca[g] * dx * dx + cc[g] * dy * dy) - cb[g] * dx * dy
        alpha = torch.minimum(alpha_max, opacity[g] * torch.exp(power))
        ok = in_rect[g] & (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done
        test_t = trans * (1.0 - alpha)
        terminate = ok & (test_t < T_EPS)
        contribute = ok & (test_t >= T_EPS)
        w_pix = torch.where(contribute, alpha * trans, torch.zeros_like(trans))
        acc_c = acc_c + w_pix[..., None] * rgb[g]
        # The original's backward leaves out the feature -> alpha gradient
        # (backward.cu:575), so by default the feature accumulation sees a
        # detached weight (features still get their own w * dL/dF).
        w_feat = w_pix if feature_alpha_grad else w_pix.detach()
        acc_f = acc_f + w_feat[..., None] * feats[g]
        acc_d = acc_d + w_pix * depth[g]
        trans = torch.where(contribute, test_t, trans)
        done = done | terminate
    return {"color": acc_c + trans[..., None] * bg,
            "feature": acc_f,
            "depth": acc_d,
            "final_T": trans}
