"""Training: one optimisation step of the Gaussian scene, in PyTorch.

Port of ``feature3dgs_tpu/train/trainer.py`` (``OptimizationConfig``,
``TrainState``, ``train_step``; the original train.py:36-178): render ->
losses -> backward -> Adam -> densification statistics. Loss
(train.py:98-105):
  (1 - λ)·L1(rgb) + λ·(1 - SSIM(rgb)) + feature_loss_weight·L1(feature)
with the rendered feature map bilinearly resized (align_corners=True) to
the teacher map, optionally lifted by the speed-up decoder.

The step updates the ``TrainState`` tensors in place under
``torch.no_grad()``. A non-finite loss discards the whole update (params,
Adam moments and step, densification statistics, decoder and its Adam) on
the device, with no host sync. The host loop (densify/prune, opacity
reset, capacity growth) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from feature3dgs_tpu_torch import default_device
from feature3dgs_tpu_torch.core.projection import CameraView
from feature3dgs_tpu_torch.model import density, optim
from feature3dgs_tpu_torch.model import gaussians as G
from feature3dgs_tpu_torch.model.decoder import apply_decoder
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.render import renderer
from feature3dgs_tpu_torch.train import losses as L


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """The original OptimizationParams (arguments/__init__.py:74-95)."""

    iterations: int = 30_000
    lr: optim.LRConfig = optim.LRConfig()
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    feature_loss_weight: float = 1.0


@dataclasses.dataclass
class TrainState:
    params: G.GaussianParams
    gstate: G.GaussianState
    adam: optim.AdamState
    decoder: dict | None = None
    decoder_adam: optim.TensorAdamState | None = None

    @classmethod
    def create(cls, params: G.GaussianParams, gstate: G.GaussianState,
               decoder: dict | None = None, device=None) -> "TrainState":
        """Fresh Adam states for ``params`` (and the decoder), which must
        lie on ``default_device(device)``."""
        device = default_device(device)
        return cls(params=params, gstate=gstate,
                   adam=optim.init_adam(params, device),
                   decoder=decoder,
                   decoder_adam=(None if decoder is None
                                 else optim.init_tensor_adam(decoder, device)))


def train_step(ts: TrainState, cam: CameraView, gt_image: torch.Tensor,
               gt_feature: torch.Tensor, bg: torch.Tensor, iteration: int, *,
               ocfg: OptimizationConfig, rcfg: RasterConfig, speedup: bool
               ) -> dict:
    """One step on view ``cam``: gt_image [H,W,3], gt_feature [h,w,F_out]
    (fp16 maps are upcast), bg [3], ``iteration`` 1-based (the xyz
    learning rate). Updates ``ts`` in place and returns a dict of scalar
    tensors (no host sync): finite, loss, l1, l1_feature, num_instances,
    max_tile_count, num_active, psnr."""
    params, gstate = ts.params, ts.gstate
    # leaves that alias the stored tensors: autograd differentiates these,
    # and the stored tensors are then updated in place
    leaves = G.GaussianParams(**{k: getattr(params, k).detach().requires_grad_()
                                 for k in G.GaussianParams.FIELDS})
    ndc_offset = torch.zeros((params.capacity, 2), dtype=torch.float32,
                             device=params.xyz.device, requires_grad=True)
    dec = None
    if speedup:
        dec = {k: v.detach().requires_grad_() for k, v in ts.decoder.items()}

    out = renderer.render(leaves, gstate, cam, bg=bg, config=rcfg,
                          ndc_offset=ndc_offset)
    rgb, ll1 = L.rgb_loss(out.color, gt_image, ocfg.lambda_dssim)
    fmap = L.resize_bilinear_from_tiles(
        out.feature_tiles, rcfg.grid(cam.width, cam.height),
        gt_feature.shape[0], gt_feature.shape[1])
    if speedup:
        fmap = apply_decoder(dec, fmap)
    ll1_feat = L.l1_loss(fmap, gt_feature.to(torch.float32))
    loss = rgb + ocfg.feature_loss_weight * ll1_feat

    inputs = [getattr(leaves, k) for k in G.GaussianParams.FIELDS] + [ndc_offset]
    if speedup:
        inputs += [dec["w"], dec["b"]]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    n_fields = len(G.GaussianParams.FIELDS)
    g_params = G.GaussianParams(*grads[:n_fields])
    g_offset = grads[n_fields]

    with torch.no_grad():
        finite = torch.isfinite(loss)
        optim.adam_update(params, g_params, ts.adam,
                          optim.group_lrs(ocfg.lr, iteration,
                                          gstate.spatial_lr_scale),
                          keep=finite)
        if speedup:
            optim.tensor_adam_update(ts.decoder, dict(w=grads[-2], b=grads[-1]),
                                     ts.decoder_adam, lr=1e-4, keep=finite)
        density.add_densification_stats(gstate, g_offset, out.visibility,
                                        out.radii, keep=finite)
        metrics = {
            "finite": finite,
            "loss": loss.detach(), "l1": ll1.detach(),
            "l1_feature": ll1_feat.detach(),
            "num_instances": out.total_instances,
            "max_tile_count": out.max_tile_count,
            "num_active": gstate.alive.sum(),
            "psnr": L.psnr(torch.clamp(out.color, 0, 1),
                           torch.clamp(gt_image, 0, 1)),
        }
    return metrics
