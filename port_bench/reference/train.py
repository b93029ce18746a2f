"""Plain PyTorch training step of Feature 3DGS: the benchmark's reference for
what the program's training step does to the state.

Written from the published method (Feature 3DGS train.py: the loss
(1 - 0.2) L1 + 0.2 (1 - SSIM) on colour plus the L1 of the rendered feature
map, resized to the teacher's size with align_corners bilinear
interpolation and, with the speed-up module, lifted by a 1x1 convolution;
3DGS's per-group Adam with eps 1e-15 and the log-linear position rate;
plain Adam with lr 1e-4 for the decoder) and nothing of the program.

The gradient is taken in two passes so that it fits at full size: the view
is rendered without autograd, the loss is differentiated with respect to
the rendered images, and the blending is then differentiated block by
block (``render.blend_backward``) and chained through the projection.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import render as R

LAMBDA_DSSIM = 0.2
FEATURE_WEIGHT = 1.0
BETAS = (0.9, 0.999)
EPS = 1e-15
DECODER_LR, DECODER_EPS = 1e-4, 1e-8
# 3DGS's learning rates (arguments/__init__.py)
LR = {"features_dc": 0.0025, "features_rest": 0.0025 / 20.0,
      "scaling": 0.005, "rotation": 0.001, "opacity": 0.05,
      "semantic_feature": 0.001}
POSITION_LR = (0.00016, 0.0000016, 30_000)


def position_lr(iteration: int, spatial_scale: float) -> float:
    """The log-linear position rate at an iteration (no delay ramp)."""
    init, final, max_steps = POSITION_LR
    t = min(max(iteration / max_steps, 0.0), 1.0)
    init, final = init * spatial_scale, final * spatial_scale
    if init <= 0 or final <= 0:
        return 0.0
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def ssim(img1: torch.Tensor, img2: torch.Tensor, size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two [C,H,W] images, Gaussian window, zero padding."""
    xs = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-xs ** 2 / (2 * sigma ** 2))
    g = (g / g.sum()).float().to(img1.device)
    c = img1.shape[0]
    win = (g[:, None] * g[None, :]).expand(c, 1, size, size).contiguous()
    conv = lambda x: F.conv2d(x[None], win, padding=size // 2, groups=c)[0]
    mu1, mu2 = conv(img1), conv(img2)
    s1 = conv(img1 * img1) - mu1 * mu1
    s2 = conv(img2 * img2) - mu2 * mu2
    s12 = conv(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def decode(dec: dict, fmap: torch.Tensor) -> torch.Tensor:
    """The speed-up decoder, a 1x1 convolution, on [..., F_in]."""
    w, b = dec["w"], dec["b"]
    return (fmap.reshape(-1, w.shape[0]) @ w + b).reshape(
        fmap.shape[:-1] + (w.shape[1],))


def loss_of(color, feat, gt_image, gt_feature, dec):
    """The training loss of rendered colour [H,W,3] and features [H,W,F]."""
    img = color.permute(2, 0, 1)
    gt = gt_image.permute(2, 0, 1)
    l1 = (img - gt).abs().mean()
    rgb = (1 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (1 - ssim(img, gt))
    h, w = gt_feature.shape[:2]
    fmap = F.interpolate(feat.permute(2, 0, 1)[None], size=(h, w),
                         mode="bilinear", align_corners=True)
    fmap = fmap[0].permute(1, 2, 0)
    if dec is not None:
        fmap = decode(dec, fmap)
    lf = (fmap - gt_feature.float()).abs().mean()
    return rgb + FEATURE_WEIGHT * lf


def gradients(params: dict, dec: dict | None, cam: R.Cam, gt_image,
              gt_feature, sh_degree: int = 3, tile=(32, 16)):
    """(loss, grads of ``params`` by field, grads of ``dec``) of one view."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    dleaves = (None if dec is None
               else {k: v.detach().requires_grad_() for k, v in dec.items()})
    s = R.project(R.activate(leaves), cam, sh_degree)
    bins = R.bin_tiles(s, cam.width, cam.height, *tile)
    img = R.render(s, bins, cam.width, cam.height)
    color = img.color.requires_grad_()
    feat = img.feat.requires_grad_()
    loss = loss_of(color, feat, gt_image, gt_feature, dleaves)
    wrt = [color, feat] + ([] if dec is None else list(dleaves.values()))
    g = torch.autograd.grad(loss, wrt)
    grads = R.blend_backward(s, bins, cam.width, cam.height, g[0], g[1])
    outs = [k for k in ("xy", "conic", "opacity", "rgb", "feat")
            if getattr(s, k).requires_grad]
    torch.autograd.backward([getattr(s, k) for k in outs],
                            [grads[k] for k in outs])
    gp = {k: (torch.zeros_like(v) if v.grad is None else v.grad)
          for k, v in leaves.items()}
    gd = None if dec is None else dict(zip(dleaves, g[2:]))
    return loss.detach(), gp, gd


@torch.no_grad()
def adam(params: dict, grads: dict, mu: dict, nu: dict, step: int, lrs: dict,
         eps: float) -> None:
    """One bias-corrected Adam step in place; ``step`` counts this one."""
    b1, b2 = BETAS
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for k, p in params.items():
        mu[k].mul_(b1).add_((1 - b1) * grads[k])
        nu[k].mul_(b2).add_((1 - b2) * grads[k] * grads[k])
        p.sub_(lrs[k] * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))


def train_step(state: dict, cam: R.Cam, gt_image, gt_feature, iteration: int,
               sh_degree: int = 3, tile=(32, 16)) -> dict:
    """One step on ``state`` in place: {"params", "mu", "nu", "step",
    "dec", "dec_mu", "dec_nu", "dec_step", "spatial_scale"}. Returns
    {"loss", "grads", "dec_grads"}."""
    loss, gp, gd = gradients(state["params"], state.get("dec"), cam,
                             gt_image, gt_feature, sh_degree, tile)
    lrs = dict(LR, xyz=position_lr(iteration, state["spatial_scale"]))
    state["step"] += 1
    adam(state["params"], gp, state["mu"], state["nu"], state["step"], lrs,
         EPS)
    if gd is not None:
        state["dec_step"] += 1
        adam(state["dec"], gd, state["dec_mu"], state["dec_nu"],
             state["dec_step"], dict.fromkeys(gd, DECODER_LR), DECODER_EPS)
    return {"loss": loss, "grads": gp, "dec_grads": gd}


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}
