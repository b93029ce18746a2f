"""LPIPS (VGG16) in PyTorch: port of ``feature3dgs_tpu/metrics/lpips_jax.py``
(the original's vendored lpipsPyTorch, lpipsPyTorch/__init__.py:6-21).

Both images go through the VGG16 feature trunk; the activations after
relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 are unit-normalised per
pixel over channels, their squared difference is weighted by the per-layer
linear heads, averaged over pixels and summed over layers (Zhang et al.
2018). Convolutions are ``F.conv2d`` in float32: LPIPS is no kernel of the
JAX package.

Weights come from a local npz in the JAX package's layout (the
``LPIPS_WEIGHTS`` variable or the ``weights`` argument): ``conv{i}_w``
[kh,kw,ci,co] and ``conv{i}_b`` for the 13 convolutions, ``lin{j}_w`` [c_j]
for the 5 heads. Without a file there is no LPIPS.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from feature3dgs_tpu_torch import default_device

# VGG16 trunk: output channels per conv, "M" = 2x2 max pool; LPIPS taps the
# activation before each pool and the last one
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512]
_TAP_AFTER_CONV = (1, 3, 6, 9, 12)
# input normalization (lpips ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def load_lpips_weights(path: str | None = None, device=None) -> dict | None:
    """LPIPS-VGG weights from an npz as tensors on ``default_device(device)``
    (convolutions as [co,ci,kh,kw]), or None when there is no file."""
    dev = default_device(device)
    path = path or os.environ.get("LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    out = {}
    with np.load(path) as data:
        for k in data.files:
            a = torch.from_numpy(np.asarray(data[k], np.float32))
            if k.endswith("_w") and a.dim() == 4:
                a = a.permute(3, 2, 0, 1).contiguous()
            out[k] = a.to(dev)
    return out


@functools.lru_cache(maxsize=4)
def _default_weights(device: str):
    return load_lpips_weights(device=device)


def lpips_available(device=None) -> bool:
    """Whether ``LPIPS_WEIGHTS`` names a weights file."""
    return _default_weights(str(default_device(device))) is not None


def _vgg_taps(x: torch.Tensor, weights: dict) -> list:
    """x [1,3,H,W] in [-1, 1] -> the five tapped activations."""
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    taps = []
    ci = 0
    for spec in _VGG16:
        if spec == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        h = F.relu(F.conv2d(h, weights[f"conv{ci}_w"], weights[f"conv{ci}_b"],
                            padding=1))
        if ci in _TAP_AFTER_CONV:
            taps.append(h)
        ci += 1
    return taps


def lpips_distance(img_a, img_b, weights: dict | None = None,
                   device=None) -> float:
    """LPIPS (vgg) between two [H,W,3] images in [0, 1] (numpy or tensors),
    the original's lpips(img, gt, net_type='vgg') (metrics.py:83). Runs on
    the weights' device, else on ``default_device(device)``."""
    if weights is None:
        weights = _default_weights(str(default_device(device)))
    if weights is None:
        raise RuntimeError(
            "no LPIPS weights: set LPIPS_WEIGHTS to an npz in the layout of "
            "scripts/convert_lpips_weights.py")
    dev = weights["conv0_w"].device

    def prep(img):
        t = torch.as_tensor(img, dtype=torch.float32, device=dev)
        return (t * 2.0 - 1.0).permute(2, 0, 1)[None]

    with torch.no_grad():
        total = torch.zeros((), device=dev)
        for j, (fa, fb) in enumerate(zip(_vgg_taps(prep(img_a), weights),
                                         _vgg_taps(prep(img_b), weights))):
            na = fa * torch.rsqrt(torch.sum(fa * fa, 1, keepdim=True) + 1e-10)
            nb = fb * torch.rsqrt(torch.sum(fb * fb, 1, keepdim=True) + 1e-10)
            d2 = (na - nb) ** 2                            # [1,c,h,w]
            lin = weights[f"lin{j}_w"].view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d2 * lin, dim=1))
    return float(total)
