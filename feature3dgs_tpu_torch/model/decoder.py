"""Speed-up feature decoder: a 1x1 convolution lifting F/4-dim rendered
features to the F-dim teacher space (the original models/networks.py,
train.py:50-53, render.py:114-119).

Port of ``feature3dgs_tpu/model/decoder.py``. On an HWC map a 1x1
convolution is a channel product, left to ``torch.addmm`` (full f32: the
package turns TF32 off). Parameters are ``{"w": [F_in, F_out], "b":
[F_out]}``; ``init_decoder`` draws them as the JAX package does (numpy
RandomState, U(-k, k), k = 1/sqrt(F_in), the torch Conv2d default).
"""
from __future__ import annotations

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device, tracing


def init_decoder(feature_in: int, feature_out: int, seed: int = 0,
                 device=None) -> dict:
    """Seeded decoder parameters on ``default_device(device)``."""
    device = default_device(device)
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(feature_in)
    w = rng.uniform(-k, k, (feature_in, feature_out)).astype(np.float32)
    b = rng.uniform(-k, k, (feature_out,)).astype(np.float32)
    return {"w": torch.from_numpy(w).to(device),
            "b": torch.from_numpy(b).to(device)}


@tracing.spanned("decoder")
def apply_decoder(params: dict, fmap: torch.Tensor) -> torch.Tensor:
    """[..., F_in] -> [..., F_out]: one product with the bias added in the
    same call."""
    w = params["w"]
    out = torch.addmm(params["b"], fmap.reshape(-1, w.shape[0]), w)
    return out.reshape(fmap.shape[:-1] + (w.shape[1],))
