"""Teacher encoders on the card: feature-map generation and downstream
decoding.

Port of ``feature3dgs_tpu/encoders/`` (the original's encoder forks,
encoders/: LSeg 512-d CLIP-aligned pixel features, SAM 256-d image
embeddings, saved per view as ``<image>_fmap_CxHxW.pt``):

  lseg_net       the LSeg network (ViT-L/16 + DPT head), 512-d features
  clip_pixel     MaskCLIP-style CLIP-aligned per-pixel features (512-d),
                 the LSeg stand-in when LSeg weights are absent
  sam_encoder    SAM ViT-H image embeddings (256 x 64 x 64)
  sam_decode     masks from RENDERED embeddings through SAM's prompt and
                 mask decoder, and the automatic mask generator

Each takes an explicit device (``default_device``) and keeps its tensors
there; random weights come from an explicit ``torch.Generator``
(``seeded_init_``). ``transformers`` is imported inside functions, so
importing the port loads it nowhere. Weights are local files only
(``LSEG_WEIGHTS``, ``CLIP_MODEL_PATH``, ``SAM_MODEL_PATH`` or the
Hugging Face cache); the loaders raise when they are absent.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def seeded_init_(module: torch.nn.Module, generator: torch.Generator):
    """Fill every floating entry of ``module``'s state dict from
    ``generator`` (on the module's device): tensors of two or more
    dimensions ~ N(0, 1/fan_in) with fan_in = numel / shape[0], other
    ``*weight`` entries 1 (norm scales), running variances 1, the rest 0
    (biases, running means). Random weights at a published width: real
    activations' scale, the compute of the real network."""
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        if t.dim() >= 2:
            t.normal_(0.0, (t.numel() / t.shape[0]) ** -0.5,
                      generator=generator)
        elif name.endswith(("weight", "running_var")):
            t.fill_(1.0)
        else:
            t.zero_()
    return module
