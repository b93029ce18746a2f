"""CLIP-aligned per-pixel feature maps on the card, the LSeg stand-in.

Port of ``feature3dgs_tpu/encoders/clip_pixel.py``: the MaskCLIP-style
dense CLIP construction. CLIP ViT patch tokens go through the final
block's VALUE and output projections only (no attention mixing), then the
post-LayerNorm and the visual projection, giving dense patch features in
the text encoder's embedding space; bilinear-upsampled to the requested
size and saved as ``<name>_fmap_CxHxW.pt`` (+ .npy twin) under
``rgb_feature_langseg/``.

Needs local CLIP weights (CLIP_MODEL_PATH or the Hugging Face cache). Only
the image processor is loaded: images need no tokenizer files.
"""
from __future__ import annotations

import inspect
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device

_CACHE: dict = {}


def load_clip_vision(device=None):
    """(CLIPModel in eval mode on ``default_device(device)``,
    CLIPImageProcessor) from CLIP_MODEL_PATH or the cache; raises when
    absent."""
    dev = default_device(device)
    if dev not in _CACHE:
        from transformers import CLIPImageProcessor, CLIPModel
        path = os.environ.get("CLIP_MODEL_PATH",
                              "openai/clip-vit-base-patch32")
        local_only = "CLIP_MODEL_PATH" not in os.environ
        model = CLIPModel.from_pretrained(
            path, local_files_only=local_only).to(dev).eval()
        proc = CLIPImageProcessor.from_pretrained(
            path, local_files_only=local_only)
        _CACHE[dev] = (model, proc)
    return _CACHE[dev]


def _layer(layer, x):
    """One CLIPEncoderLayer without masks. transformers 4.x takes
    (hidden_states, attention_mask, causal_attention_mask) and returns a
    tuple; later versions drop the causal mask and may return the hidden
    states alone."""
    masks = {"attention_mask": None}
    if "causal_attention_mask" in inspect.signature(layer.forward).parameters:
        masks["causal_attention_mask"] = None
    out = layer(x, **masks)
    return out[0] if isinstance(out, tuple) else out


@torch.no_grad()
def encode_image(image_rgb, out_hw: tuple[int, int] | None = None,
                 clip=None, device=None) -> torch.Tensor:
    """[H,W,3] image -> [512, h, w] CLIP-space pixel features (MaskCLIP
    trick), float32 on the model's device. ``clip`` is a (CLIPModel,
    image processor) pair; by default ``load_clip_vision(device)``."""
    import torch.nn.functional as F
    model, proc = clip if clip is not None else load_clip_vision(device)
    dev = next(model.parameters()).device
    image_rgb = np.asarray(image_rgb)
    if image_rgb.dtype != np.uint8:
        image_rgb = (np.clip(image_rgb, 0, 1) * 255).astype(np.uint8)
    pixels = proc(images=image_rgb, return_tensors="pt")["pixel_values"]
    vt = model.vision_model
    x = vt.embeddings(pixels.to(dev))
    x = vt.pre_layrnorm(x)
    for layer in vt.encoder.layers[:-1]:
        x = _layer(layer, x)
    last = vt.encoder.layers[-1]
    # MaskCLIP: v-projection + out-projection of the last block, applied
    # per token (no attention mixing), then the usual post-LN + CLIP
    # visual projection into the shared text space.
    y = last.layer_norm1(x)
    v = last.self_attn.v_proj(y)
    v = last.self_attn.out_proj(v)
    x = x + v
    x = x + last.mlp(last.layer_norm2(x))
    x = vt.post_layernorm(x)
    feats = model.visual_projection(x)[0, 1:]  # drop CLS -> [P, 512]
    side = int(round(feats.shape[0] ** 0.5))
    fmap = feats.T.reshape(1, -1, side, side)
    if out_hw is not None:
        fmap = F.interpolate(fmap, size=out_hw, mode="bilinear",
                             align_corners=True)
    return fmap[0].float()


def main(argv=None) -> int:
    parser = ArgumentParser()
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True,
                        help="e.g. <scene>/rgb_feature_langseg")
    parser.add_argument("--stride", type=int, default=2,
                        help="output map = image size / stride")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    dev = default_device(args.device)
    if args.checkpoint:
        os.environ["CLIP_MODEL_PATH"] = args.checkpoint

    from PIL import Image
    os.makedirs(args.output, exist_ok=True)
    names = sorted(os.listdir(args.input))
    for i, name in enumerate(names):
        stem = os.path.splitext(name)[0]
        img = np.asarray(Image.open(os.path.join(args.input, name))
                         .convert("RGB"))
        hw = (img.shape[0] // args.stride, img.shape[1] // args.stride)
        fmap = encode_image(img, hw, device=dev).to(torch.float16).cpu()
        base = os.path.join(args.output, stem + "_fmap_CxHxW")
        np.save(base + ".npy", fmap.numpy())
        torch.save(fmap, base + ".pt")
        print(f"[{i + 1}/{len(names)}] {name} -> {tuple(fmap.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
