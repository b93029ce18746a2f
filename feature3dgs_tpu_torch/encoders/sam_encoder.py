"""SAM image-embedding export on the card.

Port of ``feature3dgs_tpu/encoders/sam_encoder.py`` (the original
encoders/sam_encoder/export_image_embeddings.py:52-117): per image, the
SAM ViT image encoder, the 64x64x256 embedding cropped to the image's
aspect (64 * h/w or 64 * w/h, export_image_embeddings.py:74-83), saved as
``<name>_fmap_CxHxW.pt`` (+ .npy twin) into the scene's
``sam_embeddings/``.

Needs a local checkpoint (SAM_MODEL_PATH, ``--checkpoint``, or
facebook/sam-vit-huge in the Hugging Face cache); ``load_sam`` raises when
it is absent. Functions that run the model take ``sam``, a (SamModel,
SamProcessor) pair, so a caller can hand in a model it built.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device

_CACHE: dict = {}


def load_sam(device=None):
    """(SamModel in eval mode on ``default_device(device)``, SamProcessor)
    from SAM_MODEL_PATH or the cache; raises when absent."""
    dev = default_device(device)
    if dev not in _CACHE:
        from transformers import SamModel, SamProcessor
        path = os.environ.get("SAM_MODEL_PATH", "facebook/sam-vit-huge")
        local_only = "SAM_MODEL_PATH" not in os.environ
        model = SamModel.from_pretrained(
            path, local_files_only=local_only).to(dev).eval()
        proc = SamProcessor.from_pretrained(path, local_files_only=local_only)
        _CACHE[dev] = (model, proc)
    return _CACHE[dev]


@torch.no_grad()
def encode_image(image_rgb, sam=None, device=None) -> torch.Tensor:
    """[H,W,3] uint8 or [0,1] float image -> [256, 64h', 64w'] float32
    embedding cropped to the aspect, on the model's device (the processor
    resizes and pads on the host)."""
    model, proc = sam if sam is not None else load_sam(device)
    dev = next(model.parameters()).device
    image_rgb = np.asarray(image_rgb)
    if image_rgb.dtype != np.uint8:
        image_rgb = (np.clip(image_rgb, 0, 1) * 255).astype(np.uint8)
    pixels = proc(images=image_rgb, return_tensors="pt")["pixel_values"]
    emb = model.get_image_embeddings(pixels.to(dev))[0].float()
    # SAM pads the long side to 1024: the embedding region covering the
    # image is 64 * short/long along the short axis
    h, w = image_rgb.shape[:2]
    if h > w:
        return emb[:, :, :max(1, round(64 * w / h))]
    if w > h:
        return emb[:, :max(1, round(64 * h / w)), :]
    return emb


def main(argv=None) -> int:
    parser = ArgumentParser()
    parser.add_argument("--checkpoint", default=None,
                        help="local SAM checkpoint dir (else SAM_MODEL_PATH)")
    parser.add_argument("--input", required=True, help="image directory")
    parser.add_argument("--output", required=True,
                        help="output dir (e.g. <scene>/sam_embeddings)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    dev = default_device(args.device)
    if args.checkpoint:
        os.environ["SAM_MODEL_PATH"] = args.checkpoint

    from PIL import Image
    os.makedirs(args.output, exist_ok=True)
    names = sorted(os.listdir(args.input))
    for i, name in enumerate(names):
        stem = os.path.splitext(name)[0]
        img = np.asarray(Image.open(os.path.join(args.input, name))
                         .convert("RGB"))
        emb = encode_image(img, device=dev).to(torch.float16)
        emb = emb.contiguous().cpu()
        base = os.path.join(args.output, stem + "_fmap_CxHxW")
        np.save(base + ".npy", emb.numpy())
        torch.save(emb, base + ".pt")
        print(f"[{i + 1}/{len(names)}] {name} -> {tuple(emb.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
