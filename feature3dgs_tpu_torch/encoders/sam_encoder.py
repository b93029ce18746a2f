"""SAM image-embedding export on the card.

Port of ``feature3dgs_tpu/encoders/sam_encoder.py`` (the original
encoders/sam_encoder/export_image_embeddings.py:52-117): per image, the
SAM ViT image encoder, the 64x64x256 embedding cropped to the image's
aspect (64 * h/w or 64 * w/h, export_image_embeddings.py:74-83), saved as
``<name>_fmap_CxHxW.pt`` (+ .npy twin) into the scene's
``sam_embeddings/``.

The CLI needs a local checkpoint (SAM_MODEL_PATH, ``--checkpoint``, or
facebook/sam-vit-huge in the Hugging Face cache); ``load_sam`` raises when
it is absent. ``build_sam`` builds ViT-H at its published widths with
seeded weights instead. Functions that run the model take ``sam``, a
(SamModel, SamProcessor) pair, so a caller can hand in a model it built.

Spans (``tracing.py``): ``sam.encode`` holds ``sam.preprocess`` (the
processor on the host and the upload), one ``sam.window_block`` or
``sam.global_block`` a block, and ``sam.neck``; counters ``sam.images``,
``host_wait.sam_upload`` and ``host_wait.sam_embedding`` (the export's copy
to the host). ``sam.decode`` is each call of the ``SamModel`` itself, which
the port makes with embeddings only (``sam_decode.py``): the image's
positional encoding, the prompt encoder and the mask decoder. The block,
neck and model spans are hooks on the ``transformers`` modules, set by
``build_sam`` and ``load_sam``.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device, tracing

_CACHE: dict = {}

# SAM ViT-H's image encoder (segment-anything build_sam.py:build_sam_vit_h;
# facebook/sam-vit-huge), as transformers' SamVisionConfig keys: 16 x 16
# patches of a 1024 x 1024 input (64 x 64 tokens), 32 blocks of width 1280
# with 16 heads of 80 and an MLP of 5120, 14 x 14 windows but in the 4
# global blocks, a 256-channel neck
VIT_H = dict(hidden_size=1280, num_hidden_layers=32, num_attention_heads=16,
             global_attn_indexes=[7, 15, 23, 31], window_size=14,
             image_size=1024, patch_size=16, output_channels=256,
             mlp_dim=5120)


def _span_blocks(model):
    """Hook the spans of each vision block (windowed or global), of the
    neck and of the whole model's call onto ``model``'s ``transformers``
    modules."""
    enc = model.vision_encoder
    globals_ = set(enc.config.global_attn_indexes)
    for i, layer in enumerate(enc.layers):
        tracing.span_calls(layer, "sam.global_block" if i in globals_
                           else "sam.window_block")
    tracing.span_calls(enc.neck, "sam.neck")
    tracing.span_calls(model, "sam.decode")
    return model


def build_sam(device=None, generator: torch.Generator | None = None,
              prompt_encoder: dict | None = None,
              mask_decoder: dict | None = None, **dims):
    """(SamModel in eval mode on ``default_device(device)``, SamProcessor)
    at SAM ViT-H's published widths (``VIT_H``; ``dims`` override
    SamVisionConfig keys, and ``prompt_encoder`` / ``mask_decoder``
    SamPromptEncoderConfig / SamMaskDecoderConfig keys, whose defaults are
    segment-anything's published prompt encoder and mask decoder; so tests
    build a tiny one), the processor resizing the long side to the model's
    input size and padding to it. With ``generator`` the weights are drawn
    from it (``encoders.seeded_init_``)."""
    from transformers import (SamConfig, SamMaskDecoderConfig, SamModel,
                              SamPromptEncoderConfig, SamVisionConfig)
    dev = default_device(device)
    vision = dict(VIT_H, **dims)
    cfg = SamConfig(
        vision_config=SamVisionConfig(**vision).to_dict(),
        prompt_encoder_config=SamPromptEncoderConfig(
            **(prompt_encoder or {})).to_dict(),
        mask_decoder_config=SamMaskDecoderConfig(
            **(mask_decoder or {})).to_dict())
    with torch.device(dev):
        model = SamModel(cfg)
    if generator is not None:
        from feature3dgs_tpu_torch.encoders import seeded_init_
        seeded_init_(model, generator)
    return _span_blocks(model.eval()), processor(vision["image_size"])


def processor(size: int = 1024):
    """SAM's processor for a ``size`` x ``size`` input: the long side
    resized to ``size`` (PIL bilinear), rescaled, normalised with ImageNet's
    mean and std, zero-padded at the bottom and right."""
    from transformers import SamImageProcessor, SamProcessor
    return SamProcessor(SamImageProcessor(
        size={"longest_edge": size},
        pad_size={"height": size, "width": size}))


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
        _CACHE[dev] = (_span_blocks(model), proc)
    return _CACHE[dev]


@torch.no_grad()
def encode_image(image_rgb, sam=None, device=None) -> torch.Tensor:
    """[H,W,3] uint8 or [0,1] float image -> [256, gh', gw'] float32
    embedding cropped to the aspect of the model's g x g grid (64 x 64 at
    1024 / 16), on the model's device (the processor resizes and pads on
    the host)."""
    model, proc = sam if sam is not None else load_sam(device)
    dev = next(model.parameters()).device
    vision = model.config.vision_config
    g = vision.image_size // vision.patch_size
    with tracing.span("sam.encode"):
        tracing.count("sam.images")
        with tracing.span("sam.preprocess"):
            image_rgb = np.asarray(image_rgb)
            if image_rgb.dtype != np.uint8:
                image_rgb = (np.clip(image_rgb, 0, 1) * 255).astype(np.uint8)
            pixels = proc(images=image_rgb,
                          return_tensors="pt")["pixel_values"]
            tracing.count("host_wait.sam_upload")
            pixels = pixels.to(dev)
        emb = model.get_image_embeddings(pixels)[0].float()
    # SAM pads the long side to the input size: the embedding region
    # covering the image is g * short/long along the short axis (a view)
    h, w = image_rgb.shape[:2]
    if h > w:
        return emb[:, :, :max(1, round(g * w / h))]
    if w > h:
        return emb[:, :max(1, round(g * h / w)), :]
    return emb


def export_embedding(emb: torch.Tensor) -> torch.Tensor:
    """An embedding as the export saves it: fp16, contiguous, on the host
    (the copy waits on the card)."""
    tracing.count("host_wait.sam_embedding")
    return emb.to(torch.float16).contiguous().cpu()


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
        emb = export_embedding(encode_image(img, device=dev))
        base = os.path.join(args.output, stem + "_fmap_CxHxW")
        np.save(base + ".npy", emb.numpy())
        torch.save(emb, base + ".pt")
        print(f"[{i + 1}/{len(names)}] {name} -> {tuple(emb.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
