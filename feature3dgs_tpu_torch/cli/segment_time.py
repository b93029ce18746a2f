"""Mask-decoding throughput: SAM masks from rendered embeddings against
masks through the image encoder, on the card.

    python -m feature3dgs_tpu_torch.cli.segment_time --feature_dir <dir>
        [--image_dir <images>] [--points 8] [--limit 10] [--device cpu]

The port of ``scripts/segment_time.py`` (the original encoders/
sam_encoder/segment_time.py:132-147): masks/s decoded (a) from RENDERED
SAM embeddings (``*_fmap_CxHxW.npy``, stride 16), the Feature-3DGS claim
of skipping the ViT-H image encoder at inference, and (b) from the
matching images through the full encoder, with their ratio. SAM weights
come from SAM_MODEL_PATH or the cache; without them it prints so and exits
0, as the script does. ``time_decoding`` takes a built model, so other
callers time the same loop.
"""
from __future__ import annotations

import glob
import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch


def _clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _random_points(rng, n: int, h: int, w: int):
    return np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], axis=1)


def time_decoding(sam, embeddings, images=None, points: int = 8,
                  rng=None) -> dict:
    """Decode ``points`` single-point prompts (uniform random, from
    ``rng``) per embedding [256,h,w] (image h*16 x w*16), then per image
    [H,W,3] through ``sam_encoder.encode_image`` and the decoder; one
    warm-up decode (and encode) first, the device synchronized before
    every clock read. Returns mask counts, seconds and masks/s of each
    path and, with images, the encoder path's slowdown."""
    from feature3dgs_tpu_torch.encoders.sam_decode import decode_masks
    from feature3dgs_tpu_torch.encoders.sam_encoder import encode_image
    rng = rng or np.random.RandomState(0)
    dev = next(sam[0].parameters()).device
    out = {}

    def decode(emb, hw, p):
        return decode_masks(emb, hw, points=[p.tolist()], sam=sam)[0].shape[0]

    if embeddings:
        e0 = embeddings[0]
        decode(e0, (e0.shape[1] * 16, e0.shape[2] * 16), np.array([8.0, 8.0]))
        n, t0 = 0, _clock(dev)
        for emb in embeddings:
            h, w = emb.shape[1] * 16, emb.shape[2] * 16
            for p in _random_points(rng, points, h, w):
                n += decode(emb, (h, w), p)
        dt = _clock(dev) - t0
        out.update(masks_rendered=n, s_rendered=dt,
                   masks_per_s_rendered=n / dt)
    if images:
        decode(encode_image(images[0], sam), images[0].shape[:2],
               np.array([8.0, 8.0]))
        n, t0 = 0, _clock(dev)
        for im in images:
            emb = encode_image(im, sam)
            h, w = im.shape[:2]
            for p in _random_points(rng, points, h, w):
                n += decode(emb, (h, w), p)
        dt = _clock(dev) - t0
        out.update(masks_encoder=n, s_encoder=dt, masks_per_s_encoder=n / dt)
        if embeddings:
            out["slowdown"] = dt / max(out["s_rendered"], 1e-9)
    return out


def main(argv=None) -> int:
    parser = ArgumentParser()
    parser.add_argument("--feature_dir", required=True,
                        help="dir of rendered *_fmap_CxHxW.npy embeddings")
    parser.add_argument("--image_dir", default=None,
                        help="optional dir of matching images for the "
                             "full-encoder comparison")
    parser.add_argument("--points", type=int, default=8,
                        help="prompt points per image")
    parser.add_argument("--limit", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.encoders.sam_encoder import load_sam
    dev = default_device(args.device)
    try:
        sam = load_sam(dev)
    except Exception as e:  # no local checkpoint
        print(f"SAM weights unavailable ({e}); nothing to time.")
        return 0

    feats = sorted(glob.glob(
        os.path.join(args.feature_dir, "*_fmap_CxHxW.npy")))[: args.limit]
    if not feats:
        print(f"no embeddings under {args.feature_dir}")
        return 1
    embs = [torch.from_numpy(np.load(p).astype(np.float32)).to(dev)
            for p in feats]
    images = None
    if args.image_dir:
        from PIL import Image
        images = [np.asarray(Image.open(p).convert("RGB")) for p in sorted(
            glob.glob(os.path.join(args.image_dir, "*")))[: args.limit]]
    r = time_decoding(sam, embs, images, args.points)
    print(f"from rendered embeddings: {r['masks_rendered']} masks in "
          f"{r['s_rendered']:.2f}s = {r['masks_per_s_rendered']:.2f} masks/s")
    if images:
        print(f"from images (full encoder): {r['masks_encoder']} masks in "
              f"{r['s_encoder']:.2f}s = {r['masks_per_s_encoder']:.2f} "
              f"masks/s ({r['slowdown']:.1f}x slower)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
