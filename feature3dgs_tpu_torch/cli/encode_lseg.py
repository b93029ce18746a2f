"""LSeg teacher feature export on the card.

    python -m feature3dgs_tpu_torch.cli.encode_lseg --input <images>
        --outdir <scene>/rgb_feature_langseg [--checkpoint demo_e200.ckpt]
        [--scales 1.0 ...] [--stride 1] [--fallback_clip] [--no_vis]
        [--device cpu]

The port of ``scripts/encode_lseg.py`` (the original encoders/lseg_encoder/
encode_images.py), with its flags and outputs: per image a 512-d
CLIP-aligned feature map as ``<name>_fmap_CxHxW.pt`` and ``.npy`` (fp16
CHW), ready for ``cli.train -f lseg``, and unless ``--no_vis`` a
``pca_dict.pt`` fit on the first image and a ``<name>_feature_vis.png``
per image. The LSeg network (``encoders/lseg_net.py``) runs with the
checkpoint in ``--checkpoint`` or LSEG_WEIGHTS; ``--fallback_clip`` uses
the MaskCLIP-style stand-in (``encoders/clip_pixel.py``, CLIP_MODEL_PATH)
when there is none. The networks run on the CUDA card (``--device cpu``
for the CPU).
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def main(argv=None) -> int:
    ap = ArgumentParser()
    ap.add_argument("--input", required=True, help="directory of images")
    ap.add_argument("--outdir", required=True,
                    help="e.g. <scene>/rgb_feature_langseg")
    ap.add_argument("--checkpoint", default=None,
                    help="LSeg checkpoint (default: $LSEG_WEIGHTS)")
    ap.add_argument("--scales", type=float, nargs="+", default=[1.0],
                    help="multi-scale averaging (the reference evaluator "
                         "uses 0.75 1.0 1.25 1.75, encode_images.py:353)")
    ap.add_argument("--stride", type=int, default=1,
                    help="save maps at image size / stride")
    ap.add_argument("--fallback_clip", action="store_true",
                    help="use the dense-CLIP substitute when no LSeg "
                         "checkpoint is available")
    ap.add_argument("--no_vis", action="store_true",
                    help="skip pca_dict.pt + per-image *_feature_vis.png "
                         "(the reference always writes them, "
                         "encode_images.py:488-514)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.encoders import lseg_net
    dev = default_device(args.device)
    net = lseg_net.load_lseg_checkpoint(args.checkpoint, dev)
    use_clip = False
    if net is None:
        if not args.fallback_clip:
            raise SystemExit(
                "no LSeg checkpoint (set LSEG_WEIGHTS or --checkpoint); "
                "pass --fallback_clip for the dense-CLIP substitute")
        from feature3dgs_tpu_torch.encoders import clip_pixel
        use_clip = True
        print("WARNING: using the MaskCLIP-style substitute encoder "
              "(no LSeg checkpoint available)")

    from PIL import Image
    os.makedirs(args.outdir, exist_ok=True)
    names = [n for n in sorted(os.listdir(args.input))
             if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    pca_basis = None  # fit on the 1st image, reused for every view so the
    # vis colors are consistent across a sequence (encode_images.py:488-505)
    for i, name in enumerate(names):
        stem = os.path.splitext(name)[0]
        img = np.asarray(
            Image.open(os.path.join(args.input, name)).convert("RGB"),
            np.float32) / 255.0
        if use_clip:
            hw = (img.shape[0] // args.stride, img.shape[1] // args.stride)
            fmap = clip_pixel.encode_image(
                (img * 255).astype(np.uint8), hw, device=dev
            ).to(torch.float16).contiguous().cpu()
        else:
            fmap = lseg_net.export_features(img, net, tuple(args.scales),
                                            args.stride)
        base = os.path.join(args.outdir, stem + "_fmap_CxHxW")
        torch.save(fmap, base + ".pt")
        np.save(base + ".npy", fmap.numpy())
        if not args.no_vis:
            pca_basis = _save_feature_vis(fmap.numpy(), pca_basis,
                                          args.outdir, stem)
        print(f"[{i + 1}/{len(names)}] {name} -> {tuple(fmap.shape)}")
    return 0


def _save_feature_vis(fmap_chw, basis, outdir, stem):
    """Shared-basis PCA visualization of one CHW map: a 3-component PCA fit
    on the FIRST image (every 3rd pixel of the L2-normalized map), saved as
    ``pca_dict.pt`` and reused for every later view so the colors stay
    consistent across a sequence (encode_images.py:488-514). The dict holds
    the tensors the reference writes (feature_pca_mean / components,
    postprocess sub / div), fit by numpy SVD, not the pickled sklearn PCA
    object, which no reference code reloads."""
    from PIL import Image
    flat = np.asarray(fmap_chw, np.float32).reshape(fmap_chw.shape[0], -1).T
    flat /= np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-12)
    if basis is None:
        samples = flat[::3]
        mean = samples.mean(0)
        centered = samples - mean
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        comps = vt[:3]
        q1, q99 = np.percentile(centered @ comps.T, [1, 99])
        basis = (mean, comps, q1, max(q99 - q1, 1e-12))
        torch.save({"feature_pca_mean": torch.from_numpy(mean),
                    "feature_pca_components": torch.from_numpy(comps),
                    "feature_pca_postprocess_sub": float(q1),
                    "feature_pca_postprocess_div": float(basis[3])},
                   os.path.join(outdir, "pca_dict.pt"))
    mean, comps, q1, div = basis
    vis = np.clip(((flat - mean) @ comps.T - q1) / div, 0.0, 1.0)
    vis = vis.reshape(*fmap_chw.shape[1:], 3)
    Image.fromarray((vis * 255).astype(np.uint8)).save(
        os.path.join(outdir, stem + "_feature_vis.png"))
    return basis


if __name__ == "__main__":
    sys.exit(main())
