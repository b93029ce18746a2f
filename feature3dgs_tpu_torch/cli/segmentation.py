"""Segmentation CLI: novel-view semantic segmentation of rendered features.

    python -m feature3dgs_tpu_torch.cli.segmentation --feature_dir <dir> \\
        --output <dir> [--label_src a,b,c] [--text_features t.npy]

The port of ``scripts/segmentation.py`` (the original
encoders/lseg_encoder/segmentation.py:377-595), with its flags: the
``saved_feature/`` maps of the render CLI are scored against CLIP text
embeddings of the label set (``--label_src`` or the ADE20K-150 default)
on the card (``--device cpu`` for the CPU); per map it writes
``<stem>_labels.npy``, ``<stem>_mask.png``, with ``--image_dir`` the
``[image | 0.4 image + 0.6 mask | mask]`` strip ``<stem>_vis.png``, and
unless ``--no_legend`` a ``<stem>_legend.png``: the palette mask above the
present classes' swatches and names, drawn with PIL.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def load_feature_map(path: str) -> np.ndarray:
    """A saved CHW feature map (.npy or .pt) as float32."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return torch.load(path, map_location="cpu").float().numpy()


def main(argv=None):
    parser = ArgumentParser(description="Segment rendered feature maps")
    parser.add_argument("--feature_dir", required=True,
                        help=".../saved_feature directory of the render CLI")
    parser.add_argument("--output", required=True)
    parser.add_argument("--label_src", default="default",
                        help="comma-separated label names, or 'default' for "
                             "the ADE20K-150 set")
    parser.add_argument("--text_features", default="",
                        help="precomputed [C,F] .npy (else CLIP, from local "
                             "weights)")
    parser.add_argument("--image_dir", default="",
                        help="rendered/GT RGB dir: also write the "
                             "[img | 0.4*img+0.6*mask | mask] strip *_vis.png")
    parser.add_argument("--no_legend", action="store_true",
                        help="skip the *_legend.png images")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    from PIL import Image

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.tasks import segmentation as seg
    from feature3dgs_tpu_torch.tasks.ade20k import LABELS as ADE20K_LABELS

    device = default_device(args.device)
    if args.label_src == "default":
        labels = list(ADE20K_LABELS)
    else:
        labels = [s.strip() for s in args.label_src.split(",") if s.strip()]
    if args.text_features:
        from feature3dgs_tpu_torch.tasks.clip_text import load_text_features
        text = load_text_features(args.text_features)
    else:
        from feature3dgs_tpu_torch.tasks.clip_text import encode_text
        text = encode_text(labels)
    text = torch.from_numpy(text).to(device)

    os.makedirs(args.output, exist_ok=True)
    names = sorted(n for n in os.listdir(args.feature_dir)
                   if n.endswith((".npy", ".pt")))
    seen = set()
    for n in names:
        stem = n.split("_fmap_")[0]
        if stem in seen:
            continue
        seen.add(stem)
        fmap = load_feature_map(os.path.join(args.feature_dir, n))
        fmap = torch.from_numpy(np.ascontiguousarray(fmap.transpose(1, 2, 0)))
        lab, _ = seg.segment_features(fmap.to(device), text)
        lab = lab.cpu().numpy()
        np.save(os.path.join(args.output, stem + "_labels.npy"), lab)
        Image.fromarray(seg.colorize_labels(lab)).save(
            os.path.join(args.output, stem + "_mask.png"))
        pal_img, entries = seg.legend_entries(lab, labels)
        if args.image_dir:
            write_triptych(args.image_dir, stem, pal_img, args.output)
        if not args.no_legend:
            write_legend(pal_img, entries,
                         os.path.join(args.output, stem + "_legend.png"))
        print(f"{stem}: {len(np.unique(lab))} classes present")
    return 0


def write_triptych(image_dir, stem, pal_img, outdir):
    """[img | 0.4*img+0.6*mask | mask] strip (segmentation.py:553-560)."""
    from PIL import Image
    for ext in (".png", ".jpg", ".jpeg"):
        p = os.path.join(image_dir, stem + ext)
        if os.path.exists(p):
            break
    else:
        return
    img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
    mask = np.asarray(pal_img, np.float32) / 255.0
    if img.shape[:2] != mask.shape[:2]:
        img = np.asarray(Image.fromarray(
            (img * 255).astype(np.uint8)).resize(
                (mask.shape[1], mask.shape[0])), np.float32) / 255.0
    vis = np.concatenate([img, img * 0.4 + mask * 0.6, mask], axis=1)
    Image.fromarray((vis * 255).astype(np.uint8)).save(
        os.path.join(outdir, stem + "_vis.png"))


def write_legend(pal_img, entries, path, columns: int = 4,
                 swatch: int = 12):
    """The palette mask above a legend of the present classes, four a row
    (segmentation.py:567-575), each a colour swatch and its name, drawn
    with PIL's default font."""
    from PIL import Image, ImageDraw, ImageFont
    font = ImageFont.load_default()
    h, w = pal_img.shape[:2]
    cell_w = max(w // columns, swatch + 8 + 6 * max(
        [len(name) for name, _ in entries] or [1]))
    row_h = swatch + 6
    rows = -(-len(entries) // columns)
    canvas = Image.new("RGB", (max(w, cell_w * columns), h + rows * row_h + 6),
                       (255, 255, 255))
    canvas.paste(Image.fromarray(np.asarray(pal_img, np.uint8)), (0, 0))
    draw = ImageDraw.Draw(canvas)
    for i, (name, rgb) in enumerate(entries):
        x = (i % columns) * cell_w + 3
        y = h + 6 + (i // columns) * row_h
        color = tuple(int(round(c * 255)) for c in rgb)
        draw.rectangle([x, y, x + swatch, y + swatch], fill=color,
                       outline=(0, 0, 0))
        draw.text((x + swatch + 4, y), name, fill=(0, 0, 0), font=font)
    canvas.save(path)


if __name__ == "__main__":
    sys.exit(main())
