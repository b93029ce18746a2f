"""Segmentation-metric CLI: teacher-vs-student segmentation agreement.

    python -m feature3dgs_tpu_torch.cli.segmentation_metric \\
        --student_dir <saved_feature> --teacher_dir <feature dir> \\
        --label_src a,b,c [--text_features t.npy] [--output out.json]

The port of ``scripts/segmentation_metric.py`` (the original
encoders/lseg_encoder/segmentation_metric.py:58-107,780-833), with its
flags: labels from rendered (student) and teacher feature maps, both
scored against the same text embeddings on the card (``--device cpu`` for
the CPU), per-image pixel accuracy and mIoU, their means, and with
``--output`` a JSON of the same keys. Default: features resized bilinearly
(align corners) to ``--resize`` W H, mIoU over the label set.
``--replica_protocol``: labels argmaxed at the native resolution in 1-based
ADE20K ids, the Replica merges applied, the label maps nearest-resized,
mIoU over the 7 most frequent classes.
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def main(argv=None):
    parser = ArgumentParser(description="Teacher-vs-student segmentation "
                                        "agreement")
    parser.add_argument("--student_dir", required=True,
                        help="rendered saved_feature dir")
    parser.add_argument("--teacher_dir", required=True,
                        help="dataset feature dir (e.g. rgb_feature_langseg)")
    parser.add_argument("--label_src", required=True)
    parser.add_argument("--text_features", default="")
    parser.add_argument("--resize", nargs=2, type=int, default=[159, 119],
                        help="comparison resolution W H (the original uses "
                             "159x119, segmentation_metric.py:795)")
    parser.add_argument("--replica_protocol", action="store_true",
                        help="the published Replica protocol "
                             "(segmentation_metric.py:780-833)")
    parser.add_argument("--output", default="")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.cli.segmentation import load_feature_map
    from feature3dgs_tpu_torch.tasks import segmentation as seg
    from feature3dgs_tpu_torch.train.losses import \
        resize_bilinear_align_corners

    device = default_device(args.device)
    labels = [s.strip() for s in args.label_src.split(",") if s.strip()]
    if args.text_features:
        from feature3dgs_tpu_torch.tasks.clip_text import load_text_features
        text = load_text_features(args.text_features)
    else:
        from feature3dgs_tpu_torch.tasks.clip_text import encode_text
        text = encode_text(labels)
    text = torch.from_numpy(text).to(device)
    w, h = args.resize

    def labels_for(path):
        fmap = torch.from_numpy(np.ascontiguousarray(
            load_feature_map(path).transpose(1, 2, 0))).to(device)
        if args.replica_protocol:
            # argmax at the native resolution, 1-based ids, the Replica
            # merges, then the LABEL map nearest-resized
            lab, _ = seg.segment_features(fmap, text)
            lab = seg.replica_remap(lab.cpu().numpy() + 1)
            return seg.resize_labels_nearest(lab, h, w)
        lab, _ = seg.segment_features(
            resize_bilinear_align_corners(fmap, h, w), text)
        return lab.cpu().numpy()

    is_map = lambda n: "_fmap_" in n and n.endswith((".npy", ".pt"))
    students = sorted(n for n in os.listdir(args.student_dir) if is_map(n))
    # student renders are numbered, teachers named by image: paired in
    # sorted order, as the original's loaders pair them
    teachers = sorted(n for n in os.listdir(args.teacher_dir) if is_map(n))
    accs, mious, rows = [], [], []
    for n, t_name in zip(students, teachers):
        s_lab = labels_for(os.path.join(args.student_dir, n))
        t_lab = labels_for(os.path.join(args.teacher_dir, t_name))
        acc = seg.pixel_accuracy(s_lab, t_lab)
        miou = (seg.topk_frequent_iou(t_lab, s_lab, 7)
                if args.replica_protocol
                else seg.mean_iou(s_lab, t_lab, len(labels)))
        accs.append(acc)
        mious.append(miou)
        rows.append({"student": n, "teacher": t_name, "accuracy": acc,
                     "miou": miou})
        print(f"{n}: acc {acc:.4f} mIoU {miou:.4f}")
    summary = {"mean_accuracy": float(np.mean(accs)) if accs else None,
               "mean_miou": float(np.mean(mious)) if mious else None,
               "per_image": rows}
    print(f"MEAN: acc {summary['mean_accuracy']} mIoU {summary['mean_miou']}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
