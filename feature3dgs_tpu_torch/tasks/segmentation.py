"""Novel-view semantic segmentation from rendered feature maps, and the
teacher-vs-student agreement metrics.

Port of ``feature3dgs_tpu/tasks/segmentation.py`` (the inference side of
the original LSeg pipeline, encoders/lseg_encoder/segmentation.py:377-595,
and segmentation_metric.py:58-107): rendered (or decoder-lifted) pixel
features are scored against CLIP text embeddings of the label set by a
normalised dot product and argmax, on tensors. The label-map helpers and
metrics are numpy.
"""
from __future__ import annotations

import numpy as np
import torch

# ADE20K-style palette (repeats past its length)
_PALETTE = np.array([
    [120, 120, 120], [180, 120, 120], [6, 230, 230], [80, 50, 50],
    [4, 200, 3], [120, 120, 80], [140, 140, 140], [204, 5, 255],
    [230, 230, 230], [4, 250, 7], [224, 5, 255], [235, 255, 7],
    [150, 5, 61], [120, 120, 70], [8, 255, 51], [255, 6, 82],
    [143, 255, 140], [204, 255, 4], [255, 51, 7], [204, 70, 3],
    [0, 102, 200], [61, 230, 250], [255, 6, 51], [11, 102, 255],
], np.uint8)


def segment_features(feature_map: torch.Tensor, text_features: torch.Tensor,
                     logit_scale: float = 1.0):
    """[H,W,F] features x [C,F] text embeddings -> (labels [H,W] int32,
    logits [H,W,C]): normalised dot product and argmax
    (segmentation.py:524-543)."""
    f = feature_map / torch.clamp_min(
        torch.linalg.norm(feature_map, dim=-1, keepdim=True), 1e-12)
    t = text_features / torch.clamp_min(
        torch.linalg.norm(text_features, dim=-1, keepdim=True), 1e-12)
    logits = logit_scale * (f @ t.T)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def colorize_labels(labels: np.ndarray) -> np.ndarray:
    """Label map -> palette RGB (uint8)."""
    labels = np.asarray(labels)
    return _PALETTE[labels % len(_PALETTE)]


def legend_entries(labels_map: np.ndarray, label_names,
                   palette: np.ndarray | None = None):
    """(palette RGB image, [(name, rgb float triple) per class present]):
    the data of the original's get_legend_patch (encode_images.py:242-252).
    0-based class id i is drawn with ADE20K palette entry i and named
    label_names[i]; only classes present in the map get an entry."""
    from feature3dgs_tpu_torch.tasks.ade20k import PALETTE
    pal = PALETTE if palette is None else np.asarray(palette, np.uint8)
    labels_map = np.asarray(labels_map)
    img = pal[np.clip(labels_map, 0, len(pal) - 1)]
    entries = [(label_names[i], (pal[i] / 255.0).tolist())
               for i in np.unique(labels_map) if i < len(label_names)]
    return img, entries


def pixel_accuracy(pred: np.ndarray, gt: np.ndarray) -> float:
    """Share of equal labels (loss_utils.py:78-81)."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    return float((pred == gt).sum() / gt.size)


def mean_iou(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> float:
    """Per-class IoU averaged over the classes present in either map
    (loss_utils.py:84-93)."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    ious = []
    for c in range(num_classes):
        p, g = pred == c, gt == c
        union = np.logical_or(p, g).sum()
        ious.append(np.nan if union == 0
                    else np.logical_and(p, g).sum() / union)
    return float(np.nanmean(ious))


# The Replica protocol's label merges in 1-based ADE20K ids
# (segmentation_metric.py:787-797): TV -> door, rug -> floor,
# pillow -> cushion, applied to teacher and student maps alike.
REPLICA_REMAP = {90: 15, 29: 4, 58: 40}


def replica_remap(labels: np.ndarray, table: dict | None = None) -> np.ndarray:
    """The Replica label merges on a 1-based label map."""
    labels = np.asarray(labels).copy()
    for src, dst in (table or REPLICA_REMAP).items():
        labels[labels == src] = dst
    return labels


def topk_frequent_iou(teacher: np.ndarray, student: np.ndarray,
                      num_classes: int = 7) -> float:
    """The original's calculate_iou (segmentation_metric.py:76-90): IoU
    averaged over the ``num_classes`` labels most frequent in the teacher
    and student maps together (the Replica protocol's 7-class mIoU)."""
    teacher, student = np.asarray(teacher), np.asarray(student)
    unique_labels, counts = np.unique(
        np.concatenate((teacher.ravel(), student.ravel())),
        return_counts=True)
    sorted_labels = unique_labels[np.argsort(-counts)]
    ious = []
    for c in sorted_labels[:num_classes]:
        p, g = student == c, teacher == c
        union = np.logical_or(p, g).sum()
        ious.append(np.nan if union == 0
                    else np.logical_and(p, g).sum() / union)
    return float(np.nanmean(ious))


def resize_labels_nearest(labels: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour label-map resize as torch's
    F.interpolate(mode='nearest') picks: source index floor(i * in / out)
    (segmentation_metric.py:801-807)."""
    labels = np.asarray(labels)
    src_h, src_w = labels.shape[-2:]
    rows = (np.arange(h) * src_h // h).clip(max=src_h - 1)
    cols = (np.arange(w) * src_w // w).clip(max=src_w - 1)
    return labels[..., rows[:, None], cols[None, :]]
