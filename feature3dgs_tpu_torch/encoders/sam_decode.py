"""Promptable segmentation from RENDERED SAM embeddings, on the card.

Port of ``feature3dgs_tpu/encoders/sam_decode.py`` (the original
encoders/sam_encoder/segment_prompt.py and segment.py). The original forks
segment-anything to accept precomputed ``features=`` (automatic_mask_
generator.py:137-237, predictor.py:38-98) so masks are decoded from
embeddings the Gaussian model rendered instead of the image encoder;
transformers' SamModel takes ``image_embeddings=``, so the rendered
(aspect-cropped) embedding is padded back to 64x64 and only the prompt
encoder and mask decoder run.

Everything stays on the model's device: the embedding, the mask logits
(a batch of 64 points x 3 masks at 1216x800 is ~750 MB of float32), the
stability scores, boxes and ``box_nms``'s IoUs and greedy pass; the host
gets the kept records' scalars and a caller copies the masks it keeps.
Prompt coordinates are scaled with the processor's closed-form rules
(SamProcessor._normalize_coordinates, SamImageProcessor.
_get_preprocess_shape), in the dtypes the processor would produce, so no
dummy image is resized. The geometry helpers of segment_anything/utils/
amg.py are numpy where they make host lists and torch where they touch
masks.
"""
from __future__ import annotations

import itertools
import math
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from feature3dgs_tpu_torch.encoders.sam_encoder import load_sam

# segment-anything mask decoding constants (modeling/sam.py mask_threshold,
# automatic_mask_generator.py stability_score_offset)
MASK_THRESHOLD = 0.0
STABILITY_OFFSET = 1.0


def _model(sam, device):
    model, proc = sam if sam is not None else load_sam(device)
    return model, proc, next(model.parameters()).device


def pad_embedding(emb_chw, device) -> torch.Tensor:
    """A rendered embedding [256,h,w] (aspect-cropped, numpy or a tensor)
    zero-padded back to [1, 256, 64, 64] float32 on ``device``."""
    emb = torch.as_tensor(emb_chw).to(device, torch.float32)
    c, h, w = emb.shape
    out = torch.zeros((1, c, 64, 64), device=device)
    out[0, :, :h, :w] = emb
    return out


def _frame(proc, h: int, w: int) -> tuple[int, int]:
    """The resized (h, w) that SAM's processor gives an h x w image."""
    target = proc.image_processor.size["longest_edge"]
    scale = target * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


@torch.no_grad()
def decode_masks(emb_chw, image_hw: tuple[int, int], points=None,
                 boxes=None, labels=None, return_logits: bool = False,
                 sam=None, device=None):
    """Masks for point/box prompts from a [256,h,w] embedding.

    points: [[x, y], ...] in original-image pixel coords; boxes: [[x0, y0,
    x1, y1], ...]. Returns (masks [M, H, W] bool, iou_scores [M]) on the
    model's device; with ``return_logits`` the masks are float logits
    (threshold at MASK_THRESHOLD for the binary mask)."""
    model, proc, dev = _model(sam, device)
    h, w = image_hw
    rh, rw = _frame(proc, h, w)
    scale = np.array([rw / w, rh / h])
    kwargs = {}
    if points is not None:
        pts = np.asarray([[list(map(float, p)) for p in points]]) * scale
        kwargs["input_points"] = torch.from_numpy(pts)[:, None].to(dev)
        lab = np.array([list(labels or [1] * len(points))])
        kwargs["input_labels"] = torch.from_numpy(lab)[:, None].to(dev)
    if boxes is not None:
        bx = np.asarray([[list(map(float, b)) for b in boxes]])
        bx = (bx.reshape(1, -1, 2, 2) * scale).reshape(1, -1, 4)
        kwargs["input_boxes"] = torch.from_numpy(bx).to(dev)
    out = model(image_embeddings=pad_embedding(emb_chw, dev),
                multimask_output=True, **kwargs)
    masks = proc.image_processor.post_process_masks(
        out.pred_masks, [[h, w]], [[rh, rw]], binarize=not return_logits)[0]
    return masks[0], out.iou_scores[0, 0]


def stability_score(logits, offset: float = STABILITY_OFFSET,
                    threshold: float = MASK_THRESHOLD) -> float:
    """IoU between the masks obtained by thresholding the logits at
    ``threshold +/- offset`` (segment_anything/utils/amg.py's
    calculate_stability_score): stable masks barely change."""
    logits = torch.as_tensor(logits)
    hi = float((logits > threshold + offset).sum())
    lo = float((logits > threshold - offset).sum())
    return hi / max(lo, 1.0)


# ---- segment_anything/utils/amg.py geometry helpers ----------------------

def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n^2, 2] grid of (x, y) points evenly spaced in [0,1]^2
    (amg.py:179-187)."""
    offset = 1 / (2 * n_per_side)
    one = np.linspace(offset, 1 - offset, n_per_side)
    xs = np.tile(one[None, :], (n_per_side, 1))
    ys = np.tile(one[:, None], (1, n_per_side))
    return np.stack([xs, ys], -1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> list[np.ndarray]:
    """Layer i uses n_per_side / scale^i points per side (amg.py:189-198)."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: tuple[int, int], n_layers: int,
                        overlap_ratio: float):
    """(crop_boxes xyxy, layer_idxs): the full image plus (2^i)^2
    overlapping crops per layer i (amg.py:200-234)."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes, layer_idxs = [[0, 0, im_w, im_h]], [0]

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_side))
        crop_w = crop_len(im_w, n_side, overlap)
        crop_h = crop_len(im_h, n_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_side)]
        for x0, y0 in itertools.product(x0s, y0s):
            crop_boxes.append(
                [x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def batched_mask_to_box(masks) -> torch.Tensor:
    """[M,H,W] bool -> [M,4] float64 xyxy boxes on the masks' device;
    right/bottom edges are inclusive pixel indices, as in the reference,
    and all-zero masks give [0,0,0,0] (amg.py:303-336)."""
    masks = torch.as_tensor(masks).bool()
    m, h, w = masks.shape
    any_row = masks.any(2)   # [M,H]
    any_col = masks.any(1)   # [M,W]
    empty = ~any_row.any(1)
    ys = torch.arange(h, device=masks.device)[None, :]
    xs = torch.arange(w, device=masks.device)[None, :]
    y0 = torch.where(any_row, ys, h).amin(1)
    y1 = torch.where(any_row, ys, -1).amax(1)
    x0 = torch.where(any_col, xs, w).amin(1)
    x1 = torch.where(any_col, xs, -1).amax(1)
    boxes = torch.stack([x0, y0, x1, y1], 1).double()
    boxes[empty] = 0
    return boxes


def is_box_near_crop_edge(boxes, crop_box, orig_box,
                          atol: float = 20.0) -> torch.Tensor:
    """True for boxes at a crop edge but not at the original image edge
    (amg.py:78-89); ``boxes`` already in the ORIGINAL frame."""
    boxes = torch.as_tensor(boxes, dtype=torch.float64)
    crop = torch.tensor(crop_box, dtype=torch.float64, device=boxes.device)
    orig = torch.tensor(orig_box, dtype=torch.float64, device=boxes.device)
    near_crop = torch.isclose(boxes, crop[None], atol=atol, rtol=0)
    near_orig = torch.isclose(boxes, orig[None], atol=atol, rtol=0)
    return (near_crop & ~near_orig).any(1)


def box_nms(boxes, scores, iou_thresh: float) -> torch.Tensor:
    """Greedy box NMS on the boxes' device: the indices kept, in the
    order visited, as the numpy greedy loop of the JAX package keeps them
    (its stand-in for torchvision's batched_nms with one category,
    automatic_mask_generator.py:213-219, 250-256). The visiting order is
    numpy's argsort of the negated scores, taken on the host (the scores
    are host floats in ``auto_masks``), so tied scores fall as in the JAX
    package. IoUs in float64; box j falls to an earlier kept box i when
    their IoU passes the threshold. The greedy set is the fixed point of
    ``keep[j] = not any(keep[i] and suppresses[i, j] for i < j)``: each
    round settles at least the next box, so the rounds stop once the set
    stops changing (one host read a round, a few rounds in practice)."""
    boxes = torch.as_tensor(boxes, dtype=torch.float64)
    if isinstance(scores, torch.Tensor):
        scores = scores.cpu().numpy()
    n = boxes.shape[0]
    order = torch.from_numpy(np.argsort(-np.asarray(scores))).to(
        boxes.device)
    b = boxes[order]
    areas = (torch.clamp_min(b[:, 2] - b[:, 0], 0)
             * torch.clamp_min(b[:, 3] - b[:, 1], 0))
    x0 = torch.maximum(b[:, None, 0], b[None, :, 0])
    y0 = torch.maximum(b[:, None, 1], b[None, :, 1])
    x1 = torch.minimum(b[:, None, 2], b[None, :, 2])
    y1 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
    iou = inter / torch.clamp_min(areas[:, None] + areas[None, :] - inter,
                                  1e-9)
    suppresses = torch.triu(iou > iou_thresh, diagonal=1)
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    while True:
        nxt = ~(suppresses & keep[:, None]).any(0)
        if torch.equal(nxt, keep):
            return order[keep]
        keep = nxt


@torch.no_grad()
def _decode_point_batch(emb_chw, image_hw: tuple[int, int], points,
                        sam=None, device=None):
    """Decode a batch of SINGLE-point prompts in one model call: (logits
    [P,3,H,W], iou_preds [P,3]) at ``image_hw``, on the model's device."""
    model, proc, dev = _model(sam, device)
    h, w = image_hw
    rh, rw = _frame(proc, h, w)
    pts = np.asarray(points, np.float64) * np.array([rw / w, rh / h])
    input_points = torch.from_numpy(pts[None, :, None, :]).float().to(dev)
    input_labels = torch.ones(input_points.shape[:-1], dtype=torch.int64,
                              device=dev)
    out = model(image_embeddings=pad_embedding(emb_chw, dev),
                input_points=input_points, input_labels=input_labels,
                multimask_output=True)
    logits = proc.image_processor.post_process_masks(
        out.pred_masks, [(h, w)], [(rh, rw)], binarize=False)[0]
    return logits, out.iou_scores[0]


@torch.no_grad()
def auto_masks(emb_chw, image_hw: tuple[int, int],
               points_per_side: int = 16, points_per_batch: int = 64,
               pred_iou_thresh: float = 0.88,
               stability_thresh: float = 0.95,
               box_nms_thresh: float = 0.7, crop_n_layers: int = 0,
               crop_nms_thresh: float = 0.7,
               crop_overlap_ratio: float = 512 / 1500,
               crop_n_points_downscale_factor: int = 1, sam=None,
               device=None):
    """Automatic (prompt-free) mask generation from a rendered embedding:
    the reference's SamAutomaticMaskGenerator protocol fed with
    ``features=`` (automatic_mask_generator.py:137-270): crop layers (the
    fork reuses the SAME embedding for every crop, predictor.py:92-98),
    a per-layer point grid, 3 multimask candidates per point,
    predicted-IoU and stability filtering, crop-edge box rejection,
    per-crop box NMS, and cross-crop NMS preferring smaller crops.

    Returns a list of {"segmentation" bool [H,W] on the device, "area",
    "bbox" xywh, "predicted_iou", "point_coords", "stability_score",
    "crop_box" xywh} sorted by area (desc), the reference's records."""
    model, proc, dev = _model(sam, device)
    sam = (model, proc)
    emb = pad_embedding(emb_chw, dev)[0]
    orig_h, orig_w = image_hw
    crop_boxes, layer_idxs = generate_crop_boxes(
        image_hw, crop_n_layers, crop_overlap_ratio)
    grids = build_all_layer_point_grids(
        points_per_side, crop_n_layers, crop_n_points_downscale_factor)

    all_recs: list[dict] = []
    for crop_box, layer in zip(crop_boxes, layer_idxs):
        x0, y0, x1, y1 = crop_box
        crop_hw = (y1 - y0, x1 - x0)
        pts = grids[layer] * np.array([crop_hw[1], crop_hw[0]])[None]
        crop_recs: list[dict] = []
        for s in range(0, len(pts), points_per_batch):
            batch = pts[s: s + points_per_batch]
            logits, ious = _decode_point_batch(emb, crop_hw, batch, sam)
            lg = logits.reshape(-1, *crop_hw)          # [P*3, h, w]
            sc = ious.reshape(-1)
            pt = torch.from_numpy(np.repeat(batch, logits.shape[1], 0))
            keep = sc > pred_iou_thresh
            hi = (lg > MASK_THRESHOLD + STABILITY_OFFSET).sum((1, 2))
            lo = (lg > MASK_THRESHOLD - STABILITY_OFFSET).sum((1, 2))
            stab = hi.double() / torch.clamp_min(lo, 1).double()
            keep &= stab >= stability_thresh
            idx = torch.nonzero(keep)[:, 0]
            if not len(idx):
                continue
            masks = lg[idx] > MASK_THRESHOLD
            boxes = batched_mask_to_box(masks)
            boxes += torch.tensor([x0, y0, x0, y0], dtype=torch.float64,
                                  device=dev)[None]  # uncrop
            edge = is_box_near_crop_edge(boxes, crop_box,
                                         [0, 0, orig_w, orig_h])
            inner = torch.nonzero(~edge)[:, 0]
            full = torch.zeros((len(inner), orig_h, orig_w), dtype=torch.bool,
                               device=dev)
            full[:, y0:y1, x0:x1] = masks[inner]
            areas = masks[inner].sum((1, 2)).tolist()
            picked = idx[inner]
            scores, stabs = sc[picked].tolist(), stab[picked].tolist()
            points = pt[picked.cpu()].tolist()
            for j in range(len(inner)):
                crop_recs.append({
                    "segmentation": full[j], "area": int(areas[j]),
                    "box_xyxy": boxes[inner[j]],
                    "predicted_iou": scores[j],
                    "point_coords": [[points[j][0] + x0, points[j][1] + y0]],
                    "stability_score": stabs[j],
                    "crop_box": crop_box})
        if crop_recs:  # per-crop NMS on predicted IoU
            keep = box_nms(torch.stack([r["box_xyxy"] for r in crop_recs]),
                           [r["predicted_iou"] for r in crop_recs],
                           box_nms_thresh)
            all_recs.extend(crop_recs[i] for i in keep.tolist())

    if len(crop_boxes) > 1 and all_recs:  # cross-crop NMS, smaller wins
        def crop_area(r):
            cb = r["crop_box"]
            return (cb[2] - cb[0]) * (cb[3] - cb[1])
        keep = box_nms(torch.stack([r["box_xyxy"] for r in all_recs]),
                       [1.0 / crop_area(r) for r in all_recs],
                       crop_nms_thresh)
        all_recs = [all_recs[i] for i in keep.tolist()]

    for r in all_recs:
        b = r.pop("box_xyxy").tolist()
        cb = r["crop_box"]
        r["bbox"] = [b[0], b[1], b[2] - b[0], b[3] - b[1]]
        r["crop_box"] = [cb[0], cb[1], cb[2] - cb[0], cb[3] - cb[1]]
    all_recs.sort(key=lambda d: -d["area"])
    return all_recs


def main(argv=None) -> int:
    from feature3dgs_tpu_torch import default_device
    parser = ArgumentParser()
    parser.add_argument("--feature", required=True,
                        help="rendered embedding .npy/.pt (CxHxW)")
    parser.add_argument("--image_size", nargs=2, type=int, required=True)
    parser.add_argument("--point", nargs=2, type=float, action="append",
                        required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    dev = default_device(args.device)

    if args.feature.endswith(".npy"):
        emb = torch.from_numpy(np.load(args.feature).astype(np.float32))
    else:
        emb = torch.load(args.feature, map_location=dev).float()
    masks, scores = decode_masks(emb, tuple(args.image_size),
                                 points=args.point, device=dev)
    from PIL import Image
    best = masks[int(torch.argmax(scores))].cpu().numpy()
    Image.fromarray((best * 255).astype(np.uint8)).save(args.output)
    print(f"saved best mask (iou {float(scores.max()):.3f}) -> "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
