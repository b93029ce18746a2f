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
(a batch of 64 points x 3 masks at 1216x800 is ~750 MB of float32), their
post-processing (``postprocess_masks``, segment-anything's own, with
``F.interpolate`` on the device whatever ``transformers``' processor does),
the stability scores, boxes and ``box_nms``'s IoUs and greedy pass; the
host gets the kept records' scalars and a caller copies the masks it keeps.
Prompt coordinates are scaled with the processor's closed-form rules
(SamProcessor._normalize_coordinates, SamImageProcessor.
_get_preprocess_shape), in the dtypes the processor would produce, so no
dummy image is resized. The geometry helpers of segment_anything/utils/
amg.py are numpy where they make host lists and torch where they touch
masks.

Spans (``tracing.py``): ``sam.decode``, each call of the model (a hook set
by ``sam_encoder.build_sam`` / ``load_sam``: the prompt encoder and mask
decoder), ``sam.postprocess`` after it (and in ``auto_masks`` once more a
crop, for the masks its NMS kept), and in ``auto_masks`` ``sam.select``:
one a point batch (the IoU and stability filters, the boxes, the uncrop
and the crop-edge test), one a crop (its box NMS) and one a call (the
cross-crop NMS and the records' boxes). Counters
``sam.prompts`` (prompts decoded), ``sam.candidates`` (masks past both
filters), ``sam.masks`` (records returned) and ``host_wait.sam_<site>`` at
each read of the card's values on the host (``candidates``, one a point
batch; ``nms``, one a round; ``nms_keep``) and each copy from the host to
the card (``prompt_upload``, ``emb_upload``, ``box_upload``,
``order_upload``, ``index_upload``), which waits on it too.
"""
from __future__ import annotations

import itertools
import math
import sys
from argparse import ArgumentParser

import numpy as np
import torch
import torch.nn.functional as F

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.encoders.sam_encoder import load_sam

# segment-anything mask decoding constants (modeling/sam.py mask_threshold,
# automatic_mask_generator.py stability_score_offset)
MASK_THRESHOLD = 0.0
STABILITY_OFFSET = 1.0


def _model(sam, device):
    model, proc = sam if sam is not None else load_sam(device)
    return model, proc, next(model.parameters()).device


def _upload(t: torch.Tensor, device, site: str) -> torch.Tensor:
    """``t`` on ``device``; a copy there from the host waits on the card,
    counted as ``host_wait.<site>``."""
    if t.device.type != torch.device(device).type:
        tracing.count(f"host_wait.{site}")
    return t.to(device)


def pad_embedding(emb_chw, device, grid: int = 64) -> torch.Tensor:
    """A rendered embedding [256,h,w] (aspect-cropped, numpy or a tensor)
    zero-padded back to [1, 256, grid, grid] float32 on ``device`` (64 x 64
    at SAM's published input size)."""
    emb = _upload(torch.as_tensor(emb_chw), device,
                  "sam_emb_upload").to(torch.float32)
    c, h, w = emb.shape
    out = torch.zeros((1, c, grid, grid), device=device)
    out[0, :, :h, :w] = emb
    return out


def _frame(proc, h: int, w: int) -> tuple[int, int]:
    """The resized (h, w) that SAM's processor gives an h x w image."""
    target = proc.image_processor.size["longest_edge"]
    scale = target * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _sizes(model) -> tuple[int, int]:
    """(the model's square input side, its embedding grid side)."""
    pe = model.config.prompt_encoder_config
    return pe.image_size, pe.image_embedding_size


def postprocess_masks(low_res: torch.Tensor, input_hw: tuple[int, int],
                      image_hw: tuple[int, int], size: int) -> torch.Tensor:
    """segment-anything's ``Sam.postprocess_masks`` (modeling/sam.py) on the
    logits' device: [B, C, h, w] low-resolution mask logits upsampled
    bilinearly to the ``size`` x ``size`` input, cropped to the resized
    image ``input_hw`` and resized bilinearly to ``image_hw``; float
    logits, no threshold."""
    x = F.interpolate(low_res, (size, size), mode="bilinear",
                      align_corners=False)
    x = x[..., :input_hw[0], :input_hw[1]]
    return F.interpolate(x, image_hw, mode="bilinear", align_corners=False)


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
    size, grid = _sizes(model)
    h, w = image_hw
    rh, rw = _frame(proc, h, w)
    scale = np.array([rw / w, rh / h])
    kwargs = {}
    if points is not None:
        pts = np.asarray([[list(map(float, p)) for p in points]]) * scale
        kwargs["input_points"] = _upload(torch.from_numpy(pts)[:, None],
                                         dev, "sam_prompt_upload")
        lab = np.array([list(labels or [1] * len(points))])
        kwargs["input_labels"] = _upload(torch.from_numpy(lab)[:, None],
                                         dev, "sam_prompt_upload")
    if boxes is not None:
        bx = np.asarray([[list(map(float, b)) for b in boxes]])
        bx = (bx.reshape(1, -1, 2, 2) * scale).reshape(1, -1, 4)
        kwargs["input_boxes"] = _upload(torch.from_numpy(bx), dev,
                                        "sam_prompt_upload")
    out = model(image_embeddings=pad_embedding(emb_chw, dev, grid),
                multimask_output=True, **kwargs)
    tracing.count("sam.prompts", out.pred_masks.shape[1])
    with tracing.span("sam.postprocess"):
        masks = postprocess_masks(out.pred_masks[0], (rh, rw), (h, w), size)
    if not return_logits:
        masks = masks > MASK_THRESHOLD
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

    def near(edges):    # torch.isclose(rtol=0), column by column
        return torch.stack([(boxes[:, i] - float(e)).abs() <= atol
                            for i, e in enumerate(edges)], 1)

    return (near(crop_box) & ~near(orig_box)).any(1)


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
    stops changing (one host read a round, a few rounds in practice;
    counted as ``host_wait.sam_nms`` with the read of the kept indices)."""
    boxes = torch.as_tensor(boxes, dtype=torch.float64)
    if isinstance(scores, torch.Tensor):
        scores = scores.cpu().numpy()
    n = boxes.shape[0]
    order = _upload(torch.from_numpy(np.argsort(-np.asarray(scores))),
                    boxes.device, "sam_order_upload")
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
        tracing.count("host_wait.sam_nms")
        if torch.equal(nxt, keep):
            tracing.count("host_wait.sam_nms")
            return order[keep]
        keep = nxt


def _decode_low_res(emb_chw, image_hw: tuple[int, int], points, sam):
    """One model call on a batch of SINGLE-point prompts: (low-resolution
    logits [P,3,4g,4g] as the model returns them, iou_preds [P,3], the
    resized frame (rh, rw), the model's input side)."""
    model, proc, dev = _model(sam, None)
    size, grid = _sizes(model)
    h, w = image_hw
    rh, rw = _frame(proc, h, w)
    pts = np.asarray(points, np.float64) * np.array([rw / w, rh / h])
    input_points = _upload(torch.from_numpy(pts[None, :, None, :]).float(),
                           dev, "sam_prompt_upload")
    input_labels = torch.ones(input_points.shape[:-1], dtype=torch.int64,
                              device=dev)
    out = model(image_embeddings=pad_embedding(emb_chw, dev, grid),
                input_points=input_points, input_labels=input_labels,
                multimask_output=True)
    tracing.count("sam.prompts", out.pred_masks.shape[1])
    return out.pred_masks[0], out.iou_scores[0], (rh, rw), size


@torch.no_grad()
def _decode_point_batch(emb_chw, image_hw: tuple[int, int], points,
                        sam=None, device=None):
    """Decode a batch of SINGLE-point prompts in one model call: (logits
    [P,3,H,W], iou_preds [P,3]) at ``image_hw``, on the model's device."""
    sam = _model(sam, device)[:2]
    low, ious, input_hw, size = _decode_low_res(emb_chw, image_hw, points,
                                                sam)
    with tracing.span("sam.postprocess"):
        logits = postprocess_masks(low, input_hw, image_hw, size)
    return logits, ious


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

    A crop's full-size logits live one point batch at a time: each batch
    leaves its low-resolution logits (a fixed [points, 3, 4g, 4g] store,
    ~0.8 GB at 1,024 points) and its candidates' scalars on the host, and
    only the masks its NMS keeps are post-processed again to full size
    (the same per-mask arithmetic, so the same masks), as segment-anything
    keeps its candidates as run-length codes until NMS. The card's memory
    thus does not grow with the number of candidates.

    Returns a list of {"segmentation" bool [H,W] on the device, "area",
    "bbox" xywh, "predicted_iou", "point_coords", "stability_score",
    "crop_box" xywh} sorted by area (desc), the reference's records."""
    model, proc, dev = _model(sam, device)
    sam = (model, proc)
    emb = pad_embedding(emb_chw, dev, _sizes(model)[1])[0]
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
        store, crop_recs = None, []
        for s in range(0, len(pts), points_per_batch):
            batch = pts[s: s + points_per_batch]
            low, ious, input_hw, size = _decode_low_res(emb, crop_hw, batch,
                                                        sam)
            if store is None:
                store = low.new_empty((len(pts),) + low.shape[1:])
            store[s: s + len(batch)] = low
            with tracing.span("sam.postprocess"):
                logits = postprocess_masks(low, input_hw, crop_hw, size)
            del low
            with tracing.span("sam.select"):
                crop_recs += _select(logits, ious, batch, s, crop_box,
                                     (orig_h, orig_w), pred_iou_thresh,
                                     stability_thresh)
            del logits
        if crop_recs:  # per-crop NMS on predicted IoU
            with tracing.span("sam.select"):
                keep = box_nms(
                    _upload(torch.tensor([r["box_xyxy"] for r in crop_recs],
                                         dtype=torch.float64),
                            dev, "sam_box_upload"),
                    [r["predicted_iou"] for r in crop_recs], box_nms_thresh)
                tracing.count("host_wait.sam_nms_keep")
                crop_recs = [crop_recs[i] for i in keep.tolist()]
            with tracing.span("sam.postprocess"):
                _masks(crop_recs, store.flatten(0, 1), input_hw, crop_box,
                       (orig_h, orig_w), size, 3 * points_per_batch)
            all_recs.extend(crop_recs)
        del store

    with tracing.span("sam.select"):
        if len(crop_boxes) > 1 and all_recs:  # cross-crop NMS, smaller wins
            def crop_area(r):
                cb = r["crop_box"]
                return (cb[2] - cb[0]) * (cb[3] - cb[1])
            keep = box_nms(
                _upload(torch.tensor([r["box_xyxy"] for r in all_recs],
                                     dtype=torch.float64),
                        dev, "sam_box_upload"),
                [1.0 / crop_area(r) for r in all_recs], crop_nms_thresh)
            tracing.count("host_wait.sam_nms_keep")
            all_recs = [all_recs[i] for i in keep.tolist()]

        for r in all_recs:
            b = r.pop("box_xyxy")
            cb = r["crop_box"]
            r["bbox"] = [b[0], b[1], b[2] - b[0], b[3] - b[1]]
            r["crop_box"] = [cb[0], cb[1], cb[2] - cb[0], cb[3] - cb[1]]
    tracing.count("sam.masks", len(all_recs))
    all_recs.sort(key=lambda d: -d["area"])
    return all_recs


def _select(logits, ious, batch, first, crop_box, orig_hw, pred_iou_thresh,
            stability_thresh) -> list:
    """One point batch's candidates ([P,3,h,w] logits in the crop, [P,3]
    predicted IoUs, the [P,2] points, the first point's index in the
    crop's grid) through the predicted-IoU and stability filters,
    thresholded to masks with their boxes, uncropped, and those at a crop
    edge dropped: its records, without their masks, each with its box in
    the original frame ("box_xyxy") and its row of the crop's logits
    ("mask_index"). Every mask of the batch is scored on the card, and the
    host reads the table once."""
    x0, y0, x1, y1 = crop_box
    orig_h, orig_w = orig_hw
    lg = logits.reshape(-1, *logits.shape[-2:])        # [P*3, h, w]
    sc = ious.reshape(-1)
    passed = sc > pred_iou_thresh
    hi = (lg > MASK_THRESHOLD + STABILITY_OFFSET).sum((1, 2))
    lo = (lg > MASK_THRESHOLD - STABILITY_OFFSET).sum((1, 2))
    stab = hi.double() / torch.clamp_min(lo, 1).double()
    passed &= stab >= stability_thresh
    masks = lg > MASK_THRESHOLD
    boxes = batched_mask_to_box(masks)
    boxes[:, 0::2] += x0                               # uncrop
    boxes[:, 1::2] += y0
    edge = is_box_near_crop_edge(boxes, crop_box, [0, 0, orig_w, orig_h])
    table = torch.cat([torch.stack([passed, edge], 1).double(),
                       sc.double()[:, None], stab[:, None],
                       masks.sum((1, 2)).double()[:, None], boxes], 1)
    tracing.count("host_wait.sam_candidates")
    table = table.cpu().numpy()
    tracing.count("sam.candidates", int(table[:, 0].sum()))
    n_masks = logits.shape[1]
    return [{"area": int(row[4]), "box_xyxy": row[5:9].tolist(),
             "predicted_iou": float(row[2]),
             "point_coords": [[float(batch[j // n_masks][0] + x0),
                               float(batch[j // n_masks][1] + y0)]],
             "stability_score": float(row[3]), "crop_box": crop_box,
             "mask_index": first * n_masks + j}
            for j, row in enumerate(table) if row[0] and not row[1]]


def _masks(recs: list, low_res, input_hw, crop_box, orig_hw, size: int,
           chunk: int) -> None:
    """Each record's full-size mask ("segmentation", bool [H, W] on the
    card) from its row of the crop's low-resolution logits ``low_res``
    [M, h, w]: post-processed, ``chunk`` at a time, thresholded, and
    placed in the crop."""
    x0, y0, x1, y1 = crop_box
    idx = _upload(torch.tensor([r.pop("mask_index") for r in recs]),
                  low_res.device, "sam_index_upload")
    for s in range(0, len(recs), chunk):
        logits = postprocess_masks(low_res[idx[s: s + chunk], None],
                                   input_hw, (y1 - y0, x1 - x0), size)
        part = logits[:, 0] > MASK_THRESHOLD
        if part.shape[-2:] != orig_hw:
            full = part.new_zeros((len(part),) + tuple(orig_hw))
            full[:, y0:y1, x0:x1] = part
            part = full
        for r, m in zip(recs[s: s + chunk], part):
            r["segmentation"] = m


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
