"""Segmenting: Feature 3DGS's SAM setting on rendered embeddings, one client
in a closed loop, the next orbit view each request. Each request runs the
port's chain as ``cli/render.py`` and the original's ``segment.py`` do:
``render`` at the configuration's rendered width (F = 64),
``resize_bilinear_align_corners`` to the SAM teacher's grid (42 x 64), the
speed-up decoder (``apply_decoder``, 64 -> 256), then
``sam_decode.auto_masks`` over the configuration's point grid with its
published filters: the prompt encoder and mask decoder on each point
batch, the post-processing to the image's size, the filters, boxes and box
NMS. The masks stay on the card; the host gets the records' scalars.

Weights: the Gaussians and the decoder from the seed, as in the serving
cells; the prompt encoder and mask decoder drawn by the reference
(``reference/sam_mask_decoder.py:SamDecoder.draw``, with the
configuration's two factors) from a card generator of the seed's stream 5,
and loaded strictly into ``build_sam``'s model (its ViT-H image encoder
keeps ``transformers``' own initialisation and never runs here).

The check: a seeded reservoir of the window's requests, each request's
slot drawn before it runs. For a kept request, run under
``tracing.recording()``: its decoded embedding, the low-resolution logits
and predicted IoUs of every point batch (copied to the host by a forward
hook on the model as the card makes them; the copies' time is left out of
the window and the latency), its ``sam.candidates`` count and its records.
Numbers:
  embedding_gap  the 99.9th percentile of |program - reference| over the
                 reference's rms, of the decoded 256 x 42 x 64 embedding
                 against the reference's render -> resize -> decode;
  logit_gap      the same statistic of one seeded point batch's
                 low-resolution logits, against the reference decoder fed
                 the reference's embedding;
  iou_gap        the largest |difference| of that batch's predicted IoUs;
  selection_mismatch
                 run the reference's generator on the program's own
                 logits and IoUs: the difference of the two counts of
                 candidates past both filters, the records the two do not
                 share (by point and predicted IoU), and the shared ones
                 whose area, box or place in the order differ.
The planted faults (calibration) are the reference's ``FAULTS`` (the
decoder's) and ``SELECTION_FAULTS``.

The count: each traced view's forward compositing work and operations
(preprocess, compositing, the resize and the decoder;
``yardstick/bounds.py``, ``yardstick/flops.py``) and the mask decoder's
(``yardstick/sam_decoder.py``).
"""
from __future__ import annotations

import contextlib
import math
import os
import random
import time

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.harness import check, program, scene, trace, work
from port_bench.reference import render as R
from port_bench.reference import sam_mask_decoder as D
from port_bench.reference import train as T
from port_bench.yardstick import flops, sam_decoder

QUANTILE = 0.999
WEIGHT_STREAM = 5


def _program():
    """The program's SAM modules; ``transformers``, which they import to
    build the model, then loads neither TensorFlow nor, through it, JAX
    (``run.py`` refuses a run that did). A program without the mask
    decoder's post-processing on the card cannot run this cell: it stops
    here, before anything is drawn."""
    os.environ.setdefault("USE_TF", "0")
    from feature3dgs_tpu_torch.encoders import sam_decode, sam_encoder
    if not hasattr(sam_decode, "postprocess_masks"):
        raise RuntimeError("the program has no sam_decode.postprocess_masks:"
                           " its masks are not post-processed on the card")
    return sam_encoder, sam_decode


def weights(cfg: dict, seed: int, device) -> D.SamDecoder:
    """The prompt encoder and mask decoder with the seed's weights, drawn
    on ``device`` and kept on the host; the same for every call."""
    return D.SamDecoder(cfg["prompt_encoder"], cfg["mask_decoder"]).draw(
        scene.generator(seed, WEIGHT_STREAM, device), **cfg["draw"])


def n_batches(cfg: dict) -> int:
    g = cfg["generator"]
    return math.ceil(g["points_per_side"] ** 2 / g["points_per_batch"])


def checked_batch(cfg: dict, seed: int) -> int:
    """The point batch whose logits the check compares."""
    return random.Random(seed).randrange(n_batches(cfg))


class _Capture:
    """The model outputs of a kept request. A forward hook on the model,
    while the capture is entered, copies each call's low-resolution logits
    and predicted IoUs to the host once the card has made them; the
    copies' time, and whatever runs under ``pause()``, is the check's and
    is counted in ``paused_s``, which the window and the latencies leave
    out. The card holds nothing for the check."""

    def __init__(self, model, device):
        self.device, self.on, self.paused_s, self.got = device, False, 0.0, []
        self.hook = model.register_forward_hook(self._hook)

    def _hook(self, mod, args, out):
        if self.on:
            program.sync(self.device)
            with self.pause():
                self.got.append((out.pred_masks[0].cpu(),
                                 out.iou_scores[0].cpu()))

    def __enter__(self):
        self.on = True
        return self

    def __exit__(self, *exc):
        self.on = False

    @contextlib.contextmanager
    def pause(self):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.paused_s += time.perf_counter() - t

    def take(self) -> list:
        got, self.got = self.got, []
        return got

    def remove(self):
        self.hook.remove()
        self.got = []


def _records(recs: list) -> list:
    """The program's records as (x, y, predicted IoU, area, XYXY box)."""
    out = []
    for r in recs:
        x0, y0, w, h = r["bbox"]
        out.append((float(r["point_coords"][0][0]),
                    float(r["point_coords"][0][1]), r["predicted_iou"],
                    int(r["area"]),
                    (int(x0), int(y0), int(x0 + w), int(y0 + h))))
    return out


def run(cfg: dict, traffic: dict, seed: int, seconds: float, device,
        trace_on: bool) -> dict:
    sam_encoder, sam_decode = _program()
    from feature3dgs_tpu_torch import tracing
    from feature3dgs_tpu_torch.model.decoder import apply_decoder
    from feature3dgs_tpu_torch.render import renderer
    from feature3dgs_tpu_torch.train.losses import \
        resize_bilinear_align_corners

    gen = cfg["generator"]
    if gen["crop_n_layers"] != 0 or \
            gen["stability_score_offset"] != sam_decode.STABILITY_OFFSET:
        raise ValueError("this cell runs one crop at the program's "
                         "stability offset")
    drawn = scene.draw_gaussians(cfg, seed, device)
    dec = scene.draw_decoder(cfg, seed, device)
    params, state = program.program_gaussians(cfg, drawn, device)
    del drawn
    rcfg = program.raster_config(cfg)
    bg = torch.zeros(3, device=device)
    sam = sam_encoder.build_sam(device, prompt_encoder=cfg["prompt_encoder"],
                                mask_decoder=cfg["mask_decoder"],
                                **cfg["vision"])
    net = weights(cfg, seed, device)
    for part in ("shared_image_embedding", "prompt_encoder", "mask_decoder"):
        getattr(sam[0], part).load_state_dict(net.port_state(part),
                                              strict=True)
    del net
    gh, gw = cfg["teacher_grid"]
    image_hw = (cfg["height"], cfg["width"])
    kw = dict(points_per_side=gen["points_per_side"],
              points_per_batch=gen["points_per_batch"],
              pred_iou_thresh=gen["pred_iou_thresh"],
              stability_thresh=gen["stability_score_thresh"],
              box_nms_thresh=gen["box_nms_thresh"],
              crop_n_layers=gen["crop_n_layers"])

    def request(k: int):
        """Orbit view k: (its decoded embedding [256, gh, gw], its
        records)."""
        cam = program.port_camera(cfg, k).to_view(device)
        out = renderer.render(params, state, cam, bg=bg, config=rcfg)
        fmap = resize_bilinear_align_corners(out.feature, gh, gw)
        emb = apply_decoder(dec, fmap).permute(2, 0, 1)
        return emb, sam_decode.auto_masks(emb, image_hw, sam=sam, **kw)

    for k in range(traffic["warmup_requests"]):
        request(k)
    program.sync(device)
    setup_end = time.perf_counter()

    capture = _Capture(sam[0], device)
    rng = random.Random(seed)
    keep, seen, lat = [], 0, []
    k = traffic["warmup_requests"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 - capture.paused_s < seconds:
        # a seeded reservoir of the window's requests, its slot drawn first
        # so that only a kept request is captured
        seen += 1
        slot = (len(keep) if len(keep) < traffic["kept_answers"]
                else rng.randrange(seen))
        kept = slot < traffic["kept_answers"]
        paused = capture.paused_s
        r0 = time.perf_counter()
        if kept:
            with capture, tracing.recording() as session:
                emb, recs = request(k)
                program.sync(device)
        else:
            emb, recs = request(k)
            program.sync(device)
        lat.append(time.perf_counter() - r0 - (capture.paused_s - paused))
        if kept:
            with capture.pause():
                answer = (k, emb.cpu(), capture.take(),
                          session.summary()["counters"].get(
                              "sam.candidates", 0), _records(recs))
                if slot < len(keep):
                    keep[slot] = answer
                else:
                    keep.append(answer)
        k += 1
        del emb, recs
    program.sync(device)
    window_s = time.perf_counter() - t0 - capture.paused_s

    out = {"unit_kind": "serve", "units": len(lat), "window_s": window_s,
           "setup_end": setup_end, "latencies_s": lat,
           "attempted": len(lat), "failed": 0}
    if trace_on:
        traced = {"geometry": work.geometry(params)}
        first = k
        with trace.profiled(device, traced):
            for j in range(traffic["trace_requests"]):
                request(first + j)
                program.sync(device)
        traced["cameras"] = list(range(first,
                                       first + traffic["trace_requests"]))
        traced["units"] = traffic["trace_requests"]
        kb = first + traffic["trace_requests"]
        calls = sum(program.blocking_calls(lambda j=j: request(kb + j),
                                           device)
                    for j in range(traffic["blocking_requests"]))
        traced["blocking_per_unit"] = calls / traffic["blocking_requests"]
        out["traced"] = traced
    out["peak_bytes"] = program.peak_bytes(device)
    capture.remove()
    out["readings"] = {
        "checked_batch": checked_batch(cfg, seed),
        "answers": [{"view": i, "embedding": e,
                     "low_res": torch.cat([m for m, _ in cap]),
                     "iou": torch.cat([s for _, s in cap]),
                     "candidates": n, "records": recs}
                    for i, e, cap, n, recs in keep]}
    del keep, params, state, dec, sam
    return out


# ----------------------------------------------------------- reference


def _embedding(cfg: dict, g: dict, dec: dict, view: int, device):
    """The reference's render of ``view``, resized with align_corners to
    the teacher grid and decoded: [256, gh, gw]."""
    cam = check.ref_cam(cfg, view, device)
    with torch.no_grad():
        s = R.project(g, cam, cfg["sh_degree"])
        bins = R.bin_tiles(s, cam.width, cam.height, *cfg["tile"])
        img = R.render(s, bins, cam.width, cam.height,
                       bg=torch.zeros(3, device=device))
        fmap = F.interpolate(img.feat.permute(2, 0, 1)[None],
                             size=tuple(cfg["teacher_grid"]),
                             mode="bilinear", align_corners=True)[0]
        emb = T.decode(dec, fmap.permute(1, 2, 0)).permute(2, 0, 1)
    return emb.contiguous()


def _pad(emb: torch.Tensor, grid: int) -> torch.Tensor:
    out = torch.zeros((emb.shape[0], grid, grid), device=emb.device)
    out[:, :emb.shape[1], :emb.shape[2]] = emb
    return out


def _generate(cfg: dict, net: D.SamDecoder, embedding, device,
              fault=None, checked=None):
    """The reference generator on an embedding [256, gh, gw]: (its
    records, its candidates past both filters, the ``checked`` batch's
    low-resolution logits and IoUs). ``fault`` is one of the decoder's
    ``FAULTS`` or of its ``SELECTION_FAULTS``."""
    gen, image_hw = cfg["generator"], (cfg["height"], cfg["width"])
    size = cfg["prompt_encoder"]["image_size"]
    pts = D.image_points(gen, image_hw)
    inp = D.input_points(pts, image_hw, size)
    input_hw = D.preprocess_shape(*image_hw, size)
    emb = _pad(embedding.to(device), net.grid)
    dec_fault = fault if fault in D.FAULTS else None
    ppb, cands, passed, low = gen["points_per_batch"], [], [], None
    for b in range(n_batches(cfg)):
        sl = slice(b * ppb, (b + 1) * ppb)
        logits, iou = net.decode(emb, inp[sl], dec_fault)
        if b == checked:
            low = (logits.cpu(), iou.cpu())
        cands += D.batch_records(logits, iou, pts[sl], gen, image_hw,
                                 input_hw, size, fault, passed)
        del logits, iou
    return D.select(cands, gen, fault), sum(passed), low


def _selected(cfg: dict, answer: dict, device) -> tuple:
    """The reference generator's filters, boxes and NMS on the program's
    own low-resolution logits and IoUs: (its records, its candidates past
    both filters)."""
    gen, image_hw = cfg["generator"], (cfg["height"], cfg["width"])
    size = cfg["prompt_encoder"]["image_size"]
    pts = D.image_points(gen, image_hw)
    input_hw = D.preprocess_shape(*image_hw, size)
    ppb, cands, passed = gen["points_per_batch"], [], []
    with torch.no_grad():
        for b in range(n_batches(cfg)):
            sl = slice(b * ppb, (b + 1) * ppb)
            cands += D.batch_records(answer["low_res"][sl].to(device),
                                     answer["iou"][sl].to(device), pts[sl],
                                     gen, image_hw, input_hw, size,
                                     passed=passed)
    return D.select(cands, gen), sum(passed)


def _answers(cfg, seed, out, device, tf32: bool, fault=None) -> dict:
    prog = out["readings"]
    b = prog["checked_batch"]
    with check.precision(tf32):
        net = weights(cfg, seed, device)
        g = R.activate(scene.draw_gaussians(cfg, seed, device))
        dec = scene.draw_decoder(cfg, seed, device)
        answers = []
        for a in prog["answers"]:
            emb = _embedding(cfg, g, dec, a["view"], device)
            recs, n, (logits, iou) = _generate(cfg, net, emb, device, fault,
                                               b)
            answers.append({"view": a["view"], "embedding": emb.cpu(),
                            "low_res": logits, "iou": iou, "candidates": n,
                            "records": [c[:3] + c[4:] for c in recs]})
        del g, dec
    return {"checked_batch": b, "answers": answers, "checked": True}


def reference(cfg, traffic, seed, out: dict, device, tf32: bool = False
              ) -> dict:
    """For every view the program's kept answers hold: the reference's
    embedding, the checked batch's logits and IoUs from it, and its own
    records; and, for the program's answers, the reference generator's
    records and candidates on the program's own logits ("selected",
    "selected_candidates")."""
    ref = _answers(cfg, seed, out, device, tf32)
    for r, a in zip(ref["answers"], out["readings"]["answers"]):
        recs, n = _selected(cfg, a, device)
        r["selected"] = [c[:3] + c[4:] for c in recs]
        r["selected_candidates"] = n
    return ref


def frozen(cfg, traffic, seed, out: dict, device) -> dict:
    """The control's planted faults, of the decoder and of the selection,
    each its own readings under "faults"."""
    return {"faults": {f: _answers(cfg, seed, out, device, False, f)
                       for f in D.FAULTS + D.SELECTION_FAULTS}}


def _gap(a: torch.Tensor, r: torch.Tensor) -> float:
    """The 99.9th percentile of |a - r| over r's rms."""
    if a.shape != r.shape:
        return float("inf")
    d = (a.double() - r.double()).abs().numpy().ravel()
    rms = max(float(torch.sqrt(torch.mean(r.double() ** 2))), 1e-30)
    return float(np.quantile(d, QUANTILE)) / rms


def mismatch(prog: list, ref: list) -> int:
    """Records of ``prog`` and ``ref`` ((x, y, IoU, area, box) each) that
    the other lacks by (x, y, IoU), plus the shared ones whose area, box
    or place among the shared ones differs."""
    pk = {r[:3]: r for r in prog}
    rk = {r[:3]: r for r in ref}
    shared = [k for k in pk if k in rk]
    n = len(set(pk) ^ set(rk))
    n += sum(pk[k] != rk[k] for k in shared)
    order_r = [k for k in rk if k in pk]
    n += sum(a != b for a, b in zip(shared, order_r))
    return n


def numbers(prog: dict, ref: dict) -> dict:
    """embedding_gap, logit_gap, iou_gap (the largest over the answers)
    and selection_mismatch (their sum: the candidates counted past both
    filters that the two counts do not share, and the records'
    ``mismatch``); for the planted faults' readings
    each fault's numbers, named ``<number>.<fault>``."""
    if "faults" in prog:
        return {f"{k}.{f}": v for f, r in prog["faults"].items()
                for k, v in numbers(r, ref).items()}
    b = prog["checked_batch"]
    by_view = {r["view"]: r for r in ref["answers"]}
    res = {"embedding_gap": 0.0, "logit_gap": 0.0, "iou_gap": 0.0,
           "selection_mismatch": 0}
    for a in prog["answers"]:
        r = by_view[a["view"]]
        logits, iou = a["low_res"], a["iou"]
        if "checked" not in prog:   # the program's readings hold every batch
            n = r["low_res"].shape[0]
            logits, iou = logits[b * n:(b + 1) * n], iou[b * n:(b + 1) * n]
        res["embedding_gap"] = max(res["embedding_gap"],
                                   _gap(a["embedding"], r["embedding"]))
        res["logit_gap"] = max(res["logit_gap"], _gap(logits, r["low_res"]))
        res["iou_gap"] = max(res["iou_gap"], float(
            (iou.double() - r["iou"].double()).abs().max())
            if iou.shape == r["iou"].shape else float("inf"))
        res["selection_mismatch"] += (
            abs(a["candidates"] - r["selected_candidates"])
            + mismatch(a["records"], r["selected"]))
    return res


def count(cfg: dict, traced: dict, device) -> dict:
    """The traced views' forward work and operations, and the mask
    decoder's operations ("sam_decode_ops"); takes the Gaussians'
    geometry out of ``traced``."""
    f_r, f_out = scene.rendered_dim(cfg), cfg["feature_dim"]
    gh, gw = cfg["teacher_grid"]

    def view_ops(v: work.View) -> dict:
        return {"ops": v.gaussians * flops.PREPROCESS_FWD
                + flops.composite(v.stats, f_r, False)
                + flops.RESIZE_PER_OUTPUT * gh * gw * f_r
                + flops.decoder(gh * gw, f_r, f_out, False)}

    res = work.count_views(cfg, traced.pop("geometry"), traced["cameras"],
                           device, view_ops)
    dec_ops = traced["units"] * sam_decoder.view_ops(cfg)
    res["ops"] += dec_ops
    res["sam_decode_ops"] = dec_ops
    return res
