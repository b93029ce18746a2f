"""Encoding: the teacher export of Feature 3DGS's SAM setting, one client in
a closed loop, one image a call. Each call runs the program's
``encode_image`` (the processor on the host and the upload, ViT-H at its
input size, the neck, the crop to the image's aspect), then the export's
fp16 cast and copy to the host (``export_embedding``, as
``sam_encoder.main`` does before it writes; no disk write). The images are
uint8 noise drawn from the seed, the traffic cycling through a few distinct
ones. The weights are drawn here, not by the program: the reference's
``SamViT.draw`` from a card generator seeded with the seed, loaded into the
program's ``build_sam`` model through the inverse of the reference's name
map with ``load_state_dict(strict=True)`` before the warm-up, and drawn
again, the same, for the reference.

The check: a seeded reservoir of the window's f32 embeddings (before the
cast) against the plain reference (``reference/sam_vit.py``), which starts
from the padded, normalised pixels the program's processor produced for the
same image: embedding_gap, the 99.9th percentile of |program - reference|
over the reference's rms, and embedding_max_gap, the largest. Those pixels
are held in turn against the reference's own ``preprocess`` of the image:
pixel_gap, the largest difference in 8-bit levels. The planted faults
(calibration): the reference with its relative-position terms left out, with
its first windowed block run as a global one, and with its middle block
skipped; and its preprocess taking the nearest pixel in its resize.

The count: each traced image's products and convolutions
(``yardstick/vit.py``).
"""
from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from port_bench.harness import check, program, trace
from port_bench.reference import sam_vit as V
from port_bench.yardstick import vit

QUANTILE = 0.999
PIXEL_FAULT = "nearest_resize"


def draw_images(traffic: dict, seed: int) -> list:
    """The traffic's distinct images, [H, W, 3] uint8 arrays drawn from the
    seed in one batch on the host."""
    g = torch.Generator().manual_seed(seed)
    n, h, w = (traffic["distinct_images"], traffic["height"],
               traffic["width"])
    batch = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8,
                          generator=g)
    return list(batch.numpy())


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _sam_encoder():
    """The program's SAM module; transformers, which it imports to build
    the encoder, then loads neither TensorFlow nor, through it, JAX
    (``run.py`` refuses a run that did)."""
    os.environ.setdefault("USE_TF", "0")
    from feature3dgs_tpu_torch.encoders import sam_encoder
    return sam_encoder


def run(cfg: dict, traffic: dict, seed: int, seconds: float, device,
        trace_on: bool) -> dict:
    sam_encoder = _sam_encoder()
    images = draw_images(traffic, seed)
    sam = sam_encoder.build_sam(device, **cfg["vision"])
    sam[0].vision_encoder.load_state_dict(
        weights(cfg, seed, device).port_state(), strict=True)
    n = len(images)

    def request(k: int):
        emb = sam_encoder.encode_image(images[k % n], sam)
        sam_encoder.export_embedding(emb)
        return k % n, emb

    for k in range(traffic["warmup_images"]):
        request(k)
    program.sync(device)
    setup_end = time.perf_counter()

    rng = random.Random(seed)
    keep, seen, lat = [], 0, []
    k = traffic["warmup_images"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        r0 = time.perf_counter()
        i, emb = request(k)
        lat.append(time.perf_counter() - r0)
        k += 1
        # a seeded reservoir of the window's embeddings
        seen += 1
        slot = (len(keep) if len(keep) < traffic["kept_answers"]
                else rng.randrange(seen))
        if slot < traffic["kept_answers"]:
            if slot < len(keep):
                keep[slot] = (i, emb)
            else:
                keep.append((i, emb))
        del emb
    program.sync(device)
    window_s = time.perf_counter() - t0

    proc = sam[1]
    out = {"unit_kind": "serve", "units": len(lat), "window_s": window_s,
           "setup_end": setup_end, "latencies_s": lat,
           "attempted": len(lat), "failed": 0,
           "readings": {
               "answers": [(i, e.cpu()) for i, e in keep],
               # the inputs the reference starts from: the processor's
               # padded, normalised pixels of each kept image, and its size
               "pixels": {i: proc(images=images[i], return_tensors="pt")
                          ["pixel_values"] for i, _ in keep},
               "image_hw": (traffic["height"], traffic["width"])}}
    del keep
    if trace_on:
        traced = {}
        first = k
        with trace.profiled(device, traced):
            for j in range(traffic["trace_images"]):
                request(first + j)
        traced["units"] = traffic["trace_images"]
        kb = first + traffic["trace_images"]
        calls = sum(program.blocking_calls(lambda j=j: request(kb + j),
                                           device)
                    for j in range(traffic["blocking_images"]))
        traced["blocking_per_unit"] = calls / traffic["blocking_images"]
        out["traced"] = traced
    out["peak_bytes"] = program.peak_bytes(device)
    del sam
    return out


def weights(cfg: dict, seed: int, device) -> V.SamViT:
    """The reference at the configuration's widths with the seed's weights,
    drawn on ``device`` and kept on the host; the same for every call with
    this seed."""
    return V.SamViT(**cfg["vision"]).draw(_generator(seed, device))


def _answers(out: dict, device, net: V.SamViT, tf32: bool,
             fault=None) -> dict:
    prog = out["readings"]
    with check.precision(tf32):
        embs = {i: net.export(px, prog["image_hw"], device, fault).cpu()
                for i, px in prog["pixels"].items()}
    return {"answers": [(i, embs[i]) for i, _ in prog["answers"]]}


def _pixels(cfg, traffic, seed, out: dict, mode: str = "bilinear") -> dict:
    """The reference's own preprocess of each kept image."""
    images = draw_images(traffic, seed)
    return {i: V.preprocess(torch.from_numpy(images[i]),
                            cfg["vision"]["image_size"], mode)
            for i in out["readings"]["pixels"]}


def reference(cfg, traffic, seed, out: dict, device, tf32: bool = False
              ) -> dict:
    """The reference's embedding of every image the program's kept answers
    hold, from the program's pixels and the same weights; and its own
    pixels of those images."""
    return dict(_answers(out, device, weights(cfg, seed, device), tf32),
                pixels=_pixels(cfg, traffic, seed, out))


def frozen(cfg, traffic, seed, out: dict, device) -> dict:
    """The control's planted faults, each its own readings under
    "faults"."""
    net = weights(cfg, seed, device)
    faults = {f: _answers(out, device, net, False, f) for f in V.FAULTS}
    faults[PIXEL_FAULT] = {"pixels": _pixels(cfg, traffic, seed, out,
                                             mode="nearest")}
    return {"faults": faults}


def numbers(prog: dict, ref: dict) -> dict:
    """embedding_gap and embedding_max_gap of the readings' answers, and
    pixel_gap of their pixels; for the planted faults' readings each
    fault's numbers, named ``<number>.<fault>``."""
    if "faults" in prog:
        return {f"{k}.{f}": v for f, r in prog["faults"].items()
                for k, v in numbers(r, ref).items()}
    res = {}
    if "answers" in prog:
        res.update(embedding_gap=0.0, embedding_max_gap=0.0)
        by_image = dict(ref["answers"])
        for i, e in prog["answers"]:
            r = by_image[i].double()
            if e.shape != r.shape:
                res.update(embedding_gap=float("inf"),
                           embedding_max_gap=float("inf"))
                break
            d = (e.double() - r).abs().numpy().ravel()
            rms = max(float(torch.sqrt(torch.mean(r ** 2))), 1e-30)
            res["embedding_gap"] = max(res["embedding_gap"], float(
                np.quantile(d, QUANTILE)) / rms)
            res["embedding_max_gap"] = max(res["embedding_max_gap"],
                                           float(d.max()) / rms)
    if "pixels" in prog:
        # normalised units back to 8-bit levels, channel by channel
        std = torch.tensor(V.PIXEL_STD, dtype=torch.float64).view(1, 3, 1, 1)
        res["pixel_gap"] = max(
            float(((px.double() - ref["pixels"][i].double()).abs() * std)
                  .max()) if px.shape == ref["pixels"][i].shape
            else float("inf")
            for i, px in prog["pixels"].items())
    return res


def count(cfg: dict, traced: dict, device) -> dict:
    """The traced images' products and convolutions."""
    return {"ops": vit.image_ops(cfg["vision"]) * traced["units"]}
