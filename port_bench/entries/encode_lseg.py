"""Encoding with LSeg: the teacher export of Feature 3DGS's LSeg settings,
one client in a closed loop, one image a call. Each call is the loop body
of the port's ``cli/encode_lseg.py --no_vis`` without its disk write:
``lseg_net.export_features`` at the configuration's scales and stride (the
upload and normalisation, the ViT-L/16 trunk and the DPT head at the
image's size, the fp16 cast, the stride resize, the copy to the host). The
images are uint8 noise drawn from the seed and read as float32 / 255, as
the CLI reads a file (once, in set-up: the cell reads no disk), the
traffic cycling through a few distinct ones. The weights are drawn here,
not by the program: the reference's ``LSegDPT.draw`` from a card generator
seeded with the seed, loaded into the program's ``build_lseg`` network with
``load_state_dict(strict=True)`` before the warm-up, and drawn again, the
same, for the reference.

The check: a seeded reservoir of the window's requests, each request's
slot drawn before it runs. For a kept request a forward hook on the network
copies its float32 output to the host once the card has made it (the
copy's time is left out of the window and the latency), and the request's
exported map is kept. Numbers, against the plain reference
(``reference/lseg_dpt.py``) on the same image and weights:
  feature_gap      the 99.9th percentile of |program - reference| over the
                   reference's rms, of the network's float32 output;
  feature_max_gap  the largest |program - reference| over that rms;
  export_gap       the largest |exported fp16 map - the reference's steps
                   after the network (``lseg_dpt.merge``, then ``export``)
                   put on the program's own float32 output| over the rms
                   of the latter: those steps alone, so that a sound
                   program reads 0.
The planted faults (calibration): the reference's ``FAULTS``, and its
``EXPORT_FAULT`` (the stride resize with aligned corners) put on the
program's float32 outputs.

The count: each traced image's products and convolutions
(``yardstick/lseg.py``), the trunk's blocks, the patch embedding and the
dense head apart.
"""
from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

from port_bench.harness import check, program, trace
from port_bench.reference import lseg_dpt as L
from port_bench.yardstick import lseg

QUANTILE = 0.999


def _lseg_net():
    """The program's LSeg module. A program whose export chain lives only
    in the CLI loop cannot run this cell: it stops here, before anything
    is drawn."""
    from feature3dgs_tpu_torch.encoders import lseg_net
    if not hasattr(lseg_net, "export_features"):
        raise RuntimeError("the program has no lseg_net.export_features: "
                           "its export chain is not one function")
    return lseg_net


def _one_scale(cfg: dict) -> tuple:
    """The network's input size; this cell checks the network's output at
    one scale, on an image it takes whole."""
    h, w = cfg["image"]["height"], cfg["image"]["width"]
    if list(cfg["scales"]) != [1.0] or L.scaled_hw(h, w, 1.0) != (h, w):
        raise ValueError("this cell runs one scale, 1.0, on an image whose "
                         "sides are multiples of 32")
    return h, w


def draw_images(cfg: dict, traffic: dict, seed: int) -> list:
    """The traffic's distinct images, [H, W, 3] uint8 arrays drawn from the
    seed in one batch on the host."""
    g = torch.Generator().manual_seed(seed)
    shape = (traffic["distinct_images"], cfg["image"]["height"],
             cfg["image"]["width"], 3)
    return list(torch.randint(0, 256, shape, dtype=torch.uint8,
                              generator=g).numpy())


def read(image: np.ndarray) -> np.ndarray:
    """An 8-bit image as ``cli/encode_lseg.py`` reads it: float32 / 255."""
    return np.asarray(image, np.float32) / 255.0


def program_dims(cfg: dict) -> dict:
    """The configuration's widths as ``build_lseg``'s keywords."""
    return {k.upper(): tuple(v) if isinstance(v, list) else v
            for k, v in cfg["net"].items()}


def weights(cfg: dict, seed: int, device) -> L.LSegDPT:
    """The reference at the configuration's widths with the seed's weights,
    drawn on ``device`` and kept on the host; the same for every call with
    this seed."""
    return L.LSegDPT(**cfg["net"]).draw(
        torch.Generator(device=device).manual_seed(seed))


class _Capture:
    """The network's outputs of a kept request. A forward hook on the
    network, while the capture is entered, copies each call's output to the
    host once the card has made it; the copies' time is counted in
    ``paused_s``, which the window and the latencies leave out. The card
    holds nothing for the check."""

    def __init__(self, net, device):
        self.device, self.on, self.paused_s, self.got = device, False, 0.0, []
        self.hook = net.register_forward_hook(self._hook)

    def _hook(self, mod, args, out):
        if self.on:
            program.sync(self.device)
            t = time.perf_counter()
            self.got.append(out[0].cpu())
            self.paused_s += time.perf_counter() - t

    def __enter__(self):
        self.on = True
        return self

    def __exit__(self, *exc):
        self.on = False

    def take(self) -> list:
        got, self.got = self.got, []
        return got

    def remove(self):
        self.hook.remove()
        self.got = []


def run(cfg: dict, traffic: dict, seed: int, seconds: float, device,
        trace_on: bool) -> dict:
    lseg_net = _lseg_net()
    _one_scale(cfg)
    images = [read(im) for im in draw_images(cfg, traffic, seed)]
    net = lseg_net.build_lseg(device, **program_dims(cfg))
    net.load_state_dict(weights(cfg, seed, device).port_state(), strict=True)
    scales, stride, n = tuple(cfg["scales"]), cfg["stride"], len(images)

    def request(k: int) -> torch.Tensor:
        return lseg_net.export_features(images[k % n], net, scales, stride)

    for k in range(traffic["warmup_images"]):
        request(k)
    program.sync(device)
    setup_end = time.perf_counter()

    capture = _Capture(net, device)
    rng = random.Random(seed)
    keep, seen, lat = [], 0, []
    k = traffic["warmup_images"]
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
        with capture if kept else contextlib.nullcontext():
            fmap = request(k)
        lat.append(time.perf_counter() - r0 - (capture.paused_s - paused))
        if kept:
            (out_f32,) = capture.take()
            answer = (k % n, out_f32, fmap)
            if slot < len(keep):
                keep[slot] = answer
            else:
                keep.append(answer)
        k += 1
        del fmap
    program.sync(device)
    window_s = time.perf_counter() - t0 - capture.paused_s
    capture.remove()

    out = {"unit_kind": "serve", "units": len(lat), "window_s": window_s,
           "setup_end": setup_end, "latencies_s": lat,
           "attempted": len(lat), "failed": 0,
           "readings": {"answers": [(i, a) for i, a, _ in keep],
                        "exports": [(i, e) for i, _, e in keep]}}
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
    del net
    return out


# ----------------------------------------------------------- reference


def _readings(cfg, traffic, seed, out: dict, device, net: L.LSegDPT,
              tf32: bool, fault=None) -> dict:
    """The reference's float32 map and exported map of every image the
    program's kept answers hold."""
    images = draw_images(cfg, traffic, seed)
    answers, exports = [], []
    with check.precision(tf32):
        for i, _ in out["readings"]["answers"]:
            outputs = []
            fmap = net.encode(torch.from_numpy(read(images[i])), device,
                              tuple(cfg["scales"]), fault, outputs)
            exports.append((i, L.export(fmap, cfg["stride"]).cpu()))
            answers.append((i, outputs[0].cpu()))
            del fmap, outputs
    return {"answers": answers, "exports": exports}


def _chains(cfg, out: dict, device, fault=None) -> list:
    """The reference's steps after the network, on ``device``, on each
    float32 output the program's kept answers hold: ``merge`` to the
    image's size, then the export chain."""
    h, w = _one_scale(cfg)
    return [(i, L.export(L.merge([a.to(device)], h, w), cfg["stride"],
                         fault).cpu())
            for i, a in out["readings"]["answers"]]


def reference(cfg, traffic, seed, out: dict, device, tf32: bool = False
              ) -> dict:
    """The reference's readings, and under "chains" its export chain on
    the program's own float32 maps."""
    res = _readings(cfg, traffic, seed, out, device,
                    weights(cfg, seed, device), tf32)
    res["chains"] = _chains(cfg, out, device)
    return res


def frozen(cfg, traffic, seed, out: dict, device) -> dict:
    """The control's planted faults, each its own readings under
    "faults"; the export's fault on the program's float32 maps."""
    net = weights(cfg, seed, device)
    faults = {f: _readings(cfg, traffic, seed, out, device, net, False, f)
              for f in L.FAULTS}
    faults[L.EXPORT_FAULT] = {"exports": _chains(cfg, out, device,
                                                 L.EXPORT_FAULT)}
    return {"faults": faults}


def _rms(t: torch.Tensor) -> float:
    return max(float(torch.linalg.vector_norm(t, dtype=torch.float64))
               / t.numel() ** 0.5, 1e-30)


def numbers(prog: dict, ref: dict) -> dict:
    """feature_gap and feature_max_gap of the readings' answers against
    the reference's, export_gap of their exports against the reference's
    chains; for the planted faults' readings each fault's numbers, named
    ``<number>.<fault>``."""
    if "faults" in prog:
        return {f"{k}.{f}": v for f, r in prog["faults"].items()
                for k, v in numbers(r, ref).items()}
    res = {}
    if "answers" in prog:
        res.update(feature_gap=0.0, feature_max_gap=0.0)
        by_image = dict(ref["answers"])
        for i, a in prog["answers"]:
            r = by_image[i]
            if a.shape != r.shape:
                res.update(feature_gap=float("inf"),
                           feature_max_gap=float("inf"))
                break
            d = (a.float() - r.float()).abs()
            rms = _rms(r)
            res["feature_gap"] = max(res["feature_gap"], float(
                np.quantile(d.numpy().ravel(), QUANTILE)) / rms)
            res["feature_max_gap"] = max(res["feature_max_gap"],
                                         float(d.max()) / rms)
            del d
    if "exports" in prog:
        res["export_gap"] = 0.0
        by_image = dict(ref["chains"])
        for i, e in prog["exports"]:
            r = by_image[i].float()
            if e.shape != r.shape:
                res["export_gap"] = float("inf")
                break
            res["export_gap"] = max(res["export_gap"], float(
                (e.float() - r).abs().max()) / _rms(r))
    return res


def count(cfg: dict, traced: dict, device) -> dict:
    """The traced images' products and convolutions: "ops" in all, and the
    trunk's, the patch embedding's and the dense head's."""
    ops = lseg.image_ops(cfg["net"], *_one_scale(cfg))
    units = traced["units"]
    res = {k: v * units for k, v in ops.items()}
    res["ops"] = sum(ops.values()) * units
    return res
