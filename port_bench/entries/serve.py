"""Serving: the program's ``render`` (or ``render_batch`` for a batch of
views) and the speed-up decoder, one client in a closed loop, the next
orbit views each request.

The check: the answers kept from the window (a seeded reservoir) against
the reference's render of the same views: colour_gap and depth_gap, the
99.9th percentile of the absolute difference; feature_gap, the same of the
decoded features at pixels drawn from the seed, over their rms.

The count: each traced view's forward compositing work and its operations
(``yardstick/bounds.py``, ``yardstick/flops.py``).
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from port_bench.harness import check, program, scene, trace, work
from port_bench.reference import render as R
from port_bench.reference import train as T
from port_bench.yardstick import flops

QUANTILE = 0.999


def run(cfg: dict, traffic: dict, seed: int, seconds: float, device,
        trace_on: bool) -> dict:
    from feature3dgs_tpu_torch.model.decoder import apply_decoder
    from feature3dgs_tpu_torch.render import renderer

    drawn = scene.draw_gaussians(cfg, seed, device)
    dec = scene.draw_decoder(cfg, seed, device) if cfg["speedup"] else None
    params, state = program.program_gaussians(cfg, drawn, device)
    del drawn
    rcfg = program.raster_config(cfg)
    bg = torch.zeros(3, device=device)
    batch = traffic["batch"]
    pixels = scene.sample_rows(cfg["width"] * cfg["height"],
                               traffic["checked_pixels"], seed, device)

    def request(k: int) -> list:
        """Views k*batch .. (k+1)*batch - 1 of the orbit: [(view index,
        colour, depth, decoded feature map)]."""
        idx = list(range(k * batch, (k + 1) * batch))
        cams = [program.port_camera(cfg, i).to_view(device) for i in idx]
        if batch == 1:
            outs = [renderer.render(params, state, cams[0], bg=bg,
                                    config=rcfg)]
        else:
            o = renderer.render_batch(params, state, cams, bg=bg,
                                      config=rcfg)
            outs = [type(o)(*(v[j] for v in o)) for j in range(batch)]
        return [(i, o.color, o.depth,
                 o.feature if dec is None else apply_decoder(dec, o.feature))
                for i, o in zip(idx, outs)]

    for k in range(traffic["warmup_requests"]):
        request(k)
    program.sync(device)
    setup_end = time.perf_counter()

    rng = random.Random(seed)
    keep, seen = [], 0
    lat = []
    k = traffic["warmup_requests"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        r0 = time.perf_counter()
        answers = request(k)
        program.sync(device)
        lat.append(time.perf_counter() - r0)
        k += 1
        for i, color, depth, fmap in answers:
            # a seeded reservoir of the window's answers
            seen += 1
            slot = (len(keep) if len(keep) < traffic["kept_answers"]
                    else rng.randrange(seen))
            if slot < traffic["kept_answers"]:
                kept = (i, color.clone(), depth.clone(),
                        fmap.reshape(-1, fmap.shape[-1])[pixels])
                if slot < len(keep):
                    keep[slot] = kept
                else:
                    keep.append(kept)
        del answers
    program.sync(device)
    window_s = time.perf_counter() - t0
    n_req = len(lat)

    out = {"unit_kind": "serve", "units": n_req * batch,
           "window_s": window_s, "setup_end": setup_end,
           "latencies_s": lat, "attempted": n_req * batch, "failed": 0,
           "readings": {"answers": [(i, c.cpu(), d.cpu(), f.cpu())
                                    for i, c, d, f in keep],
                        "pixels": pixels.cpu()}}
    if trace_on:
        traced = {"geometry": work.geometry(params)}
        first = k
        with trace.profiled(device, traced):
            for j in range(traffic["trace_requests"]):
                request(first + j)
                program.sync(device)
        traced["cameras"] = list(range(first * batch, (first + traffic[
            "trace_requests"]) * batch))
        traced["units"] = traffic["trace_requests"] * batch
        kb = first + traffic["trace_requests"]
        calls = sum(program.blocking_calls(lambda j=j: request(kb + j),
                                           device)
                    for j in range(traffic["blocking_requests"]))
        traced["blocking_per_unit"] = calls / (traffic["blocking_requests"]
                                               * batch)
        traced["batch"] = batch
        out["traced"] = traced
    out["peak_bytes"] = program.peak_bytes(device)
    del params, state, dec
    return out


def reference(cfg, traffic, seed, out: dict, device, tf32: bool = False
              ) -> dict:
    """The reference's colour, depth and decoded features at the sampled
    pixels, for every view the program's kept answers hold."""
    prog = out["readings"]
    with check.precision(tf32):
        g = R.activate(scene.draw_gaussians(cfg, seed, device))
        dec = (scene.draw_decoder(cfg, seed, device) if cfg["speedup"]
               else None)
        pixels = prog["pixels"].to(device)
        answers = []
        for i, *_ in prog["answers"]:
            cam = check.ref_cam(cfg, i, device)
            with torch.no_grad():
                s = R.project(g, cam, cfg["sh_degree"])
                bins = R.bin_tiles(s, cam.width, cam.height, *cfg["tile"])
                img = R.render(s, bins, cam.width, cam.height,
                               bg=torch.zeros(3, device=device))
                f = img.feat.reshape(-1, img.feat.shape[-1])[pixels]
                if dec is not None:
                    f = T.decode(dec, f)
            answers.append((i, img.color.cpu(), img.depth.cpu(), f.cpu()))
            del s, bins, img
    return {"answers": answers}


def _q(x: torch.Tensor) -> float:
    a = np.abs(x.double().numpy().ravel())
    return float(np.quantile(a, QUANTILE)) if a.size else 0.0


def numbers(prog: dict, ref: dict) -> dict:
    color = depth = feat = 0.0
    by_view = {a[0]: a for a in ref["answers"]}
    for i, c, d, f in prog["answers"]:
        _, rc, rd, rf = by_view[i]
        color = max(color, _q(c - rc))
        depth = max(depth, _q(d - rd))
        rms = float(torch.sqrt(torch.mean(rf.double() ** 2)))
        feat = max(feat, _q(f - rf) / max(rms, 1e-30))
    return {"color_gap": color, "depth_gap": depth, "feature_gap": feat}


def count(cfg: dict, traced: dict, device) -> dict:
    """The traced views' forward work and operations; takes the Gaussians'
    geometry out of ``traced``."""
    f_r, f_out = scene.rendered_dim(cfg), cfg["feature_dim"]

    def view_ops(v: work.View) -> dict:
        return {"ops": flops.serve_view(v.gaussians, v.stats, cfg["width"],
                                        cfg["height"], f_r, f_out,
                                        cfg["speedup"])}

    return work.count_views(cfg, traced.pop("geometry"), traced["cameras"],
                            device, view_ops)
