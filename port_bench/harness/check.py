"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``port_bench/reference``), run once the window
has closed and the program's state is freed.

Training: the reference follows the checked steps from the same drawn
state, cameras and views. Compared, each as the worst over its leaves:
  loss_gap        |loss - ref| / |ref| over the checked steps;
  grad_norm_gap   the gap of the first step's gradient norms, the program's
                  worked out from Adam's first moment after that step (the
                  drawn first moments are zero);
  change_gap      the gap of the norms of the parameters' change over the
                  checked steps, leaves whose reference gradient is under
                  1e-3 of the median leaf's left out;
  grad_elem_gap   the median, over the nonzero elements of the reference's
                  first gradient on rows drawn from the seed, of each
                  element's relative gap |program - reference| / |reference|.
The norm gaps are taken against the larger of the leaf's reference norm
and the median leaf's. A norm averages rounding away; the median of the
elementwise gap does not, and ignores the few Gaussians whose alpha or
transmittance test flips between two sound runs.

Serving: the answers kept from the window (a seeded reservoir) against the
reference's render of the same views: colour_gap and depth_gap, the 99.9th
percentile of the absolute difference; feature_gap, the same of the
decoded features at pixels drawn from the seed, over their rms.
"""
from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch

from port_bench.harness import scene
from port_bench.reference import render as R
from port_bench.reference import train as T

QUANTILE = 0.999


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in full f32, or in TF32 (the
    control)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def ref_cam(cfg, i, device) -> R.Cam:
    rot, t = scene.orbit(cfg, i)
    return R.make_cam(rot, t, cfg["fovx"], cfg["fovy"], cfg["width"],
                      cfg["height"], device)


def reference_train(cfg, traffic, seed, program: dict, inputs: list, device,
                    tf32: bool = False, frozen: bool = False) -> dict:
    """The reference's readings of the checked steps, on the cameras the
    program drew. ``frozen`` plants a fault in it: each step leaves the
    state unchanged, so Adam's first moment, the gradient worked out from
    it and the change all read zero."""
    with precision(tf32):
        params = scene.draw_gaussians(cfg, seed, device)
        opt = scene.draw_optimizer(cfg, params, seed, device)
        state = {"params": params, "spatial_scale":
                 cfg["resume"]["spatial_lr_scale"], **opt}
        start = {k: v.clone() for k, v in params.items()}
        if cfg["speedup"]:
            start.update({"decoder." + k: v.clone()
                          for k, v in opt["dec"].items()})
        rows = program["rows"].to(device)
        losses, grad_norms, grad_rows = [], {}, {}
        for k, uid in enumerate(program["cameras"]):
            image, teacher = inputs[uid]
            args = (ref_cam(cfg, uid, device),
                    torch.from_numpy(image).to(device),
                    torch.from_numpy(teacher).to(device))
            if frozen:
                losses.append(float(T.gradients(
                    state["params"], state.get("dec"), *args,
                    cfg["sh_degree"], cfg["tile"])[0]))
                continue
            r = T.train_step(state, *args, cfg["resume"]["iteration"] + k + 1,
                             cfg["sh_degree"], cfg["tile"])
            losses.append(float(r["loss"]))
            if k == 0:
                grads = dict(r["grads"])
                if r["dec_grads"] is not None:
                    grads.update({"decoder." + n: g
                                  for n, g in r["dec_grads"].items()})
                grad_norms = T.leaf_norms(grads)
                grad_rows = {n: (g if n.startswith("decoder.") else g[rows]
                                 ).cpu() for n, g in grads.items()}
                del grads, r
        if frozen:
            grad_norms = dict.fromkeys(start, 0.0)
            grad_rows = {n: torch.zeros_like(g)
                         for n, g in program["grad_rows"].items()}
        now = dict(state["params"])
        if cfg["speedup"]:
            now.update({"decoder." + k: v for k, v in state["dec"].items()})
        changes = {k: float(torch.linalg.vector_norm((now[k] - start[k])
                                                     .double()))
                   for k in start}
    return {"losses": losses, "grad_norms": grad_norms,
            "grad_rows": grad_rows, "changes": changes}


def _gap(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    if not keys:
        return 0.0
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap of gradient norms and of change norms, against the
    larger of its reference norm and the median leaf's (calibration)."""
    out = {}
    for key in ("grad_norms", "changes"):
        r = ref[key]
        med = statistics.median(r.values())
        out[key] = {k: abs(prog[key][k] - r[k]) / max(r[k], med, 1e-30)
                    for k in r}
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"]))
    gn = ref["grad_norms"]
    med = statistics.median(gn.values())
    moved = [k for k in gn if gn[k] >= 1e-3 * med]
    elem = 0.0
    for k, r in ref["grad_rows"].items():
        r = r.double().flatten()
        nz = r != 0             # Gaussians out of view or hidden have none
        if nz.any():
            p = prog["grad_rows"][k].double().flatten()
            elem = max(elem, float(((p - r)[nz] / r[nz]).abs().median()))
    return {"loss_gap": loss,
            "grad_norm_gap": _gap(prog["grad_norms"], gn, gn),
            "change_gap": _gap(prog["changes"], ref["changes"], moved),
            "grad_elem_gap": elem}


def reference_serve(cfg, seed, program: dict, device, tf32: bool = False
                    ) -> dict:
    """The reference's colour, depth and decoded features at the sampled
    pixels, for every view the program's kept answers hold."""
    with precision(tf32):
        g = R.activate(scene.draw_gaussians(cfg, seed, device))
        dec = (scene.draw_decoder(cfg, seed, device) if cfg["speedup"]
               else None)
        pixels = program["pixels"].to(device)
        out = []
        for i, *_ in program["answers"]:
            cam = ref_cam(cfg, i, device)
            with torch.no_grad():
                s = R.project(g, cam, cfg["sh_degree"])
                bins = R.bin_tiles(s, cam.width, cam.height, *cfg["tile"])
                img = R.render(s, bins, cam.width, cam.height,
                               bg=torch.zeros(3, device=device))
                f = img.feat.reshape(-1, img.feat.shape[-1])[pixels]
                if dec is not None:
                    f = T.decode(dec, f)
            out.append((i, img.color.cpu(), img.depth.cpu(), f.cpu()))
            del s, bins, img
    return {"answers": out}


def _q(x: torch.Tensor) -> float:
    a = np.abs(x.double().numpy().ravel())
    return float(np.quantile(a, QUANTILE)) if a.size else 0.0


def serve_numbers(prog: dict, ref: dict) -> dict:
    color = depth = feat = 0.0
    by_view = {a[0]: a for a in ref["answers"]}
    for i, c, d, f in prog["answers"]:
        _, rc, rd, rf = by_view[i]
        color = max(color, _q(c - rc))
        depth = max(depth, _q(d - rd))
        rms = float(torch.sqrt(torch.mean(rf.double() ** 2)))
        feat = max(feat, _q(f - rf) / max(rms, 1e-30))
    return {"color_gap": color, "depth_gap": depth, "feature_gap": feat}


def reference(kind, cfg, traffic, seed, out: dict, device, tf32=False
              ) -> dict:
    """The reference's readings of what ``out``'s timed path produced."""
    if kind == "train":
        return reference_train(cfg, traffic, seed, out["readings"],
                               out["inputs"], device, tf32)
    return reference_serve(cfg, seed, out["readings"], device, tf32)


def numbers(kind, prog: dict, ref: dict) -> dict:
    return (train_numbers if kind == "train" else serve_numbers)(prog, ref)


def run(kind, cfg, traffic, seed, out: dict, device) -> dict:
    """The numbers compared, program against reference."""
    ref = reference(kind, cfg, traffic, seed, out, device)
    return numbers(kind, out["readings"], ref)


def control(kind, cfg, traffic, seed, out: dict, device) -> dict:
    """The same numbers with the reference computed in TF32 put in the
    program's place (the step below the configuration's f32 with TF32
    off), and for training also with the reference's steps leaving the
    state unchanged: {"tf32": numbers, "frozen": numbers}. Their readings
    set the limits' upper ends. ``out`` gives the cameras and views the
    program's run drew. Training adds each leaf's gaps ("leaves": program,
    TF32 control)."""
    ref = reference(kind, cfg, traffic, seed, out, device)
    low = reference(kind, cfg, traffic, seed, out, device, tf32=True)
    res = {"tf32": numbers(kind, low, ref)}
    if kind == "train":
        frozen = reference_train(cfg, traffic, seed, out["readings"],
                                 out["inputs"], device, frozen=True)
        res["frozen"] = numbers(kind, frozen, ref)
        res["leaves"] = {"program": leaf_gaps(out["readings"], ref),
                         "tf32": leaf_gaps(low, ref)}
    return res


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without its number, fails."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    for k in limits:
        if k not in checks:
            checks[k] = {"value": None, "limit": limits[k]}
    ok = all(c["value"] is not None and c["limit"] is not None
             and np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
