"""Training: the program's ``Trainer`` resumed from the drawn state, one
camera a step by its own draw, timed over ``Trainer.step``.

The check: the plain reference follows the checked steps from the same
drawn state, cameras and views. Compared, each as the worst over its
leaves:
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

The count: each traced step's forward and backward compositing work and
its operations (``yardstick/bounds.py``, ``yardstick/flops.py``).
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from port_bench.harness import check, program, scene, trace, work
from port_bench.reference import train as T
from port_bench.yardstick import bounds, flops

BETA1 = 0.9     # Adam's first-moment decay in the program and the reference


def run(cfg: dict, traffic: dict, seed: int, seconds: float, device,
        trace_on: bool) -> dict:
    from feature3dgs_tpu_torch.data.dataset import SceneData
    from feature3dgs_tpu_torch.model import optim
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.train.trainer import Trainer, TrainState

    drawn = scene.draw_gaussians(cfg, seed, device)
    opt = scene.draw_optimizer(cfg, drawn, seed, device)
    views = scene.draw_views(cfg, seed, device)
    cams = [program.port_camera(cfg, i, img, teacher)
            for i, (img, teacher) in enumerate(views)]
    colors = (drawn["features_dc"][:, 0] * scene.SH_C0 + 0.5).clamp(0, 1)
    data = SceneData(train_cameras=cams, test_cameras=[],
                     points=drawn["xyz"].cpu().numpy(),
                     colors=colors.cpu().numpy(),
                     nerf_norm={"translate": np.zeros(3),
                                "radius": cfg["resume"]["spatial_lr_scale"]},
                     feature_dim=cfg["feature_dim"], source_path="")
    trainer = Trainer(data, rcfg=program.raster_config(cfg),
                      max_sh_degree=cfg["sh_degree"],
                      speedup=cfg["speedup"], seed=seed % (1 << 32),
                      capacity_headroom=1.0, device=device)
    params, gstate = program.program_gaussians(cfg, drawn, device)
    step0 = torch.tensor(opt["step"], dtype=torch.int32, device=device)
    adam = optim.AdamState(G.GaussianParams(**opt["mu"]),
                           G.GaussianParams(**opt["nu"]), step0)
    dec = dec_adam = None
    if cfg["speedup"]:
        dec = opt["dec"]
        dec_adam = optim.TensorAdamState(
            opt["dec_mu"], opt["dec_nu"],
            torch.tensor(opt["dec_step"], dtype=torch.int32, device=device))
    trainer.restore_state(TrainState(params, gstate, adam, dec, dec_adam))
    trainer.iteration = cfg["resume"]["iteration"]
    del drawn, opt

    picked = []
    pick = trainer.pick_camera

    def recording_pick():
        cam = pick()
        picked.append(cam.uid)
        return cam

    trainer.pick_camera = recording_pick
    every = traffic["sync_every"]

    def step():
        m = trainer.step(sync=(trainer.iteration + 1) % every == 0)
        return m

    # the checked steps: the window's own call, from the drawn state
    ts = trainer.ts
    leaves = lambda: ({k: getattr(ts.params, k) for k in scene.FIELDS}
                      | ({} if ts.decoder is None
                         else {"decoder." + k: v
                               for k, v in ts.decoder.items()}))
    start = {k: v.clone() for k, v in leaves().items()}
    rows = scene.sample_rows(ts.params.capacity, traffic["checked_rows"],
                             seed, device)
    losses, grad_norms, grad_rows = [], {}, {}
    for k in range(traffic["checked_steps"]):
        losses.append(step()["loss"])
        if k == 0:
            # the drawn first moments are zero: mu = (1 - beta1) * g
            mus = {f: getattr(ts.adam.mu, f) for f in scene.FIELDS}
            if ts.decoder_adam is not None:
                mus.update({"decoder." + n: v
                            for n, v in ts.decoder_adam.mu.items()})
            for n, mu in mus.items():
                g = mu / (1 - BETA1)
                grad_norms[n] = float(torch.linalg.vector_norm(g.double()))
                grad_rows[n] = (g if n.startswith("decoder.") else g[rows]
                                ).cpu()
    changes = {k: float(torch.linalg.vector_norm((v - start[k]).double()))
               for k, v in leaves().items()}
    del start
    readings = {"losses": [float(x) for x in losses],
                "grad_norms": grad_norms, "grad_rows": grad_rows,
                "changes": changes, "cameras": picked[:len(losses)],
                "rows": rows.cpu()}
    for _ in range(traffic["warmup_steps"] - traffic["checked_steps"]):
        step()
    program.sync(device)
    setup_end = time.perf_counter()

    n, failed = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        m = step()
        n += 1
        if isinstance(m["finite"], float) and not m["finite"]:
            failed += 1
    program.sync(device)
    window_s = time.perf_counter() - t0

    out = {"unit_kind": "train", "units": n, "window_s": window_s,
           "setup_end": setup_end, "attempted": n, "failed": failed,
           "readings": readings, "inputs": views}
    if trace_on:
        traced = {"geometry": work.geometry(trainer.ts.params)}
        before = len(picked)
        with trace.profiled(device, traced):
            for _ in range(traffic["trace_steps"]):
                step()
        traced["cameras"] = picked[before - 1:before - 1
                                   + traffic["trace_steps"]]
        traced["units"] = traffic["trace_steps"]
        calls = program.blocking_calls(
            lambda: [step() for _ in range(traffic["blocking_steps"])], device)
        traced["blocking_per_unit"] = calls / traffic["blocking_steps"]
        out["traced"] = traced
    out["peak_bytes"] = program.peak_bytes(device)
    trainer.pick_camera = pick
    del trainer, ts
    return out


def reference(cfg, traffic, seed, out: dict, device, tf32: bool = False,
              frozen: bool = False) -> dict:
    """The reference's readings of the checked steps, on the cameras the
    program drew. ``frozen`` plants a fault in it: each step leaves the
    state unchanged, so Adam's first moment, the gradient worked out from
    it and the change all read zero."""
    prog, inputs = out["readings"], out["inputs"]
    with check.precision(tf32):
        params = scene.draw_gaussians(cfg, seed, device)
        opt = scene.draw_optimizer(cfg, params, seed, device)
        state = {"params": params, "spatial_scale":
                 cfg["resume"]["spatial_lr_scale"], **opt}
        start = {k: v.clone() for k, v in params.items()}
        if cfg["speedup"]:
            start.update({"decoder." + k: v.clone()
                          for k, v in opt["dec"].items()})
        rows = prog["rows"].to(device)
        losses, grad_norms, grad_rows = [], {}, {}
        for k, uid in enumerate(prog["cameras"]):
            image, teacher = inputs[uid]
            args = (check.ref_cam(cfg, uid, device),
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
                         for n, g in prog["grad_rows"].items()}
        now = dict(state["params"])
        if cfg["speedup"]:
            now.update({"decoder." + k: v for k, v in state["dec"].items()})
        changes = {k: float(torch.linalg.vector_norm((now[k] - start[k])
                                                     .double()))
                   for k in start}
    return {"losses": losses, "grad_norms": grad_norms,
            "grad_rows": grad_rows, "changes": changes}


def frozen(cfg, traffic, seed, out: dict, device) -> dict:
    """The control's planted fault: the reference with steps that leave the
    state unchanged."""
    return reference(cfg, traffic, seed, out, device, frozen=True)


def _gap(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    if not keys:
        return 0.0
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def leaves(prog: dict, ref: dict) -> dict:
    """Each leaf's gap of gradient norms and of change norms, against the
    larger of its reference norm and the median leaf's (calibration)."""
    out = {}
    for key in ("grad_norms", "changes"):
        r = ref[key]
        med = statistics.median(r.values())
        out[key] = {k: abs(prog[key][k] - r[k]) / max(r[k], med, 1e-30)
                    for k in r}
    return out


def numbers(prog: dict, ref: dict) -> dict:
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


def count(cfg: dict, traced: dict, device) -> dict:
    """The traced steps' forward and backward work and operations; takes
    the Gaussians' geometry out of ``traced``."""
    geom = traced.pop("geometry")
    n = geom["xyz"].shape[0]
    m = (cfg["sh_degree"] + 1) ** 2
    f_r, f_out = scene.rendered_dim(cfg), cfg["feature_dim"]
    w, h, sub = cfg["width"], cfg["height"], cfg["teacher_subsample"]
    n_params = n * (3 + 3 + 3 * (m - 1) + 3 + 4 + 1 + f_r)
    if cfg["speedup"]:
        n_params += f_r * f_out + f_out

    def backward(v: work.View) -> dict:
        bb, bo = bounds.backward_bound(v.stats, v.tiles, v.pixels,
                                       v.instances, f_r)
        return {"bwd_bytes": bb, "bwd_ops": bo, "ops": flops.train_step(
            n, v.instances, v.stats, v.stats, w, h, (h // sub, w // sub),
            f_r, f_out, cfg["speedup"], n_params)}

    return work.count_views(cfg, geom, traced["cameras"], device, backward)
