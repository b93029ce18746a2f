"""The entries a traffic mix drives: the program's training loop and its
renderer, each set up from the cell's inputs, warmed up, then timed.

Each entry returns a dict that the metric readers and the check read:
  "units": steps or views completed in the window, "unit_kind": "train" or
  "serve", "window_s", "setup_end" (host clock at the first timed step),
  "latencies_s" (serving: one per request), "attempted", "failed",
  "readings" (what the program produced, for the check), and "traced": the
  traced window and the counts it needs, when asked for.

Only these functions touch the program (``feature3dgs_tpu_torch``).
"""
from __future__ import annotations

import random
import time
import warnings

import numpy as np
import torch

from port_bench.harness import scene, trace, work

BETA1 = 0.9     # Adam's first-moment decay in the program and the reference


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def blocking_calls(fn, device) -> int:
    """Host calls that wait on the card while ``fn()`` runs (CUDA's sync
    debug mode); 0 off the card. A copy of the program's own counter."""
    if device.type != "cuda":
        return 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def raster_config(cfg: dict):
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    tw, th = cfg["tile"]
    return RasterConfig(tile_w=tw, tile_h=th,
                        instance_capacity=cfg["instance_capacity"])


def program_gaussians(cfg: dict, drawn: dict, device):
    from feature3dgs_tpu_torch.model import gaussians as G
    params = G.GaussianParams(**{k: drawn[k] for k in scene.FIELDS})
    n = drawn["xyz"].shape[0]
    state = G.GaussianState.fresh(
        torch.ones(n, dtype=torch.bool, device=device),
        active_sh_degree=cfg["sh_degree"],
        spatial_lr_scale=cfg["resume"]["spatial_lr_scale"])
    return params, state


def port_camera(cfg: dict, i: int, image=None, teacher=None):
    from feature3dgs_tpu_torch.data.cameras import Camera
    rot, t = scene.orbit(cfg, i)
    return Camera(uid=i, colmap_id=i, R=rot, T=t, fovx=cfg["fovx"],
                  fovy=cfg["fovy"], image=image, image_name=f"view{i:03d}",
                  semantic_feature=teacher, width=cfg["width"],
                  height=cfg["height"])


# ------------------------------------------------------------------ train

def train(cfg: dict, traffic: dict, seed: int, seconds: float, device,
          trace_on: bool) -> dict:
    from feature3dgs_tpu_torch.data.dataset import SceneData
    from feature3dgs_tpu_torch.model import optim
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.train.trainer import Trainer, TrainState

    drawn = scene.draw_gaussians(cfg, seed, device)
    opt = scene.draw_optimizer(cfg, drawn, seed, device)
    views = scene.draw_views(cfg, seed, device)
    cams = [port_camera(cfg, i, img, teacher)
            for i, (img, teacher) in enumerate(views)]
    colors = (drawn["features_dc"][:, 0] * scene.SH_C0 + 0.5).clamp(0, 1)
    data = SceneData(train_cameras=cams, test_cameras=[],
                     points=drawn["xyz"].cpu().numpy(),
                     colors=colors.cpu().numpy(),
                     nerf_norm={"translate": np.zeros(3),
                                "radius": cfg["resume"]["spatial_lr_scale"]},
                     feature_dim=cfg["feature_dim"], source_path="")
    trainer = Trainer(data, rcfg=raster_config(cfg),
                      max_sh_degree=cfg["sh_degree"],
                      speedup=cfg["speedup"], seed=seed % (1 << 32),
                      capacity_headroom=1.0, device=device)
    params, gstate = program_gaussians(cfg, drawn, device)
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
    _sync(device)
    setup_end = time.perf_counter()

    n, failed = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        m = step()
        n += 1
        if isinstance(m["finite"], float) and not m["finite"]:
            failed += 1
    _sync(device)
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
        calls = blocking_calls(
            lambda: [step() for _ in range(traffic["blocking_steps"])], device)
        traced["blocking_per_unit"] = calls / traffic["blocking_steps"]
        out["traced"] = traced
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    trainer.pick_camera = pick
    del trainer, ts
    return out


# ------------------------------------------------------------------ serve

def serve(cfg: dict, traffic: dict, seed: int, seconds: float, device,
          trace_on: bool) -> dict:
    from feature3dgs_tpu_torch.model.decoder import apply_decoder
    from feature3dgs_tpu_torch.render import renderer

    drawn = scene.draw_gaussians(cfg, seed, device)
    dec = scene.draw_decoder(cfg, seed, device) if cfg["speedup"] else None
    params, state = program_gaussians(cfg, drawn, device)
    del drawn
    rcfg = raster_config(cfg)
    bg = torch.zeros(3, device=device)
    batch = traffic["batch"]
    pixels = scene.sample_rows(cfg["width"] * cfg["height"],
                               traffic["checked_pixels"], seed, device)

    def request(k: int) -> list:
        """Views k*batch .. (k+1)*batch - 1 of the orbit: [(view index,
        colour, depth, decoded feature map)]."""
        idx = list(range(k * batch, (k + 1) * batch))
        cams = [port_camera(cfg, i).to_view(device) for i in idx]
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
    _sync(device)
    setup_end = time.perf_counter()

    rng = random.Random(seed)
    keep, seen = [], 0
    lat = []
    k = traffic["warmup_requests"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        r0 = time.perf_counter()
        answers = request(k)
        _sync(device)
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
    _sync(device)
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
                _sync(device)
        traced["cameras"] = list(range(first * batch, (first + traffic[
            "trace_requests"]) * batch))
        traced["units"] = traffic["trace_requests"] * batch
        kb = first + traffic["trace_requests"]
        calls = sum(blocking_calls(lambda j=j: request(kb + j), device)
                    for j in range(traffic["blocking_requests"]))
        traced["blocking_per_unit"] = calls / (traffic["blocking_requests"]
                                               * batch)
        traced["batch"] = batch
        out["traced"] = traced
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    del params, state, dec
    return out


ENTRIES = {"train": train, "serve": serve}
