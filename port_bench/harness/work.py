"""The work the traced window's views need, counted by the reference's own
binning and blending of the same Gaussians (``reference/render.py``), and
turned into the kernels' bounds and the step's operations by the frozen
yardstick. It reads the Gaussians' geometry as the traced window started."""
from __future__ import annotations

import torch

from port_bench.harness import check, scene
from port_bench.reference import render as R
from port_bench.yardstick import bounds, flops


def geometry(params) -> dict:
    """Copies of the fields the counts depend on (position, shape,
    opacity) of a parameter set with the original model's field names."""
    return {k: getattr(params, k).detach().clone()
            for k in ("xyz", "scaling", "rotation", "opacity")}


def count(cfg: dict, geom: dict, cameras: list, kind: str, device) -> dict:
    """{"fwd_bound_s", "fwd_by", "bwd_bound_s", "bwd_by", "ops"} summed over
    ``cameras``; the backward only for training."""
    n = geom["xyz"].shape[0]
    m = (cfg["sh_degree"] + 1) ** 2
    zeros = lambda *shape: torch.zeros(shape, device=device)
    g = R.activate(dict(geom, features_dc=zeros(n, 1, 3),
                        features_rest=zeros(n, m - 1, 3),
                        semantic_feature=zeros(n, 1, 1)))
    f_r, f_out = scene.rendered_dim(cfg), cfg["feature_dim"]
    w, h, sub = cfg["width"], cfg["height"], cfg["teacher_subsample"]
    n_params = n * (3 + 3 + 3 * (m - 1) + 3 + 4 + 1 + f_r)
    if cfg["speedup"]:
        n_params += f_r * f_out + f_out
    out = {"fwd_bound_s": 0.0, "bwd_bound_s": 0.0, "ops": 0,
           "fwd_bytes": 0, "fwd_ops": 0, "bwd_bytes": 0, "bwd_ops": 0}
    for i in cameras:
        cam = check.ref_cam(cfg, i, device)
        stats = {}
        with torch.no_grad():
            s = R.project(g, cam, cfg["sh_degree"])
            bins = R.bin_tiles(s, cam.width, cam.height, *cfg["tile"])
            R.render(s, bins, cam.width, cam.height, stats=stats)
        n_tiles = bins.grid_x * bins.grid_y
        p = bins.tile_w * bins.tile_h
        fb, fo = bounds.forward_bound(stats, n_tiles, p, f_r)
        out["fwd_bytes"] += fb
        out["fwd_ops"] += fo
        if kind == "train":
            n_inst = int(bins.gid.shape[0])
            bb, bo = bounds.backward_bound(stats, n_tiles, p, n_inst, f_r)
            out["bwd_bytes"] += bb
            out["bwd_ops"] += bo
            out["ops"] += flops.train_step(
                n, n_inst, stats, stats, w, h, (h // sub, w // sub), f_r,
                f_out, cfg["speedup"], n_params)
        else:
            out["ops"] += flops.serve_view(n, stats, w, h, f_r, f_out,
                                           cfg["speedup"])
        del s, bins, stats
    out["fwd_bound_s"], out["fwd_by"] = bounds.bound_seconds(
        out["fwd_bytes"], out["fwd_ops"])
    out["bwd_bound_s"], out["bwd_by"] = bounds.bound_seconds(
        out["bwd_bytes"], out["bwd_ops"])
    return out
