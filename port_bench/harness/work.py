"""The work the traced window's views need, counted by the reference's own
binning and blending of the same Gaussians (``reference/render.py``), and
turned into the kernels' bounds by the frozen yardstick. It reads the
Gaussians' geometry as the traced window started. What an entry counts
besides (a backward, a step's operations) it adds itself
(``entries/<entry>.py:count``)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from port_bench.harness import check, scene
from port_bench.reference import render as R
from port_bench.yardstick import bounds


class View(NamedTuple):
    """One view's counts: the reference's blending statistics, its tiles,
    the pixels a tile, its (Gaussian, tile) instances and the Gaussians."""
    stats: dict
    tiles: int
    pixels: int
    instances: int
    gaussians: int


def geometry(params) -> dict:
    """Copies of the fields the counts depend on (position, shape,
    opacity) of a parameter set with the original model's field names."""
    return {k: getattr(params, k).detach().clone()
            for k in ("xyz", "scaling", "rotation", "opacity")}


def count_views(cfg: dict, geom: dict, cameras: list, device,
                per_view: Callable[[View], dict]) -> dict:
    """{"fwd_bound_s", "fwd_by", "bwd_bound_s", "bwd_by", "ops",
    "fwd_bytes", "fwd_ops", "bwd_bytes", "bwd_ops"}: the forward's bytes
    and operations of each of ``cameras``, plus what ``per_view`` returns
    for it under those keys, summed; then each bound's seconds."""
    n = geom["xyz"].shape[0]
    m = (cfg["sh_degree"] + 1) ** 2
    zeros = lambda *shape: torch.zeros(shape, device=device)
    g = R.activate(dict(geom, features_dc=zeros(n, 1, 3),
                        features_rest=zeros(n, m - 1, 3),
                        semantic_feature=zeros(n, 1, 1)))
    f_r = scene.rendered_dim(cfg)
    out = {"fwd_bound_s": 0.0, "bwd_bound_s": 0.0, "ops": 0,
           "fwd_bytes": 0, "fwd_ops": 0, "bwd_bytes": 0, "bwd_ops": 0}
    for i in cameras:
        cam = check.ref_cam(cfg, i, device)
        stats = {}
        with torch.no_grad():
            s = R.project(g, cam, cfg["sh_degree"])
            bins = R.bin_tiles(s, cam.width, cam.height, *cfg["tile"])
            R.render(s, bins, cam.width, cam.height, stats=stats)
        v = View(stats, bins.grid_x * bins.grid_y, bins.tile_w * bins.tile_h,
                 int(bins.gid.shape[0]), n)
        fb, fo = bounds.forward_bound(stats, v.tiles, v.pixels, f_r)
        out["fwd_bytes"] += fb
        out["fwd_ops"] += fo
        for k, x in per_view(v).items():
            out[k] += x
        del s, bins, stats, v
    out["fwd_bound_s"], out["fwd_by"] = bounds.bound_seconds(
        out["fwd_bytes"], out["fwd_ops"])
    out["bwd_bound_s"], out["bwd_by"] = bounds.bound_seconds(
        out["bwd_bytes"], out["bwd_ops"])
    return out
