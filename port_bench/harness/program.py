"""What the entries (``port_bench/entries/``) share on the program's side:
the program's Gaussians, cameras and raster settings made from the cell's
inputs, and its host calls that wait on the card.

Only these functions and the entries touch the program
(``feature3dgs_tpu_torch``), and only inside a call.
"""
from __future__ import annotations

import warnings

import torch

from port_bench.harness import scene


def sync(device):
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


def peak_bytes(device) -> int:
    """The allocator's peak so far; 0 off the card."""
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
