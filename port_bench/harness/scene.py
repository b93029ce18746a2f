"""The cell's inputs, made from ``--seed``: a scene of Gaussians with its
optimizer state as a resume at the configuration's iteration would hold it,
the orbit cameras, and the training views' images and teacher maps.

Everything is drawn on the run's device with ``torch.Generator``s in a few
large calls, one generator per stream so that a reader can redraw one
stream alone: stream 0 the Gaussians, 1 the optimizer state, 2 the views'
images and teachers, 3 the rows and pixels the check samples, 4 the
decoder. Seeds are any non-negative integer below 2**60.
"""
from __future__ import annotations

import math

import numpy as np
import torch

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "semantic_feature")
SH_C0 = 0.28209479177387814


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 8 + stream)
    return g


def rendered_dim(cfg: dict) -> int:
    """Channels each Gaussian carries: the teacher's, or a quarter of them
    under the speed-up decoder."""
    return cfg["feature_dim"] // 4 if cfg["speedup"] else cfg["feature_dim"]


def draw_gaussians(cfg: dict, seed: int, device) -> dict:
    """The scene's parameters by field, in the original model's layout
    (log scales, unnormalised quaternions, opacity logits)."""
    s = cfg["scene"]
    n, f = cfg["n_gaussians"], rendered_dim(cfg)
    m = (cfg["sh_degree"] + 1) ** 2
    g = generator(seed, 0, device)
    kw = dict(generator=g, device=device)
    box = s["box"]
    xyz = torch.rand((n, 3), **kw) * (2 * box) - box
    scaling = math.log(s["scale"]) + s["log_scale_std"] * torch.randn((n, 3),
                                                                       **kw)
    rotation = torch.randn((n, 4), **kw)
    rotation = rotation / torch.linalg.vector_norm(rotation, dim=-1,
                                                   keepdim=True)
    lo, hi = s["opacity"]
    op = lo + (hi - lo) * torch.rand((n, 1), **kw)
    colors = torch.rand((n, 3), **kw)
    rest = s["sh_rest_std"] * torch.randn((n, m - 1, 3), **kw)
    feat = s["feature_std"] * torch.randn((n, 1, f), **kw)
    return {"xyz": xyz, "features_dc": ((colors - 0.5) / SH_C0)[:, None, :],
            "features_rest": rest, "scaling": scaling, "rotation": rotation,
            "opacity": torch.log(op / (1 - op)), "semantic_feature": feat}


def draw_optimizer(cfg: dict, params: dict, seed: int, device) -> dict:
    """Adam's state at the resume: first moments zero, second moments
    (rms * U(0.5, 1.5))^2 with each field's rms from the configuration, the
    step count at the resume's iteration; and, under the speed-up module,
    the decoder with its own Adam state (weights U(-k, k), k = 1/sqrt(F_in),
    as a 1x1 convolution starts)."""
    r = cfg["resume"]
    g = generator(seed, 1, device)
    kw = dict(generator=g, device=device)

    def second(x, rms):
        return (rms * (0.5 + torch.rand(x.shape, **kw))) ** 2

    out = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: second(v, r["adam_rms"][k]) for k, v in params.items()},
           "step": r["iteration"]}
    if cfg["speedup"]:
        dec = draw_decoder(cfg, seed, device)
        out.update(dec=dec,
                   dec_mu={n: torch.zeros_like(v) for n, v in dec.items()},
                   dec_nu={n: second(v, r["adam_rms"]["decoder." + n])
                           for n, v in dec.items()},
                   dec_step=r["iteration"])
    return out


def draw_decoder(cfg: dict, seed: int, device) -> dict:
    """The speed-up decoder's weights {"w": [F/4, F], "b": [F]},
    U(-k, k) with k = 1/sqrt(F/4)."""
    g = generator(seed, 4, device)
    fin, fout = rendered_dim(cfg), cfg["feature_dim"]
    k = 1.0 / math.sqrt(fin)
    return {"w": (torch.rand((fin, fout), generator=g, device=device) * 2 - 1)
            * k,
            "b": (torch.rand((fout,), generator=g, device=device) * 2 - 1) * k}


def orbit(cfg: dict, i: int):
    """(R, T) of orbit view ``i``: bench.py's camera at distance
    ``camera_distance`` turned about z by ``orbit_step_rad`` a view. R is
    the camera-to-world rotation, T the world-to-camera translation."""
    a = cfg["orbit_step_rad"] * i
    c, s = math.cos(a), math.sin(a)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return rot, np.array([0.0, 0.0, cfg["camera_distance"]])


def draw_views(cfg: dict, seed: int, device) -> list:
    """The training views as host arrays: [(image [H,W,3] float32 U(0,1),
    teacher [H/s,W/s,F] float16 N(0, std^2))], drawn on ``device``."""
    g = generator(seed, 2, device)
    w, h, sub = cfg["width"], cfg["height"], cfg["teacher_subsample"]
    std = cfg["scene"]["teacher_std"]
    views = []
    for _ in range(cfg["n_views"]):
        img = torch.rand((h, w, 3), generator=g, device=device)
        teacher = (std * torch.randn((h // sub, w // sub, cfg["feature_dim"]),
                                     generator=g, device=device)).half()
        views.append((img.cpu().numpy(), teacher.cpu().numpy()))
        del img, teacher
    return views


def sample_rows(n: int, k: int, seed: int, device) -> torch.Tensor:
    """``k`` distinct indices below ``n`` drawn from the check's stream."""
    g = generator(seed, 3, device)
    return torch.randperm(n, generator=g, device=device)[:min(k, n)]
