"""Gradient/pixel parity report: the port of ``scripts/parity_check.py``.

    python -m feature3dgs_tpu_torch.cli.parity_check [--device cpu]

Renders the script's synthetic scene (1,000 random Gaussians drawn as
``tests/utils.py`` draws them with seed 0, 208x160, RGB + 8 feature
channels + depth, SH degree 3, background (0.2, 0.3, 0.4)) through each
compositing route, differentiates the script's loss, mean |color| + mean
feature^2 + mean depth * alpha, with respect to means3d, opacity and
feature, and prints the largest pixel and gradient deviations as one JSON
line per comparison:

  * cuda-vs-plain: the CUDA kernels against their plain PyTorch versions
    (the script's pallas-vs-xla line; on the card only);
  * plain-vs-oracle: the plain compositor against the per-pixel oracle
    (``ops/oracle.py``), the comparison the script's docstring names. The
    oracle shares no code with the tiled compositor, so agreement of all
    three checks the kernels against the original's math.

A line passes when every deviation is below 5e-4; the last line is
{"backend", "platform", "all_pass"}, and the exit code is 0 when all pass,
else 1. The card is used unless ``--device cpu`` is given, where only
plain-vs-oracle runs (no kernel runs on the CPU).
"""
from __future__ import annotations

import json
import sys
from argparse import ArgumentParser

import numpy as np
import torch

WIDTH, HEIGHT, N_GAUSS, F_DIM, SH_DEGREE = 208, 160, 1000, 8, 3
BG = (0.2, 0.3, 0.4)
TOL = 5e-4
GRAD_NAMES = ("d_means", "d_opacity", "d_feature")


def parity_scene(f_dim: int = F_DIM, device=None) -> dict:
    """The script's camera and Gaussians as tensors on
    ``default_device(device)``: {"cam", "means3d", "opacities", "feat",
    "kw"} with ``kw`` the rasterize keywords (scales, rotations, shs,
    sh_degree, bg)."""
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.data.synthetic import (make_camera,
                                                      random_gaussians)
    device = default_device(device)
    g = random_gaussians(n=N_GAUSS, f_dim=f_dim, seed=0)
    # The script passes sh_degree=3 with the 9 coefficient rows these draws
    # hold; JAX clamps the out-of-range row index, so its rows 9-15 read
    # row 8. The same rows here give the same colours.
    shs = g["shs"][:, np.minimum(np.arange((SH_DEGREE + 1) ** 2), 8)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"cam": make_camera(width=WIDTH, height=HEIGHT, device=device),
            "means3d": t(g["means3d"]), "opacities": t(g["opacities"]),
            "feat": t(g["feat"]),
            "kw": dict(scales=t(g["scales"]), rotations=t(g["rotations"]),
                       shs=t(shs), sh_degree=SH_DEGREE,
                       bg=torch.tensor(BG, device=device))}


def raster_config(backend: str, alpha_matmul: bool = False):
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    return RasterConfig(instance_capacity=1 << 14, chunk=32, backend=backend,
                        alpha_matmul=alpha_matmul)


def _loss(color, feature, depth, alpha):
    return (color.abs().mean() + (feature ** 2).mean()
            + (depth * alpha).mean())


def _leaves(scene):
    return [scene[k].detach().clone().requires_grad_(True)
            for k in ("means3d", "opacities", "feat")]


def run_route(scene, backend: str, alpha_matmul: bool = False):
    """({color, feature, depth, alpha}, (d_means, d_opacity, d_feature))
    through ``ops.rasterize`` on ``backend``."""
    from feature3dgs_tpu_torch.ops.rasterize import rasterize
    means, op, feat = _leaves(scene)
    o = rasterize(means, op, feat, scene["cam"],
                  config=raster_config(backend, alpha_matmul), **scene["kw"])
    out = {"color": o.color, "feature": o.feature, "depth": o.depth,
           "alpha": o.alpha}
    grads = torch.autograd.grad(_loss(**out), (means, op, feat))
    return {k: v.detach() for k, v in out.items()}, grads


def run_oracle(scene):
    """The same outputs and gradients through ``ops/oracle.py`` on the
    rasterizer's own tile grid."""
    from feature3dgs_tpu_torch.core.projection import preprocess
    from feature3dgs_tpu_torch.ops.oracle import oracle_composite
    means, op, feat = _leaves(scene)
    kw = dict(scene["kw"])
    bg, grid = kw.pop("bg"), raster_config("plain").grid(WIDTH, HEIGHT)
    pre = preprocess(means, op, scene["cam"], **kw)
    o = oracle_composite(pre, feat, bg, grid)
    out = {"color": o["color"], "feature": o["feature"], "depth": o["depth"],
           "alpha": 1.0 - o["final_T"]}
    grads = torch.autograd.grad(_loss(**out), (means, op, feat))
    return {k: v.detach() for k, v in out.items()}, grads


def report(name: str, a: dict, b: dict, ga, gb) -> bool:
    """Print the script's JSON line for one comparison; True if it passes."""
    line = {"compare": name}
    for k in ("color", "feature", "depth", "alpha"):
        line[f"{k}_max"] = float((a[k] - b[k]).abs().max())
    for gname, x, y in zip(GRAD_NAMES, ga, gb):
        s = max(float(y.abs().max()), 1e-12)
        line[f"{gname}_relmax"] = float((x - y).abs().max()) / s
    line["pass"] = all(v < TOL for v in line.values() if isinstance(v, float))
    print(json.dumps(line), flush=True)
    return line["pass"]


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Pixel and gradient parity of the "
                            "compositing routes (PyTorch)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from feature3dgs_tpu_torch import default_device
    device = default_device(args.device)
    scene = parity_scene(device=device)
    on_card = device.type == "cuda"
    plain, g_plain = run_route(scene, "plain")
    ok = True
    if on_card:
        cuda, g_cuda = run_route(scene, "cuda")
        ok &= report("cuda-vs-plain", cuda, plain, g_cuda, g_plain)
    oracle, g_oracle = run_oracle(scene)
    ok &= report("plain-vs-oracle", plain, oracle, g_plain, g_oracle)
    print(json.dumps({"backend": "cuda" if on_card else "plain",
                      "platform": "gpu" if on_card else "cpu",
                      "all_pass": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
