"""Forward-render throughput on the card: the port of
``scripts/bench_render.py``.

    python -m feature3dgs_tpu_torch.cli.bench_render [--f_dims 16 128 256]
        [--iters 5] [--batch B] [--device cpu]

Renders RGB + F feature channels + depth, forward only, at bench.py's
scene scale (the script's numpy draws, seed 0: 100K Gaussians, 1216x800,
opacity 0.5, SH degree 3) for each F of ``--f_dims`` and prints one JSON
line per F with the script's keys (``metric``, ``f_dim``, ``render_ms`` a
view, ``fps``, ``batch``, ``image``, ``n_gauss``, ``platform``) and
``device``, the card's name and power limit. ``--batch B`` > 1 renders the
script's B orbit views (rotated about z by 0.05 i) through
``render/renderer.py:render_batch`` in one call. A render is timed as a
CUDA-event span around a synchronised call, median of ``--iters`` after a
warm-up (``bench_utils.profiled_step_ms``).
"""
from __future__ import annotations

import json
import sys
from argparse import ArgumentParser

import numpy as np


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description="Forward-render throughput (PyTorch "
                        "port of scripts/bench_render.py)")
    ap.add_argument("--n_gauss", type=int, default=100_000)
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--f_dims", type=int, nargs="+", default=[16, 128, 256])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per batched render call "
                         "(renderer.render_batch; amortizes the per-frame "
                         "preprocess/binning fixed cost)")
    ap.add_argument("--instance_capacity", type=int, default=393216)
    ap.add_argument("--tile_capacity", type=int, default=1 << 11,
                    help="accepted and ignored: the port never truncates "
                         "tile lists")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import (bench_camera, device_label,
                                                   platform, profiled_step_ms)
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.render import renderer
    dev = default_device(args.device)

    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.0, 2.0, (args.n_gauss, 3)).astype(np.float32)
    rcfg = RasterConfig(instance_capacity=args.instance_capacity, chunk=128)
    cams = [bench_camera(args.width, args.height, dev, i)
            for i in range(args.batch)]

    for f_dim in args.f_dims:
        params, state = G.create_from_pcd(
            pts, rng.rand(args.n_gauss, 3).astype(np.float32),
            max_sh_degree=3, feature_dim=f_dim, capacity=args.n_gauss,
            knn_mean_dists=np.full(args.n_gauss, 2e-4, np.float32),
            device=dev)
        params.semantic_feature = torch.from_numpy(
            rng.randn(args.n_gauss, 1, f_dim).astype(np.float32) * 0.1).to(dev)
        params.opacity = torch.zeros((args.n_gauss, 1), device=dev)
        state.active_sh_degree = 3

        @torch.inference_mode()
        def render():
            if args.batch > 1:
                out = renderer.render_batch(params, state, cams, config=rcfg)
            else:
                out = renderer.render(params, state, cams[0], config=rcfg)
            return out.color, out.feature, out.depth

        render()                                       # warm-up
        ms = profiled_step_ms(render, n=args.iters, device=dev)
        print(json.dumps({
            "metric": "forward-render FPS (RGB+feat+depth)",
            "f_dim": f_dim, "render_ms": round(ms / args.batch, 2),
            "fps": round(1000.0 * args.batch / ms, 1),
            "batch": args.batch,
            "image": [args.width, args.height], "n_gauss": args.n_gauss,
            "platform": platform(dev), "device": device_label(dev),
        }), flush=True)
        del params, state
    return 0


if __name__ == "__main__":
    sys.exit(main())
