"""Scaling of the data x tile sharded train step over the cards of a
``torchrun`` world: the port of ``scripts/bench_scaling.py``.

    python -m feature3dgs_tpu_torch.cli.bench_scaling [--small] [--iters 3]
        [--shard_gaussians [--shard_instances]] [--device cpu]
    torchrun --nproc_per_node=N -m feature3dgs_tpu_torch.cli.bench_scaling

Runs ``parallel/sharded.py:sharded_train_step`` on the first d ranks of the
world for d = 1, 2, 4, ... up to the world size, with the script's mesh
rule (two cameras a step on a data axis of 2 when d is even and above 1,
the rest on the tile axis) and its inputs (``build_inputs``: the script's
numpy draws, seed 0), and prints one JSON line per size from rank 0:
devices, mesh, images_per_step, platform, backend, step_ms (median of
``--iters`` CUDA-event spans of synchronised steps after a warm-up step,
rank 0's), step_ms_ratio_vs_1dev and efficiency_vs_1dev, and
``device`` (the card's name and power limit). Every rank builds every
size's mesh (its process groups are made by all ranks); the ranks outside
a size wait at a barrier.

The script's ``hlo_*``, ``*_per_image_ratio`` and ``replicated_*_fraction``
fields come from XLA's compiled-cost model, which eager PyTorch does not
have: as the script does for a backend without one, they are left out and
``# cost_analysis unavailable: ...`` goes to stderr; ``--cost_only`` then
prints the structure fields alone. One process (no torchrun) gives the
1-device row only, which is no scaling measurement.
"""
from __future__ import annotations

import json
import math
import sys
from argparse import ArgumentParser

import numpy as np

def build_inputs(n_gauss, f_dim, w, h, n_data, capacity, device=None):
    """The script's state, cameras and targets (bench_scaling.py:43-77),
    numpy draws in its order: (TrainState, [n_data CameraViews], gt_images
    [n_data,h,w,3], gt_features [n_data,h/2,w/2,f_dim]) on
    ``default_device(device)``."""
    import torch

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import camera
    from feature3dgs_tpu_torch.core import transforms
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.train.trainer import TrainState
    dev = default_device(device)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1.5, 1.5, (n_gauss, 3)).astype(np.float32)
    params, state = G.create_from_pcd(
        pts, rng.rand(n_gauss, 3).astype(np.float32), max_sh_degree=3,
        feature_dim=f_dim, capacity=capacity,
        knn_mean_dists=np.full(n_gauss, 1e-3, np.float32), device=dev)
    params.semantic_feature = torch.from_numpy(
        rng.randn(params.capacity, 1, f_dim).astype(np.float32) * 0.1).to(dev)
    state.active_sh_degree = 3
    ts = TrainState.create(params, state, device=dev)

    cams = []
    for i in range(n_data):
        th = i * 0.3
        view = transforms.world_to_view(
            np.eye(3), np.array([math.sin(th), 0.0, 4.0 + math.cos(th)]))
        cams.append(camera(view, w, h, math.tan(0.5), math.tan(0.4), dev))
    gt_images = torch.from_numpy(
        rng.rand(n_data, h, w, 3).astype(np.float32)).to(dev)
    gt_features = torch.from_numpy(
        rng.randn(n_data, h // 2, w // 2, f_dim).astype(np.float32)).to(dev)
    return ts, cams, gt_images, gt_features


def mesh_sizes(world: int) -> list:
    """[(devices, n_data, n_tile)] of the script's mesh rule."""
    out = []
    for d in (1, 2, 4, 8, 16, 32):
        if d <= world:
            n_data = 2 if d % 2 == 0 and d > 1 else 1
            out.append((d, n_data, d // n_data))
    return out


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Scaling of the sharded train step "
                            "(PyTorch port of scripts/bench_scaling.py)")
    parser.add_argument("--n_gauss", type=int, default=100_000)
    parser.add_argument("--f_dim", type=int, default=128)
    parser.add_argument("--width", type=int, default=1216)
    parser.add_argument("--height", type=int, default=800)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--instance_capacity", type=int, default=393216)
    parser.add_argument("--tile_capacity", type=int, default=1 << 11,
                        help="accepted and ignored: the port never "
                             "truncates tile lists")
    parser.add_argument("--backend", type=str, default="auto",
                        help="RasterConfig.backend: auto, cuda or plain")
    parser.add_argument("--small", action="store_true",
                        help="tiny shapes for CPU-mesh validation runs")
    parser.add_argument("--cost_only", action="store_true",
                        help="skip the timing loops; eager PyTorch has no "
                             "compiled-cost model, so only the structure "
                             "fields are printed")
    parser.add_argument("--shard_gaussians", action="store_true",
                        help="row-shard params/Adam over all mesh devices "
                             "(gather-in, reduce-scatter-out; the memory-"
                             "scaling mode) instead of replicating them")
    parser.add_argument("--shard_instances", action="store_true",
                        help="also shard binning and compositing by tile "
                             "owner through the instance exchange (implies "
                             "--shard_gaussians)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; cpu "
                             "runs gloo ranks on the plain compositor)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.small:
        args.n_gauss, args.f_dim = 2_000, 16
        args.width, args.height = 256, 192
        args.instance_capacity, args.tile_capacity = 1 << 14, 1 << 9
    import torch
    import torch.distributed as dist

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import (device_label, platform,
                                                   profiled_step_ms)
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.parallel import make_mesh, sharded_train_step
    from feature3dgs_tpu_torch.parallel import distributed as dist_lib
    from feature3dgs_tpu_torch.parallel.sharded import shard_state
    from feature3dgs_tpu_torch.train.trainer import OptimizationConfig
    dev = default_device(args.device)
    dist_lib.initialize(dev)
    world, rank = dist_lib.process_count(), dist_lib.process_index()
    cfg = RasterConfig(instance_capacity=args.instance_capacity, chunk=128,
                       backend=args.backend)
    ocfg = OptimizationConfig()
    bg = torch.zeros(3, device=dev)
    label = device_label(dev) if rank == 0 else None
    base = None

    for d, n_data, n_tile in mesh_sizes(world):
        mesh = make_mesh((n_data, n_tile), ranks=range(d))
        if rank == 0:
            print("# cost_analysis unavailable: eager PyTorch has no "
                  "compiled-cost model", file=sys.stderr)
        if mesh.member:
            ts, cams, gt_i, gt_f = build_inputs(
                args.n_gauss, args.f_dim, args.width, args.height, n_data,
                args.n_gauss, dev)
            sharded = (args.shard_gaussians or args.shard_instances) and d > 1
            flags = dict(shard_gaussians=sharded,
                         shard_instances=args.shard_instances and d > 1)
            if sharded:
                ts = shard_state(ts, mesh)

            def step_and_block():
                sharded_train_step(ts, cams, gt_i, gt_f, bg, 1, mesh=mesh,
                                   ocfg=ocfg, rcfg=cfg, **flags)

            rec = {"devices": d, "mesh": [n_data, n_tile],
                   "images_per_step": n_data, "platform": platform(dev),
                   "backend": cfg.backend}
            if not args.cost_only:
                step_and_block()                       # warm-up
                step_ms = profiled_step_ms(step_and_block, n=args.iters,
                                           device=dev)
                # pixels processed per step scale with the data axis
                per_img_ms = step_ms / n_data
                if base is None:
                    base = (per_img_ms, step_ms)
                rec.update({
                    "step_ms": round(step_ms, 2),
                    "step_ms_ratio_vs_1dev": round(step_ms / base[1], 4),
                    "efficiency_vs_1dev": round(base[0] / per_img_ms / d, 4),
                })
            rec["device"] = label
            if rank == 0:
                print(json.dumps(rec), flush=True)
            del ts, cams, gt_i, gt_f
        if world > 1:
            dist.barrier()
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
