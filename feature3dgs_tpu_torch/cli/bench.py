"""Training-step throughput on the card: the port of the root ``bench.py``.

    python -m feature3dgs_tpu_torch.cli.bench [--f_dim F] [--alpha_matmul]
        [--device cpu]

Times full forward + backward + Adam training iterations
(``train/trainer.py:train_step``: RGB + F semantic channels + depth, the
reference loss, no speed-up decoder) on bench.py's synthetic scene
(``bench_utils.bench_scene``: 100K Gaussians, 1216x800, 128 channels,
32x16 tiles, instance capacity 393,216). The first step is timed alone
(``compile_s``: the kernels' build and load included), one more warms up,
and ``step_ms`` is the median of ``ITERS`` steps, each a CUDA-event span
around a synchronised step (``bench_utils.profiled_step_ms``). Prints one
JSON line with bench.py's keys:

  {"metric", "value" (pix/s), "unit", "vs_baseline", "detail": {"step_ms",
   "timing_method", "compile_s", "instances", "image", "n_gauss", "f_dim",
   "device", "loss"}}

``vs_baseline`` is against bench.py's ``REFERENCE_PIX_S`` (its estimate of
the CUDA reference's training throughput). ``device`` is the card's name
and power limit. There is no fallback: a failing step raises.
"""
from __future__ import annotations

import json
import sys
import time
from argparse import ArgumentParser

REFERENCE_PIX_S = 6.0e6

N_GAUSS = 100_000
F_DIM = 128
W, H = 1216, 800
ITERS = 10
INSTANCE_CAPACITY = 393216

XLA_SWITCH = ("accepted and ignored: an XLA A/B switch of the JAX package; "
              "the port has one implementation")


def make_step(device=None, f_dim=None, alpha_matmul: bool = False,
              backend: str = "auto"):
    """bench.py's training step on ``default_device(device)``: returns (ts,
    step) where ``step(iteration)`` runs ``train_step`` on the scene's
    TrainState ``ts`` (updated in place) and returns its metrics (device
    tensors, no host read). The module constants size the scene."""
    import torch

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import bench_camera, bench_scene
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import (OptimizationConfig,
                                                     TrainState, train_step)
    dev = default_device(device)
    f_dim = F_DIM if f_dim is None else f_dim
    params, state, gt_image, gt_feature = bench_scene(dev, N_GAUSS, f_dim, W, H)
    ts = TrainState.create(params, state, device=dev)
    cam = bench_camera(W, H, dev)
    bg = torch.zeros(3, device=dev)
    ocfg = OptimizationConfig()
    rcfg = RasterConfig(instance_capacity=INSTANCE_CAPACITY, chunk=128,
                        backend=backend, alpha_matmul=alpha_matmul)

    def step(iteration: int) -> dict:
        return train_step(ts, cam, gt_image, gt_feature, bg, iteration,
                          ocfg=ocfg, rcfg=rcfg, speedup=False)

    return ts, step


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description="Training-step throughput (PyTorch port "
                        "of bench.py)")
    ap.add_argument("--f_dim", type=int, default=None,
                    help="semantic channel count (default F_DIM = 128; "
                         "reference configs: 128 LSeg-speedup, 256 SAM, 512 "
                         "LSeg-editing)")
    ap.add_argument("--blur_impl", choices=["matmul", "shift"], default=None,
                    help=XLA_SWITCH)
    ap.add_argument("--resize_impl", choices=["matmul", "blocked", "stride"],
                    default=None, help=XLA_SWITCH)
    ap.add_argument("--alpha_matmul", action="store_true",
                    help="the kernels' alpha_matmul mode "
                         "(RasterConfig.alpha_matmul)")
    ap.add_argument("--resize_precision",
                    choices=["default", "high", "highest"], default=None,
                    help=XLA_SWITCH)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import (device_label,
                                                   profiled_step_ms,
                                                   synchronize, timing_method)
    dev = default_device(args.device)
    f_dim = F_DIM if args.f_dim is None else args.f_dim
    _, step = make_step(dev, f_dim, args.alpha_matmul)

    t0 = time.perf_counter()
    metrics = step(1)
    synchronize(dev)
    compile_s = time.perf_counter() - t0
    state = {"it": 1, "metrics": metrics}

    def step_and_block():
        state["it"] += 1
        state["metrics"] = step(state["it"])

    step_and_block()                                   # warm-up
    step_ms = profiled_step_ms(step_and_block, n=ITERS, device=dev)
    m = state["metrics"]
    pix_s = W * H / (step_ms / 1e3)
    print(json.dumps({
        "metric": f"train-step pixels/s (fwd+bwd+adam, RGB+{f_dim}f, "
                  "100K gauss)",
        "value": round(pix_s, 1),
        "unit": "pix/s",
        "vs_baseline": round(pix_s / REFERENCE_PIX_S, 4),
        "detail": {
            "step_ms": round(step_ms, 2),
            "timing_method": timing_method(dev),
            "compile_s": round(compile_s, 1),
            "instances": int(m["num_instances"]),
            "image": [W, H], "n_gauss": N_GAUSS, "f_dim": f_dim,
            "device": device_label(dev),
            "loss": float(m["loss"]),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
