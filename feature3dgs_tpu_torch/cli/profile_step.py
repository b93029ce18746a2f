"""Profile the bench-config training step on the card and print its device
events by name: the port of ``scripts/profile_step.py``.

    python -m feature3dgs_tpu_torch.cli.profile_step [--f_dim 128] [--n 3]
        [--top 40] [--save trace.json] [--device cpu]

Runs bench.py's step (``bench_utils.bench_scene`` at the given sizes, 16x16
tiles and an instance capacity of 1 << 19 by default, as the script does)
once, then ``--n`` steps alone and ``--n`` under ``torch.profiler``
(``bench_utils.profile_steps``). Prints the step span (median over the
unprofiled steps of a CUDA-event span around each synchronised step), then
the script's ``med_ms count name`` table of the ``--top`` largest device
events of the profiled steps (kernels, copies, memsets: median ms of each
name and its count), then the device's busy milliseconds a step and its
idle share against the step span. On the CPU (``--device cpu``) the table
lists operators and the idle share is not measured.

``--save PATH`` writes the Chrome trace. ``--dump_hlo DIR`` is accepted:
eager PyTorch compiles no HLO, so it prints one line saying so and writes
nothing. ``--tpp``, ``--chunk`` and ``--bwd_chunk`` are accepted; ``chunk``
reaches ``RasterConfig.chunk``, which only the plain compositor reads (the
kernels stage their own 32 entries), and the other two have no counterpart.
"""
from __future__ import annotations

import statistics
import sys
import time
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description="Profile the bench training step "
                        "(PyTorch port of scripts/profile_step.py)")
    ap.add_argument("--f_dim", type=int, default=128)
    ap.add_argument("--n", type=int, default=3, help="profiled steps")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--n_gauss", type=int, default=100_000)
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--instance_capacity", type=int, default=1 << 19)
    ap.add_argument("--tpp", type=int, default=8,
                    help="accepted and ignored: the TPU kernel's tiles per "
                         "program; the CUDA kernels launch blocks per tile")
    ap.add_argument("--tile_w", type=int, default=16)
    ap.add_argument("--tile_h", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=128,
                    help="RasterConfig.chunk: list entries a step of the "
                         "plain compositor (the kernels stage their own 32)")
    ap.add_argument("--bwd_chunk", type=int, default=64,
                    help="accepted and ignored: the TPU backward kernel's "
                         "chunk; the CUDA backward stages its own entries")
    ap.add_argument("--save", type=str, default=None,
                    help="also write the Chrome trace here")
    ap.add_argument("--dump_hlo", type=str, default=None, metavar="DIR",
                    help="accepted: eager PyTorch compiles no HLO, so "
                         "nothing is written")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import (bench_camera, bench_scene,
                                                   device_label,
                                                   profile_steps, synchronize)
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import (OptimizationConfig,
                                                     TrainState, train_step)
    dev = default_device(args.device)
    if args.dump_hlo:
        print(f"--dump_hlo {args.dump_hlo}: eager PyTorch compiles no HLO; "
              "nothing written")
    params, state, gt_image, gt_feature = bench_scene(
        dev, args.n_gauss, args.f_dim, args.width, args.height)
    ts = TrainState.create(params, state, device=dev)
    del params, state
    cam = bench_camera(args.width, args.height, dev)
    bg = torch.zeros(3, device=dev)
    ocfg = OptimizationConfig()
    rcfg = RasterConfig(instance_capacity=args.instance_capacity,
                        chunk=args.chunk, tile_w=args.tile_w,
                        tile_h=args.tile_h)
    it = [0]

    def step():
        it[0] += 1
        return train_step(ts, cam, gt_image, gt_feature, bg, it[0],
                          ocfg=ocfg, rcfg=rcfg, speedup=False)

    t0 = time.perf_counter()
    m = step()
    synchronize(dev)
    print(f"first step in {time.perf_counter() - t0:.0f}s (kernel build and "
          f"load included); loss={float(m['loss']):.4f} "
          f"instances={int(m['num_instances'])}; device {device_label(dev)}")

    prof = profile_steps(step, args.n, dev)
    if args.save:
        prof["profile"].export_chrome_trace(args.save)
        print(f"trace -> {args.save}")
    print(f"\nstep span: {statistics.median(prof['spans_ms']):.2f} ms  "
          f"(median over {args.n})")
    print(f"{'med_ms':>9} {'count':>5}  name")
    for med, cnt, name in prof["rows"][: args.top]:
        print(f"{med:9.3f} {cnt:5d}  {name[:110]}")
    if prof["busy_ms"] is None:
        print("\ndevice busy: not measured on the CPU")
    else:
        print(f"\ndevice busy: {prof['busy_ms']:.2f} ms a step; idle share "
              f"{prof['idle_share']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
