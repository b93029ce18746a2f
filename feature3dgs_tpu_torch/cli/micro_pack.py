"""The instance-slab gather at wide lane counts against the port's reads by
id, on the card: the port of ``scripts/micro_pack.py``.

    python -m feature3dgs_tpu_torch.cli.micro_pack [--iters 3]
        [--n_gauss 100000] [--width 1216] [--height 800] [--device cpu]

The JAX kernels read a packed per-instance slab, [L, 128 + F] lanes
gathered from a per-Gaussian table by each instance's id. The script times
that gather at F = 512 (L = 552,960 instances of N = 100,000 Gaussians,
ids and table from RandomState(0) in its order, ``build_inputs``) in four
forms, ported here as ``index_select``:

  one_640     the [N + 1, 640] table, one gather
  split       the [N + 1, 128] misc and [N + 1, 512] feature tables
  feat_only   the 512-lane feature gather alone
  misc_only   the 128-lane misc gather alone

The misc and feature tables are copies of the table's columns, as the
script's sliced JAX arrays are. The gathers are checked bit for bit
against one another first (``check_agreement``).

The port has no slab: its forward kernel reads the scalars and feature
rows of each list entry by id through ``gid_sorted``. ``kernel_reads``
times that kernel (``ops/rasterize.py:composite``, no grad) on
``bench_utils.bench_scene`` at F = 512 (bench.py's scene and camera,
32x16 tiles; 303,278 instances at the defaults; the scene flags shrink
it) and prints its instance
count; on the CPU it runs the kernel's plain version. Each row is timed
as a CUDA-event span of a synchronised call, median of ``--iters``
(``bench_utils.profiled_step_ms``). The first line names the card and its
power limit; each row carries its bytes bound at
``bench_utils.PEAK_BYTES``: for a gather the ids and the table rows they
use read once and the gathered rows written once; for the kernel the
Gaussians its lists name, their ids, the tiles' starts and counts read
once and every output written once.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser

import numpy as np
import torch

L = 552_960
N = 100_000
F_DIM = 512     # the script's feature lanes, kernel_reads' channels


def build_parser() -> ArgumentParser:
    from feature3dgs_tpu_torch import bench_utils
    ap = ArgumentParser(description="Instance-slab gather against the "
                        "kernel's reads by id (PyTorch port of "
                        "scripts/micro_pack.py)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--n_gauss", type=int, default=bench_utils.N_GAUSS,
                    help="kernel_reads: Gaussians of bench_scene")
    ap.add_argument("--width", type=int, default=bench_utils.WIDTH)
    ap.add_argument("--height", type=int, default=bench_utils.HEIGHT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def build_inputs():
    """The script's (seg [L] int32 in [0, N], t640 [N + 1, 640] float32)
    from RandomState(0) in its order."""
    rng = np.random.RandomState(0)
    seg = rng.randint(0, N + 1, L).astype(np.int32)
    t640 = rng.randn(N + 1, 640).astype(np.float32)
    return seg, t640


def gathers(t640: torch.Tensor) -> dict:
    """name -> (fn(seg), the tables it reads) of the script's four."""
    t128 = t640[:, :128].contiguous()
    t512 = t640[:, 128:].contiguous()
    take = lambda t, s: t.index_select(0, s)
    return {"one_640": (lambda s: (take(t640, s),), (t640,)),
            "split": (lambda s: (take(t128, s), take(t512, s)),
                      (t128, t512)),
            "feat_only": (lambda s: (take(t512, s),), (t512,)),
            "misc_only": (lambda s: (take(t128, s),), (t128,))}


def check_agreement(outs: dict) -> None:
    """The four gathers' rows bit-equal, on their device (the gathered
    rows are 1.4 GB at the script's sizes)."""
    (whole,), (misc, feat) = outs["one_640"], outs["split"]
    for name, got, want in (("split misc", misc, whole[:, :128]),
                            ("split features", feat, whole[:, 128:]),
                            ("feat_only", outs["feat_only"][0], feat),
                            ("misc_only", outs["misc_only"][0], misc)):
        if not torch.equal(got, want):
            raise AssertionError(f"micro_pack: {name} differs from one_640")


def kernel_inputs(args, dev):
    """``composite``'s inputs for bench_scene at F_DIM, seen from
    bench_camera (the default RasterConfig). The scene's teacher is drawn
    one channel wide: it comes after the parameters' draws and is not
    used here."""
    from feature3dgs_tpu_torch import bench_utils
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    params, state, _, _ = bench_utils.bench_scene(
        dev, n_gauss=args.n_gauss, f_dim=F_DIM, width=args.width,
        height=args.height, teacher_dim=1)
    cam = bench_utils.bench_camera(args.width, args.height, dev)
    opacity = torch.where(state.alive, G.get_opacity(params),
                          torch.zeros((), device=dev))
    with torch.no_grad():
        return composite_inputs(
            params.xyz, opacity, G.get_semantic(params), cam,
            scales=G.get_scaling(params), rotations=G.get_rotation(params),
            shs=G.get_features(params), sh_degree=state.active_sh_degree,
            active_mask=state.alive, config=RasterConfig())


def kernel_bytes(ci) -> int:
    """The forward's inputs read once (x, y, conic, opacity, rgb, depth and
    the F features of each Gaussian a list names, the ids, the tiles'
    starts and counts) and its outputs written once (color, depth,
    final_T, n_contrib and F features a pixel)."""
    gid = ci.bins.gid_sorted
    f_dim = ci.args[5].shape[-1]
    named = int(torch.unique(gid).numel())
    n_tiles, p = ci.grid.num_tiles, ci.grid.pixels_per_tile
    return 4 * (named * (10 + f_dim) + gid.numel() + 2 * n_tiles
                + n_tiles * p * (6 + f_dim))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import (bytes_bound_ms,
                                                   device_label, platform,
                                                   profiled_step_ms)
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig, composite
    dev = default_device(args.device)
    print(device_label(dev), flush=True)
    seg_np, t640_np = build_inputs()
    seg = torch.from_numpy(seg_np).to(dev)
    t640 = torch.from_numpy(t640_np).to(dev)
    del t640_np
    used = int(np.unique(seg_np).size)    # table rows the ids name
    runs = gathers(t640)
    check_agreement({name: fn(seg) for name, (fn, _) in runs.items()})
    for name, (fn, tables) in runs.items():
        lanes = sum(t.shape[1] for t in tables)
        ms = profiled_step_ms(lambda: fn(seg), n=args.iters, device=dev)
        bound = bytes_bound_ms(4 * (L + (used + L) * lanes))
        print(f"{name:12s} {ms:7.4f} ms   [{L}x{lanes} lanes, "
              f"{platform(dev)}]   bound {bound:.4f} ms", flush=True)
    del runs, seg, t640

    ci = kernel_inputs(args, dev)
    config = RasterConfig()

    @torch.no_grad()
    def kernel():
        return composite(ci.args, config)

    kernel()                                    # warm-up
    ms = profiled_step_ms(kernel, n=args.iters, device=dev)
    print(f"{'kernel_reads':12s} {ms:7.4f} ms   [{int(ci.bins.total)} "
          f"instances, F={F_DIM}, {platform(dev)}]   bound "
          f"{bytes_bound_ms(kernel_bytes(ci)):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
