"""Long-run wall-clock throughput on the card: does densify maintenance
stall the loop? The port of ``scripts/bench_longrun.py``.

    python -m feature3dgs_tpu_torch.cli.bench_longrun [--iters 1200]
        [--warmup 500] [--sync_every 10] [--densify_interval 100]
        [--device cpu]

The script's scene (``build_scene``: 100K points of bench.py's draws, 4
cameras 1216x800 with U(0,1) images and 128-d N(0, 0.1^2) teachers) goes
through ``train/trainer.py:Trainer`` with the script's overrides: densify
every ``--densify_interval`` iterations from ``warmup - 2 *
densify_interval`` to the end at threshold 6e-4, no opacity reset, an
instance capacity of 1 << 21 and a Gaussian capacity headroom of 8, the SH
degree at 3 from the start (its rises would land in the measured region).
The wall clock is stamped at every sync point (``Trainer.step(sync=True)``
every ``--sync_every`` iterations, one host read each). Over the sync
spans past the warm-up (``classify_spans``), the JSON line gives the
overall wall ms an iteration against the median of the spans that carry no
densify round, and their ratio (the script's target: <= 1.2).
``capacity_regrew`` says whether a capacity grew inside the measured
region, which would invalidate the ratio; ``device`` names the card and its
power limit.

Wall clocks are the right meter here: a long run pays host time, blocking
reads and maintenance, and a sync point's host read waits for the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N_GAUSS = 100_000
F_DIM = 128
W, H = 1216, 800


def build_scene(n_cams: int = 4):
    """The script's SceneData (bench_longrun.py:43-66), numpy draws in its
    order."""
    from feature3dgs_tpu_torch.data.cameras import Camera
    from feature3dgs_tpu_torch.data.dataset import SceneData

    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.0, 2.0, (N_GAUSS, 3)).astype(np.float32)
    cols = rng.rand(N_GAUSS, 3).astype(np.float32)
    cams = []
    for i in range(n_cams):
        cams.append(Camera(
            uid=i, colmap_id=i, R=np.eye(3),
            T=np.array([0.1 * (i - n_cams / 2), 0.0, 5.0]),
            fovx=1.2, fovy=0.9,
            image=rng.rand(H, W, 3).astype(np.float32),
            image_name=f"cam{i}",
            semantic_feature=(rng.randn(H // 2, W // 2, F_DIM)
                              .astype(np.float32) * 0.1),
            width=W, height=H))
    return SceneData(train_cameras=cams, test_cameras=[], points=pts,
                     colors=cols,
                     nerf_norm={"translate": np.zeros(3), "radius": 4.0},
                     feature_dim=F_DIM, source_path="synthetic")


def classify_spans(sync_marks, warmup: int, densify_interval: int,
                   densify_from_iter: int) -> list:
    """[(last iteration, wall ms an iteration, carries a densify round)] of
    the sync spans that start at or past ``warmup``; ``sync_marks`` holds
    (iteration, wall seconds) at each sync point. The round of iteration k
    runs at the start of k + 1, so a round at k stalls the span (k, k +
    sync_every] (the script's rule, bench_longrun.py:129-150)."""
    spans = []
    for (i0, t0), (i1, t1) in zip(sync_marks, sync_marks[1:]):
        if i0 < warmup:
            continue
        ms_it = (t1 - t0) * 1000.0 / (i1 - i0)
        has_densify = any(k > densify_from_iter and k % densify_interval == 0
                          for k in range(i0, i1))
        spans.append((i1, ms_it, has_densify))
    return spans


def summarize(sync_marks, spans, warmup: int) -> dict:
    """The ratio line's numbers: overall wall ms an iteration from the first
    mark past the warm-up to the last, the median of the clean and of the
    densify spans, the measured iterations."""
    clean = sorted(ms for _, ms, d in spans if not d)
    dirty = sorted(ms for _, ms, d in spans if d)
    in_window = clean[len(clean) // 2] if clean else float("nan")
    # numerator and denominator anchored to the same first mark past warmup
    i_base, t_base = next((i, t) for i, t in sync_marks if i >= warmup)
    total_it = spans[-1][0] - i_base
    overall = (sync_marks[-1][1] - t_base) * 1000.0 / total_it
    return {"overall": overall, "in_window": in_window,
            "dirty": dirty[len(dirty) // 2] if dirty else None,
            "total_it": total_it, "spans": len(spans),
            "densify_spans": len(dirty)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Long-run wall ms/it against "
                                 "in-window ms/it (PyTorch port of "
                                 "scripts/bench_longrun.py)")
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--warmup", type=int, default=500,
                    help="iterations before the measured region (covers "
                         "the first step's kernel load and the first "
                         "densify rounds)")
    ap.add_argument("--sync_every", type=int, default=10)
    ap.add_argument("--densify_interval", type=int, default=100)
    ap.add_argument("--densify_grad_threshold", type=float, default=6e-4,
                    help="default is 3x the training default, as in the "
                         "script: random ground truth at 2e-4 grows the "
                         "scene past the instance capacity")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.warmup <= 2 * args.densify_interval:
        ap.error("--warmup must exceed 2*--densify_interval so the "
                 "first densify rounds land before the measured region")
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import device_label
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import OptimizationConfig, Trainer
    dev = default_device(args.device)

    scene = build_scene()
    ocfg = OptimizationConfig(
        iterations=args.iters,
        densify_from_iter=args.warmup - args.densify_interval * 2,
        densify_until_iter=args.iters + 1,
        densification_interval=args.densify_interval,
        densify_grad_threshold=args.densify_grad_threshold,
        opacity_reset_interval=100_000,  # keep the measured region uniform
    )
    # generous capacities: no growth inside the measured region
    rcfg = RasterConfig(instance_capacity=1 << 21, chunk=128)
    tr = Trainer(scene, ocfg=ocfg, rcfg=rcfg, max_sh_degree=3,
                 capacity_headroom=8.0, device=dev)
    # the schedule's SH-degree rises at 1000, 2000, 3000 would land inside
    # the measured region; this bench isolates densify maintenance
    tr.ts.gstate.active_sh_degree = 3

    sync_marks = []          # (iteration, wall time) at sync points
    cap0 = None              # capacities at the start of the measured region
    t_start = time.time()
    for it in range(1, args.iters + 1):
        sync = (it % args.sync_every == 0)
        m = tr.step(sync=sync)
        if sync:
            sync_marks.append((it, time.time()))
            if cap0 is None and it >= args.warmup:
                cap0 = (tr.rcfg.instance_capacity, tr.ts.params.capacity)
            if it % 100 == 0:
                print(f"  it {it}: loss={m['loss']:.4f} "
                      f"wall={time.time() - t_start:.1f}s", flush=True)
    tr.flush_maintenance(drain=True)

    spans = classify_spans(sync_marks, args.warmup, args.densify_interval,
                           ocfg.densify_from_iter)
    if not spans:
        sys.exit("warmup >= iters: nothing measured")
    s = summarize(sync_marks, spans, args.warmup)
    print(json.dumps({
        "metric": "long-run wall ms/it vs in-window ms/it",
        "value": round(s["overall"] / s["in_window"], 3),
        "unit": "ratio (target <= 1.2)",
        "detail": {
            "overall_ms_it": round(s["overall"], 1),
            "in_window_median_ms_it": round(s["in_window"], 1),
            "densify_window_median_ms_it": (
                round(s["dirty"], 1) if s["dirty"] is not None else None),
            "measured_iters": s["total_it"],
            "spans": s["spans"], "densify_spans": s["densify_spans"],
            "num_active": float(tr.ts.gstate.num_active),
            # a growth inside the run invalidates the ratio: surface it
            "capacity_regrew": (tr.rcfg.instance_capacity,
                                tr.ts.params.capacity) != cap0,
            "device": device_label(dev),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
