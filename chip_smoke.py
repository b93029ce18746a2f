#!/usr/bin/env python3
"""Smoke check of the PyTorch port (feature3dgs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, one line each; any failure raises and exits non-zero:
  build        nvcc-builds the CUDA kernels from this checkout's sources
               (one nvcc per source, in parallel).
  kernel_small the forward compositing kernel against its plain PyTorch
               version on the card at the test scenes (16x16 tiles,
               F = 4 and 128, boosted opacities): 1e-5 absolute on color,
               features and final_T, 1e-4 on depth, n_contrib exactly.
  kernel_full  the same at the LSeg speed-up serving scene (bench.py's:
               100K Gaussians, SH degree 3, 128 feature channels,
               1216x800, 32x16 tiles, seed 0): 1e-4 absolute on color,
               features and final_T, 1e-3 on depth, n_contrib equal on at
               least 99.99% of pixels; kernel and plain times, the bound.
  serve        the serving path as a user drives it: save the scene's PLY,
               load it back, render 8 orbit views (scripts/bench_render.py)
               through renderer.render plus the 128->512 decoder; outputs
               finite, view 0 equal to the plain backend's, one kernel
               launch per view; per-view time and peak memory.
  kernel_bwd_small  the backward compositing kernel against its plain
               version at the test scenes (16x16 tiles, boosted opacities,
               F = 4, 128, 512; feature_alpha_grad also on at F = 4, 128):
               per-entry rows and per-Gaussian sums at 5e-6 after dividing
               by each group's largest magnitude; rows first filled with
               NaN are all written.
  kernel_bwd_full   the same at the training scene with the cotangents of
               bench.py's loss, at 1e-5; two kernel + segment-sum runs
               bit-equal; kernel, plain and segment-sum times, the bound.
  train        bench.py's training step (bench.py:81-119: the scene above,
               a 608x400 128-d teacher, black background, default
               OptimizationConfig): step 1's Adam moments equal to the
               plain backend's at 1e-5 (max-normalised per group), then
               2 warm-up and 10 timed steps, each finite and making one
               forward and one backward launch; step time, peak memory.
               Then 2 steps of the --speedup variant (128 rendered
               channels, the 128->512 decoder, a 512-d teacher): finite,
               and the decoder moves.
Then the card's name and power limit, a {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}. With --profile DIR, torch.profiler tables of
two served views and two training steps are written to DIR.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# operations per (list entry, pixel) pair: alpha and its tests (~15), and
# for a contributing pair T, the weight and RGB+depth (~16) plus 2F
OPS_TESTED, OPS_CONTRIB = 15, 16
# the backward: alpha and its tests per walked pair (~15); per counting
# pair T, u, dL/dalpha, the suffix and the ten row terms (~50) plus 2F
OPS_BWD_WALKED, OPS_BWD_CONTRIB = 15, 50

N_GAUSS, F_DIM, F_OUT, WIDTH, HEIGHT = 100_000, 128, 512, 1216, 800
N_VIEWS = 8


def say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (after a warm-up)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def camera(view, width, height, tan_x, tan_y, dev):
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import transforms
    fovx, fovy = 2 * math.atan(tan_x), 2 * math.atan(tan_y)
    proj = transforms.projection_matrix(0.01, 100.0, fovx, fovy) @ view
    return camera_from_numpy(
        view, proj, transforms.camera_center_from_view(view).astype(np.float32),
        tan_x, tan_y, width, height, dev)


def small_scene(n, f_dim, seed, boost, dev):
    """tests/utils.py's random_gaussians (numpy draws in the same order) and
    make_camera, at SH degree 2."""
    import torch
    from feature3dgs_tpu_torch.core import transforms
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g = {"means3d": rng.uniform(-1.5, 1.5, (n, 3)),
         "scales": np.exp(rng.uniform(-3.5, -1.5, (n, 3))),
         "rotations": q,
         "opacities": rng.uniform(0.2, 0.95, (n,)),
         "shs": rng.randn(n, 9, 3) * 0.3,
         "feat": rng.randn(n, f_dim)}
    g = {k: torch.tensor(v.astype(np.float32), device=dev) for k, v in g.items()}
    g["opacities"] = torch.clamp_max(g["opacities"] * boost, 0.999)
    view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
    return g, view


def compare(name, got, ref, tol_color, tol_depth, min_ncontrib_share):
    """Kernel output vs plain output; returns (max abs error over color,
    features and final_T, n_contrib mismatches, per-output errors) and
    raises past the tolerances."""
    errs = {k: float((getattr(got, k) - getattr(ref, k)).abs().max())
            for k in ("color", "feature", "final_T", "depth")}
    mism = int((got.n_contrib != ref.n_contrib).sum())
    share = 1.0 - mism / got.n_contrib.numel()
    bad = [k for k in ("color", "feature", "final_T") if not errs[k] <= tol_color]
    if not errs["depth"] <= tol_depth:
        bad.append("depth")
    if share < min_ncontrib_share:
        bad.append("n_contrib")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with plain on {bad}: "
                             f"{errs}, n_contrib mismatches {mism}")
    return max(errs["color"], errs["feature"], errs["final_T"]), mism, errs


def phase_kernel_small(dev):
    import torch
    from feature3dgs_tpu_torch.ops.composite import composite_plain
    from feature3dgs_tpu_torch.ops.cuda_raster import raster_forward_cuda
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    for f_dim, boost, (w, h), seed in ((4, 3.0, (48, 32), 1),
                                       (128, 3.0, (64, 48), 4),
                                       (128, 1.0, (48, 32), 0)):
        g, view = small_scene(300, f_dim, seed, boost, dev)
        cam = camera(view, w, h, math.tan(0.5), math.tan(0.4), dev)
        ci = composite_inputs(
            g["means3d"], g["opacities"], g["feat"], cam, scales=g["scales"],
            rotations=g["rotations"], shs=g["shs"], sh_degree=2,
            config=RasterConfig(tile_w=16, tile_h=16))
        got = raster_forward_cuda(*ci.args)
        ref = composite_plain(*ci.args, chunk=16)
        torch.cuda.synchronize()
        err, _, _ = compare(f"kernel_small F={f_dim}", got, ref, 1e-5, 1e-4, 1.0)
        say("kernel_small", F=f_dim, boost=boost, size=f"{w}x{h}",
            instances=int(ci.bins.total), max_abs_err=err, n_contrib="equal")


def bench_scene(dev, feature_dim=F_DIM, teacher_dim=F_DIM):
    """bench.py's scene and targets (bench.py:81-105), numpy draws in its
    order: seed 0, 100K Gaussians in [-2, 2]^3, SH degree 3 (DC from random
    colors), opacity 0.5, ``feature_dim`` channels ~ N(0, 0.1^2); then
    gt_image U(0,1) [800,1216,3] and a teacher ~ N(0, 0.1^2)
    [400,608,teacher_dim]. The camera is orbit_view(0)."""
    import torch
    from feature3dgs_tpu_torch.model import gaussians as G
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.0, 2.0, (N_GAUSS, 3)).astype(np.float32)
    cols = rng.rand(N_GAUSS, 3).astype(np.float32)
    params, state = G.create_from_pcd(
        pts, cols, max_sh_degree=3, feature_dim=feature_dim, capacity=N_GAUSS,
        knn_mean_dists=np.full(N_GAUSS, 2e-4, np.float32), device=dev)
    params.semantic_feature = torch.from_numpy(
        rng.randn(N_GAUSS, 1, feature_dim).astype(np.float32) * 0.1).to(dev)
    params.opacity = torch.zeros((N_GAUSS, 1), device=dev)
    state.active_sh_degree = 3
    gt_image = torch.from_numpy(
        rng.rand(HEIGHT, WIDTH, 3).astype(np.float32)).to(dev)
    gt_feature = torch.from_numpy(
        rng.randn(HEIGHT // 2, WIDTH // 2, teacher_dim).astype(np.float32)
        * 0.1).to(dev)
    return params, state, gt_image, gt_feature


def orbit_view(i):
    """scripts/bench_render.py's orbit: rotate about z by 0.05 * i."""
    from feature3dgs_tpu_torch.core import transforms
    c, s = math.cos(0.05 * i), math.sin(0.05 * i)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return transforms.world_to_view(rot, np.array([0.0, 0.0, 5.0]))


def phase_kernel_full(dev, params, state):
    import torch
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops.composite import composite_plain
    from feature3dgs_tpu_torch.ops.cuda_raster import (check_tile_lists,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    cam = camera(orbit_view(0), WIDTH, HEIGHT, math.tan(0.6), math.tan(0.45),
                 dev)
    opacity = torch.where(state.alive, G.get_opacity(params),
                          torch.zeros((), device=dev))
    ci = composite_inputs(
        params.xyz, opacity, G.get_semantic(params), cam,
        scales=G.get_scaling(params), rotations=G.get_rotation(params),
        shs=G.get_features(params), sh_degree=state.active_sh_degree,
        active_mask=state.alive, config=RasterConfig())
    stats: dict = {}
    ref = composite_plain(*ci.args, chunk=128, stats=stats)
    got = raster_forward_cuda(*ci.args)
    torch.cuda.synchronize()
    err, mism, errs = compare("kernel_full", got, ref, 1e-4, 1e-3, 0.9999)

    kernel_ms = cuda_ms(lambda: raster_forward_cuda(*ci.args), 20)
    # the wrapper's tile-list check (one host sync), part of kernel_ms
    check_ms = cuda_ms(lambda: check_tile_lists(*ci.args[6:9], N_GAUSS), 20)
    plain_ms = cuda_ms(lambda: composite_plain(*ci.args, chunk=128), 2)
    instances = int(ci.bins.total)
    n_tiles, p = ci.grid.num_tiles, ci.grid.pixels_per_tile
    # what this view needs, each input read once and each output written
    # once: x, y, conic, opacity of the Gaussians some pixel tests; rgb,
    # depth, features of those that contribute; the list entries tested,
    # the tiles' starts and counts; color, depth, final_T, n_contrib and
    # the features of every pixel
    n_tested = int(stats["tested_gaussians"].sum())
    n_contributing = int(stats["contributing_gaussians"].sum())
    n_bytes = 4 * (6 * n_tested + (4 + F_DIM) * n_contributing
                   + stats["entries_tested"] + 2 * n_tiles
                   + n_tiles * p * (F_DIM + 6))
    ops = (OPS_TESTED * stats["tested"]
           + (OPS_CONTRIB + 2 * F_DIM) * stats["contributing"])
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    say("kernel_full", instances=instances,
        max_tile_count=int(ci.bins.tile_counts.max()),
        max_abs_err=json.dumps(errs).replace(" ", ""),
        n_contrib_mismatches=mism, kernel_ms=f"{kernel_ms:.4f}",
        check_ms=f"{check_ms:.4f}", plain_ms=f"{plain_ms:.2f}", pairs_tested=stats["tested"],
        pairs_contributing=stats["contributing"],
        entries_tested=stats["entries_tested"], gaussians_tested=n_tested,
        gaussians_contributing=n_contributing, bound_bytes=n_bytes,
        bound_bytes_ms=f"{bytes_ms:.4f}", bound_ops=ops,
        bound_ops_ms=f"{ops_ms:.4f}")
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_serve(dev, params, state, profile_dir):
    import torch
    from feature3dgs_tpu_torch.model.decoder import apply_decoder, init_decoder
    from feature3dgs_tpu_torch.model.ply_io import (load_gaussians_ply,
                                                    save_gaussians_ply)
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.render import renderer

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    ply = os.path.join(work, "point_cloud.ply")
    save_gaussians_ply(ply, params, state)
    params, state = load_gaussians_ply(ply, max_sh_degree=3, device=dev)
    decoder = init_decoder(F_DIM, F_OUT, seed=0, device=dev)
    cams = [camera(orbit_view(i), WIDTH, HEIGHT, math.tan(0.6),
                   math.tan(0.45), dev) for i in range(N_VIEWS)]

    def serve(cam, config=RasterConfig()):
        out = renderer.render(params, state, cam, config=config)
        return out, apply_decoder(decoder, out.feature)

    with torch.inference_mode():
        for cam in cams[:2]:        # warm-up: allocator, cuBLAS
            serve(cam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_raster.FORWARD_LAUNCHES = 0
        times = []
        for i, cam in enumerate(cams):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out, feat512 = serve(cam)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            assert out.color.shape == (HEIGHT, WIDTH, 3)
            assert feat512.shape == (HEIGHT, WIDTH, F_OUT)
            for name, x in (("color", out.color), ("feature", feat512),
                            ("depth", out.depth), ("alpha", out.alpha)):
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"serve: non-finite {name}")
            if i == 0:
                first = (out, feat512)
            del out, feat512
        launches = cuda_raster.FORWARD_LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        if launches != N_VIEWS:
            raise AssertionError(f"serve: {launches} kernel launches for "
                                 f"{N_VIEWS} views")
        ref, ref512 = serve(cams[0], RasterConfig(backend="plain"))
        err = max(float((first[0].color - ref.color).abs().max()),
                  float((first[1] - ref512).abs().max()))
        if not err <= 1e-4:
            raise AssertionError(f"serve: view 0 differs from plain by {err}")
        if profile_dir:
            write_profile(profile_dir, "serve_profile.txt",
                          lambda: [serve(c) for c in cams[:2]])
    say("serve", views=N_VIEWS, launches=launches,
        view_ms_median=f"{statistics.median(times):.3f}",
        view_ms_min=f"{min(times):.3f}", view_ms_max=f"{max(times):.3f}",
        peak_mem_bytes=peak, instances_view0=int(first[0].total_instances),
        plain_view0_max_abs_err=err)
    return launches


def norm_err(got, ref) -> float:
    """max |got - ref| over the largest |ref|."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-12)


# gradient groups of the backward's per-entry rows: (name, columns)
GROUPS = (("xy", 0, 2), ("conic", 2, 5), ("opacity", 5, 6), ("rgb", 6, 9),
          ("depth", 9, 10))


def compare_rows(name, got, ref, plan, tol):
    """Backward rows and their per-Gaussian sums, group by group, against
    the plain version; returns (worst normalised error, worst absolute
    error) and raises past ``tol``."""
    errs = {}
    for group, a, b in GROUPS + (("feature", 0, None),):
        g = got.feature if group == "feature" else got.geom[:, a:b]
        r = ref.feature if group == "feature" else ref.geom[:, a:b]
        if r.numel() == 0:
            continue
        errs[group] = max(norm_err(g, r), norm_err(plan.sum(g), plan.sum(r)))
    worst = max(errs.values())
    if not worst <= tol:
        raise AssertionError(f"{name}: backward kernel disagrees with plain: "
                             f"{errs}")
    abs_err = max(float((got.geom - ref.geom).abs().max()),
                  float((got.feature - ref.feature).abs().max())
                  if ref.feature.numel() else 0.0)
    return worst, abs_err


def poisoned_rows(n_inst, f_dim, dev):
    import torch
    from feature3dgs_tpu_torch.ops.composite import BackwardRows
    return BackwardRows(torch.full((n_inst, 10), float("nan"), device=dev),
                        torch.full((n_inst, f_dim), float("nan"), device=dev))


def assert_all_written(name, rows):
    if bool(rows.geom.isnan().any()) or bool(rows.feature.isnan().any()):
        raise AssertionError(f"{name}: a row the kernel should write kept "
                             "its NaN")


def phase_kernel_bwd_small(dev):
    import torch
    from feature3dgs_tpu_torch.ops.composite import composite_plain_backward
    from feature3dgs_tpu_torch.ops.cuda_raster import (raster_backward_cuda,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    for f_dim, fag, seed in ((4, False, 1), (4, True, 1), (128, False, 4),
                             (128, True, 4), (512, False, 2)):
        g, view = small_scene(300, f_dim, seed, 3.0, dev)
        cam = camera(view, 64, 48, math.tan(0.5), math.tan(0.4), dev)
        ci = composite_inputs(
            g["means3d"], g["opacities"], g["feat"], cam, scales=g["scales"],
            rotations=g["rotations"], shs=g["shs"], sh_degree=2,
            config=RasterConfig(tile_w=16, tile_h=16))
        fwd = raster_forward_cuda(*ci.args)
        gen = torch.Generator().manual_seed(seed)
        cts = [torch.randn(x.shape, generator=gen).to(dev)
               for x in (fwd.color, fwd.feature, fwd.depth, fwd.final_T)]
        rest = (*cts, fwd.final_T, fwd.n_contrib)
        got = raster_backward_cuda(
            *ci.args, *rest, feature_alpha_grad=fag,
            out=poisoned_rows(ci.bins.gid_sorted.shape[0], f_dim, dev))
        ref = composite_plain_backward(*ci.args, *rest, chunk=16,
                                       feature_alpha_grad=fag)
        torch.cuda.synchronize()
        assert_all_written("kernel_bwd_small", got)
        plan = SegmentPlan(ci.bins.gid_sorted, ci.args[0].shape[0])
        err, _ = compare_rows(f"kernel_bwd_small F={f_dim} fag={fag}", got,
                              ref, plan, 5e-6)
        say("kernel_bwd_small", F=f_dim, feature_alpha_grad=fag,
            instances=int(ci.bins.total), max_norm_err=err, nan_rows=0)


def bench_loss_cotangents(ci, fwd, gt_image, gt_feature):
    """The pixel cotangents of bench.py's loss (rgb_loss with lambda 0.2 on
    color + final_T * bg, bg black, plus the L1 of the resized features
    against the teacher) at the forward outputs ``fwd``."""
    import torch
    from feature3dgs_tpu_torch.ops.rasterize import tiles_to_image
    from feature3dgs_tpu_torch.train import losses as L
    leaves = [x.detach().requires_grad_()
              for x in (fwd.color, fwd.feature, fwd.depth, fwd.final_T)]
    bg = torch.zeros(3, device=gt_image.device)
    image = tiles_to_image(leaves[0] + leaves[3][..., None] * bg, ci.grid)
    fmap = L.resize_bilinear_from_tiles(leaves[1], ci.grid,
                                        gt_feature.shape[0],
                                        gt_feature.shape[1])
    loss = L.rgb_loss(image, gt_image, 0.2)[0] + L.l1_loss(fmap, gt_feature)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if gr is None else gr.contiguous()
            for x, gr in zip(leaves, grads)]


def phase_kernel_bwd_full(dev, params, state, gt_image, gt_feature):
    import torch
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops.composite import composite_plain_backward
    from feature3dgs_tpu_torch.ops.cuda_raster import (raster_backward_cuda,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    cam = camera(orbit_view(0), WIDTH, HEIGHT, math.tan(0.6), math.tan(0.45),
                 dev)
    opacity = torch.where(state.alive, G.get_opacity(params),
                          torch.zeros((), device=dev))
    ci = composite_inputs(
        params.xyz, opacity, G.get_semantic(params), cam,
        scales=G.get_scaling(params), rotations=G.get_rotation(params),
        shs=G.get_features(params), sh_degree=state.active_sh_degree,
        active_mask=state.alive, config=RasterConfig())
    fwd = raster_forward_cuda(*ci.args)
    rest = (*bench_loss_cotangents(ci, fwd, gt_image, gt_feature),
            fwd.final_T, fwd.n_contrib)
    n_inst = ci.bins.gid_sorted.shape[0]
    args = (*ci.args, *rest)
    got = raster_backward_cuda(*args, out=poisoned_rows(n_inst, F_DIM, dev))
    stats: dict = {}
    t0 = time.perf_counter()
    ref = composite_plain_backward(*args, chunk=128, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert_all_written("kernel_bwd_full", got)
    plan = SegmentPlan(ci.bins.gid_sorted, N_GAUSS)
    err, abs_err = compare_rows("kernel_bwd_full", got, ref, plan, 1e-5)

    def kernel_and_sum():
        rows = raster_backward_cuda(*args, check_lists=False)
        p = SegmentPlan(ci.bins.gid_sorted, N_GAUSS)
        return rows, p.sum(rows.geom), p.sum(rows.feature)

    first, second = kernel_and_sum(), kernel_and_sum()
    for a, b in zip(first[0] + first[1:], second[0] + second[1:]):
        if not torch.equal(a, b):
            raise AssertionError("kernel_bwd_full: two runs differ")
    kernel_ms = cuda_ms(lambda: raster_backward_cuda(*args, check_lists=False),
                        20)

    def segment_sum():
        p = SegmentPlan(ci.bins.gid_sorted, N_GAUSS)
        return p.sum(got.geom), p.sum(got.feature)

    segment_ms = cuda_ms(segment_sum, 20)
    n_tiles, p = ci.grid.num_tiles, ci.grid.pixels_per_tile
    # each input read once, each output written once: the pixel
    # cotangents, final_T and n_contrib; x, y, conic, opacity of the
    # Gaussians some walk reaches, rgb and depth of those that count; the
    # walked list ids, the tiles' starts and counts; one row per entry
    n_walked = int(stats["walked_gaussians"].sum())
    n_contributing = int(stats["contributing_gaussians"].sum())
    n_bytes = 4 * (n_tiles * p * (F_DIM + 7) + 6 * n_walked
                   + 4 * n_contributing + stats["entries_walked"]
                   + 2 * n_tiles + n_inst * (10 + F_DIM))
    ops = (OPS_BWD_WALKED * stats["walked"]
           + (OPS_BWD_CONTRIB + 2 * F_DIM) * stats["contributing"])
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    say("kernel_bwd_full", instances=int(ci.bins.total),
        max_norm_err=err, max_abs_err=abs_err, bit_equal_runs=2,
        kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.2f}",
        segment_sum_ms=f"{segment_ms:.4f}", pairs_walked=stats["walked"],
        pairs_contributing=stats["contributing"],
        entries_walked=stats["entries_walked"], gaussians_walked=n_walked,
        gaussians_contributing=n_contributing, bound_bytes=n_bytes,
        bound_bytes_ms=f"{bytes_ms:.4f}", bound_ops=ops,
        bound_ops_ms=f"{ops_ms:.4f}")
    return {"max_abs_err": abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_train(dev, profile_dir):
    import torch
    from feature3dgs_tpu_torch.model.decoder import init_decoder
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import (OptimizationConfig,
                                                     TrainState, train_step)
    cam = camera(orbit_view(0), WIDTH, HEIGHT, math.tan(0.6), math.tan(0.45),
                 dev)
    bg = torch.zeros(3, device=dev)
    ocfg = OptimizationConfig()
    rcfg = RasterConfig(instance_capacity=393216, chunk=128)

    def fresh(**kw):
        params, state, gt_image, gt_feature = bench_scene(dev, **kw)
        return TrainState.create(params, state, device=dev), gt_image, gt_feature

    # step 1 through the plain versions, then through the kernels
    ts_plain, gt_image, gt_feature = fresh()
    m_plain = train_step(ts_plain, cam, gt_image, gt_feature, bg, 1,
                         ocfg=ocfg,
                         rcfg=dataclasses.replace(rcfg, backend="plain"),
                         speedup=False)
    ts, _, _ = fresh()
    cuda_raster.FORWARD_LAUNCHES = cuda_raster.BACKWARD_LAUNCHES = 0
    times, losses, per_step = [], [], []
    for it in range(1, 13):       # 2 warm-up steps, 10 timed
        if it == 3:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        f0, b0 = cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES
        t0 = time.perf_counter()
        m = train_step(ts, cam, gt_image, gt_feature, bg, it, ocfg=ocfg,
                       rcfg=rcfg, speedup=False)
        torch.cuda.synchronize()
        if it >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
        per_step.append((cuda_raster.FORWARD_LAUNCHES - f0,
                         cuda_raster.BACKWARD_LAUNCHES - b0))
        losses.append(float(m["loss"]))
        if not (bool(m["finite"]) and math.isfinite(losses[-1])):
            raise AssertionError(f"train: step {it} loss {losses[-1]}")
        if it == 1:
            mu_err = max(norm_err(getattr(ts.adam.mu, k),
                                  getattr(ts_plain.adam.mu, k))
                         for k in ts.params.FIELDS)
            loss_err = abs(losses[0] - float(m_plain["loss"]))
            if not mu_err <= 1e-5:
                raise AssertionError(f"train: step 1 Adam mu differs from "
                                     f"the plain backend's by {mu_err}")
            instances = int(m["num_instances"])
    launches = (cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if set(per_step) != {(1, 1)}:
        raise AssertionError(f"train: launches per step {per_step}")
    del ts_plain
    if profile_dir:
        write_profile(profile_dir, "train_profile.txt", lambda: [
            train_step(ts, cam, gt_image, gt_feature, bg, 13 + i, ocfg=ocfg,
                       rcfg=rcfg, speedup=False) for i in range(2)])
    say("train", steps=len(times), step_ms_median=f"{statistics.median(times):.3f}",
        step_ms_min=f"{min(times):.3f}", step_ms_max=f"{max(times):.3f}",
        peak_mem_bytes=peak, instances=instances,
        forward_launches=launches[0], backward_launches=launches[1],
        step1_mu_max_norm_err=mu_err, step1_loss_vs_plain=loss_err,
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}")

    # the --speedup variant: 128 rendered channels lifted to 512
    del ts
    params, state, gt_image, gt_feature = bench_scene(dev, teacher_dim=F_OUT)
    decoder = init_decoder(F_DIM, F_OUT, seed=0, device=dev)
    w0 = decoder["w"].clone()
    ts = TrainState.create(params, state, decoder=decoder, device=dev)
    f0, b0 = cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES
    sp_losses = []
    for it in (1, 2):
        m = train_step(ts, cam, gt_image, gt_feature, bg, it, ocfg=ocfg,
                       rcfg=rcfg, speedup=True)
        sp_losses.append(float(m["loss"]))
        if not (bool(m["finite"]) and math.isfinite(sp_losses[-1])):
            raise AssertionError(f"train speedup: step {it} not finite")
    moved = float((ts.decoder["w"] - w0).abs().max())
    sp_launches = (cuda_raster.FORWARD_LAUNCHES - f0,
                   cuda_raster.BACKWARD_LAUNCHES - b0)
    if not moved > 0 or sp_launches != (2, 2):
        raise AssertionError(f"train speedup: decoder moved {moved}, "
                             f"launches {sp_launches}")
    say("train_speedup", steps=2, losses=json.dumps(sp_losses),
        decoder_max_change=moved, forward_launches=sp_launches[0],
        backward_launches=sp_launches[1])
    return (launches[0] + sp_launches[0], launches[1] + sp_launches[1])


def write_profile(out_dir, name, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="",
                    help="directory for profiler tables of two served views "
                    "and two training steps")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.ops import cuda_raster
    dev = default_device()

    t0 = time.time()
    cuda_raster.build()
    ptxas = [ln.strip() for ln in cuda_raster.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", seconds=f"{time.time() - t0:.1f}", ptxas=json.dumps(ptxas))

    phase_kernel_small(dev)
    params, state, gt_image, gt_feature = bench_scene(dev)
    full = phase_kernel_full(dev, params, state)
    serve_launches = phase_serve(dev, params, state, args.profile)
    phase_kernel_bwd_small(dev)
    bwd = phase_kernel_bwd_full(dev, params, state, gt_image, gt_feature)
    del params, state, gt_image, gt_feature
    train_fwd, train_bwd = phase_train(dev, args.profile)

    print(card_line())
    src = "feature3dgs_tpu_torch/ops/csrc/"
    print(json.dumps({"kernels": [
        dict(name="raster_forward", route="cuda",
             source=src + "raster_forward.cu",
             replaces="feature3dgs_tpu/ops/pallas_raster.py:192",
             launches=serve_launches + train_fwd, **full, library_ms=None),
        dict(name="raster_backward", route="cuda",
             source=src + "raster_backward.cu",
             replaces="feature3dgs_tpu/ops/pallas_raster.py:495",
             launches=train_bwd, **bwd, library_ms=None)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
