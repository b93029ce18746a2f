#!/usr/bin/env python3
"""Smoke check of the PyTorch port (feature3dgs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, one line each; any failure raises and exits non-zero:
  build        nvcc-builds the CUDA kernels from this checkout's sources
               (one nvcc per source, in parallel) and, beside them, with
               g++ the native host helpers (native/src/f3dgs_native.cc);
               ptxas' registers and spills per instantiation, and for the
               instantiations the main path launches (512-pixel tiles,
               F = 128, both modes) registers, local bytes, resident blocks
               an SM and the launch plan; whether ncu is installed.
  kernel_small the forward compositing kernel against its plain PyTorch
               version on the card at the test scenes (16x16 tiles,
               F = 4 and 128, boosted opacities): 1e-5 absolute on color,
               features and final_T, 1e-4 on depth, n_contrib exactly.
  kernel_full  the same at the LSeg speed-up serving scene (bench.py's:
               100K Gaussians, SH degree 3, 128 feature channels,
               1216x800, 32x16 tiles, seed 0): 1e-4 absolute on color,
               features and final_T, 1e-3 on depth, n_contrib equal on at
               least 99.99% of pixels; kernel and plain times, the bound,
               and beside the bound's bytes the bytes the kernel's design
               moves (device memory; L2 to shared memory) and what the
               design before it moved over the feature map.
  serve        the serving path as a user drives it: save the scene's PLY,
               load it back, render 8 orbit views (scripts/bench_render.py)
               through renderer.render plus the 128->512 decoder; outputs
               finite, view 0 equal to the plain backend's, one kernel
               launch per view; per-view time and peak memory.
  serve_batch  the same 8 views through renderer.render_batch at B = 4
               (two forward launches) and B = 8 (one): color, features,
               depth, alpha and n_contrib of every view bit-equal to its own
               renderer.render, again at B = 4 in the alpha_matmul mode;
               view 0 within the serve bars of the plain version's batch;
               per-view ms batched and sequential (CUDA events, median of
               3 after a warm-up), host syncs and peak memory of a view and
               of a batch of 8; the batched kernel alone at B = 8 in both
               modes (20 launches) beside its bound summed over the views.
  kernel_bwd_small  the backward compositing kernel against its plain
               version at the test scenes (16x16 tiles, boosted opacities,
               F = 4, 128, 512; feature_alpha_grad also on at F = 4, 128):
               per-entry rows and per-Gaussian sums at 5e-6 after dividing
               by each group's largest magnitude; rows first filled with
               NaN are all written.
  kernel_bwd_full   the same at the training scene with the cotangents of
               bench.py's loss, at 1e-5; two kernel + segment-sum runs
               bit-equal; kernel, plain and segment-sum times, the bound
               and the design's bytes (passes over the cotangent rows).
               The segment-sum kernel (ops/csrc/segment.cu) on those rows
               with the plan built: bit-equal to segment_reduce(rows[order])
               (the plain path), both timed (20 calls of both arrays) beside
               the bytes bound, launches a call, the team and attributes;
               the same at the training cells' shapes (1M Gaussians drawn
               as their scene is, orbit view 0 binned into ~5.5M entries,
               random rows of 10 geometric and F = 128, 512 feature
               channels).
  kernel_bwd_slice  the backward kernel's tile_base and n_per_camera at the
               training scene: over 2 and 4 slices of tile rows of view 0
               (each its own sub-range of gid_sorted, rebased starts) the
               rows equal the full launch's bit for bit; over orbit views
               0-3 in one launch each camera's rows equal its own launch's
               bit for bit; full and batched launch within 5e-6 of the plain
               version (max-normalised); the batched launch's time in both
               modes (20 launches) beside the per-view bound summed over the
               4 views.
  kernel_loop  both kernels alone, in both modes, at the first view of the
               train_loop scene (scales from 3-NN distances, opacity 0.1,
               SH degree 0: ~1.79 M instances, 30-56 chunks a tile, where a
               training run lives): against the plain versions with the
               kernels' own chunk of 32 at the training scene's bars, two
               backward launches bit-equal, 20 launches each timed by CUDA
               events, that scene's own bound and design bytes.
  train        bench.py's training step as cli/bench.py builds it
               (bench.make_step; bench.py:81-119: the scene above, a
               608x400 128-d teacher, black background, default
               OptimizationConfig): step 1's Adam moments equal to the
               plain backend's at 1e-5 (max-normalised per group), then
               2 warm-up and 10 timed steps, each finite and making one
               forward and one backward launch; step time, peak memory.
               Then 2 steps of the --speedup variant (128 rendered
               channels, the 128->512 decoder, a 512-d teacher): finite,
               and the decoder moves.
  kernel_alpha_small  both kernels in the alpha_matmul mode against the
               plain versions in the same mode at the test scenes (16x16
               tiles, F = 4 and 128, boosted opacities): 1e-4 absolute on
               color, features and final_T, 5e-4 on depth, n_contrib
               differing on fewer than 1% of pixels by at most 1, gradient
               rows 1e-4 max-normalised, NaN-poisoned rows all written; and
               against the exact mode's kernels at the same bars, with the
               count and size of the n_contrib differences.
  kernel_alpha_full   the same at the training scene with the cotangents of
               bench.py's loss, mode off and on in turns: forward against
               the plain version at the same bars and against the exact
               mode at 5x them on all but 0.01% of the pixels, gradient
               rows at 1e-3 (against the exact mode: per-Gaussian sums, on
               all but 0.1% of the Gaussians); ms of each kernel (20 launches), the bytes bound,
               n_contrib differences, gradient error max-normalised.
  kernel_wide  both kernels in both modes at F = 256 and 512 (the
               reference's SAM and LSeg widths; the forward's 2 and 4
               channel groups, the backward's 16- and 8-row ring stages):
               at a test scene (64x48, 16x16 tiles, boosted opacities) at
               kernel_small's and kernel_bwd_small's bars (n_contrib
               exactly; kernel_alpha_small's in the alpha_matmul mode),
               and at the training scene at that width (303,278
               instances) at kernel_full's and kernel_bwd_full's bars
               (kernel_alpha_full's in the alpha_matmul mode); each
               kernel's time (20 launches) beside its bytes bound and
               launch plan.
  bench_clis   the measuring CLIs' main in process at their full default
               scenes with few iterations: cli.bench, cli.bench_render (F =
               16, 128, 256), cli.profile_step, cli.bench_longrun (80
               iterations) and cli.bench_scaling (one card); the JAX
               scripts' JSON keys, finite numbers and loss, the card named
               in every line, no capacity growth in the long run's
               measured region.
  micro        the stage micro-benchmarks' main in process at their full
               default sizes, 2 timed calls a row: cli.micro_segsum (the
               segment-sum at 552,960 x 256 -> 100,000 x 256 with a
               quarter of the rows dropped; every variant against the
               first at 1e-3, SegmentPlan's segment-sum kernel against
               index_add_ among them), cli.micro_expand (the instance
               expansion at 524,288 slots: six layouts bit-equal, the
               port's expansion with and without its host read bit-equal
               on the slots it keeps) and cli.micro_pack (the slab gathers
               at 552,960 x 640, and the forward kernel's reads by id at F
               = 512 on the training scene, whose launches count in the
               kernels line); each returns 0, names the card first and
               prints every row with a finite ms and bytes bound on gpu.
  adam         the fused Adam kernel (ops/csrc/adam.cu) at the training
               cells' sizes, 1 M Gaussians at F = 128 and 512 (187 M and
               571 M elements; the SH gradients as slices of one [N, 16, 3]
               gradient, as autograd hands them), keep a device True: one
               step bit-equal to the plain version (model/optim.py:_adam_)
               on clones; the group's call (the kernel and the counter's
               add, 20 calls), the plain version's and torch._fused_adam_'s
               (the library yardstick, one learning rate, contiguous
               gradients) times beside the 28-byte-an-element bound; the
               kernel's registers, local bytes and blocks an SM.
  preprocess   the preprocess kernels (ops/csrc/preprocess.cu) at 1 M
               Gaussians (bench.py's cloud, random scales, rotations,
               opacities and SH), orbit view 0 at 1216x800, SH degree 3,
               an ndc_offset and a live mask: the forward bit-equal to the
               plain ops (ops/rasterize.py:_prep_plain), the backward to
               core/projection.py:preprocess_backward on cotangents laid out
               as the compositing hands them (NaN equal to NaN); each
               kernel's ms (CUDA events, mean of 20) beside its bytes bound,
               the plain versions' ms, and the autograd path's (the plain
               ops' forward and autograd backward, what they replace); both
               kernels' registers, local bytes and blocks an SM.
  resize       the tile-layout resize kernels (ops/csrc/resize.cu) at the
               training cells' shape, 1216x800 on 32x16 tiles to 608x400,
               F = 128 and 512: the forward bit-equal to tiles_to_image +
               F.interpolate (elements whose bits differ, the largest gap
               in ulp), the backward against that path's autograd gradient
               (max-normalised gap), two runs of each bit-equal; each
               kernel's ms (CUDA events, mean of 20) beside its bytes bound,
               the plain path's forward and forward + backward ms, and
               F.interpolate's alone on a contiguous NCHW map (the library
               yardstick); both kernels' registers, local bytes and blocks
               an SM.
  parity       the parity CLI's scene (1,000 Gaussians, 208x160, SH degree
               3) at F = 8 and at F = 128: the CUDA route (one forward and
               one backward launch) in the exact and alpha_matmul modes
               against the per-pixel oracle (ops/oracle.py) on the card,
               forward outputs and the loss's gradients with respect to
               means3d, opacity and features, at the JAX package's oracle
               bars (tests/test_rasterize.py:72-81: 99.5% of the values
               within 2e-5, 1e-4 for the alpha_matmul forward, the worst
               within 0.02, depth 0.2; gradients max-normalised 5e-4 and
               0.05); each comparison's worst and 99.5% values, the share
               of pixels (or Gaussians) past the tight bar, the oracle's
               own seconds. python -m feature3dgs_tpu_torch.cli.parity_check
               starts as a subprocess with the phase and runs beside it and
               the train CLI (it runs after train_loop; parity_cli reads
               it after train_cli): exit 0, cuda-vs-plain and
               plain-vs-oracle lines, all_pass on gpu.
  setup        scene setup's host helpers at 1,000,000 points: a
               points3D.bin (tracks of 4 entries) written from one numpy
               structured array, read by data/colmap.py's reader (the
               native scanner) bit-equal to what was written; the native
               3-NN (ops/knn.py, one thread) against scipy's cKDTree (all
               cores) at rtol 1e-5 / atol 1e-7; the read and both 3-NN
               seconds.
  train_loop   the host loop at full width: a SceneData in memory (the
               scene above as a point cloud, the 8 orbit cameras, a U(0,1)
               image and an fp16 608x400x128 teacher each) through Trainer
               (the package's own KNN, auto instance capacity, capacity
               headroom 1.0) for 50 steps with the schedule compressed
               (densify every 10 from 5, opacity reset every 20), then
               across iteration 1000 (the SH-degree bump). Every loss
               finite; clones, splits and prunes non-zero; a Gaussian-
               capacity growth and an instance-capacity growth; one forward
               and one backward launch per step of each of the compositing,
               preprocess and resize kernels, and one segment-sum launch
               (both row arrays); a checkpoint saved mid-run
               resumes in a fresh Trainer to the same next step (loss 1e-5
               relative, Adam mu 1e-4 max-normalised); the saved PLY serves
               finite.
               Step times (plain steps, steps that carry maintenance), the
               round's own ms, host syncs per step, peak memory. Then 10
               steps with alpha_matmul=True from a fresh Trainer, held to
               the same launches a step.
  train_batch  4 cameras a step through parallel.DistributedTrainer on a
               1 x 1 mesh (bench.py's Gaussians, train_loop's orbit cameras
               0-3 with their images and teachers): the first step's loss
               equal to the mean of the 4 cameras' own train_step losses
               from the same state (2e-5 relative), one forward and one
               backward launch a step, B = 4 step ms against 4 single-camera
               Trainer steps, blocking host calls and peak memory of each.
  train_shard  the row-sharded modes of parallel.sharded_train_step on a
               1 x 1 mesh, from one state (train_batch's Gaussians, cameras,
               images and teachers): one step of the 4 cameras replicated,
               one with shard_gaussians and one with shard_instances too
               (the instance exchange: one forward and one backward launch
               a camera), each against the replicated one at the CPU
               tests' bars (loss 2e-5 relative, parameters 5e-5 where the
               gradient is above 1e-12 and Adam's first moments 1e-5
               max-normalised, xyz_gradient_accum 2e-5, denom exact,
               max_radii2d 1e-4 and exact for the exchange,
               num_instances equal); step ms of
               each mode, blocking host calls a step, peak memory, the
               exchange's instances against its slots; then
               DistributedTrainer(shard_gaussians=True) for 10 steps of 4
               cameras over one densify round.
  viewer       the viewers on the serve scene (128 channels through the
               128->512 decoder, 1216x800): cli.view's serve loop on a
               NetworkGUI in a thread on a free loopback port; a client
               asks for each of the 6 render modes at orbit view 0 (3
               frames each) and 2 frames at scaling 0.5; every frame equals
               render_net_image of a direct render bit for bit, one forward
               launch a frame; the client's round trip and the direct
               path's ms (median a mode), blocking calls of an RGB frame,
               peak memory. Then the WebViewer: /info and 4 /render PNGs at
               1216x800, each decoded and equal to the direct render's
               image; ms a request.
  encoders     the teacher encoders at published widths, seeded weights
               built on the card: LSeg ViT-L/16 (encode_image of a 480x360
               image, median of 3 after a warm-up, peak memory; the f32
               output of a 160x128 crop against the same weights on the
               CPU, max-normalised, 1e-4), CLIP ViT-B/32 (CLIPConfig(), card against CPU at
               1e-4), SAM ViT-H (1280 wide, 32 blocks, global attention at
               7/15/23/31: encode_image timed on the card; a 2-block copy at
               full width, one windowed and one global block, against the
               CPU at 1e-4, embedding and decoder logits); then
               segment_time's loop (8 points) on an embedding rendered
               from the serve scene through a seeded 128->256 decoder and
               resized to SAM's 42x64 grid, and through ViT-H on the
               rendered image: masks/s of each and their ratio; auto_masks
               at 16 points a side with the default filters and with none.
  train_cli    python -m feature3dgs_tpu_torch.cli.train as a subprocess on
               a small Blender-style scene (4 train and 2 test frames of
               128x128, 16-d teacher maps, 2000 points), 40 iterations with
               densify rounds, a save and a checkpoint, the viewer on a free
               port: a SIBR client reads a frame and the metrics at each of
               the first 3 sync points (every 10 iterations) while it
               trains; the artifact tree, the exit code, and whether
               TensorBoard wrote its event file.
  serve_cli    the render and downstream CLIs on that model, as
               subprocesses, several at once: the render CLI with
               --render_batch 3 --novel_view --num_views 6 --video, and one
               view at a time with each edit config (from EDIT_CONFIGS, as
               JSON) and seeded text features; then the segmentation,
               segmentation-metric and metrics CLIs on their output; every
               exit code, the artifact trees, finite scores.
Bounds are taken against the card's data-sheet peaks, bench_utils'
PEAK_BYTES (3.35e12 B/s) and PEAK_F32_FLOPS (67e12 f32 operations/s).
Then the card's name and power limit, a {"kernels": [...]} line (the two
forward entries also with batch8_ms and batch8_bound_ms, the two backward
entries with batch4_ms and batch4_bound_ms, all four with f256_ms,
f256_bound_ms, f512_ms and f512_bound_ms from kernel_wide; a fifth entry,
adam, with adam's times and bounds at F = 128 and 512; then the two
preprocess and the two resize kernels, and the segment-sum with its times
and bound at the training scene and, as kernel_ms_f128 .. bound_ms_f512,
at the training cells' shapes, and train_loop's launches)
and, last,
{"ok": true, "device": {...}}. With --profile DIR, torch.profiler tables of
two served views, of the 8 views sequential and in a batch of 8 (with the
device-busy ms and idle share of each) and of two training steps are
written to DIR, and of one B = 4 train_batch step and 4 single steps;
--only a,b runs just those phases (and prints no result lines).
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
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from feature3dgs_tpu_torch.bench_utils import (  # noqa: E402
    PEAK_F32_FLOPS, bench_camera, bench_scene, blocking_calls,
    bytes_bound_ms, camera, card_line, device_busy_ms, orbit_view)

# operations per (list entry, pixel) pair: alpha and its tests (~15), and
# for a contributing pair T, the weight and RGB+depth (~16) plus 2F
OPS_TESTED, OPS_CONTRIB = 15, 16
# the backward: alpha and its tests per walked pair (~15); per counting
# pair T, u, dL/dalpha, the suffix and the ten row terms (~50) plus 2F
OPS_BWD_WALKED, OPS_BWD_CONTRIB = 15, 50

N_GAUSS, F_DIM, F_OUT, WIDTH, HEIGHT = 100_000, 128, 512, 1216, 800
N_VIEWS = 8
CELL_GAUSS = 1_000_000  # the training cells' Gaussians (segment-sum timing)
BATCH = 4       # cameras a step of train_batch, views of kernel_bwd_slice
# configs/edit_*.yaml as mappings, so that this check needs no PyYAML (the
# render CLI reads them as JSON); tests/test_torch_tasks.py holds them equal
_OBJECTS = ["car", "tree", "building", "sidewalk", "road"]
EDIT_CONFIGS = {
    "edit_color": {"edit": {
        "objects": _OBJECTS, "operations": "color_func",
        "colorFunc": "lambda color: color[..., [2, 1, 0]]", "targets": "car",
        "threshold": 0.2}},
    "edit_deletion": {"edit": {"objects": _OBJECTS, "operations": "deletion",
                               "targets": "car", "threshold": 0.2}},
    "edit_extraction": {"edit": {"objects": _OBJECTS,
                                 "operations": "extraction",
                                 "targets": "car", "threshold": 0.2}},
}


T_START = time.perf_counter()


def say(phase: str, **fields):
    """One result line, stamped with the seconds since the script began
    (the gaps between stamps are the phases' wall times)."""
    print(f"[{phase}] t={time.perf_counter() - T_START:.1f} "
          + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


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


def small_scene(n, f_dim, seed, boost, dev):
    """tests/utils.py's random_gaussians (data/synthetic.py's copy: numpy
    draws in the same order) with boosted opacities, and make_camera's
    view, at SH degree 2."""
    import torch
    from feature3dgs_tpu_torch.core import transforms
    from feature3dgs_tpu_torch.data.synthetic import random_gaussians
    g = {k: torch.from_numpy(v).to(dev)
         for k, v in random_gaussians(n=n, f_dim=f_dim, seed=seed).items()}
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


def bench_inputs(dev, params, state, cam=None):
    """The training / serving scene from orbit view 0 (or ``cam``),
    preprocessed and binned at the default RasterConfig."""
    import torch
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    if cam is None:
        cam = bench_camera(WIDTH, HEIGHT, dev)
    opacity = torch.where(state.alive, G.get_opacity(params),
                          torch.zeros((), device=dev))
    return composite_inputs(
        params.xyz, opacity, G.get_semantic(params), cam,
        scales=G.get_scaling(params), rotations=G.get_rotation(params),
        shs=G.get_features(params), sh_degree=state.active_sh_degree,
        active_mask=state.alive, config=RasterConfig())


def forward_bound(stats, n_tiles, p, f_dim=F_DIM):
    """Bytes and operations the forward needs for these inputs, each input
    read once and each output written once: x, y, conic, opacity of the
    Gaussians some pixel tests; rgb, depth, features of those that
    contribute; the list entries tested, the tiles' starts and counts;
    color, depth, final_T, n_contrib and the features of every pixel."""
    n_tested = int(stats["tested_gaussians"].sum())
    n_contributing = int(stats["contributing_gaussians"].sum())
    n_bytes = 4 * (6 * n_tested + (4 + f_dim) * n_contributing
                   + stats["entries_tested"] + 2 * n_tiles
                   + n_tiles * p * (f_dim + 6))
    ops = (OPS_TESTED * stats["tested"]
           + (OPS_CONTRIB + 2 * f_dim) * stats["contributing"])
    return n_bytes, ops, n_tested, n_contributing


def backward_bound(stats, n_tiles, p, n_inst, f_dim=F_DIM):
    """The same for the backward: the pixel cotangents, final_T and
    n_contrib; x, y, conic, opacity of the Gaussians some walk reaches, rgb
    and depth of those that count; the walked list ids, the tiles' starts
    and counts; one row per entry."""
    n_walked = int(stats["walked_gaussians"].sum())
    n_contributing = int(stats["contributing_gaussians"].sum())
    n_bytes = 4 * (n_tiles * p * (f_dim + 7) + 6 * n_walked
                   + 4 * n_contributing + stats["entries_walked"]
                   + 2 * n_tiles + n_inst * (10 + f_dim))
    ops = (OPS_BWD_WALKED * stats["walked"]
           + (OPS_BWD_CONTRIB + 2 * f_dim) * stats["contributing"])
    return n_bytes, ops, n_walked, n_contributing


def bound_fields(n_bytes, ops):
    bytes_ms, ops_ms = bytes_bound_ms(n_bytes), ops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def chunks_per_tile(entries):
    """[T] 32-entry chunks of lists of ``entries`` [T] entries."""
    from feature3dgs_tpu_torch.ops.cuda_raster import KERNEL_CHUNK
    return (entries.long() + KERNEL_CHUNK - 1) // KERNEL_CHUNK


def forward_design_bytes(ci):
    """Bytes the forward kernel moves by its design, whatever the caches do:
    "dram" = every output written once and each staged list entry's
    (10 + F) floats and id read once; "l2" = what is staged from L2 into
    shared memory (every block of a tile, pixel splits x channel groups,
    stages the scalars of every chunk and its channels of the feature
    rows); "out_feat" = the
    feature map's share of dram (one write, no read); "out_feat_before" =
    the same share under the design before this one, which added each
    chunk's product into out_feat in device memory (a write per chunk and a
    read per chunk after the first). Early exits are not reckoned: a tile
    counts all its chunks."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.cuda_raster import KERNEL_CHUNK
    if not hasattr(cuda_raster, "forward_plan"):
        return {}       # an older checkout's kernels, timed by this script
    n_tiles, p = ci.grid.num_tiles, ci.grid.pixels_per_tile
    plan = cuda_raster.forward_plan(p, F_DIM)
    chunks = chunks_per_tile(ci.bins.tile_counts)
    staged = int(chunks.sum()) * KERNEL_CHUNK
    out_feat = 4 * n_tiles * p * F_DIM
    passes_before = int((2 * chunks - 1).clamp_min(1).sum())
    return {"dram": 4 * (n_tiles * p * (F_DIM + 6) + staged * (11 + F_DIM)),
            "l2": 4 * staged * plan.splits * plan.groups
            * (11 + 8 * plan.channel_tiles * plan.halves),
            "out_feat": out_feat, "out_feat_before": 4 * passes_before * p * F_DIM}


def backward_design_bytes(ci, n_contrib):
    """The same for the backward: "dram" = cotangents and saved state read
    once, the walked entries' scalars and ids read once, one row written per
    entry; "g_l2" = the cotangent rows [g_feat | g_color | g_depth] streamed
    from L2 into shared memory once per pass of ``entries`` staged list
    entries; "g_l2_before" = the design before this one, which streamed
    g_feat once per 32 entries."""
    import torch
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.cuda_raster import KERNEL_CHUNK
    if not hasattr(cuda_raster, "backward_plan"):
        return {}
    n_tiles, p = ci.grid.num_tiles, ci.grid.pixels_per_tile
    plan = cuda_raster.backward_plan(p, F_DIM)
    walked = torch.minimum(n_contrib.amax(1), ci.bins.tile_counts)
    chunks = chunks_per_tile(walked)
    per_pass = plan.entries // KERNEL_CHUNK
    passes = int(((chunks + per_pass - 1) // per_pass).sum())
    n_inst = ci.bins.gid_sorted.shape[0]
    return {"dram": 4 * (n_tiles * p * (F_DIM + 7)
                         + int(chunks.sum()) * KERNEL_CHUNK * 11
                         + n_inst * (10 + F_DIM)),
            "g_l2": 4 * passes * p * (F_DIM + 4), "g_passes": passes,
            "g_l2_before": 4 * int(chunks.sum()) * p * F_DIM,
            "g_passes_before": int(chunks.sum())}


def phase_kernel_full(dev, params, state):
    import torch
    from feature3dgs_tpu_torch.ops.composite import composite_plain
    from feature3dgs_tpu_torch.ops.cuda_raster import (check_tile_lists,
                                                       raster_forward_cuda)
    ci = bench_inputs(dev, params, state)
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
    n_bytes, ops, n_tested, n_contributing = forward_bound(
        stats, ci.grid.num_tiles, ci.grid.pixels_per_tile)
    design = forward_design_bytes(ci)
    say("kernel_full", instances=instances,
        max_tile_count=int(ci.bins.tile_counts.max()),
        max_abs_err=json.dumps(errs).replace(" ", ""),
        n_contrib_mismatches=mism, kernel_ms=f"{kernel_ms:.4f}",
        check_ms=f"{check_ms:.4f}", plain_ms=f"{plain_ms:.2f}", pairs_tested=stats["tested"],
        pairs_contributing=stats["contributing"],
        entries_tested=stats["entries_tested"], gaussians_tested=n_tested,
        gaussians_contributing=n_contributing, bound_bytes=n_bytes,
        bound_bytes_ms=f"{bytes_bound_ms(n_bytes):.4f}", bound_ops=ops,
        bound_ops_ms=f"{ops / PEAK_F32_FLOPS * 1e3:.4f}",
        **{"design_" + k + "_bytes": v for k, v in design.items()})
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            **bound_fields(n_bytes, ops)}


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
    cams = [bench_camera(WIDTH, HEIGHT, dev, i) for i in range(N_VIEWS)]

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


BATCH_FIELDS = ("color", "feature", "depth", "alpha", "n_contrib")


def phase_serve_batch(dev, params, state, profile_dir):
    """The serving scene's 8 orbit views through renderer.render_batch at
    B = 4 (two launches) and B = 8 (one launch), each view bit-equal to its
    own renderer.render; B = 4 again in the alpha_matmul mode; view 0 of a
    batch against the plain version's batch; per-view times batched and
    sequential, host syncs a batch, peak memory; the batched kernel alone at
    B = 8 in both modes beside its bound (summed over the 8 views)."""
    import warnings

    import torch
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.composite import composite_plain
    from feature3dgs_tpu_torch.ops.cuda_raster import raster_forward_cuda
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs_batch)
    from feature3dgs_tpu_torch.render import renderer

    cams = [bench_camera(WIDTH, HEIGHT, dev, i) for i in range(N_VIEWS)]
    mm_cfg = RasterConfig(alpha_matmul=True)

    def batches(bsz, config=RasterConfig()):
        return [renderer.render_batch(params, state, cams[i:i + bsz],
                                      config=config)
                for i in range(0, N_VIEWS, bsz)]

    def bit_equal(name, outs, singles):
        views = [(out, k) for out in outs for k in range(out.color.shape[0])]
        for (out, k), one in zip(views, singles):
            for f in BATCH_FIELDS:
                if not torch.equal(getattr(out, f)[k], getattr(one, f)):
                    raise AssertionError(f"serve_batch {name}: view {k} "
                                         f"{f} differs from render")

    with torch.inference_mode():
        cuda_raster.FORWARD_LAUNCHES = cuda_raster.FORWARD_MM_LAUNCHES = 0
        singles = [renderer.render(params, state, c) for c in cams]
        singles_mm = [renderer.render(params, state, c, config=mm_cfg)
                      for c in cams[:4]]
        launches_per_batch = []
        for bsz in (4, 8):
            for i in range(0, N_VIEWS, bsz):
                before = cuda_raster.FORWARD_LAUNCHES
                out = renderer.render_batch(params, state, cams[i:i + bsz])
                launches_per_batch.append(cuda_raster.FORWARD_LAUNCHES - before)
                bit_equal(f"B={bsz}", [out], singles[i:i + bsz])
                if bsz == 4 and i == 0:
                    first = out
                del out
        before = cuda_raster.FORWARD_MM_LAUNCHES
        out_mm = renderer.render_batch(params, state, cams[:4], config=mm_cfg)
        launches_per_batch.append(cuda_raster.FORWARD_MM_LAUNCHES - before)
        bit_equal("alpha_matmul B=4", [out_mm], singles_mm)
        torch.cuda.synchronize()
        launches = (cuda_raster.FORWARD_LAUNCHES,
                    cuda_raster.FORWARD_MM_LAUNCHES)
        if launches_per_batch != [1, 1, 1, 1]:
            raise AssertionError(f"serve_batch: forward launches per batch "
                                 f"{launches_per_batch}, expected one each")
        del out_mm, singles, singles_mm
        plain = renderer.render_batch(params, state, cams[:4],
                                      config=RasterConfig(backend="plain"))
        errs = {f: float((getattr(first, f)[0] - getattr(plain, f)[0])
                         .abs().max()) for f in ("color", "feature", "alpha",
                                                  "depth")}
        mism = int((first.n_contrib[0] != plain.n_contrib[0]).sum())
        if (max(errs["color"], errs["feature"], errs["alpha"]) > 1e-4
                or errs["depth"] > 1e-3
                or mism > 1e-4 * first.n_contrib[0].numel()):
            raise AssertionError(f"serve_batch: view 0 differs from the plain "
                                 f"batch: {errs}, n_contrib {mism}")
        del first, plain

        def per_view_ms(fn):
            fn()
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / N_VIEWS)
            return statistics.median(times)

        seq_ms = per_view_ms(lambda: [renderer.render(params, state, c)
                                      for c in cams])
        b4_ms = per_view_ms(lambda: batches(4))
        b8_ms = per_view_ms(lambda: batches(8))

        def syncs_and_peak(fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            return (sum("synchronizing CUDA operation" in str(w.message)
                        for w in caught), torch.cuda.max_memory_allocated())

        syncs_view, peak_view = syncs_and_peak(
            lambda: renderer.render(params, state, cams[0]))
        syncs_b8, peak_b8 = syncs_and_peak(lambda: batches(8))
        if profile_dir:
            # device-busy ms of the 8 views against their unprofiled time
            busy = {name: write_profile(
                profile_dir, f"serve_batch_{name}_profile.txt", fn) / N_VIEWS
                for name, fn in (
                    ("sequential", lambda: [renderer.render(params, state, c)
                                            for c in cams]),
                    ("batch8", lambda: batches(8)))}
            say("serve_batch_profile",
                device_busy_ms_per_view=json.dumps(
                    {k: round(v, 3) for k, v in busy.items()}).replace(" ", ""),
                idle_share_sequential=f"{1 - busy['sequential'] / seq_ms:.3f}",
                idle_share_batch8=f"{1 - busy['batch8'] / b8_ms:.3f}")

        ci = composite_inputs_batch(
            params.xyz, torch.where(state.alive, G.get_opacity(params),
                                    torch.zeros((), device=dev)),
            G.get_semantic(params), cams, scales=G.get_scaling(params),
            rotations=G.get_rotation(params), shs=G.get_features(params),
            sh_degree=state.active_sh_degree, active_mask=state.alive)
        n = params.xyz.shape[0]
        stats: dict = {}
        composite_plain(*ci.args, chunk=128, n_per_camera=n, stats=stats)
        kernel_ms = {mm: cuda_ms(lambda: raster_forward_cuda(
            *ci.args, n_per_camera=n, alpha_matmul=mm), 20)
            for mm in (False, True)}
        n_bytes, ops, _, _ = forward_bound(stats, ci.grid.num_tiles * N_VIEWS,
                                           ci.grid.pixels_per_tile)
    bound = bound_fields(n_bytes, ops)
    say("serve_batch", views=N_VIEWS, launches_per_batch=launches_per_batch,
        bit_equal="B=4,B=8,alpha_matmul B=4",
        plain_view0_max_abs_err=json.dumps(errs).replace(" ", ""),
        plain_view0_n_contrib_mismatches=mism,
        view_ms_sequential=f"{seq_ms:.3f}", view_ms_batch4=f"{b4_ms:.3f}",
        view_ms_batch8=f"{b8_ms:.3f}", host_syncs_view=syncs_view,
        host_syncs_batch8=syncs_b8, peak_mem_bytes_view=peak_view,
        peak_mem_bytes_batch8=peak_b8,
        instances_batch8=int(ci.bins.total.sum()),
        batch8_kernel_ms=f"{kernel_ms[False]:.4f}",
        batch8_kernel_mm_ms=f"{kernel_ms[True]:.4f}",
        batch8_bound_ms=f"{bound['bound_ms']:.4f}",
        batch8_bound_by=bound["bound_by"])
    return launches, {mm: {"batch8_ms": kernel_ms[mm],
                           "batch8_bound_ms": bound["bound_ms"]}
                      for mm in (False, True)}


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


def compare_gaussian_grads(name, got, ref, plan, tol, outliers):
    """Per-Gaussian gradients (the rows summed by ``plan``) of two backward
    runs whose forwards may have decided a few marginal pairs differently:
    a Gaussian is an outlier when any of its gradient groups differs by more
    than ``tol`` of that group's largest magnitude; at most the share
    ``outliers`` of the Gaussians may be. Returns (worst normalised error
    over the others, number of outliers)."""
    import torch
    worst = None
    for group, a, b in GROUPS + (("feature", 0, None),):
        g = got.feature if group == "feature" else got.geom[:, a:b]
        r = ref.feature if group == "feature" else ref.geom[:, a:b]
        if r.numel() == 0:
            continue
        g, r = plan.sum(g), plan.sum(r)
        err = (g - r).abs().amax(-1) / max(float(r.abs().max()), 1e-12)
        worst = err if worst is None else torch.maximum(worst, err)
    out = worst > tol
    n_out = int(out.sum())
    if n_out > outliers * out.numel():
        raise AssertionError(f"{name}: {n_out} of {out.numel()} Gaussians "
                             f"differ by more than {tol} (worst "
                             f"{float(worst.max())})")
    return float(worst[~out].max()), n_out


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
    from feature3dgs_tpu_torch.ops.composite import composite_plain_backward
    from feature3dgs_tpu_torch.ops.cuda_raster import (raster_backward_cuda,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    ci = bench_inputs(dev, params, state)
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
        return (rows, *SegmentPlan(ci.bins.gid_sorted, N_GAUSS).sums(
            rows.feature, rows.geom))

    first, second = kernel_and_sum(), kernel_and_sum()
    for a, b in zip(first[0] + first[1:], second[0] + second[1:]):
        if not torch.equal(a, b):
            raise AssertionError("kernel_bwd_full: two runs differ")
    kernel_ms = cuda_ms(lambda: raster_backward_cuda(*args, check_lists=False),
                        20)

    def segment_sum():
        return SegmentPlan(ci.bins.gid_sorted, N_GAUSS).sums(got.feature,
                                                             got.geom)

    segment_ms = cuda_ms(segment_sum, 20)
    seg = segment_sum_fields(plan, got.feature, got.geom)
    n_bytes, ops, n_walked, n_contributing = backward_bound(
        stats, ci.grid.num_tiles, ci.grid.pixels_per_tile, n_inst)
    design = backward_design_bytes(ci, fwd.n_contrib)
    say("kernel_bwd_full", instances=int(ci.bins.total),
        max_norm_err=err, max_abs_err=abs_err, bit_equal_runs=2,
        kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.2f}",
        segment_sum_ms=f"{segment_ms:.4f}", pairs_walked=stats["walked"],
        pairs_contributing=stats["contributing"],
        entries_walked=stats["entries_walked"], gaussians_walked=n_walked,
        gaussians_contributing=n_contributing, bound_bytes=n_bytes,
        bound_bytes_ms=f"{bytes_bound_ms(n_bytes):.4f}", bound_ops=ops,
        bound_ops_ms=f"{ops / PEAK_F32_FLOPS * 1e3:.4f}",
        **{"design_" + k: v for k, v in design.items()})
    say("kernel_bwd_full_segment_sum", instances=n_inst, **seg)
    del ci, fwd, rest, args, got, ref, first, second, plan
    cells = segment_sum_at_cell_shapes(dev)
    return ({"max_abs_err": abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
             **bound_fields(n_bytes, ops)},
            {**{k: seg[k] for k in ("kernel_ms", "plain_ms", "bound_ms")},
             **{f"{k}_f{f}": row[k] for f, row in cells.items()
                for k in ("kernel_ms", "plain_ms", "bound_ms")}})


def segment_sum_fields(plan, feature, geom) -> dict:
    """The segment-sum kernel (ops/csrc/segment.cu) on a backward's feature
    and geometric rows with ``plan`` built, as the step calls it
    (``plan.sums(feature, geom)``): bit-equal to the plain path
    (``segment_reduce(rows[order])``, which it replaces on the card), each
    path's ms (CUDA events, mean of 20 calls of both arrays), launches a
    call, the bytes bound (each row, ``order`` and ``bounds`` read once,
    the sums written once), and the feature rows' team and its
    attributes."""
    import torch
    from feature3dgs_tpu_torch.ops import cuda_segment

    def plain():
        lengths = plan.bounds.diff()
        return [torch.segment_reduce(r[plan.order], "sum", lengths=lengths,
                                     unsafe=True) for r in (feature, geom)]

    before = cuda_segment.SEGMENT_LAUNCHES
    fused = plan.sums(feature, geom)
    launches = cuda_segment.SEGMENT_LAUNCHES - before
    for name, a, b in zip(("feature", "geom"), fused, plain()):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"segment sum of the {name} rows differs "
                                 "from segment_reduce(rows[order])")
    del fused
    n_inst, n = feature.shape[0], plan.bounds.shape[0] - 1
    n_bytes = 8 * (n_inst + n + 1) + sum(4 * r.shape[1] * (n_inst + n)
                                         for r in (feature, geom))
    team = cuda_segment.team_plan(
        feature.shape[1],
        feature.shape[1] % 4 == 0 and feature.data_ptr() % 16 == 0)
    return dict(
        bit_equal_to_plain=True, launches_a_call=launches,
        kernel_ms=f"{cuda_ms(lambda: plan.sums(feature, geom), 20):.4f}",
        plain_ms=f"{cuda_ms(plain, 20):.4f}", bound_bytes=n_bytes,
        bound_ms=f"{bytes_bound_ms(n_bytes):.4f}",
        team=json.dumps(team._asdict()).replace(" ", ""),
        attributes=json.dumps(cuda_segment.kernel_attributes(
            team.vec4, team.per_lane)).replace(" ", ""))


def segment_sum_at_cell_shapes(dev) -> dict:
    """The segment-sum at the training cells' shapes: 1M Gaussians drawn as
    the cells' scene is (port_bench/configs/lseg512.json's "scene": means
    U[-2, 2]^3, log-scales N(log 0.02, 0.4^2), random unit quaternions,
    opacity U(0.05, 0.95)), binned from orbit view 0 at 1216x800 in 32x16
    tiles (~5.5M entries), and random rows: the 10 geometric channels
    beside F = 128 and F = 512 feature channels. Returns
    {F: segment_sum_fields} and says one line a width."""
    import torch
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    g = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=g, device=dev)
    n = CELL_GAUSS
    xyz = torch.rand((n, 3), **kw) * 4.0 - 2.0
    scales = torch.exp(math.log(0.02) + 0.4 * torch.randn((n, 3), **kw))
    rotations = torch.nn.functional.normalize(torch.randn((n, 4), **kw),
                                              dim=-1)
    opacity = 0.05 + 0.9 * torch.rand((n,), **kw)
    ci = composite_inputs(
        xyz, opacity, torch.zeros((n, 1), device=dev),
        bench_camera(WIDTH, HEIGHT, dev), scales=scales, rotations=rotations,
        colors_precomp=torch.rand((n, 3), **kw),
        config=RasterConfig(instance_capacity=1 << 24))
    gid = ci.bins.gid_sorted
    if int(ci.bins.total) != gid.shape[0]:
        raise AssertionError("segment sum at the cells' shapes: instances "
                             "dropped at the capacity")
    plan = SegmentPlan(gid, n)
    lengths = plan.bounds.diff()
    geom = torch.randn((gid.shape[0], 10), **kw)
    out = {}
    for f_dim in (128, 512):
        feature = torch.randn((gid.shape[0], f_dim), **kw)
        out[f_dim] = segment_sum_fields(plan, feature, geom)
        del feature
        torch.cuda.empty_cache()
        say("kernel_bwd_full_segment_sum_cells", F=f_dim, gaussians=n,
            instances=gid.shape[0],
            gaussians_with_entries=int((lengths > 0).sum()),
            max_entries=int(lengths.max()), **out[f_dim])
    return out


def phase_kernel_bwd_slice(dev, params, state, gt_image, gt_feature):
    """The backward kernel's tile slices and batched cameras at the training
    scene: over 2 and 4 slices of tile rows of view 0 (each launched with
    its own sub-range of gid_sorted, rebased starts and ``tile_base``) the
    rows equal the full launch's bit for bit, NaN-poisoned rows all
    written; over orbit views 0-3 in one launch (``n_per_camera``) each
    camera's rows equal its own launch's bit for bit. The full and the
    batched launch within 5e-6 of the plain version (max-normalised). The
    batched launch timed in both modes (20 launches) beside its bound, the
    per-view bound summed over the 4 views (the exact mode's, for both)."""
    import torch
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops.binning import tile_slices
    from feature3dgs_tpu_torch.ops.composite import (CompositeOutput,
                                                     composite_plain_backward)
    from feature3dgs_tpu_torch.ops.cuda_raster import (raster_backward_cuda,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.rasterize import composite_inputs_batch
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan, camera_rows
    ci = bench_inputs(dev, params, state)
    grid = ci.grid
    fwd = raster_forward_cuda(*ci.args)
    state_rows = (*bench_loss_cotangents(ci, fwd, gt_image, gt_feature),
                  fwd.final_T, fwd.n_contrib)
    full = raster_backward_cuda(*ci.args, *state_rows, check_lists=False)
    ref = composite_plain_backward(*ci.args, *state_rows, chunk=128)
    torch.cuda.synchronize()
    err_full, _ = compare_rows("kernel_bwd_slice full", full, ref,
                               SegmentPlan(ci.bins.gid_sorted, N_GAUSS), 5e-6)
    del ref
    slices = {}
    for n_tile in (2, 4):
        rows_loc = -(-grid.grid_y // n_tile)
        ranges = [(min(r * rows_loc, grid.grid_y) * grid.grid_x,
                   min((r + 1) * rows_loc, grid.grid_y) * grid.grid_x)
                  for r in range(n_tile)]
        offset = 0
        for (t0, t1), lists in zip(ranges, tile_slices(*ci.args[6:9],
                                                       ranges)):
            k = lists[0].shape[0]
            rows = raster_backward_cuda(
                *ci.args[:6], *lists, grid, *(x[t0:t1] for x in state_rows),
                tile_base=t0, out=poisoned_rows(k, F_DIM, dev))
            assert_all_written(f"kernel_bwd_slice {n_tile} slices", rows)
            if not (torch.equal(rows.geom, full.geom[offset:offset + k])
                    and torch.equal(rows.feature,
                                    full.feature[offset:offset + k])):
                raise AssertionError(f"kernel_bwd_slice: slice {t0}..{t1} "
                                     f"of {n_tile} differs from the full "
                                     "launch")
            offset += k
        slices[n_tile] = len(ranges)
    del full

    cams = [bench_camera(WIDTH, HEIGHT, dev, i) for i in range(BATCH)]
    n = params.xyz.shape[0]
    cb = composite_inputs_batch(
        params.xyz, torch.where(state.alive, G.get_opacity(params),
                                torch.zeros((), device=dev)),
        G.get_semantic(params), cams, scales=G.get_scaling(params),
        rotations=G.get_rotation(params), shs=G.get_features(params),
        sh_degree=state.active_sh_degree, active_mask=state.alive)
    t_n = grid.num_tiles
    batch_state = {}
    for mm in (False, True):
        bfwd = raster_forward_cuda(*cb.args, n_per_camera=n, alpha_matmul=mm)
        cts = [bench_loss_cotangents(ci, CompositeOutput(
            *(x[b * t_n:(b + 1) * t_n] for x in bfwd)), gt_image, gt_feature)
            for b in range(BATCH)]
        batch_state[mm] = (*(torch.cat(c) for c in zip(*cts)), bfwd.final_T,
                           bfwd.n_contrib)
    bstate = batch_state[False]
    brows = raster_backward_cuda(*cb.args, *bstate, n_per_camera=n,
                                 check_lists=False)
    offset = 0
    for b, cam in enumerate(cams):
        one = bench_inputs(dev, params, state, cam=cam)
        rows = raster_backward_cuda(
            *one.args, *(x[b * t_n:(b + 1) * t_n] for x in bstate),
            check_lists=False)
        k = one.bins.gid_sorted.shape[0]
        if not (torch.equal(brows.geom[offset:offset + k], rows.geom)
                and torch.equal(brows.feature[offset:offset + k],
                                rows.feature)):
            raise AssertionError(f"kernel_bwd_slice: camera {b} of the "
                                 "batched launch differs from its own launch")
        offset += k
        del one, rows
    stats: dict = {}
    ref = composite_plain_backward(*cb.args, *bstate, chunk=128,
                                   n_per_camera=n, stats=stats)
    torch.cuda.synchronize()
    rows_of = camera_rows(cb.bins.gid_sorted, cb.bins.tile_counts, n, t_n)
    err_batch, _ = compare_rows("kernel_bwd_slice batched", brows, ref,
                                SegmentPlan(rows_of, BATCH * n), 5e-6)
    del ref, brows
    ms = {mm: cuda_ms(lambda: raster_backward_cuda(
        *cb.args, *batch_state[mm], n_per_camera=n, alpha_matmul=mm,
        check_lists=False), 20) for mm in (False, True)}
    n_inst = cb.bins.gid_sorted.shape[0]
    b_bytes, b_ops, _, _ = backward_bound(stats, BATCH * t_n,
                                          grid.pixels_per_tile, n_inst)
    bound = bound_fields(b_bytes, b_ops)
    say("kernel_bwd_slice", instances=int(ci.bins.total),
        slices=json.dumps(slices).replace(" ", ""), slice_rows_bit_equal=True,
        full_max_norm_err=err_full, batch=BATCH,
        instances_batch=int(cb.bins.total.sum()), batch_rows_bit_equal=True,
        batch_max_norm_err=err_batch,
        batch4_kernel_ms=f"{ms[False]:.4f}",
        batch4_kernel_mm_ms=f"{ms[True]:.4f}",
        batch4_bound_bytes=b_bytes, batch4_bound_ops=b_ops,
        batch4_bound_ms=f"{bound['bound_ms']:.4f}",
        batch4_bound_by=bound["bound_by"])
    return {mm: {"batch4_ms": ms[mm], "batch4_bound_ms": bound["bound_ms"]}
            for mm in (False, True)}


def phase_train_batch(dev, scene, at_batch4, profile_dir):
    """B = 4 cameras a step through DistributedTrainer on a 1 x 1 mesh:
    bench.py's Gaussians (the training scene) with the train_loop scene's
    orbit cameras 0-3 and their U(0,1) images and fp16 608x400x128
    teachers. The first step's loss against the mean of the four cameras'
    own train_step losses from the same state (2e-5 relative); one forward
    and one backward launch a step; B = 4 step times (host clock around the
    step and a synchronize, 2 warm-up and 6 timed) against 4 single-camera
    Trainer steps on the same cameras (2 warm-up rounds, 3 timed), the host
    calls each blocks on, peak memory of each. With a profile directory,
    the device-busy ms of one B = 4 step and of 4 single steps, and the
    idle share of each against its median time."""
    import copy

    import torch
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.parallel import DistributedTrainer, make_mesh
    from feature3dgs_tpu_torch.train.trainer import (OptimizationConfig,
                                                     Trainer, TrainState,
                                                     train_step)
    rcfg = RasterConfig(instance_capacity=1 << 20)
    kw = dict(ocfg=OptimizationConfig(), rcfg=rcfg, max_sh_degree=3,
              feature_dim=F_DIM, capacity_headroom=1.0, seed=0, device=dev)
    cams = scene.train_cameras[:BATCH]

    def with_bench_gaussians(trainer):
        params, gstate, _, _ = bench_scene(dev)
        gstate.spatial_lr_scale = trainer.extent
        trainer.ts = TrainState.create(params, gstate, device=dev)
        return trainer

    def launches():
        return (cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES)

    def timed(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = launches()
        m = step()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3,
                tuple(a - b for a, b in zip(launches(), before)), m)

    for name in ("FORWARD_LAUNCHES", "BACKWARD_LAUNCHES",
                 "FORWARD_MM_LAUNCHES", "BACKWARD_MM_LAUNCHES"):
        setattr(cuda_raster, name, 0)
    dt = with_bench_gaussians(DistributedTrainer(
        scene, mesh=make_mesh((1, 1)), cameras_per_step=BATCH, **kw))
    start = copy.deepcopy(dt.ts)
    _, first_launches, m = timed(lambda: dt.step(cameras=cams))
    batch_loss = m["loss"]
    torch.cuda.reset_peak_memory_stats()
    runs = [timed(lambda: dt.step(cameras=cams)) for _ in range(8)]
    batch_peak = torch.cuda.max_memory_allocated()
    batch_syncs = blocking_calls(lambda: dt.step(cameras=cams, sync=False))
    per_step = {first_launches} | {r[1] for r in runs}
    if per_step != {(1, 1)} or not all(r[2]["finite"] for r in runs):
        raise AssertionError(f"train_batch: launches per step {per_step}")
    batch_ms = [r[0] for r in runs[2:]]
    busy = {}
    if profile_dir:
        busy["batch"] = write_profile(profile_dir, "train_batch_profile.txt",
                                      lambda: dt.step(cameras=cams))
    del dt

    own = []
    for c in cams:
        ts = copy.deepcopy(start)
        gt_image = torch.from_numpy(np.asarray(c.image, np.float32)).to(dev)
        gt_feature = torch.from_numpy(np.asarray(c.semantic_feature)).to(dev)
        own.append(float(train_step(
            ts, c.to_view(dev), gt_image, gt_feature,
            torch.zeros(3, device=dev), 1, ocfg=kw["ocfg"], rcfg=rcfg,
            speedup=False)["loss"]))
        del ts
    del start
    mean = sum(own) / len(own)
    rel = abs(batch_loss - mean) / abs(mean)
    if not rel <= 2e-5:
        raise AssertionError(f"train_batch: batch loss {batch_loss} against "
                             f"the mean {mean} of {own} (rel {rel})")

    st = with_bench_gaussians(Trainer(scene, **kw))
    torch.cuda.reset_peak_memory_stats()
    rounds = []
    for _ in range(5):
        rounds.append(sum(timed(lambda: st.step(camera=c))[0] for c in cams))
    single_peak = torch.cuda.max_memory_allocated()
    single_syncs = blocking_calls(lambda: st.step(camera=cams[0], sync=False))
    if profile_dir:
        busy["single"] = write_profile(
            profile_dir, "train_batch_single_profile.txt",
            lambda: [st.step(camera=c) for c in cams])
        say("train_batch_profile",
            device_busy_ms=json.dumps({k: round(v, 3) for k, v in
                                       busy.items()}).replace(" ", ""),
            idle_share_batch=f"{1 - busy['batch'] / statistics.median(batch_ms):.3f}",
            idle_share_single=f"{1 - busy['single'] / statistics.median(rounds[2:]):.3f}")
    del st
    counts = launches()
    stat = lambda xs: (f"{statistics.median(xs):.3f}/{min(xs):.3f}/"
                       f"{max(xs):.3f}")
    say("train_batch", batch=BATCH, mesh="1x1", loss=f"{batch_loss:.6f}",
        own_losses_mean=f"{mean:.6f}", loss_rel_err=rel,
        launches_per_step="1,1",
        batch_step_ms_median_min_max=stat(batch_ms),
        four_single_steps_ms_median_min_max=stat(rounds[2:]),
        ms_per_camera_batch=f"{statistics.median(batch_ms) / BATCH:.3f}",
        ms_per_camera_single=f"{statistics.median(rounds[2:]) / BATCH:.3f}",
        host_syncs_batch_step=batch_syncs, host_syncs_single_step=single_syncs,
        peak_mem_bytes_batch=batch_peak, peak_mem_bytes_single=single_peak,
        batch4_bwd_kernel_ms=(f"{at_batch4[False]['batch4_ms']:.4f}"
                              if at_batch4 else "not run"),
        batch4_bwd_bound_ms=(f"{at_batch4[False]['batch4_bound_ms']:.4f}"
                             if at_batch4 else "not run"),
        forward_launches=counts[0], backward_launches=counts[1])
    return counts


def phase_train_shard(dev, scene):
    """The row-sharded modes on a 1 x 1 mesh, from one state: bench.py's
    Gaussians with train_batch's orbit cameras 0-3, their images and fp16
    teachers, one ``sharded_train_step`` of the 4 cameras replicated, one
    with ``shard_gaussians`` (the rows gathered for the render, gradients
    back to the shard) and one with ``shard_instances`` as well (the
    instance exchange: per camera one expansion, one routing buffer, one
    receiver sort and one forward and one backward launch). Each against
    the replicated step at the CPU tests' bars: loss 2e-5 relative,
    parameters 5e-5, xyz_gradient_accum 2e-5, denom exact, max_radii2d 1e-4
    (exact for the exchange), num_instances equal. At 100K Gaussians some
    gradients cancel to below 1e-12, where a first Adam step is
    lr * g / (|g| + 1e-15) and the order of a sum decides it: parameters
    are held at 5e-5 where the gradient is above that, the elements below
    it are counted, and Adam's first moments (the gradients) are held at
    1e-5 max-normalised everywhere. Then 3 timed steps of
    each mode after a warm-up (host clock around the step and a
    synchronize), the host calls a step blocks on, peak memory, and the
    exchange's instances against its slots. Then
    ``DistributedTrainer(shard_gaussians=True)`` from the scene's own points
    for 10 steps of 4 cameras over one densify round. Returns the forward
    and backward launches of the phase."""
    import copy

    import torch
    from feature3dgs_tpu_torch.model.gaussians import GaussianParams
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.parallel import (DistributedTrainer, make_mesh,
                                                sharded_train_step)
    from feature3dgs_tpu_torch.parallel.sharded import (exchange_capacities,
                                                        shard_state)
    from feature3dgs_tpu_torch.train.trainer import (OptimizationConfig,
                                                     TrainState)
    for name in ("FORWARD_LAUNCHES", "BACKWARD_LAUNCHES",
                 "FORWARD_MM_LAUNCHES", "BACKWARD_MM_LAUNCHES"):
        setattr(cuda_raster, name, 0)
    rcfg = RasterConfig(instance_capacity=1 << 20)
    ocfg = OptimizationConfig()
    mesh = make_mesh((1, 1))
    cams = scene.train_cameras[:BATCH]
    views = [c.to_view(dev) for c in cams]
    gt_images = [torch.from_numpy(np.asarray(c.image, np.float32)).to(dev)
                 for c in cams]
    gt_features = [torch.from_numpy(np.asarray(c.semantic_feature)).to(dev)
                   for c in cams]
    params, gstate, _, _ = bench_scene(dev)
    gstate.spatial_lr_scale = float(scene.nerf_norm["radius"])
    start = TrainState.create(params, gstate, device=dev)
    del params, gstate
    bg, span = torch.zeros(3, device=dev), np.arange(1, BATCH + 1)
    modes = {"replicated": {}, "shard_gaussians": dict(shard_gaussians=True),
             "shard_instances": dict(shard_gaussians=True,
                                     shard_instances=True)}
    launches = lambda: (cuda_raster.FORWARD_LAUNCHES,
                        cuda_raster.BACKWARD_LAUNCHES)
    stat = lambda xs: (f"{statistics.median(xs):.3f}/{min(xs):.3f}/"
                       f"{max(xs):.3f}")
    STATS = ("xyz_gradient_accum", "denom", "max_radii2d")
    after, report = {}, {}
    for mode, flags in modes.items():
        step = lambda ts, flags=flags: sharded_train_step(
            ts, views, gt_images, gt_features, bg, span, mesh=mesh,
            ocfg=ocfg, rcfg=rcfg, **flags)
        ts = copy.deepcopy(start)
        ts = shard_state(ts, mesh) if flags else ts
        before = launches()
        m = {k: float(v) for k, v in step(ts).items()}
        got = tuple(a - b for a, b in zip(launches(), before))
        want = (BATCH, BATCH) if flags.get("shard_instances") else (1, 1)
        if got != want or not m["finite"]:
            raise AssertionError(f"train_shard {mode}: launches {got}, "
                                 f"expected {want}; metrics {m}")
        # what the comparison reads, kept on the host so that it does not
        # count in the next modes' peak memory
        host = lambda x: x.to("cpu", copy=True)
        after[mode] = ({f"{g}.{k}": host(getattr(getattr(ts, g), k))
                        for g, keys in (("params", GaussianParams.FIELDS),
                                        ("gstate", STATS))
                        for k in keys}
                       | {f"mu.{k}": host(getattr(ts.adam.mu, k))
                          for k in GaussianParams.FIELDS}, m)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        report[mode] = dict(step_ms=stat(ms[1:]),
                            peak=torch.cuda.max_memory_allocated(),
                            syncs=blocking_calls(lambda: step(ts)))
        del ts
    del start
    ref, rm = after["replicated"]
    errs = {}
    for mode in ("shard_gaussians", "shard_instances"):
        ts, m = after[mode]
        rel = abs(m["loss"] - rm["loss"]) / abs(rm["loss"])
        # a first Adam step moves a parameter by lr * g / (|g| + 1e-15):
        # where the replicated gradient is below 1e-12 (a sum that cancels)
        # its rounding decides the step, so those elements are counted
        # apart; the first moments hold the gradients themselves
        d_par, d_mu, edge_off = 0.0, 0.0, 0
        for k in GaussianParams.FIELDS:
            diff = (ts[f"params.{k}"] - ref[f"params.{k}"]).abs()
            mu_ref = ref[f"mu.{k}"]
            edge = mu_ref.abs() < 0.1 * 1e-12
            d_par = max(d_par, float(torch.where(
                edge, torch.zeros_like(diff), diff).max()))
            edge_off += int((edge & (diff > 5e-5)).sum())
            d_mu = max(d_mu, float((ts[f"mu.{k}"] - mu_ref).abs().max()
                                   / mu_ref.abs().max().clamp_min(1e-30)))
        d = {k: float((ts[f"gstate.{k}"] - ref[f"gstate.{k}"]).abs().max())
             for k in STATS}
        radii_tol = 0.0 if mode == "shard_instances" else 1e-4
        if not (rel <= 2e-5 and d_par <= 5e-5 and d_mu <= 1e-5
                and d["xyz_gradient_accum"] <= 2e-5 and d["denom"] == 0
                and d["max_radii2d"] <= radii_tol
                and m["num_instances"] == rm["num_instances"]):
            raise AssertionError(f"train_shard {mode} against the replicated "
                                 f"step: loss rel {rel}, params {d_par}, "
                                 f"Adam mu {d_mu}, stats {d}, instances "
                                 f"{m['num_instances']} vs "
                                 f"{rm['num_instances']}")
        errs[mode] = dict(loss_rel=rel, params=d_par, adam_mu=d_mu,
                          params_off_at_zero_gradient=edge_off, **d)
    del after, ref
    l_src, cap_pair = exchange_capacities(rcfg.instance_capacity_or_default,
                                          mesh)

    o = OptimizationConfig(iterations=40, densify_from_iter=8,
                           densification_interval=24,
                           opacity_reset_interval=10_000,
                           densify_until_iter=1000)
    t0 = time.perf_counter()
    tr = DistributedTrainer(scene, mesh=mesh, cameras_per_step=BATCH,
                            shard_gaussians=True, ocfg=o, max_sh_degree=3,
                            feature_dim=F_DIM, capacity_headroom=1.0,
                            device=dev)
    active0 = int(tr.ts.gstate.alive.sum())
    history = tr.train(iterations=40, log_every=8)
    tr.flush_maintenance(drain=True)
    trainer_s = time.perf_counter() - t0
    rounds = tr.densify_log
    if (len(rounds) != 1 or not all(h["finite"] for h in history)
            or rounds[0]["num_cloned"] + rounds[0]["num_split"] == 0):
        raise AssertionError(f"train_shard trainer: rounds {rounds}, "
                             f"history {history}")
    counts = launches()
    say("train_shard", card=card_line().replace(" ", ""), batch=BATCH,
        mesh="1x1",
        step_ms_median_min_max=json.dumps(
            {k: v["step_ms"] for k, v in report.items()}).replace(" ", ""),
        host_syncs_per_step=json.dumps(
            {k: v["syncs"] for k, v in report.items()}).replace(" ", ""),
        peak_mem_bytes=json.dumps(
            {k: v["peak"] for k, v in report.items()}).replace(" ", ""),
        against_replicated=json.dumps(errs).replace(" ", ""),
        instances_max_camera=int(rm["num_instances"]), cap_pair=cap_pair,
        l_src=l_src, exchange_launches_per_step=f"{BATCH},{BATCH}",
        trainer_steps=tr.iteration // BATCH,
        trainer_capacity=tr.capacity, trainer_active=f"{active0}->"
        f"{history[-1]['num_active']:.0f}->{int(tr.ts.gstate.alive.sum())}",
        trainer_round=json.dumps(rounds[0]).replace(" ", ""),
        trainer_s=f"{trainer_s:.2f}",
        forward_launches=counts[0], backward_launches=counts[1])
    return counts


def phase_kernel_loop(dev, scene):
    """Both kernels alone at the first view of the train_loop scene, exact
    and alpha_matmul modes; returns {(kernel, mode): loop-scene fields of
    the kernels line}."""
    import torch
    from feature3dgs_tpu_torch.ops.composite import (composite_plain,
                                                     composite_plain_backward)
    from feature3dgs_tpu_torch.ops.cuda_raster import (KERNEL_CHUNK,
                                                       raster_backward_cuda,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    from feature3dgs_tpu_torch.train.trainer import Trainer
    trainer = Trainer(scene, rcfg=RasterConfig(), max_sh_degree=3,
                      feature_dim=F_DIM, capacity_headroom=1.0, seed=0,
                      device=dev)
    cam0 = scene.train_cameras[0]
    ci = bench_inputs(dev, trainer.ts.params, trainer.ts.gstate,
                      cam=cam0.to_view(dev))
    gt_image = torch.from_numpy(np.asarray(cam0.image, np.float32)).to(dev)
    gt_feature = torch.from_numpy(
        np.asarray(cam0.semantic_feature).astype(np.float32)).to(dev)
    del trainer
    n_tiles, p = ci.grid.num_tiles, ci.grid.pixels_per_tile
    n_inst = ci.bins.gid_sorted.shape[0]
    plan = SegmentPlan(ci.bins.gid_sorted, ci.args[0].shape[0])
    chunks = chunks_per_tile(ci.bins.tile_counts)
    out = {}
    for mm in (False, True):
        tag = "kernel_loop alpha_matmul" if mm else "kernel_loop"
        f_stats: dict = {}
        got = raster_forward_cuda(*ci.args, alpha_matmul=mm)
        ref = composite_plain(*ci.args, chunk=KERNEL_CHUNK, alpha_matmul=mm,
                              stats=f_stats)
        torch.cuda.synchronize()
        if mm:
            f_err, _, mism, _ = compare_alpha(tag + " vs plain", got, ref)
        else:
            f_err, mism, _ = compare(tag, got, ref, 1e-4, 1e-3, 0.9999)
        del ref
        args = (*ci.args, *bench_loss_cotangents(ci, got, gt_image,
                                                 gt_feature),
                got.final_T, got.n_contrib)
        rows = raster_backward_cuda(*args, alpha_matmul=mm, check_lists=False,
                                    out=poisoned_rows(n_inst, F_DIM, dev))
        b_stats: dict = {}
        ref_rows = composite_plain_backward(*args, chunk=KERNEL_CHUNK,
                                            alpha_matmul=mm, stats=b_stats)
        torch.cuda.synchronize()
        assert_all_written(tag, rows)
        b_err, b_abs = compare_rows(tag + " backward", rows, ref_rows, plan,
                                    1e-3 if mm else 1e-5)
        del ref_rows
        again = raster_backward_cuda(*args, alpha_matmul=mm,
                                     check_lists=False)
        if not (torch.equal(again.geom, rows.geom)
                and torch.equal(again.feature, rows.feature)):
            raise AssertionError(f"{tag}: two backward launches differ")
        del again
        f_ms = cuda_ms(lambda: raster_forward_cuda(*ci.args, alpha_matmul=mm),
                       20)
        b_ms = cuda_ms(lambda: raster_backward_cuda(
            *args, alpha_matmul=mm, check_lists=False), 20)
        fb, fo, _, _ = forward_bound(f_stats, n_tiles, p)
        bb, bo, _, _ = backward_bound(b_stats, n_tiles, p, n_inst)
        fd, bd = forward_design_bytes(ci), backward_design_bytes(
            ci, got.n_contrib)
        say("kernel_loop", alpha_matmul=mm, instances=int(ci.bins.total),
            chunks_per_tile_median=int(chunks.median()),
            chunks_per_tile_max=int(chunks.max()),
            fwd_ms=f"{f_ms:.4f}", bwd_ms=f"{b_ms:.4f}",
            fwd_max_abs_err=f_err, n_contrib_mismatches=mism,
            bwd_max_norm_err=b_err, bit_equal_runs=2,
            pairs_tested=f_stats["tested"], pairs_walked=b_stats["walked"],
            pairs_contributing=f_stats["contributing"],
            fwd_bound_bytes=fb, fwd_bound_ops=fo,
            fwd_bound_ms=f"{bound_fields(fb, fo)['bound_ms']:.4f}",
            bwd_bound_bytes=bb, bwd_bound_ops=bo,
            bwd_bound_ms=f"{bound_fields(bb, bo)['bound_ms']:.4f}",
            n_contrib_crc32=zlib.crc32(
                got.n_contrib.cpu().numpy().tobytes()),
            **{"fwd_design_" + k + "_bytes": v for k, v in fd.items()},
            **{"bwd_design_" + k: v for k, v in bd.items()})
        for name, ms, (b_bytes, b_ops) in (("fwd", f_ms, (fb, fo)),
                                           ("bwd", b_ms, (bb, bo))):
            bound = bound_fields(b_bytes, b_ops)
            out[(name, mm)] = {"loop_scene_ms": ms,
                               "loop_scene_bound_ms": bound["bound_ms"],
                               "loop_scene_bound_by": bound["bound_by"]}
    return out


def phase_train(dev, profile_dir):
    """bench.py's step as cli/bench.py builds it (``bench.make_step``)."""
    import torch
    from feature3dgs_tpu_torch.cli import bench
    from feature3dgs_tpu_torch.model.decoder import init_decoder
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import (OptimizationConfig,
                                                     TrainState, train_step)
    # step 1 through the plain versions, then through the kernels
    ts_plain, plain_step = bench.make_step(dev, backend="plain")
    m_plain = plain_step(1)
    ts, step = bench.make_step(dev)
    cuda_raster.FORWARD_LAUNCHES = cuda_raster.BACKWARD_LAUNCHES = 0
    times, losses, per_step = [], [], []
    for it in range(1, 13):       # 2 warm-up steps, 10 timed
        if it == 3:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        f0, b0 = cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES
        t0 = time.perf_counter()
        m = step(it)
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
    del ts_plain, plain_step
    if profile_dir:
        write_profile(profile_dir, "train_profile.txt",
                      lambda: [step(13 + i) for i in range(2)])
    say("train", steps=len(times), step_ms_median=f"{statistics.median(times):.3f}",
        step_ms_min=f"{min(times):.3f}", step_ms_max=f"{max(times):.3f}",
        peak_mem_bytes=peak, instances=instances,
        forward_launches=launches[0], backward_launches=launches[1],
        step1_mu_max_norm_err=mu_err, step1_loss_vs_plain=loss_err,
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}")

    # the --speedup variant: 128 rendered channels lifted to 512
    del ts, step
    cam = bench_camera(WIDTH, HEIGHT, dev)
    bg = torch.zeros(3, device=dev)
    ocfg = OptimizationConfig()
    rcfg = RasterConfig(instance_capacity=bench.INSTANCE_CAPACITY, chunk=128)
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


def compare_alpha(name, got, ref, tol=1e-4, tol_depth=5e-4, outliers=0.0):
    """The alpha_matmul contract (tests/test_pallas.py:413-419): 1e-4 on
    color, features and final_T, 5e-4 on depth, n_contrib differing on
    fewer than 1% of pixels by at most 1. ``outliers`` is the share of
    pixels that may miss the bars (against the exact mode a splat whose
    power rounds to just above 0 at its own centre is dropped from that
    pixel, which then differs visibly and in n_contrib by more than 1).
    Returns (max abs error over color, features and final_T on the pixels
    within the bars, pixels outside them, pixels whose n_contrib differs,
    the largest difference)."""
    err = {}
    for k in ("color", "feature", "final_T", "depth"):
        d = (getattr(got, k) - getattr(ref, k)).abs()
        err[k] = d if d.dim() == 2 else d.amax(-1)
    out = ((err["color"] > tol) | (err["feature"] > tol)
           | (err["final_T"] > tol) | (err["depth"] > tol_depth))
    diff = (got.n_contrib - ref.n_contrib).abs()
    n_out, n_diff = int(out.sum()), int((diff > 0).sum())
    max_diff = int(diff.max()) if outliers else int(diff[~out].max())
    worst = {k: float(v.max()) for k, v in err.items()}
    if (n_out > outliers * out.numel() or n_diff >= 0.01 * diff.numel()
            or (not outliers and max_diff > 1)):
        raise AssertionError(
            f"{name}: {n_out} pixels outside the bars (worst {worst}), "
            f"n_contrib differs on {n_diff} pixels by up to {max_diff}")
    inside = max(float(err[k][~out].max())
                 for k in ("color", "feature", "final_T"))
    return inside, n_out, n_diff, max_diff


def phase_kernel_alpha_small(dev):
    import torch
    from feature3dgs_tpu_torch.ops.composite import (composite_plain,
                                                     composite_plain_backward)
    from feature3dgs_tpu_torch.ops.cuda_raster import (raster_backward_cuda,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    for f_dim, seed in ((4, 1), (128, 4)):
        g, view = small_scene(300, f_dim, seed, 3.0, dev)
        cam = camera(view, 64, 48, math.tan(0.5), math.tan(0.4), dev)
        ci = composite_inputs(
            g["means3d"], g["opacities"], g["feat"], cam, scales=g["scales"],
            rotations=g["rotations"], shs=g["shs"], sh_degree=2,
            config=RasterConfig(tile_w=16, tile_h=16))
        n_inst = ci.bins.gid_sorted.shape[0]
        plan = SegmentPlan(ci.bins.gid_sorted, ci.args[0].shape[0])
        fwd = raster_forward_cuda(*ci.args, alpha_matmul=True)
        ref = composite_plain(*ci.args, chunk=16, alpha_matmul=True)
        exact = raster_forward_cuda(*ci.args)
        torch.cuda.synchronize()
        tag = f"kernel_alpha_small F={f_dim}"
        err, _, n_diff, max_diff = compare_alpha(tag + " vs plain", fwd, ref)
        err_x, _, n_diff_x, max_diff_x = compare_alpha(
            tag + " vs exact mode", fwd, exact)
        gen = torch.Generator().manual_seed(seed)
        cts = [torch.randn(x.shape, generator=gen).to(dev)
               for x in (fwd.color, fwd.feature, fwd.depth, fwd.final_T)]
        # the backward re-decides the forward's own pairs, so each mode's
        # backward takes its own forward's final_T and n_contrib
        got = raster_backward_cuda(
            *ci.args, *cts, fwd.final_T, fwd.n_contrib, alpha_matmul=True,
            out=poisoned_rows(n_inst, f_dim, dev))
        ref_rows = composite_plain_backward(
            *ci.args, *cts, fwd.final_T, fwd.n_contrib, chunk=16,
            alpha_matmul=True)
        exact_rows = raster_backward_cuda(*ci.args, *cts, exact.final_T,
                                          exact.n_contrib)
        torch.cuda.synchronize()
        assert_all_written(tag, got)
        g_err, _ = compare_rows(tag + " backward vs plain", got, ref_rows,
                                plan, 1e-4)
        g_err_x, _ = compare_rows(tag + " backward vs exact mode", got,
                                  exact_rows, plan, 1e-4)
        say("kernel_alpha_small", F=f_dim, instances=int(ci.bins.total),
            fwd_max_abs_err=err, n_contrib_diff_pixels=n_diff,
            n_contrib_max_diff=max_diff, bwd_max_norm_err=g_err, nan_rows=0,
            vs_exact_fwd_max_abs_err=err_x,
            vs_exact_n_contrib_diff_pixels=n_diff_x,
            vs_exact_n_contrib_max_diff=max_diff_x,
            vs_exact_bwd_max_norm_err=g_err_x)


def phase_kernel_alpha_full(dev, params, state, gt_image, gt_feature):
    """Both kernels at the training scene, alpha_matmul off and on in turns;
    returns the kernels-line fields of the two alpha-mode entries."""
    import torch
    from feature3dgs_tpu_torch.ops.composite import (composite_plain,
                                                     composite_plain_backward)
    from feature3dgs_tpu_torch.ops.cuda_raster import (raster_backward_cuda,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    ci = bench_inputs(dev, params, state)
    n_inst = ci.bins.gid_sorted.shape[0]
    n_tiles, p = ci.grid.num_tiles, ci.grid.pixels_per_tile
    plan = SegmentPlan(ci.bins.gid_sorted, N_GAUSS)

    def forward(mm):
        return raster_forward_cuda(*ci.args, alpha_matmul=mm)

    fwd, exact = forward(True), forward(False)
    f_stats: dict = {}
    ref = composite_plain(*ci.args, chunk=128, alpha_matmul=True,
                          stats=f_stats)
    torch.cuda.synchronize()
    err, _, n_diff, max_diff = compare_alpha("kernel_alpha_full vs plain",
                                             fwd, ref)
    # against the exact mode the bars are 5x the test scenes' (the regrouped
    # sum's rounding, ~6e-8 x the ~70 its terms reach at a 32-pixel tile with
    # 3-pixel splats, enters alpha, and the lists are ten times as long), and
    # 1 pixel in 10,000 may miss them
    err_x, n_out_x, n_diff_x, max_diff_x = compare_alpha(
        "kernel_alpha_full vs exact mode", fwd, exact, 5e-4, 2.5e-3, 1e-4)
    del ref
    back_args = {}
    for mm, out in ((True, fwd), (False, exact)):
        back_args[mm] = (*ci.args, *bench_loss_cotangents(
            ci, out, gt_image, gt_feature), out.final_T, out.n_contrib)

    def backward(mm, **kw):
        return raster_backward_cuda(*back_args[mm], alpha_matmul=mm,
                                    check_lists=False, **kw)

    got = backward(True, out=poisoned_rows(n_inst, F_DIM, dev))
    b_stats: dict = {}
    t0 = time.perf_counter()
    ref_rows = composite_plain_backward(*back_args[True], chunk=128,
                                        alpha_matmul=True, stats=b_stats)
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t0) * 1e3
    assert_all_written("kernel_alpha_full", got)
    # 1e-3, not the test scenes' 1e-4: the chain rule from the coefficient
    # sums back to the conic cancels terms of the order of xl^2 (up to
    # ~1000 at 32-pixel tiles) times the result, so the order of the sums
    # alone moves the conic rows by a few 1e-4 of their largest
    g_err, g_abs = compare_rows("kernel_alpha_full backward vs plain", got,
                                ref_rows, plan, 1e-3)
    del ref_rows
    # the pixels that dropped a splat at its centre move that Gaussian's
    # gradient and its neighbours': 1 Gaussian in 1,000 may miss the bar
    g_err_x, g_out_x = compare_gaussian_grads(
        "kernel_alpha_full backward vs exact mode", got, backward(False),
        plan, 1e-3, 1e-3)

    # exact, alpha, alpha, exact: both modes see the same card state
    ms = {("fwd", False): [], ("fwd", True): [], ("bwd", False): [],
          ("bwd", True): []}
    for mm in (False, True, True, False):
        ms[("fwd", mm)].append(cuda_ms(lambda: forward(mm), 20))
        ms[("bwd", mm)].append(cuda_ms(lambda: backward(mm), 20))
    fwd_plain_ms = cuda_ms(lambda: composite_plain(
        *ci.args, chunk=128, alpha_matmul=True), 2)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    fb, fo, _, _ = forward_bound(f_stats, n_tiles, p)
    bb, bo, _, _ = backward_bound(b_stats, n_tiles, p, n_inst)
    say("kernel_alpha_full", instances=int(ci.bins.total),
        fwd_ms_exact=json.dumps([round(x, 4) for x in ms[("fwd", False)]]),
        fwd_ms_alpha=json.dumps([round(x, 4) for x in ms[("fwd", True)]]),
        bwd_ms_exact=json.dumps([round(x, 4) for x in ms[("bwd", False)]]),
        bwd_ms_alpha=json.dumps([round(x, 4) for x in ms[("bwd", True)]]),
        fwd_plain_ms=f"{fwd_plain_ms:.2f}", bwd_plain_ms=f"{bwd_plain_ms:.2f}",
        fwd_max_abs_err=err, n_contrib_diff_pixels=n_diff,
        n_contrib_max_diff=max_diff, bwd_max_norm_err=g_err,
        vs_exact_fwd_max_abs_err=err_x, vs_exact_outlier_pixels=n_out_x,
        vs_exact_n_contrib_diff_pixels=n_diff_x,
        vs_exact_n_contrib_max_diff=max_diff_x,
        vs_exact_bwd_max_norm_err=g_err_x,
        vs_exact_bwd_outlier_gaussians=g_out_x, fwd_bound_bytes=fb,
        fwd_bound_ops=fo, bwd_bound_bytes=bb, bwd_bound_ops=bo)
    return ({"max_abs_err": err, "ms": mean[("fwd", True)],
             "plain_ms": fwd_plain_ms, **bound_fields(fb, fo)},
            {"max_abs_err": g_abs, "ms": mean[("bwd", True)],
             "plain_ms": bwd_plain_ms, **bound_fields(bb, bo)})


# the reference's wide feature widths: SAM's 256, LSeg's 512 without the
# speed-up decoder (bench.py:39-42)
WIDE_DIMS = (256, 512)


def phase_kernel_wide(dev):
    """Both kernels in both modes at F = 256 and 512 against their plain
    versions, where the launch plans differ from F = 128: the forward
    composites 2 and 4 channel groups a tile (only group 0 writes color,
    depth, final_T and n_contrib), the backward stages 16 and 8 cotangent
    rows a ring stage at 512-pixel tiles. At a test scene (300 Gaussians,
    64x48, 16x16 tiles, boosted opacities) at kernel_small's and
    kernel_bwd_small's bars (kernel_alpha_small's in the alpha_matmul
    mode), and at the training scene (bench_scene at that width, orbit view
    0, 32x16 tiles) at kernel_full's and kernel_bwd_full's (the alpha_matmul
    mode at kernel_alpha_full's, with bench.py's loss cotangents). Each
    kernel timed at the training scene (20 launches) beside its bytes
    bound. Returns {(kernel, mode): the kernels line's f{F}_ms and
    f{F}_bound_ms fields}."""
    import torch
    from feature3dgs_tpu_torch.ops.composite import (composite_plain,
                                                     composite_plain_backward)
    from feature3dgs_tpu_torch.ops.cuda_raster import (backward_plan,
                                                       forward_plan,
                                                       raster_backward_cuda,
                                                       raster_forward_cuda)
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    out = {}
    for f_dim, seed in zip(WIDE_DIMS, (4, 2)):
        # the test scene
        g, view = small_scene(300, f_dim, seed, 3.0, dev)
        cam = camera(view, 64, 48, math.tan(0.5), math.tan(0.4), dev)
        ci = composite_inputs(
            g["means3d"], g["opacities"], g["feat"], cam, scales=g["scales"],
            rotations=g["rotations"], shs=g["shs"], sh_degree=2,
            config=RasterConfig(tile_w=16, tile_h=16))
        plan = SegmentPlan(ci.bins.gid_sorted, ci.args[0].shape[0])
        n_inst = ci.bins.gid_sorted.shape[0]
        small = {}
        for mm in (False, True):
            tag = f"kernel_wide F={f_dim} test scene alpha_matmul={mm}"
            fwd = raster_forward_cuda(*ci.args, alpha_matmul=mm)
            ref = composite_plain(*ci.args, chunk=16, alpha_matmul=mm)
            gen = torch.Generator().manual_seed(seed)
            cts = [torch.randn(x.shape, generator=gen).to(dev)
                   for x in (fwd.color, fwd.feature, fwd.depth, fwd.final_T)]
            rest = (*cts, fwd.final_T, fwd.n_contrib)
            rows = raster_backward_cuda(*ci.args, *rest, alpha_matmul=mm,
                                        out=poisoned_rows(n_inst, f_dim, dev))
            ref_rows = composite_plain_backward(*ci.args, *rest, chunk=16,
                                                alpha_matmul=mm)
            torch.cuda.synchronize()
            if mm:
                f_err = compare_alpha(tag, fwd, ref)[0]
            else:
                f_err = compare(tag, fwd, ref, 1e-5, 1e-4, 1.0)[0]
            assert_all_written(tag, rows)
            b_err, _ = compare_rows(tag + " backward", rows, ref_rows, plan,
                                    1e-4 if mm else 5e-6)
            small[mm] = (f_err, b_err)
        say("kernel_wide", F=f_dim, scene="test", size="64x48",
            instances=int(ci.bins.total),
            fwd_max_abs_err=json.dumps([small[False][0], small[True][0]]),
            bwd_max_norm_err=json.dumps([small[False][1], small[True][1]]),
            modes="exact,alpha_matmul", n_contrib="equal (exact)", nan_rows=0)
        del g, ci, plan, fwd, ref, cts, rest, rows, ref_rows

        # the training scene
        params, state, gt_image, gt_feature = bench_scene(dev, f_dim=f_dim)
        ci = bench_inputs(dev, params, state)
        n_tiles, p = ci.grid.num_tiles, ci.grid.pixels_per_tile
        n_inst = ci.bins.gid_sorted.shape[0]
        plan = SegmentPlan(ci.bins.gid_sorted, N_GAUSS)
        fields = {}
        for mm in (False, True):
            tag = f"kernel_wide F={f_dim} training scene alpha_matmul={mm}"
            f_stats, b_stats = {}, {}
            fwd = raster_forward_cuda(*ci.args, alpha_matmul=mm)
            ref = composite_plain(*ci.args, chunk=128, alpha_matmul=mm,
                                  stats=f_stats)
            torch.cuda.synchronize()
            if mm:
                f_err, _, mism, _ = compare_alpha(tag, fwd, ref)
            else:
                f_err, mism, _ = compare(tag, fwd, ref, 1e-4, 1e-3, 0.9999)
            del ref
            args = (*ci.args, *bench_loss_cotangents(ci, fwd, gt_image,
                                                     gt_feature),
                    fwd.final_T, fwd.n_contrib)
            rows = raster_backward_cuda(*args, alpha_matmul=mm,
                                        check_lists=False,
                                        out=poisoned_rows(n_inst, f_dim, dev))
            ref_rows = composite_plain_backward(*args, chunk=128,
                                                alpha_matmul=mm,
                                                stats=b_stats)
            torch.cuda.synchronize()
            assert_all_written(tag, rows)
            b_err, _ = compare_rows(tag + " backward", rows, ref_rows, plan,
                                    1e-3 if mm else 1e-5)
            del ref_rows, rows
            f_ms = cuda_ms(lambda: raster_forward_cuda(*ci.args,
                                                       alpha_matmul=mm), 20)
            b_ms = cuda_ms(lambda: raster_backward_cuda(
                *args, alpha_matmul=mm, check_lists=False), 20)
            del fwd, args
            fb = bound_fields(*forward_bound(f_stats, n_tiles, p, f_dim)[:2])
            bb = bound_fields(*backward_bound(b_stats, n_tiles, p, n_inst,
                                              f_dim)[:2])
            fp, bp = forward_plan(p, f_dim, mm), backward_plan(p, f_dim, mm)
            say("kernel_wide", F=f_dim, scene="training", alpha_matmul=mm,
                instances=int(ci.bins.total), fwd_max_abs_err=f_err,
                n_contrib_mismatches=mism, bwd_max_norm_err=b_err,
                fwd_ms=f"{f_ms:.4f}", fwd_bound_ms=f"{fb['bound_ms']:.4f}",
                fwd_bound_by=fb["bound_by"], bwd_ms=f"{b_ms:.4f}",
                bwd_bound_ms=f"{bb['bound_ms']:.4f}",
                bwd_bound_by=bb["bound_by"],
                fwd_plan=f"groups={fp.groups},splits={fp.splits},"
                f"threads={fp.threads},smem={fp.smem_bytes}",
                bwd_plan=f"entries={bp.entries},ring_rows={bp.ring_rows},"
                f"smem={bp.smem_bytes}")
            for name, ms, bound in (("fwd", f_ms, fb), ("bwd", b_ms, bb)):
                out.setdefault((name, mm), {}).update({
                    f"f{f_dim}_ms": ms, f"f{f_dim}_bound_ms": bound["bound_ms"]})
        del params, state, gt_image, gt_feature, ci, plan
        torch.cuda.empty_cache()
    return out


# what each measuring CLI prints (the JAX scripts' keys; bench_render,
# bench_longrun and bench_scaling also name the device)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL = {"step_ms", "timing_method", "compile_s", "instances", "image",
                "n_gauss", "f_dim", "device", "loss"}
RENDER_KEYS = {"metric", "f_dim", "render_ms", "fps", "batch", "image",
               "n_gauss", "platform", "device"}
LONGRUN_DETAIL = {"overall_ms_it", "in_window_median_ms_it",
                  "densify_window_median_ms_it", "measured_iters", "spans",
                  "densify_spans", "num_active", "capacity_regrew", "device"}
SCALING_KEYS = {"devices", "mesh", "images_per_step", "platform", "backend",
                "step_ms", "step_ms_ratio_vs_1dev", "efficiency_vs_1dev",
                "device"}


def finite_numbers(obj) -> bool:
    """Every number in a parsed JSON value is finite."""
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def phase_bench_clis():
    """The five measuring CLIs' main in process, each at its full default
    scene with few iterations: cli.bench (bench.py's step), cli.bench_render
    (F = 16, 128, 256), cli.profile_step, cli.bench_longrun (80 iterations,
    a round every 20, 50 of warm-up) and cli.bench_scaling (the 1-card row).
    Each printed line's keys, finite numbers and loss, the card named in
    each, no capacity growth inside the long run's measured region.
    Returns the forward and backward launches the five made."""
    import contextlib
    import io

    from feature3dgs_tpu_torch.cli import (bench, bench_longrun, bench_render,
                                           bench_scaling, profile_step)
    from feature3dgs_tpu_torch.ops import cuda_raster
    runs = {"bench": (bench.main, []),
            "bench_render": (bench_render.main, ["--iters", "2"]),
            "profile_step": (profile_step.main, ["--n", "2", "--top", "5"]),
            "bench_longrun": (bench_longrun.main, [
                "--iters", "80", "--warmup", "50", "--densify_interval",
                "20"]),
            "bench_scaling": (bench_scaling.main, ["--iters", "2"])}
    card = card_line()
    printed, seconds = {}, {}
    cuda_raster.FORWARD_LAUNCHES = cuda_raster.BACKWARD_LAUNCHES = 0
    for name, (main, argv) in runs.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        seconds[name] = round(time.perf_counter() - t0, 1)
        printed[name] = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"bench_clis: {name} returned {rc}:\n"
                                 f"{printed[name][-2000:]}")
    launches = (cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES)
    js = {name: [json.loads(ln) for ln in text.splitlines()
                 if ln.startswith("{")] for name, text in printed.items()}
    problems = []
    (b,) = js["bench"]
    if (set(b) != BENCH_KEYS or set(b["detail"]) != BENCH_DETAIL
            or b["detail"]["timing_method"] != "cuda_events"
            or not finite_numbers(b) or b["detail"]["loss"] <= 0):
        problems.append(f"bench {b}")
    if ([r["f_dim"] for r in js["bench_render"]] != [16, 128, 256] or any(
            set(r) != RENDER_KEYS or r["platform"] != "gpu"
            or not finite_numbers(r) for r in js["bench_render"])):
        problems.append(f"bench_render {js['bench_render']}")
    text = printed["profile_step"]
    loss = float(text.split("loss=")[1].split()[0])
    if ("step span:" not in text or "   med_ms count  name" not in text
            or "idle share" not in text or not math.isfinite(loss)
            or card not in text):
        problems.append(f"profile_step {text[-1500:]}")
    (lr,) = js["bench_longrun"]
    if (set(lr["detail"]) != LONGRUN_DETAIL or lr["detail"]["capacity_regrew"]
            or not finite_numbers(lr)):
        problems.append(f"bench_longrun {lr}")
    (sc,) = js["bench_scaling"]
    if set(sc) != SCALING_KEYS or sc["mesh"] != [1, 1] or \
            not finite_numbers(sc):
        problems.append(f"bench_scaling {sc}")
    devices = ([b["detail"]["device"], lr["detail"]["device"], sc["device"]]
               + [r["device"] for r in js["bench_render"]])
    if any(d != card for d in devices):
        problems.append(f"devices {devices}, card {card}")
    if problems:
        raise AssertionError("bench_clis: " + "; ".join(problems))
    say("bench_clis", seconds=json.dumps(seconds).replace(" ", ""),
        bench_step_ms=b["detail"]["step_ms"], bench_loss=b["detail"]["loss"],
        bench_instances=b["detail"]["instances"],
        render_ms=json.dumps({r["f_dim"]: r["render_ms"]
                              for r in js["bench_render"]}).replace(" ", ""),
        profile_step_span=text.split("step span: ")[1].split(" ms")[0],
        profile_idle=text.split("idle share ")[1].split()[0],
        longrun_ratio=lr["value"],
        longrun_detail=json.dumps(lr["detail"]).replace(" ", ""),
        scaling_step_ms=sc["step_ms"], forward_launches=launches[0],
        backward_launches=launches[1])
    return launches


# the rows each stage micro-benchmark prints, by CLI
MICRO_ROWS = {
    "micro_segsum": ("plain_at_add", "oob_drop", "spill_spread",
                     "sorted_fused", "sorted_materialized",
                     "segment_plan_sum"),
    "micro_expand": ("v0_current", "v1_reshape_cols", "v2_transpose",
                     "v3_reshape3d", "v4_packed4", "v5_gather2d",
                     "port_expand", "port_expand_sized"),
    "micro_pack": ("one_640", "split", "feat_only", "misc_only",
                   "kernel_reads")}


def phase_micro():
    """The three stage micro-benchmarks' main in process at their full
    default sizes, 2 timed calls a row: cli.micro_segsum (552,960 x 256
    rows into 100,000, a quarter dropped: the variants held to one another
    at 1e-3, among them SegmentPlan's segment_reduce, which leaves the
    dropped rows past its segments, against index_add_), cli.micro_expand
    (524,288 slots: the six layouts bit-equal, the port's expansion with
    and without its host read bit-equal on the slots it keeps) and
    cli.micro_pack (the four slab gathers at 552,960 x 640, bit-equal, and
    the forward kernel's reads at F = 512, the training scene). Each
    returns 0, opens with the card's line and prints every row with a
    finite ms and bound on gpu. Returns the forward launches made."""
    import contextlib
    import io

    from feature3dgs_tpu_torch.cli import micro_expand, micro_pack, micro_segsum
    from feature3dgs_tpu_torch.ops import cuda_raster
    mains = {"micro_segsum": micro_segsum.main,
             "micro_expand": micro_expand.main, "micro_pack": micro_pack.main}
    card = card_line()
    problems, seconds, ms, bound = [], {}, {}, {}
    cuda_raster.FORWARD_LAUNCHES = 0
    for cli, main in mains.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(["--iters", "2"])
        seconds[cli] = round(time.perf_counter() - t0, 1)
        lines = buf.getvalue().splitlines()
        if rc != 0 or not lines or lines[0] != card:
            problems.append(f"{cli} rc={rc} {lines[:1]}")
        for name in MICRO_ROWS[cli]:
            row = next((ln.split() for ln in lines[1:]
                        if ln.split()[:1] == [name] and ", gpu]" in ln), None)
            if row is None:
                problems.append(f"{cli}: no gpu row {name}")
                continue
            ms[name] = float(row[1])
            bound[name] = float(row[row.index("bound") + 1])
            if not (math.isfinite(ms[name]) and ms[name] > 0
                    and math.isfinite(bound[name]) and bound[name] > 0):
                problems.append(f"{cli}: {name} ms={ms[name]} "
                                f"bound={bound[name]}")
    launches = cuda_raster.FORWARD_LAUNCHES
    if launches < 1:
        problems.append("kernel_reads launched no forward kernel")
    if problems:
        raise AssertionError("micro: " + "; ".join(problems))
    say("micro", seconds=json.dumps(seconds).replace(" ", ""),
        ms=json.dumps(ms).replace(" ", ""),
        bound_ms=json.dumps(bound).replace(" ", ""),
        forward_launches=launches)
    return launches


def phase_adam(dev):
    """The fused Adam at 1 M Gaussians, F = 128 and 512: one step
    bit-equal to the plain version, then times. Returns the kernel's row
    for the kernels line, less its launches: those are counted on the
    training loop's main path."""
    import torch

    from feature3dgs_tpu_torch.model import optim
    from feature3dgs_tpu_torch.model.gaussians import GaussianParams
    from feature3dgs_tpu_torch.ops import cuda_adam
    n = 1_000_000
    lrs = optim.group_lrs(optim.LRConfig(), 15_000, 1.0)
    row = {"library_ms": {}}
    for f_dim in (128, 512):
        gen = torch.Generator(device=dev).manual_seed(f_dim)
        shapes = {"xyz": (n, 3), "features_dc": (n, 1, 3),
                  "features_rest": (n, 15, 3), "scaling": (n, 3),
                  "rotation": (n, 4), "opacity": (n, 1),
                  "semantic_feature": (n, 1, f_dim)}

        def draw(scale, square=False):
            out = {k: torch.randn(s, generator=gen, device=dev) * scale
                   for k, s in shapes.items()}
            return {k: v * v for k, v in out.items()} if square else out

        grads = draw(1e-3)
        sh = torch.randn((n, 16, 3), generator=gen, device=dev) * 1e-3
        grads["features_dc"], grads["features_rest"] = sh[:, :1], sh[:, 1:]
        fused = [draw(1.0), draw(1e-3), draw(1e-3, square=True),
                 torch.tensor(14_999, dtype=torch.int32, device=dev)]
        plain = [{k: v.clone() for k, v in d.items()} for d in fused[:3]] \
            + [fused[3].clone()]
        keep = torch.tensor(True, device=dev)
        with torch.no_grad():
            optim._adam_by_device(fused[0], grads, fused[1], fused[2],
                                  fused[3], lrs, 0.9, 0.999, 1e-15, keep)
            optim._adam_(plain[0], grads, plain[1], plain[2], plain[3], lrs,
                         0.9, 0.999, 1e-15, keep)
        torch.cuda.synchronize()
        for part in range(3):
            for k in shapes:
                if not torch.equal(fused[part][k].view(torch.int32),
                                   plain[part][k].view(torch.int32)):
                    raise AssertionError(f"adam F={f_dim}: {k} of part "
                                         f"{part} differs from the plain one")
        if not torch.equal(fused[3], plain[3]):
            raise AssertionError(f"adam F={f_dim}: step counters differ")
        elements = sum(math.prod(s) for s in shapes.values())
        group = GaussianParams(**fused[0])
        g_params = GaussianParams(**grads)
        state = optim.AdamState(GaussianParams(**fused[1]),
                                GaussianParams(**fused[2]), fused[3])
        ms = cuda_ms(lambda: optim.adam_update(group, g_params, state, lrs,
                                               keep=keep), 20)
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: optim._adam_(
                plain[0], grads, plain[1], plain[2], plain[3], lrs, 0.9,
                0.999, 1e-15, keep), 3)
        del plain
        library_ms = None
        if hasattr(torch, "_fused_adam_"):
            names = list(shapes)
            flat = [grads[k].contiguous() for k in names]
            steps = [torch.tensor(15_000.0, device=dev) for _ in names]
            library_ms = cuda_ms(lambda: torch._fused_adam_(
                [fused[0][k] for k in names], flat,
                [fused[1][k] for k in names], [fused[2][k] for k in names],
                [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0,
                eps=1e-15, amsgrad=False, maximize=False), 20)
        bound = bytes_bound_ms(28 * elements)
        row.update({f"f{f_dim}_ms": ms, f"f{f_dim}_bound_ms": bound,
                    f"f{f_dim}_plain_ms": plain_ms})
        row["library_ms"][f"f{f_dim}"] = library_ms
        say("adam", F=f_dim, elements=elements, bit_equal=True,
            group_ms=f"{ms:.4f}", bound_ms=f"{bound:.4f}",
            roofline=f"{bound / ms:.3f}", plain_ms=f"{plain_ms:.3f}",
            library_ms=None if library_ms is None else f"{library_ms:.4f}",
            **cuda_adam.kernel_attributes())
        del fused, grads, sh, group, g_params, state
        torch.cuda.empty_cache()
    return row


def phase_preprocess(dev):
    """The preprocess kernels (ops/csrc/preprocess.cu) at 1 M Gaussians
    (bench.py's cloud; random scales, rotations, opacities, SH and a live
    mask), orbit view 0 at 1216 x 800, SH degree 3 with an ndc_offset: the
    forward bit-equal to the plain ops (``_prep_plain``), the backward to
    ``preprocess_backward`` on cotangents laid out as the compositing hands
    them; each kernel's ms (CUDA events, mean of 20) beside its bytes bound,
    the plain version's ms and the autograd path's (the plain ops' forward
    with their autograd backward, what the kernels replace). Returns the
    two kernels' rows for the kernels line, less their launches."""
    import torch

    from feature3dgs_tpu_torch.core.projection import preprocess_backward
    from feature3dgs_tpu_torch.ops import cuda_preprocess as cp
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig, _prep_plain
    n, degree, m_rows = 1_000_000, 3, 16
    params, _, _, _ = bench_scene(dev, n_gauss=n, f_dim=1)
    gen = torch.Generator(device=dev).manual_seed(20)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    rot = randn(n, 4)
    x = {"means3d": params.xyz.detach().contiguous(),
         "scales": torch.exp(math.log(0.02) + 0.4 * randn(n, 3)),
         "rotations": (rot / rot.norm(dim=1, keepdim=True)).contiguous(),
         "shs": randn(n, m_rows, 3) * 0.4,
         "opacities": torch.rand(n, generator=gen, device=dev) * 0.9 + 0.05,
         "ndc_offset": torch.zeros((n, 2), device=dev),
         "active_mask": torch.rand(n, generator=gen, device=dev) > 0.02}
    del params
    cam = bench_camera(device=dev)
    grid = RasterConfig().grid(cam.width, cam.height)

    def plain_fwd(inputs=x):
        pre, xy, rmin, rmax, valid = _prep_plain(
            inputs["means3d"], inputs["opacities"], cam, grid,
            scales=inputs["scales"], rotations=inputs["rotations"],
            cov3d_precomp=None, shs=inputs["shs"], sh_degree=degree,
            colors_precomp=None, scale_modifier=1.0,
            ndc_offset=inputs["ndc_offset"],
            active_mask=inputs["active_mask"])
        return (xy, pre.depth, pre.conic, pre.radius, pre.rgb, rmin, rmax,
                pre.valid, valid)

    def kernel_fwd():
        return cp.preprocess_forward_cuda(
            x["means3d"], x["scales"], x["rotations"], x["shs"],
            x["opacities"], cam, grid, sh_degree=degree,
            ndc_offset=x["ndc_offset"], active_mask=x["active_mask"])

    def differing(names, got, want):
        out = {}
        for name, g, w in zip(names, got, want):
            g, w = g.contiguous(), w.contiguous()
            if g.dtype == torch.float32:
                nan = torch.isnan(g) & torch.isnan(w)
                out[name] = int(((g.view(torch.int32) != w.view(torch.int32))
                                 & ~nan).sum())
            else:
                out[name] = int((g != w).sum())
        return out

    with torch.no_grad():
        got, want = kernel_fwd(), plain_fwd()
        fwd_bad = differing(("xy", "depth", "conic", "radius", "rgb",
                             "rect_min", "rect_max", "pre_valid", "valid"),
                            got, want)
        valid = want[-1]
        dg = randn(n, 10)
        cts = (dg[:, 0:2], dg[:, 9], dg[:, 2:5], dg[:, 6:9])
        bwd_args = (x["means3d"], x["scales"], x["rotations"], x["shs"],
                    degree, 1.0, cam, valid, *cts)
        gk = cp.preprocess_backward_cuda(*bwd_args, want_ndc_offset=True)
        gp = preprocess_backward(*bwd_args, want_ndc_offset=True)
        bwd_bad = differing(("g_means3d", "g_scales", "g_rotations",
                             "g_shs", "g_ndc_offset"), gk, gp)
    if any(fwd_bad.values()) or any(bwd_bad.values()):
        raise AssertionError(f"preprocess kernels differ from the plain "
                             f"versions: {fwd_bad} {bwd_bad}")
    with torch.no_grad():
        fwd_ms = cuda_ms(kernel_fwd, 20)
        bwd_ms = cuda_ms(lambda: cp.preprocess_backward_cuda(
            *bwd_args, want_ndc_offset=True), 20)
        plain_ms = cuda_ms(plain_fwd, 3)
        plain_bwd_ms = cuda_ms(lambda: preprocess_backward(
            *bwd_args, want_ndc_offset=True), 3)
    keys = ("means3d", "scales", "rotations", "shs", "ndc_offset")

    def autograd_step():
        leaves = {k: x[k].clone().requires_grad_() for k in keys}
        out = plain_fwd({**x, **leaves})
        torch.autograd.grad((out[0], out[1], out[2], out[4]),
                            list(leaves.values()), cts)
    autograd_ms = cuda_ms(autograd_step, 3)
    rows = (degree + 1) ** 2
    fwd_bytes = n * (12 + 12 + 16 + 4 + 12 * rows + 1 + 8) \
        + n * (8 + 4 + 12 + 4 + 12 + 16 + 2)
    bwd_bytes = n * (12 + 12 + 16 + 12 * rows + 1 + 8 + 4 + 12 + 12) \
        + n * (12 + 12 + 16 + 12 * m_rows + 8)
    fwd_bound, bwd_bound = bytes_bound_ms(fwd_bytes), bytes_bound_ms(bwd_bytes)
    say("preprocess", gaussians=n, degree=degree, valid=int(valid.sum()),
        bit_equal=True, forward_ms=f"{fwd_ms:.4f}",
        forward_bound_ms=f"{fwd_bound:.4f}",
        forward_roofline=f"{fwd_bound / fwd_ms:.3f}",
        backward_ms=f"{bwd_ms:.4f}", backward_bound_ms=f"{bwd_bound:.4f}",
        backward_roofline=f"{bwd_bound / bwd_ms:.3f}",
        plain_forward_ms=f"{plain_ms:.3f}",
        plain_backward_ms=f"{plain_bwd_ms:.3f}",
        autograd_path_ms=f"{autograd_ms:.3f}",
        forward_attributes=json.dumps(cp.kernel_attributes(False, degree)),
        backward_attributes=json.dumps(cp.kernel_attributes(True, degree)))
    del x, got, want, gk, gp
    torch.cuda.empty_cache()
    return ({"ms": fwd_ms, "plain_ms": plain_ms, "bound_bytes": fwd_bytes,
             "bound_ms": fwd_bound},
            {"ms": bwd_ms, "plain_ms": plain_bwd_ms,
             "autograd_path_ms": autograd_ms, "bound_bytes": bwd_bytes,
             "bound_ms": bwd_bound})


def resize_touched(n_in: int, n_out: int) -> int:
    """Source rows (or columns) an align_corners resize of one axis reads,
    from ATen's float32 taps."""
    if n_out == 1:
        scale = np.float32(0)
    else:
        scale = np.float32(n_in - 1) / np.float32(n_out - 1)
    lo = (scale * np.arange(n_out, dtype=np.float32)).astype(np.int64)
    return len(set(lo) | set(np.minimum(lo + 1, n_in - 1)))


def phase_resize(dev):
    """The tile-layout resize kernels at the training cells' shape: checks
    against the plain path, then times beside the bytes bound. Returns the
    two kernels' rows for the kernels line, less their launches."""
    import torch
    import torch.nn.functional as F

    from feature3dgs_tpu_torch.ops import cuda_resize as cr
    from feature3dgs_tpu_torch.ops.binning import TileGrid
    from feature3dgs_tpu_torch.ops.rasterize import tiles_to_image
    from feature3dgs_tpu_torch.train.losses import \
        resize_bilinear_align_corners
    grid = TileGrid(width=WIDTH, height=HEIGHT, tile_w=32, tile_h=16)
    out_h, out_w = HEIGHT // 2, WIDTH // 2
    n_pix = grid.num_tiles * grid.pixels_per_tile
    read_pix = (resize_touched(HEIGHT, out_h) * resize_touched(WIDTH, out_w))
    rows = ({}, {})

    def plain(x):
        return resize_bilinear_align_corners(tiles_to_image(x, grid), out_h,
                                             out_w)

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    for f_dim in (128, 512):
        gen = torch.Generator(device=dev).manual_seed(f_dim)
        tiles = torch.randn((grid.num_tiles, grid.pixels_per_tile, f_dim),
                            generator=gen, device=dev)
        g = torch.randn((out_h, out_w, f_dim), generator=gen, device=dev)
        fwd = lambda: cr.resize_forward_cuda(tiles, grid, out_h, out_w)
        bwd = lambda: cr.resize_backward_cuda(g, grid, out_h, out_w)
        got, got2 = fwd(), fwd()
        g_got, g_got2 = bwd(), bwd()
        x = tiles.clone().requires_grad_()
        ref = plain(x)
        g_ref, = torch.autograd.grad(ref, x, g)
        ref = ref.detach()
        differing = int((got.view(torch.int32) != ref.view(torch.int32))
                        .sum())
        max_ulp = int((ordered(got) - ordered(ref)).abs().max())
        bwd_gap = float((g_got - g_ref).abs().max() / g_ref.abs().max())
        repeat = (torch.equal(got.view(torch.int32), got2.view(torch.int32))
                  and torch.equal(g_got.view(torch.int32),
                                  g_got2.view(torch.int32)))
        if differing or not bwd_gap <= 1e-6 or not repeat:
            raise AssertionError(f"resize F={f_dim}: forward {differing} "
                                 f"elements off, {max_ulp} ulp at most; "
                                 f"backward gap {bwd_gap}; runs bit-equal "
                                 f"{repeat}")
        del got2, g_got2, x, g_ref
        fwd_ms, bwd_ms = cuda_ms(fwd, 20), cuda_ms(bwd, 20)

        def plain_fwd_bwd():
            xx = tiles.clone().requires_grad_()
            torch.autograd.grad(plain(xx), xx, g)
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: plain(tiles), 5)
        plain_fb_ms = cuda_ms(plain_fwd_bwd, 5)
        nchw = tiles_to_image(tiles, grid).permute(2, 0, 1)[None].contiguous()
        library_ms = cuda_ms(lambda: F.interpolate(
            nchw, size=(out_h, out_w), mode="bilinear", align_corners=True),
            20)
        del nchw
        fwd_bytes = 4 * f_dim * (read_pix + out_h * out_w)
        bwd_bytes = 4 * f_dim * (out_h * out_w + n_pix)
        fwd_bound, bwd_bound = (bytes_bound_ms(fwd_bytes),
                                bytes_bound_ms(bwd_bytes))
        say("resize", F=f_dim, forward_bits_differing=differing,
            forward_max_ulp=max_ulp, backward_max_gap=f"{bwd_gap:.3e}",
            runs_bit_equal=repeat, forward_ms=f"{fwd_ms:.4f}",
            forward_bound_ms=f"{fwd_bound:.4f}",
            forward_roofline=f"{fwd_bound / fwd_ms:.3f}",
            backward_ms=f"{bwd_ms:.4f}", backward_bound_ms=f"{bwd_bound:.4f}",
            backward_roofline=f"{bwd_bound / bwd_ms:.3f}",
            plain_forward_ms=f"{plain_ms:.4f}",
            plain_forward_backward_ms=f"{plain_fb_ms:.4f}",
            library_ms=f"{library_ms:.4f}",
            forward_attributes=json.dumps(cr.kernel_attributes(False)),
            backward_attributes=json.dumps(cr.kernel_attributes(True)))
        rows[0].update({f"f{f_dim}_ms": fwd_ms, f"f{f_dim}_bound_ms": fwd_bound,
                        f"f{f_dim}_plain_ms": plain_ms,
                        f"f{f_dim}_library_ms": library_ms})
        rows[1].update({f"f{f_dim}_ms": bwd_ms, f"f{f_dim}_bound_ms": bwd_bound,
                        f"f{f_dim}_plain_forward_backward_ms": plain_fb_ms})
        del tiles, g, got, g_got, ref
        torch.cuda.empty_cache()
    return rows


# the compressed schedule of the train_loop phase
LOOP_STEPS, LOOP_DENSIFY_FROM, LOOP_DENSIFY_EVERY, LOOP_RESET_EVERY = 50, 5, 10, 20
LOOP_SYNC_EVERY = 12
PREP_COUNTERS = ("PREPROCESS_LAUNCHES", "PREPROCESS_BWD_LAUNCHES")
RESIZE_COUNTERS = ("RESIZE_LAUNCHES", "RESIZE_BWD_LAUNCHES")
LOOP_EXTENT = 5.5   # 1.1 x the cameras' distance from the scene's centre


def loop_scene():
    """bench.py's scene as a SceneData: 100K points in [-2, 2]^3 with random
    colours (its draws, seed 0), the 8 orbit cameras of the serve phase,
    each with a U(0,1) image and an fp16 N(0, 0.1^2) teacher map at half
    resolution. The orbit cameras share one centre, so the scene radius is
    given (LOOP_EXTENT) instead of taken from their spread."""
    from feature3dgs_tpu_torch.data.cameras import Camera
    from feature3dgs_tpu_torch.data.dataset import SceneData
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.0, 2.0, (N_GAUSS, 3)).astype(np.float32)
    cols = rng.rand(N_GAUSS, 3).astype(np.float32)
    gen = np.random.default_rng(0)
    cams = []
    for i in range(N_VIEWS):
        c, s = math.cos(0.05 * i), math.sin(0.05 * i)
        teacher = gen.standard_normal((HEIGHT // 2, WIDTH // 2, F_DIM),
                                      dtype=np.float32)
        cams.append(Camera(
            uid=i, colmap_id=i,
            R=np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]),
            T=np.array([0.0, 0.0, 5.0]), fovx=2 * math.atan(0.6),
            fovy=2 * math.atan(0.45),
            image=gen.random((HEIGHT, WIDTH, 3), dtype=np.float32),
            image_name=f"orbit_{i}",
            semantic_feature=(teacher * 0.1).astype(np.float16),
            width=WIDTH, height=HEIGHT))
    return SceneData(train_cameras=cams, test_cameras=[], points=pts,
                     colors=cols, nerf_norm={"radius": LOOP_EXTENT},
                     feature_dim=F_DIM, source_path="<smoke>")


def carries_maintenance(it: int) -> bool:
    """Whether step ``it`` starts with the deferred densify round or opacity
    reset of iteration it - 1."""
    prev = it - 1
    return ((prev > LOOP_DENSIFY_FROM and prev % LOOP_DENSIFY_EVERY == 0)
            or (prev > 0 and prev % LOOP_RESET_EVERY == 0))


def run_loop(trainer, steps, dev, *, mm, count_syncs=()):
    """Drive ``trainer`` for ``steps`` iterations. Each step's time is the
    host clock around flush_maintenance + step + synchronize; the flush (the
    densify round and the reset) is also timed alone. Returns per-iteration
    records. Steps in ``count_syncs`` run under torch's sync debug mode and
    count the host reads PyTorch warns about."""
    import warnings

    import torch
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops import (cuda_adam, cuda_preprocess,
                                           cuda_raster, cuda_resize,
                                           cuda_segment)
    names = (("FORWARD_MM_LAUNCHES", "BACKWARD_MM_LAUNCHES") if mm
             else ("FORWARD_LAUNCHES", "BACKWARD_LAUNCHES"))
    records = []
    for _ in range(steps):
        it = trainer.iteration + 1
        sync = it == 1 or it % LOOP_SYNC_EVERY == 0
        before = [getattr(cuda_raster, n) for n in names]
        adam_before = cuda_adam.ADAM_LAUNCHES
        prep_before = [getattr(cuda_preprocess, n) for n in PREP_COUNTERS]
        resize_before = [getattr(cuda_resize, n) for n in RESIZE_COUNTERS]
        segment_before = cuda_segment.SEGMENT_LAUNCHES
        counting = it in count_syncs

        def watched(fn, *a, **kw):
            # only the trainer's own calls run under the sync debug mode,
            # not the synchronize() calls that time them
            if counting:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            watched(trainer.flush_maintenance)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = watched(trainer.step, sync=sync)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        rec = {"it": it, "sync": sync, "flush_ms": (t1 - t0) * 1e3,
               "step_ms": (t2 - t0) * 1e3, "loss": m["loss"],
               "finite": m["finite"],
               "launches": tuple(getattr(cuda_raster, n) - b
                                 for n, b in zip(names, before)),
               "adam_launches": cuda_adam.ADAM_LAUNCHES - adam_before,
               "prep_launches": tuple(getattr(cuda_preprocess, n) - b
                                      for n, b in zip(PREP_COUNTERS,
                                                      prep_before)),
               "resize_launches": tuple(getattr(cuda_resize, n) - b
                                        for n, b in zip(RESIZE_COUNTERS,
                                                        resize_before)),
               "segment_launches": cuda_segment.SEGMENT_LAUNCHES
               - segment_before,
               "syncs": None}
        if counting:
            sites = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                     for w in caught
                     if "synchronizing CUDA operation" in str(w.message)]
            rec["syncs"], rec["sync_sites"] = len(sites), sites
        if sync:
            rec["num_active"] = int(m["num_active"])
            rec["num_instances"] = int(m["num_instances"])
            rec["instance_capacity"] = trainer.rcfg.instance_capacity
            rec["capacity"] = trainer.ts.params.capacity
            alive = int(trainer.ts.gstate.alive.sum())
            if alive != rec["num_active"]:
                raise AssertionError(f"train_loop: num_active "
                                     f"{rec['num_active']} but {alive} alive")
        if it - 1 > 0 and (it - 1) % LOOP_RESET_EVERY == 0:
            # this step's flush reset the opacities; the step then moved them
            # by at most one Adam step
            rec["max_opacity_after_reset"] = float(
                G.get_opacity(trainer.ts.params, trainer.ts.gstate.alive).max())
        records.append(rec)
    return records


def phase_train_loop(dev, scene, scene_s):
    import torch
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    from feature3dgs_tpu_torch.ops import (cuda_adam, cuda_preprocess,
                                           cuda_raster, cuda_resize,
                                           cuda_segment)
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.render import renderer
    from feature3dgs_tpu_torch.train import checkpoints as ckpt
    from feature3dgs_tpu_torch.train.trainer import (OptimizationConfig,
                                                     Trainer)
    work = os.path.join(ROOT, "build", "smoke", "loop")
    os.makedirs(work, exist_ok=True)
    ocfg = OptimizationConfig(
        iterations=LOOP_STEPS, densify_from_iter=LOOP_DENSIFY_FROM,
        densification_interval=LOOP_DENSIFY_EVERY,
        opacity_reset_interval=LOOP_RESET_EVERY, densify_until_iter=10_000)

    def make(rcfg):
        return Trainer(scene, ocfg=ocfg, rcfg=rcfg, max_sh_degree=3,
                       feature_dim=F_DIM, capacity_headroom=1.0, seed=0,
                       device=dev)

    for name in ("FORWARD_LAUNCHES", "BACKWARD_LAUNCHES",
                 "FORWARD_MM_LAUNCHES", "BACKWARD_MM_LAUNCHES"):
        setattr(cuda_raster, name, 0)
    cuda_adam.ADAM_LAUNCHES = 0
    for name in PREP_COUNTERS:
        setattr(cuda_preprocess, name, 0)
    for name in RESIZE_COUNTERS:
        setattr(cuda_resize, name, 0)
    cuda_segment.SEGMENT_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer = make(RasterConfig())
    init_s = time.perf_counter() - t0
    cap0, icap0 = trainer.ts.params.capacity, trainer.rcfg.instance_capacity
    active0 = trainer.ts.gstate.num_active

    records = run_loop(trainer, 2, dev, mm=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records += run_loop(trainer, LOOP_DENSIFY_EVERY - 3, dev, mm=False)
    # the mean screen-space gradient of the first round, read once here: if
    # the default threshold would clone or split under 1% of the Gaussians
    # of this random scene, the 70th percentile takes its place
    gs = trainer.ts.gstate
    seen = gs.alive & (gs.denom > 0)
    grads = (gs.xyz_gradient_accum / gs.denom.clamp_min(1e-20))[seen]
    default_thr = ocfg.densify_grad_threshold
    hot_share = float((grads >= default_thr).float().mean())
    q50, q70, q90 = (float(x) for x in torch.quantile(
        grads, torch.tensor([0.5, 0.7, 0.9], device=dev)))
    threshold = default_thr if hot_share >= 0.01 else q70
    ocfg = dataclasses.replace(ocfg, densify_grad_threshold=threshold)
    trainer.ocfg = ocfg
    say("train_loop_threshold", default=default_thr,
        hot_share_at_default=hot_share, grad_q50=q50, grad_q70=q70,
        grad_q90=q90, grad_max=float(grads.max()), used=threshold)

    records += run_loop(trainer, 30 - trainer.iteration, dev, mm=False)
    # checkpoint mid-run (after iteration 30's round, as the CLI does), load
    # it into a fresh Trainer, and take the same next step in both
    trainer.flush_maintenance(drain=True)
    path = ckpt.save_checkpoint(work, trainer.iteration, trainer.ts)
    other = make(trainer.rcfg)
    ts, it = ckpt.load_checkpoint(path, device=dev)
    other.restore_state(ts)
    other.iteration = it
    cam = scene.train_cameras[3]
    m_a = trainer.step(camera=cam, sync=True)
    m_b = other.step(camera=cam, sync=True)
    resume_loss = abs(m_a["loss"] - m_b["loss"]) / abs(m_a["loss"])
    resume_mu = max(norm_err(getattr(other.ts.adam.mu, k),
                             getattr(trainer.ts.adam.mu, k))
                    for k in trainer.ts.params.FIELDS)
    if it != 30 or not resume_loss <= 1e-5 or not resume_mu <= 1e-4:
        raise AssertionError(f"train_loop: resumed at {it}, next step's loss "
                             f"off by {resume_loss}, Adam mu by {resume_mu}")
    ckpt_bytes = os.path.getsize(path)
    os.remove(path)
    del other, ts

    window = range(37, 47)      # ten steps without a sync point
    records += run_loop(trainer, LOOP_STEPS - trainer.iteration, dev,
                        mm=False, count_syncs=window)
    ply = ckpt.save_scene_ply(work, trainer.iteration, trainer.ts.params,
                              trainer.ts.gstate)
    # iteration 50's round is still pending. If no round has pruned so far
    # (after a reset every Gaussian of this random scene gains opacity), this
    # last round alone prunes below the 5th percentile of the opacities
    # instead of the default 0.005.
    min_opacity = ocfg.min_opacity
    if sum(r["num_pruned"] for r in trainer.densify_log) == 0:
        from feature3dgs_tpu_torch.model import gaussians as G
        alive = trainer.ts.gstate.alive
        min_opacity = float(torch.quantile(
            G.get_opacity(trainer.ts.params)[alive][:1 << 24], 0.05))
        trainer.ocfg = dataclasses.replace(ocfg, min_opacity=min_opacity)
    trainer.flush_maintenance(drain=True)
    trainer.ocfg = ocfg
    # across iteration 1000, where the SH degree rises
    degree0 = trainer.ts.gstate.active_sh_degree
    trainer.iteration = 998
    records += run_loop(trainer, 3, dev, mm=False)
    trainer.flush_maintenance(drain=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    vals = torch.stack([torch.as_tensor(r["loss"], dtype=torch.float64,
                                        device=dev) for r in records]).tolist()
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"train_loop: non-finite loss in {vals}")
    # one fused Adam launch a step for the Gaussians, one more for a decoder
    adam_per_step = 2 if trainer.speedup else 1
    # and one preprocess and one resize launch each way: the view's
    # forward, the step's backward; one segment-sum launch for the
    # backward's feature and geometric rows
    bad = [(r["it"], r["launches"], r["adam_launches"], r["prep_launches"],
            r["resize_launches"], r["segment_launches"])
           for r in records
           if r["launches"] != (1, 1) or r["adam_launches"] != adam_per_step
           or r["prep_launches"] != (1, 1) or r["resize_launches"] != (1, 1)
           or r["segment_launches"] != 1]
    if bad:
        raise AssertionError(f"train_loop: raster, Adam, preprocess, resize "
                             f"and segment-sum launches per step {bad}")
    log = trainer.densify_log
    totals = {k: sum(r[k] for r in log)
              for k in ("num_cloned", "num_split", "num_pruned")}
    synced = [r for r in records if r["sync"]]
    grown = [r for r in synced if r["instance_capacity"] > icap0]
    over = [r for r in grown[1:]
            if r["num_instances"] > r["instance_capacity"]]
    resets = [r["max_opacity_after_reset"] for r in records
              if "max_opacity_after_reset" in r]
    problems = []
    if min(totals.values()) <= 0:
        problems.append(f"clones, splits or prunes missing: {totals}")
    if len({r["num_active"] for r in synced}) < 2:
        problems.append("num_active never changed")
    if trainer.ts.params.capacity <= cap0:
        problems.append("the Gaussian capacity never grew")
    if not grown or over:
        problems.append(f"instance capacity: grown {len(grown)}, over it "
                        f"after growth {over}")
    # a reset caps opacity at 0.01; one Adam step at lr 0.05 then moves the
    # logit by at most ~0.16
    if not resets or max(resets) > 0.012:
        problems.append(f"opacity after a reset: {resets}")
    if trainer.ts.gstate.active_sh_degree != degree0 + 1:
        problems.append("the SH degree did not rise at iteration 1000")
    per_step = [r["syncs"] for r in records if r["syncs"] is not None]
    maint_syncs = [r["syncs"] for r in records
                   if r["syncs"] is not None and carries_maintenance(r["it"])]
    if not maint_syncs or max(per_step) != min(per_step):
        problems.append(f"host reads per step differ in the window (a round "
                        f"or the loop reads the device): {per_step}")
    if problems:
        raise AssertionError("train_loop: " + "; ".join(problems))
    # where one step of the window blocks on the stream (PyTorch's sync debug
    # mode names a blocking host-to-device copy as well as a device read)
    import collections
    sites = collections.Counter(next(
        r["sync_sites"] for r in records if r["syncs"] is not None))

    with torch.inference_mode():
        params, state = load_gaussians_ply(ply, max_sh_degree=3, device=dev)
        out = renderer.render(params, state,
                              scene.train_cameras[0].to_view(dev),
                              config=trainer.rcfg)
        served_ok = all(bool(torch.isfinite(x).all())
                        for x in (out.color, out.feature, out.depth))
        if not served_ok or out.color.shape != (HEIGHT, WIDTH, 3):
            raise AssertionError("train_loop: the saved PLY does not serve")
        served_active = state.num_active
        del params, state, out
    os.remove(ply)
    launches = (cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES)
    adam_launches = cuda_adam.ADAM_LAUNCHES
    prep_launches = [getattr(cuda_preprocess, n) for n in PREP_COUNTERS]
    resize_launches = [getattr(cuda_resize, n) for n in RESIZE_COUNTERS]
    segment_launches = cuda_segment.SEGMENT_LAUNCHES

    main_run = [r for r in records if 3 <= r["it"] <= LOOP_STEPS
                and not r["sync"]]
    plain = [r["step_ms"] for r in main_run if not carries_maintenance(r["it"])]
    maint = [r["step_ms"] for r in main_run if carries_maintenance(r["it"])]
    rounds = [r["flush_ms"] for r in records if 3 <= r["it"] <= LOOP_STEPS
              and (r["it"] - 1) > LOOP_DENSIFY_FROM
              and (r["it"] - 1) % LOOP_DENSIFY_EVERY == 0]
    exact_early = [r["step_ms"] for r in records if 3 <= r["it"] <= 10]
    stat = lambda xs: (f"{statistics.median(xs):.3f}/{min(xs):.3f}/"
                       f"{max(xs):.3f}")
    say("train_loop", steps=len(records), scene_s=f"{scene_s:.1f}",
        trainer_init_s=f"{init_s:.1f}", threshold=threshold,
        last_round_min_opacity=min_opacity,
        plain_step_ms_median_min_max=stat(plain), plain_steps=len(plain),
        maintenance_step_ms_median_min_max=stat(maint),
        maintenance_steps=len(maint),
        densify_round_ms_median_min_max=stat(rounds), rounds=len(log),
        host_syncs_per_step=per_step[0], host_syncs_in_10_steps=sum(per_step),
        peak_mem_bytes=peak, active_start=active0,
        active_end=trainer.ts.gstate.num_active, capacity_start=cap0,
        capacity_end=trainer.ts.params.capacity,
        instance_capacity_start=icap0,
        instance_capacity_end=trainer.rcfg.instance_capacity,
        instances_first_sync=synced[0]["num_instances"],
        instances_last_sync=synced[-1]["num_instances"],
        cloned=totals["num_cloned"], split=totals["num_split"],
        pruned=totals["num_pruned"],
        max_opacity_after_resets=json.dumps([round(x, 5) for x in resets]),
        sh_degree=trainer.ts.gstate.active_sh_degree,
        resume_loss_rel_err=resume_loss, resume_mu_max_norm_err=resume_mu,
        checkpoint_bytes=ckpt_bytes, served_active=served_active,
        forward_launches=launches[0], backward_launches=launches[1],
        adam_launches=adam_launches, adam_launches_per_step=adam_per_step,
        preprocess_launches=prep_launches[0],
        preprocess_backward_launches=prep_launches[1],
        resize_launches=resize_launches[0],
        resize_backward_launches=resize_launches[1],
        segment_sum_launches=segment_launches,
        loss_first=f"{vals[0]:.6f}", loss_last=f"{vals[-1]:.6f}")
    say("train_loop_sync_sites", per_step=json.dumps(sites).replace(" ", ""))
    say("train_loop_rounds", log=json.dumps(log).replace(" ", ""))
    say("train_loop_steps", step_ms=json.dumps(
        [round(r["step_ms"], 1) for r in records]).replace(" ", ""))
    del trainer

    # the same loop's first ten steps with the alpha_matmul mode on
    alpha = make(RasterConfig(alpha_matmul=True))
    a_records = run_loop(alpha, 10, dev, mm=True)
    a_vals = [float(r["loss"]) for r in a_records]
    a_bad = [(r["launches"], r["adam_launches"], r["prep_launches"],
              r["resize_launches"], r["segment_launches"])
             for r in a_records
             if r["launches"] != (1, 1) or r["adam_launches"] != adam_per_step
             or r["prep_launches"] != (1, 1)
             or r["resize_launches"] != (1, 1)
             or r["segment_launches"] != 1]
    if (not all(math.isfinite(v) for v in a_vals) or a_bad or launches != (
            cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES)):
        raise AssertionError(f"train_loop alpha_matmul: losses {a_vals}, "
                             f"launches {a_bad}")
    mm_launches = (cuda_raster.FORWARD_MM_LAUNCHES,
                   cuda_raster.BACKWARD_MM_LAUNCHES)
    say("train_loop_alpha", steps=len(a_records),
        step_ms_median_min_max=stat([r["step_ms"] for r in a_records[2:]]),
        exact_mode_same_steps_ms_median_min_max=stat(exact_early),
        forward_mm_launches=mm_launches[0],
        backward_mm_launches=mm_launches[1],
        adam_launches=cuda_adam.ADAM_LAUNCHES - adam_launches,
        preprocess_launches=cuda_preprocess.PREPROCESS_LAUNCHES
        - prep_launches[0],
        preprocess_backward_launches=cuda_preprocess.PREPROCESS_BWD_LAUNCHES
        - prep_launches[1],
        segment_sum_launches=cuda_segment.SEGMENT_LAUNCHES - segment_launches,
        loss_first=f"{a_vals[0]:.6f}", loss_last=f"{a_vals[-1]:.6f}",
        exact_loss_first=f"{vals[0]:.6f}")
    return (launches, mm_launches, cuda_adam.ADAM_LAUNCHES,
            tuple(getattr(cuda_preprocess, n) for n in PREP_COUNTERS),
            tuple(getattr(cuda_resize, n) for n in RESIZE_COUNTERS),
            cuda_segment.SEGMENT_LAUNCHES)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_clis(phase, cmds, timeout=300):
    """Run ``{name: argv}`` CLI subprocesses together from the checkout;
    returns {name: seconds} and raises on any exit code but 0."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, argv in cmds.items()}
    seconds, failed = {}, []
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} exited {proc.returncode}:\n{out[-2000:]}\n"
                          f"{err[-4000:]}")
    if failed:
        raise AssertionError(f"{phase}: " + "\n".join(failed))
    return seconds


def phase_train_cli(work):
    """The train CLI as a subprocess (serve_cli renders its output).
    Returns the trained model's folder and the scene's."""
    import shutil

    from feature3dgs_tpu_torch.data.synthetic import write_blender_scene
    shutil.rmtree(work, ignore_errors=True)
    scene = write_blender_scene(os.path.join(work, "scene"), n_frames=4,
                                size=128, f_dim=16, n_pts=2000, seed=0,
                                n_test=2)
    out = os.path.join(work, "out")
    port = free_port()
    train = [
        "feature3dgs_tpu_torch.cli.train", "-s", scene, "-m", out, "-f",
        "lseg", "--eval", "--iterations", "40", "--densify_from_iter", "5",
        "--densification_interval", "10", "--opacity_reset_interval", "30",
        "--densify_grad_threshold", "1e-7", "--save_iterations", "20",
        "--checkpoint_iterations", "30", "--test_iterations", "40",
        "--sync_every", "10", "--port", str(port)]
    # a SIBR client reads a frame at each of the first 3 sync points while
    # the CLI trains (each message asks to train on)
    from feature3dgs_tpu_torch.data.dataset import load_scene
    cam = load_scene(scene, foundation_model="lseg").train_cameras[0]
    msg = sibr_message(cam.view, cam.full_proj, 128, 128, cam.fovx, cam.fovy)
    seen = {"frames": []}

    def client():
        try:
            c = SibrClient(port, timeout=240)
            for _ in range(3):
                seen["frames"].append(c.frame(msg))
            c.close()
        except Exception as e:        # reported below
            seen["error"] = repr(e)

    import threading
    viewer = threading.Thread(target=client, daemon=True)
    viewer.start()
    seconds = run_clis("train_cli", {"train": train})["train"]
    viewer.join(timeout=30)
    frames = seen["frames"]
    if len(frames) != 3 or any(
            np.frombuffer(img, np.uint8).std() == 0 or metrics["#"] <= 0
            for img, metrics, _ in frames):
        raise AssertionError(f"train_cli: viewer got {len(frames)} frames "
                             f"({seen.get('error')}), metrics "
                             f"{[f[1] for f in frames]}")
    tb_events = any(f.startswith("events.out.tfevents")
                    for f in os.listdir(out))
    expect = ["point_cloud/iteration_20/point_cloud.ply",
              "point_cloud/iteration_40/point_cloud.ply", "cfg_args",
              "cameras.json", "train_log.jsonl", "chkpnt30.ckpt",
              "chkpnt30.meta.json"]
    missing = [f for f in expect if not os.path.exists(os.path.join(out, f))]
    with open(os.path.join(out, "train_log.jsonl")) as f:
        last = json.loads(f.read().strip().splitlines()[-1])
    if (missing or last["iteration"] != 40 or not math.isfinite(last["loss"])
            or not last["num_active"] > 2000):
        raise AssertionError(f"train_cli: missing {missing}, last log line "
                             f"{last}")
    say("train_cli", train_s=f"{seconds:.1f}", exit_code=0,
        iterations=last["iteration"],
        loss=f"{last['loss']:.5f}", points_start=2000,
        points_end=int(last["num_active"]), artifacts=len(expect),
        viewer_frames=len(frames),
        viewer_points=json.dumps([f[1]["#"] for f in frames]),
        viewer_frame_ms=json.dumps([round(f[2], 1) for f in frames]),
        tensorboard_events=tb_events)
    return out, scene


def phase_serve_cli(work, out, scene):
    """The render CLI and the downstream CLIs on train_cli's model, as
    subprocesses: the render CLI with --render_batch 3 --novel_view
    --num_views 6 --video and, beside it, once with each edit config
    (written as JSON from EDIT_CONFIGS) and seeded text features, one view
    at a time as by default; then the segmentation, segmentation-metric and
    metrics CLIs on their output. Every exit code, the artifact trees, and
    finite metrics."""
    labels = ",".join(_OBJECTS)
    text = os.path.join(work, "text.npy")
    np.save(text, np.random.RandomState(0).randn(len(_OBJECTS), 16)
            .astype(np.float32))
    render = ["feature3dgs_tpu_torch.cli.render", "-m", out, "--iteration",
              "40"]
    first = {"render_batch": render + ["--render_batch", "3", "--novel_view",
                                       "--num_views", "6", "--video"]}
    for name, mapping in EDIT_CONFIGS.items():
        path = os.path.join(work, name + ".json")
        with open(path, "w") as f:
            json.dump(mapping, f)
        first[name] = render + ["--edit_config", path, "--text_features",
                                text]
    seconds = run_clis("serve_cli", first)
    base = os.path.join(out, "train", "ours_40")
    seg_out = os.path.join(work, "segmentation")
    metric_json = os.path.join(work, "segmentation_metric.json")
    seconds.update(run_clis("serve_cli", {
        "segmentation": [
            "feature3dgs_tpu_torch.cli.segmentation", "--feature_dir",
            os.path.join(base, "saved_feature"), "--output", seg_out,
            "--label_src", labels, "--text_features", text, "--image_dir",
            os.path.join(base, "renders")],
        "segmentation_metric": [
            "feature3dgs_tpu_torch.cli.segmentation_metric", "--student_dir",
            os.path.join(base, "saved_feature"), "--teacher_dir",
            os.path.join(scene, "rgb_feature_langseg"), "--label_src", labels,
            "--text_features", text, "--output", metric_json],
        "metrics": ["feature3dgs_tpu_torch.cli.metrics", "-m", out]}))
    edits = [f"ours_40_{op}_car" for op in ("color_func", "deletion",
                                             "extraction")]
    expect = ([f"{s}/ours_40/renders/{i:05d}.png" for s, n in
               (("train", 4), ("test", 2), ("novel_views", 6), ("video", 6))
               for i in range(n)]
              + [f"{s}/ours_40/saved_feature/00003_fmap_CxHxW.{x}"
                 for s in ("train", "video") for x in ("npy", "pt")]
              + [f"{s}/{e}/renders/{i:05d}.png" for e in edits
                 for s, n in (("train", 4), ("test", 2)) for i in range(n)]
              + ["results.json", "per_view.json"])
    missing = [f for f in expect if not os.path.exists(os.path.join(out, f))]
    missing += [f for f in (f"{i:05d}{x}" for i in range(4) for x in (
        "_labels.npy", "_mask.png", "_vis.png", "_legend.png"))
        if not os.path.exists(os.path.join(seg_out, f))]
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    with open(metric_json) as f:
        seg_metric = json.load(f)
    scores = [v for m in results.values() for k, v in m.items()
              if k != "LPIPS"] + [seg_metric["mean_accuracy"],
                                  seg_metric["mean_miou"]]
    if (missing or sorted(results) != sorted(["ours_40"] + edits)
            or not all(math.isfinite(v) for v in scores)
            # each view's .npy and .pt both pair with a teacher, in sorted
            # order, as scripts/segmentation_metric.py pairs them: 6 rows
            or len(seg_metric["per_image"]) != 6):
        raise AssertionError(f"serve_cli: missing {missing}, results "
                             f"{results}, segmentation metric {seg_metric}")
    say("serve_cli", exit_codes="0," * 6 + "0",
        seconds=json.dumps({k: round(v, 1) for k, v in seconds.items()})
        .replace(" ", ""), artifacts=len(expect),
        psnr_test=f"{results['ours_40']['PSNR']:.3f}",
        ssim_test=f"{results['ours_40']['SSIM']:.4f}",
        lpips=results["ours_40"]["LPIPS"],
        segmentation_accuracy=f"{seg_metric['mean_accuracy']:.4f}")


def sibr_message(view, proj_full, width, height, fovx, fovy, mode=0,
                 scaling=1.0, train=True) -> dict:
    """The camera message a SIBR client sends for a math-convention view
    and full projection (transposed, with the client's column flips)."""
    wvt = np.asarray(view, np.float32).T.copy()
    wvt[:, 1:3] = -wvt[:, 1:3]
    vpt = np.asarray(proj_full, np.float32).T.copy()
    vpt[:, 1] = -vpt[:, 1]
    return {"resolution_x": width, "resolution_y": height, "train": train,
            "fov_y": fovy, "fov_x": fovx, "z_near": 0.01, "z_far": 100.0,
            "keep_alive": True, "scaling_modifier": scaling,
            "view_matrix": wvt.ravel().tolist(),
            "view_projection_matrix": vpt.ravel().tolist(),
            "render_mode": mode}


class SibrClient:
    """The client side of the SIBR protocol on a loopback socket."""

    def __init__(self, port, timeout=120.0):
        import socket
        deadline = time.time() + timeout
        while True:
            try:
                self.sock = socket.create_connection(("127.0.0.1", port),
                                                     timeout=timeout)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        n = int.from_bytes(self._read(4), "little")
        self.items = json.loads(self._read(n).decode())

    def _read(self, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(min(n - len(buf), 1 << 22))
            if not chunk:
                raise ConnectionError("viewer server closed")
            buf += chunk
        return bytes(buf)

    def frame(self, msg):
        """(frame bytes, metrics, round-trip ms) of one camera message."""
        t0 = time.perf_counter()
        payload = json.dumps(msg).encode()
        self.sock.sendall(len(payload).to_bytes(4, "little") + payload)
        img = self._read(msg["resolution_x"] * msg["resolution_y"] * 3)
        self._read(int.from_bytes(self._read(4), "little"))   # source path
        metrics = json.loads(self._read(
            int.from_bytes(self._read(4), "little")).decode())
        return img, metrics, (time.perf_counter() - t0) * 1e3

    def close(self):
        self.sock.close()


def phase_viewer(dev, params, state):
    """The viewers on the serve phase's scene (128 rendered channels lifted
    to 512 by the seeded decoder), 1216x800: cli.view's serve loop on a
    NetworkGUI in a thread on a free loopback port; a client asks for each
    render mode at orbit view 0 (3 frames each) and 2 frames at scaling
    0.5 (views 1, 2); each frame equals render_net_image of a direct
    render of the same camera bit for bit. Then the WebViewer: /info and
    4 /render PNGs, each decoded and equal to the direct render's image.
    Returns the forward launches of the served frames."""
    import io
    import threading
    import urllib.request

    import torch
    from PIL import Image

    from feature3dgs_tpu_torch.cli.view import serve
    from feature3dgs_tpu_torch.core import transforms
    from feature3dgs_tpu_torch.model.decoder import apply_decoder, init_decoder
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.render import renderer
    from feature3dgs_tpu_torch.render.modes import (RENDER_ITEMS,
                                                    render_net_image)
    from feature3dgs_tpu_torch.viewer.network_gui import (NetworkGUI,
                                                          camera_from_message,
                                                          render_frame)
    from feature3dgs_tpu_torch.viewer.web import WebViewer

    decoder = init_decoder(F_DIM, F_OUT, seed=0, device=dev)

    def render_fn(view, scaling_modifier):
        out = renderer.render(params, state, view,
                              scaling_modifier=scaling_modifier)
        return out._replace(feature=apply_decoder(decoder, out.feature))

    fovx, fovy = 1.2, 0.9
    msgs = []
    for mode in range(len(RENDER_ITEMS)):
        view = orbit_view(0)
        proj = transforms.projection_matrix(0.01, 100.0, fovx, fovy) @ view
        msgs += [sibr_message(view, proj, WIDTH, HEIGHT, fovx, fovy,
                              mode)] * 3
    for i in (1, 2):
        view = orbit_view(i)
        proj = transforms.projection_matrix(0.01, 100.0, fovx, fovy) @ view
        msgs.append(sibr_message(view, proj, WIDTH, HEIGHT, fovx, fovy, 0,
                                 scaling=0.5))

    def direct(msg):
        """The JAX way: render_net_image, then clip * 255 to uint8."""
        cam = camera_from_message(msg)
        with torch.inference_mode():
            view = cam.to_view(dev)
            out = render_fn(view, cam.scaling_modifier)
            img = render_net_image({"color": out.color,
                                    "feature": out.feature,
                                    "depth": out.depth}, RENDER_ITEMS,
                                   cam.render_mode, view.proj)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes()

    # warm-up of every mode's path (QR, sort, colormap tables)
    for m in msgs[::3]:
        direct(m)
    gui = NetworkGUI("127.0.0.1", 0)
    stop = threading.Event()
    server = threading.Thread(target=serve, args=(
        gui, render_fn, "smoke", state.num_active, dev, stop), daemon=True)
    server.start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_raster.FORWARD_LAUNCHES = 0
    client = SibrClient(gui.listener.getsockname()[1])
    got = [client.frame(m) for m in msgs]
    client.close()
    launches = cuda_raster.FORWARD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stop.set()
    server.join(timeout=30)
    gui.close()
    if client.items != RENDER_ITEMS or launches != len(msgs):
        raise AssertionError(f"viewer: items {client.items}, {launches} "
                             f"launches for {len(msgs)} frames")
    bad = [i for i, (m, (img, metrics, _)) in enumerate(zip(msgs, got))
           if img != direct(m) or metrics["#"] != N_GAUSS]
    if bad:
        raise AssertionError(f"viewer: frames {bad} differ from direct "
                             "renders")

    # the direct path's own time (render, channel, uint8, one copy)
    def one_frame(msg):
        cam = camera_from_message(msg)
        with torch.inference_mode():
            return render_frame(render_fn, cam, dev).cpu()

    render_ms, frame_ms = {}, {}
    for mode, item in enumerate(RENDER_ITEMS):
        frame_ms[item] = round(statistics.median(
            g[2] for g in got[3 * mode:3 * mode + 3]), 3)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_frame(msgs[3 * mode])
            times.append((time.perf_counter() - t0) * 1e3)
        render_ms[item] = round(statistics.median(times), 3)
    syncs = blocking_calls(lambda: one_frame(msgs[0]))
    say("viewer", frames=len(msgs), launches=launches,
        bit_equal_to_direct=len(msgs), peak_mem_bytes=peak,
        blocking_calls_rgb_frame=syncs,
        frame_ms_median=json.dumps(frame_ms).replace(" ", ""),
        render_ms_median=json.dumps(render_ms).replace(" ", ""),
        frame_ms_scaling_half=json.dumps([round(g[2], 3)
                                          for g in got[-2:]]))

    def render_pkg(cam, scaling):
        with torch.inference_mode():
            out = render_fn(cam.to_view(dev), scaling)
        return {"color": out.color, "feature": out.feature,
                "depth": out.depth}

    web = WebViewer(render_pkg, center=[0, 0, 0], radius=5.0,
                    n_gaussians=N_GAUSS, feature_dim=F_OUT,
                    port=0).serve_background()
    try:
        base = f"http://127.0.0.1:{web.port}"
        info = json.loads(urllib.request.urlopen(base + "/info").read())
        queries = [{"az": a, "el": 0.2, "w": WIDTH, "h": HEIGHT, "mode": m}
                   for a, m in ((0.3, 0), (0.9, 1), (1.5, 3), (2.1, 5))]
        web_ms, render_hdr = [], []
        for q in queries:
            t0 = time.perf_counter()
            resp = urllib.request.urlopen(base + "/render?" + "&".join(
                f"{k}={v}" for k, v in q.items()))
            png = resp.read()
            web_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
            render_hdr.append(float(resp.headers["X-Render-Ms"]))
            got_img = np.asarray(Image.open(io.BytesIO(png)))
            cam, mode, scaling = web.camera({k: str(v) for k, v in q.items()})
            pkg = render_pkg(cam, scaling)
            proj = torch.from_numpy(np.asarray(cam.full_proj)).to(dev)
            ref = (np.clip(render_net_image(pkg, RENDER_ITEMS, mode, proj),
                           0, 1) * 255).astype(np.uint8)
            if got_img.shape != (HEIGHT, WIDTH, 3) or \
                    not np.array_equal(got_img, ref):
                raise AssertionError(f"web viewer: /render {q} differs from "
                                     "the direct render")
    finally:
        web.close()
    if info["n_gaussians"] != N_GAUSS or info["modes"] != RENDER_ITEMS:
        raise AssertionError(f"web viewer: /info {info}")
    say("web_viewer", pngs=len(queries), equal_to_direct=len(queries),
        request_ms=json.dumps(web_ms), render_ms_header=json.dumps(render_hdr))
    return launches


def timed_ms(fn, reps=3) -> float:
    """Median host milliseconds of fn() with the card synchronized around
    each call, after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_encoders(dev, params, state):
    """The teacher encoders at their published widths with seeded weights
    built on the card (no weights exist here): LSeg ViT-L/16 (encode_image
    of a 480x360 image, the net's f32 output against the same weights on
    the CPU), CLIP ViT-B/32 (CLIPConfig()'s defaults, card against CPU),
    SAM ViT-H (``sam_encoder.build_sam``: 1280 wide, 32 blocks;
    encode_image timed on the card; a 2-block copy at full width held
    against the CPU), then segment_time's
    loop on an embedding rendered from the serve scene through a seeded
    128 -> 256 decoder, and auto_masks on it."""
    import copy
    import importlib.metadata

    import torch
    import torch.nn.functional as F
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel

    from feature3dgs_tpu_torch.cli.segment_time import time_decoding
    from feature3dgs_tpu_torch.encoders import (clip_pixel, lseg_net,
                                                sam_decode, sam_encoder,
                                                seeded_init_)
    from feature3dgs_tpu_torch.model.decoder import apply_decoder, init_decoder
    from feature3dgs_tpu_torch.render import renderer

    bar = 1e-4      # card against CPU, max-normalised
    rng = np.random.RandomState(0)
    gen = torch.Generator(dev).manual_seed(0)
    results = {"transformers": importlib.metadata.version("transformers")}

    # LSeg ViT-L/16 + DPT head
    net = lseg_net.build_lseg(dev, gen)
    n_params = sum(p.numel() for p in net.parameters())
    img = rng.rand(360, 480, 3).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lseg_ms = timed_ms(lambda: lseg_net.encode_image(img, net))
    lseg_peak = torch.cuda.max_memory_allocated()
    # card against CPU at 160x128 (the whole net; the CPU forward at
    # 480x352 alone takes seconds)
    fmap = lseg_net.encode_image(img, net)
    small_img = img[:128, :160]
    card = lseg_net.encode_features(small_img, net)
    cpu_net = copy.deepcopy(net).cpu()
    del net
    lseg_err = norm_err(card.cpu(), lseg_net.encode_features(small_img,
                                                             cpu_net))
    del cpu_net
    if tuple(fmap.shape) != (512, 360, 480) or fmap.dtype != torch.float16 \
            or not lseg_err <= bar:
        raise AssertionError(f"encoders: LSeg {tuple(fmap.shape)} "
                             f"{fmap.dtype}, card vs CPU {lseg_err}")
    say("encoders_lseg", params=n_params, image="480x360", input="480x352",
        encode_ms_median=f"{lseg_ms:.3f}", peak_mem_bytes=lseg_peak,
        card_vs_cpu_160x128_max_norm_err=lseg_err, bar=bar)

    # CLIP ViT-B/32 (MaskCLIP pixel features)
    with torch.device(dev):
        clip_model = CLIPModel(CLIPConfig())
    seeded_init_(clip_model, gen).eval()
    clip = (clip_model, CLIPImageProcessor())
    image8 = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    clip_ms = timed_ms(lambda: clip_pixel.encode_image(image8, (240, 320),
                                                       clip=clip))
    card = clip_pixel.encode_image(image8, (240, 320), clip=clip)
    cpu_clip = (copy.deepcopy(clip_model).cpu(), clip[1])
    clip_err = norm_err(card.cpu(), clip_pixel.encode_image(
        image8, (240, 320), clip=cpu_clip))
    del clip, cpu_clip, clip_model
    if tuple(card.shape) != (512, 240, 320) or not clip_err <= bar:
        raise AssertionError(f"encoders: CLIP {tuple(card.shape)}, card vs "
                             f"CPU {clip_err}")
    say("encoders_clip", config="CLIPConfig()", encode_ms_median=
        f"{clip_ms:.3f}", card_vs_cpu_max_norm_err=clip_err, bar=bar)

    # SAM ViT-H (encoders/sam_encoder.py:build_sam): a 2-block copy at full
    # width against the CPU first
    small = sam_encoder.build_sam(dev, gen, num_hidden_layers=2,
                                  global_attn_indexes=[1])
    emb_card = sam_encoder.encode_image(image8, small)
    cpu_small = (copy.deepcopy(small[0]).cpu(), small[1])
    emb_err = norm_err(emb_card.cpu(),
                       sam_encoder.encode_image(image8, cpu_small))
    pts = [[200.0, 150.0], [500.0, 300.0]]
    lg_card, iou_card = sam_decode.decode_masks(
        emb_card, (480, 640), points=pts, return_logits=True, sam=small)
    lg_cpu, iou_cpu = sam_decode.decode_masks(
        emb_card.cpu(), (480, 640), points=pts, return_logits=True,
        sam=cpu_small)
    dec_err = max(norm_err(lg_card.cpu(), lg_cpu),
                  norm_err(iou_card.cpu(), iou_cpu))
    del small, cpu_small
    if not (emb_err <= bar and dec_err <= bar):
        raise AssertionError(f"encoders: SAM 2-block card vs CPU: embedding "
                             f"{emb_err}, decoder {dec_err}")
    sam = sam_encoder.build_sam(dev, gen)
    n_params = sum(p.numel() for p in sam[0].parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sam_ms = timed_ms(lambda: sam_encoder.encode_image(image8, sam))
    sam_peak = torch.cuda.max_memory_allocated()
    emb = sam_encoder.encode_image(image8, sam)
    if tuple(emb.shape) != (256, 48, 64) or \
            not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"encoders: SAM ViT-H {tuple(emb.shape)}")
    say("encoders_sam", params=n_params, width=1280, blocks=32,
        global_attn="7,15,23,31", image="640x480",
        encode_ms_median=f"{sam_ms:.3f}", peak_mem_bytes=sam_peak,
        card_vs_cpu_2block_embedding_max_norm_err=emb_err,
        card_vs_cpu_2block_decoder_max_norm_err=dec_err, bar=bar,
        transformers=results["transformers"])

    # segment_time: an embedding rendered from the serve scene
    decoder = init_decoder(F_DIM, 256, seed=1, device=dev)
    cam = bench_camera(WIDTH, HEIGHT, dev)
    with torch.inference_mode():
        out = renderer.render(params, state, cam)
        rendered = apply_decoder(decoder, out.feature).permute(2, 0, 1)
        grid = (round(64 * HEIGHT / WIDTH), 64)
        emb = F.interpolate(rendered[None], size=grid, mode="bilinear",
                            align_corners=False)[0].clone()
        image = (torch.clamp(out.color, 0, 1) * 255).to(torch.uint8
                                                         ).cpu().numpy()
    timing = time_decoding(sam, [emb], [image], points=8)
    if timing["masks_rendered"] != 24 or timing["masks_encoder"] != 24:
        raise AssertionError(f"encoders: segment_time {timing}")
    say("segment_time", embedding=f"256x{grid[0]}x{grid[1]}",
        image=f"{WIDTH}x{HEIGHT}", points=8,
        masks_rendered=timing["masks_rendered"],
        masks_per_s_rendered=f"{timing['masks_per_s_rendered']:.2f}",
        masks_encoder=timing["masks_encoder"],
        masks_per_s_encoder=f"{timing['masks_per_s_encoder']:.2f}",
        ratio=f"{timing['slowdown']:.2f}")

    auto = {}
    for name, kw in (("default", {}),
                     ("unfiltered", dict(pred_iou_thresh=-1e9,
                                         stability_thresh=0.0))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = sam_decode.auto_masks(emb, (HEIGHT, WIDTH), points_per_side=16,
                                     sam=sam, **kw)
        torch.cuda.synchronize()
        auto[name] = (len(recs), (time.perf_counter() - t0) * 1e3)
        if recs and (recs[0]["segmentation"].shape != (HEIGHT, WIDTH)
                     or recs[0]["segmentation"].device.type != "cuda"):
            raise AssertionError("encoders: auto_masks records")
    say("auto_masks", points_per_side=16, note="filtering depends on the "
        "random weights", masks_default=auto["default"][0],
        ms_default=f"{auto['default'][1]:.1f}",
        masks_unfiltered=auto["unfiltered"][0],
        ms_unfiltered=f"{auto['unfiltered'][1]:.1f}")


# the JAX package's oracle bars (tests/test_rasterize.py:72-81,84-128): per
# output 99.5% of the values within TIGHT (the alpha_matmul forward within
# its looser 1e-4) and the worst within LOOSE (depth 0.2); gradients divided
# by the oracle's largest magnitude, 5e-4 at the 99.5% quantile, 0.05 worst
ORACLE_FRAC, ORACLE_TIGHT, ORACLE_TIGHT_MM = 0.995, 2e-5, 1e-4
ORACLE_LOOSE, ORACLE_GRAD_TIGHT, ORACLE_GRAD_LOOSE = 0.02, 5e-4, 0.05


def oracle_hold(name, got, ref, tight, loose, lead):
    """Hold ``got`` against the oracle's ``ref`` at the robust bars; returns
    (99.5% quantile, worst, share of the pixels or Gaussians (the first
    ``lead`` dims) with a value past ``tight``) and raises past a bar."""
    d = (got - ref).abs().flatten(0, lead - 1).reshape(
        int(np.prod(got.shape[:lead])), -1).cpu().numpy()
    q, worst = float(np.quantile(d, ORACLE_FRAC)), float(d.max())
    share = float((d.max(axis=1) > tight).mean())
    if not (q < tight and worst < loose):
        raise AssertionError(f"{name}: q{ORACLE_FRAC} {q} (bar {tight}), "
                             f"worst {worst} (bar {loose})")
    return q, worst, share


def phase_parity(dev):
    """The CUDA route in both modes against the per-pixel oracle on the
    card, at the parity CLI's scene with F = 8 and 128. The parity CLI is
    started first as a subprocess and returned running: its ~8 s of process
    start and its own oracle run beside these holds and the train CLI
    (finish_parity_cli reads its report)."""
    import torch
    from feature3dgs_tpu_torch.cli import parity_check as pc
    from feature3dgs_tpu_torch.ops import cuda_raster
    counts = lambda: (cuda_raster.FORWARD_LAUNCHES,
                      cuda_raster.FORWARD_MM_LAUNCHES,
                      cuda_raster.BACKWARD_LAUNCHES,
                      cuda_raster.BACKWARD_MM_LAUNCHES)
    cli = subprocess.Popen(
        [sys.executable, "-m", "feature3dgs_tpu_torch.cli.parity_check"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for f_dim in (pc.F_DIM, F_DIM):
            scene = pc.parity_scene(f_dim, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            oracle, g_oracle = pc.run_oracle(scene)
            torch.cuda.synchronize()
            oracle_s = time.perf_counter() - t0
            for mm in (False, True):
                tag = f"parity F={f_dim} alpha_matmul={mm}"
                before = counts()
                out, grads = pc.run_route(scene, "cuda", alpha_matmul=mm)
                torch.cuda.synchronize()
                launched = [a - b for a, b in zip(counts(), before)]
                if launched != ([0, 1, 0, 1] if mm else [1, 0, 1, 0]):
                    raise AssertionError(f"{tag}: kernel launches {launched}")
                fields = {}
                tight = ORACLE_TIGHT_MM if mm else ORACLE_TIGHT
                for k in ("color", "feature", "depth", "alpha"):
                    fields[k] = oracle_hold(
                        f"{tag} {k}", out[k], oracle[k], tight,
                        0.2 if k == "depth" else ORACLE_LOOSE, 2)
                for gname, x, y in zip(pc.GRAD_NAMES, grads, g_oracle):
                    s = max(float(y.abs().max()), 1e-12)
                    fields[gname] = oracle_hold(
                        f"{tag} {gname}", x / s, y / s, ORACLE_GRAD_TIGHT,
                        ORACLE_GRAD_LOOSE, 1)
                say("parity", F=f_dim, alpha_matmul=mm, size=f"{pc.WIDTH}x"
                    f"{pc.HEIGHT}", gaussians=pc.N_GAUSS,
                    oracle_s=f"{oracle_s:.2f}",
                    worst=json.dumps({k: v[1] for k, v in fields.items()}),
                    q995=json.dumps({k: v[0] for k, v in fields.items()}),
                    share_past_tight=json.dumps(
                        {k: v[2] for k, v in fields.items()}))
            del scene, oracle, g_oracle, out, grads
    except BaseException:
        stop_process(cli)
        raise
    return cli


def stop_process(proc):
    """Kill ``proc`` if it still runs and reap it."""
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def finish_parity_cli(cli):
    """Wait for the parity CLI: exit 0, a cuda-vs-plain and a
    plain-vs-oracle line, all_pass on gpu."""
    try:
        cli_out, cli_err = cli.communicate(timeout=300)
    finally:
        stop_process(cli)
    lines = [json.loads(ln) for ln in cli_out.splitlines()
             if ln.startswith("{")]
    if (cli.returncode != 0 or not lines
            or lines[-1] != {"backend": "cuda", "platform": "gpu",
                             "all_pass": True}
            or [ln["compare"] for ln in lines[:-1]] != [
                "cuda-vs-plain", "plain-vs-oracle"]):
        raise AssertionError(f"parity_check CLI exited {cli.returncode}:\n"
                             f"{cli_out[-3000:]}\n{cli_err[-3000:]}")
    for ln in lines[:-1]:
        say("parity_cli", **{k: v for k, v in ln.items()})


SETUP_POINTS, SETUP_TRACK = 1_000_000, 4


def phase_setup():
    """Scene setup's host helpers at 1 M points: a points3D.bin written
    from one numpy structured array (tracks of 4 entries) read back through
    the port's reader (the native scanner) bit for bit; the native 3-NN
    against cKDTree at tests/test_data.py's rtol 1e-5 / atol 1e-7."""
    from scipy.spatial import cKDTree

    from feature3dgs_tpu_torch.data.colmap import read_points3d_binary
    from feature3dgs_tpu_torch.ops.knn import mean_sq_dist_3nn
    n = SETUP_POINTS
    rng = np.random.RandomState(0)
    rec = np.zeros(n, dtype=[
        ("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
        ("error", "<f8"), ("track_len", "<u8"),
        ("track", "<i4", (2 * SETUP_TRACK,))])
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"] = rng.uniform(-2.0, 2.0, (n, 3))
    rec["rgb"] = rng.randint(0, 256, (n, 3))
    rec["error"] = rng.rand(n)
    rec["track_len"] = SETUP_TRACK
    rec["track"] = rng.randint(0, 1000, (n, 2 * SETUP_TRACK))
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "points3D.bin")
    with open(path, "wb") as f:
        f.write(np.uint64(n).astype("<u8").tobytes())
        f.write(rec.tobytes())
    try:
        t0 = time.perf_counter()
        xyz, rgb, err = read_points3d_binary(path)
        read_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    finally:
        os.remove(path)
    for name, got in (("xyz", xyz), ("rgb", rgb), ("error", err)):
        if got.tobytes() != np.ascontiguousarray(rec[name]).tobytes():
            raise AssertionError(f"setup: {name} read back differs")
    pts = xyz.astype(np.float32)
    t0 = time.perf_counter()
    got = mean_sq_dist_3nn(pts)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, _ = cKDTree(pts).query(pts, k=4, workers=-1)
    want = (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
    tree_s = time.perf_counter() - t0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                               err_msg="setup: native 3-NN vs cKDTree")
    say("setup", points=n, track_len=SETUP_TRACK, file_bytes=size,
        read_s=f"{read_s:.3f}", fields="bit-equal",
        knn_native_s=f"{native_s:.3f}", knn_native_threads=1,
        knn_ckdtree_s=f"{tree_s:.3f}", knn_ckdtree_workers=os.cpu_count(),
        knn_max_abs_err=float(np.abs(got - want).max()))


def write_profile(out_dir, name, fn) -> float:
    """Profile fn() into DIR/name; returns the device-busy ms it recorded
    (the sum of every op's own device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(table)
    return device_busy_ms(prof)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="",
                    help="directory for profiler tables of the served views "
                    "(one by one and batched) and two training steps")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run alone (for finding "
                    "faults; prints no kernels or ok line)")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    want = lambda phase: not only or phase in only

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.native import loader as native
    from feature3dgs_tpu_torch.ops import (cuda_preprocess, cuda_raster,
                                           kernel_lib)
    dev = default_device()

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:        # g++ beside the nvcc builds
        native_built = pool.submit(native.build)
        libraries = kernel_lib.build()
        native_lib = native_built.result()
    ptxas, entry = [], ""
    for ln in kernel_lib.BUILD_LOG.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln or "spill" in ln:
            ptxas.append(f"{entry}: {ln.strip()}")
    say("build", seconds=f"{time.time() - t0:.1f}", ptxas=json.dumps(ptxas),
        native=os.path.relpath(native_lib, ROOT),
        libraries=json.dumps(sorted(p.name for p in libraries.values())))
    p_main = 32 * 16
    for name in ("raster_forward", "raster_backward"):
        for mm in (False, True):
            # (an older checkout, whose kernels --only kernel_loop can time
            # from its root, has no launch plans to report)
            if hasattr(cuda_raster, "kernel_attributes"):
                say("build_kernel", name=name, alpha_matmul=mm,
                    pixels=p_main, F=F_DIM,
                    **cuda_raster.kernel_attributes(name, p_main, F_DIM, mm))
    import shutil
    say("build_tools", ncu="installed, not run: its hardware counters need "
        "privileges this check does not assume" if shutil.which("ncu")
        else "not installed")

    if want("kernel_small"):
        phase_kernel_small(dev)
    params, state, gt_image, gt_feature = bench_scene(dev)
    if want("kernel_full"):
        full = phase_kernel_full(dev, params, state)
    if want("serve"):
        serve_launches = phase_serve(dev, params, state, args.profile)
    if want("serve_batch"):
        batch_launches, at_batch = phase_serve_batch(dev, params, state,
                                                     args.profile)
    if want("kernel_bwd_small"):
        phase_kernel_bwd_small(dev)
    if want("kernel_bwd_full"):
        bwd, segment_row = phase_kernel_bwd_full(dev, params, state,
                                                 gt_image, gt_feature)
    at_batch4 = None
    if want("kernel_bwd_slice"):
        at_batch4 = phase_kernel_bwd_slice(dev, params, state, gt_image,
                                           gt_feature)
    viewer_launches = 0
    if want("viewer"):
        viewer_launches = phase_viewer(dev, params, state)
    if want("encoders"):
        phase_encoders(dev, params, state)
    if want("kernel_alpha_small"):
        phase_kernel_alpha_small(dev)
    if want("kernel_alpha_full"):
        full_mm, bwd_mm = phase_kernel_alpha_full(dev, params, state,
                                                  gt_image, gt_feature)
    del params, state, gt_image, gt_feature
    if want("kernel_wide"):
        wide = phase_kernel_wide(dev)
    if want("adam"):
        adam_row = phase_adam(dev)
    if want("preprocess"):
        prep_rows = phase_preprocess(dev)
    if want("resize"):
        resize_rows = phase_resize(dev)
    if want("setup"):
        phase_setup()
    if want("train"):
        train_fwd, train_bwd = phase_train(dev, args.profile)
    if want("bench_clis"):
        clis_fwd, clis_bwd = phase_bench_clis()
    if want("micro"):
        micro_fwd = phase_micro()
    if (want("kernel_loop") or want("train_loop") or want("train_batch")
            or want("train_shard")):
        t0 = time.perf_counter()
        scene = loop_scene()
        scene_s = time.perf_counter() - t0
    if want("train_batch"):
        batch_launches_train = phase_train_batch(dev, scene, at_batch4,
                                                 args.profile)
    if want("train_shard"):
        shard_launches = phase_train_shard(dev, scene)
    if want("kernel_loop"):
        at_loop = phase_kernel_loop(dev, scene)
    if want("train_loop"):
        (loop, loop_mm, loop_adam, loop_prep, loop_resize,
         loop_segment) = phase_train_loop(dev, scene, scene_s)
    parity_cli = phase_parity(dev) if want("parity") else None
    try:
        if want("train_cli") or want("serve_cli"):
            import shutil
            work = os.path.join(ROOT, "build", "smoke", "cli")
            out, scene = phase_train_cli(work)
            if parity_cli is not None:
                finish_parity_cli(parity_cli)
            if want("serve_cli"):
                phase_serve_cli(work, out, scene)
            shutil.rmtree(work, ignore_errors=True)
        elif parity_cli is not None:
            finish_parity_cli(parity_cli)
    finally:
        if parity_cli is not None:
            stop_process(parity_cli)

    print(card_line())
    if only:
        return 0
    src = "feature3dgs_tpu_torch/ops/csrc/"
    tpu = "feature3dgs_tpu/ops/pallas_raster.py:"
    print(json.dumps({"kernels": [
        dict(name="raster_forward", route="cuda",
             source=src + "raster_forward.cu", replaces=tpu + "192",
             launches=serve_launches + batch_launches[0] + train_fwd
             + loop[0] + batch_launches_train[0] + shard_launches[0]
             + viewer_launches + clis_fwd + micro_fwd, **full,
             library_ms=None,
             **at_loop[("fwd", False)], **at_batch[False],
             **wide[("fwd", False)]),
        dict(name="raster_backward", route="cuda",
             source=src + "raster_backward.cu", replaces=tpu + "495",
             launches=train_bwd + loop[1] + batch_launches_train[1]
             + shard_launches[1] + clis_bwd, **bwd,
             library_ms=None, **at_loop[("bwd", False)],
             **at_batch4[False], **wide[("bwd", False)]),
        dict(name="raster_forward_alpha_mm", route="cuda",
             source=src + "raster_forward.cu", replaces=tpu + "302",
             launches=batch_launches[1] + loop_mm[0], **full_mm,
             library_ms=None, **at_loop[("fwd", True)], **at_batch[True],
             **wide[("fwd", True)]),
        dict(name="raster_backward_alpha_mm", route="cuda",
             source=src + "raster_backward.cu", replaces=tpu + "671",
             launches=loop_mm[1], **bwd_mm, library_ms=None,
             **at_loop[("bwd", True)], **at_batch4[True],
             **wide[("bwd", True)]),
        dict(name="adam", route="cuda", source=src + "adam.cu",
             replaces=None, launches=loop_adam, **adam_row),
        dict(name="preprocess_forward", route="cuda",
             source=src + "preprocess.cu", replaces=None,
             launches=loop_prep[0], **prep_rows[0]),
        dict(name="preprocess_backward", route="cuda",
             source=src + "preprocess.cu", replaces=None,
             launches=loop_prep[1], **prep_rows[1]),
        dict(name="resize_forward", route="cuda", source=src + "resize.cu",
             replaces=None, launches=loop_resize[0], **resize_rows[0]),
        dict(name="resize_backward", route="cuda", source=src + "resize.cu",
             replaces=None, launches=loop_resize[1], **resize_rows[1]),
        dict(name="segment_sum", route="cuda", source=src + "segment.cu",
             replaces=tpu + "_cp_bwd (jax.ops.segment_sum)",
             launches=loop_segment, **segment_row)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
