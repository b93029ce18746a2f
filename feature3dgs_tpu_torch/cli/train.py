"""Training CLI: train a scene with PyTorch and CUDA.

    python -m feature3dgs_tpu_torch.cli.train -s <scene> -m <out> -f lseg \\
        [--speedup] [--alpha_matmul]

The port of ``scripts/train.py``'s single-device path with the same flags
and the same output folder: ``cfg_args``, ``cameras.json``,
``train_log.jsonl``, ``point_cloud/iteration_N/point_cloud.ply`` (plus
``decoder_chkpnt{N}.ckpt`` under ``--speedup``) at ``--save_iterations``,
saved before that iteration's densify / opacity reset, and ``chkpnt{N}.ckpt``
at ``--checkpoint_iterations``, saved after it. ``--start_checkpoint`` resumes
from such a file (either package's). Steps between sync points
(``--sync_every``) read nothing from the device. The first SIGTERM or SIGINT
finishes the step in flight, writes a full checkpoint and exits; a second
one ends the process at once. ``--profile DIR`` writes a ``torch.profiler``
table and trace of iterations 20-30 (``train_profile.txt``,
``train_trace.json``) and, beside them, ``train_spans.json``: the summary of
the program's own spans and counters over the same iterations
(``feature3dgs_tpu_torch/tracing.py``).

Runs on the CUDA card (``--device cpu`` for the plain versions of the
kernels). ``--cameras_per_step B`` trains B cameras a step (one sort, one
forward and one backward launch for the B views; ``--mesh 1x1`` implied);
``--mesh DxT`` spreads the batch over D data rows and each image's tile
grid over T ranks of a torchrun launch, one process a card:

    torchrun --nproc_per_node 4 -m feature3dgs_tpu_torch.cli.train \
        -s <scene> -m <out> -f lseg --mesh 2x2 --cameras_per_step 4

D * T must equal torchrun's world size; rank 0 alone writes the output
folder, logs and checkpoints. ``--shard_gaussians`` (with a mesh) keeps
1/(D * T) of the Gaussian rows, their Adam moments and densification
statistics on each rank; ``--shard_instances`` (with it) runs the tile-owner
instance exchange. ``--distributed`` trains over several hosts:

    torchrun --nnodes H --nproc_per_node C ... -m \
        feature3dgs_tpu_torch.cli.train -s <colmap scene> -m <out> -f lseg \
        --distributed [--shard_gaussians [--shard_instances]]

puts the H hosts on the data axis and each host's C cards on the tile axis
(``MultiHostTrainer``), and each rank loads the pixels and teacher maps of
its host's camera stripe only (the test split on rank 0 only). Every rank
joins the gather of a row-sharded state before rank 0 writes it, so the
checkpoints and PLY files are those of a replicated run.

Unless ``--disable_viewer`` is given, rank 0 listens for the SIBR remote
viewer on ``--ip``/``--port`` (``viewer/network_gui.py``) and serves it at
sync iterations only, after the host has read that step's metrics, so
steps between them still read nothing from the device; a client that asks
not to train holds the loop there, frame after frame, as in the original.
The viewer is off under ``--distributed`` (as in ``scripts/train.py``) and
when ``--shard_gaussians`` spreads the rows over several ranks (rank 0
alone holds no whole model). TensorBoard scalars (losses, iteration time,
points; test and train L1 / PSNR and the opacity histogram at
``--test_iterations``) go to the output folder where
``torch.utils.tensorboard`` imports.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import sys
import threading
import time
import uuid
from argparse import ArgumentParser

import torch
import torch.distributed as dist


def build_parser() -> ArgumentParser:
    from feature3dgs_tpu_torch import config as C
    parser = ArgumentParser(description="Training script parameters (PyTorch)")
    C.add_model_args(parser)
    C.add_optimization_args(parser)
    C.add_pipeline_args(parser)
    C.add_raster_args(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--sync_every", type=int, default=10,
                        help="period of the host's metric reads (and log "
                             "lines); steps in between read nothing from the "
                             "device")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler table and chrome trace "
                             "of iterations 20-30 into DIR, and the program's "
                             "spans and counters as train_spans.json")
    parser.add_argument("--disable_viewer", action="store_true",
                        help="do not serve the SIBR remote viewer")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--gt_cache_mb", type=int, default=0,
                        help="device-memory budget (MB) for cached images "
                             "and teacher feature maps; 0 keeps every view. "
                             "Evicted views are uploaded again on their next "
                             "epoch.")
    parser.add_argument("--allow_missing_features", action="store_true",
                        help="train cameras without a teacher feature map "
                             "get zeros instead of an error")
    parser.add_argument("--mesh", type=str, default=None, metavar="DxT",
                        help="training mesh 'data x tile', e.g. '2x2': "
                             "cameras batch over the data axis, each image's "
                             "tile grid shards over the tile axis; data * "
                             "tile must equal torchrun's world size")
    parser.add_argument("--cameras_per_step", type=int, default=None,
                        help="B cameras a step, each counted as one "
                             "iteration (the loss is their mean); a multiple "
                             "of the mesh's data axis. Implies --mesh 1x1 "
                             "when no mesh is given.")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host training under torchrun: hosts on "
                             "the data axis, each host's cards on the tile "
                             "axis, each host loading its own camera stripe")
    parser.add_argument("--shard_gaussians", action="store_true",
                        help="row-shard the Gaussians, their Adam moments "
                             "and densification statistics over all ranks "
                             "(needs --mesh or --distributed)")
    parser.add_argument("--shard_instances", action="store_true",
                        help="route (tile, depth, id) instances to their "
                             "tile-owner ranks with one all_to_all a camera "
                             "position; needs --shard_gaussians")
    return parser


@contextlib.contextmanager
def _graceful_stop(stop: dict):
    """First SIGTERM / SIGINT: note it (the loop checkpoints and exits after
    the step in flight). Second: KeyboardInterrupt."""
    def request(signum, frame):
        if stop["sig"] is not None:
            raise KeyboardInterrupt(f"second signal {signum}")
        stop["sig"] = signum
        print(f"\n[preempt] signal {signum}: will checkpoint and exit after "
              "the current step", flush=True)

    # handlers can only be set from the main thread
    main = threading.current_thread() is threading.main_thread()
    prev = {s: signal.signal(s, request)
            for s in (signal.SIGTERM, signal.SIGINT)} if main else {}
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def _mesh_shape(args):
    """(data, tile) of --mesh / --cameras_per_step, or None for the
    single-camera Trainer. Exits naming the world size the mesh needs when
    torchrun's WORLD_SIZE (1 without torchrun) differs."""
    if not (args.mesh or args.cameras_per_step):
        if args.shard_instances:
            raise ValueError("--shard_instances needs --shard_gaussians "
                             "and a device mesh (--mesh DxT)")
        if args.shard_gaussians:
            raise ValueError("--shard_gaussians needs a device mesh: pass "
                             "--mesh DxT (e.g. --mesh 1x8)")
        return None
    try:
        n_data, n_tile = (int(x) for x in
                          (args.mesh or "1x1").lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh takes DxT, e.g. 2x2; got {args.mesh!r}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n_data * n_tile != world:
        raise SystemExit(
            f"--mesh {n_data}x{n_tile} needs a world size of "
            f"{n_data * n_tile} (torchrun --nproc_per_node "
            f"{n_data * n_tile} -m feature3dgs_tpu_torch.cli.train ...); "
            f"this run has a world size of {world}")
    return n_data, n_tile


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # --distributed under torchrun with several processes: the host x card
    # mesh covers the world, whatever --mesh says
    multihost = args.distributed and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1
    shape = None if multihost else _mesh_shape(args)
    args.save_iterations.append(args.iterations)

    from feature3dgs_tpu_torch import config as C
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.data.dataset import load_scene
    from feature3dgs_tpu_torch.train import checkpoints as ckpt
    from feature3dgs_tpu_torch.train.trainer import Trainer

    device = default_device(args.device)
    mesh = pixel_filter = None
    if shape is not None or multihost:
        from feature3dgs_tpu_torch.parallel import distributed as dist_lib
        from feature3dgs_tpu_torch.parallel import make_mesh
        dist_lib.initialize(device)
        mesh = (dist_lib.make_host_chip_mesh() if multihost
                else make_mesh(shape))
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    is_main = n_proc == 1 or dist.get_rank() == 0
    mcfg = C.extract_model(args)
    ocfg = C.extract_optimization(args)
    rcfg = C.extract_raster(args)

    if not mcfg.model_path:
        if n_proc > 1:
            raise SystemExit("a multi-process run needs an explicit -m/"
                             "--model_path (a random one per process would "
                             "scatter the output)")
        mcfg.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    log = print if is_main else (lambda *a, **k: None)
    if is_main:
        os.makedirs(mcfg.model_path, exist_ok=True)
    log(f"Output folder: {mcfg.model_path}")

    if multihost:
        # each host reads its own camera stripe's pixels and teacher maps
        # from disk (they never cross hosts); the test split loads on the
        # rank that evaluates it
        def pixel_filter(split, i, n):
            if split == "train":
                return i in dist_lib.stripe_indices(n, mesh.data_index,
                                                    mesh.shape["data"])
            return is_main

    scene = load_scene(
        mcfg.source_path, foundation_model=mcfg.foundation_model or None,
        images_dir=mcfg.images, resolution=mcfg.resolution,
        eval_split=mcfg.eval, white_background=mcfg.white_background,
        allow_missing_features=args.allow_missing_features,
        pixel_filter=pixel_filter)
    log(f"Loaded scene: {len(scene.train_cameras)} train / "
        f"{len(scene.test_cameras)} test cameras, "
        f"{scene.points.shape[0]} points, feature dim {scene.feature_dim}")
    if is_main:
        ckpt.save_cfg_args(mcfg.model_path, {
            **vars(args), "source_path": mcfg.source_path,
            "model_path": mcfg.model_path})
        ckpt.save_cameras_json(mcfg.model_path, scene.train_cameras)

    tkw = dict(ocfg=ocfg, rcfg=rcfg, max_sh_degree=mcfg.sh_degree,
               speedup=mcfg.speedup, white_background=mcfg.white_background,
               seed=args.seed,
               gt_cache_bytes=args.gt_cache_mb * (1 << 20) or None,
               device=device)
    shard = dict(shard_gaussians=args.shard_gaussians,
                 shard_instances=args.shard_instances)
    if multihost:
        from feature3dgs_tpu_torch.parallel.multihost import MultiHostTrainer
        trainer = MultiHostTrainer(scene, mesh=mesh,
                                   cameras_per_step=args.cameras_per_step,
                                   **shard, **tkw)
        log(f"Multi-host training: {mesh.shape['data']} hosts x "
            f"{mesh.shape['tile']} cards, {trainer.batch} cameras/step "
            "(host-striped)")
    elif mesh is not None:
        from feature3dgs_tpu_torch.parallel.trainer import DistributedTrainer
        trainer = DistributedTrainer(scene, mesh=mesh,
                                     cameras_per_step=args.cameras_per_step,
                                     **shard, **tkw)
        log(f"Mesh training: data={shape[0]} x tile={shape[1]} over "
            f"{n_proc} processes, {trainer.batch} cameras/step")
    else:
        trainer = Trainer(scene, **tkw)
    if args.start_checkpoint:
        ts, it = ckpt.load_checkpoint(args.start_checkpoint, device=device)
        trainer.restore_state(ts)
        trainer.iteration = it
        log(f"Restored checkpoint at iteration {it}")

    gui = _open_viewer(args, multihost, n_proc) if is_main else None
    # TensorBoard, as the original's training_report (train.py:203-239)
    tb = None
    if is_main:
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb = SummaryWriter(mcfg.model_path)
        except Exception as e:
            print(f"tensorboard logging disabled ({e})")

    stop = {"sig": None}
    ema_loss = 0.0
    t_start = t_sync = time.time()
    last_sync_it = last_logged_it = 0
    prof = None
    bsz = getattr(trainer, "batch", 1)
    stop_now = False
    log_path = (os.path.join(mcfg.model_path, "train_log.jsonl") if is_main
                else os.devnull)
    with _graceful_stop(stop), open(log_path, "a") as logf:
        while trainer.iteration < ocfg.iterations:
            if args.profile and prof is None and trainer.iteration >= 20:
                prof = _start_profile()
            # a step counts as the iterations of its span; sync only where
            # the host reads metrics: every sync_every iterations and at
            # report, save and checkpoint points inside the span
            span = range(trainer.iteration + 1, trainer.iteration + bsz + 1)
            it = span[-1]
            sync = (it % args.sync_every < bsz or it >= ocfg.iterations
                    or any(i in args.test_iterations
                           or i in args.save_iterations
                           or i in args.checkpoint_iterations for i in span)
                    or bool(args.profile and it >= 20))
            metrics = trainer.step(sync=sync)
            stop_now = stop["sig"] is not None
            if n_proc > 1:
                # the ranks stop together, at a sync point (every rank
                # reaches the same ones), or the others would wait in the
                # next step's collectives
                stop_now = sync and _agree(stop_now, device)
            if stop_now:
                # after densification, like a scheduled checkpoint; every
                # rank joins the gather of a row-sharded state
                trainer.flush_maintenance()
                state = trainer.full_state()
                if is_main:
                    ckpt.save_checkpoint(mcfg.model_path, trainer.iteration,
                                         state)
                log(f"[preempt] checkpoint saved at iteration "
                    f"{trainer.iteration}; resume with --start_checkpoint",
                    flush=True)
                break
            if prof is not None and it >= 30:
                _stop_profile(prof, args.profile, device)
                prof, args.profile = None, None
            if not sync:
                continue
            # a discarded non-finite step still reports loss = NaN: keep it
            # out of the moving average
            if metrics.get("finite", 1.0):
                ema_loss = (0.4 * metrics["loss"] + 0.6 * ema_loss if it > 1
                            else metrics["loss"])
            ms_it = (time.time() - t_sync) * 1000 / max(it - last_sync_it, 1)
            t_sync, last_sync_it = time.time(), it
            if not args.quiet:
                log(f"[{it}/{ocfg.iterations}] loss={ema_loss:.5f} "
                    f"psnr={metrics['psnr']:.2f} "
                    f"pts={int(metrics['num_active'])} ({ms_it:.0f} ms/it)")
            if tb is not None:
                tb.add_scalar("train_loss_patches/l1_loss",
                              metrics.get("l1", 0.0), it)
                tb.add_scalar("train_loss_patches/l1_feature_loss",
                              metrics.get("l1_feature", 0.0), it)
                tb.add_scalar("train_loss_patches/total_loss",
                              metrics["loss"], it)
                tb.add_scalar("iter_time", ms_it, it)
                tb.add_scalar("total_points", int(metrics["num_active"]), it)
            # the log rides the existing sync points, about every 50
            # iterations
            if it - last_logged_it >= 50 or it >= ocfg.iterations:
                logf.write(json.dumps({"iteration": it, **metrics,
                                       "elapsed_s": time.time() - t_start})
                           + "\n")
                logf.flush()
                last_logged_it = it

            # rank 0 evaluates and writes the whole state, which every rank
            # joins gathering when the rows are sharded
            report = any(i in args.test_iterations for i in span)
            save = any(i in args.save_iterations for i in span)
            state = trainer.full_state() if report or save else None
            if is_main and report:
                _report(trainer, state, scene, it, tb)
            if is_main and save:
                print(f"\n[ITER {it}] Saving Gaussians")
                ckpt.save_scene_ply(mcfg.model_path, it, state.params,
                                    state.gstate)
                if mcfg.speedup and state.decoder is not None:
                    ckpt.save_decoder_checkpoint(mcfg.model_path, it,
                                                 state.decoder)
            if any(i in args.checkpoint_iterations for i in span):
                # full checkpoints come after the iteration's densification
                # in the original (train.py:151-153 follow :129-140); the
                # PLY above comes before it (:121-126). Every rank flushes
                # (its state stays the others') and joins the gather, rank
                # 0 writes
                trainer.flush_maintenance()
                state = trainer.full_state()
                if is_main:
                    print(f"\n[ITER {it}] Saving Checkpoint")
                    ckpt.save_checkpoint(mcfg.model_path, it, state)
            if gui is not None:
                _serve_gui(gui, trainer, scene, ema_loss)

    if gui is not None:
        gui.close()
    if tb is not None:
        tb.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    if stop_now:
        return 0
    log("\nTraining complete.")
    return 0


def _open_viewer(args, multihost: bool, n_proc: int):
    """The SIBR viewer's listener, or None (off, or the port is taken)."""
    if args.disable_viewer:
        return None
    if multihost or (args.shard_gaussians and n_proc > 1):
        print("viewer disabled (the Gaussians are not whole on one rank)")
        return None
    from feature3dgs_tpu_torch.viewer.network_gui import NetworkGUI
    try:
        return NetworkGUI(args.ip, args.port)
    except OSError as e:
        print(f"viewer disabled ({e})")
        return None


@torch.no_grad()
def _serve_gui(gui, trainer, scene, ema_loss: float):
    """At a sync iteration: accept a waiting viewer, then answer its camera
    messages until one asks to train (the original train.py:155-177). A
    dropped client is disconnected and training goes on."""
    from feature3dgs_tpu_torch.render import renderer
    from feature3dgs_tpu_torch.render.modes import RENDER_ITEMS
    from feature3dgs_tpu_torch.viewer.network_gui import render_frame
    if gui.conn is None:
        gui.try_connect(list(RENDER_ITEMS))
    ts = trainer.ts

    def render_fn(view, scaling_modifier):
        return renderer.render(ts.params, ts.gstate, view, bg=trainer.bg,
                               config=trainer.rcfg,
                               scaling_modifier=scaling_modifier)

    while gui.conn is not None:
        try:
            cam = gui.receive()
            frame = (render_frame(render_fn, cam, trainer.device)
                     if cam is not None else None)
            gui.send(frame, scene.source_path,
                     {"#": ts.gstate.num_active, "loss": ema_loss})
            if cam is None or cam.do_training:
                break
        except Exception:
            gui.disconnect()


def _agree(flag: bool, device) -> bool:
    """Whether any rank's ``flag`` is set (one all-reduce)."""
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _start_profile():
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profile(prof, out_dir: str, device):
    from feature3dgs_tpu_torch import tracing
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(out_dir, exist_ok=True)
    sort_by = ("cuda_time_total" if device.type == "cuda"
               else "cpu_time_total")
    with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=40))
    prof.export_chrome_trace(os.path.join(out_dir, "train_trace.json"))
    session = tracing.last_session()
    if session is not None:
        with open(os.path.join(out_dir, "train_spans.json"), "w") as f:
            json.dump(session.summary(), f, indent=1)
    print(f"profiler trace (~iterations 20-30) -> {out_dir}")


@torch.no_grad()
def _report(trainer, state, scene, iteration: int, tb=None):
    """The original training_report (train.py:203-239): L1 and PSNR of the
    whole ``state`` on the test cameras and on 5 fixed train cameras whose
    pixels this process holds, to stdout and TensorBoard, with the opacity
    histogram and the point count."""
    from feature3dgs_tpu_torch.render import renderer
    from feature3dgs_tpu_torch.train import losses as L
    params, gstate = state.params, state.gstate
    train_loaded = [c for c in scene.train_cameras if c.image is not None]
    configs = [("test", [c for c in scene.test_cameras
                         if c.image is not None]),
               ("train", [train_loaded[i % len(train_loaded)]
                          for i in range(5, 30, 5)] if train_loaded else [])]
    for name, cams in configs:
        if not cams:
            continue
        totals = torch.zeros(2, device=trainer.device)
        for cam in cams:
            out = renderer.render(params, gstate, cam.to_view(trainer.device),
                                  bg=trainer.bg, config=trainer.rcfg)
            img = torch.clamp(out.color, 0, 1)
            gt = torch.clamp(torch.as_tensor(
                cam.image, dtype=torch.float32, device=trainer.device), 0, 1)
            totals += torch.stack([L.l1_loss(img, gt), L.psnr(img, gt)])
        l1, psnr = (totals / len(cams)).tolist()
        print(f"\n[ITER {iteration}] Evaluating {name}: "
              f"L1 {l1:.5f} PSNR {psnr:.2f}")
        if tb is not None:
            tb.add_scalar(f"{name}/loss_viewpoint - l1_loss", l1, iteration)
            tb.add_scalar(f"{name}/loss_viewpoint - psnr", psnr, iteration)
    if tb is not None:
        op = torch.sigmoid(params.opacity[:, 0])[gstate.alive]
        tb.add_histogram("scene/opacity_histogram", op.cpu().numpy(),
                         iteration)
        tb.add_scalar("total_points", gstate.num_active, iteration)


if __name__ == "__main__":
    sys.exit(main())
