"""Render CLI: views of a trained model, with PyTorch and CUDA.

    python -m feature3dgs_tpu_torch.cli.render -m <model_path> --iteration N

The port of ``scripts/render.py``, with its flags and artifact tree under
``<model_path>/<set>/ours_<N>[_<op>_<target>]/``: ``renders``, ``gt``,
``depth`` (jet), ``feature_map`` and ``gt_feature_map`` (PCA), and
``saved_feature/<idx>_fmap_CxHxW.npy`` + ``.pt`` (fp16 CHW), for the
``train`` and ``test`` sets, ``novel_views`` (``--novel_view``: pose
interpolation, ``--multi_interpolate`` over three spans) and ``video``
(``--video``: a spiral), ``--num_views`` views each. ``--render_batch B``
renders runs of consecutive same-resolution views B at a time through
``renderer.render_batch`` (one binning sort and one forward-kernel launch a
batch); a short tail is padded by repeating its last view and the padded
outputs are dropped; a run of one view goes through ``renderer.render``.
``--edit_config`` (YAML, or JSON) applies a language-guided edit with text
embeddings from ``--text_features`` (.npy) or from local CLIP weights.
Runs on the CUDA card (``--device cpu`` for the plain versions).
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def save_png(path, arr):
    from PIL import Image
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def save_feature(path_base, fmap_hwc: torch.Tensor):
    """fp16 CHW feature (the original render.py:179-180): .npy and .pt."""
    chw = fmap_hwc.detach().permute(2, 0, 1).to(torch.float16).contiguous().cpu()
    np.save(path_base + "_fmap_CxHxW.npy", chw.numpy())
    torch.save(chw, path_base + "_fmap_CxHxW.pt")


def batch_runs(cameras, bsz: int):
    """[(start, cameras)] runs of at most ``bsz`` consecutive views of one
    resolution, in order (scripts/render.py:iter_outputs)."""
    runs, i = [], 0
    while i < len(cameras):
        res = (cameras[i].width, cameras[i].height)
        j = i + 1
        while (j < len(cameras) and j - i < bsz
               and (cameras[j].width, cameras[j].height) == res):
            j += 1
        runs.append((i, cameras[i:j]))
        i = j
    return runs


def main(argv=None):
    parser = ArgumentParser(description="Render views of a trained model "
                                        "(PyTorch)")
    from feature3dgs_tpu_torch import config as C
    C.add_model_args(parser)
    C.add_pipeline_args(parser)
    C.add_raster_args(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--novel_view", action="store_true")
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--multi_interpolate", action="store_true")
    parser.add_argument("--num_views", default=200, type=int)
    parser.add_argument("--render_batch", default=1, type=int,
                        help="views per batched render call (consecutive "
                             "same-resolution views; one kernel launch each)")
    parser.add_argument("--edit_config", default="no editing", type=str)
    parser.add_argument("--text_features", default="", type=str,
                        help=".npy of precomputed CLIP text embeddings for "
                             "--edit_config (used when CLIP weights absent)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = C.combine_with_saved(parser, argv)

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.data.dataset import load_scene
    from feature3dgs_tpu_torch.model.decoder import apply_decoder
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    from feature3dgs_tpu_torch.render import editing, renderer
    from feature3dgs_tpu_torch.render.modes import colormap, feature_pca_vis
    from feature3dgs_tpu_torch.render.paths import (camera_from_w2c,
                                                    interpolate_poses,
                                                    spiral_path)
    from feature3dgs_tpu_torch.train import checkpoints as ckpt
    from feature3dgs_tpu_torch.train import losses as L

    device = default_device(args.device)
    mcfg = C.extract_model(args)
    rcfg = C.extract_raster(args)

    iteration = args.iteration
    if iteration == -1:
        pc_dir = os.path.join(mcfg.model_path, "point_cloud")
        iteration = max(int(d.split("_")[-1]) for d in os.listdir(pc_dir))
    ply_path = os.path.join(mcfg.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
    params, state = load_gaussians_ply(ply_path, max_sh_degree=mcfg.sh_degree,
                                       device=device)
    print(f"Loaded {state.num_active} gaussians from {ply_path}")

    scene = load_scene(
        mcfg.source_path, foundation_model=mcfg.foundation_model or None,
        images_dir=mcfg.images, resolution=mcfg.resolution,
        eval_split=mcfg.eval, white_background=mcfg.white_background,
        # rendering reads the trained field, not teacher maps
        allow_missing_features=True)

    decoder = None
    if mcfg.speedup:
        dec_path = os.path.join(mcfg.model_path,
                                f"decoder_chkpnt{iteration}.ckpt")
        if not os.path.exists(dec_path):
            # a full training checkpoint of that iteration holds it too
            full = os.path.join(mcfg.model_path, f"chkpnt{iteration}.ckpt")
            if not os.path.exists(full):
                raise SystemExit(f"neither {dec_path} nor {full} found")
            dec_path = full
        decoder = ckpt.load_decoder_checkpoint(dec_path, device=device)
    bg = torch.tensor([1.0, 1.0, 1.0] if mcfg.white_background
                      else [0.0, 0.0, 0.0], device=device)

    p_render, op_override, edit_suffix = params, None, ""
    if args.edit_config != "no editing":
        edit, objects, target = editing.parse_edit_config(args.edit_config)
        if args.text_features:
            from feature3dgs_tpu_torch.tasks.clip_text import \
                load_text_features
            text = load_text_features(args.text_features)
        else:
            from feature3dgs_tpu_torch.tasks.clip_text import encode_text
            text = encode_text([o.replace("_", " ") for o in objects])
        p_render, op_override = editing.apply_edits(
            params, torch.from_numpy(text).to(device), edit)
        edit_suffix = f"_{next(iter(edit['operations']))}_{target}"

    def iter_outputs(cameras):
        """(idx, camera, output) per view, sequentially or in batches."""
        bsz = max(1, args.render_batch)
        max_inst = 0
        for start, run in batch_runs(cameras, bsz):
            if len(run) == 1:
                yield start, run[0], renderer.render(
                    p_render, state, run[0].to_view(device), bg=bg,
                    config=rcfg, override_opacity=op_override)
                continue
            views = [c.to_view(device) for c in run]
            views += [views[-1]] * (bsz - len(run))   # pad the tail
            out = renderer.render_batch(p_render, state, views, bg=bg,
                                        config=rcfg,
                                        override_opacity=op_override)
            for k, cam in enumerate(run):
                yield start + k, cam, type(out)(*(v[k] for v in out))
            max_inst = max(max_inst, int(out.total_instances.max()))
        cap = rcfg.instance_capacity_or_default
        if max_inst > cap:
            print(f"[warn] instance overflow in batched render: {max_inst} "
                  f"> capacity {cap}: the farthest splats were dropped; "
                  f"rerun with a larger --instance_capacity")

    def render_set(name, cameras):
        base = os.path.join(mcfg.model_path, name,
                            f"ours_{iteration}{edit_suffix}")
        dirs = {d: os.path.join(base, d) for d in
                ("renders", "gt", "depth", "feature_map", "gt_feature_map",
                 "saved_feature")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        for idx, cam, out in iter_outputs(cameras):
            stem = f"{idx:05d}"
            save_png(os.path.join(dirs["renders"], stem + ".png"),
                     out.color.cpu().numpy())
            if cam.image is not None:
                save_png(os.path.join(dirs["gt"], stem + ".png"), cam.image)
            save_png(os.path.join(dirs["depth"], stem + ".png"),
                     colormap(out.depth.cpu().numpy(), "jet"))
            fmap = out.feature
            if cam.semantic_feature is not None:
                h, w = cam.semantic_feature.shape[:2]
                fmap = L.resize_bilinear_align_corners(fmap, h, w)
                save_png(os.path.join(dirs["gt_feature_map"],
                                      stem + "_feature_vis.png"),
                         feature_pca_vis(cam.semantic_feature))
            if decoder is not None:
                fmap = apply_decoder(decoder, fmap)
            save_png(os.path.join(dirs["feature_map"],
                                  stem + "_feature_vis.png"),
                     feature_pca_vis(fmap.cpu().numpy()))
            save_feature(os.path.join(dirs["saved_feature"], stem), fmap)
        print(f"rendered {len(cameras)} views -> {base}")

    with torch.inference_mode():
        if not args.skip_train:
            render_set("train", scene.train_cameras)
        if not args.skip_test and scene.test_cameras:
            render_set("test", scene.test_cameras)
        cams = scene.train_cameras
        if args.novel_view:
            if args.multi_interpolate:
                n = len(cams)
                spans = [(0, n // 3), (n // 3, 2 * n // 3),
                         (2 * n // 3, n - 1)]
                w2cs = [m for a, b in spans for m in interpolate_poses(
                    cams[a], cams[b], args.num_views // len(spans))]
            else:
                w2cs = interpolate_poses(cams[0], cams[min(len(cams) - 1, 10)],
                                         args.num_views)
            render_set("novel_views", [camera_from_w2c(m, cams[0], i)
                                       for i, m in enumerate(w2cs)])
        if args.video:
            w2cs = spiral_path(cams, n_frames=args.num_views)
            render_set("video", [camera_from_w2c(m, cams[0], i)
                                 for i, m in enumerate(w2cs)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
