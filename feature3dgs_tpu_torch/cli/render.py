"""Render CLI: train/test views of a trained model, with PyTorch and CUDA.

    python -m feature3dgs_tpu_torch.cli.render -m <model_path> --iteration N

The port of ``scripts/render.py``'s train/test path with the same artifact
tree under ``<model_path>/{train,test}/ours_<N>/``: ``renders``, ``gt``,
``depth`` (jet), ``feature_map`` and ``gt_feature_map`` (PCA), and
``saved_feature/<idx>_fmap_CxHxW.npy`` + ``.pt`` (fp16 CHW). Runs on the
CUDA card (``--device cpu`` for the plain versions). ``--novel_view``,
``--video``, ``--edit_config`` and ``--render_batch > 1`` are not ported yet
and are refused.
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


def _refuse_unported(args):
    unported = [flag for flag, on in (
        ("--novel_view", args.novel_view), ("--video", args.video),
        ("--multi_interpolate", args.multi_interpolate),
        ("--edit_config", args.edit_config != "no editing"),
        ("--text_features", bool(args.text_features)),
        ("--render_batch > 1", args.render_batch > 1)) if on]
    if unported:
        raise SystemExit(
            f"not ported to feature3dgs_tpu_torch yet: {', '.join(unported)} "
            "(use scripts/render.py, the JAX package, for these)")


def main(argv=None):
    parser = ArgumentParser(description="Render train/test views (PyTorch)")
    from feature3dgs_tpu_torch import config as C
    C.add_model_args(parser)
    C.add_pipeline_args(parser)
    C.add_raster_args(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    # flags of scripts/render.py that this slice refuses
    parser.add_argument("--novel_view", action="store_true")
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--multi_interpolate", action="store_true")
    parser.add_argument("--num_views", default=200, type=int)
    parser.add_argument("--render_batch", default=1, type=int)
    parser.add_argument("--edit_config", default="no editing", type=str)
    parser.add_argument("--text_features", default="", type=str)
    args = C.combine_with_saved(parser, argv)
    _refuse_unported(args)

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.data.dataset import load_scene
    from feature3dgs_tpu_torch.model.decoder import apply_decoder
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    from feature3dgs_tpu_torch.render import renderer
    from feature3dgs_tpu_torch.render.modes import colormap, feature_pca_vis
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

    def render_set(name, cameras):
        base = os.path.join(mcfg.model_path, name, f"ours_{iteration}")
        dirs = {d: os.path.join(base, d) for d in
                ("renders", "gt", "depth", "feature_map", "gt_feature_map",
                 "saved_feature")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        for idx, cam in enumerate(cameras):
            out = renderer.render(params, state, cam.to_view(device), bg=bg,
                                  config=rcfg)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
