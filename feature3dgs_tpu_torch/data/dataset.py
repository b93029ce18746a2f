"""Scene loading: COLMAP & Blender datasets + teacher feature maps.

A numpy copy of ``feature3dgs_tpu/data/dataset.py`` (the original
scene/__init__.py:25-93 and scene/dataset_readers.py:148-302):
  * auto-detects COLMAP (``sparse/``) vs Blender (``transforms_train.json``);
  * loads per-view teacher feature maps ``<image>_fmap_CxHxW.pt`` from
    ``sam_embeddings/`` (SAM) or ``rgb_feature_langseg/`` (LSeg)
    (dataset_readers.py:110-112, 162-165) — .npy/.npz sidecars are also
    accepted so the pipeline runs without torch;
  * eval split: test views are ``idx % 8 == 2`` over name-sorted cameras
    (:175-176);
  * NeRF++ normalization radius = 1.1 * max camera-center distance from the
    mean center (:51-72); used as the spatial LR scale and densify extent;
  * Blender scenes without a point cloud start from 100k random points in
    [-1.3, 1.3]^3 (:274-285).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

from feature3dgs_tpu_torch.core import transforms
from feature3dgs_tpu_torch.data import colmap as colmap_lib
from feature3dgs_tpu_torch.data.cameras import Camera, choose_resolution, load_image
from feature3dgs_tpu_torch.data.ply import read_ply, write_ply

FEATURE_DIRS = {"sam": "sam_embeddings", "lseg": "rgb_feature_langseg"}


def load_feature_map(path_base: str) -> np.ndarray | None:
    """Load ``<base>_fmap_CxHxW.pt`` (torch CHW tensor) or .npy/.npz sidecar;
    returns HWC float32 — or float16 when the map is fp16 on disk (the
    reference saves teacher/rendered maps half precision, render.py:179-180,
    encode_images.py:478-481). Preserving fp16 halves the GT device cache
    and the loss-path HBM reads; it is EXACT, not an approximation: the
    train steps upcast to f32 before any arithmetic, which reproduces
    torch's fp16->f32 type promotion in the reference's l1_loss
    (train.py:105) bit for bit."""
    for ext, loader in ((".pt", _load_pt), (".npy", np.load), (".npz", _load_npz)):
        p = path_base + "_fmap_CxHxW" + ext
        if os.path.exists(p):
            arr = np.asarray(loader(p))
            if arr.dtype != np.float16:
                arr = arr.astype(np.float32)
            if arr.ndim != 3:
                raise ValueError(f"{p}: expected CHW feature map, got {arr.shape}")
            return np.ascontiguousarray(arr.transpose(1, 2, 0))  # CHW -> HWC
    return None


def _load_pt(path):
    import torch
    t = torch.load(path, map_location="cpu", weights_only=False).detach()
    if t.dtype != torch.float16:  # bf16 etc. -> f32 (numpy has no bf16)
        t = t.float()
    return t.numpy()


def _load_npz(path):
    with np.load(path) as z:
        return z[z.files[0]]


def nerfpp_norm(cameras: list[Camera]) -> dict:
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    avg = centers.mean(axis=0)
    diag = float(np.max(np.linalg.norm(centers - avg, axis=1)))
    return {"translate": -avg, "radius": diag * 1.1}


@dataclasses.dataclass
class SceneData:
    train_cameras: list[Camera]
    test_cameras: list[Camera]
    points: np.ndarray       # [N,3]
    colors: np.ndarray       # [N,3] in [0,1]
    nerf_norm: dict
    feature_dim: int
    source_path: str


def _split_eval(cams: list[Camera], eval_split: bool, llffhold: int = 8):
    if not eval_split:
        return cams, []
    train = [c for i, c in enumerate(cams) if i % llffhold != 2]
    test = [c for i, c in enumerate(cams) if i % llffhold == 2]
    return train, test


def load_colmap_scene(path: str, *, foundation_model: str | None = None,
                      images_dir: str = "images", resolution: int = -1,
                      resolution_scale: float = 1.0, eval_split: bool = False,
                      load_images: bool = True,
                      pixel_filter=None) -> SceneData:
    """``pixel_filter(split, index_within_split, n_split) -> bool`` gates
    the EXPENSIVE per-camera loads (image pixels + teacher feature map,
    100-200 MB/view at LSeg scale) while geometry/metadata always loads for
    every camera. Multi-host training passes a stripe filter so each
    process only reads its own cameras' files from disk
    (parallel/distributed.local_camera_indices). Skipped cameras have
    ``pixels_loaded=False`` and image/semantic_feature None."""
    cams_intr, imgs, pts = colmap_lib.read_model(os.path.join(path, "sparse/0"))
    feat_dir = (os.path.join(path, FEATURE_DIRS[foundation_model])
                if foundation_model else None)

    cam_list: list[Camera] = []
    srcs = {}
    for img in imgs.values():
        intr = cams_intr[img.camera_id]
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx = fy = intr.params[0]
        elif intr.model in ("PINHOLE", "OPENCV"):
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"COLMAP camera model not handled: {intr.model} (only "
                "undistorted PINHOLE-family supported, dataset_readers.py:101)")
        fovy = transforms.focal_to_fov(fy, intr.height)
        fovx = transforms.focal_to_fov(fx, intr.width)
        name = os.path.splitext(os.path.basename(img.name))[0]
        cam = Camera(
            uid=len(cam_list), colmap_id=img.id,
            R=colmap_lib.qvec_to_rotmat(img.qvec).T, T=np.array(img.tvec),
            fovx=fovx, fovy=fovy, image=None, image_name=name,
            semantic_feature=None, width=intr.width,
            height=intr.height)
        srcs[name] = (os.path.basename(img.name), intr.width, intr.height)
        cam_list.append(cam)

    cam_list.sort(key=lambda c: c.image_name)
    for i, c in enumerate(cam_list):
        c.uid = i
    train, test = _split_eval(cam_list, eval_split)

    # Pixel/feature loads AFTER the name-sort + eval split so pixel_filter
    # addresses cameras by their final (split, index) identity.
    for split, cams in (("train", train), ("test", test)):
        for i, cam in enumerate(cams):
            fname, ow, oh = srcs[cam.image_name]
            wanted = (load_images if pixel_filter is None
                      else load_images and pixel_filter(split, i, len(cams)))
            feature = None
            if feat_dir is not None and wanted:
                feature = load_feature_map(
                    os.path.join(feat_dir, cam.image_name))
            if resolution == 0 and not wanted:
                raise ValueError(
                    "-r 0 (feature-map resolution) needs every camera's "
                    "feature map on every process; it cannot be combined "
                    "with host-local pixel loading")
            feature_hw = feature.shape[:2] if feature is not None else None
            w, h = (choose_resolution(ow, oh, resolution, resolution_scale,
                                      feature_hw)
                    if load_images else (ow, oh))
            cam.width, cam.height = w, h
            cam.semantic_feature = feature
            cam.pixels_loaded = bool(wanted)
            if wanted:
                rgb, alpha = load_image(
                    os.path.join(path, images_dir, fname), (w, h))
                if alpha is not None:
                    rgb = rgb * alpha
                cam.image = rgb

    if pts is not None:
        xyz, rgb_u8 = pts[0].astype(np.float32), pts[1]
        colors = rgb_u8.astype(np.float32) / 255.0
    else:
        ply_path = os.path.join(path, "sparse/0/points3D.ply")
        cols = read_ply(ply_path)
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], 1).astype(np.float32)
        colors = np.stack([cols["red"], cols["green"], cols["blue"]], 1
                          ).astype(np.float32) / 255.0

    feat_dim = next((c.semantic_feature.shape[-1] for c in train
                     if c.semantic_feature is not None), 0)
    return SceneData(train_cameras=train, test_cameras=test, points=xyz,
                     colors=colors, nerf_norm=nerfpp_norm(train or cam_list),
                     feature_dim=feat_dim, source_path=path)


def load_blender_scene(path: str, *, foundation_model: str | None = None,
                       white_background: bool = False, eval_split: bool = False,
                       extension: str = ".png", resolution: int = -1,
                       resolution_scale: float = 1.0,
                       rng: np.random.RandomState | None = None) -> SceneData:
    feat_dir = (os.path.join(path, FEATURE_DIRS[foundation_model])
                if foundation_model else None)

    def read_transforms(fname):
        cams = []
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            return cams
        with open(fpath) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            c2w = np.array(frame["transform_matrix"], np.float64)
            c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes (dataset_readers.py:222)
            w2c = np.linalg.inv(c2w)
            R, T = w2c[:3, :3].T, w2c[:3, 3]
            img_path = os.path.join(path, frame["file_path"] + extension)
            rgb, alpha = load_image(img_path)
            bg = np.ones(3, np.float32) if white_background else np.zeros(3, np.float32)
            if alpha is not None:
                rgb = rgb * alpha + bg * (1 - alpha)
            h, w = rgb.shape[:2]
            fovy = transforms.focal_to_fov(transforms.fov_to_focal(fovx, w), h)
            name = os.path.splitext(os.path.basename(img_path))[0]
            feature = (load_feature_map(os.path.join(feat_dir, name))
                       if feat_dir else None)
            cams.append(Camera(uid=idx, colmap_id=idx, R=R, T=T, fovx=fovx,
                               fovy=fovy, image=rgb, image_name=name,
                               semantic_feature=feature, width=w, height=h))
        return cams

    train = read_transforms("transforms_train.json")
    test = read_transforms("transforms_test.json")
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        cols = read_ply(ply_path)
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], 1).astype(np.float32)
        colors = np.stack([cols["red"], cols["green"], cols["blue"]], 1
                          ).astype(np.float32) / 255.0
    else:
        rng = rng or np.random.RandomState(0)
        n = 100_000
        xyz = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
        from feature3dgs_tpu_torch.core.sh import sh_dc_to_rgb
        colors = np.asarray(sh_dc_to_rgb(rng.random((n, 3)) / 255.0), np.float32)
        write_ply(ply_path, {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
            "nz": np.zeros(n, np.float32),
            "red": (colors[:, 0] * 255).astype(np.uint8),
            "green": (colors[:, 1] * 255).astype(np.uint8),
            "blue": (colors[:, 2] * 255).astype(np.uint8)})

    feat_dim = (train[0].semantic_feature.shape[-1]
                if train and train[0].semantic_feature is not None else 0)
    return SceneData(train_cameras=train, test_cameras=test, points=xyz,
                     colors=colors, nerf_norm=nerfpp_norm(train),
                     feature_dim=feat_dim, source_path=path)


def load_scene(path: str, allow_missing_features: bool = False,
               **kw) -> SceneData:
    """Auto-detect scene type (scene/__init__.py:38-46).

    When a foundation model is requested, every train camera must have a
    teacher feature map on disk — the reference fails loudly there
    (dataset_readers.py:110-112 raises on a missing .pt) and so do we:
    silently zero-filling a missing map would train the semantic field of
    those views toward zero. ``allow_missing_features=True`` restores the
    zero-fill escape hatch for deliberately partial datasets."""
    if os.path.exists(os.path.join(path, "sparse")):
        kw.pop("white_background", None)
        scene = load_colmap_scene(path, **kw)
    elif os.path.exists(os.path.join(path, "transforms_train.json")):
        kw.pop("images_dir", None)
        if kw.pop("pixel_filter", None) is not None:
            raise NotImplementedError(
                "host-local pixel loading (pixel_filter) is COLMAP-only; "
                "Blender scenes are small synthetic sets")
        scene = load_blender_scene(path, **kw)
    else:
        raise ValueError(f"Could not recognize scene type for {path}")
    if kw.get("foundation_model") and not allow_missing_features:
        missing = [c.image_name for c in scene.train_cameras
                   if c.semantic_feature is None and c.pixels_loaded]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} train cameras have no "
                f"'{FEATURE_DIRS[kw['foundation_model']]}' feature map "
                f"(first: {missing[0]}); run the encoder export first, or "
                "pass --allow_missing_features to train those views' "
                "features toward zero (reference raises too, "
                "dataset_readers.py:110-112)")
    return scene
