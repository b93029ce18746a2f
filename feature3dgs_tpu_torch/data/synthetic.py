"""Small synthetic scenes for tests and smoke checks.

``synthetic_scene`` (in memory, no files) is a copy of
``feature3dgs_tpu/data/synthetic.py``: the same numpy draws in the same
order, so both packages build the same scene from one seed.
``write_blender_scene`` writes a Blender-style scene folder that
``load_scene`` and the CLIs read. ``make_camera`` and ``random_gaussians``
copy the test scenes of ``tests/utils.py`` (numpy draws in the same order),
which ``cli/parity_check.py`` renders as ``scripts/parity_check.py`` does.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from feature3dgs_tpu_torch.data.cameras import Camera
from feature3dgs_tpu_torch.data.dataset import SceneData


def synthetic_scene(n_cams=6, w=64, h=48, n_pts=256, f_dim=8, seed=0
                    ) -> SceneData:
    """Cameras fanned around the origin looking at a random point cloud,
    with random ground-truth images and half-resolution feature maps."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.5, 1.5, (n_pts, 3)).astype(np.float32)
    cols = rng.rand(n_pts, 3).astype(np.float32)
    cams = []
    for i in range(n_cams):
        ang = 0.15 * (i - n_cams / 2)
        rot = np.array([[math.cos(ang), 0, math.sin(ang)],
                        [0, 1, 0],
                        [-math.sin(ang), 0, math.cos(ang)]], np.float32)
        cams.append(Camera(
            uid=i, colmap_id=i, R=rot, T=np.array([0.0, 0.0, 4.0], np.float32),
            fovx=1.0, fovy=0.8,
            image=rng.rand(h, w, 3).astype(np.float32),
            image_name=f"synth_{i}",
            semantic_feature=rng.randn(h // 2, w // 2, f_dim).astype(
                np.float32) * 0.1,
            width=w, height=h))
    return SceneData(train_cameras=cams, test_cameras=[], points=pts,
                     colors=cols, nerf_norm={"radius": 4.0},
                     feature_dim=f_dim, source_path="<synthetic>")


def make_camera(width=64, height=48, fovx=1.0, fovy=0.8, cam_z=-4.0,
                device=None):
    """Camera at (0,0,cam_z) looking down +z at the origin, on
    ``default_device(device)``."""
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import transforms
    view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, -cam_z]))
    proj = transforms.projection_matrix(0.01, 100.0, fovx, fovy) @ view
    return camera_from_numpy(view, proj,
                             transforms.camera_center_from_view(view),
                             np.tan(fovx / 2), np.tan(fovy / 2), width, height,
                             device)


def random_gaussians(n=200, f_dim=8, seed=0, spread=1.5, scale_lo=-3.5,
                     scale_hi=-1.5, max_sh_degree=2) -> dict[str, np.ndarray]:
    """Random Gaussians as float32 numpy arrays by name (means3d, scales,
    rotations, opacities, shs [n, (max_sh_degree+1)^2, 3], feat)."""
    rng = np.random.RandomState(seed)
    m = (max_sh_degree + 1) ** 2
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return {
        "means3d": rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
        "scales": np.exp(rng.uniform(scale_lo, scale_hi, (n, 3))).astype(
            np.float32),
        "rotations": q.astype(np.float32),
        "opacities": rng.uniform(0.2, 0.95, (n,)).astype(np.float32),
        "shs": rng.randn(n, m, 3).astype(np.float32) * 0.3,
        "feat": rng.randn(n, f_dim).astype(np.float32),
    }


def write_blender_scene(path: str, *, n_frames: int = 4, size: int = 128,
                        f_dim: int = 16, n_pts: int = 2000, seed: int = 0,
                        feature_dir: str = "rgb_feature_langseg",
                        n_test: int = 0) -> str:
    """Write a Blender-style scene into ``path``: ``transforms_train.json``
    (cameras on a circle of radius 4 looking at the origin),
    ``train/r_i.png`` (a smooth colour pattern per frame), CHW float32
    teacher maps ``<feature_dir>/r_i_fmap_CxHxW.npy`` at half resolution
    and a ``points3d.ply`` of ``n_pts`` random points in [-1.3, 1.3]^3.
    ``n_test`` > 0 adds ``transforms_test.json`` with frames ``test/t_i``
    half-way between the train cameras (their teacher maps from seed + 1,
    so the train split does not depend on it). Returns ``path``."""
    from PIL import Image

    from feature3dgs_tpu_torch.data.ply import write_ply
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(path, feature_dir), exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size

    def write_split(split, prefix, n, offset, draw):
        os.makedirs(os.path.join(path, split), exist_ok=True)
        frames = []
        for i in range(n):
            ang = 2.0 * math.pi * (i + offset) / max(n_frames, 1)
            # OpenGL camera-to-world: the camera sits on the circle, its -z
            # axis points at the origin, +y is up
            eye = np.array([4.0 * math.sin(ang), 0.0, 4.0 * math.cos(ang)])
            z = eye / np.linalg.norm(eye)
            x = np.cross([0.0, 1.0, 0.0], z)
            x /= np.linalg.norm(x)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
                x, np.cross(z, x), z, eye)
            frames.append({"file_path": f"{split}/{prefix}_{i}",
                           "transform_matrix": c2w.tolist()})
            img = np.stack([0.5 + 0.5 * np.sin(6.0 * xx + i + offset),
                            0.5 + 0.5 * np.cos(5.0 * yy - i - offset),
                            xx * yy], -1)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(path, split, f"{prefix}_{i}.png"))
            np.save(os.path.join(path, feature_dir,
                                 f"{prefix}_{i}_fmap_CxHxW.npy"),
                    (draw.randn(f_dim, size // 2, size // 2) * 0.1).astype(
                        np.float32))
        with open(os.path.join(path, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)

    write_split("train", "r", n_frames, 0, rng)
    if n_test:
        write_split("test", "t", n_test, 0.5, np.random.RandomState(seed + 1))
    xyz = rng.uniform(-1.3, 1.3, (n_pts, 3)).astype(np.float32)
    rgb = (rng.rand(n_pts, 3) * 255).astype(np.uint8)
    zeros = np.zeros(n_pts, np.float32)
    write_ply(os.path.join(path, "points3d.ply"), {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": zeros, "ny": zeros, "nz": zeros,
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
    return path
