"""Novel-view camera paths: an LLFF-style spiral and pose interpolation.

A numpy copy of ``feature3dgs_tpu/render/paths.py`` (the original
utils/pose_utils.py:25-56 render_path_spiral and render.py:236-317
render_novel_views), on the port's ``data.cameras.Camera``. Matrices are
COLMAP-convention world-to-camera 4x4.
"""
from __future__ import annotations

import numpy as np

from feature3dgs_tpu_torch.data.cameras import Camera


def _normalize(v):
    return v / np.linalg.norm(v)


def _look_at(z, up, pos):
    """Camera-to-world basis [3,4] from forward z, an up hint and position."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def camera_c2w(cam: Camera) -> np.ndarray:
    """Camera -> OpenGL-convention c2w (y up, z back), as the original pose
    preparation (pose_utils.py:27-32)."""
    w2c = np.eye(4)
    w2c[:3, :3] = cam.R.T
    w2c[:3, 3] = cam.T
    c2w = np.linalg.inv(w2c)
    c2w[:, 1:3] *= -1
    return c2w


def spiral_path(cameras: list[Camera], focal: float = 30.0, zrate: float = 0.5,
                rots: int = 2, n_frames: int = 120) -> list[np.ndarray]:
    """World-to-camera matrices along a spiral around the average pose
    (pose_utils.py:25-56)."""
    poses = np.stack([camera_c2w(c) for c in cameras], axis=0)
    center = poses[:, :3, 3].mean(0)
    fwd = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    c2w_avg = _look_at(fwd, up, center)
    up_n = _normalize(up)

    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0)
    rads = np.append(rads, 1.0)

    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n_frames + 1)[:-1]:
        c = c2w_avg @ (np.array([np.cos(theta), -np.sin(theta),
                                 -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w_avg @ np.array([0, 0, -focal, 1.0]))
        pose = np.eye(4)
        pose[:3] = _look_at(z, up_n, c)
        pose[:3, 1:3] *= -1  # back to the COLMAP convention
        out.append(np.linalg.inv(pose))
    return out


def interpolate_poses(cam_a: Camera, cam_b: Camera, n_frames: int = 30
                      ) -> list[np.ndarray]:
    """Linear blend of R and T between two cameras, R re-orthonormalised by
    SVD (render.py:236-317). Returns w2c 4x4 matrices."""
    out = []
    for t in np.linspace(0.0, 1.0, n_frames):
        rot = (1 - t) * cam_a.R + t * cam_b.R
        u, _, vt = np.linalg.svd(rot)
        rot = u @ vt
        trans = (1 - t) * cam_a.T + t * cam_b.T
        w2c = np.eye(4)
        w2c[:3, :3] = rot.T
        w2c[:3, 3] = trans
        out.append(w2c)
    return out


def camera_from_w2c(w2c: np.ndarray, like: Camera, uid: int = 0) -> Camera:
    """A render-only Camera at a w2c matrix, with ``like``'s intrinsics."""
    return Camera(
        uid=uid, colmap_id=uid, R=w2c[:3, :3].T, T=w2c[:3, 3],
        fovx=like.fovx, fovy=like.fovy, image=None,
        image_name=f"novel_{uid:05d}", semantic_feature=None,
        width=like.width, height=like.height)
