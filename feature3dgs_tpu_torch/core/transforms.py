"""Camera matrix construction (numpy; used at data-loading time).

A copy of ``feature3dgs_tpu/core/transforms.py``, kept here so the port
imports nothing of the JAX package. Matrices multiply COLUMN vectors
(``p_view = V @ p``), as in the JAX package; the original Feature-3DGS code
(utils/graphics_utils.py) stores them transposed.
"""
from __future__ import annotations

import math

import numpy as np


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix.

    Args mirror the reference ``getWorld2View2``
    (utils/graphics_utils.py:38-49 of the original code): ``R`` is the
    camera-to-world rotation (COLMAP qvec convention after transpose at load
    time) and ``t`` the world-to-camera translation. ``translate``/``scale``
    re-center/re-scale the camera positions (NeRF++ normalization).
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    center = (c2w[:3, 3] + (0.0 if translate is None else translate)) * scale
    c2w[:3, 3] = center
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, the original getProjectionMatrix
    (utils/graphics_utils.py:51-71). NDC z in [0, 1] after
    w-division; w row copies view z."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov_to_focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def camera_center_from_view(view: np.ndarray) -> np.ndarray:
    """Camera position in world space = inverse(view)[:3, 3]."""
    return np.linalg.inv(view)[:3, 3]
