"""COLMAP sparse-reconstruction parsers (binary + text), numpy-native.

A copy of ``feature3dgs_tpu/data/colmap.py``, points3D.bin read by the
native scanner (``native/loader.py``), the JAX package's first route.
Covers the same inputs as the original scene/colmap_loader.py
(cameras.bin/images.bin/points3D.bin and their .txt forms), parsing with
numpy buffer slicing. Format definitions follow the public COLMAP
file-format spec.
"""
from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

from feature3dgs_tpu_torch.native import loader as native

# COLMAP camera models: model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w,x,y,z) quaternion to rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams: dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, width, height = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODELS[model_id]
            params = np.frombuffer(f.read(8 * n_params), dtype="<f8")
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height),
                                        params.copy())
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    imgs: dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    (n,) = struct.unpack_from("<Q", data, off); off += 8
    for _ in range(n):
        img_id = struct.unpack_from("<i", data, off)[0]; off += 4
        qt = np.frombuffer(data, dtype="<f8", count=7, offset=off); off += 56
        cam_id = struct.unpack_from("<i", data, off)[0]; off += 4
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8"); off = end + 1
        (n_pts,) = struct.unpack_from("<Q", data, off); off += 8
        off += n_pts * 24  # skip 2D points (x f8, y f8, point3D_id i8)
        imgs[img_id] = ColmapImage(img_id, qt[:4].copy(), qt[4:].copy(),
                                   cam_id, name)
    return imgs


def read_points3d_binary(path: str):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N] f64).

    The records have variable length (track lists): the native scanner of
    ``native/src/f3dgs_native.cc`` walks them in one pass and raises on a
    truncated file.
    """
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    return native.colmap_scan_points3d(data, n)


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams: dict[int, ColmapCamera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    imgs: dict[int, ColmapImage] = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.strip().startswith("#")]
    # alternating: image line, points2D line
    for ln in lines[::2]:
        parts = ln.split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        imgs[img_id] = ColmapImage(img_id, qvec, tvec, int(parts[8]), parts[9])
    return imgs


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append([float(p) for p in parts[1:4]])
            rgb.append([int(p) for p in parts[4:7]])
            err.append(float(parts[7]))
    return (np.array(xyz, np.float64), np.array(rgb, np.uint8),
            np.array(err, np.float64))


def read_model(sparse_dir: str):
    """Load (cameras, images, points) from a COLMAP sparse dir, preferring
    binary (readColmapSceneInfo behavior, dataset_readers.py:148-158)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    pts_bin = os.path.join(sparse_dir, "points3D.bin")
    pts_txt = os.path.join(sparse_dir, "points3D.txt")
    if os.path.exists(pts_bin):
        pts = read_points3d_binary(pts_bin)
    elif os.path.exists(pts_txt):
        pts = read_points3d_text(pts_txt)
    else:
        pts = None
    return cams, imgs, pts


def write_dummy_model(sparse_dir: str, cams, imgs, xyz, rgb):
    """Write a minimal binary model (testing + convert tooling)."""
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams:
            model_id = CAMERA_MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, model_id, c.width, c.height))
            f.write(np.asarray(c.params, "<f8").tobytes())
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs:
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(np.concatenate([im.qvec, im.tvec]), "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<Q", i))
            f.write(np.asarray(xyz[i], "<f8").tobytes())
            f.write(np.asarray(rgb[i], np.uint8).tobytes())
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))
