"""Host-side camera records and the resolution policy.

A numpy copy of ``feature3dgs_tpu/data/cameras.py`` (the original
scene/cameras.py:17-73 and utils/camera_utils.py:19-63): each camera
carries its GT image, the teacher semantic feature map and view/projection
data. Images are HWC float32 numpy on the host; ``to_view(device)`` makes
the port's CameraView of tensors.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from feature3dgs_tpu_torch.convert import camera_from_numpy
from feature3dgs_tpu_torch.core import transforms
from feature3dgs_tpu_torch.core.projection import CameraView


@dataclasses.dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray            # camera-to-world rotation (COLMAP transposed qvec)
    T: np.ndarray            # world-to-camera translation
    fovx: float
    fovy: float
    image: np.ndarray | None           # [H,W,3] float32 in [0,1] (mask applied)
    image_name: str
    semantic_feature: np.ndarray | None  # [h,w,C] teacher map (HWC), float32
    # or float16 when fp16 on disk (load_feature_map; steps upcast to f32)
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    scale: float = 1.0
    # False = pixel/feature loads deliberately skipped (host-local loading:
    # this camera belongs to another process's stripe)
    pixels_loaded: bool = True

    @property
    def view(self) -> np.ndarray:
        return transforms.world_to_view(self.R, self.T, self.trans, self.scale)

    @property
    def full_proj(self) -> np.ndarray:
        return transforms.projection_matrix(
            self.znear, self.zfar, self.fovx, self.fovy) @ self.view

    @property
    def camera_center(self) -> np.ndarray:
        return transforms.camera_center_from_view(self.view)

    def to_view(self, device=None) -> CameraView:
        """This camera as the port's CameraView on ``default_device(device)``."""
        return camera_from_numpy(
            self.view, self.full_proj, self.camera_center.astype(np.float32),
            math.tan(self.fovx * 0.5), math.tan(self.fovy * 0.5),
            self.width, self.height, device)

    def to_json(self) -> dict:
        """cameras.json entry (utils/camera_utils.py:75-95)."""
        rt = np.zeros((4, 4))
        rt[:3, :3] = self.R.T
        rt[:3, 3] = self.T
        rt[3, 3] = 1.0
        c2w = np.linalg.inv(rt)
        return {
            "id": self.uid,
            "img_name": self.image_name,
            "width": self.width,
            "height": self.height,
            "position": c2w[:3, 3].tolist(),
            "rotation": [row.tolist() for row in c2w[:3, :3]],
            "fy": transforms.fov_to_focal(self.fovy, self.height),
            "fx": transforms.fov_to_focal(self.fovx, self.width),
        }


def choose_resolution(orig_w: int, orig_h: int, resolution: int,
                      resolution_scale: float = 1.0,
                      feature_hw: tuple[int, int] | None = None):
    """The reference's -r policy (utils/camera_utils.py:19-48):
    1/2/4/8 = downsample factor; 0 = feature-map resolution; -2 = 480x320;
    -1 = auto (cap width at 1600); other positives = target width."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == 0:
        if feature_hw is None:
            raise ValueError("-r 0 needs a feature map to take the size from")
        return feature_hw[1], feature_hw[0]
    if resolution == -2:
        return 480, 320
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    s = float(global_down) * float(resolution_scale)
    return int(orig_w / s), int(orig_h / s)


def load_image(path: str, resolution: tuple[int, int] | None = None):
    """PIL load -> float [0,1] HWC; returns (rgb [H,W,3], alpha or None)."""
    from PIL import Image
    img = Image.open(path)
    if resolution is not None and (img.size != resolution):
        img = img.resize(resolution)
    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if arr.shape[-1] == 4:
        return arr[..., :3], arr[..., 3:]
    return arr[..., :3], None
