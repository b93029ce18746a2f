"""SIBR-remote-viewer-compatible TCP server.

Port of ``feature3dgs_tpu/viewer/network_gui.py``: the wire protocol of the
original network_gui (gaussian_renderer/network_gui.py:27-98), so the
upstream SIBR_remoteGaussian_app connects to a training or viewing process
of the port unmodified:

  server -> client on connect : u32 length + JSON list of render-mode names
  client -> server per frame  : u32 length + JSON camera message
      {resolution_x/y, train, fov_y, fov_x, z_near, z_far, keep_alive,
       scaling_modifier, view_matrix (16 floats), view_projection_matrix,
       render_mode}
  server -> client per frame  : raw H*W*3 bytes + u32 length + source-path
                                string + u32 length + metrics JSON

The client sends torch-style row-vector matrices (the transpose of the
math-convention view matrix) with the original's y/z axis flips (:86-89).
``ViewerCamera.to_view`` makes the port's CameraView on the render device;
``send`` takes the frame as a tensor on the card (one copy of its uint8
bytes to the host) or as numpy.
"""
from __future__ import annotations

import json
import math
import select
import socket
import struct
from dataclasses import dataclass

import numpy as np
import torch

from feature3dgs_tpu_torch.convert import camera_from_numpy
from feature3dgs_tpu_torch.core.projection import CameraView
from feature3dgs_tpu_torch.render.modes import (RENDER_ITEMS, net_image,
                                                to_uint8)


@dataclass
class ViewerCamera:
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    view: np.ndarray       # [4,4] math convention (column vectors)
    proj_full: np.ndarray  # [4,4] = P @ V
    do_training: bool
    keep_alive: bool
    scaling_modifier: float
    render_mode: int

    def to_view(self, device=None) -> CameraView:
        """This camera as a CameraView on ``default_device(device)``."""
        return camera_from_numpy(
            self.view, self.proj_full,
            np.linalg.inv(self.view)[:3, 3].astype(np.float32),
            math.tan(self.fovx * 0.5), math.tan(self.fovy * 0.5),
            self.width, self.height, device)


def camera_from_message(msg: dict) -> ViewerCamera | None:
    """The camera of a client message; None for a 0 x 0 keep-alive."""
    width, height = msg["resolution_x"], msg["resolution_y"]
    if width == 0 or height == 0:
        return None
    # the client's row-vector (transposed) matrices: columns 1 and 2
    # flipped as in the original (network_gui.py:85-89), then transposed to
    # the math convention
    wvt = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    wvt[:, 1] = -wvt[:, 1]
    wvt[:, 2] = -wvt[:, 2]
    vpt = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    vpt[:, 1] = -vpt[:, 1]
    return ViewerCamera(
        width=width, height=height,
        fovx=msg["fov_x"], fovy=msg["fov_y"],
        znear=msg["z_near"], zfar=msg["z_far"],
        view=wvt.T, proj_full=vpt.T,
        do_training=bool(msg["train"]),
        keep_alive=bool(msg["keep_alive"]),
        scaling_modifier=msg["scaling_modifier"],
        render_mode=msg["render_mode"])


def render_frame(render_fn, cam: ViewerCamera, device=None) -> torch.Tensor:
    """The uint8 [H,W,3] frame of ``cam``'s render mode on the device:
    ``render_fn(view, scaling_modifier)`` returns a RasterOutput (or any
    object with color, feature and depth) of that CameraView."""
    view = cam.to_view(device)
    out = render_fn(view, cam.scaling_modifier)
    pkg = {"color": out.color, "feature": out.feature, "depth": out.depth}
    return to_uint8(net_image(pkg, RENDER_ITEMS, cam.render_mode, view.proj))


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def _send_json(self, data):
        payload = json.dumps(data).encode("utf-8")
        self.conn.sendall(struct.pack("I", len(payload)))
        self.conn.sendall(payload)

    def try_connect(self, render_items, wait: float = 0.0) -> bool:
        """Accept a waiting client, waiting up to ``wait`` seconds for one
        (not at all by default), and send it the render modes; True while a
        client is connected."""
        if self.conn is not None:
            return True
        try:
            if wait > 0:
                select.select([self.listener], [], [], wait)
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            self._send_json(render_items)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self) -> ViewerCamera | None:
        length = int.from_bytes(self._read_exact(4), "little")
        return camera_from_message(
            json.loads(self._read_exact(length).decode("utf-8")))

    def send(self, image, source_path: str, metrics: dict):
        """image: [H,W,3] in [0,1] or uint8, a tensor (its uint8 bytes are
        made on its device and copied once) or numpy; sent as raw RGB."""
        if image is not None:
            if isinstance(image, torch.Tensor):
                if image.dtype != torch.uint8:
                    image = to_uint8(image)
                img = image.cpu().numpy()
            else:
                img = np.asarray(image)
                if img.dtype != np.uint8:
                    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            self.conn.sendall(img.tobytes())
        self.conn.sendall(len(source_path).to_bytes(4, "little"))
        self.conn.sendall(source_path.encode("ascii"))
        self._send_json(metrics)

    def disconnect(self):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self):
        """Drop the client and stop listening."""
        self.disconnect()
        self.listener.close()
