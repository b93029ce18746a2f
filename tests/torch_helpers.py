"""Shared inputs for the PyTorch-port parity tests: one numpy-seeded scene
or camera, handed to both the JAX package and the port."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch.convert import camera_from_numpy
from tests.utils import make_camera, random_gaussians

CPU = torch.device("cpu")


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (float64 becomes float32)."""
    a = np.array(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def cameras(width=64, height=48, **kw):
    """(JAX CameraView, port CameraView) of the same camera."""
    jcam = make_camera(width=width, height=height, **kw)
    pcam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.proj),
                             np.asarray(jcam.campos), np.asarray(jcam.tan_fovx),
                             np.asarray(jcam.tan_fovy), width, height, CPU)
    return jcam, pcam


def scene(n=200, f_dim=4, seed=0, boost=None, max_sh_degree=2):
    """random_gaussians as numpy, with opacities optionally boosted as in
    tests/test_pallas.py (more pixels reach the T floor)."""
    g = {k: np.array(v) for k, v in random_gaussians(
        n=n, f_dim=f_dim, seed=seed, max_sh_degree=max_sh_degree).items()}
    if boost:
        g["opacities"] = np.minimum(g["opacities"] * boost, 0.999
                                    ).astype(np.float32)
    return g


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's torch work. The suite runs six
    workers on a few cores: torch's multi-threaded small ops then wait on
    each other's descheduled threads and a test that takes seconds alone
    takes minutes. Use with ``pytestmark = pytest.mark.usefixtures(
    "one_torch_thread")`` and import the fixture into the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
