"""Mean squared distance to the 3 nearest neighbours, for the initial
Gaussian scales.

Port of ``feature3dgs_tpu/ops/knn.py:mean_sq_dist_3nn`` (the original
simple-knn ``distCUDA2``, which averages SQUARED distances). It runs once
per scene on the host, so it is no kernel. One route by size, no fallback
chain: brute force for up to four points, the JAX package's first route
otherwise, the native grid search of ``native/src/f3dgs_native.cc``; a
failed build of the native library raises.
"""
from __future__ import annotations

import numpy as np

from feature3dgs_tpu_torch.native import loader as native


def _brute(points: np.ndarray) -> np.ndarray:
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k = min(3, points.shape[0] - 1)
    if k <= 0:
        return np.full((points.shape[0],), 1e-6, np.float32)
    return np.sort(d2, axis=1)[:, :k].mean(axis=1).astype(np.float32)


def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """[N,3] -> [N] mean squared distance to each point's 3 nearest
    neighbours."""
    points = np.asarray(points, np.float32)
    if points.shape[0] <= 4:
        return _brute(points)
    return native.knn_mean_sq_dist(points)
