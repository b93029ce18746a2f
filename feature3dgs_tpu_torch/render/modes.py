"""Render-output visualizations used by the render CLI: the depth colormap
and the feature PCA (the original utils/image_utils.py and render.py:38-53).

Port of ``colormap`` and ``feature_pca_vis`` from
``feature3dgs_tpu/render/modes.py``, in numpy. The jet colormap is built
here from its segment table, as matplotlib builds it, so rendering needs no
matplotlib; the viewer modes (edges, normals, curvature) come with the
viewer slice.
"""
from __future__ import annotations

import numpy as np

# matplotlib's "jet" segment data: (x, y_left, y_right) per channel
_JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}


def _segment_lut(data, n: int = 256) -> np.ndarray:
    """Piecewise-linear lookup table of n entries over [0, 1]."""
    a = np.asarray(data, np.float64)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


_COLORMAPS = {
    "jet": np.stack([_segment_lut(_JET_SEGMENTS[c])
                     for c in ("red", "green", "blue")], axis=1),
}


def colormap(x, cmap: str = "jet") -> np.ndarray:
    """Min-max normalize, then map through a 256-entry colormap; returns
    HW3 float32 RGB."""
    if cmap not in _COLORMAPS:
        raise ValueError(f"colormap {cmap!r} not available: {sorted(_COLORMAPS)}")
    colors = _COLORMAPS[cmap]
    x = np.asarray(x).squeeze()
    x = (x - x.min()) / max(float(x.max() - x.min()), 1e-12)
    idx = np.clip(np.round(x * (len(colors) - 1)).astype(int), 0,
                  len(colors) - 1)
    return colors[idx].astype(np.float32)


def feature_pca_vis(feature, stride: int = 3) -> np.ndarray:
    """3-component PCA visualization of an HWC feature map: L2-normalize
    channels, PCA on every ``stride``-th pixel, 1/99-percentile contrast
    stretch."""
    f = np.asarray(feature, np.float64)
    h, w, c = f.shape
    flat = f.reshape(-1, c)
    norm = np.linalg.norm(flat, axis=1, keepdims=True)
    flat = flat / np.maximum(norm, 1e-12)
    samples = flat[::stride]
    mean = samples.mean(0)
    centered = samples - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    comps = vt[:3]
    transformed = centered @ comps.T
    q1, q99 = np.percentile(transformed, [1, 99])
    vis = (flat - mean) @ comps.T
    vis = (vis - q1) / max(q99 - q1, 1e-12)
    return np.clip(vis, 0.0, 1.0).reshape(h, w, 3).astype(np.float32)
