"""Per-Gaussian view-dependent preprocessing in PyTorch.

Port of ``feature3dgs_tpu/core/projection.py`` (the original
``preprocessCUDA``, forward.cu:156-256), with the same constants: near cull
at z <= 0.2, homogeneous epsilon +1e-7, the 1.3*tan_fov frustum clamp, the
+0.3 px low-pass on the cov2D diagonal and radius = ceil(3*sqrt(max
eigenvalue)) with the ``max(0.1, ...)`` discriminant guard.

The affine transforms are written elementwise in the JAX package's order
(not as ``@``), so that projected pixel means agree to the last bits and
``tile_rect`` floors do not flip at tile borders.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.core import sh as sh_lib


@dataclasses.dataclass
class CameraView:
    """One camera: ``view`` and ``proj`` act on column vectors and ``proj``
    is the FULL projection (P @ V). Tensors on the render device; width and
    height are plain ints."""

    view: torch.Tensor      # [4,4]
    proj: torch.Tensor      # [4,4] = P @ V
    campos: torch.Tensor    # [3]
    tan_fovx: torch.Tensor  # scalar
    tan_fovy: torch.Tensor  # scalar
    width: int
    height: int

    # torch.div, not ``int / tensor``: the latter is reciprocal-then-multiply
    # in torch, one rounding away from the JAX package's true division
    @property
    def focal_x(self) -> torch.Tensor:
        return torch.div(torch.full_like(self.tan_fovx, self.width),
                         2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return torch.div(torch.full_like(self.tan_fovy, self.height),
                         2.0 * self.tan_fovy)


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities feeding binning + compositing."""

    xy: torch.Tensor        # [N,2] pixel-space means
    depth: torch.Tensor     # [N] view-space z
    conic: torch.Tensor     # [N,3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor    # [N] float, 0 for culled
    rgb: torch.Tensor       # [N,3] SH-evaluated clamped color (or precomputed)
    opacity: torch.Tensor   # [N]
    valid: torch.Tensor     # [N] bool: in frustum, invertible cov, radius > 0


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (r, x, y, z) -> rotation matrix [..., 3, 3], used as given
    (no renormalization, as in the original kernel, forward.cu:128)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                scale_modifier=1.0) -> torch.Tensor:
    """3D covariance R S^2 R^T packed [N,6] (xx, xy, xz, yy, yz, zz),
    elementwise in the JAX package's term order."""
    r, x, y, z = (rotations[..., 0], rotations[..., 1],
                  rotations[..., 2], rotations[..., 3])
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scale_modifier * scales
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    return torch.stack([
        s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02,
        s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12,
        s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22,
        s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12,
        s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22,
        s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22], dim=-1)


def _affine_row(p: torch.Tensor, m: torch.Tensor, row: int) -> torch.Tensor:
    """p @ m[row, :3] + m[row, 3], written elementwise."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    m0, m1, m2, m3 = (m[row, i] for i in range(4))
    return x * m0 + y * m1 + z * m2 + m3


def _affine3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """First three rows of the affine transform, stacked [N, 3]."""
    return torch.stack([_affine_row(p, m, r) for r in range(3)], dim=-1)


def project_points(means3d: torch.Tensor, cam: CameraView):
    """(p_view [N,3], p_ndc [N,3], in_front [N] bool); near plane z > 0.2."""
    pv = _affine3(means3d, cam.view)
    ph = _affine3(means3d, cam.proj)
    pw = _affine_row(means3d, cam.proj, 3)
    inv_w = 1.0 / (pw + 1e-7)
    p_ndc = ph * inv_w[:, None]
    return pv, p_ndc, pv[:, 2] > 0.2


def ndc_to_pixel(ndc_xy: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """((v+1)*S - 1) / 2 per axis."""
    tracing.count("host_wait.ndc_to_pixel")
    wh = torch.tensor([width, height], dtype=ndc_xy.dtype, device=ndc_xy.device)
    return ((ndc_xy + 1.0) * wh - 1.0) * 0.5


def compute_cov2d(means3d: torch.Tensor, cov3d: torch.Tensor,
                  cam: CameraView) -> torch.Tensor:
    """EWA projection of the 3D covariance: [N,3] (a, b, c) of the 2x2
    screen covariance with the +0.3 low-pass added (forward.cu:75-114)."""
    t = _affine3(means3d, cam.view)
    tz = t[:, 2]
    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    tx = torch.minimum(torch.maximum(t[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(t[:, 1] / tz, -limy), limy) * tz

    fx, fy = cam.focal_x, cam.focal_y
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    wr = cam.view[:3, :3]
    t0 = j00[:, None] * wr[0] + j02[:, None] * wr[2]
    t1 = j11[:, None] * wr[1] + j12[:, None] * wr[2]

    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = [cov3d[:, i] for i in range(6)]

    def sig_mul(v):
        return torch.stack(
            [c_xx * v[:, 0] + c_xy * v[:, 1] + c_xz * v[:, 2],
             c_xy * v[:, 0] + c_yy * v[:, 1] + c_yz * v[:, 2],
             c_xz * v[:, 0] + c_yz * v[:, 1] + c_zz * v[:, 2]], dim=-1)

    def dot3(u, v):
        # explicit left-to-right sum: a reduction over 3 may reassociate
        return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]

    s0 = sig_mul(t0)
    a = dot3(t0, s0) + 0.3
    b = dot3(t1, s0)
    c = dot3(t1, sig_mul(t1)) + 0.3
    return torch.stack([a, b, c], dim=-1)


def invert_cov2d(cov2d: torch.Tensor):
    """(conic [N,3], radius [N] float, invertible [N] bool),
    forward.cu:217-231."""
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    invertible = det != 0.0
    det_safe = torch.where(invertible, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam_max = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam_max, 0.0)))
    return conic, radius, invertible


def tile_rect(xy: torch.Tensor, radius: torch.Tensor, grid_x: int, grid_y: int,
              tile_w: int, tile_h: int):
    """Tile-grid bounding rectangle per Gaussian: (rect_min [N,2] int32,
    rect_max [N,2] int32), max exclusive; area 0 means no tiles touched."""
    r = radius[:, None]
    tracing.count("host_wait.tile_rect", 2)
    tile = torch.tensor([tile_w, tile_h], dtype=xy.dtype, device=xy.device)
    lo = torch.floor((xy - r) / tile)
    hi = torch.floor((xy + r + (tile - 1)) / tile)
    # clamp while still float: converting an out-of-int32-range float is
    # undefined in torch, where XLA saturates; in range both agree exactly
    grid = torch.tensor([grid_x, grid_y], dtype=xy.dtype, device=xy.device)
    zero = torch.zeros_like(grid)
    rect_min = torch.minimum(torch.maximum(lo, zero), grid).to(torch.int32)
    rect_max = torch.minimum(torch.maximum(hi, zero), grid).to(torch.int32)
    return rect_min, rect_max


def preprocess(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    cam: CameraView,
    *,
    scales: torch.Tensor | None = None,
    rotations: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors_precomp: torch.Tensor | None = None,
    scale_modifier=1.0,
) -> Preprocessed:
    """Full per-Gaussian preprocess. Exactly one of (scales+rotations) /
    cov3d_precomp and one of shs / colors_precomp must be given."""
    if cov3d_precomp is None:
        cov3d = build_cov3d(scales, rotations, scale_modifier)
    else:
        cov3d = cov3d_precomp

    p_view, p_ndc, in_front = project_points(means3d, cam)
    cov2d = compute_cov2d(means3d, cov3d, cam)
    conic, radius, invertible = invert_cov2d(cov2d)
    xy = ndc_to_pixel(p_ndc[:, :2], cam.width, cam.height)

    if colors_precomp is None:
        rgb = sh_lib.sh_to_rgb(sh_degree, shs, means3d, cam.campos)
    else:
        rgb = colors_precomp

    valid = in_front & invertible & (radius > 0.0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Preprocessed(xy=xy, depth=p_view[:, 2], conic=conic, radius=radius,
                        rgb=rgb, opacity=opacities, valid=valid)
