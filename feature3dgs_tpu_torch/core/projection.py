"""Per-Gaussian view-dependent preprocessing in PyTorch.

Port of ``feature3dgs_tpu/core/projection.py`` (the original
``preprocessCUDA``, forward.cu:156-256), with the same constants: near cull
at z <= 0.2, homogeneous epsilon +1e-7, the 1.3*tan_fov frustum clamp, the
+0.3 px low-pass on the cov2D diagonal and radius = ceil(3*sqrt(max
eigenvalue)) with the ``max(0.1, ...)`` discriminant guard.

The affine transforms are written elementwise in the JAX package's order
(not as ``@``), so that projected pixel means agree to the last bits and
``tile_rect`` floors do not flip at tile borders.

``preprocess_backward`` is the closed-form backward of the scales +
rotations + SH path, which the backward kernel (ops/csrc/preprocess.cu)
repeats op for op; ``ops/rasterize.py:_Preprocess`` takes it for CPU
tensors.
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


def _sum_left(terms):
    """terms[0] + terms[1] + ..., left to right."""
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc


def preprocess_backward(means3d, scales, rotations, shs, sh_degree: int,
                        scale_modifier, cam: CameraView, valid, g_xy, g_depth,
                        g_conic, g_rgb, want_ndc_offset: bool = False):
    """The closed-form backward of ``preprocess`` on the scales + rotations
    + SH path, plus the ``ndc_offset * wh * 0.5`` added to xy
    (``ops/rasterize.py``): given the cotangents of xy [N,2], depth [N],
    conic [N,3] and rgb [N,3] (None = zero), returns (g_means3d, g_scales,
    g_rotations, g_shs, g_ndc_offset or None). Rows where ``valid`` is
    False are exact zeros (they reach no pixel, so no cotangent); SH rows
    at and above (sh_degree+1)**2 are zero.

    It recomputes what the forward computed, op for op as ``preprocess``
    does, and saves nothing; every line is one elementwise op on [N]
    columns, in the order the backward kernel (ops/csrc/preprocess.cu)
    repeats, so the two agree bit for bit on the card. Where the forward
    clamps (the frustum clamp of the EWA Jacobian, the colour's max(., 0))
    the derivative follows autograd's: half to each side at a tie of
    ``minimum``/``maximum``, through ``clamp_min`` where the value equals
    the bound."""
    n = means3d.shape[0]
    zeros = lambda k: torch.zeros((n, k), dtype=means3d.dtype,
                                  device=means3d.device)
    g_xy = zeros(2) if g_xy is None else g_xy
    g_depth = zeros(1)[:, 0] if g_depth is None else g_depth
    g_conic = zeros(3) if g_conic is None else g_conic
    g_rgb = zeros(3) if g_rgb is None else g_rgb
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    v, p = cam.view, cam.proj

    # forward: the view-space point, the homogeneous projection
    t = [_affine_row(means3d, v, r) for r in range(3)]
    tz = t[2]
    hx = _affine_row(means3d, p, 0)
    hy = _affine_row(means3d, p, 1)
    inv_w = 1.0 / (_affine_row(means3d, p, 3) + 1e-7)

    # forward: R and the 3D covariance (build_cov3d)
    qr, qx, qy, qz = (rotations[:, 0], rotations[:, 1], rotations[:, 2],
                      rotations[:, 3])
    rm = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qr * qz),
           2 * (qx * qz + qr * qy)],
          [2 * (qx * qy + qr * qz), 1 - 2 * (qx * qx + qz * qz),
           2 * (qy * qz - qr * qx)],
          [2 * (qx * qz - qr * qy), 2 * (qy * qz + qr * qx),
           1 - 2 * (qx * qx + qy * qy)]]
    s = [scale_modifier * scales[:, k] for k in range(3)]
    sq = [s[k] ** 2 for k in range(3)]
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))

    def cov_entry(i, j):
        return (sq[0] * rm[i][0] * rm[j][0] + sq[1] * rm[i][1] * rm[j][1]
                + sq[2] * rm[i][2] * rm[j][2])
    cov = {ij: cov_entry(*ij) for ij in pairs}
    sig = lambda i, j: cov[(min(i, j), max(i, j))]

    # forward: the EWA Jacobian with the frustum clamp (compute_cov2d)
    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    ux, uy = t[0] / tz, t[1] / tz
    cx = torch.minimum(torch.maximum(ux, -limx), limx)
    cy = torch.minimum(torch.maximum(uy, -limy), limy)
    txc, tyc = cx * tz, cy * tz
    fx, fy = cam.focal_x, cam.focal_y
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    nfx, nfy = -fx, -fy
    j00, j02 = fx * inv_z, nfx * txc * inv_z2
    j11, j12 = fy * inv_z, nfy * tyc * inv_z2
    t0 = [j00 * v[0, k] + j02 * v[2, k] for k in range(3)]
    t1 = [j11 * v[1, k] + j12 * v[2, k] for k in range(3)]

    def sig_mul(u):
        return [sig(i, 0) * u[0] + sig(i, 1) * u[1] + sig(i, 2) * u[2]
                for i in range(3)]

    def dot3(u, w):
        return u[0] * w[0] + u[1] * w[1] + u[2] * w[2]
    s0, s1 = sig_mul(t0), sig_mul(t1)
    a = dot3(t0, s0) + 0.3
    b = dot3(t1, s0)
    c = dot3(t1, s1) + 0.3
    det = a * c - b * b
    inv_det = 1.0 / det

    # backward: conic = (c, -b, a) / det
    gc0, gc1, gc2 = g_conic[:, 0], g_conic[:, 1], g_conic[:, 2]
    g_inv = gc0 * c - gc1 * b + gc2 * a
    g_det = -(g_inv * inv_det * inv_det)
    g_a = gc2 * inv_det + g_det * c
    g_b = -(gc1 * inv_det) - g_det * (2.0 * b)
    g_c = gc0 * inv_det + g_det * a

    # backward: a = t0' S t0, b = t1' S t0, c = t1' S t1
    g_a2, g_c2 = 2.0 * g_a, 2.0 * g_c
    g_t0 = [g_a2 * s0[k] + g_b * s1[k] for k in range(3)]
    g_t1 = [g_b * s0[k] + g_c2 * s1[k] for k in range(3)]
    g_cov = {}
    for i, j in pairs:
        if i == j:
            g_cov[(i, j)] = (g_a * (t0[i] * t0[i]) + g_b * (t1[i] * t0[i])
                             + g_c * (t1[i] * t1[i]))
        else:
            g_cov[(i, j)] = (g_a2 * (t0[i] * t0[j])
                             + g_b * (t1[i] * t0[j] + t1[j] * t0[i])
                             + g_c2 * (t1[i] * t1[j]))

    # backward: the Jacobian rows, 1/tz, the clamp and t = V m
    g_j00 = dot3(g_t0, [v[0, k] for k in range(3)])
    g_j02 = dot3(g_t0, [v[2, k] for k in range(3)])
    g_j11 = dot3(g_t1, [v[1, k] for k in range(3)])
    g_j12 = dot3(g_t1, [v[2, k] for k in range(3)])
    g_txc = g_j02 * inv_z2 * nfx
    g_tyc = g_j12 * inv_z2 * nfy
    g_inv_z2 = g_j02 * (nfx * txc) + g_j12 * (nfy * tyc)
    g_inv_z = g_j00 * fx + g_j11 * fy + g_inv_z2 * (2.0 * inv_z)

    def clamp_factor(u, lo, hi):
        # d min(max(u, lo), hi) / du as autograd takes it: 1/2 at each tie
        up = torch.where(u > lo, 1.0, torch.where(u == lo, 0.5, 0.0))
        m = torch.maximum(u, lo)
        return up * torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))
    g_ux = g_txc * tz * clamp_factor(ux, -limx, limx)
    g_uy = g_tyc * tz * clamp_factor(uy, -limy, limy)
    g_tx = g_ux / tz
    g_ty = g_uy / tz
    g_tz = (g_depth + g_txc * cx + g_tyc * cy
            - g_inv_z * inv_z * inv_z - g_ux * ux / tz - g_uy * uy / tz)

    # backward: xy = ((ndc + 1) * wh - 1) * 0.5, ndc = h / w
    g_nx = g_xy[:, 0] * 0.5 * cam.width
    g_ny = g_xy[:, 1] * 0.5 * cam.height
    g_hx, g_hy = g_nx * inv_w, g_ny * inv_w
    g_hw = -((g_nx * hx + g_ny * hy) * inv_w * inv_w)

    # backward: the colour's direction (sh_to_rgb)
    d = means3d - cam.campos[None, :]
    length = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    dirs = d / length
    pre = sh_lib.eval_sh(sh_degree, shs, dirs) + 0.5
    g_pre = torch.where(pre >= 0.0, g_rgb, torch.zeros_like(g_rgb))
    g_shs, g_dirs = sh_lib.sh_backward(sh_degree, shs, dirs, g_pre)
    dg = dot3([dirs[:, k] for k in range(3)],
              [g_dirs[:, k] for k in range(3)])
    g_d = [(g_dirs[:, k] - dirs[:, k] * dg) / length[:, 0] for k in range(3)]

    # backward: means (t, h, w and the direction), per coordinate
    g_means = torch.stack(
        [g_tx * v[0, k] + g_ty * v[1, k] + g_tz * v[2, k] + g_hx * p[0, k]
         + g_hy * p[1, k] + g_hw * p[3, k] + g_d[k] for k in range(3)], -1)

    # backward: the covariance's R and S^2, then q and the scales
    g_sq = [g_cov[(0, 0)] * (rm[0][k] * rm[0][k])
            + g_cov[(0, 1)] * (rm[0][k] * rm[1][k])
            + g_cov[(0, 2)] * (rm[0][k] * rm[2][k])
            + g_cov[(1, 1)] * (rm[1][k] * rm[1][k])
            + g_cov[(1, 2)] * (rm[1][k] * rm[2][k])
            + g_cov[(2, 2)] * (rm[2][k] * rm[2][k]) for k in range(3)]
    g_scales = torch.stack([g_sq[k] * (2.0 * s[k]) * scale_modifier
                            for k in range(3)], -1)
    # g_R[i][k] = sq_k * (2 g_ii R_ik + sum_{j != i} g_ij R_jk)
    g_rm = [[sq[k] * _sum_left(
        [(2.0 * g_cov[(i, i)]) * rm[i][k]]
        + [g_cov[(min(i, j), max(i, j))] * rm[j][k]
           for j in range(3) if j != i]) for k in range(3)] for i in range(3)]
    g_r = 2.0 * (-(qz * g_rm[0][1]) + qy * g_rm[0][2] + qz * g_rm[1][0]
                 - qx * g_rm[1][2] - qy * g_rm[2][0] + qx * g_rm[2][1])
    g_qx = (2.0 * (qy * g_rm[0][1] + qz * g_rm[0][2] + qy * g_rm[1][0]
                   - qr * g_rm[1][2] + qz * g_rm[2][0] + qr * g_rm[2][1])
            - 4.0 * qx * (g_rm[1][1] + g_rm[2][2]))
    g_qy = (2.0 * (qx * g_rm[0][1] + qr * g_rm[0][2] + qx * g_rm[1][0]
                   + qz * g_rm[1][2] - qr * g_rm[2][0] + qz * g_rm[2][1])
            - 4.0 * qy * (g_rm[0][0] + g_rm[2][2]))
    g_qz = (2.0 * (-(qr * g_rm[0][1]) + qx * g_rm[0][2] + qr * g_rm[1][0]
                   + qy * g_rm[1][2] + qx * g_rm[2][0] + qy * g_rm[2][1])
            - 4.0 * qz * (g_rm[0][0] + g_rm[1][1]))
    g_rot = torch.stack([g_r, g_qx, g_qy, g_qz], -1)

    keep = valid[:, None]
    out = [torch.where(keep, g, torch.zeros_like(g))
           for g in (g_means, g_scales, g_rot)]
    out.append(torch.where(valid[:, None, None], g_shs,
                           torch.zeros_like(g_shs)))
    g_ndc = None
    if want_ndc_offset:
        wh = torch.stack([torch.full_like(mx, cam.width),
                          torch.full_like(mx, cam.height)], -1)
        g_ndc = torch.where(keep, g_xy * wh * 0.5, torch.zeros_like(g_xy))
    return (*out, g_ndc)

