"""Real spherical-harmonics evaluation (degrees 0..4) in PyTorch.

Port of ``feature3dgs_tpu/core/sh.py``: the same basis constants, the same
term order, ``sh`` laid out ``[..., M, 3]`` with ``M = (degree+1)**2``
(DC first), and colors = ``max(SH(dir) + 0.5, 0)``. ``sh_backward`` is
the closed-form backward of ``eval_sh``.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Raw SH polynomial at unit directions: sh [..., M, C], dirs [..., 3]
    -> [..., C] (no +0.5, no clamp). Only the first (degree+1)**2
    coefficient rows are read."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree must be in [0,4], got {degree}")
    result = SH_C0 * sh[..., 0, :]
    if degree > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result
                  - SH_C1 * y * sh[..., 1, :]
                  + SH_C1 * z * sh[..., 2, :]
                  - SH_C1 * x * sh[..., 3, :])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * sh[..., 4, :]
                      + SH_C2[1] * yz * sh[..., 5, :]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + SH_C2[3] * xz * sh[..., 7, :]
                      + SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if degree > 2:
                result = (result
                          + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                          + SH_C3[1] * xy * z * sh[..., 10, :]
                          + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                          + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                          * sh[..., 12, :]
                          + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                          + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
                if degree > 3:
                    result = (result
                              + SH_C4[0] * xy * (xx - yy) * sh[..., 16, :]
                              + SH_C4[1] * yz * (3.0 * xx - yy) * sh[..., 17, :]
                              + SH_C4[2] * xy * (7.0 * zz - 1.0) * sh[..., 18, :]
                              + SH_C4[3] * yz * (7.0 * zz - 3.0) * sh[..., 19, :]
                              + SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0)
                              * sh[..., 20, :]
                              + SH_C4[5] * xz * (7.0 * zz - 3.0) * sh[..., 21, :]
                              + SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0)
                              * sh[..., 22, :]
                              + SH_C4[7] * xz * (xx - 3.0 * yy) * sh[..., 23, :]
                              + SH_C4[8]
                              * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))
                              * sh[..., 24, :])
    return result


def sh_to_rgb(degree: int, sh: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """[N, M, 3] SH, [N, 3] centers, [3] camera center -> [N, 3] colors
    ``max(SH(dir) + 0.5, 0)`` (the original preprocess, forward.cu:20-72)."""
    d = means - campos[None, :]
    dirs = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return torch.clamp_min(eval_sh(degree, sh, dirs) + 0.5, 0.0)


def rgb_to_sh_dc(rgb):
    """Inverse of the DC band (numpy or tensor in, same kind out)."""
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(sh):
    return sh * SH_C0 + 0.5


def _sh_terms(degree: int, x, y, z):
    """The signed basis values of ``eval_sh`` (what each coefficient row is
    multiplied by, with the sign it is summed with; row 0's is SH_C0) and
    each row's partial derivatives along x, y and z, as (row, axis, factor)
    in row order. Every value is rounded as ``eval_sh`` rounds it: x * x,
    x * y and the basis products in its op order."""
    basis, parts = [SH_C0], []
    if degree > 0:
        basis += [-(SH_C1 * y), SH_C1 * z, -(SH_C1 * x)]
        parts += [(1, 1, -SH_C1), (2, 2, SH_C1), (3, 0, -SH_C1)]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                  SH_C2[4] * (xx - yy)]
        parts += [(4, 0, SH_C2[0] * y), (4, 1, SH_C2[0] * x),
                  (5, 1, SH_C2[1] * z), (5, 2, SH_C2[1] * y),
                  (6, 0, (-2.0 * SH_C2[2]) * x), (6, 1, (-2.0 * SH_C2[2]) * y),
                  (6, 2, (4.0 * SH_C2[2]) * z),
                  (7, 0, SH_C2[3] * z), (7, 2, SH_C2[3] * x),
                  (8, 0, (2.0 * SH_C2[4]) * x), (8, 1, (-2.0 * SH_C2[4]) * y)]
    if degree > 2:
        xx_yy = xx - yy
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * xx_yy, SH_C3[6] * x * (xx - 3.0 * yy)]
        parts += [(9, 0, (6.0 * SH_C3[0]) * xy),
                  (9, 1, (3.0 * SH_C3[0]) * xx_yy),
                  (10, 0, SH_C3[1] * yz), (10, 1, SH_C3[1] * xz),
                  (10, 2, SH_C3[1] * xy),
                  (11, 0, (-2.0 * SH_C3[2]) * xy),
                  (11, 1, SH_C3[2] * (4.0 * zz - xx - 3.0 * yy)),
                  (11, 2, (8.0 * SH_C3[2]) * yz),
                  (12, 0, (-6.0 * SH_C3[3]) * xz),
                  (12, 1, (-6.0 * SH_C3[3]) * yz),
                  (12, 2, SH_C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
                  (13, 0, SH_C3[4] * (4.0 * zz - 3.0 * xx - yy)),
                  (13, 1, (-2.0 * SH_C3[4]) * xy),
                  (13, 2, (8.0 * SH_C3[4]) * xz),
                  (14, 0, (2.0 * SH_C3[5]) * xz),
                  (14, 1, (-2.0 * SH_C3[5]) * yz),
                  (14, 2, SH_C3[5] * xx_yy),
                  (15, 0, (3.0 * SH_C3[6]) * xx_yy),
                  (15, 1, (-6.0 * SH_C3[6]) * xy)]
    if degree > 3:
        xyz = xy * z
        zz7_1, zz7_3 = 7.0 * zz - 1.0, 7.0 * zz - 3.0
        xx3_yy, xx_3yy = 3.0 * xx - yy, xx - 3.0 * yy
        basis += [SH_C4[0] * xy * xx_yy, SH_C4[1] * yz * xx3_yy,
                  SH_C4[2] * xy * zz7_1, SH_C4[3] * yz * zz7_3,
                  SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                  SH_C4[5] * xz * zz7_3, SH_C4[6] * xx_yy * zz7_1,
                  SH_C4[7] * xz * xx_3yy,
                  SH_C4[8] * (xx * xx_3yy - yy * xx3_yy)]
        parts += [(16, 0, SH_C4[0] * (y * xx3_yy)),
                  (16, 1, SH_C4[0] * (x * xx_3yy)),
                  (17, 0, (6.0 * SH_C4[1]) * xyz),
                  (17, 1, (3.0 * SH_C4[1]) * (z * xx_yy)),
                  (17, 2, SH_C4[1] * (y * xx3_yy)),
                  (18, 0, SH_C4[2] * (y * zz7_1)),
                  (18, 1, SH_C4[2] * (x * zz7_1)),
                  (18, 2, (14.0 * SH_C4[2]) * xyz),
                  (19, 1, SH_C4[3] * (z * zz7_3)),
                  (19, 2, SH_C4[3] * (y * (21.0 * zz - 3.0))),
                  (20, 2, SH_C4[4] * (z * (140.0 * zz - 60.0))),
                  (21, 0, SH_C4[5] * (z * zz7_3)),
                  (21, 2, SH_C4[5] * (x * (21.0 * zz - 3.0))),
                  (22, 0, (2.0 * SH_C4[6]) * (x * zz7_1)),
                  (22, 1, (-2.0 * SH_C4[6]) * (y * zz7_1)),
                  (22, 2, (14.0 * SH_C4[6]) * (z * xx_yy)),
                  (23, 0, (3.0 * SH_C4[7]) * (z * xx_yy)),
                  (23, 1, (-6.0 * SH_C4[7]) * xyz),
                  (23, 2, SH_C4[7] * (x * xx_3yy)),
                  (24, 0, (4.0 * SH_C4[8]) * (x * xx_3yy)),
                  (24, 1, (4.0 * SH_C4[8]) * (y * (yy - 3.0 * xx)))]
    return basis, parts


def sh_backward(degree: int, sh: torch.Tensor, dirs: torch.Tensor,
                g_result: torch.Tensor):
    """The closed-form backward of ``eval_sh(degree, sh, dirs)``: given the
    cotangent ``g_result`` [N, C] of its result, returns (g_sh [N, M, C],
    rows at and above (degree+1)**2 zero; g_dirs [N, 3]). g_sh's row k is
    g_result times row k's basis value; g_dirs sums, row by row, each
    row's derivative times w_k = sum_c g_result[c] * sh[k, c] (left to
    right over c). Written as single elementwise ops on [N] columns, in
    the order ops/csrc/preprocess.cu repeats."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree must be in [0,4], got {degree}")
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    basis, parts = _sh_terms(degree, x, y, z)
    g_sh = torch.zeros_like(sh)
    w = []
    for k, b in enumerate(basis):
        g_sh[:, k] = g_result * (b if k == 0 else b[:, None])
        wk = g_result[:, 0] * sh[:, k, 0]
        for c in range(1, sh.shape[-1]):
            wk = wk + g_result[:, c] * sh[:, k, c]
        w.append(wk)
    g_dirs = []
    for axis in range(3):
        acc = torch.zeros_like(x)
        terms = [w[k] * d for k, a, d in parts if a == axis]
        if terms:
            acc = terms[0]
            for term in terms[1:]:
                acc = acc + term
        g_dirs.append(acc)
    return g_sh, torch.stack(g_dirs, dim=-1)
