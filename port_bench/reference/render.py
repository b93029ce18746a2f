"""Plain PyTorch rendering of 3D Gaussians with features: the benchmark's
reference for what the program renders.

Written from the published method (Kerbl et al. 2023, "3D Gaussian
Splatting", and its CUDA rasterizer's preprocess and blending rules, with
Feature 3DGS's extra feature channels) and nothing of the program: the
activations, the EWA projection with the 0.3 px low-pass and the 1.3 tan(fov)
clamp, the 3-sigma radius, binning into 32x16 tiles with a stable
(tile, depth) sort, and front-to-back blending per pixel with alpha capped at
0.99, splats under alpha 1/255 skipped, and a pixel ended by the splat that
would take its transmittance below 1e-4.

The blending runs over tiles in blocks, each block's lists padded to its
longest list, so that it fits on the card at full size. It is differentiable
by autograd: the rasterizer's rule that the feature channels add no gradient
to alpha (the original backward.cu leaves that term out) is kept by blending
features with detached weights; the alpha cap passes its gradient through,
as the original's backward does.

Binning uses the least tile rectangle that can hold a pixel where the splat
reaches alpha 1/255: min(3 sigma, sigma * sqrt(2 ln(opacity * 255))) + 1 px,
tile-aligned as the original's getRect. A tile outside it holds no pixel at
which the splat counts, so the image is that of the 3-sigma rectangle, and
the instance count is the one these inputs need.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
NEAR = 0.2
# elements of one [tiles, pixels, entries] block of the blending
BLOCK_ELEMS = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


# ---------------------------------------------------------------- cameras

def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 world-to-camera matrix of a camera-to-world rotation ``R`` and a
    world-to-camera translation ``t`` (getWorld2View2 without re-centring)."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = np.asarray(R, np.float64).T
    rt[:3, 3] = t
    rt[3, 3] = 1.0
    return rt.astype(np.float32)


def projection(znear: float, zfar: float, fovx: float, fovy: float
               ) -> np.ndarray:
    """The perspective matrix of getProjectionMatrix (NDC z in [0, 1])."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    p = np.zeros((4, 4), np.float32)
    p[0, 0] = znear / right
    p[1, 1] = znear / top
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


class Cam(NamedTuple):
    view: torch.Tensor     # [4,4] world -> camera
    full: torch.Tensor     # [4,4] projection @ view
    center: torch.Tensor   # [3]
    tan_x: float
    tan_y: float
    width: int
    height: int


def make_cam(R, t, fovx, fovy, width, height, device, znear=0.01, zfar=100.0
             ) -> Cam:
    view = world_to_view(R, t)
    full = projection(znear, zfar, fovx, fovy) @ view
    center = np.linalg.inv(view.astype(np.float64))[:3, 3]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Cam(f32(view), f32(full), f32(center), float(np.float32(
        math.tan(fovx / 2))), float(np.float32(math.tan(fovy / 2))),
        int(width), int(height))


# ---------------------------------------------------------------- Gaussians

def activate(p: dict) -> dict:
    """Activated parameters of a dict with the original model's fields:
    xyz, features_dc [N,1,3], features_rest [N,15,3], scaling (log),
    rotation (unnormalised quaternion r,x,y,z), opacity (logit [N,1]),
    semantic_feature [N,1,F]."""
    q = p["rotation"]
    return {
        "xyz": p["xyz"],
        "scale": torch.exp(p["scaling"]),
        "quat": q / torch.linalg.vector_norm(q, dim=-1, keepdim=True),
        "opacity": torch.sigmoid(p["opacity"][:, 0]),
        "sh": torch.cat([p["features_dc"], p["features_rest"]], 1),
        "feat": p["semantic_feature"][:, 0, :],
    }


def sh_color(sh: torch.Tensor, dirs: torch.Tensor, degree: int
             ) -> torch.Tensor:
    """max(SH(dir) + 0.5, 0) of [N,16,3] coefficients at unit directions."""
    x, y, z = (dirs[:, i:i + 1] for i in range(3))
    out = SH_C0 * sh[:, 0]
    if degree > 0:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree > 2:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp_min(out + 0.5, 0.0)


class Screen(NamedTuple):
    """Per-Gaussian screen-space quantities of one view."""

    xy: torch.Tensor       # [N,2] pixel centres
    conic: torch.Tensor    # [N,3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # [N]
    rgb: torch.Tensor      # [N,3]
    depth: torch.Tensor    # [N] view-space z
    feat: torch.Tensor     # [N,F]
    radius: torch.Tensor   # [N] 3-sigma pixel radius, 0 where culled
    valid: torch.Tensor    # [N] bool


def project(g: dict, cam: Cam, sh_degree: int = 3) -> Screen:
    """EWA projection of activated Gaussians ``g`` into ``cam``."""
    xyz = g["xyz"]
    v, pf = cam.view, cam.full
    pv = xyz @ v[:3, :3].T + v[:3, 3]
    ph = xyz @ pf.T[:3] + pf[:, 3]
    ndc = ph[:, :2] / (ph[:, 3:4] + 1e-7)
    wh = torch.tensor([cam.width, cam.height], dtype=xyz.dtype,
                      device=xyz.device)
    xy = ((ndc + 1.0) * wh - 1.0) * 0.5

    q = g["quat"]
    r, x, y, z = q.unbind(-1)
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    m = rot * g["scale"][:, None, :]
    cov3 = m @ m.transpose(1, 2)

    tz = pv[:, 2]
    fx = cam.width / (2.0 * cam.tan_x)
    fy = cam.height / (2.0 * cam.tan_y)
    tx = torch.clamp(pv[:, 0] / tz, -1.3 * cam.tan_x, 1.3 * cam.tan_x) * tz
    ty = torch.clamp(pv[:, 1] / tz, -1.3 * cam.tan_y, 1.3 * cam.tan_y) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                       zero, fy / tz, -fy * ty / (tz * tz)], -1)
    jac = jac.reshape(-1, 2, 3)
    t = jac @ v[:3, :3]
    cov2 = t @ cov3 @ t.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    ok_det = det != 0
    det_s = torch.where(ok_det, det, torch.ones_like(det))
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0))).detach()
    valid = (tz > NEAR) & ok_det & (radius > 0)

    d = xyz - cam.center
    dirs = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    rgb = sh_color(g["sh"], dirs, sh_degree)
    return Screen(xy, conic, g["opacity"], rgb, tz, g["feat"],
                  torch.where(valid, radius, torch.zeros_like(radius)),
                  valid.detach())


# ---------------------------------------------------------------- binning

class Bins(NamedTuple):
    gid: torch.Tensor      # [L] Gaussian ids in (tile, depth) order
    starts: torch.Tensor   # [T] int64
    counts: torch.Tensor   # [T] int64
    grid_x: int
    grid_y: int
    tile_w: int
    tile_h: int


def bin_tiles(s: Screen, width: int, height: int, tile_w: int = 32,
              tile_h: int = 16) -> Bins:
    """Per-tile lists of the Gaussians whose reach touches each tile, sorted
    by view depth (ties in id order)."""
    gx, gy = -(-width // tile_w), -(-height // tile_h)
    op = s.opacity.detach()
    reach = torch.sqrt(2.0 * torch.clamp_min(
        torch.log(torch.clamp_min(op, 1e-12) / ALPHA_MIN), 0.0))
    r = torch.minimum(s.radius, torch.ceil(s.radius / 3.0 * reach) + 1.0)
    xy = s.xy.detach()
    tile = torch.tensor([tile_w, tile_h], dtype=xy.dtype, device=xy.device)
    top = torch.tensor([gx, gy], dtype=xy.dtype, device=xy.device)
    lo = torch.clamp(torch.floor((xy - r[:, None]) / tile), min=0)
    lo = torch.minimum(lo, top).long()
    hi = torch.floor((xy + r[:, None] + tile - 1) / tile).clamp(min=0)
    hi = torch.minimum(hi, top).long()
    span = (hi - lo).clamp(min=0)
    area = span[:, 0] * span[:, 1]
    area = torch.where(s.valid, area, torch.zeros_like(area))
    ids = torch.repeat_interleave(torch.arange(area.shape[0],
                                               device=xy.device), area)
    first = torch.cumsum(area, 0) - area
    k = torch.arange(ids.shape[0], device=xy.device) - first[ids]
    tx = lo[ids, 0] + k % span[ids, 0]
    ty = lo[ids, 1] + k // span[ids, 0]
    tid = ty * gx + tx
    depth_bits = s.depth.detach()[ids].contiguous().view(torch.int32).long()
    order = torch.sort(tid * (1 << 32) + depth_bits, stable=True).indices
    counts = torch.bincount(tid, minlength=gx * gy)
    starts = torch.cumsum(counts, 0) - counts
    return Bins(ids[order], starts, counts, gx, gy, tile_w, tile_h)


# ---------------------------------------------------------------- blending

class Image(NamedTuple):
    color: torch.Tensor    # [H,W,3]
    feat: torch.Tensor     # [H,W,F]
    depth: torch.Tensor    # [H,W]
    final_t: torch.Tensor  # [H,W]


def tile_blocks(bins: Bins, budget: int = BLOCK_ELEMS):
    """[t0, t1) runs of tiles whose padded [tiles, pixels, longest list]
    block stays under ``budget`` elements."""
    p = bins.tile_w * bins.tile_h
    counts = bins.counts.tolist()
    t0, longest = 0, 0
    for t, n in enumerate(counts):
        longest_next = max(longest, n)
        if t > t0 and (t - t0 + 1) * p * max(longest_next, 1) > budget:
            yield t0, t
            t0, longest_next = t, n
        longest = longest_next
    if counts:
        yield t0, len(counts)


ENTRY_FIELDS = ("xy", "conic", "opacity", "rgb", "depth", "feat")


def block_entries(bins: Bins, t0: int, t1: int):
    """(gid [tiles, K], used [tiles, K]) of tiles [t0, t1): each tile's
    list padded to the block's longest, padding marked unused (id 0)."""
    counts = bins.counts[t0:t1]
    longest = int(counts.max()) if t1 > t0 else 0
    pos = torch.arange(longest, device=counts.device)
    used = pos[None, :] < counts[:, None]
    slot = (bins.starts[t0:t1, None] + pos[None, :]).clamp(
        max=max(bins.gid.shape[0] - 1, 0))
    gid = torch.where(used, bins.gid[slot], torch.zeros_like(slot))
    return gid, used


def blend_entries(e: dict, used, bins: Bins, t0: int, t1: int, stats=None,
                  gid=None, n=None):
    """Blend tiles [t0, t1) from their lists' entries ``e`` (each field of
    ``ENTRY_FIELDS`` gathered to [tiles, K, ...]): ([tiles, P, 3],
    [tiles, P, F], [tiles, P], [tiles, P]) colour, features, depth and
    final transmittance. ``stats`` (with the entries' ``gid`` and the
    Gaussian count ``n``) gets the work counted."""
    dev = used.device
    nt, tw, th = t1 - t0, bins.tile_w, bins.tile_h
    p = tw * th
    t = torch.arange(t0, t1, device=dev)
    lane = torch.arange(p, device=dev)
    px = ((t % bins.grid_x) * tw)[:, None] + lane % tw              # [nt,P]
    py = ((t // bins.grid_x) * th)[:, None] + lane // tw
    dx = e["xy"][:, None, :, 0] - px[..., None].float()            # [nt,P,K]
    dy = e["xy"][:, None, :, 1] - py[..., None].float()
    a, b, c = (e["conic"][:, None, :, i] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = e["opacity"][:, None, :] * torch.exp(power)
    # the cap at 0.99 passes its gradient through, as the original backward
    alpha = raw - torch.clamp_min(raw - ALPHA_MAX, 0.0).detach()
    counts_here = (power <= 0) & (alpha >= ALPHA_MIN) & used[:, None, :]
    alpha = torch.where(counts_here, alpha, torch.zeros_like(alpha))
    keep = 1.0 - alpha
    t_before = torch.cat([torch.ones_like(keep[..., :1]),
                          torch.cumprod(keep, -1)[..., :-1]], -1)
    contrib = counts_here & (t_before * keep >= T_MIN)
    w = torch.where(contrib, alpha * t_before, torch.zeros_like(alpha))
    # colour and depth in one product, features in another
    cd = torch.bmm(w, torch.cat([e["rgb"], e["depth"][..., None]], -1))
    feat = torch.bmm(w.detach(), e["feat"])
    final_t = torch.prod(torch.where(contrib, keep, torch.ones_like(keep)), -1)
    if stats is not None:
        _count(stats, n, gid, used, counts_here, contrib)
    return cd[..., :3], feat, cd[..., 3], final_t


def blend_block(s: Screen, bins: Bins, t0: int, t1: int, stats=None):
    """``blend_entries`` of tiles [t0, t1) of the view ``s``."""
    gid, used = block_entries(bins, t0, t1)
    if gid.shape[1] == 0:
        dev, nt, p = s.xy.device, t1 - t0, bins.tile_w * bins.tile_h
        z = lambda *shape: torch.zeros(shape, device=dev)
        return (z(nt, p, 3), z(nt, p, s.feat.shape[-1]), z(nt, p),
                torch.ones(nt, p, device=dev))
    e = {k: getattr(s, k)[gid] for k in ENTRY_FIELDS}
    return blend_entries(e, used, bins, t0, t1, stats, gid, s.xy.shape[0])


def _count(stats: dict, n: int, gid, used, counts_here, contrib) -> None:
    """Add this block's work to ``stats``: the (entry, pixel) pairs a pixel
    tests while live and those that contribute (forward), the pairs up to a
    pixel's last contributor (backward), the list entries either touches,
    and the Gaussians whose rows either reads."""
    ended = counts_here & ~contrib
    none = torch.full_like(ended[..., 0], -1, dtype=torch.long)
    first_end = torch.where(ended.any(-1), ended.float().argmax(-1), none)
    n_list = used.sum(-1)                                           # [nt]
    tested = torch.where(first_end >= 0, first_end + 1, n_list[:, None])
    k = torch.arange(contrib.shape[-1], device=contrib.device)
    last = torch.where(contrib.any(-1),
                       (contrib * (k + 1)).amax(-1), torch.zeros_like(tested))
    entry_tested = k[None, :] < tested.amax(-1)[:, None]            # [nt,K]
    entry_walked = k[None, :] < last.amax(-1)[:, None]
    add = lambda key, v: stats.__setitem__(key, stats.get(key, 0) + int(v))
    add("tested", tested.sum())
    add("contributing", contrib.sum())
    add("walked", last.sum())
    add("entries_tested", (entry_tested & used).sum())
    add("entries_walked", (entry_walked & used).sum())
    for key, hit in (("tested_gaussians", entry_tested & used),
                     ("walked_gaussians", entry_walked & used),
                     ("contributing_gaussians", contrib.any(1))):
        seen = stats.setdefault(key, torch.zeros(n, dtype=torch.bool,
                                                 device=gid.device))
        seen[gid[hit]] = True


def tiles_to_image(x: torch.Tensor, bins: Bins, width: int, height: int
                   ) -> torch.Tensor:
    """[tiles, P, ...] in row-major tile order -> [H, W, ...]."""
    rest = tuple(x.shape[2:])
    img = x.reshape((bins.grid_y, bins.grid_x, bins.tile_h, bins.tile_w)
                    + rest).transpose(1, 2)
    img = img.reshape((bins.grid_y * bins.tile_h, bins.grid_x * bins.tile_w)
                      + rest)
    return img[:height, :width]


def render(s: Screen, bins: Bins, width: int, height: int, bg=None,
           stats=None) -> Image:
    """The whole view, block by block, without autograd."""
    parts = [[], [], [], []]
    with torch.no_grad():
        for t0, t1 in tile_blocks(bins):
            for acc, x in zip(parts, blend_block(s, bins, t0, t1, stats)):
                acc.append(x)
    color, feat, depth, final_t = (
        tiles_to_image(torch.cat(x, 0), bins, width, height) for x in parts)
    if bg is not None:
        color = color + final_t[..., None] * bg
    return Image(color, feat, depth, final_t)


def blend_backward(s: Screen, bins: Bins, width: int, height: int,
                   g_color: torch.Tensor, g_feat: torch.Tensor) -> dict:
    """The blending's gradient: image cotangents [H,W,3] and [H,W,F] taken
    back, block by block, to each list entry, and summed per Gaussian.
    Returns {field of ``ENTRY_FIELDS``: [N, ...]}."""
    gx, gy, tw, th = bins.grid_x, bins.grid_y, bins.tile_w, bins.tile_h

    def to_tiles(img):
        pad = torch.zeros((gy * th, gx * tw) + img.shape[2:],
                          device=img.device)
        pad[:height, :width] = img
        return pad.reshape((gy, th, gx, tw) + img.shape[2:]).transpose(
            1, 2).reshape((gx * gy, th * tw) + img.shape[2:])

    gc, gf = to_tiles(g_color), to_tiles(g_feat)
    grads = {k: torch.zeros_like(getattr(s, k)) for k in ENTRY_FIELDS}
    for t0, t1 in tile_blocks(bins):
        gid, used = block_entries(bins, t0, t1)
        if gid.shape[1] == 0:
            continue
        e = {k: getattr(s, k).detach()[gid].requires_grad_()
             for k in ENTRY_FIELDS}
        color, feat, _, _ = blend_entries(e, used, bins, t0, t1)
        torch.autograd.backward([color, feat], [gc[t0:t1], gf[t0:t1]])
        rows = gid[used]
        for k, x in e.items():
            if x.grad is not None:
                grads[k].index_add_(0, rows, x.grad[used])
    return grads
