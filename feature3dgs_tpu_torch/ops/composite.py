"""Front-to-back alpha compositing of binned Gaussians and its gradient:
the plain PyTorch versions of the forward and backward kernels.

Port of ``feature3dgs_tpu/ops/composite.py`` (``_composite_fwd_impl`` and
``_composite_bwd``), vectorized over batches of tiles and over per-tile
lists padded to the longest list in the batch. Lists are never truncated,
as in the kernel path. This is what CPU tensors run, and what the CUDA
kernels (ops/csrc/raster_forward.cu, raster_backward.cu) are held against
on the card.

Transmittance is kept in the log domain per chunk of K list entries:
  * T before a splat = T_in * exp(strict prefix sum of log1p(-alpha));
  * T after = T before * (1 - alpha);
  * a splat contributes iff it counts (power <= 0, alpha >= 1/255), the
    pixel is live and T after >= T_EPS; its weight is alpha * T before;
  * at the chunk's end T_in *= exp(sum of contributing log1p(-alpha));
  * a counting live splat with T after < T_EPS ends the pixel;
  * n_contrib is the largest 1-based list position that contributed.
Under this form the result does not depend on K beyond float rounding, so
the kernel may use its own chunk length.

The backward (``composite_plain_backward``) walks each tile back to front
from its deepest contributor and returns one gradient row per list entry,
as the backward kernel does; ``ops.segment`` sums the rows per Gaussian.

``alpha_matmul=True`` (``RasterConfig.alpha_matmul``; the ``alpha_mm`` mode
of the TPU kernels, pallas_raster.py:167-189) evaluates the exponent as the
dot product of six per-splat coefficients with the pixel's monomials
(1, x, y, x^2, xy, y^2) in tile-local coordinates, and the backward's five
geometric sums as six sums of dL/dpower * monomial followed by a per-entry
chain rule. Same math, other rounding: power moves by ~1e-6, so a marginal
splat can flip and ``n_contrib`` may differ by one on isolated pixels. The
dot runs in the fixed order ((((c0 + c1 x) + c2 y) + c3 x^2) + c4 xy) +
c5 y^2 with separately rounded products and sums, which is also the order
and rounding of the CUDA kernels' alpha mode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from feature3dgs_tpu_torch.ops.binning import TileGrid

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

# elements of one [tiles, K, P] intermediate per tile batch (16 MiB in f32)
_BATCH_ELEMS = 1 << 22


class CompositeOutput(NamedTuple):
    color: torch.Tensor      # [T, P, 3]
    feature: torch.Tensor    # [T, P, F]
    depth: torch.Tensor      # [T, P]
    final_T: torch.Tensor    # [T, P]
    n_contrib: torch.Tensor  # [T, P] int32


class BackwardRows(NamedTuple):
    """Gradient rows of the compositing, one per entry of gid_sorted."""

    geom: torch.Tensor     # [L, 10]: x, y, conic a, b, c, opacity, r, g, b, depth
    feature: torch.Tensor  # [L, F]


def tile_pixel_coords(grid: TileGrid, n_tiles: int, tile_base: int = 0,
                      device=None) -> torch.Tensor:
    """[n_tiles, P, 2] pixel coordinates (no +0.5) of tiles
    ``tile_base .. tile_base + n_tiles``; the tile row wraps per image
    (``(t // grid_x) % grid_y``) so stacked same-size grids stay
    image-local."""
    t = torch.arange(n_tiles, device=device) + tile_base
    tx = (t % grid.grid_x) * grid.tile_w
    ty = ((t // grid.grid_x) % grid.grid_y) * grid.tile_h
    lane = torch.arange(grid.pixels_per_tile, device=device)
    px = tx[:, None] + (lane % grid.tile_w)[None, :]
    py = ty[:, None] + (lane // grid.tile_w)[None, :]
    return torch.stack([px, py], dim=-1).to(torch.float32)


def tile_monomials(grid: TileGrid, device=None) -> torch.Tensor:
    """[6, P] monomials (1, x, y, x^2, xy, y^2) of the tile-local pixel
    coordinates (small integers: every entry is exact in f32)."""
    lane = torch.arange(grid.pixels_per_tile, device=device)
    x = (lane % grid.tile_w).to(torch.float32)
    y = (lane // grid.tile_w).to(torch.float32)
    return torch.stack([torch.ones_like(x), x, y, x * x, x * y, y * y])


def _alpha_coeff(g_xy, g_conic, origin):
    """Coefficients of power over the tile-local monomials, each [tb,K,1],
    and the tile-local splat position (xl, yl). Tile-local coordinates keep
    every term of the order of (distance / sigma)^2, which bounds the f32
    cancellation the regrouped sum exposes."""
    xl = g_xy[..., 0:1] - origin[:, None, 0:1]
    yl = g_xy[..., 1:2] - origin[:, None, 1:2]
    ca, cb, cc = (g_conic[..., i:i + 1] for i in range(3))
    c0 = -0.5 * (ca * xl * xl + cc * yl * yl) - cb * xl * yl
    c1 = ca * xl + cb * yl
    c2 = cc * yl + cb * xl
    return (c0, c1, c2, -0.5 * ca, -cb, -0.5 * cc), xl, yl


def _alpha_power(coeff, mono):
    """[tb,K,P] power = coeff . mono in the fixed order of the kernels."""
    power = coeff[0] + coeff[1] * mono[1]
    for c in range(2, 6):
        power = power + coeff[c] * mono[c]
    return power


def composite_plain(xy, conic, opacity, rgb, depth, feat, gid_sorted,
                    tile_starts, tile_counts, grid: TileGrid, *, chunk: int,
                    tile_base: int = 0, n_per_camera: int = 0,
                    alpha_matmul: bool = False,
                    stats: dict | None = None) -> CompositeOutput:
    """Composite every tile of ``tile_starts``/``tile_counts`` (tile t is
    global tile ``tile_base + t``). Per-Gaussian inputs: xy [N,2],
    conic [N,3], opacity [N], rgb [N,3], depth [N], feat [N,F].

    ``n_per_camera`` = N > 0 composites B cameras' stacked tile grids
    (``ops.binning.bin_gaussians_batch``): global tile g belongs to camera
    b = g // T, xy, conic, opacity, rgb and depth are [B*N, ...] and are
    read at row b * N + id, and feat [N,F] at row id. Tiles are batched
    within one camera at a time, exactly as one camera's call batches them,
    so each camera's outputs are bit-equal to its own call's.

    ``stats``, when given, gets the work these inputs need: "tested"
    (list entry, pixel) pairs — the entries a pixel examines while it is
    live — and "contributing" pairs (nonzero weight) are added to; the list
    entries some pixel tests are counted in "entries_tested"; and [N] bool
    masks mark the Gaussians some pixel tests ("tested_gaussians", whose
    position, conic and opacity must be read) and those that contribute
    somewhere ("contributing_gaussians", whose colour, depth and features
    must be read; rows of xy, so per camera when batched). The chip smoke
    check computes the kernel's bound from them."""
    dev = xy.device
    n_tiles = tile_starts.shape[0]
    p = grid.pixels_per_tile
    f_dim = feat.shape[-1]
    color = torch.zeros((n_tiles, p, 3), dtype=torch.float32, device=dev)
    feature = torch.zeros((n_tiles, p, f_dim), dtype=torch.float32, device=dev)
    depth_out = torch.zeros((n_tiles, p), dtype=torch.float32, device=dev)
    final_t = torch.ones((n_tiles, p), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((n_tiles, p), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return CompositeOutput(color, feature, depth_out, final_t, n_contrib)

    counts = tile_counts.long()
    starts = tile_starts.long()
    gid = gid_sorted.long()
    pix = tile_pixel_coords(grid, n_tiles, tile_base, dev)
    # alpha_matmul: each tile's origin is its first pixel
    local = (pix[:, 0], tile_monomials(grid, dev)) if alpha_matmul else None
    row0 = _tile_row0(grid, n_tiles, tile_base, n_per_camera, dev)
    step = max(1, _BATCH_ELEMS // (chunk * p))
    for t0, t1 in _tile_batches(n_tiles, step, tile_base, grid.num_tiles):
        longest = int(counts[t0:t1].max())
        if longest == 0:
            continue
        out = _composite_tiles(
            xy, conic, opacity, rgb, depth, feat, gid, starts[t0:t1],
            counts[t0:t1], pix[t0:t1], row0[t0:t1], chunk, longest, stats,
            None if local is None else (local[0][t0:t1], local[1]))
        (color[t0:t1], feature[t0:t1], depth_out[t0:t1], final_t[t0:t1],
         n_contrib[t0:t1]) = out
    return CompositeOutput(color, feature, depth_out, final_t, n_contrib)


def _tile_row0(grid: TileGrid, n_tiles: int, tile_base: int,
                 n_per_camera: int, device) -> torch.Tensor:
    """[n_tiles] first row of each tile's camera in the per-camera inputs
    (all 0 unbatched)."""
    return ((torch.arange(n_tiles, device=device) + tile_base)
            // grid.num_tiles * n_per_camera)


def _tile_batches(n_tiles: int, step: int, tile_base: int, per_camera: int):
    """[t0, t1) batches of at most ``step`` tiles, cut where a camera's grid
    of ``per_camera`` tiles starts and where the camera-local tile index is
    a multiple of ``step``: every tile lands in the batch it has in a call
    over its whole camera, whatever slice of the grid (``tile_base``) or
    stack of cameras a call covers."""
    t0 = 0
    while t0 < n_tiles:
        local = (tile_base + t0) % per_camera
        t1 = min(n_tiles, t0 + step - local % step, t0 + per_camera - local)
        yield t0, t1
        t0 = t1


def _composite_tiles(xy, conic, opacity, rgb, depth, feat, gid, starts,
                     counts, pix, row0, chunk: int, longest: int, stats,
                     local=None):
    """``row0`` [tb] is each tile's first row of the per-camera inputs;
    ``local`` = (tile origins [tb,2], monomials [6,P]) selects the
    alpha_matmul evaluation of power."""
    tb, p = pix.shape[0], pix.shape[1]
    dev = xy.device
    px = pix[:, None, :, 0]                              # [tb,1,P]
    py = pix[:, None, :, 1]
    trans = torch.ones((tb, p), dtype=torch.float32, device=dev)
    live = torch.ones((tb, p), dtype=torch.bool, device=dev)
    acc_c = torch.zeros((tb, p, 3), dtype=torch.float32, device=dev)
    acc_f = torch.zeros((tb, p, feat.shape[-1]), dtype=torch.float32,
                        device=dev)
    acc_d = torch.zeros((tb, p), dtype=torch.float32, device=dev)
    ncon = torch.zeros((tb, p), dtype=torch.int32, device=dev)
    lane = torch.arange(chunk, device=dev)
    for base in range(0, longest, chunk):
        pos = base + lane                                # [K] 0-based
        in_list = pos[None, :] < counts[:, None]         # [tb,K]
        slot = torch.where(in_list, starts[:, None] + pos[None, :],
                           torch.zeros_like(starts)[:, None])
        ids = torch.where(in_list, gid[slot], torch.zeros_like(slot))
        rows = ids + row0[:, None]                       # this camera's rows
        g_xy, g_conic = xy[rows], conic[rows]            # [tb,K,2], [tb,K,3]
        if local is not None:
            power = _alpha_power(_alpha_coeff(g_xy, g_conic, local[0])[0],
                                 local[1])
        else:
            dx = g_xy[..., 0:1] - px                     # [tb,K,P]
            dy = g_xy[..., 1:2] - py
            ca, cb, cc = (g_conic[..., i:i + 1] for i in range(3))
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha_raw = torch.clamp_max(opacity[rows][..., None] * torch.exp(power),
                                    ALPHA_MAX)
        ok = (power <= 0.0) & (alpha_raw >= ALPHA_MIN) & in_list[..., None]
        alpha = torch.where(ok, alpha_raw, torch.zeros_like(alpha_raw))
        log1m = torch.log1p(-alpha)
        t_before = trans[:, None, :] * torch.exp(torch.cumsum(log1m, 1) - log1m)
        t_after = t_before * (1.0 - alpha)
        okl = ok & live[:, None, :]
        mask = okl & (t_after >= T_EPS)
        w = torch.where(mask, alpha * t_before, torch.zeros_like(alpha))
        if stats is not None:
            ended = (okl & ~mask).int()
            tested = (in_list[..., None] & live[:, None, :]
                      & (torch.cumsum(ended, 1) - ended == 0))
            stats["tested"] = stats.get("tested", 0) + int(tested.sum())
            stats["contributing"] = (stats.get("contributing", 0)
                                     + int(mask.sum()))
            entry_tested = tested.any(-1)                # [tb,K]
            stats["entries_tested"] = (stats.get("entries_tested", 0)
                                       + int(entry_tested.sum()))
            for key, hit in (("tested_gaussians", entry_tested),
                             ("contributing_gaussians", mask.any(-1))):
                seen = stats.setdefault(key, torch.zeros(
                    xy.shape[0], dtype=torch.bool, device=dev))
                seen[rows[hit]] = True

        acc_c += torch.einsum("tkp,tkc->tpc", w, rgb[rows])
        acc_f += torch.einsum("tkp,tkf->tpf", w, feat[ids])
        acc_d += torch.einsum("tkp,tk->tp", w, depth[rows])

        trans = trans * torch.exp(torch.sum(
            torch.where(mask, log1m, torch.zeros_like(log1m)), dim=1))
        live = live & ~torch.any(okl & ~mask, dim=1)
        pos1 = (pos + 1).to(torch.int32)[None, :, None]
        ncon = torch.maximum(ncon, torch.amax(
            torch.where(mask, pos1, torch.zeros_like(pos1)), dim=1))
    return acc_c, acc_f, acc_d, trans, ncon


def composite_plain_backward(xy, conic, opacity, rgb, depth, feat, gid_sorted,
                             tile_starts, tile_counts, grid: TileGrid,
                             g_color, g_feat, g_depth, g_final_t, final_t,
                             n_contrib, *, chunk: int,
                             tile_base: int = 0, n_per_camera: int = 0,
                             feature_alpha_grad: bool = False,
                             alpha_matmul: bool = False,
                             stats: dict | None = None) -> BackwardRows:
    """Gradient rows of ``composite_plain`` (one per list entry), given the
    forward's inputs, the pixel cotangents g_color [T,P,3], g_feat [T,P,F],
    g_depth [T,P], g_final_t [T,P] and the forward's final_t and n_contrib.

    The quirks of ``feature3dgs_tpu/ops/composite.py:_composite_bwd`` hold:
    features couple into alpha only under ``feature_alpha_grad``; the 0.99
    alpha clamp is not gated; the conic gets the true d/db; the final_T
    cotangent enters the suffix as g_final_t * final_T; depth couples into
    alpha like a colour channel. Rows the walk never reaches (past each
    tile's deepest contributor) are zero.

    ``tile_base`` and ``n_per_camera`` mean what they mean to
    ``composite_plain``: tile t is global tile ``tile_base + t`` (its pixels
    and its camera), and with ``n_per_camera`` = N > 0 the splat inputs are
    [B*N] stacks read at row b * N + id while feat [N,F] is read at row id.
    The rows written are one per entry of the lists given; a slice of the
    grid passes its own sub-range of gid_sorted with rebased starts. Tiles
    are batched as a call over each whole camera batches them
    (``_tile_batches``), so a slice's rows and a batched camera's rows are
    bit-equal to the rows of that camera's own full call.

    ``stats``, when given, gets the work these inputs need: "walked"
    (entry, pixel) pairs of the entries before each tile's deepest
    contributor, "contributing" pairs, "entries_walked", and bool masks
    over the rows of xy (per camera when batched) "walked_gaussians" and
    "contributing_gaussians"."""
    dev = xy.device
    n_tiles = tile_starts.shape[0]
    p = grid.pixels_per_tile
    f_dim = feat.shape[-1]
    n_inst = gid_sorted.shape[0]
    geom = torch.zeros((n_inst, 10), dtype=torch.float32, device=dev)
    feature = torch.zeros((n_inst, f_dim), dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return BackwardRows(geom, feature)
    counts = tile_counts.long()
    starts = tile_starts.long()
    gid = gid_sorted.long()
    # the walk stops at each tile's deepest contributor
    depth_walk = torch.minimum(n_contrib.long().amax(1), counts)
    pix = tile_pixel_coords(grid, n_tiles, tile_base, dev)
    local = (pix[:, 0], tile_monomials(grid, dev)) if alpha_matmul else None
    row0 = _tile_row0(grid, n_tiles, tile_base, n_per_camera, dev)
    step = max(1, _BATCH_ELEMS // (chunk * p))
    for t0, t1 in _tile_batches(n_tiles, step, tile_base, grid.num_tiles):
        longest = int(depth_walk[t0:t1].max())
        if longest == 0:
            continue
        _backward_tiles(
            xy, conic, opacity, rgb, depth, feat, gid, starts[t0:t1],
            depth_walk[t0:t1], pix[t0:t1], row0[t0:t1], g_color[t0:t1],
            g_feat[t0:t1], g_depth[t0:t1], g_final_t[t0:t1], final_t[t0:t1],
            n_contrib[t0:t1].long(), chunk, longest, feature_alpha_grad,
            geom, feature, stats,
            None if local is None else (local[0][t0:t1], local[1]))
    return BackwardRows(geom, feature)


def _backward_tiles(xy, conic, opacity, rgb, depth, feat, gid, starts,
                    walk, pix, row0, g_color, g_feat, g_depth, g_final_t,
                    final_t, ncon, chunk: int, longest: int, fag: bool, geom,
                    feature, stats, local=None):
    dev = xy.device
    px = pix[:, None, :, 0]                              # [tb,1,P]
    py = pix[:, None, :, 1]
    g_aug = torch.cat([g_color, g_depth[..., None]], -1)  # [tb,P,4(+F)]
    if fag:
        g_aug = torch.cat([g_aug, g_feat], -1)
    t_end = final_t.clone()
    # S = g_finalT * final_T + sum over later entries of w * u
    suffix = g_final_t * final_t
    lane = torch.arange(chunk, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for base in reversed(range(0, longest, chunk)):
        pos = base + lane                                # [K] 0-based
        walked = pos[None, :] < walk[:, None]            # [tb,K]
        slot = torch.where(walked, starts[:, None] + pos[None, :],
                           torch.zeros_like(starts)[:, None])
        ids = torch.where(walked, gid[slot], torch.zeros_like(slot))
        rows = ids + row0[:, None]                       # this camera's rows
        g_xy, g_conic = xy[rows], conic[rows]
        g_op = opacity[rows][..., None]                  # [tb,K,1]
        ca, cb, cc = (g_conic[..., i:i + 1] for i in range(3))
        if local is not None:
            coeff, xl, yl = _alpha_coeff(g_xy, g_conic, local[0])
            power = _alpha_power(coeff, local[1])
        else:
            dx = g_xy[..., 0:1] - px                     # [tb,K,P]
            dy = g_xy[..., 1:2] - py
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        gexp = torch.exp(power)
        alpha_raw = torch.clamp_max(g_op * gexp, ALPHA_MAX)
        mask = ((power <= 0.0) & (alpha_raw >= ALPHA_MIN) & walked[..., None]
                & (pos[None, :, None] < ncon[:, None, :]))
        alpha = torch.where(mask, alpha_raw, zero)
        log1m = torch.log1p(-alpha)
        revcum = torch.flip(torch.cumsum(torch.flip(log1m, [1]), 1), [1])
        t_before = t_end[:, None, :] * torch.exp(-revcum)
        w = torch.where(mask, alpha * t_before, zero)
        c_aug = torch.cat([rgb[rows], depth[rows][..., None]], -1)
        if fag:
            c_aug = torch.cat([c_aug, feat[ids]], -1)
        u = torch.einsum("tkc,tpc->tkp", c_aug, g_aug)
        m = w * u
        s_within = torch.flip(torch.cumsum(torch.flip(m, [1]), 1), [1]) - m
        dl_da = torch.where(
            mask, t_before * u - (s_within + suffix[:, None, :]) / (1.0 - alpha),
            zero)
        d_op = torch.where(mask, gexp * dl_da, zero)
        d_pow = g_op * d_op
        if local is not None:
            # d coeff = dL/dpower . mono^T, then the chain rule from the
            # coefficients back to x, y and the conic, per entry
            dc = torch.einsum("tkp,cp->tkc", d_pow, local[1])
            dc = [dc[..., c:c + 1] for c in range(6)]
            geo = [dc[0] * -(ca * xl + cb * yl) + dc[1] * ca + dc[2] * cb,
                   dc[0] * -(cc * yl + cb * xl) + dc[1] * cb + dc[2] * cc,
                   dc[0] * (-0.5 * xl * xl) + dc[1] * xl - 0.5 * dc[3],
                   dc[0] * -(xl * yl) + dc[1] * yl + dc[2] * xl - dc[4],
                   dc[0] * (-0.5 * yl * yl) + dc[2] * yl - 0.5 * dc[5]]
            geo = [x[..., 0] for x in geo]
        else:
            geo = [torch.sum(-(ca * dx + cb * dy) * d_pow, 2),
                   torch.sum(-(cc * dy + cb * dx) * d_pow, 2),
                   torch.sum(-0.5 * dx * dx * d_pow, 2),
                   torch.sum(-dx * dy * d_pow, 2),
                   torch.sum(-0.5 * dy * dy * d_pow, 2)]
        out = torch.stack(geo + [torch.sum(d_op, 2)], -1)    # [tb,K,6]
        out = torch.cat([out, torch.einsum("tkp,tpc->tkc", w, g_color),
                         torch.einsum("tkp,tp->tk", w, g_depth)[..., None]],
                        -1)
        geom[slot[walked]] = out[walked]
        feature[slot[walked]] = torch.einsum("tkp,tpf->tkf", w, g_feat)[walked]
        if stats is not None:
            stats["walked"] = (stats.get("walked", 0)
                               + int(walked.sum()) * pix.shape[1])
            stats["contributing"] = (stats.get("contributing", 0)
                                     + int(mask.sum()))
            stats["entries_walked"] = (stats.get("entries_walked", 0)
                                       + int(walked.sum()))
            for key, hit in (("walked_gaussians", walked),
                             ("contributing_gaussians", mask.any(-1))):
                seen = stats.setdefault(key, torch.zeros(
                    xy.shape[0], dtype=torch.bool, device=dev))
                seen[rows[hit]] = True
        suffix = suffix + torch.sum(m, 1)
        t_end = t_end * torch.exp(-torch.sum(log1m, 1))
