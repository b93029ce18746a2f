"""Rasterization API: preprocess -> binning -> compositing -> image assembly.

Port of ``feature3dgs_tpu/ops/rasterize.py:rasterize``: one differentiable
call renders RGB + N-dim semantic features + depth, returned HWC, with the
same radii, visibility, ``n_contrib`` and overflow counters. The
preprocess (projection, EWA covariance, colour from SH, tile rectangle and
cull) is one ``torch.autograd.Function`` whose forward and backward are one
CUDA kernel each (or, for CPU tensors, the plain ops and their closed-form
backward); a precomputed covariance or colour takes ordinary autograd.
Binning is integer work on detached inputs; the compositing is one
``torch.autograd.Function`` whose forward and backward are the CUDA kernels
(or, for CPU tensors, their plain versions), and whose per-entry gradient
rows are summed per Gaussian by ``ops.segment``.
``ndc_offset`` (a zero [N,2] tensor that requires grad) yields the NDC-space
positional gradients densification accumulates. ``rasterize_batch`` renders
B same-resolution views forward-only through one binning sort and one
forward-kernel launch over their stacked tile grids; under grad,
``composite_inputs_batch`` and ``composite(..., n_per_camera=N)`` give the
training step of several cameras one sort, one forward launch and one
backward launch, and ``tile_base`` composites a slice of the tile grid.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.core import projection as proj_lib
from feature3dgs_tpu_torch.ops import binning as binning_lib
from feature3dgs_tpu_torch.ops.binning import TileGrid
from feature3dgs_tpu_torch.ops.composite import (ALPHA_MIN, CompositeOutput,
                                                 composite_plain,
                                                 composite_plain_backward)
from feature3dgs_tpu_torch.ops.cuda_preprocess import (
    preprocess_backward_cuda, preprocess_forward_cuda)
from feature3dgs_tpu_torch.ops.cuda_raster import (raster_backward_cuda,
                                                   raster_forward_cuda)
from feature3dgs_tpu_torch.ops.segment import SegmentPlan, camera_rows

BACKENDS = ("auto", "cuda", "plain")


def rect_radius(radius: torch.Tensor, opacity: torch.Tensor) -> torch.Tensor:
    """Opacity-aware binning radius: beyond sqrt(2 ln(op / ALPHA_MIN))
    sigma every pixel's alpha is below ALPHA_MIN, so such tiles would only
    hold splats that never count. The radii/visibility outputs keep the
    3-sigma ``radius``."""
    op = opacity.detach()
    return torch.minimum(
        radius,
        torch.ceil((radius / 3.0) * torch.sqrt(2.0 * torch.clamp_min(
            torch.log(torch.clamp_min(op, 1e-12) / ALPHA_MIN), 0.0))) + 1.0)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer configuration.

    tile_w/tile_h: pixel tile size (32x16 default; 16x16 is the original
      CUDA tiling).
    chunk: list entries per step of the plain compositor; the CUDA kernel
      uses its own (cuda_raster.KERNEL_CHUNK). Results agree up to float
      rounding either way.
    instance_capacity: cap on (Gaussian, tile) instances; Gaussians beyond
      it are dropped whole, highest index first (0 = 1 << 20). Per-tile
      lists are never truncated.
    backend: 'auto' = the CUDA kernels for CUDA tensors, the plain
      versions for CPU tensors; 'cuda' = the kernels (CUDA tensors only);
      'plain' = the plain versions on any device (tests and the chip smoke
      check). The backward follows the same choice as the forward.
    feature_alpha_grad: the reference leaves the feature -> alpha gradient
      coupling out (backward.cu:575); True restores the complete gradient.
    alpha_matmul: evaluate the Gaussian exponent as a six-term dot of
      per-splat coefficients with the pixel's tile-local monomials
      (1, x, y, x^2, xy, y^2), and the backward's geometric sums as six
      monomial-weighted sums plus a per-entry chain rule, in both kernels
      and both plain versions (ops/composite.py, ops/csrc/raster_common.cuh).
      Same math, regrouped floats: power moves by ~1e-6, so outputs agree
      with the exact mode to ~1e-4 and ``n_contrib`` may differ by one on
      isolated pixels. The forward and backward of a step share the mode.
    """

    tile_w: int = 32
    tile_h: int = 16
    chunk: int = 128
    instance_capacity: int = 0
    backend: str = "auto"
    feature_alpha_grad: bool = False
    alpha_matmul: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be positive, got {self.chunk}")

    @property
    def instance_capacity_or_default(self) -> int:
        return self.instance_capacity or (1 << 20)

    def grid(self, width: int, height: int) -> TileGrid:
        return TileGrid(width=width, height=height,
                        tile_w=self.tile_w, tile_h=self.tile_h)


class RasterOutput(NamedTuple):
    color: torch.Tensor      # [H,W,3]
    feature: torch.Tensor    # [H,W,F]
    depth: torch.Tensor      # [H,W]
    alpha: torch.Tensor      # [H,W] = 1 - final_T
    radii: torch.Tensor      # [N] float screen radii (0 = invisible)
    visibility: torch.Tensor  # [N] bool (radii > 0)
    n_contrib: torch.Tensor  # [H,W] int32
    total_instances: torch.Tensor  # scalar: instances before the cap
    max_tile_count: torch.Tensor   # scalar int32: longest per-tile list
    feature_tiles: torch.Tensor    # [T,P,F] tile layout of ``feature``


def tiles_to_image(tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """[num_tiles, pixels_per_tile, ...] -> [H, W, ...] crop."""
    ch = tuple(tiles.shape[2:])
    img = tiles.reshape((grid.grid_y, grid.grid_x, grid.tile_h, grid.tile_w)
                        + ch)
    img = img.movedim(2, 1).reshape(
        (grid.grid_y * grid.tile_h, grid.grid_x * grid.tile_w) + ch)
    return img[: grid.height, : grid.width]


def tiles_to_images(tiles: torch.Tensor, grid: TileGrid,
                    n_cams: int) -> torch.Tensor:
    """[B * num_tiles, pixels_per_tile, ...] of B stacked same-size grids,
    camera-major -> [B, H, W, ...]: the stack is one image B grids tall."""
    tall = TileGrid(width=grid.grid_x * grid.tile_w,
                    height=n_cams * grid.grid_y * grid.tile_h,
                    tile_w=grid.tile_w, tile_h=grid.tile_h)
    img = tiles_to_image(tiles, tall)
    img = img.reshape((n_cams, grid.grid_y * grid.tile_h) + img.shape[1:])
    return img[:, : grid.height, : grid.width]


def mark_visible(means3d: torch.Tensor, cam: proj_lib.CameraView) -> torch.Tensor:
    """[N] bool near-plane mask (view z > 0.2), as the preprocess applies."""
    _, _, in_frustum = proj_lib.project_points(means3d, cam)
    return in_frustum


def _prep_plain(means3d, opacities, cam, grid, *, scales, rotations,
                cov3d_precomp, shs, sh_degree, colors_precomp, scale_modifier,
                ndc_offset, active_mask):
    """The preprocess and tile-rect cull as plain ops: the autograd path of
    the editing inputs, and the forward of ``_Preprocess``'s plain half."""
    pre = proj_lib.preprocess(
        means3d, opacities, cam,
        scales=scales, rotations=rotations, cov3d_precomp=cov3d_precomp,
        shs=shs, sh_degree=sh_degree, colors_precomp=colors_precomp,
        scale_modifier=scale_modifier)
    xy = pre.xy
    if ndc_offset is not None:
        tracing.count("host_wait.ndc_offset_scale")
        wh = torch.tensor([cam.width, cam.height], dtype=xy.dtype,
                          device=xy.device)
        xy = xy + ndc_offset * wh * 0.5
    rect_min, rect_max = proj_lib.tile_rect(
        xy, rect_radius(pre.radius, pre.opacity),
        grid.grid_x, grid.grid_y, grid.tile_w, grid.tile_h)
    area = ((rect_max[:, 0] - rect_min[:, 0])
            * (rect_max[:, 1] - rect_min[:, 1]))
    valid = pre.valid & (area > 0)
    if active_mask is not None:
        valid = valid & active_mask
    return pre, xy, rect_min, rect_max, valid


def _preprocess_path(config: RasterConfig, means3d, scales, rotations, shs,
                     cov3d_precomp, colors_precomp) -> str:
    """The one place the preprocess is chosen, by what the inputs show:
    scales + rotations + SH take ``_Preprocess``, its kernels ("kernels")
    where ``_use_kernels`` picks them, else its plain halves ("plain"); a
    precomputed covariance or colour (the editing paths) takes autograd
    through the plain ops ("autograd"). The camera is not differentiated."""
    if (scales is None or rotations is None or shs is None
            or cov3d_precomp is not None or colors_precomp is not None):
        return "autograd"
    return "kernels" if _use_kernels(config, means3d) else "plain"


class _Preprocess(torch.autograd.Function):
    """The per-Gaussian preprocess of one view on the scales + rotations +
    SH path, from ``proj_lib.preprocess`` through the cull. Differentiable
    inputs: means3d, scales, rotations, shs, ndc_offset; differentiable
    outputs: xy (ndc_offset added), depth, conic, rgb; radius, rect_min,
    rect_max, pre_valid and valid are not. ``kernels``: one forward and one
    backward launch (ops/cuda_preprocess.py), else the plain forward
    (``_prep_plain``) and the closed-form backward
    (``proj_lib.preprocess_backward``), which the kernels equal bit for bit
    on the card. The backward recomputes from the inputs and saves
    nothing else."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, shs, ndc_offset, opacities,
                active_mask, cam, grid, sh_degree, scale_modifier, kernels):
        if kernels:
            means3d, scales, rotations, shs, opacities = (
                x.contiguous() for x in (means3d, scales, rotations, shs,
                                         opacities))
            ndc_offset, active_mask = (
                None if x is None else x.contiguous()
                for x in (ndc_offset, active_mask))
            out = preprocess_forward_cuda(
                means3d, scales, rotations, shs, opacities, cam, grid,
                sh_degree=sh_degree, scale_modifier=scale_modifier,
                ndc_offset=ndc_offset, active_mask=active_mask)
        else:
            pre, xy, rect_min, rect_max, valid = _prep_plain(
                means3d, opacities, cam, grid, scales=scales,
                rotations=rotations, cov3d_precomp=None, shs=shs,
                sh_degree=sh_degree, colors_precomp=None,
                scale_modifier=scale_modifier, ndc_offset=ndc_offset,
                active_mask=active_mask)
            out = (xy, pre.depth, pre.conic, pre.radius, pre.rgb, rect_min,
                   rect_max, pre.valid, valid)
        xy, depth, conic, radius, rgb, rect_min, rect_max, pre_valid, valid \
            = out
        ctx.save_for_backward(means3d, scales, rotations, shs, valid)
        # an output no loss reached comes to backward as None: read as zero
        ctx.set_materialize_grads(False)
        ctx.cam, ctx.sh_degree, ctx.kernels = cam, sh_degree, kernels
        ctx.scale_modifier = scale_modifier
        ctx.mark_non_differentiable(radius, rect_min, rect_max, pre_valid,
                                    valid)
        return xy, depth, conic, rgb, radius, rect_min, rect_max, pre_valid, \
            valid

    @staticmethod
    def backward(ctx, g_xy, g_depth, g_conic, g_rgb, *_non_differentiable):
        means3d, scales, rotations, shs, valid = ctx.saved_tensors
        need = ctx.needs_input_grad
        with tracing.span("raster.preprocess_backward"):
            fn = (preprocess_backward_cuda if ctx.kernels
                  else proj_lib.preprocess_backward)
            grads = fn(means3d, scales, rotations, shs, ctx.sh_degree,
                       ctx.scale_modifier, ctx.cam, valid, g_xy, g_depth,
                       g_conic, g_rgb, want_ndc_offset=need[4])
        return (*(g if want else None for g, want in zip(grads, need[:5])),
                None, None, None, None, None, None, None)


@tracing.spanned("raster.preprocess")
def _prep_view(means3d, opacities, cam, grid, *, scales, rotations,
               cov3d_precomp, shs, sh_degree, colors_precomp, scale_modifier,
               ndc_offset, active_mask, config: RasterConfig):
    """Preprocess + tile-rect cull. Returns (pre, xy, rect_min, rect_max,
    valid); on ``_Preprocess``'s path ``pre.xy`` is ``xy``, the offset
    added. Counters ``raster.preprocess_fused`` and
    ``raster.preprocess_plain`` count the views the kernels and the plain
    ops served."""
    path = _preprocess_path(config, means3d, scales, rotations, shs,
                            cov3d_precomp, colors_precomp)
    tracing.count("raster.preprocess_fused" if path == "kernels"
                  else "raster.preprocess_plain")
    if path == "autograd":
        return _prep_plain(
            means3d, opacities, cam, grid, scales=scales, rotations=rotations,
            cov3d_precomp=cov3d_precomp, shs=shs, sh_degree=sh_degree,
            colors_precomp=colors_precomp, scale_modifier=scale_modifier,
            ndc_offset=ndc_offset, active_mask=active_mask)
    (xy, depth, conic, rgb, radius, rect_min, rect_max, pre_valid,
     valid) = _Preprocess.apply(
        means3d, scales, rotations, shs, ndc_offset, opacities, active_mask,
        cam, grid, sh_degree, scale_modifier, path == "kernels")
    pre = proj_lib.Preprocessed(xy=xy, depth=depth, conic=conic,
                                radius=radius, rgb=rgb, opacity=opacities,
                                valid=pre_valid)
    return pre, xy, rect_min, rect_max, valid


class CompositeInputs(NamedTuple):
    """One view (or B, from ``composite_inputs_batch``: a leading [B] on
    ``pre`` and ``valid``), preprocessed and binned: what the compositor
    takes."""

    pre: proj_lib.Preprocessed
    valid: torch.Tensor            # [N] bool: binned (in view, alive)
    bins: binning_lib.BinningResult
    grid: TileGrid
    args: tuple                    # positional args of the compositors


def composite_inputs(means3d, opacities, semantic_features, cam, *,
                     scales=None, rotations=None, cov3d_precomp=None, shs=None,
                     sh_degree=0, colors_precomp=None, scale_modifier=1.0,
                     ndc_offset=None, active_mask=None,
                     config: RasterConfig = RasterConfig()) -> CompositeInputs:
    """Preprocess and bin one view; ``args`` feeds ``raster_forward_cuda``
    and ``composite_plain`` alike."""
    grid = config.grid(cam.width, cam.height)
    pre, xy, rect_min, rect_max, valid = _prep_view(
        means3d, opacities, cam, grid, scales=scales, rotations=rotations,
        cov3d_precomp=cov3d_precomp, shs=shs, sh_degree=sh_degree,
        colors_precomp=colors_precomp, scale_modifier=scale_modifier,
        ndc_offset=ndc_offset, active_mask=active_mask, config=config)
    bins = binning_lib.bin_gaussians(
        rect_min, rect_max, pre.depth.detach(), valid, grid,
        instance_capacity=config.instance_capacity_or_default)
    tracing.count_tensor("raster.instances", bins.total)
    args = (xy.contiguous(), pre.conic.contiguous(),
            pre.opacity.contiguous(), pre.rgb.contiguous(),
            pre.depth.contiguous(), semantic_features.contiguous(),
            bins.gid_sorted, bins.tile_starts, bins.tile_counts, grid)
    return CompositeInputs(pre, valid, bins, grid, args)


def _use_kernels(config: RasterConfig, x: torch.Tensor) -> bool:
    """The one place the compositors are chosen: the kernels for every
    tensor that is not on the CPU (the kernel wrappers raise off CUDA)."""
    return not (config.backend == "plain"
                or (config.backend == "auto" and x.device.type == "cpu"))


class _Composite(torch.autograd.Function):
    """Forward and backward compositing of one view, a slice of its tile
    grid (``tile_base``) or B views' stacked grids (``n_per_camera``).
    Differentiable inputs: xy, conic, opacity, rgb, depth, feat;
    differentiable outputs: color, feature, depth and final_T
    (``color + final_T * bg`` needs its cotangent); n_contrib is not. The
    tiles' lists must cover gid_sorted exactly once, in order."""

    @staticmethod
    def forward(ctx, xy, conic, opacity, rgb, depth, feat, gid_sorted,
                tile_starts, tile_counts, grid, config, tile_base,
                n_per_camera):
        args = (xy, conic, opacity, rgb, depth, feat, gid_sorted,
                tile_starts, tile_counts, grid)
        where = dict(tile_base=tile_base, n_per_camera=n_per_camera)
        with tracing.span("raster.forward"):
            if _use_kernels(config, xy):
                out = raster_forward_cuda(*args, **where,
                                          alpha_matmul=config.alpha_matmul)
            else:
                out = composite_plain(*args, chunk=config.chunk, **where,
                                      alpha_matmul=config.alpha_matmul)
        ctx.grid, ctx.config, ctx.where = grid, config, where
        ctx.save_for_backward(xy, conic, opacity, rgb, depth, feat,
                              gid_sorted, tile_starts, tile_counts,
                              out.final_T, out.n_contrib)
        ctx.mark_non_differentiable(out.n_contrib)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_color, g_feat, g_depth, g_final_t, _g_ncontrib):
        (xy, conic, opacity, rgb, depth, feat, gid_sorted, tile_starts,
         tile_counts, final_t, n_contrib) = ctx.saved_tensors
        config = ctx.config
        n_tiles, p = final_t.shape
        shapes = ((n_tiles, p, 3), (n_tiles, p, feat.shape[-1]), (n_tiles, p),
                  (n_tiles, p))
        g_color, g_feat, g_depth, g_final_t = (
            torch.zeros(shape, dtype=final_t.dtype, device=final_t.device)
            if g is None else g.contiguous()
            for g, shape in zip((g_color, g_feat, g_depth, g_final_t), shapes))
        args = (xy, conic, opacity, rgb, depth, feat, gid_sorted,
                tile_starts, tile_counts, ctx.grid, g_color, g_feat, g_depth,
                g_final_t, final_t, n_contrib)
        with tracing.span("raster.backward"):
            if _use_kernels(config, xy):
                # the forward's wrapper checked these lists; binning lays
                # them out as the kernel's one-row-per-entry output needs
                rows = raster_backward_cuda(
                    *args, **ctx.where,
                    feature_alpha_grad=config.feature_alpha_grad,
                    alpha_matmul=config.alpha_matmul, check_lists=False)
            else:
                rows = composite_plain_backward(
                    *args, chunk=config.chunk, **ctx.where,
                    feature_alpha_grad=config.feature_alpha_grad,
                    alpha_matmul=config.alpha_matmul)
        # feature rows fold by Gaussian id into [N,F]; geometric rows by
        # (camera, id) = b * N + id into the [B*N] per-camera inputs
        with tracing.span("raster.segment_sum"):
            plan = SegmentPlan(gid_sorted, feat.shape[0])
            if ctx.where["n_per_camera"]:
                dg = SegmentPlan(camera_rows(
                    gid_sorted, tile_counts, ctx.where["n_per_camera"],
                    ctx.grid.num_tiles, ctx.where["tile_base"]),
                    xy.shape[0]).sum(rows.geom)
                d_feat = (plan.sum(rows.feature) if ctx.needs_input_grad[5]
                          else None)
            elif ctx.needs_input_grad[5]:
                # one plan for both: one kernel launch sums both
                d_feat, dg = plan.sums(rows.feature, rows.geom)
            else:
                dg, d_feat = plan.sum(rows.geom), None
        return (dg[:, 0:2], dg[:, 2:5], dg[:, 5], dg[:, 6:9], dg[:, 9],
                d_feat, None, None, None, None, None, None, None)


def composite(args: tuple, config: RasterConfig, *, tile_base: int = 0,
              n_per_camera: int = 0) -> CompositeOutput:
    """Differentiable compositing of ``composite_inputs(...).args``, or of
    ``composite_inputs_batch(...).args`` with ``n_per_camera`` = N (one
    forward and one backward launch for the B views). ``tile_base``: tile t
    of the lists is global tile ``tile_base + t`` (a slice of the grid)."""
    return CompositeOutput(*_Composite.apply(*args, config, tile_base,
                                             n_per_camera))


def rasterize(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    semantic_features: torch.Tensor,
    cam: proj_lib.CameraView,
    *,
    scales: torch.Tensor | None = None,
    rotations: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors_precomp: torch.Tensor | None = None,
    bg: torch.Tensor | None = None,
    scale_modifier=1.0,
    ndc_offset: torch.Tensor | None = None,
    active_mask: torch.Tensor | None = None,
    config: RasterConfig = RasterConfig(),
) -> RasterOutput:
    """Render RGB + semantic features + depth of one view, differentiably.

    Provide shs(+sh_degree) or colors_precomp, and scales+rotations or
    cov3d_precomp. ``semantic_features`` is [N, F]; ``bg`` is [3] (black
    by default)."""
    ci = composite_inputs(
        means3d, opacities, semantic_features, cam, scales=scales,
        rotations=rotations, cov3d_precomp=cov3d_precomp, shs=shs,
        sh_degree=sh_degree, colors_precomp=colors_precomp,
        scale_modifier=scale_modifier, ndc_offset=ndc_offset,
        active_mask=active_mask, config=config)
    out = composite(ci.args, config)

    grid = ci.grid
    if bg is None:
        bg = torch.zeros((3,), dtype=out.color.dtype, device=out.color.device)
    color = out.color + out.final_T[..., None] * bg
    radii = torch.where(ci.valid, ci.pre.radius,
                        torch.zeros_like(ci.pre.radius))
    counts = ci.bins.tile_counts
    return RasterOutput(
        color=tiles_to_image(color, grid),
        feature=tiles_to_image(out.feature, grid),
        depth=tiles_to_image(out.depth, grid),
        alpha=1.0 - tiles_to_image(out.final_T, grid),
        radii=radii,
        visibility=radii > 0,
        n_contrib=tiles_to_image(out.n_contrib, grid),
        total_instances=ci.bins.total,
        max_tile_count=(counts.max() if counts.numel()
                        else torch.zeros((), dtype=torch.int32,
                                         device=counts.device)),
        feature_tiles=out.feature,
    )


def _views(cams) -> list:
    """A stacked CameraView (tensor fields with a leading [B]) or a list of
    CameraViews -> a list of B same-resolution CameraViews."""
    if isinstance(cams, proj_lib.CameraView):
        cams = [proj_lib.CameraView(
            view=cams.view[b], proj=cams.proj[b], campos=cams.campos[b],
            tan_fovx=cams.tan_fovx[b], tan_fovy=cams.tan_fovy[b],
            width=cams.width, height=cams.height)
            for b in range(cams.view.shape[0])]
    cams = list(cams)
    if not cams:
        raise ValueError("rasterize_batch needs at least one view")
    if any((c.width, c.height) != (cams[0].width, cams[0].height)
           for c in cams):
        raise ValueError("rasterize_batch renders same-resolution views only")
    return cams


def composite_inputs_batch(means3d, opacities, semantic_features, cams, *,
                           scales=None, rotations=None, shs=None, sh_degree=0,
                           colors_precomp=None, scale_modifier=1.0,
                           ndc_offset=None, active_mask=None,
                           config: RasterConfig = RasterConfig()
                           ) -> CompositeInputs:
    """Preprocess B same-resolution views (a stacked CameraView or a list)
    one by one and bin them in one sort. ``pre`` and ``valid`` are stacked
    [B, N, ...]; ``args`` holds the splat arrays flattened to [B*N, ...] and
    the feature table [N,F] once, for ``raster_forward_cuda``,
    ``composite_plain`` and ``composite`` with ``n_per_camera`` = N.
    Differentiable: gradients of the flattened arrays reach each view's
    preprocess. ``ndc_offset`` [N,2] is added to every view's positions, so
    its gradient sums over the views."""
    views = _views(cams)
    n_cams, n = len(views), means3d.shape[0]
    grid = config.grid(views[0].width, views[0].height)
    preps = [_prep_view(
        means3d, opacities, cam, grid, scales=scales, rotations=rotations,
        cov3d_precomp=None, shs=shs, sh_degree=sh_degree,
        colors_precomp=colors_precomp, scale_modifier=scale_modifier,
        ndc_offset=ndc_offset, active_mask=active_mask, config=config)
        for cam in views]
    pre = proj_lib.Preprocessed(*(torch.stack(x) for x in zip(
        *(p[0] for p in preps))))
    xy, rect_min, rect_max, valid = (torch.stack([p[i] for p in preps])
                                     for i in (1, 2, 3, 4))
    bins = binning_lib.bin_gaussians_batch(
        rect_min, rect_max, pre.depth.detach(), valid, grid,
        instance_capacity=config.instance_capacity_or_default)
    tracing.count_tensor("raster.instances", bins.total)
    flat = lambda x: x.reshape((n_cams * n,) + x.shape[2:]).contiguous()
    args = (flat(xy), flat(pre.conic), flat(pre.opacity), flat(pre.rgb),
            flat(pre.depth), semantic_features.contiguous(), bins.gid_sorted,
            bins.tile_starts, bins.tile_counts, grid)
    return CompositeInputs(pre, valid, bins, grid, args)


def rasterize_batch(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    semantic_features: torch.Tensor,
    cams,
    *,
    scales: torch.Tensor | None = None,
    rotations: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors_precomp: torch.Tensor | None = None,
    bg: torch.Tensor | None = None,
    scale_modifier=1.0,
    active_mask: torch.Tensor | None = None,
    config: RasterConfig = RasterConfig(),
) -> RasterOutput:
    """Forward-only rendering of B same-resolution views in one pass (port
    of ``feature3dgs_tpu/ops/rasterize.py:rasterize_batch``).

    ``cams`` is a stacked CameraView (tensor fields [B, ...]) or a list of
    CameraViews. ``composite_inputs_batch`` preprocesses each view and bins
    all B in one sort into a camera-major list over B * T tiles; one
    ``composite`` call (``n_per_camera`` = N) composites them, as
    ``rasterize`` composites its view: one forward-kernel launch for CUDA
    tensors, the plain version for CPU tensors. The splat arrays are stacked to [B*N, ...];
    the feature table [N,F] is passed once and never copied per camera. The
    kernel addresses its outputs with 64-bit offsets, so a batch is never
    split into several launches.

    Image fields come back [B, ...]; radii and visibility [B,N];
    ``total_instances`` and ``max_tile_count`` are per camera ([B]), and
    ``instance_capacity`` holds for each camera alone. Every field is
    bit-equal to B ``rasterize`` calls with either compositor. No gradient:
    it runs under ``torch.no_grad()`` and raises if an input requires one
    while grad mode is on."""
    inputs = (means3d, opacities, semantic_features, scales, rotations, shs,
              colors_precomp)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in inputs):
        raise ValueError("rasterize_batch is forward-only: call it under "
                         "torch.no_grad() or with inputs that need no grad")
    with torch.no_grad():
        ci = composite_inputs_batch(
            means3d, opacities, semantic_features, cams, scales=scales,
            rotations=rotations, shs=shs, sh_degree=sh_degree,
            colors_precomp=colors_precomp, scale_modifier=scale_modifier,
            active_mask=active_mask, config=config)
        n_cams, grid = ci.valid.shape[0], ci.grid
        out = composite(ci.args, config, n_per_camera=means3d.shape[0])
        if bg is None:
            bg = torch.zeros((3,), dtype=out.color.dtype,
                             device=out.color.device)
        color = out.color + out.final_T[..., None] * bg
        img = lambda x: tiles_to_images(x, grid, n_cams)
        radii = torch.where(ci.valid, ci.pre.radius,
                            torch.zeros_like(ci.pre.radius))
        counts = ci.bins.tile_counts.reshape(n_cams, grid.num_tiles)
        return RasterOutput(
            color=img(color),
            feature=img(out.feature),
            depth=img(out.depth),
            alpha=1.0 - img(out.final_T),
            radii=radii,
            visibility=radii > 0,
            n_contrib=img(out.n_contrib),
            total_instances=ci.bins.total,
            max_tile_count=(counts.amax(1) if grid.num_tiles else
                            torch.zeros(n_cams, dtype=torch.int32,
                                        device=counts.device)),
            feature_tiles=out.feature.reshape(
                (n_cams, grid.num_tiles) + out.feature.shape[1:]),
        )
