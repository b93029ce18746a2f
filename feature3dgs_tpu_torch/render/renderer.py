"""High-level render binding: GaussianParams -> rasterizer.

Port of ``feature3dgs_tpu/render/renderer.py:render`` (the original
gaussian_renderer/__init__.py:173-261): applies the activations, selects
the SH or precomputed-color path, optionally builds cov3D or converts SH
outside the rasterizer, and calls ``rasterize``; ``render_batch`` renders
B same-resolution views forward-only through ``rasterize_batch``. Dead rows
(``alive`` false) get opacity 0 and are culled before binning.
"""
from __future__ import annotations

import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.core import sh as sh_lib
from feature3dgs_tpu_torch.core.projection import CameraView, build_cov3d
from feature3dgs_tpu_torch.model import gaussians as G
from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig, RasterOutput,
                                                 rasterize, rasterize_batch)


@tracing.spanned("render")
def render(
    params: G.GaussianParams,
    state: G.GaussianState,
    cam: CameraView,
    *,
    bg: torch.Tensor | None = None,
    config: RasterConfig = RasterConfig(),
    scaling_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    override_opacity: torch.Tensor | None = None,
    override_sh: torch.Tensor | None = None,
    convert_shs_outside: bool = False,
    compute_cov3d_outside: bool = False,
    ndc_offset: torch.Tensor | None = None,
) -> RasterOutput:
    opacity = (override_opacity if override_opacity is not None
               else G.get_opacity(params))
    opacity = torch.where(state.alive, opacity, torch.zeros_like(opacity))

    scales = rotations = cov3d = None
    if compute_cov3d_outside:
        cov3d = build_cov3d(G.get_scaling(params), G.get_rotation(params),
                            scaling_modifier)
    else:
        scales = G.get_scaling(params)
        rotations = G.get_rotation(params)

    shs = colors = None
    if override_color is not None:
        colors = override_color
    else:
        sh_stack = (override_sh if override_sh is not None
                    else G.get_features(params))
        if convert_shs_outside:
            colors = sh_lib.sh_to_rgb(state.active_sh_degree, sh_stack,
                                      params.xyz, cam.campos)
        else:
            shs = sh_stack

    return rasterize(
        params.xyz, opacity, G.get_semantic(params), cam,
        scales=scales, rotations=rotations, cov3d_precomp=cov3d,
        shs=shs, sh_degree=state.active_sh_degree, colors_precomp=colors,
        bg=bg, scale_modifier=scaling_modifier, ndc_offset=ndc_offset,
        active_mask=state.alive, config=config)


@tracing.spanned("render")
def render_batch(
    params: G.GaussianParams,
    state: G.GaussianState,
    cams,
    *,
    bg: torch.Tensor | None = None,
    config: RasterConfig = RasterConfig(),
    scaling_modifier: float = 1.0,
    override_opacity: torch.Tensor | None = None,
) -> RasterOutput:
    """Forward-only render of B same-resolution views (a stacked CameraView
    or a list), the activations applied once (port of
    ``feature3dgs_tpu/render/renderer.py:render_batch``). Image fields come
    back with a leading [B] axis, the overflow counters per camera; each
    view equals ``render`` of that view bit for bit."""
    opacity = (override_opacity if override_opacity is not None
               else G.get_opacity(params))
    opacity = torch.where(state.alive, opacity, torch.zeros_like(opacity))
    return rasterize_batch(
        params.xyz, opacity, G.get_semantic(params), cams,
        scales=G.get_scaling(params), rotations=G.get_rotation(params),
        shs=G.get_features(params), sh_degree=state.active_sh_degree,
        bg=bg, scale_modifier=scaling_modifier, active_mask=state.alive,
        config=config)
