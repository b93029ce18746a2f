"""Densification statistics, in PyTorch.

Port of ``feature3dgs_tpu/model/density.py:add_densification_stats`` (the
original train.py:130-133). Clone, split, prune and the opacity reset come
with the host training loop.
"""
from __future__ import annotations

import torch

from feature3dgs_tpu_torch.model.gaussians import GaussianState


@torch.no_grad()
def add_densification_stats(state: GaussianState, ndc_grad: torch.Tensor,
                            visibility: torch.Tensor, radii: torch.Tensor,
                            keep: torch.Tensor | None = None) -> GaussianState:
    """Accumulate the screen-space gradient norm of every Gaussian that is
    visible and alive, count it, and keep its largest radius; in place.
    ``keep`` (scalar bool tensor): where False, nothing changes (the
    trainer's non-finite guard), with no host sync."""
    norm = torch.linalg.vector_norm(ndc_grad[:, :2], dim=-1)
    vis = visibility & state.alive
    if keep is not None:
        vis = vis & keep
    state.xyz_gradient_accum.add_(torch.where(vis, norm, torch.zeros_like(norm)))
    state.denom.add_(vis.to(state.denom.dtype))
    state.max_radii2d.copy_(torch.where(
        vis, torch.maximum(state.max_radii2d, radii), state.max_radii2d))
    return state
