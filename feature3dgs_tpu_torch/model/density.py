"""Adaptive density control, in PyTorch: densification statistics, clone /
split / prune, and the opacity reset.

Port of ``feature3dgs_tpu/model/density.py`` (the original
scene/gaussian_model.py:285-438 and train.py:129-140), with the JAX
package's fixed-capacity, free-slot layout, so that both packages' states
stay comparable row by row and their checkpoints interchangeable:
  * new Gaussians go into dead rows, in the order a stable argsort of
    ``alive`` lists them; clones first, then each split's pair;
  * clone: mean screen-space gradient >= threshold and largest scale <=
    percent_dense * extent; the row is copied verbatim;
  * split: gradient >= threshold and largest scale above that; two
    children drawn from the Gaussian (std = scale, rotated by the
    normalised quaternion), scales divided by 0.8 * 2, the parent removed;
    a pair that does not fit whole is dropped and its parent stays;
  * rows written get zero Adam moments; the step counter is kept;
  * prune: opacity < min_opacity and, under ``use_screen_size_prune``,
    largest scale > 0.1 * extent. The original's screen-radius prune never
    fires, because max_radii2D is zeroed before the prune mask is made
    (gaussian_model.py:377 before :427-431); that quirk is kept;
  * all densification statistics are zero after a round;
  * reset_opacity: opacity <- inverse_sigmoid(min(opacity, 0.01)), with the
    opacity group's Adam moments zeroed.

A round runs on the parameters' device with no host read: masked writes
are gathers through a source-row index built with ``index_copy_`` into a
dropped dummy row, ranks come from ``cumsum``, and the report is a tuple of
0-d tensors. The split noise is an argument (standard normal, [2, cap, 3]),
because no torch generator reproduces the JAX package's draw.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from feature3dgs_tpu_torch.core.projection import quat_to_rotmat
from feature3dgs_tpu_torch.model.gaussians import (GaussianParams,
                                                   GaussianState, get_opacity,
                                                   get_scaling,
                                                   inverse_sigmoid)
from feature3dgs_tpu_torch.model.optim import AdamState


class DensifyReport(NamedTuple):
    """Diagnostics of one round, 0-d tensors on the parameters' device.
    ``wanted_slots`` > ``granted_slots`` means the capacity overflowed: grow
    it (``gaussians.grow_capacity``) and go on."""

    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    wanted_slots: torch.Tensor
    granted_slots: torch.Tensor
    num_active: torch.Tensor


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


@torch.no_grad()
def densify_and_prune(params: GaussianParams, state: GaussianState,
                      adam: AdamState, noise: torch.Tensor, *,
                      max_grad: float, min_opacity: float, extent,
                      percent_dense: float, use_screen_size_prune: bool
                      ) -> tuple[GaussianParams, GaussianState, AdamState,
                                 DensifyReport]:
    """One clone / split / prune round; ``params``, ``state`` and ``adam``
    are updated in place (their fields are rebound to new tensors) and
    returned with the report. ``noise`` is standard normal [2, cap, 3];
    ``extent`` a float or a 0-d tensor."""
    cap = params.capacity
    dev = params.xyz.device
    if tuple(noise.shape) != (2, cap, 3):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"(2, {cap}, 3)")
    alive = state.alive
    grads = state.xyz_gradient_accum / torch.clamp_min(state.denom, 1e-20)
    grads = torch.where(state.denom > 0, grads, torch.zeros_like(grads))

    scaling = get_scaling(params)
    max_scale = scaling.amax(dim=-1)
    hot = alive & (grads >= max_grad)
    small = max_scale <= percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small

    # free-slot allocation
    n_clone = clone_mask.sum(dtype=torch.int32)
    n_split = split_mask.sum(dtype=torch.int32)
    wanted = n_clone + 2 * n_split
    slot_order = torch.argsort(alive.to(torch.int32), stable=True)  # free first
    n_free = (~alive).sum(dtype=torch.int32)
    granted = torch.minimum(wanted, n_free)

    def nth_free(r):
        # the r-th free slot, or cap (dropped) when there is none
        return torch.where(r < n_free, slot_order[r.clamp(0, cap - 1).long()],
                           cap)

    clone_tgt = nth_free(torch.cumsum(clone_mask, 0, dtype=torch.int32) - 1)
    split_rank = torch.cumsum(split_mask, 0, dtype=torch.int32) - 1
    child_a = nth_free(n_clone + 2 * split_rank)
    child_b = nth_free(n_clone + 2 * split_rank + 1)
    # children come in whole pairs; a pair that does not fit is dropped and
    # its parent stays alive
    pair_ok = split_mask & (child_a < cap) & (child_b < cap)

    # source[d] = the row written into slot d (d itself when none), kind[d]
    # = 0 for a copy, 1 / 2 for a split's first / second child; masked-out
    # writes land in the dummy slot cap. Sources are alive rows and targets
    # dead ones, so no write reads a row another write changed.
    rows = torch.arange(cap, device=dev)
    source = torch.arange(cap + 1, device=dev)
    kind = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    for which, (tgt, mask) in enumerate(((clone_tgt, clone_mask),
                                         (child_a, pair_ok),
                                         (child_b, pair_ok))):
        tgt = torch.where(mask, tgt, cap)
        source.index_copy_(0, tgt, rows)
        kind.index_fill_(0, tgt, which)
    source, kind = source[:cap], kind[:cap]
    written = source != rows

    rotation = params.rotation
    rotn = quat_to_rotmat(rotation / torch.clamp_min(
        torch.linalg.vector_norm(rotation, dim=-1, keepdim=True), 1e-12))
    samples = noise.to(scaling.dtype) * scaling[None]             # [2,cap,3]
    child_xyz = (torch.einsum("pij,npj->npi", rotn, samples)
                 + params.xyz[None])
    new_scaling = torch.log(scaling / (0.8 * 2.0))
    is_child = (kind > 0)[:, None]
    child_pos = torch.where((kind == 1)[:, None], child_xyz[0][source],
                            child_xyz[1][source])
    for name in GaussianParams.FIELDS:
        value = getattr(params, name)[source]
        if name == "xyz":
            value = torch.where(is_child, child_pos, value)
        elif name == "scaling":
            value = torch.where(is_child, new_scaling[source], value)
        setattr(params, name, value)
        for moments in (adam.mu, adam.nu):
            m = getattr(moments, name)
            m.masked_fill_(written.reshape((cap,) + (1,) * (m.dim() - 1)), 0)
    alive = (alive | written) & ~pair_ok

    prune = get_opacity(params) < min_opacity
    if use_screen_size_prune:
        prune = prune | (get_scaling(params).amax(dim=-1) > 0.1 * extent)
    num_pruned = (alive & prune).sum(dtype=torch.int32)
    alive = alive & ~prune

    state.alive = alive
    state.max_radii2d = torch.zeros_like(state.max_radii2d)
    state.xyz_gradient_accum = torch.zeros_like(state.xyz_gradient_accum)
    state.denom = torch.zeros_like(state.denom)
    report = DensifyReport(
        num_cloned=n_clone, num_split=n_split, num_pruned=num_pruned,
        wanted_slots=wanted, granted_slots=granted,
        num_active=alive.sum(dtype=torch.int32))
    return params, state, adam, report


@torch.no_grad()
def reset_opacity(params: GaussianParams, adam: AdamState
                  ) -> tuple[GaussianParams, AdamState]:
    """Cap every opacity at 0.01 and zero the opacity group's Adam moments
    (gaussian_model.py:231-234, 285-298); in place, the step is kept."""
    params.opacity.copy_(inverse_sigmoid(torch.clamp_max(
        torch.sigmoid(params.opacity), 0.01)))
    adam.mu.opacity.zero_()
    adam.nu.opacity.zero_()
    return params, adam
