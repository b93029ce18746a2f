"""Gaussian scene parameters as tensors.

Port of ``feature3dgs_tpu/model/gaussians.py``. Parameter layout matches the
original model (scene/gaussian_model.py): xyz [P,3]; features_dc [P,1,3];
features_rest [P,M-1,3] (M = (max_sh_degree+1)^2); scaling [P,3] log-space;
rotation [P,4] unnormalized quaternions; opacity [P,1] logit-space;
semantic_feature [P,1,F]. Arrays may be padded to a capacity; ``alive``
marks real rows, and dead rows render with opacity 0 and are culled before
binning.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device
from feature3dgs_tpu_torch.core.sh import num_sh_coeffs, rgb_to_sh_dc


@dataclasses.dataclass
class GaussianParams:
    """The seven learnable groups (gaussian_model.py:168-176)."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    semantic_feature: torch.Tensor

    FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "semantic_feature")

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        return int(round((1 + self.features_rest.shape[1]) ** 0.5)) - 1

    @property
    def feature_dim(self) -> int:
        return self.semantic_feature.shape[-1]


@dataclasses.dataclass
class GaussianState:
    """Non-learnable state: liveness and the densification statistics."""

    alive: torch.Tensor               # [P] bool
    max_radii2d: torch.Tensor         # [P]
    xyz_gradient_accum: torch.Tensor  # [P]
    denom: torch.Tensor               # [P]
    active_sh_degree: int = 0
    spatial_lr_scale: float = 1.0

    @property
    def num_active(self) -> int:
        return int(self.alive.sum())

    @classmethod
    def fresh(cls, alive: torch.Tensor, active_sh_degree: int = 0,
              spatial_lr_scale: float = 1.0) -> "GaussianState":
        z = torch.zeros(alive.shape, dtype=torch.float32, device=alive.device)
        return cls(alive=alive, max_radii2d=z, xyz_gradient_accum=z.clone(),
                   denom=z.clone(), active_sh_degree=active_sh_degree,
                   spatial_lr_scale=spatial_lr_scale)


# activations (gaussian_model.py:26-41)

def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    # rsqrt of the square norm clamped at 1e-24: all-zero padding rows stay
    # finite (a plain norm divides 0 by 0 there)
    sq = torch.sum(p.rotation * p.rotation, dim=-1, keepdim=True)
    return p.rotation * torch.rsqrt(torch.clamp_min(sq, 1e-24))


def get_opacity(p: GaussianParams, alive: torch.Tensor | None = None
                ) -> torch.Tensor:
    op = torch.sigmoid(p.opacity[:, 0])
    if alive is not None:
        op = torch.where(alive, op, torch.zeros_like(op))
    return op


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def get_features(p: GaussianParams) -> torch.Tensor:
    """[P, M, 3] full SH coefficient stack (DC first)."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def get_semantic(p: GaussianParams) -> torch.Tensor:
    """[P, F] flattened semantic feature vectors."""
    return p.semantic_feature[:, 0, :]


def create_from_pcd(points: np.ndarray, colors: np.ndarray, *,
                    knn_mean_dists: np.ndarray | None = None,
                    max_sh_degree: int = 3,
                    feature_dim: int = 128, speedup: bool = False,
                    capacity: int | None = None, device=None
                    ) -> tuple[GaussianParams, GaussianState]:
    """Initialize from a point cloud (gaussian_model.py:133-160): scale =
    log sqrt(mean squared 3-NN distance, clamped at 1e-7), identity
    quaternions, opacity inverse_sigmoid(0.1), SH DC from RGB with higher
    bands zero, zero semantic features (F/4 of them under the speed-up
    decoder). ``knn_mean_dists`` defaults to ``ops.knn.mean_sq_dist_3nn`` of
    the points. Tensors land on ``default_device(device)``."""
    device = default_device(device)
    n = points.shape[0]
    capacity = n if capacity is None else capacity
    if capacity < n:
        raise ValueError(f"capacity {capacity} < number of points {n}")
    if speedup:
        feature_dim = feature_dim // 4
    m = num_sh_coeffs(max_sh_degree)
    if knn_mean_dists is None:
        from feature3dgs_tpu_torch.ops.knn import mean_sq_dist_3nn
        knn_mean_dists = mean_sq_dist_3nn(points)
    dist2 = np.maximum(np.asarray(knn_mean_dists), 1e-7)

    def pad(x):
        out = np.zeros((capacity,) + x.shape[1:], dtype=np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(device)

    scales = np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    dc = rgb_to_sh_dc(colors.astype(np.float32))[:, None, :]
    params = GaussianParams(
        xyz=pad(points.astype(np.float32)),
        features_dc=pad(dc),
        features_rest=pad(np.zeros((n, m - 1, 3), np.float32)),
        scaling=pad(scales.astype(np.float32)),
        rotation=pad(rots),
        opacity=pad(np.full((n, 1), float(np.log(0.1 / 0.9)), np.float32)),
        semantic_feature=pad(np.zeros((n, 1, feature_dim), np.float32)))
    alive = torch.zeros((capacity,), dtype=torch.bool, device=device)
    alive[:n] = True
    return params, GaussianState.fresh(alive)


def _pad_rows(x: torch.Tensor, new_capacity: int) -> torch.Tensor:
    pad = torch.zeros((new_capacity - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def grow_params(params: GaussianParams, new_capacity: int) -> GaussianParams:
    """``params`` (or Adam moments of that shape) padded with zero rows to
    ``new_capacity``; new tensors, the old ones are left alone."""
    return GaussianParams(**{k: _pad_rows(getattr(params, k), new_capacity)
                             for k in GaussianParams.FIELDS})


def grow_capacity(params: GaussianParams, state: GaussianState,
                  new_capacity: int, opt_state: GaussianParams | None = None):
    """Pad every array to a larger capacity (parameters, statistics and
    Adam moments with zeros, ``alive`` with False). Returns (params, state)
    or, given one tree of Adam moments, (params, state, opt_state). There is
    nothing to recompile on this side: growth is a reallocation, and every
    tensor that aliased the old ones must be taken from the result."""
    if new_capacity <= params.capacity:
        return ((params, state) if opt_state is None
                else (params, state, opt_state))
    new_state = dataclasses.replace(
        state, **{k: _pad_rows(getattr(state, k), new_capacity)
                  for k in ("alive", "max_radii2d", "xyz_gradient_accum",
                            "denom")})
    new_params = grow_params(params, new_capacity)
    if opt_state is None:
        return new_params, new_state
    return new_params, new_state, grow_params(opt_state, new_capacity)


def one_up_sh_degree(state: GaussianState, max_degree: int) -> GaussianState:
    """Raise the active SH degree by one, up to ``max_degree``; in place."""
    if state.active_sh_degree < max_degree:
        state.active_sh_degree += 1
    return state
