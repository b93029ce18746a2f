"""Gaussian scene PLY snapshots in the original schema.

Port of ``feature3dgs_tpu/model/ply_io.py``. Field order and names match
construct_list_of_attributes (scene/gaussian_model.py:192-229): x y z,
nx ny nz (zeros), f_dc_{0..2}, f_rest_{...} (channel-major: the [M-1, 3]
block is transposed to [3, M-1] then flattened), opacity, scale_{0..2},
rot_{0..3}, semantic_{0..F-1}. Files written here load in the JAX package
and the original code, and the other way round.
"""
from __future__ import annotations

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device
from feature3dgs_tpu_torch.data.ply import read_ply, write_ply
from feature3dgs_tpu_torch.model.gaussians import GaussianParams, GaussianState


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu").numpy()


def save_gaussians_ply(path: str, params: GaussianParams,
                       state: GaussianState | None = None):
    keep = (_np(state.alive).astype(bool) if state is not None
            else np.ones((params.capacity,), bool))
    xyz = _np(params.xyz)[keep]
    n = xyz.shape[0]
    f_dc = _np(params.features_dc)[keep]          # [n,1,3]
    f_rest = _np(params.features_rest)[keep]      # [n,M-1,3]
    opacity = _np(params.opacity)[keep][:, 0]
    scaling = _np(params.scaling)[keep]
    rotation = _np(params.rotation)[keep]
    sem = _np(params.semantic_feature)[keep]      # [n,1,F]

    fields: dict[str, np.ndarray] = {}
    for i, ax in enumerate("xyz"):
        fields[ax] = xyz[:, i].astype(np.float32)
    for ax in ("nx", "ny", "nz"):
        fields[ax] = np.zeros(n, np.float32)
    dc_t = f_dc.transpose(0, 2, 1).reshape(n, -1)
    for i in range(dc_t.shape[1]):
        fields[f"f_dc_{i}"] = dc_t[:, i].astype(np.float32)
    rest_t = f_rest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest_t.shape[1]):
        fields[f"f_rest_{i}"] = rest_t[:, i].astype(np.float32)
    fields["opacity"] = opacity.astype(np.float32)
    for i in range(scaling.shape[1]):
        fields[f"scale_{i}"] = scaling[:, i].astype(np.float32)
    for i in range(rotation.shape[1]):
        fields[f"rot_{i}"] = rotation[:, i].astype(np.float32)
    sem_t = sem.transpose(0, 2, 1).reshape(n, -1)
    for i in range(sem_t.shape[1]):
        fields[f"semantic_{i}"] = sem_t[:, i].astype(np.float32)
    write_ply(path, fields)


def _numbered(cols: dict, prefix: str) -> list[str]:
    return sorted((k for k in cols if k.startswith(prefix)),
                  key=lambda s: int(s.split("_")[-1]))


def load_gaussians_ply(path: str, *, max_sh_degree: int = 3,
                       capacity: int | None = None, device=None
                       ) -> tuple[GaussianParams, GaussianState]:
    """Load a PLY in the original schema (gaussian_model.py:236-281), with
    active_sh_degree = max_sh_degree as the original loader sets it.
    Tensors land on ``default_device(device)``."""
    device = default_device(device)
    cols = read_ply(path)
    n = cols["x"].shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n}")

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    opacity = cols["opacity"][:, None]
    dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1)   # [n,3]
    m = (max_sh_degree + 1) ** 2
    rest_names = _numbered(cols, "f_rest_")
    if len(rest_names) != 3 * (m - 1):
        raise ValueError(
            f"{path}: expected {3 * (m - 1)} f_rest fields, got {len(rest_names)}")
    rest = np.stack([cols[k] for k in rest_names], axis=1).reshape(n, 3, m - 1)
    sem_names = _numbered(cols, "semantic_")
    sem = (np.stack([cols[k] for k in sem_names], axis=1)[:, None, :]
           if sem_names else np.zeros((n, 1, 0), np.float32))
    scaling = np.stack([cols[k] for k in _numbered(cols, "scale_")], axis=1)
    rotation = np.stack([cols[k] for k in _numbered(cols, "rot_")], axis=1)

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(device)

    params = GaussianParams(
        xyz=pad(xyz),
        features_dc=pad(dc[:, None, :]),
        features_rest=pad(rest.transpose(0, 2, 1)),
        scaling=pad(scaling),
        rotation=pad(rotation),
        opacity=pad(opacity),
        semantic_feature=pad(sem))
    alive = torch.zeros((cap,), dtype=torch.bool, device=device)
    alive[:n] = True
    return params, GaussianState.fresh(alive, active_sh_degree=max_sh_degree)
