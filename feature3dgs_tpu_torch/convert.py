"""Carry weights, training state and cameras across from numpy.

The JAX package's parameters, decoder, training state and cameras, taken
to numpy, become the port's tensors here, so both packages can compute the
same thing (the parity tests do exactly that). Tensors land on
``default_device(device)``.
"""
from __future__ import annotations

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device, tracing
from feature3dgs_tpu_torch.core.projection import CameraView
from feature3dgs_tpu_torch.model.gaussians import GaussianParams, GaussianState
from feature3dgs_tpu_torch.model.optim import AdamState, TensorAdamState
from feature3dgs_tpu_torch.train.trainer import TrainState


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def gaussians_from_numpy(fields: dict[str, np.ndarray], alive: np.ndarray,
                         active_sh_degree: int, device=None
                         ) -> tuple[GaussianParams, GaussianState]:
    """``fields`` holds the seven GaussianParams arrays by name."""
    device = default_device(device)
    missing = set(GaussianParams.FIELDS) - set(fields)
    if missing:
        raise KeyError(f"missing Gaussian fields: {sorted(missing)}")
    params = GaussianParams(**{k: _f32(fields[k], device)
                               for k in GaussianParams.FIELDS})
    alive_t = torch.from_numpy(np.asarray(alive, bool).copy()).to(device)
    if alive_t.shape != (params.capacity,):
        raise ValueError(f"alive has shape {tuple(alive_t.shape)}, expected "
                         f"({params.capacity},)")
    return params, GaussianState.fresh(alive_t, active_sh_degree)


def train_state_from_numpy(state: dict, device=None) -> TrainState:
    """A TrainState from numpy: ``state["params"]`` holds the seven
    GaussianParams arrays; ``state["gstate"]`` alive, max_radii2d,
    xyz_gradient_accum, denom, active_sh_degree and spatial_lr_scale;
    ``state["adam"]`` {"mu": fields, "nu": fields, "step"}; and, for the
    speed-up decoder, ``state["decoder"]`` {"w", "b"} and
    ``state["decoder_adam"]`` {"mu", "nu", "step"} (absent or None
    otherwise)."""
    device = default_device(device)
    gs = state["gstate"]
    params, gstate = gaussians_from_numpy(
        state["params"], gs["alive"], int(gs["active_sh_degree"]), device)
    for k in ("max_radii2d", "xyz_gradient_accum", "denom"):
        setattr(gstate, k, _f32(gs[k], device))
    gstate.spatial_lr_scale = float(gs["spatial_lr_scale"])

    def step(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=device)

    def fields(d):
        return GaussianParams(**{k: _f32(d[k], device)
                                 for k in GaussianParams.FIELDS})

    adam = AdamState(fields(state["adam"]["mu"]), fields(state["adam"]["nu"]),
                     step(state["adam"]["step"]))
    decoder = dec_adam = None
    if state.get("decoder") is not None:
        decoder = decoder_from_numpy(state["decoder"], device)
        da = state["decoder_adam"]
        dec_adam = TensorAdamState(decoder_from_numpy(da["mu"], device),
                                   decoder_from_numpy(da["nu"], device),
                                   step(da["step"]))
    return TrainState(params, gstate, adam, decoder, dec_adam)


def decoder_from_numpy(params: dict[str, np.ndarray], device=None) -> dict:
    device = default_device(device)
    return {"w": _f32(params["w"], device), "b": _f32(params["b"], device)}


def camera_from_numpy(view, proj, campos, tan_fovx, tan_fovy, width: int,
                      height: int, device=None) -> CameraView:
    device = default_device(device)
    tracing.count("host_wait.camera_upload", 5)
    # the preprocess kernels read the camera row-major; a viewer's matrices
    # may arrive transposed
    row_major = lambda x: _f32(np.ascontiguousarray(x), device)
    return CameraView(
        view=row_major(view), proj=row_major(proj),
        campos=row_major(campos),
        tan_fovx=_f32(np.float32(tan_fovx), device),
        tan_fovy=_f32(np.float32(tan_fovy), device),
        width=int(width), height=int(height))


def encoder_state_from_numpy(arrays: dict[str, np.ndarray], device=None
                             ) -> dict[str, torch.Tensor]:
    """A state dict on ``default_device(device)`` from numpy arrays by key,
    dtypes kept (the encoders' keys are the same in both packages; each
    port encoder loads it with ``strict=True``)."""
    device = default_device(device)
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in arrays.items()}
