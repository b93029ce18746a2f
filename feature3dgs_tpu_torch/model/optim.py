"""Per-group Adam and the learning-rate schedules, in PyTorch.

Port of ``feature3dgs_tpu/model/optim.py`` (the original
scene/gaussian_model.py:163-190 and utils/general_utils.py:29-62): one Adam
group per GaussianParams field with its own learning rate, eps 1e-15, the
log-linear xyz decay with an optional sin delay ramp, one shared step
counter, and a plain Adam (eps 1e-8) for the speed-up decoder. The update
is torch.optim.Adam's: p -= lr * mhat / (sqrt(nhat) + eps).

Unlike the JAX package, whose pytrees are immutable, the updates here write
parameters, moments and the step counter in place (no second copy of the
optimizer state), under ``torch.no_grad``. The ``keep`` gate of
``adam_update`` (the trainer's non-finite-loss guard) is read on the
device, so it costs no host sync.

The update goes by the tensors' device. CUDA tensors take one launch of
the fused kernel a group (ops/cuda_adam.py, ops/csrc/adam.cu: every tensor
read and written once, nothing allocated) and the counter is advanced
after it; CPU tensors take ``_adam_``, plain elementwise ops, which is also
the kernel's bit-for-bit oracle on the card. Counters
``optim.adam_fused`` and ``optim.adam_plain`` count the tensors each path
updated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device, tracing
from feature3dgs_tpu_torch.model.gaussians import GaussianParams
from feature3dgs_tpu_torch.ops import cuda_adam


@dataclasses.dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    step: torch.Tensor  # scalar int32


@dataclasses.dataclass
class TensorAdamState:
    mu: dict
    nu: dict
    step: torch.Tensor  # scalar int32


@dataclasses.dataclass(frozen=True)
class LRConfig:
    """Learning rates (the original arguments/__init__.py:74-95)."""

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_steps: int = 0
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    semantic_feature_lr: float = 0.001


def expon_lr(step: int, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """Log-linear decay with an optional sin delay ramp, in float32 as the
    JAX package computes it; ``step`` is a host integer."""
    f32 = np.float32
    step = f32(step)
    if lr_delay_steps > 0:
        delay = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0),
                                       f32(1)))
    else:
        delay = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    return float(f32(delay * log_lerp))


def xyz_lr(cfg: LRConfig, step: int, spatial_lr_scale: float) -> float:
    return expon_lr(step, cfg.position_lr_init * spatial_lr_scale,
                    cfg.position_lr_final * spatial_lr_scale,
                    lr_delay_steps=cfg.position_lr_delay_steps,
                    lr_delay_mult=cfg.position_lr_delay_mult,
                    max_steps=cfg.position_lr_max_steps)


def group_lrs(cfg: LRConfig, step, spatial_lr_scale: float) -> dict:
    """Per-field learning rates (floats) at one iteration, or summed over a
    span of B iterations when ``step`` is a sequence (the batched trainer's
    one Adam update per B camera-iterations: the linear-scaling rule of
    ``feature3dgs_tpu/model/optim.py:group_lrs``). The xyz rate is summed
    in float32 in span order; every other rate is B times its own. A scalar
    step gives the one-iteration values."""
    if np.ndim(step) == 0:
        xyz, b = xyz_lr(cfg, step, spatial_lr_scale), 1
    else:
        b, xyz = len(step), np.float32(0)
        for s in step:
            xyz = np.float32(xyz + np.float32(xyz_lr(cfg, s, spatial_lr_scale)))
        xyz = float(xyz)
    return {"xyz": xyz,
            "features_dc": b * cfg.feature_lr,
            "features_rest": b * cfg.feature_lr / 20.0,
            "scaling": b * cfg.scaling_lr,
            "rotation": b * cfg.rotation_lr,
            "opacity": b * cfg.opacity_lr,
            "semantic_feature": b * cfg.semantic_feature_lr}


def _zeros_on(tensors: dict, device) -> dict:
    device = default_device(device)
    for name, x in tensors.items():
        # "cuda" names the current card, which a tensor reports as cuda:N
        if x.device.type != device.type or device.index not in (
                None, x.device.index):
            raise ValueError(f"{name} is on {x.device}, expected {device}")
    return {k: torch.zeros_like(x) for k, x in tensors.items()}


def _fields(p: GaussianParams) -> dict:
    return {k: getattr(p, k) for k in GaussianParams.FIELDS}


def init_adam(params: GaussianParams, device=None) -> AdamState:
    """Zero moments and step for ``params``, which must lie on
    ``default_device(device)``."""
    mu = _zeros_on(_fields(params), device)
    nu = {k: torch.zeros_like(x) for k, x in mu.items()}
    step = torch.zeros((), dtype=torch.int32, device=params.xyz.device)
    return AdamState(GaussianParams(**mu), GaussianParams(**nu), step)


def init_tensor_adam(params: dict, device=None) -> TensorAdamState:
    mu = _zeros_on(params, device)
    nu = {k: torch.zeros_like(x) for k, x in mu.items()}
    step = torch.zeros((), dtype=torch.int32, device=next(iter(mu.values())).device)
    return TensorAdamState(mu, nu, step)


def _adam_(params: dict, grads: dict, mu: dict, nu: dict, step: torch.Tensor,
           lrs, b1: float, b2: float, eps: float, keep):
    """One bias-corrected Adam step over every tensor, in place."""
    new_step = step + 1
    t = new_step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    for k, p in params.items():
        g = grads[k]
        m = b1 * mu[k] + (1 - b1) * g
        n = b2 * nu[k] + (1 - b2) * g * g
        new_p = p - lrs[k] * (m / c1) / (torch.sqrt(n / c2) + eps)
        if keep is not None:
            m = torch.where(keep, m, mu[k])
            n = torch.where(keep, n, nu[k])
            new_p = torch.where(keep, new_p, p)
        mu[k].copy_(m)
        nu[k].copy_(n)
        p.copy_(new_p)
    step.copy_(new_step if keep is None
               else torch.where(keep, new_step, step))


def _adam_by_device(params: dict, grads: dict, mu: dict, nu: dict,
                    step: torch.Tensor, lrs, b1: float, b2: float, eps: float,
                    keep):
    """``_adam_``'s step by the parameters' device: CUDA tensors in one
    kernel launch, whose blocks read the counter, which is advanced after
    it on the same stream; CPU tensors by ``_adam_``."""
    if next(iter(params.values())).device.type == "cuda":
        cuda_adam.adam_cuda_(params, grads, mu, nu, step, lrs, keep, b1=b1,
                             b2=b2, eps=eps)
        step.add_(1 if keep is None else keep)
        tracing.count("optim.adam_fused", len(params))
    else:
        _adam_(params, grads, mu, nu, step, lrs, b1, b2, eps, keep)
        tracing.count("optim.adam_plain", len(params))


@torch.no_grad()
def adam_update(params: GaussianParams, grads: GaussianParams,
                state: AdamState, lrs: dict, *, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15,
                keep: torch.Tensor | None = None):
    """One Adam step of every field, in place; returns (params, state).
    ``keep`` (scalar bool tensor): where False, parameters, moments and the
    step counter stay as they were, with no host sync."""
    _adam_by_device(_fields(params), _fields(grads), _fields(state.mu),
                    _fields(state.nu), state.step, lrs, b1, b2, eps, keep)
    return params, state


@torch.no_grad()
def tensor_adam_update(params: dict, grads: dict, state: TensorAdamState,
                       lr: float, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, keep: torch.Tensor | None = None):
    """Plain Adam over a dict of tensors (the decoder), in place; ``keep``
    as in ``adam_update``. Returns (params, state)."""
    _adam_by_device(params, grads, state.mu, state.nu, state.step,
                    dict.fromkeys(params, lr), b1, b2, eps, keep)
    return params, state
