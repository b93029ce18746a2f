"""Training: the optimisation step and the host loop, in PyTorch.

Port of ``feature3dgs_tpu/train/trainer.py`` (the original
train.py:36-178). ``train_step``: render -> losses -> backward -> Adam ->
densification statistics. ``Trainer``: the host loop around it, with the
schedule-driven events between steps: the SH degree rises every 1000
iterations, densify / prune every ``densification_interval`` inside the
densify window, the opacity reset every ``opacity_reset_interval``, and
capacities grow when a round or the binning overflows. Loss
(train.py:98-105):
  (1 - λ)·L1(rgb) + λ·(1 - SSIM(rgb)) + feature_loss_weight·L1(feature)
with the rendered feature map bilinearly resized (align_corners=True) to
the teacher map, optionally lifted by the speed-up decoder.

The step updates the ``TrainState`` tensors in place under
``torch.no_grad()``. A non-finite loss discards the whole update (params,
Adam moments and step, densification statistics, decoder and its Adam) on
the device, with no host sync. ``Trainer.step(sync=False)`` reads nothing
from the device either: densify reports queue up and are folded in one host
read at the next sync point.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
from typing import TYPE_CHECKING

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device, tracing
from feature3dgs_tpu_torch.core.projection import CameraView
from feature3dgs_tpu_torch.model import density, optim
from feature3dgs_tpu_torch.model import gaussians as G
from feature3dgs_tpu_torch.model.decoder import apply_decoder, init_decoder
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.render import renderer
from feature3dgs_tpu_torch.train import losses as L

if TYPE_CHECKING:   # data.cameras imports convert, which imports this module
    from feature3dgs_tpu_torch.data.dataset import SceneData


# the speed-up decoder's Adam learning rate (the original's fixed 1e-4)
DECODER_LR = 1e-4


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """The original OptimizationParams (arguments/__init__.py:74-95)."""

    iterations: int = 30_000
    lr: optim.LRConfig = optim.LRConfig()
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    feature_loss_weight: float = 1.0


@dataclasses.dataclass
class TrainState:
    params: G.GaussianParams
    gstate: G.GaussianState
    adam: optim.AdamState
    decoder: dict | None = None
    decoder_adam: optim.TensorAdamState | None = None

    @classmethod
    def create(cls, params: G.GaussianParams, gstate: G.GaussianState,
               decoder: dict | None = None, device=None) -> "TrainState":
        """Fresh Adam states for ``params`` (and the decoder), which must
        lie on ``default_device(device)``."""
        device = default_device(device)
        return cls(params=params, gstate=gstate,
                   adam=optim.init_adam(params, device),
                   decoder=decoder,
                   decoder_adam=(None if decoder is None
                                 else optim.init_tensor_adam(decoder, device)))


def step_leaves(ts: TrainState, speedup: bool):
    """What a step differentiates: (the parameters as leaves that alias the
    stored tensors, which are then updated in place; a zero NDC offset
    [capacity, 2], whose gradient feeds the densification statistics; the
    decoder's tensors as leaves, or None without ``speedup``)."""
    params = ts.params
    leaves = G.GaussianParams(**{k: getattr(params, k).detach().requires_grad_()
                                 for k in G.GaussianParams.FIELDS})
    ndc_offset = torch.zeros((params.capacity, 2), dtype=torch.float32,
                             device=params.xyz.device, requires_grad=True)
    dec = None
    if speedup:
        dec = {k: v.detach().requires_grad_() for k, v in ts.decoder.items()}
    return leaves, ndc_offset, dec


def step_grads(loss: torch.Tensor, leaves: G.GaussianParams, ndc_offset,
               dec: dict | None) -> list:
    """The gradients of ``loss`` with respect to ``step_leaves``' leaves,
    flat: the parameter fields in ``GaussianParams.FIELDS`` order, the NDC
    offset, then the decoder's w and b; zeros where the loss does not reach
    a leaf."""
    inputs = [getattr(leaves, k) for k in G.GaussianParams.FIELDS] + [ndc_offset]
    if dec is not None:
        inputs += [dec["w"], dec["b"]]
    with tracing.span("train.backward"):
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, grads)]


@torch.no_grad()
def step_update(ts: TrainState, grads: list, visibility, radii, finite,
                iteration, *, ocfg: OptimizationConfig, speedup: bool) -> None:
    """The step's update of ``ts`` in place from ``step_grads``' list: Adam
    over the parameters at ``group_lrs(iteration)`` (an iteration, or the
    span of a batch), the decoder's Adam, and the densification statistics
    from the NDC gradient, ``visibility`` and ``radii``; where the 0-d bool
    ``finite`` is False nothing is written."""
    n_fields = len(G.GaussianParams.FIELDS)
    with tracing.span("optim.adam"):
        optim.adam_update(ts.params, G.GaussianParams(*grads[:n_fields]),
                          ts.adam, optim.group_lrs(ocfg.lr, iteration,
                                                   ts.gstate.spatial_lr_scale),
                          keep=finite)
        if speedup:
            optim.tensor_adam_update(
                ts.decoder, dict(w=grads[-2], b=grads[-1]), ts.decoder_adam,
                lr=DECODER_LR, keep=finite)
    density.add_densification_stats(ts.gstate, grads[n_fields], visibility,
                                    radii, keep=finite)


def train_step(ts: TrainState, cam: CameraView, gt_image: torch.Tensor,
               gt_feature: torch.Tensor, bg: torch.Tensor, iteration: int, *,
               ocfg: OptimizationConfig, rcfg: RasterConfig, speedup: bool
               ) -> dict:
    """One step on view ``cam``: gt_image [H,W,3], gt_feature [h,w,F_out]
    (fp16 maps are upcast), bg [3], ``iteration`` 1-based (the xyz
    learning rate). Updates ``ts`` in place and returns a dict of scalar
    tensors (no host sync): finite, loss, l1, l1_feature, num_instances,
    max_tile_count, num_active, psnr."""
    leaves, ndc_offset, dec = step_leaves(ts, speedup)
    out = renderer.render(leaves, ts.gstate, cam, bg=bg, config=rcfg,
                          ndc_offset=ndc_offset)
    rgb, ll1 = L.rgb_loss(out.color, gt_image, ocfg.lambda_dssim)
    with tracing.span("loss.resize"):
        fmap = L.resize_bilinear_from_tiles(
            out.feature_tiles, rcfg.grid(cam.width, cam.height),
            gt_feature.shape[0], gt_feature.shape[1])
    if speedup:
        fmap = apply_decoder(dec, fmap)
    ll1_feat = L.l1_loss(fmap, gt_feature.to(torch.float32))
    loss = rgb + ocfg.feature_loss_weight * ll1_feat

    grads = step_grads(loss, leaves, ndc_offset, dec)
    with torch.no_grad():
        finite = torch.isfinite(loss)
        step_update(ts, grads, out.visibility, out.radii, finite, iteration,
                    ocfg=ocfg, speedup=speedup)
        metrics = {
            "finite": finite,
            "loss": loss.detach(), "l1": ll1.detach(),
            "l1_feature": ll1_feat.detach(),
            "num_instances": out.total_instances,
            "max_tile_count": out.max_tile_count,
            "num_active": ts.gstate.alive.sum(),
            "psnr": L.psnr(torch.clamp(out.color, 0, 1),
                           torch.clamp(gt_image, 0, 1)),
        }
    return metrics


def densify_step(ts: TrainState, noise: torch.Tensor, extent, *,
                 ocfg: OptimizationConfig, use_screen_size_prune: bool
                 ) -> tuple[TrainState, density.DensifyReport]:
    """One clone / split / prune round on ``ts``, in place, with no host
    read; ``noise`` is the standard-normal split noise [2, capacity, 3]."""
    _, _, _, report = density.densify_and_prune(
        ts.params, ts.gstate, ts.adam, noise,
        max_grad=ocfg.densify_grad_threshold, min_opacity=ocfg.min_opacity,
        extent=extent, percent_dense=ocfg.percent_dense,
        use_screen_size_prune=use_screen_size_prune)
    return ts, report


def reset_opacity_step(ts: TrainState) -> TrainState:
    density.reset_opacity(ts.params, ts.adam)
    return ts


def _host_values(tensors: list) -> list:
    """The values of 0-d tensors as Python floats, in one host read."""
    tracing.count("host_wait.host_values")
    return torch.stack([x.detach().to(torch.float64) for x in tensors]).tolist()


class Trainer:
    """The host loop (the original train.py ``training()``). Runs on
    ``default_device(device)``. ``parallel.trainer.DistributedTrainer``
    subclasses it: ``step`` and ``train`` are what a batch of cameras a
    step changes, ``batch`` counts the iterations a step spans, ``_whole``
    gathers a row-sharded state for maintenance, ``_sync_tag`` names the
    loop in its messages."""

    _sync_tag = "trainer"
    batch = 1

    def __init__(self, scene: "SceneData", *, ocfg: OptimizationConfig = None,
                 rcfg: RasterConfig = None, max_sh_degree: int = 3,
                 feature_dim: int | None = None, speedup: bool = False,
                 white_background: bool = False, seed: int = 0,
                 capacity_headroom: float = 4.0,
                 gt_cache_bytes: int | None = None, device=None):
        self.device = default_device(device)
        self.scene = scene
        self.ocfg = ocfg or OptimizationConfig()
        self.rcfg = rcfg or RasterConfig()
        self.speedup = speedup
        self.max_sh_degree = max_sh_degree
        feature_dim = (feature_dim if feature_dim is not None
                       else scene.feature_dim)
        self.feature_out_dim = feature_dim

        n = scene.points.shape[0]
        # instance_capacity == 0 means auto: freshly initialised Gaussians
        # touch a few tiles each at 32x16 tiles, so start at ~3.5 N (scaled
        # for smaller tiles) in the JAX package's buckets and grow on
        # overflow
        if not self.rcfg.instance_capacity:
            tile_scale = 512 / (self.rcfg.tile_w * self.rcfg.tile_h)
            auto_cap = _round_capacity(
                max(1 << 17, int(3.5 * max(tile_scale, 1.0) * n)))
            self.rcfg = dataclasses.replace(self.rcfg,
                                            instance_capacity=auto_cap)
            print(f"[raster] auto instance capacity: {auto_cap} "
                  f"({n} points; grows on overflow)")
        capacity = _round_capacity(int(n * capacity_headroom))
        params, gstate = G.create_from_pcd(
            scene.points, scene.colors, max_sh_degree=max_sh_degree,
            feature_dim=feature_dim, speedup=speedup, capacity=capacity,
            device=self.device)
        self.extent = float(scene.nerf_norm["radius"])
        gstate.spatial_lr_scale = self.extent

        decoder = None
        if speedup:
            decoder = init_decoder(feature_dim // 4, feature_dim, seed,
                                   device=self.device)
        self.ts = TrainState.create(params, gstate, decoder=decoder,
                                    device=self.device)
        self.bg = torch.tensor([1.0, 1.0, 1.0] if white_background
                               else [0.0, 0.0, 0.0], device=self.device)
        self.white_background = white_background
        self.rng = random.Random(seed)
        # the split noise's own generator, on the device
        self.noise_generator = torch.Generator(device=self.device)
        self.noise_generator.manual_seed(seed)
        self.iteration = 0
        self._nonfinite_streak = 0
        self._pending_maintenance = None
        self._viewpoint_stack: list = []
        # ground truth on the device: an LRU over (kind, uid) with an
        # optional byte budget (None keeps every view)
        self.gt_cache_bytes = gt_cache_bytes
        self._gt_cache: collections.OrderedDict = collections.OrderedDict()
        self._gt_bytes = 0
        self._next_cam = None
        # densify reports awaiting a host read: (report, step metrics) of
        # device tensors, folded at sync points in one read
        self._pending_reports: list = []
        # every folded round as host integers: iteration, num_cloned,
        # num_split, num_pruned, wanted_slots, granted_slots, num_active
        self.densify_log: list = []
        self._extent_dev = torch.tensor(self.extent, dtype=torch.float32,
                                        device=self.device)

    def restore_state(self, ts: TrainState) -> None:
        """Adopt a restored checkpoint's TrainState (its tensors must lie
        on this trainer's device)."""
        where = ts.params.xyz.device
        if where.type != self.device.type:
            raise ValueError(f"checkpoint state is on {where}, the trainer "
                             f"on {self.device}")
        self.ts = ts

    def full_state(self) -> TrainState:
        """The whole TrainState, as checkpoints and PLY files hold it
        (``parallel.trainer.DistributedTrainer`` gathers its row shards)."""
        return self.ts

    def pick_camera(self):
        """Random sampling without replacement within an epoch
        (train.py:84-86)."""
        if not self._viewpoint_stack:
            self._viewpoint_stack = list(self.scene.train_cameras)
        return self._viewpoint_stack.pop(
            self.rng.randint(0, len(self._viewpoint_stack) - 1))

    @tracing.spanned("train.step")
    def step(self, camera=None, sync: bool = True) -> dict:
        """One training iteration. With ``sync=False`` the metrics come
        back as device tensors and the host reads nothing."""
        # Maintenance of the PREVIOUS iteration runs first: the original
        # saves the scene PLY before the same iteration's densify / opacity
        # reset (train.py:121-126 precede :129-140), so the state seen
        # between step() calls must be pre-maintenance. A model saved at an
        # opacity-reset boundary would otherwise be near transparent.
        self.flush_maintenance()
        self.iteration += 1
        it = self.iteration
        if it % 1000 == 0:
            G.one_up_sh_degree(self.ts.gstate, self.max_sh_degree)
        if camera is not None:
            cam = camera
        elif self._next_cam is not None:
            cam = self._next_cam
            self._next_cam = None
        else:
            cam = self.pick_camera()
        with tracing.span("train.inputs"):
            gt_image = self._device_cache(cam, "image")
            gt_feature = self._device_cache(cam, "feature")
            view = cam.to_view(self.device)
        metrics = train_step(self.ts, view, gt_image, gt_feature, self.bg, it,
                             ocfg=self.ocfg, rcfg=self.rcfg,
                             speedup=self.speedup)
        if camera is None:
            # draw the next camera now (same rng sequence, one step early)
            # so that its upload overlaps this step's device work
            self._next_cam = self.pick_camera()
            with tracing.span("train.inputs"):
                self._device_cache(self._next_cam, "image")
                self._device_cache(self._next_cam, "feature")

        # A non-finite step is discarded on the device inside train_step;
        # the host only escalates at sync points, where repeated
        # non-finite losses mean training is stuck.
        if sync:
            host_metrics, ok = self._sync_metrics(metrics, it,
                                                  self._sync_tag)
            if ok:
                self._pending_maintenance = (it, metrics)
            return host_metrics
        self._pending_maintenance = (it, metrics)
        return metrics

    @tracing.spanned("train.sync")
    def _sync_metrics(self, metrics: dict, it: int, tag: str):
        """The blocking metrics read of a sync point (one host read for the
        whole dict), and what rides on it: folding the queued densify
        reports and the capacity checks. Returns (host_metrics, finite)."""
        keys = list(metrics)
        host_metrics = dict(zip(keys, _host_values([metrics[k]
                                                    for k in keys])))
        if not host_metrics["finite"]:
            self._nonfinite_streak += 1
            print(f"[{tag}] non-finite loss at iteration {it} "
                  f"(streak {self._nonfinite_streak}); step discarded "
                  "on device")
            if self._nonfinite_streak >= 5:
                raise FloatingPointError(
                    f"loss non-finite at {self._nonfinite_streak} "
                    "consecutive sync points")
            return host_metrics, False
        self._nonfinite_streak = 0
        self._drain_reports()
        self._maybe_grow_raster(host_metrics)
        return host_metrics, True

    @tracing.spanned("train.maintenance")
    def flush_maintenance(self, drain: bool = False) -> None:
        """Apply the deferred densify / prune / opacity reset of the last
        completed iteration (nothing when none is pending). Call it before
        saving a FULL training checkpoint, which the original writes after
        densification (train.py:151-153); a scene PLY save must NOT call it.
        It reads nothing from the device: reports queue up and fold at the
        next sync point (or here with ``drain=True``), so a capacity growth
        lags its round by at most one sync interval."""
        if self._pending_maintenance is not None:
            it, metrics = self._pending_maintenance
            self._pending_maintenance = None
            self._dispatch_maintenance(it, metrics)
        if drain:
            self._drain_reports()

    def _whole(self):
        """A context in which ``ts`` is the whole state (it always is here;
        the mesh trainer gathers its row shards)."""
        return contextlib.nullcontext()

    def _dispatch_maintenance(self, it: int, metrics: dict) -> None:
        """Densify / prune / opacity reset after the step that ended at
        ``it``: each fires when its interval boundary falls inside the
        step's span of ``batch`` iterations (the reference checks ``it %
        interval == 0`` per camera-iteration), on the whole state."""
        o = self.ocfg
        first = it - self.batch + 1
        if first >= o.densify_until_iter:
            return
        hits = lambda interval: any(i % interval == 0
                                    for i in range(first, it + 1))
        densify = it > o.densify_from_iter and hits(o.densification_interval)
        reset = hits(o.opacity_reset_interval) or (
            self.white_background and first <= o.densify_from_iter <= it)
        if not (densify or reset):
            return
        with self._whole():
            if densify:
                noise, extent = self._densify_inputs()
                self.ts, report = densify_step(
                    self.ts, noise, extent, ocfg=o,
                    use_screen_size_prune=it > o.opacity_reset_interval)
                self._pending_reports.append((it, report, metrics))
            if reset:
                self.ts = reset_opacity_step(self.ts)

    def _densify_inputs(self):
        """(split noise [2, capacity, 3], extent) of the next round."""
        noise = torch.randn((2, self.ts.params.capacity, 3),
                            generator=self.noise_generator, device=self.device)
        return noise, self._extent_dev

    def _drain_reports(self) -> None:
        """Fold every queued densify report and its round's step metrics
        into the capacity decisions, with one host read."""
        if not self._pending_reports:
            return
        batch, self._pending_reports = self._pending_reports, []
        flat = []
        for _, report, m in batch:
            flat += [*report, m["num_instances"]]
        width = len(density.DensifyReport._fields) + 1
        vals = np.asarray(_host_values(flat)).reshape(len(batch), width)
        for (it, _, _), row in zip(batch, vals):
            self.densify_log.append({"iteration": it, **dict(zip(
                density.DensifyReport._fields, (int(v) for v in row)))})
        rounds = self.densify_log[-len(batch):]
        shortfall = max(r["wanted_slots"] - r["granted_slots"]
                        for r in rounds)
        if shortfall > 0:
            self._grow_params(_round_capacity(
                int((rounds[-1]["num_active"] + shortfall) * 1.5)))
        self._maybe_grow_raster({"num_instances": vals[:, -1].max()})

    def _device_cache(self, cam, kind: str) -> torch.Tensor:
        """Ground-truth tensors in a byte-budgeted LRU on the device
        (unbounded when ``gt_cache_bytes`` is None). At full scale each
        view's fp16 LSeg map is 100-200 MB, so views over the budget are
        evicted and uploaded again on their next epoch; the one-camera
        lookahead of ``step`` overlaps that upload (from pinned host memory,
        non-blocking) with the step before. fp16 teacher maps stay fp16 on
        the device. A camera without a teacher map gets zeros, which only
        ``load_scene(allow_missing_features=True)`` lets through."""
        key = (kind, cam.uid)
        entry = self._gt_cache.get(key)
        if entry is not None:
            self._gt_cache.move_to_end(key)
            return entry[0]
        if kind == "image":
            host = np.asarray(cam.image, np.float32)
        elif cam.semantic_feature is not None:
            host = np.asarray(cam.semantic_feature)
            if host.dtype != np.float16:
                host = host.astype(np.float32)
        else:
            host = np.zeros((*cam.image.shape[:2], self.feature_out_dim),
                            np.float32)
        staged = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type == "cuda":
            staged = staged.pin_memory()
        arr = staged.to(self.device, non_blocking=True)
        self._gt_cache[key] = (arr, host.nbytes)
        self._gt_bytes += host.nbytes
        if self.gt_cache_bytes is not None:
            # keep at least 4 entries: the current and the prefetched
            # camera's image and feature map must coexist whatever the budget
            while (self._gt_bytes > self.gt_cache_bytes
                   and len(self._gt_cache) > 4):
                _, (_, nbytes) = self._gt_cache.popitem(last=False)
                self._gt_bytes -= nbytes
        return arr

    def _maybe_grow_raster(self, metrics: dict) -> None:
        """Raise the instance capacity when binning comes near it: past the
        capacity whole Gaussians are dropped, and ``num_instances`` (counted
        before the cap) is how that shows."""
        total = int(metrics["num_instances"])
        if total > 0.9 * self.rcfg.instance_capacity:
            self.rcfg = dataclasses.replace(
                self.rcfg, instance_capacity=_round_capacity(int(total * 1.5)))
            print("[raster] growing capacities -> instances "
                  f"{self.rcfg.instance_capacity}")

    def _grow_params(self, new_cap: int) -> None:
        """Reallocate parameters, statistics and Adam moments at a larger
        capacity (decided in ``_drain_reports`` from host scalars)."""
        ts = self.ts
        if new_cap <= ts.params.capacity:
            return
        ts.params, ts.gstate, ts.adam.mu = G.grow_capacity(
            ts.params, ts.gstate, new_cap, ts.adam.mu)
        ts.adam.nu = G.grow_params(ts.adam.nu, new_cap)
        print(f"[trainer] growing Gaussian capacity -> {new_cap}")

    def train(self, iterations: int | None = None, log_every: int = 50,
              callback=None) -> list:
        n = iterations or self.ocfg.iterations
        history = []
        for _ in range(n):
            log = (self.iteration + 1 >= n
                   or (self.iteration + 1) % log_every == 0)
            m = self.step(sync=log)
            if log:
                history.append({"iteration": self.iteration, **m})
                if callback:
                    callback(self.iteration, m)
        return history


def _round_capacity(n: int) -> int:
    """Round up to the next 2^k or 1.5 * 2^k bucket, as the JAX package
    does, so both packages' capacities match."""
    n = max(n, 256)
    p = 1 << (n - 1).bit_length()
    return (p * 3) // 4 if n <= (p * 3) // 4 else p
