"""The host loop over a batch of cameras a step: ``DistributedTrainer``.

Port of ``feature3dgs_tpu/parallel/trainer.py``. It keeps the ``Trainer``'s
host-side schedule (SH bumps, densify / prune / opacity-reset cadence,
capacity growth, the ground-truth cache) and swaps its step for
``parallel.sharded.sharded_train_step``: a step takes ``cameras_per_step``
cameras (``mesh.shape['data']`` by default), each counted as one reference
iteration (train.py:84-91), rendered tile-sharded over ``mesh.shape
['tile']`` ranks, with gradients summed over the mesh.

Densification runs replicated: every rank folds the same summed
statistics into its own copy of the state and draws the same split noise
from the same seed, so the ranks' parameters stay equal. Under
``shard_gaussians`` each rank holds only its row shard of the parameters,
Adam moments and statistics (the capacity a multiple of the world size);
densify, prune, the opacity reset and capacity growth decide over the whole
model, so they gather the rows on every rank, run the replicated code and
keep this rank's rows again.
"""
from __future__ import annotations

import contextlib

import numpy as np

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.model import gaussians as G
from feature3dgs_tpu_torch.parallel.sharded import (Mesh, gather_state,
                                                    shard_state,
                                                    sharded_train_step)
from feature3dgs_tpu_torch.train.trainer import Trainer


class DistributedTrainer(Trainer):
    """Mesh-parallel Trainer: ``cameras_per_step`` cameras a step (a
    multiple of the data axis). The iteration counter advances by the batch
    so the reference's per-iteration schedule (densify every 100, opacity
    reset every 3000, the xyz learning-rate decay) keeps its meaning; the
    batch loss is the mean of the per-camera reference losses. On a 1 x 1
    mesh it is one card taking B cameras a step.

    ``shard_gaussians``: ``ts`` holds this rank's rows (``full_state``
    gathers the whole state; every rank must call it). ``shard_instances``
    (needs ``shard_gaussians``): the steps use the instance exchange."""

    _sync_tag = "dist-trainer"

    def __init__(self, scene, *, mesh: Mesh, cameras_per_step: int | None = None,
                 shard_gaussians: bool = False, shard_instances: bool = False,
                 **kwargs):
        if shard_instances and not shard_gaussians:
            raise ValueError(
                "shard_instances requires shard_gaussians: the instance "
                "exchange only makes sense when Gaussian rows are "
                "row-sharded over the mesh")
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.batch = cameras_per_step or self.n_data
        if self.batch % self.n_data:
            raise ValueError(
                f"cameras_per_step {self.batch} not divisible by the data "
                f"axis {self.n_data}")
        self.shard_gaussians = shard_gaussians
        self.shard_instances = shard_instances
        self._sharded = False          # whether ts holds this rank's rows
        super().__init__(scene, **kwargs)
        self._adopt(self.ts)

    def _adopt(self, ts) -> None:
        """Take a whole TrainState: under shard_gaussians its capacity is
        rounded up to a multiple of the world size and this rank keeps its
        rows."""
        self.ts, self._sharded = ts, False
        if self.shard_gaussians:
            self._grow_params(ts.params.capacity)
            self.ts, self._sharded = shard_state(self.ts, self.mesh), True

    @property
    def capacity(self) -> int:
        """The whole model's capacity (every rank's rows)."""
        return self.ts.params.capacity * (self.mesh.size if self._sharded
                                          else 1)

    def full_state(self):
        """The whole TrainState: under shard_gaussians a gather of every
        rank's rows, which every rank must join."""
        return gather_state(self.ts, self.mesh) if self._sharded else self.ts

    @contextlib.contextmanager
    def _whole(self):
        """``ts`` is the whole state inside the block (gathered on every
        rank) and this rank's rows again after it."""
        if not self._sharded:
            yield
            return
        self.ts, self._sharded = gather_state(self.ts, self.mesh), False
        try:
            yield
        finally:
            self.ts, self._sharded = shard_state(self.ts, self.mesh), True

    def restore_state(self, ts) -> None:
        """Adopt a restored checkpoint's (whole) TrainState; under
        shard_gaussians the capacity is rounded up to a multiple of the
        world size and this rank keeps its rows."""
        super().restore_state(ts)
        self._adopt(self.ts)

    def _grow_params(self, new_cap: int) -> None:
        if self.shard_gaussians:
            new_cap = -(-new_cap // self.mesh.size) * self.mesh.size
        if new_cap <= self.capacity:
            return
        with self._whole():
            super()._grow_params(new_cap)

    def _assemble_batch(self, cameras):
        """(views, ground-truth images, teacher maps) of one step's batch;
        ``cameras`` is a list of Camera objects, or None to sample."""
        cams = (list(cameras) if cameras is not None
                else [self.pick_camera() for _ in range(self.batch)])
        if len(cams) != self.batch:
            raise ValueError(f"a step takes {self.batch} cameras, got "
                             f"{len(cams)}")
        return ([c.to_view(self.device) for c in cams],
                [self._device_cache(c, "image") for c in cams],
                [self._device_cache(c, "feature") for c in cams])

    @tracing.spanned("train.step")
    def step(self, cameras=None, sync: bool = True) -> dict:
        """One mesh step over a batch of cameras (``batch`` reference
        iterations); ``sync=False`` reads nothing from the device."""
        self.flush_maintenance()
        it0 = self.iteration + 1
        self.iteration += self.batch
        for it in range(it0, self.iteration + 1):
            if it % 1000 == 0:
                G.one_up_sh_degree(self.ts.gstate, self.max_sh_degree)
        with tracing.span("train.inputs"):
            views, gt_images, gt_features = self._assemble_batch(cameras)
        # the span's per-iteration schedule is folded into the one update
        # (group_lrs; train.py:77-81)
        span = np.arange(it0, it0 + self.batch)
        metrics = sharded_train_step(
            self.ts, views, gt_images, gt_features, self.bg, span,
            mesh=self.mesh, ocfg=self.ocfg, rcfg=self.rcfg,
            speedup=self.speedup, shard_gaussians=self.shard_gaussians,
            shard_instances=self.shard_instances)
        if sync:
            host_metrics, ok = self._sync_metrics(metrics, self.iteration,
                                                  self._sync_tag)
            if ok:
                self._pending_maintenance = (self.iteration, metrics)
            return host_metrics
        self._pending_maintenance = (self.iteration, metrics)
        return metrics

    def train(self, iterations: int | None = None, log_every: int = 50,
              callback=None) -> list:
        n = iterations or self.ocfg.iterations
        history = []
        while self.iteration < n:
            nxt = self.iteration + self.batch
            log = nxt >= n or (nxt // log_every) > (self.iteration // log_every)
            m = self.step(sync=log)
            if log:
                history.append({"iteration": self.iteration, **m})
                if callback:
                    callback(self.iteration, m)
        return history
