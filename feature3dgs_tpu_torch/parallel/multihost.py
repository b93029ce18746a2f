"""Training over several hosts: ``MultiHostTrainer``.

Port of ``feature3dgs_tpu/parallel/multihost.py``, on ``torch.distributed``.
torchrun starts one process a card on every host;
``distributed.make_host_chip_mesh`` puts the hosts on the ``data`` axis and
each host's cards on ``tile``, so the gradient sum crosses hosts once a
step and the tile-sharded render's traffic stays within a host.

  * Every rank builds the same state from the same seed (replicated, or
    its row shard under ``shard_gaussians``); growth and maintenance are
    ``DistributedTrainer``'s, on tensors, with no host round trip.
  * Ground truth stays on its host: data row d draws its cameras from its
    own contiguous stripe (``distributed.stripe_indices``) with its own
    seeded RNG, epochs without replacement, and a rank uploads only the
    cameras of its own data row. The train CLI loads pixels for the rank's
    stripe only (``load_scene(pixel_filter=...)``), so ``_host_gt`` raises
    on any other camera.

It runs in a single process too (one host), with the same stripe-drawn
schedule.
"""
from __future__ import annotations

import random

from feature3dgs_tpu_torch.parallel.distributed import stripe_indices
from feature3dgs_tpu_torch.parallel.sharded import Mesh
from feature3dgs_tpu_torch.parallel.trainer import DistributedTrainer


class MultiHostTrainer(DistributedTrainer):
    """DistributedTrainer whose ranks hold only their own data row's
    ground truth, and whose camera batches are drawn per data row from its
    stripe. ``step(cameras=...)`` takes camera uids."""

    _sync_tag = "multihost-trainer"

    def __init__(self, scene, *, mesh: Mesh,
                 cameras_per_step: int | None = None, **kwargs):
        super().__init__(scene, mesh=mesh, cameras_per_step=cameras_per_step,
                         **kwargs)
        n_cams = len(scene.train_cameras)
        if n_cams < self.n_data:
            raise ValueError(
                f"{n_cams} cameras < data axis {self.n_data}; every data "
                "row needs a non-empty camera stripe")
        seed = kwargs.get("seed", 0)
        self._stripes = [stripe_indices(n_cams, d, self.n_data)
                         for d in range(self.n_data)]
        self._row_rngs = [random.Random(seed * 7919 + d)
                          for d in range(self.n_data)]
        self._row_stacks: list[list] = [[] for _ in range(self.n_data)]

    def pick_row_camera(self, d: int) -> int:
        """Epoch sampling without replacement within stripe d."""
        if not self._row_stacks[d]:
            self._row_stacks[d] = list(self._stripes[d])
        stack = self._row_stacks[d]
        return stack.pop(self._row_rngs[d].randint(0, len(stack) - 1))

    def pick_batch(self) -> list[int]:
        """The step's camera uids: batch position k belongs to data row
        k % n_data."""
        return [self.pick_row_camera(d)
                for _ in range(self.batch // self.n_data)
                for d in range(self.n_data)]

    def _host_gt(self, uid: int):
        """(image, teacher map) of a camera of this rank's stripe, on the
        device (the Trainer's byte-budgeted cache)."""
        cam = self.scene.train_cameras[uid]
        if cam.image is None:
            raise RuntimeError(
                f"camera uid {uid} ({cam.image_name}) has no pixel data on "
                "this process — it belongs to another host's stripe "
                "(host-local loading, distributed.local_camera_indices); "
                "a multi-host batch must only route stripe-local cameras "
                "here")
        return self._device_cache(cam, "image"), self._device_cache(
            cam, "feature")

    def _assemble_batch(self, cameras):
        """``cameras``: the step's camera uids (``pick_batch`` when None).
        The batch is ordered data row by data row, as the step splits it;
        every rank knows every camera's geometry, and holds ground truth
        for its own data row's cameras only (None elsewhere)."""
        uids = list(cameras) if cameras is not None else self.pick_batch()
        if len(uids) != self.batch:
            raise ValueError(f"a step takes {self.batch} cameras, got "
                             f"{len(uids)}")
        order = [k for d in range(self.n_data)
                 for k in range(d, self.batch, self.n_data)]
        b_loc = self.batch // self.n_data
        d = self.mesh.data_index
        gts = [self._host_gt(uids[k]) if j // b_loc == d else (None, None)
               for j, k in enumerate(order)]
        views = [self.scene.train_cameras[uids[k]].to_view(self.device)
                 for k in order]
        return views, [g[0] for g in gts], [g[1] for g in gts]
