"""Process setup and the host x chip mesh, on ``torch.distributed``.

Port of ``feature3dgs_tpu/parallel/distributed.py``. One process drives one
card (torchrun starts them and sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``);
``initialize`` joins them into one process group, NCCL between cards and
gloo between CPU processes. A single process (no ``WORLD_SIZE`` above 1)
needs no process group: the mesh of ``parallel.sharded`` then runs no
collective at all. The rank plays the JAX package's process index.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from feature3dgs_tpu_torch import default_device


def initialize(device: str | torch.device | None = None) -> bool:
    """Idempotent ``init_process_group`` from torchrun's environment: NCCL
    on the card (``default_device(device)``; each process takes card
    ``LOCAL_RANK``), gloo when ``device`` is ``"cpu"``. Returns whether a
    process group is up. Without ``WORLD_SIZE`` > 1 this is a
    single-process run and nothing is set up; with it, a failure to join
    raises (every process would otherwise train alone and write over the
    others' output)."""
    dev = default_device(device)
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_host_chip_mesh():
    """Mesh with hosts on the first axis and each host's processes (one a
    card) on the second: the data axis' gradient sum crosses hosts once a
    step, the tile-sharded render's traffic stays within a host. torchrun
    numbers ranks host by host, so rank // LOCAL_WORLD_SIZE is the host."""
    from feature3dgs_tpu_torch.parallel.sharded import make_mesh
    world = process_count()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if per_host <= 0 or world % per_host:
        raise ValueError(f"world size {world} is not a whole number of hosts "
                         f"of {per_host} processes")
    return make_mesh((world // per_host, per_host))


def stripe_indices(num_items: int, row: int, n_rows: int) -> list[int]:
    """Balanced contiguous partition: the first ``num_items % n_rows``
    stripes get one extra item, so every stripe is non-empty whenever
    ``num_items >= n_rows``. The one stripe convention for host-local data
    loading and the per-data-row camera schedule."""
    q, r = divmod(num_items, n_rows)
    start = row * q + min(row, r)
    return list(range(start, start + q + (1 if row < r else 0)))


def local_camera_indices(num_cameras: int) -> list[int]:
    """The cameras this process loads: a contiguous stripe by rank."""
    return stripe_indices(num_cameras, process_index(), process_count())
