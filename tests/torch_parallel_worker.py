"""One rank of the multi-process runs of tests/test_torch_parallel_gloo.py.

    python -m tests.torch_parallel_worker INPUTS.npz OUT_DIR
    python -m tests.torch_parallel_worker trainers INPUTS.npz OUT_DIR
    python -m tests.torch_parallel_worker mesh_order OUT_DIR

with torchrun's variables set (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
Joins a gloo process group on the CPU, builds a 2 x 2 ("data", "tile")
mesh, renders the inputs' camera 0 tile-sharded (``rasterize_tile_sharded``)
and takes, from the inputs' state, one ``sharded_train_step`` over the
inputs' B cameras in each mode: replicated, with this rank's row shard
(``shard_gaussians``) and through the instance exchange (``shard_gaussians``
and ``shard_instances``), the exchange also on a 1 x 4 mesh. Writes what this rank holds (its shard in the
sharded modes) to OUT_DIR/rank{RANK}.npz. ``trainers`` runs the two
trainers of tests/test_torch_multihost.py (``trainers`` below);
``mesh_order`` the collectives of tests/test_torch_mesh_order.py on 2
ranks. Imports the port and torch only.
"""
from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "semantic_feature")


def main(inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from feature3dgs_tpu_torch import convert
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.parallel import (make_mesh,
                                                rasterize_tile_sharded,
                                                sharded_train_step)
    from feature3dgs_tpu_torch.parallel.distributed import initialize
    from feature3dgs_tpu_torch.parallel.sharded import shard_state
    from feature3dgs_tpu_torch.train.trainer import OptimizationConfig

    assert initialize(device="cpu")
    mesh = make_mesh((2, 2))
    z = np.load(inputs)
    cpu = torch.device("cpu")
    n_cams = z["view"].shape[0]
    cams = [convert.camera_from_numpy(
        z["view"][i], z["proj"][i], z["campos"][i], z["tan_fovx"][i],
        z["tan_fovy"][i], int(z["width"]), int(z["height"]), cpu)
        for i in range(n_cams)]
    fields = {k: z[k] for k in FIELDS}
    zeros = np.zeros(z["alive"].shape[0], np.float32)
    ts = convert.train_state_from_numpy({
        "params": fields,
        "gstate": {"alive": z["alive"], "max_radii2d": zeros,
                   "xyz_gradient_accum": zeros, "denom": zeros,
                   "active_sh_degree": int(z["sh_degree"]),
                   "spatial_lr_scale": float(z["spatial_lr_scale"])},
        "adam": {"mu": {k: np.zeros_like(v) for k, v in fields.items()},
                 "nu": {k: np.zeros_like(v) for k, v in fields.items()},
                 "step": np.int32(0)}}, cpu)
    rcfg = RasterConfig(tile_w=16, tile_h=16, chunk=16,
                        instance_capacity=1 << 12)
    out = {}
    with torch.no_grad():
        img = rasterize_tile_sharded(ts.params, ts.gstate, cams[0],
                                     bg=torch.zeros(3), config=rcfg,
                                     mesh=mesh)
    out.update({f"render_{k}": v.numpy() for k, v in img.items()})
    # the replicated step, then from the same state one step with this
    # rank's row shard and one through the instance exchange
    # the exchange again on a 1 x 4 mesh, whose last two tile ranks own
    # only tile rows past the 2-row grid
    start = copy.deepcopy(ts)
    exchange = dict(shard_gaussians=True, shard_instances=True)
    for prefix, on, flags in (("", mesh, {}),
                              ("sg_", mesh, dict(shard_gaussians=True)),
                              ("si_", mesh, exchange),
                              ("si14_", make_mesh((1, 4)), exchange)):
        ts = copy.deepcopy(start)
        ts = shard_state(ts, on) if flags else ts
        m = sharded_train_step(
            ts, cams, torch.from_numpy(z["gt_images"]),
            torch.from_numpy(z["gt_features"]), torch.zeros(3),
            np.arange(1, n_cams + 1), mesh=on, ocfg=OptimizationConfig(),
            rcfg=rcfg, **flags)
        out.update({f"{prefix}metric_{k}": float(v) for k, v in m.items()})
        out.update({f"{prefix}param_{k}": getattr(ts.params, k).numpy()
                    for k in FIELDS})
        for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
            out[f"{prefix}gstate_{k}"] = getattr(ts.gstate, k).numpy()
        out[f"{prefix}adam_step"] = int(ts.adam.step)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


# the trainers' run: scene, schedule and rasterizer of both packages' runs
TRAIN = dict(n_cams=4, w=48, h=32, n_pts=100, f_dim=4, scene_seed=1,
             iterations=30, log_every=10, densify_from_iter=5,
             densification_interval=10, opacity_reset_interval=20,
             densify_until_iter=1000, densify_grad_threshold=1e-5,
             max_sh_degree=2, capacity_headroom=1.2, seed=3,
             instance_capacity=1 << 13)


def trainers(inputs: str, out_dir: str) -> None:
    """A ``DistributedTrainer(shard_gaussians=True)`` on a 2 x 2 mesh, then
    a ``MultiHostTrainer`` on the host x card mesh of LOCAL_WORLD_SIZE
    (2 hosts of 2 ranks), whose ranks hold the pixels of their host's
    camera stripe only; each with the split noise of INPUTS, round by
    round. Every rank joins the gathers; rank 0 writes both whole states,
    and every rank the rows it held, to OUT_DIR/trainers{RANK}.npz."""
    torch.set_num_threads(1)
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.model.optim import LRConfig
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.parallel import DistributedTrainer, make_mesh
    from feature3dgs_tpu_torch.parallel.distributed import (
        initialize, make_host_chip_mesh, stripe_indices)
    from feature3dgs_tpu_torch.parallel.multihost import MultiHostTrainer
    from feature3dgs_tpu_torch.train.trainer import OptimizationConfig

    assert initialize(device="cpu")
    z = np.load(inputs)
    c = TRAIN
    ocfg = OptimizationConfig(
        iterations=c["iterations"], densify_from_iter=c["densify_from_iter"],
        densification_interval=c["densification_interval"],
        densify_until_iter=c["densify_until_iter"],
        opacity_reset_interval=c["opacity_reset_interval"],
        densify_grad_threshold=c["densify_grad_threshold"],
        lr=LRConfig(position_lr_max_steps=c["iterations"]))
    kw = dict(ocfg=ocfg, rcfg=RasterConfig(
        tile_w=16, tile_h=16, chunk=16,
        instance_capacity=c["instance_capacity"]),
        max_sh_degree=c["max_sh_degree"],
        capacity_headroom=c["capacity_headroom"], seed=c["seed"],
        device="cpu")

    def scene():
        return synthetic_scene(n_cams=c["n_cams"], w=c["w"], h=c["h"],
                               n_pts=c["n_pts"], f_dim=c["f_dim"],
                               seed=c["scene_seed"])

    def noise_from(prefix):
        noises = [z[k] for k in sorted((k for k in z.files
                                        if k.startswith(prefix)),
                                       key=lambda k: int(k.split("_")[-1]))]

        def densify_inputs(self):
            noise = torch.from_numpy(noises.pop(0))
            assert noise.shape[1] == self.ts.params.capacity
            return noise, self._extent_dev
        return densify_inputs

    out = {}
    runs = (("dist_", DistributedTrainer, make_mesh((2, 2)),
             dict(shard_gaussians=True), scene()),)
    mesh = make_host_chip_mesh()
    striped = scene()
    stripe = stripe_indices(c["n_cams"], mesh.data_index, mesh.shape["data"])
    for cam in striped.train_cameras:
        if cam.uid not in stripe:
            cam.image = cam.semantic_feature = None
            cam.pixels_loaded = False
    runs += (("mh_", MultiHostTrainer, mesh, {}, striped),)
    for prefix, cls, m, flags, sc in runs:
        cls = type(cls.__name__, (cls,),
                   {"_densify_inputs": noise_from(prefix + "noise_")})
        tr = cls(sc, mesh=m, **flags, **kw)
        history = tr.train(iterations=c["iterations"],
                           log_every=c["log_every"])
        tr.flush_maintenance(drain=True)
        out[prefix + "shard_rows"] = tr.ts.params.capacity
        out[prefix + "xyz_rows"] = tr.ts.params.xyz.numpy()
        whole = tr.full_state()
        out[prefix + "capacity"] = whole.params.capacity
        out[prefix + "alive"] = whole.gstate.alive.numpy()
        out[prefix + "loss"] = history[-1]["loss"]
        out[prefix + "rounds"] = len(tr.densify_log)
        out.update({prefix + k: getattr(whole.params, k).numpy()
                    for k in FIELDS})
    np.savez(os.path.join(out_dir, f"trainers{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def cotangent(rank: int, shape: tuple) -> torch.Tensor:
    """The cotangent global rank ``rank`` hands a collective's backward in
    ``mesh_order``: distinct on every rank and entry."""
    n = int(np.prod(shape))
    return (torch.arange(n, dtype=torch.float32) + 1000.0 * (rank + 1)
            ).reshape(shape)


def mesh_order(out_dir: str) -> None:
    """Two ranks, each mesh over ranks [0, 1] and over [1, 0]: on a 2 x 1
    mesh a 4-row TrainState through ``shard_state`` and ``gather_state``
    (``_all_rows``), its xyz shard through ``_GatherRows`` forward and
    backward (a reduce-scatter of ``cotangent``), and one instance a
    (source, destination) pair through the exchange's ``_route``; on a
    1 x 2 mesh a [3, 2] block through ``_GatherTiles`` forward and
    backward. Writes what this rank got to OUT_DIR/order{RANK}.npz."""
    torch.set_num_threads(1)
    from feature3dgs_tpu_torch import convert
    from feature3dgs_tpu_torch.parallel.distributed import initialize
    from feature3dgs_tpu_torch.parallel.sharded import (Mesh, _GatherRows,
                                                        _GatherTiles, _route,
                                                        gather_state,
                                                        shard_state)
    assert initialize(device="cpu")
    me = torch.distributed.get_rank()
    xyz = np.arange(12, dtype=np.float32).reshape(4, 3)
    fields = {k: xyz if k == "xyz" else np.zeros((4, 1), np.float32)
              for k in FIELDS}
    zeros = np.zeros(4, np.float32)
    ts = convert.train_state_from_numpy({
        "params": fields,
        "gstate": {"alive": np.array([True, False, True, True]),
                   "max_radii2d": zeros, "xyz_gradient_accum": zeros,
                   "denom": zeros, "active_sh_degree": 0,
                   "spatial_lr_scale": 1.0},
        "adam": {"mu": fields, "nu": fields, "step": np.int32(0)}}, "cpu")
    out = {}
    for key, ranks in (("up_", [0, 1]), ("down_", [1, 0])):
        mesh = Mesh((2, 1), ranks=ranks)
        shard = shard_state(ts, mesh)
        whole = gather_state(shard, mesh)
        out[key + "mesh_rank"] = mesh.rank
        out[key + "shard"] = shard.params.xyz.numpy()
        out[key + "gathered"] = whole.params.xyz.numpy()
        out[key + "alive"] = whole.gstate.alive.numpy()
        rows = shard.params.xyz.clone().requires_grad_()
        full = _GatherRows.apply(rows, mesh)
        full.backward(cotangent(me, tuple(full.shape)))
        out[key + "gather_rows"] = full.detach().numpy()
        out[key + "scatter_rows"] = rows.grad.numpy()
        # one instance from this mesh rank to each: tile 10 * source +
        # destination, id = source
        dest = torch.arange(2)
        recv, dropped = _route(dest, 10 * mesh.rank + dest,
                               torch.ones(2), torch.full((2,), mesh.rank),
                               2, mesh)
        out[key + "route"] = recv.numpy()
        out[key + "route_dropped"] = int(dropped)

        mesh = Mesh((1, 2), ranks=ranks)
        block = (torch.arange(6, dtype=torch.float32).reshape(3, 2)
                 + 100.0 * mesh.tile_index).requires_grad_()
        tiles = _GatherTiles.apply(block, block, mesh)
        tiles.backward(cotangent(me, tuple(tiles.shape)))
        out[key + "tile_index"] = mesh.tile_index
        out[key + "gather_tiles"] = tiles.detach().numpy()
        out[key + "scatter_tiles"] = block.grad.numpy()
    np.savez(os.path.join(out_dir, f"order{me}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "trainers":
        trainers(*sys.argv[2:4])
    elif sys.argv[1] == "mesh_order":
        mesh_order(sys.argv[2])
    else:
        main(*sys.argv[1:3])
