"""One rank of the multi-process runs of tests/test_torch_parallel_gloo.py.

    python -m tests.torch_parallel_worker INPUTS.npz OUT_DIR

with torchrun's variables set (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
Joins a gloo process group on the CPU, builds a 2 x 2 ("data", "tile")
mesh, renders the inputs' camera 0 tile-sharded (``rasterize_tile_sharded``)
and takes one ``sharded_train_step`` over the inputs' B cameras, then writes
what this rank holds to OUT_DIR/rank{RANK}.npz. Imports the port and torch
only.
"""
from __future__ import annotations

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
    m = sharded_train_step(
        ts, cams, torch.from_numpy(z["gt_images"]),
        torch.from_numpy(z["gt_features"]), torch.zeros(3),
        np.arange(1, n_cams + 1), mesh=mesh, ocfg=OptimizationConfig(),
        rcfg=rcfg)
    out.update({f"metric_{k}": float(v) for k, v in m.items()})
    out.update({f"param_{k}": getattr(ts.params, k).numpy() for k in FIELDS})
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        out[f"gstate_{k}"] = getattr(ts.gstate, k).numpy()
    out["adam_step"] = int(ts.adam.step)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
