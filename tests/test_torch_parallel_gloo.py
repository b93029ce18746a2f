"""The port's mesh across processes: 4 CPU ranks on gloo, a 2 x 2
("data", "tile") mesh, against one process and against the JAX package.

One spawn (tests/torch_parallel_worker.py, 4 ranks, each with its own
timeout so that a hung rank fails the test) renders a camera tile-sharded
and takes one ``sharded_train_step`` at B = 2 from the inputs of
tests/test_torch_parallel.py. Bars: the sharded render equals the port's
single render to 1e-5 (1e-4 on depth), as tests/test_parallel.py holds the
JAX one; the 2 x 2 step matches JAX ``sharded_train_step`` on a 2 x 2 mesh
of ``jax.devices()[:4]``, run here, at the mesh step's bars (loss 2e-5
relative, parameters 5e-5, xyz_gradient_accum 2e-5, denom exact,
max_radii2d 1e-4), and every rank holds the same state.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.render import renderer

from tests.test_torch_parallel import (FIELDS, _batch, _jax_mesh_step, _model,
                                       check_step_against_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the JAX package's 2 x 2 step on them, and what each of
    the 4 ranks wrote."""
    tmp = tmp_path_factory.mktemp("gloo")
    jts, pts = _model()
    cams, gt_images, gt_features = _batch(2)
    jcams = [c[0] for c in cams]
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **{k: np.asarray(getattr(pts.params, k)) for k in FIELDS},
             alive=pts.gstate.alive.numpy(), sh_degree=2,
             spatial_lr_scale=pts.gstate.spatial_lr_scale,
             view=np.stack([np.asarray(c.view) for c in jcams]),
             proj=np.stack([np.asarray(c.proj) for c in jcams]),
             campos=np.stack([np.asarray(c.campos) for c in jcams]),
             tan_fovx=np.stack([np.asarray(c.tan_fovx) for c in jcams]),
             tan_fovy=np.stack([np.asarray(c.tan_fovy) for c in jcams]),
             width=jcams[0].width, height=jcams[0].height,
             gt_images=gt_images, gt_features=gt_features)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(WORLD), LOCAL_WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_worker", inputs,
         str(tmp)], cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    failed = []
    try:
        for r, proc in enumerate(procs):
            try:
                _, err = proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} still running after {TIMEOUT_S} s")
                break
            if proc.returncode:
                failed.append(f"rank {r} exited {proc.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert not failed, "\n".join(failed)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    jax_step = _jax_mesh_step(jts, cams, gt_images, gt_features, (2, 2))
    return pts, cams, jax_step, ranks


def test_tile_sharded_render_matches_single_render(run):
    pts, cams, _, ranks = run
    with torch.no_grad():
        single = renderer.render(pts.params, pts.gstate, cams[0][1],
                                 bg=torch.zeros(3),
                                 config=RasterConfig(tile_w=16, tile_h=16,
                                                     chunk=16,
                                                     instance_capacity=1 << 12))
    for r, got in enumerate(ranks):
        for k, tol in (("color", 1e-5), ("feature", 1e-5), ("depth", 1e-4)):
            np.testing.assert_allclose(got[f"render_{k}"],
                                       getattr(single, k).numpy(), atol=tol,
                                       err_msg=f"rank {r} {k}")


def test_2x2_sharded_train_step_matches_jax(run):
    """Every rank's state after the step against the JAX package's 2 x 2
    step; the ranks agree with each other bit for bit."""
    pts, _, (jts2, jm), ranks = run
    for r, got in enumerate(ranks):
        for k in FIELDS:
            getattr(pts.params, k).copy_(torch.from_numpy(got[f"param_{k}"]))
            np.testing.assert_array_equal(got[f"param_{k}"],
                                          ranks[0][f"param_{k}"])
        for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
            getattr(pts.gstate, k).copy_(torch.from_numpy(got[f"gstate_{k}"]))
        pts.adam.step.fill_(int(got["adam_step"]))
        metrics = {k[len("metric_"):]: v for k, v in got.items()
                   if k.startswith("metric_")}
        check_step_against_jax(pts, metrics, jts2, jm)
