"""The port's mesh across processes: 4 CPU ranks on gloo, a 2 x 2
("data", "tile") mesh, against one process and against the JAX package.

One spawn (tests/torch_parallel_worker.py, 4 ranks, each with its own
timeout so that a hung rank fails the test) renders a camera tile-sharded
and takes one ``sharded_train_step`` at B = 2 from the inputs of
tests/test_torch_parallel.py in each mode: replicated, ``shard_gaussians``
and ``shard_gaussians`` + ``shard_instances``. Bars: the sharded render
equals the port's single render to 1e-5 (1e-4 on depth), as
tests/test_parallel.py holds the JAX one; each step matches JAX
``sharded_train_step`` with the same flags on a 2 x 2 mesh of
``jax.devices()[:4]``, run here (the exchange through the Pallas kernels in
interpret mode), at the mesh step's bars (loss 2e-5 relative, parameters
5e-5, xyz_gradient_accum 2e-5, denom exact, max_radii2d 1e-4 and exact
for the exchange, num_instances equal); the exchange also on a 1 x 4 mesh,
where two tile ranks own only rows past the 2-row grid. The replicated ranks hold the same
state; in the sharded modes each rank holds capacity / 4 rows and the
shards, in rank order, are the JAX arrays. Then the scaling CLI's meshes
over the first 1, 2 and 4 of the 4 ranks, row-sharded.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.parallel import make_mesh as jmake_mesh
from feature3dgs_tpu.parallel import sharded as jsharded
from feature3dgs_tpu.train import trainer as jtrainer

from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.render import renderer

from tests.test_torch_parallel import (FIELDS, JCFG, _batch, _jax_mesh_step,
                                       _model, check_step_against_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(args: list, local_world: int | None = None,
                module: str = "tests.torch_parallel_worker",
                world: int = WORLD) -> list:
    """Run ``python -m <module> *args`` as ``world`` gloo ranks on the CPU
    (``local_world`` ranks a host, default all, torchrun's variables set);
    fail on a rank's error or on one still running after TIMEOUT_S. Returns
    each rank's standard output."""
    local_world = world if local_world is None else local_world
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(local_world),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args],
        cwd=ROOT, env={**env, "RANK": str(r),
                       "LOCAL_RANK": str(r % local_world)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    failed, outs = [], []
    try:
        for r, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=TIMEOUT_S)
                outs.append(out)
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
    return outs


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
    spawn_ranks([inputs, str(tmp)])
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    jax_steps = {"": _jax_mesh_step(jts, cams, gt_images, gt_features, (2, 2)),
                 "sg_": _jax_sharded_step(jts, cams, gt_images, gt_features),
                 "si_": _jax_sharded_step(jts, cams, gt_images, gt_features,
                                          shard_instances=True),
                 "si14_": _jax_sharded_step(jts, cams, gt_images, gt_features,
                                            shard_instances=True,
                                            shape=(1, 4))}
    return pts, cams, jax_steps, ranks


def _jax_sharded_step(jts, cams, gt_images, gt_features,
                      shard_instances=False, shape=(2, 2)):
    """JAX ``sharded_train_step`` with ``shard_gaussians`` (and the
    exchange, which needs the Pallas compositor: interpret mode here) on a
    mesh of 4 devices, on a copy of ``jts``."""
    mesh = jmake_mesh(shape, devices=jax.devices()[:4])
    rcfg = (dataclasses.replace(JCFG, backend="pallas_interpret")
            if shard_instances else JCFG)
    with jax.set_mesh(mesh):
        return jsharded.sharded_train_step(
            jax.tree.map(jnp.copy, jts),
            jsharded.stack_cameras([c[0] for c in cams]),
            jnp.asarray(gt_images), jnp.asarray(gt_features), jnp.zeros(3),
            np.arange(1, len(cams) + 1, dtype=np.int32), mesh=mesh,
            ocfg=jtrainer.OptimizationConfig(), rcfg=rcfg,
            shard_gaussians=True, shard_instances=shard_instances)


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
    pts, _, steps, ranks = run
    jts2, jm = steps[""]
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


@pytest.mark.parametrize("mode", ["sg_", "si_", "si14_"])
def test_2x2_row_sharded_steps_match_jax(run, mode):
    """``shard_gaussians`` (sg_) and the instance exchange (si_) on the 2 x
    2 mesh, and the exchange on a 1 x 4 mesh whose last two ranks own only
    tile rows past the image (si14_): each rank's shard holds capacity / 4
    rows; the shards in rank order, after one step each, against the JAX
    package's step with the same flags on the same mesh shape; every rank
    reports the same metrics."""
    pts, _, steps, ranks = run
    jts2, jm = steps[mode]
    cap = pts.params.capacity
    for k in FIELDS:
        shards = [got[f"{mode}param_{k}"] for got in ranks]
        assert all(x.shape[0] == cap // WORLD for x in shards), k
        getattr(pts.params, k).copy_(torch.from_numpy(np.concatenate(shards)))
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        shards = [got[f"{mode}gstate_{k}"] for got in ranks]
        assert all(x.shape[0] == cap // WORLD for x in shards), k
        getattr(pts.gstate, k).copy_(torch.from_numpy(np.concatenate(shards)))
    pts.adam.step.fill_(int(ranks[0][f"{mode}adam_step"]))
    metrics = [{k[len(mode + "metric_"):]: v for k, v in got.items()
                if k.startswith(mode + "metric_")} for got in ranks]
    assert all(m == metrics[0] for m in metrics)
    check_step_against_jax(pts, metrics[0], jts2, jm)
    if mode != "sg_":
        np.testing.assert_array_equal(pts.gstate.max_radii2d.numpy(),
                                      np.asarray(jts2.gstate.max_radii2d))


@pytest.mark.parametrize("flag", ["--shard_gaussians", "--shard_instances"])
def test_meshes_over_part_of_the_world(flag):
    """cli.bench_scaling on the 4 ranks: meshes over ranks [0] (the others
    wait), [0, 1] (a process group of its own: gathers, reduce-scatters,
    the exchange's all_to_all and the world sums run on it) and all 4, each
    with the row-sharded flag; rank 0 prints the three rows, the others
    nothing."""
    outs = spawn_ranks(["--n_gauss", "400", "--width", "64", "--height",
                        "48", "--f_dim", "4", "--instance_capacity", "8192",
                        "--iters", "1", flag, "--device", "cpu"],
                       module="feature3dgs_tpu_torch.cli.bench_scaling")
    rows = [json.loads(ln) for ln in outs[0].splitlines()
            if ln.startswith("{")]
    assert [(r["devices"], r["mesh"]) for r in rows] == [
        (1, [1, 1]), (2, [2, 1]), (4, [2, 2])]
    assert all(r["step_ms"] > 0 for r in rows)
    assert not any(o.strip() for o in outs[1:])
