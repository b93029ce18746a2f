"""The port's row-sharded and multi-host trainers across processes: 4 CPU
ranks on gloo against the JAX package's trainers on 2 x 2 meshes of
``jax.devices()[:4]`` in this process.

One spawn (``tests/torch_parallel_worker.py trainers``, LOCAL_WORLD_SIZE 2:
two "hosts" of two ranks) trains, from the same seed and
``synthetic_scene`` as the JAX runs, 30 iterations at 48x32 px from 100
points, over densify rounds, an opacity reset and a capacity growth:
  * ``DistributedTrainer(shard_gaussians=True)`` on a 2 x 2 mesh, each
    rank holding capacity / 4 rows;
  * ``MultiHostTrainer`` on ``make_host_chip_mesh()``, each rank holding
    the pixels of its host's camera stripe only,
with the JAX trainers' split noise handed over round by round (no torch
generator draws JAX's). Bars (tests/test_parallel.py:290-306,
tests/test_multihost.py:137-152): capacity and ``alive`` exactly equal;
per parameter fewer than 2% of the elements off by more than 6e-4, none by
5e-2, the median under 2e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.data.synthetic import synthetic_scene as jsynthetic
from feature3dgs_tpu.model import optim as joptim
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.parallel import make_mesh as jmake_mesh
from feature3dgs_tpu.parallel.multihost import MultiHostTrainer as JMultiHost
from feature3dgs_tpu.parallel.trainer import DistributedTrainer as JDist
from feature3dgs_tpu.train import losses as jlosses
from feature3dgs_tpu.train import trainer as jtrainer
from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
from feature3dgs_tpu_torch.parallel import make_mesh
from feature3dgs_tpu_torch.parallel.multihost import MultiHostTrainer

from tests.test_torch_parallel_gloo import WORLD, spawn_ranks
from tests.torch_helpers import one_torch_thread  # noqa: F401
from tests.torch_parallel_worker import FIELDS, TRAIN

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_train(cls, **flags):
    """One JAX trainer's run of TRAIN on a 2 x 2 mesh: its final state as
    numpy, and the split noise of each densify round."""
    c = TRAIN
    ocfg = jtrainer.OptimizationConfig(
        iterations=c["iterations"], densify_from_iter=c["densify_from_iter"],
        densification_interval=c["densification_interval"],
        densify_until_iter=c["densify_until_iter"],
        opacity_reset_interval=c["opacity_reset_interval"],
        densify_grad_threshold=c["densify_grad_threshold"],
        lr=joptim.LRConfig(position_lr_max_steps=c["iterations"]))
    rcfg = JRasterConfig(tile_w=16, tile_h=16, chunk=16,
                         instance_capacity=c["instance_capacity"],
                         tile_capacity=1 << 9, backend="xla")
    scene = jsynthetic(n_cams=c["n_cams"], w=c["w"], h=c["h"],
                       n_pts=c["n_pts"], f_dim=c["f_dim"],
                       seed=c["scene_seed"])
    mesh = jmake_mesh((2, 2), devices=jax.devices()[:4])
    noises = []
    real = jtrainer.densify_step

    def recording(ts, key, *a, **k):
        noises.append(np.asarray(jax.random.normal(
            jnp.asarray(key), (2, ts.params.capacity, 3), jnp.float32)))
        return real(ts, key, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "densify_step", recording)
        mp.setattr(jlosses, "SEPARABLE_PRECISION", jax.lax.Precision.HIGHEST)
        tr = cls(scene, mesh=mesh, ocfg=ocfg, rcfg=rcfg,
                 max_sh_degree=c["max_sh_degree"],
                 capacity_headroom=c["capacity_headroom"], seed=c["seed"],
                 **flags)
        cap0 = tr.ts.params.capacity
        with jax.set_mesh(mesh):
            tr.train(iterations=c["iterations"], log_every=c["log_every"])
            tr.flush_maintenance(drain=True)
    ts = jax.device_get(tr.ts)
    state = {k: np.asarray(getattr(ts.params, k)) for k in FIELDS}
    state.update(alive=np.asarray(ts.gstate.alive), cap0=cap0,
                 capacity=ts.params.capacity)
    return state, noises


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX runs, then the port's 4 ranks with their noise."""
    tmp = tmp_path_factory.mktemp("trainers")
    ref_dist, noise_dist = _jax_train(JDist, shard_gaussians=True)
    ref_mh, noise_mh = _jax_train(JMultiHost)
    inputs = str(tmp / "noise.npz")
    np.savez(inputs, **{f"dist_noise_{i}": x for i, x in enumerate(noise_dist)},
             **{f"mh_noise_{i}": x for i, x in enumerate(noise_mh)})
    spawn_ranks(["trainers", inputs, str(tmp)], local_world=2)
    ranks = [dict(np.load(tmp / f"trainers{r}.npz")) for r in range(WORLD)]
    return {"dist_": (ref_dist, noise_dist), "mh_": (ref_mh, noise_mh)}, ranks


def _tracks(got: dict, ref: dict, prefix: str):
    """The two tiers of tests/test_parallel.py:290-306."""
    for name in ("xyz", "opacity", "scaling", "semantic_feature"):
        err = np.abs(got[prefix + name] - ref[name])
        assert (err > 6e-4).mean() < 0.02, (name, err.max())
        assert err.max() < 5e-2, (name, err.max())
        assert np.median(err) < 2e-5, (name, np.median(err))


@pytest.mark.parametrize("prefix", ["dist_", "mh_"])
def test_trainers_across_ranks_track_jax(run, prefix):
    """Both trainers grew their capacity over densify rounds and an
    opacity reset, as the JAX ones did, to the same capacity (a multiple of
    4) and the same live rows; the row-sharded ranks each held capacity /
    4 rows, the multi-host ranks the whole model."""
    refs, ranks = run
    ref, noises = refs[prefix]
    got = ranks[0]
    assert len(noises) >= 2 and int(got[prefix + "rounds"]) == len(noises)
    assert int(got[prefix + "capacity"]) == ref["capacity"] > ref["cap0"]
    assert ref["capacity"] % WORLD == 0
    rows = ref["capacity"] // WORLD if prefix == "dist_" else ref["capacity"]
    assert [int(r[prefix + "shard_rows"]) for r in ranks] == [rows] * WORLD
    np.testing.assert_array_equal(got[prefix + "alive"], ref["alive"])
    assert np.isfinite(float(got[prefix + "loss"]))
    _tracks(got, ref, prefix)


def test_host_gt_refuses_another_hosts_camera():
    """A camera whose pixels this process did not load (another host's
    stripe) is refused by name; the stripe's own cameras upload."""
    scene = synthetic_scene(n_cams=4, w=48, h=32, n_pts=60, f_dim=4, seed=0)
    off = scene.train_cameras[3]
    off.image = off.semantic_feature = None
    off.pixels_loaded = False
    tr = MultiHostTrainer(scene, mesh=make_mesh((1, 1)), cameras_per_step=2,
                          max_sh_degree=1, capacity_headroom=1.0,
                          device="cpu")
    image, feature = tr._host_gt(1)
    assert isinstance(image, torch.Tensor) and image.shape == (32, 48, 3)
    assert feature.shape == (16, 24, 4)
    with pytest.raises(RuntimeError, match="another host's stripe"):
        tr._host_gt(3)
    assert tr._stripes == [[0, 1, 2, 3]]
    assert sorted(tr.pick_batch() + tr.pick_batch()) == [0, 1, 2, 3]


def test_distributed_cli_over_two_hosts(tmp_path_factory):
    """``cli.train --distributed --shard_gaussians --shard_instances`` as 4
    gloo ranks, 2 "hosts" of 2 (torchrun's variables), on a COLMAP scene:
    the ranks train in lockstep, each host loading its own camera stripe;
    every rank joins the gathers and rank 0 alone writes the PLY and a
    checkpoint of the whole model that the JAX package's reader loads."""
    from feature3dgs_tpu.model.ply_io import load_gaussians_ply
    from feature3dgs_tpu.train import checkpoints as jckpt

    from tests.test_e2e_cli import _build_dataset
    root = str(tmp_path_factory.mktemp("colmap"))
    model = str(tmp_path_factory.mktemp("model"))
    _build_dataset(root)
    outs = spawn_ranks([
        "-s", root, "-m", model, "-f", "lseg", "--iterations", "12",
        "--save_iterations", "12", "--checkpoint_iterations", "12",
        "--test_iterations", "12", "--sync_every", "4", "--distributed",
        "--shard_gaussians", "--shard_instances", "--device", "cpu",
        "--tile_size", "16", "--chunk", "16", "--instance_capacity",
        str(1 << 13), "--densify_from_iter", "3",
        "--densification_interval", "4", "--opacity_reset_interval", "1000",
        "--densify_grad_threshold", "1e-7"], local_world=2,
        module="feature3dgs_tpu_torch.cli.train")
    assert "Multi-host training: 2 hosts x 2 cards, 2 cameras/step" in outs[0]
    assert "[ITER 12] Evaluating train" in outs[0]
    assert all("Saving" not in out for out in outs[1:])
    ts, it = jckpt.load_checkpoint(os.path.join(model, "chkpnt12.ckpt"))
    assert it == 12 and ts.params.capacity % WORLD == 0
    assert int(np.asarray(ts.gstate.alive).sum()) > 150      # densified
    _, state = load_gaussians_ply(
        os.path.join(model, "point_cloud", "iteration_12", "point_cloud.ply"),
        max_sh_degree=3)
    assert int(state.num_active) > 150
