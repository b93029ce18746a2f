"""PyTorch port vs the JAX package: the host training loop (``Trainer``).

The parity test runs both trainers on the scene of tests/test_train.py
(48x32, 4 feature channels, 80 points) from the same seed, with the JAX
package's split noise handed to the port through ``_densify_inputs``. Both
must pick the same cameras in the same order and make the same densify
decisions (``num_active`` and every report count equal); losses agree at
1e-4 relative. The parameters part slowly: Adam divides by sqrt(nu), so a
gradient component near zero turns f32 rounding into a step of up to the
learning rate in either direction. After 12 steps, of the rows alive in
both, at least 85% of each group's elements agree within two learning
rates (the semantic features, which start at zero under gradients of the
order of 1e-9, are the loosest group at 90%), and none is further off than
12 steps taken in opposite directions.

The other tests are the port's own versions of the JAX trainer tests that
need no JAX (tests/test_train.py): the deferred opacity reset, the PLY save
that precedes it, the non-finite guard synced and pipelined, the
ground-truth cache's LRU budget and fp16 teacher maps.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.data.cameras import Camera as JCamera
from feature3dgs_tpu.data.dataset import SceneData as JSceneData
from feature3dgs_tpu.model import optim as joptim
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.ops import rasterize as jrasterize
from feature3dgs_tpu.train import losses as jlosses
from feature3dgs_tpu.train import trainer as jtrainer
from feature3dgs_tpu_torch.data.cameras import Camera
from feature3dgs_tpu_torch.data.dataset import SceneData
from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
from feature3dgs_tpu_torch.model import gaussians as PG
from feature3dgs_tpu_torch.model import optim as poptim
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.train import checkpoints as pckpt
from feature3dgs_tpu_torch.train import trainer as ptrainer

from tests.torch_helpers import t, one_torch_thread  # noqa: F401
from tests.utils import make_camera, random_gaussians

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H, F_DIM = 48, 32, 4
JCFG = JRasterConfig(tile_w=16, tile_h=16, chunk=16,
                     instance_capacity=1 << 13, tile_capacity=1 << 9,
                     backend="xla")
PCFG = RasterConfig(tile_w=16, tile_h=16, chunk=16, instance_capacity=1 << 13)
FIELDS = PG.GaussianParams.FIELDS


def _scenes(n_cams=3, n_gt=120, seed=0):
    """tests/test_train.py:_make_scene as (JAX SceneData, port SceneData):
    a ground-truth model rendered by the JAX rasterizer gives each camera
    its image and feature map; 80 random points start the training."""
    rng = np.random.RandomState(seed)
    gt = random_gaussians(n=n_gt, f_dim=F_DIM, seed=seed, max_sh_degree=3)
    jcams, pcams = [], []
    for i in range(n_cams):
        cv = make_camera(width=W, height=H, cam_z=-4.0 - 0.3 * i)
        out = jrasterize(gt["means3d"], gt["opacities"], gt["feat"], cv,
                         scales=gt["scales"], rotations=gt["rotations"],
                         shs=gt["shs"], sh_degree=3,
                         config=dataclasses.replace(JCFG, backend="auto"))
        kw = dict(uid=i, colmap_id=i, R=np.eye(3),
                  T=np.array([0.0, 0.0, 4.0 + 0.3 * i]), fovx=1.0, fovy=0.8,
                  image=np.clip(np.asarray(out.color), 0, 1),
                  image_name=f"cam{i}",
                  semantic_feature=np.asarray(out.feature), width=W, height=H)
        jcams.append(JCamera(**kw))
        pcams.append(Camera(**kw))
    pts = rng.uniform(-1.5, 1.5, (80, 3)).astype(np.float32)
    cols = rng.rand(80, 3).astype(np.float32)
    kw = dict(test_cameras=[], points=pts, colors=cols,
              nerf_norm={"translate": np.zeros(3), "radius": 4.0},
              feature_dim=F_DIM, source_path="synthetic")
    return (JSceneData(train_cameras=jcams, **kw),
            SceneData(train_cameras=pcams, **kw))


class _NoiseFromJax(ptrainer.Trainer):
    """The port's Trainer with the JAX trainer's split noise: the same key
    sequence (trainer.py:223, 368-370), drawn with jax.random."""

    def __init__(self, *args, seed=0, **kw):
        super().__init__(*args, seed=seed, **kw)
        self.key = jax.random.PRNGKey(seed)

    def _densify_inputs(self):
        self.key, sub = jax.random.split(self.key)
        noise = jax.random.normal(sub, (2, self.ts.params.capacity, 3),
                                  jnp.float32)
        return t(np.asarray(noise)), self._extent_dev


def test_trainer_matches_jax_trainer(monkeypatch):
    """12 steps spanning densify rounds at 4, 8 and 12, an opacity reset at
    8 and a capacity growth."""
    monkeypatch.setattr(jlosses, "SEPARABLE_PRECISION",
                        jax.lax.Precision.HIGHEST)
    jscene, pscene = _scenes()
    common = dict(iterations=12, densify_from_iter=2, densification_interval=4,
                  opacity_reset_interval=8, densify_until_iter=100,
                  densify_grad_threshold=2e-5)
    jo = jtrainer.OptimizationConfig(
        lr=joptim.LRConfig(position_lr_max_steps=12), **common)
    po = ptrainer.OptimizationConfig(
        lr=poptim.LRConfig(position_lr_max_steps=12), **common)
    kw = dict(max_sh_degree=3, feature_dim=F_DIM, capacity_headroom=1.5,
              seed=5)
    jt = jtrainer.Trainer(jscene, ocfg=jo, rcfg=JCFG, **kw)
    pt = _NoiseFromJax(pscene, ocfg=po, rcfg=PCFG, device="cpu", **kw)
    assert pt.ts.params.capacity == jt.ts.params.capacity
    assert pt.rcfg.instance_capacity == jt.rcfg.instance_capacity

    jreports = []
    real_densify = jtrainer.densify_step

    def recording_densify(*a, **k):
        ts, report = real_densify(*a, **k)
        jreports.append({name: int(v) for name, v in
                         report._asdict().items()})
        return ts, report

    monkeypatch.setattr(jtrainer, "densify_step", recording_densify)
    picked = {"jax": [], "port": []}

    def record(tr, name):
        real = tr.pick_camera

        def pick():
            cam = real()
            picked[name].append(cam.uid)
            return cam
        tr.pick_camera = pick

    record(jt, "jax")
    record(pt, "port")

    for it in range(1, 13):
        jm = jt.step()
        pm = pt.step()
        assert pm["finite"] == jm["finite"] == 1.0
        assert int(pm["num_active"]) == int(jm["num_active"]), it
        assert int(pm["num_instances"]) == int(jm["num_instances"]), it
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-4,
                                   err_msg=f"loss @ {it}")
        np.testing.assert_allclose(pm["psnr"], jm["psnr"], rtol=1e-4)
    jt.flush_maintenance(drain=True)
    pt.flush_maintenance(drain=True)
    assert picked["port"] == picked["jax"] and len(picked["jax"]) == 13

    assert [r["iteration"] for r in pt.densify_log] == [4, 8, 12]
    assert len(jreports) == 3
    for mine, ref in zip(pt.densify_log, jreports):
        assert {k: mine[k] for k in ref} == ref
    assert sum(r["num_cloned"] + r["num_split"] for r in jreports) > 0
    assert pt.ts.params.capacity == jt.ts.params.capacity > 128
    assert pt.ts.gstate.active_sh_degree == jt.ts.gstate.active_sh_degree
    assert int(pt.ts.adam.step) == int(jt.ts.adam.step) == 12

    alive = pt.ts.gstate.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(jt.ts.gstate.alive))
    # each group against its learning rate: nearly every element within two
    # steps' worth, none further than every step taken in opposite directions
    lrs = poptim.group_lrs(po.lr, 1, pt.extent)
    for k in FIELDS:
        diff = np.abs(getattr(pt.ts.params, k).numpy()[alive]
                      - np.asarray(getattr(jt.ts.params, k))[alive])
        assert (diff <= 2 * lrs[k]).mean() >= 0.85, (k, diff.max())
        assert diff.max() <= 2 * 12 * lrs[k], (k, diff.max())


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene(n_cams=3, w=W, h=H, n_pts=80, f_dim=F_DIM, seed=0)


def _trainer(scene, ocfg, **kw):
    kw.setdefault("rcfg", PCFG)
    kw.setdefault("max_sh_degree", 2)
    kw.setdefault("capacity_headroom", 2.0)
    return ptrainer.Trainer(scene, ocfg=ocfg, device="cpu", **kw)


def test_opacity_reset_in_loop(scene):
    ocfg = ptrainer.OptimizationConfig(
        iterations=6, densify_from_iter=1, densification_interval=100,
        opacity_reset_interval=3, densify_until_iter=100)
    tr = _trainer(scene, ocfg, max_sh_degree=3)
    for _ in range(3):
        tr.step()
    # the reset of iteration 3 is deferred, so that a save sees the state
    # before it; flush applies it
    assert float(torch.sigmoid(tr.ts.params.opacity).max()) > 0.05
    tr.flush_maintenance()
    op = PG.get_opacity(tr.ts.params)[tr.ts.gstate.alive]
    assert bool((op <= 0.0101).all())
    assert not tr.ts.adam.mu.opacity.any()
    tr.flush_maintenance()                      # nothing pending: a no-op
    assert int(tr.ts.adam.step) == 3


def test_white_background_resets_at_densify_from_iter(scene):
    ocfg = ptrainer.OptimizationConfig(
        iterations=6, densify_from_iter=2, densification_interval=100,
        opacity_reset_interval=1000, densify_until_iter=100)
    tr = _trainer(scene, ocfg, white_background=True)
    assert tr.bg.tolist() == [1.0, 1.0, 1.0]
    for _ in range(2):
        tr.step()
    tr.flush_maintenance()
    assert float(PG.get_opacity(tr.ts.params, tr.ts.gstate.alive).max()) <= 0.0101


def test_ply_save_precedes_opacity_reset(scene, tmp_path):
    ocfg = ptrainer.OptimizationConfig(
        iterations=6, densify_from_iter=100, densification_interval=2,
        opacity_reset_interval=4)
    tr = _trainer(scene, ocfg)
    for _ in range(4):                          # iteration 4: reset boundary
        tr.step()
    assert float(tr.ts.params.opacity.max()) > -3.0     # still learned logits
    path = pckpt.save_scene_ply(str(tmp_path), 4, tr.ts.params, tr.ts.gstate)
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    saved, _ = load_gaussians_ply(path, max_sh_degree=2, device="cpu")
    assert float(saved.opacity.max()) > -3.0
    tr.step()                                   # applies the reset, then trains
    assert tr.iteration == 5
    assert float(tr.ts.params.opacity.max()) < -4.0


def test_sh_degree_rises_every_1000_iterations(scene):
    tr = _trainer(scene, ptrainer.OptimizationConfig(iterations=3000,
                                                     densify_from_iter=10 ** 6))
    for start, degree in ((998, 0), (999, 1), (1999, 2), (2999, 2)):
        tr.iteration = start
        tr.step()
        assert tr.ts.gstate.active_sh_degree == degree


@pytest.mark.parametrize("sync", [True, False])
def test_nonfinite_loss_guard(scene, sync):
    """A blown-up step is discarded on the device (state bit-identical) and
    five non-finite sync points in a row abort; with sync=False a transient
    blow-up between sync points does not poison the state."""
    ocfg = ptrainer.OptimizationConfig(iterations=50)
    if sync:
        tr = _trainer(scene, ocfg)
        tr.step()
        tr.ts.params.features_dc.mul_(float("nan"))
        xyz_before = tr.ts.params.xyz.clone()
        with pytest.raises(FloatingPointError, match="5 consecutive"):
            for _ in range(6):
                m = tr.step()
                assert m["finite"] == 0.0
                assert torch.equal(tr.ts.params.xyz, xyz_before)
        assert int(tr.ts.adam.step) == 1
        return
    poisoned = dataclasses.replace(
        scene, train_cameras=[copy.copy(c) for c in scene.train_cameras])
    bad = poisoned.train_cameras[1]
    bad.image = bad.image.copy()
    bad.image[4:8, 4:8, :] = np.nan
    tr = _trainer(poisoned, ocfg)
    n_bad = 0
    for i in range(9):
        cam = poisoned.train_cameras[i % 3]
        n_bad += cam.uid == 1
        m = tr.step(camera=cam, sync=False)
        assert isinstance(m["loss"], torch.Tensor)
    m = tr.step(camera=poisoned.train_cameras[0], sync=True)
    assert np.isfinite(m["loss"]) and n_bad == 3
    assert int(tr.ts.adam.step) == 10 - n_bad
    assert bool(torch.isfinite(tr.ts.params.xyz).all())
    assert bool(torch.isfinite(tr.ts.adam.mu.xyz).all())


def test_gt_cache_lru_budget():
    big = synthetic_scene(n_cams=12, w=W, h=H, n_pts=96, f_dim=F_DIM)
    per_view = (W * H * 3 + (H // 2) * (W // 2) * F_DIM) * 4
    budget = 5 * per_view           # forces eviction with 12 views + lookahead
    tr = _trainer(big, ptrainer.OptimizationConfig(
        iterations=30, densify_from_iter=1000,
        lr=poptim.LRConfig(position_lr_max_steps=30)), gt_cache_bytes=budget)
    for _ in range(30):
        m = tr.step()
        assert tr._gt_bytes <= budget, (tr._gt_bytes, budget)
    assert np.isfinite(m["loss"])
    assert len(tr._gt_cache) < 24
    assert tr._gt_bytes == sum(n for _, n in tr._gt_cache.values())


def test_fp16_teacher_maps_stay_fp16_and_train_like_f32(scene):
    """fp16 teacher maps are a storage format only: they stay fp16 in the
    device cache and train bit-identically to the same values upcast."""
    def run(dtype):
        cams = [dataclasses.replace(c, semantic_feature=np.asarray(
            c.semantic_feature, np.float32).astype(np.float16).astype(dtype))
            for c in scene.train_cameras]
        sc = dataclasses.replace(scene, train_cameras=cams)
        tr = _trainer(sc, ptrainer.OptimizationConfig(
            iterations=6, densify_from_iter=1000,
            lr=poptim.LRConfig(position_lr_max_steps=6)), max_sh_degree=3)
        for i in range(6):
            m = tr.step(camera=cams[i % len(cams)])
        tr.flush_maintenance()
        return m, tr

    m16, t16 = run(np.float16)
    m32, t32 = run(np.float32)
    assert t16._device_cache(t16.scene.train_cameras[0], "feature").dtype \
        == torch.float16
    assert t32._gt_bytes > t16._gt_bytes
    assert m16["loss"] == m32["loss"]
    for k in FIELDS:
        assert torch.equal(getattr(t16.ts.params, k), getattr(t32.ts.params, k))


def test_capacities_follow_the_scene(scene, capsys):
    """Auto instance capacity in the JAX package's buckets; a round that
    wants more slots than are free grows the Gaussian capacity at the next
    sync point; an overflowing view grows the instance capacity."""
    assert [ptrainer._round_capacity(n) for n in (1, 256, 257, 384, 385, 513,
                                                  100_000, 350_000)] == [
        256, 256, 384, 384, 512, 768, 131072, 393216]
    ocfg = ptrainer.OptimizationConfig(
        iterations=8, densify_from_iter=1, densification_interval=2,
        opacity_reset_interval=1000, densify_until_iter=100,
        densify_grad_threshold=1e-7)
    tr = _trainer(scene, ocfg, rcfg=RasterConfig(tile_w=16, tile_h=16,
                                                 chunk=16),
                  capacity_headroom=1.0)
    assert tr.rcfg.instance_capacity == 1 << 17     # the auto floor
    assert tr.ts.params.capacity == 256
    for _ in range(6):
        tr.step(sync=False)
    assert tr.densify_log == [] and len(tr._pending_reports) == 2
    m = tr.step()                                   # a sync point drains them
    assert tr._pending_reports == [] and len(tr.densify_log) == 3
    assert tr.ts.params.capacity > 256
    assert tr.ts.adam.mu.xyz.shape[0] == tr.ts.params.capacity
    assert tr.ts.gstate.alive.shape[0] == tr.ts.params.capacity
    assert int(m["num_active"]) == tr.densify_log[-1]["num_active"]
    tr.step()                                       # trains at the new size

    tr.rcfg = dataclasses.replace(tr.rcfg, instance_capacity=256)
    m = tr.step()
    assert m["num_instances"] > 0.9 * 256
    assert tr.rcfg.instance_capacity > m["num_instances"] / 0.9
    assert tr.rcfg.instance_capacity == ptrainer._round_capacity(
        tr.rcfg.instance_capacity)                  # a bucket
    assert "growing capacities" in capsys.readouterr().out


def test_train_logs_at_its_sync_points(scene):
    tr = _trainer(scene, ptrainer.OptimizationConfig(iterations=7,
                                                     densify_from_iter=1000))
    seen = []
    history = tr.train(log_every=3, callback=lambda it, m: seen.append(it))
    assert [h["iteration"] for h in history] == seen == [3, 6, 7]
    assert all(isinstance(h["loss"], float) for h in history)
