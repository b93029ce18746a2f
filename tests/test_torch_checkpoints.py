"""PyTorch port vs the JAX package: checkpoints in the JAX package's file
formats, both ways.

A full training checkpoint (``chkpnt{N}.ckpt`` + ``.meta.json``) written by
either package loads in the other with every leaf bit-equal, with and
without the speed-up decoder; the port's pure-Python msgpack writer emits
flax's bytes; the decoder loads from a decoder file or a full checkpoint;
and a resumed ``Trainer`` takes the same next step as the one that went on.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from feature3dgs_tpu.data.synthetic import synthetic_scene as jsynthetic_scene
from feature3dgs_tpu.model import gaussians as JG
from feature3dgs_tpu.model import optim as joptim
from feature3dgs_tpu.train import checkpoints as jckpt
from feature3dgs_tpu.train import trainer as jtrainer
from feature3dgs_tpu_torch import convert
from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
from feature3dgs_tpu_torch.model import gaussians as PG
from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.train import checkpoints as pckpt
from feature3dgs_tpu_torch.train import trainer as ptrainer

from tests.torch_helpers import CPU

FIELDS = PG.GaussianParams.FIELDS


def _numpy_state(n=37, f_dim=6, seed=0, decoder=False) -> dict:
    """A full training state of random leaves, as nested numpy."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    shapes = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (8, 3),
              "scaling": (3,), "rotation": (4,), "opacity": (1,),
              "semantic_feature": (1, f_dim)}
    fields = lambda: {k: rng.randn(n, *s).astype(f32)
                      for k, s in shapes.items()}
    state = {
        "params": fields(),
        "gstate": {"alive": rng.rand(n) > 0.3,
                   "max_radii2d": rng.rand(n).astype(f32) * 9,
                   "xyz_gradient_accum": rng.rand(n).astype(f32),
                   "denom": rng.randint(0, 5, n).astype(f32),
                   "active_sh_degree": 2, "spatial_lr_scale": 3.25},
        "adam": {"mu": fields(), "nu": fields(), "step": np.int32(41)},
    }
    if decoder:
        dec = lambda: {"w": rng.randn(f_dim, 4 * f_dim).astype(f32),
                       "b": rng.randn(4 * f_dim).astype(f32)}
        state["decoder"] = dec()
        state["decoder_adam"] = {"mu": dec(), "nu": dec(),
                                 "step": np.int32(41)}
    return state


def _jax_state(state) -> jtrainer.TrainState:
    jp = lambda d: JG.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
    gs = state["gstate"]
    dec = state.get("decoder")
    da = state.get("decoder_adam")
    return jtrainer.TrainState(
        params=jp(state["params"]),
        gstate=JG.GaussianState(
            alive=jnp.asarray(gs["alive"]),
            max_radii2d=jnp.asarray(gs["max_radii2d"]),
            xyz_gradient_accum=jnp.asarray(gs["xyz_gradient_accum"]),
            denom=jnp.asarray(gs["denom"]),
            active_sh_degree=gs["active_sh_degree"],
            spatial_lr_scale=gs["spatial_lr_scale"]),
        adam=joptim.AdamState(mu=jp(state["adam"]["mu"]),
                              nu=jp(state["adam"]["nu"]),
                              step=jnp.asarray(state["adam"]["step"])),
        decoder=None if dec is None else {k: jnp.asarray(v)
                                          for k, v in dec.items()},
        decoder_adam=None if da is None else joptim.TensorAdamState(
            mu={k: jnp.asarray(v) for k, v in da["mu"].items()},
            nu={k: jnp.asarray(v) for k, v in da["nu"].items()},
            step=jnp.asarray(da["step"])))


def _leaves(ts) -> dict:
    """Every leaf of a TrainState of either package as numpy, by path."""
    out = {}
    for k in FIELDS:
        out[f"params.{k}"] = getattr(ts.params, k)
        out[f"mu.{k}"] = getattr(ts.adam.mu, k)
        out[f"nu.{k}"] = getattr(ts.adam.nu, k)
    for k in ("alive", "max_radii2d", "xyz_gradient_accum", "denom"):
        out[f"gstate.{k}"] = getattr(ts.gstate, k)
    out["adam.step"] = ts.adam.step
    if ts.decoder is not None:
        for k in ("w", "b"):
            out[f"decoder.{k}"] = ts.decoder[k]
            out[f"decoder_mu.{k}"] = ts.decoder_adam.mu[k]
            out[f"decoder_nu.{k}"] = ts.decoder_adam.nu[k]
        out["decoder_adam.step"] = ts.decoder_adam.step
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert a.gstate.active_sh_degree == b.gstate.active_sh_degree
    assert a.gstate.spatial_lr_scale == b.gstate.spatial_lr_scale
    assert (a.decoder is None) == (b.decoder is None)
    assert (a.decoder_adam is None) == (b.decoder_adam is None)


@pytest.mark.parametrize("decoder", [False, True])
def test_jax_checkpoint_loads_in_the_port(decoder, tmp_path):
    state = _numpy_state(decoder=decoder)
    jts = _jax_state(state)
    path = jckpt.save_checkpoint(str(tmp_path), 1234, jts)
    pts, it = pckpt.load_checkpoint(path, device="cpu")
    assert it == 1234
    _assert_same_state(pts, jts)
    assert pts.gstate.alive.dtype == torch.bool
    assert pts.adam.step.dtype == torch.int32 and pts.adam.step.dim() == 0
    # the same state, built directly from numpy
    _assert_same_state(pts, convert.train_state_from_numpy(state, CPU))


@pytest.mark.parametrize("decoder", [False, True])
def test_port_checkpoint_loads_in_jax(decoder, tmp_path):
    state = _numpy_state(seed=1, decoder=decoder)
    pts = convert.train_state_from_numpy(state, CPU)
    path = pckpt.save_checkpoint(str(tmp_path / "out"), 77, pts)
    assert os.path.basename(path) == "chkpnt77.ckpt"
    with open(tmp_path / "out" / "chkpnt77.meta.json") as f:
        assert json.load(f) == {"iteration": 77}
    jts, it = jckpt.load_checkpoint(path)
    assert it == 77
    _assert_same_state(jts, pts)
    # and the file is byte for byte what the JAX package writes
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 77, _jax_state(state))
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    # round trip through the port alone
    back, it = pckpt.load_checkpoint(path, device="cpu")
    _assert_same_state(back, pts)


def test_missing_meta_file_means_iteration_zero(tmp_path):
    pts = convert.train_state_from_numpy(_numpy_state(), CPU)
    path = pckpt.save_checkpoint(str(tmp_path), 5, pts)
    os.remove(str(tmp_path / "chkpnt5.meta.json"))
    assert pckpt.load_checkpoint(path, device="cpu")[1] == 0


def test_msgpack_writer_emits_flax_bytes():
    rng = np.random.RandomState(0)
    tree = {
        "a": {"x": rng.randn(3, 4).astype(np.float32), "none": {"__none__": True},
              "flag": True, "off": False},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33,
                 -129, -32769, -2 ** 31 - 1],
        "float": 0.1, "text": "café", "long": "x" * 300,
        "bytes": b"\x00\x01", "scalar": np.float32(1.5),
        "i64": np.arange(5), "f16": rng.randn(2).astype(np.float16),
        "bool": np.array([True, False]), "zero_d": np.asarray(np.int32(7)),
        "empty": np.zeros((0, 3), np.float32),
        "wide": {f"k{i}": i for i in range(20)},
        "list": list(range(20)),
    }
    mine = pckpt.msgpack_serialize(tree)
    assert mine == serialization.msgpack_serialize(tree)
    back = pckpt.msgpack_restore(mine)
    ref = serialization.msgpack_restore(mine)
    assert back["ints"] == tree["ints"] and back["text"] == tree["text"]
    assert back["wide"] == tree["wide"] and back["list"] == tree["list"]
    for k in ("i64", "f16", "bool", "zero_d", "empty"):
        np.testing.assert_array_equal(back[k], ref[k])
        assert back[k].dtype == tree[k].dtype
    assert back["scalar"] == np.float32(1.5)
    with pytest.raises(TypeError, match="cannot pack"):
        pckpt.msgpack_serialize({"x": object()})
    with pytest.raises(TypeError, match="not all strings"):
        pckpt.msgpack_serialize({1: 2})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_decoder_loads_from_decoder_file_and_full_checkpoint(writer, tmp_path):
    state = _numpy_state(seed=2, decoder=True)
    if writer == "jax":
        jts = _jax_state(state)
        full = jckpt.save_checkpoint(str(tmp_path), 9, jts)
        alone = jckpt.save_decoder_checkpoint(str(tmp_path), 9, jts.decoder)
    else:
        pts = convert.train_state_from_numpy(state, CPU)
        full = pckpt.save_checkpoint(str(tmp_path), 9, pts)
        alone = pckpt.save_decoder_checkpoint(str(tmp_path), 9, pts.decoder)
        ref = jckpt.load_decoder_checkpoint(alone)      # JAX reads it too
        np.testing.assert_array_equal(np.asarray(ref["w"]),
                                      state["decoder"]["w"])
    assert os.path.basename(alone) == "decoder_chkpnt9.ckpt"
    for path in (full, alone):
        dec = pckpt.load_decoder_checkpoint(path, device="cpu")
        assert set(dec) == {"w", "b"}
        for k in dec:
            np.testing.assert_array_equal(dec[k].numpy(), state["decoder"][k])
    # a checkpoint trained without --speedup holds none
    bare = pckpt.save_checkpoint(
        str(tmp_path / "bare"), 9,
        convert.train_state_from_numpy(_numpy_state(), CPU))
    with pytest.raises(ValueError, match="holds no decoder"):
        pckpt.load_decoder_checkpoint(bare, device="cpu")


def test_cfg_args_cameras_json_and_scene_ply_match_jax(tmp_path):
    pscene = synthetic_scene(n_cams=3, w=32, h=24, n_pts=20, f_dim=4, seed=1)
    jscene = jsynthetic_scene(n_cams=3, w=32, h=24, n_pts=20, f_dim=4, seed=1)
    cfg = {"iterations": 7, "source_path": "/data/x", "lr": 1e-3,
           "save_iterations": [3, 7], "mesh": None}
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    pckpt.save_cfg_args(pdir, cfg)
    jckpt.save_cfg_args(jdir, cfg)
    pckpt.save_cameras_json(pdir, pscene.train_cameras)
    jckpt.save_cameras_json(jdir, jscene.train_cameras)
    for name in ("cfg_args", "cameras.json"):
        with open(os.path.join(pdir, name)) as a, \
                open(os.path.join(jdir, name)) as b:
            assert a.read() == b.read(), name
    assert pckpt.load_cfg_args(pdir) == cfg == jckpt.load_cfg_args(jdir)

    pts = convert.train_state_from_numpy(_numpy_state(), CPU)
    path = pckpt.save_scene_ply(pdir, 30, pts.params, pts.gstate)
    assert path == os.path.join(pdir, "point_cloud", "iteration_30",
                                "point_cloud.ply")
    params, state = load_gaussians_ply(path, max_sh_degree=2, device="cpu")
    alive = pts.gstate.alive
    assert state.num_active == int(alive.sum())
    np.testing.assert_array_equal(params.xyz.numpy(),
                                  pts.params.xyz[alive].numpy())


def test_resumed_trainer_takes_the_same_next_step(tmp_path):
    """Five steps with a densify round, a full checkpoint (after the
    iteration's maintenance), then the same camera through the original and
    through a fresh Trainer that restored the file: every leaf bit-equal."""
    scene = synthetic_scene(n_cams=4, w=48, h=32, n_pts=80, f_dim=4, seed=0)
    ocfg = ptrainer.OptimizationConfig(
        iterations=10, densify_from_iter=2, densification_interval=3,
        opacity_reset_interval=100, densify_until_iter=100,
        densify_grad_threshold=1e-6)
    kw = dict(ocfg=ocfg, rcfg=RasterConfig(tile_w=16, tile_h=16, chunk=16),
              seed=3, capacity_headroom=2.0, device="cpu")
    first = ptrainer.Trainer(scene, **kw)
    for _ in range(6):
        first.step()
    first.flush_maintenance(drain=True)
    assert first.densify_log and first.densify_log[-1]["iteration"] == 6
    path = pckpt.save_checkpoint(str(tmp_path), first.iteration, first.ts)

    second = ptrainer.Trainer(scene, **kw)
    ts, it = pckpt.load_checkpoint(path, device="cpu")
    second.restore_state(ts)
    second.iteration = it
    second.rcfg = first.rcfg
    assert it == 6 and second.ts.params.capacity == first.ts.params.capacity
    cam = scene.train_cameras[2]
    m_a = first.step(camera=cam)
    m_b = second.step(camera=cam)
    assert m_a == m_b and m_a["finite"] == 1.0
    _assert_same_state(first.ts, second.ts)
    with pytest.raises(ValueError, match="checkpoint state is on"):
        bad = pckpt.load_checkpoint(path, device="cpu")[0]
        bad.params.xyz = bad.params.xyz.to("meta")
        second.restore_state(bad)
