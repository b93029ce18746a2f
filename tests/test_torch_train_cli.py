"""The port's train CLI on the CPU: ``feature3dgs_tpu_torch.cli.train.main``
in process on a tiny Blender-style scene written to ``tmp_path``: the
artifact tree, B cameras a step, the mesh's world-size check, the
row-sharding flags refused without a mesh and trained with one (their
checkpoint read by the JAX package), resuming from a checkpoint, the
profile, the render CLI on the result, and every flag of scripts/train.py
and scripts/render.py parsing in the port's CLIs.
"""
import argparse
import importlib.util
import json
import os
from unittest import mock

import numpy as np
import pytest

from feature3dgs_tpu_torch import config as C
from feature3dgs_tpu_torch.cli import render as render_cli
from feature3dgs_tpu_torch.cli import train as train_cli
from feature3dgs_tpu_torch.data.dataset import load_scene
from feature3dgs_tpu_torch.data.synthetic import write_blender_scene
from feature3dgs_tpu_torch.train import checkpoints as ckpt

from tests.torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = ["--device", "cpu", "--disable_viewer", "--tile_size", "16",
         "--chunk", "16", "--densify_from_iter", "3",
         "--densification_interval", "4", "--opacity_reset_interval", "10",
         "--densify_grad_threshold", "1e-7"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_blender_scene(str(tmp_path_factory.mktemp("scene")),
                               n_frames=3, size=64, f_dim=8, n_pts=300, seed=0)


def test_written_scene_loads(scene_dir):
    scene = load_scene(scene_dir, foundation_model="lseg")
    assert len(scene.train_cameras) == 3 and not scene.test_cameras
    assert scene.points.shape == (300, 3) and scene.feature_dim == 8
    cam = scene.train_cameras[1]
    assert cam.image.shape == (64, 64, 3)
    assert cam.semantic_feature.shape == (32, 32, 8)
    # every camera looks at the origin from 4 units away
    for c in scene.train_cameras:
        assert np.linalg.norm(c.camera_center) == pytest.approx(4.0, abs=1e-4)
        origin = c.view @ np.array([0.0, 0.0, 0.0, 1.0])
        np.testing.assert_allclose(origin[:3], [0, 0, 4], atol=1e-4)
    assert scene.nerf_norm["radius"] > 0


def test_train_cli_writes_the_artifact_tree(scene_dir, tmp_path, capsys):
    out = str(tmp_path / "out")
    rc = train_cli.main([
        "-s", scene_dir, "-m", out, "-f", "lseg", "--iterations", "12",
        "--save_iterations", "8", "--checkpoint_iterations", "8",
        "--test_iterations", "12", "--sync_every", "4", *SMALL])
    assert rc == 0
    text = capsys.readouterr().out
    assert "not ported" not in text and "viewer disabled" not in text
    assert "[ITER 12] Evaluating train" in text and "Training complete." in text
    assert "[12/12]" in text and "[6/12]" not in text   # sync_every 4
    for rel in ("cfg_args", "cameras.json", "train_log.jsonl", "chkpnt8.ckpt",
                "chkpnt8.meta.json",
                "point_cloud/iteration_8/point_cloud.ply",
                "point_cloud/iteration_12/point_cloud.ply"):
        assert os.path.exists(os.path.join(out, rel)), rel
    cfg = ckpt.load_cfg_args(out)
    assert cfg["iterations"] == 12 and cfg["model_path"] == out
    assert cfg["source_path"] == os.path.abspath(scene_dir)
    assert cfg["alpha_matmul"] is False
    with open(os.path.join(out, "cameras.json")) as f:
        assert [c["img_name"] for c in json.load(f)] == ["r_0", "r_1", "r_2"]
    with open(os.path.join(out, "train_log.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["iteration"] == 12 and np.isfinite(last["loss"])
    assert last["num_active"] > 300                     # densified

    # the full checkpoint comes after iteration 8's round, the PLY before it
    ts, it = ckpt.load_checkpoint(os.path.join(out, "chkpnt8.ckpt"),
                                  device="cpu")
    assert it == 8 and not ts.gstate.denom.any()
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    _, state8 = load_gaussians_ply(
        os.path.join(out, "point_cloud/iteration_8/point_cloud.ply"),
        max_sh_degree=3, device="cpu")
    assert state8.num_active < ts.gstate.num_active

    # the render CLI reads the folder (cfg_args carries the scene and the
    # rasterizer flags)
    assert render_cli.main(["-m", out, "--iteration", "12", "--device",
                            "cpu"]) == 0
    renders = os.path.join(out, "train", "ours_12", "renders")
    assert sorted(os.listdir(renders)) == ["00000.png", "00001.png",
                                           "00002.png"]

    # resume: two more iterations from the checkpoint, into another folder
    out2 = str(tmp_path / "resumed")
    rc = train_cli.main([
        "-s", scene_dir, "-m", out2, "-f", "lseg", "--iterations", "10",
        "--start_checkpoint", os.path.join(out, "chkpnt8.ckpt"),
        "--sync_every", "1", *SMALL])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Restored checkpoint at iteration 8" in text
    assert "[9/10]" in text and "[10/10]" in text and "[8/10]" not in text
    assert os.path.exists(os.path.join(
        out2, "point_cloud/iteration_10/point_cloud.ply"))


def test_train_cli_speedup_alpha_matmul_and_profile(scene_dir, tmp_path):
    """--speedup saves the decoder beside the PLY, --alpha_matmul reaches
    the trainer's RasterConfig, --profile writes its table, trace and the
    program's span summary, and the render CLI finds the decoder in a full
    checkpoint too."""
    out = str(tmp_path / "out")
    rc = train_cli.main([
        "-s", scene_dir, "-m", out, "-f", "lseg", "--speedup",
        "--alpha_matmul", "--iterations", "31", "--save_iterations", "31",
        "--checkpoint_iterations", "31", "--test_iterations", "1000",
        "--profile", str(tmp_path / "prof"), "--quiet", "--device", "cpu",
        "--tile_size", "16", "--chunk", "16", "--densify_from_iter", "1000"])
    assert rc == 0
    assert ckpt.load_cfg_args(out)["alpha_matmul"] is True
    dec = ckpt.load_decoder_checkpoint(
        os.path.join(out, "decoder_chkpnt31.ckpt"), device="cpu")
    assert dec["w"].shape == (2, 8)
    assert os.path.getsize(tmp_path / "prof" / "train_profile.txt") > 0
    assert os.path.exists(tmp_path / "prof" / "train_trace.json")
    with open(tmp_path / "prof" / "train_spans.json") as f:
        spans = json.load(f)
    assert spans["spans"]["train.step"]["count"] >= 10
    assert spans["spans"]["decoder"]["device_ms"] is None    # on the CPU
    assert spans["counters"]["host_wait.host_values"] >= 10
    os.remove(os.path.join(out, "decoder_chkpnt31.ckpt"))
    assert render_cli.main(["-m", out, "--iteration", "31", "--device",
                            "cpu"]) == 0
    saved = np.load(os.path.join(out, "train", "ours_31", "saved_feature",
                                 "00000_fmap_CxHxW.npy"))
    assert saved.shape[0] == 8                          # lifted by the decoder


@pytest.mark.parametrize("flags", [
    ["--distributed", "--shard_gaussians"], ["--shard_gaussians"],
    ["--shard_instances"]])
def test_train_cli_refuses_multi_device_flags(flags, scene_dir, tmp_path):
    """The row-sharding flags without a mesh (``--distributed`` in one
    process gives none) raise scripts/train.py's errors, before anything
    is written."""
    want = {"--shard_gaussians": "--shard_gaussians needs a device mesh: "
                                 "pass --mesh DxT",
            "--shard_instances": "--shard_instances needs --shard_gaussians "
                                 "and a device mesh"}[flags[-1]]
    with pytest.raises(ValueError, match=want):
        train_cli.main(["-s", scene_dir, "-m", str(tmp_path / "o"),
                        "--device", "cpu", *flags])
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("flags", [
    ["--shard_gaussians"], ["--shard_gaussians", "--shard_instances"]])
def test_train_cli_row_sharded_checkpoint_loads_in_jax(flags, scene_dir,
                                                        tmp_path, capsys):
    """``--mesh 1x1 --shard_gaussians`` (and the instance exchange) trains
    in process over densify rounds and an opacity reset; its checkpoint is
    the JAX package's format (the JAX reader gives the port reader's
    arrays) and its PLY holds the densified model."""
    from feature3dgs_tpu.train import checkpoints as jckpt
    out = str(tmp_path / "o")
    rc = train_cli.main([
        "-s", scene_dir, "-m", out, "-f", "lseg", "--iterations", "12",
        "--save_iterations", "12", "--checkpoint_iterations", "12",
        "--test_iterations", "12", "--sync_every", "4", "--mesh", "1x1",
        *flags, *SMALL])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Mesh training: data=1 x tile=1" in text
    assert "[ITER 12] Evaluating train" in text
    path = os.path.join(out, "chkpnt12.ckpt")
    ts, it = ckpt.load_checkpoint(path, device="cpu")
    jts, jit_ = jckpt.load_checkpoint(path)
    assert it == jit_ == 12 and int(ts.adam.step) == 12
    for k in ("xyz", "opacity", "scaling", "semantic_feature"):
        np.testing.assert_array_equal(np.asarray(getattr(jts.params, k)),
                                      getattr(ts.params, k).numpy())
    np.testing.assert_array_equal(np.asarray(jts.gstate.alive),
                                  ts.gstate.alive.numpy())
    assert int(ts.gstate.alive.sum()) > 300             # densified
    with open(os.path.join(out, "train_log.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["iteration"] == 12 and np.isfinite(last["loss"])
    assert os.path.exists(os.path.join(
        out, "point_cloud/iteration_12/point_cloud.ply"))


@pytest.mark.parametrize("case", ["cameras_per_step", "mesh_1x4"])
def test_train_cli_mesh_flags(case, scene_dir, tmp_path, capsys):
    """``--cameras_per_step 2`` trains two cameras a step (a 1 x 1 mesh)
    and writes the single-camera run's tree, saves and checkpoints at the
    steps whose span holds their iteration; ``--mesh 1x4`` in one process
    exits naming the world size it needs and writes nothing."""
    out = str(tmp_path / "o")
    if case == "mesh_1x4":
        with pytest.raises(SystemExit, match="needs a world size of 4"):
            train_cli.main(["-s", scene_dir, "-m", out, "--device", "cpu",
                            "--mesh", "1x4"])
        assert not os.path.exists(out)
        return
    rc = train_cli.main([
        "-s", scene_dir, "-m", out, "-f", "lseg", "--iterations", "12",
        "--save_iterations", "7", "--checkpoint_iterations", "8",
        "--test_iterations", "12", "--sync_every", "4",
        "--cameras_per_step", "2", *SMALL])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Mesh training: data=1 x tile=1 over 1 processes, 2 cameras/step" \
        in text
    assert "[ITER 12] Evaluating train" in text and "[12/12]" in text
    assert "[6/12]" not in text and "[8/12]" in text
    for rel in ("cfg_args", "cameras.json", "train_log.jsonl", "chkpnt8.ckpt",
                "chkpnt8.meta.json",
                "point_cloud/iteration_8/point_cloud.ply",
                "point_cloud/iteration_12/point_cloud.ply"):
        assert os.path.exists(os.path.join(out, rel)), rel
    assert ckpt.load_cfg_args(out)["cameras_per_step"] == 2
    with open(os.path.join(out, "train_log.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["iteration"] == 12 and np.isfinite(last["loss"])
    assert last["num_active"] > 300                     # densified
    ts, it = ckpt.load_checkpoint(os.path.join(out, "chkpnt8.ckpt"),
                                  device="cpu")
    assert it == 8 and int(ts.adam.step) == 4           # one update a step


class _Captured(Exception):
    pass


def _parser_of(main) -> argparse.ArgumentParser:
    """The parser ``main`` builds, caught at its parse_args call."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Captured

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Captured):
            main([])
    return seen["parser"]


def _sample(action, option: str) -> list:
    if action.nargs == 0:
        return [option]
    if action.choices:
        return [option, str(list(action.choices)[-1])]
    value = {int: "3", float: "0.5"}.get(action.type, "x")
    return [option, value]


@pytest.mark.parametrize("script", ["train", "render"])
def test_every_script_flag_parses_in_the_port(script):
    """Each option string of scripts/<script>.py's parser (collected by
    calling its main with parse_args caught) parses in the port's CLI of
    the same name."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"_script_{script}", os.path.join(root, "scripts", f"{script}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    theirs = _parser_of(module.main)
    port_main = train_cli.main if script == "train" else render_cli.main
    ours = _parser_of(port_main)
    options = [(a, o) for a in theirs._actions for o in a.option_strings
               if o not in ("-h", "--help")]
    assert len(options) > 30
    for action, option in options:
        argv = _sample(action, option)
        try:
            ours.parse_args(argv)
        except SystemExit:
            pytest.fail(f"port {script} CLI refuses {argv}")


def test_optimization_flags_round_trip():
    parser = train_cli.build_parser()
    args = parser.parse_args([
        "--iterations", "99", "--position_lr_init", "0.5", "--feature_lr",
        "0.25", "--lambda_dssim", "0.3", "--densify_until_iter", "77",
        "--convert_SHs_python"])
    o = C.extract_optimization(args)
    assert (o.iterations, o.lr.position_lr_init, o.lr.feature_lr,
            o.lambda_dssim, o.densify_until_iter) == (99, 0.5, 0.25, 0.3, 77)
    assert o.lr.position_lr_delay_steps == 0 and o.min_opacity == 0.005
    assert C.extract_pipeline(args) == C.PipelineConfig(
        convert_SHs_python=True)
    from feature3dgs_tpu_torch.train.trainer import OptimizationConfig
    assert C.extract_optimization(parser.parse_args([])) == OptimizationConfig()
