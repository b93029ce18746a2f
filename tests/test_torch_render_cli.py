"""PyTorch port vs the JAX package: the render CLI's batched, novel-view,
video and editing paths, and the segmentation, segmentation-metric and
metrics CLIs, each against its scripts/ counterpart on the small trained
model of tests/test_torch_render.py.

Artifact trees must hold the same file names; renders and gt within one
uint8 step (8-bit quantized from values that agree to 1e-5); depth maps
on all but 1% of the pixels (a jet bin edge); saved fp16 features within
fp16 rounding of values that agree to 2e-5; segmentation labels exactly;
JSON numbers at 1e-5.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_render import F_DIM, ITER, N_FRAMES, _build_model
from tests.torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
N_TEXT = 5
LABELS = "car,tree,building,sidewalk,road"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(scene, model dir, text features for editing, text features for
    segmentation): one trained model; edits score the Gaussians' F_DIM
    features, segmentation the saved maps, which the decoder lifted to
    4 * F_DIM channels."""
    tmp = tmp_path_factory.mktemp("cli")
    root, model = str(tmp / "scene"), str(tmp / "model")
    _build_model(root, model)
    texts = []
    for name, dim in (("edit.npy", F_DIM), ("seg.npy", 4 * F_DIM)):
        texts.append(str(tmp / name))
        np.save(texts[-1], np.random.RandomState(dim).randn(N_TEXT, dim)
                .astype(np.float32))
    return (root, model, *texts)


def _fresh(models, tmp_path):
    mj, mp = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(models[1], mj)
    shutil.copytree(models[1], mp)
    return mj, mp, models[2]


def _run_both(mj, mp, flags):
    import scripts.render as jax_cli
    from feature3dgs_tpu_torch.cli import render as port_cli
    jax_cli.main(["-m", mj, "--iteration", str(ITER)] + flags)
    assert port_cli.main(["-m", mp, "--iteration", str(ITER), "--device",
                          "cpu"] + flags) == 0


def _files(base):
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def _img(path):
    from PIL import Image
    return np.asarray(Image.open(path)).astype(int)


def _compare_set(base_j, base_p, n_views):
    files = _files(base_j)
    assert _files(base_p) == files, base_p
    assert len([f for f in files if f.startswith("renders")]) == n_views
    for rel in files:
        a, b = os.path.join(base_p, rel), os.path.join(base_j, rel)
        if rel.startswith("saved_feature") and rel.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype == np.float16 and x.shape == y.shape
            np.testing.assert_allclose(x.astype(np.float32),
                                       y.astype(np.float32), rtol=2 ** -10,
                                       atol=2e-5, err_msg=rel)
        elif rel.startswith("saved_feature"):
            np.testing.assert_array_equal(torch.load(a).numpy(),
                                          np.load(a[:-3] + ".npy"))
        elif rel.startswith(("renders", "gt")):
            assert np.abs(_img(a) - _img(b)).max() <= 1, rel
        elif rel.startswith("depth"):
            assert ((np.abs(_img(a) - _img(b)).max(-1) > 0).mean()
                    < 0.01), rel


def test_render_cli_batch_with_uneven_tails(models, tmp_path):
    """--render_batch 3: the 4 train views run as a batch of 3 and a
    single view, the 5 novel views as a batch of 3 and a padded batch of
    2; --novel_view interpolates between the first and last camera."""
    mj, mp, _ = _fresh(models, tmp_path)
    _run_both(mj, mp, ["--render_batch", "3", "--novel_view",
                       "--num_views", "5"])
    for name, n in (("train", N_FRAMES), ("novel_views", 5)):
        _compare_set(os.path.join(mj, name, f"ours_{ITER}"),
                     os.path.join(mp, name, f"ours_{ITER}"), n)


def test_render_cli_multi_interpolate_and_video(models, tmp_path):
    mj, mp, _ = _fresh(models, tmp_path)
    _run_both(mj, mp, ["--skip_train", "--novel_view", "--multi_interpolate",
                       "--num_views", "3", "--video", "--render_batch", "2"])
    assert not os.path.exists(os.path.join(mp, "train"))
    for name in ("novel_views", "video"):
        _compare_set(os.path.join(mj, name, f"ours_{ITER}"),
                     os.path.join(mp, name, f"ours_{ITER}"), 3)


@pytest.mark.parametrize("config,suffix", [
    ("edit_deletion", "deletion_car"), ("edit_extraction", "extraction_car"),
    ("edit_color", "color_func_car")])
def test_render_cli_edit_configs(models, tmp_path, config, suffix):
    mj, mp, text = _fresh(models, tmp_path)
    _run_both(mj, mp, ["--skip_train", "--novel_view", "--num_views", "2",
                       "--edit_config", os.path.join(CONFIGS, config + ".yaml"),
                       "--text_features", text])
    base = os.path.join("novel_views", f"ours_{ITER}_{suffix}")
    _compare_set(os.path.join(mj, base), os.path.join(mp, base), 2)


@pytest.fixture(scope="module")
def rendered(models, tmp_path_factory):
    """The JAX render CLI's train set of the model: the features the
    segmentation CLIs read (both read the same files)."""
    import scripts.render as jax_cli
    mj = str(tmp_path_factory.mktemp("rendered") / "jax")
    shutil.copytree(models[1], mj)
    jax_cli.main(["-m", mj, "--iteration", str(ITER)])
    return os.path.join(mj, "train", f"ours_{ITER}")


def test_segmentation_cli_matches_jax(models, rendered, tmp_path):
    import scripts.segmentation as jax_seg
    from feature3dgs_tpu_torch.cli import segmentation as port_seg
    flags = ["--feature_dir", os.path.join(rendered, "saved_feature"),
             "--label_src", LABELS, "--text_features", models[3],
             "--image_dir", os.path.join(rendered, "renders")]
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_seg.main(flags + ["--output", out_j])
    assert port_seg.main(flags + ["--output", out_p, "--device", "cpu"]) == 0
    files = _files(out_j)
    assert _files(out_p) == files
    assert len([f for f in files if f.endswith("_legend.png")]) == N_FRAMES
    for rel in files:
        a, b = os.path.join(out_p, rel), os.path.join(out_j, rel)
        if rel.endswith("_labels.npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        elif rel.endswith(("_mask.png", "_vis.png")):
            assert np.abs(_img(a) - _img(b)).max() <= 1, rel
    legend = _img(os.path.join(out_p, files[0].replace("_labels.npy",
                                                         "_legend.png")))
    assert legend.ndim == 3 and legend.shape[0] > 48


@pytest.mark.parametrize("protocol", [[], ["--replica_protocol"]])
def test_segmentation_metric_cli_matches_jax(models, rendered, tmp_path,
                                             protocol):
    import scripts.segmentation_metric as jax_metric
    from feature3dgs_tpu_torch.cli import segmentation_metric as port_metric
    flags = ["--student_dir", os.path.join(rendered, "saved_feature"),
             "--teacher_dir", os.path.join(models[0], "rgb_feature_langseg"),
             "--label_src", LABELS, "--text_features", models[3],
             "--resize", "40", "30"] + protocol
    out_j, out_p = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_metric.main(flags + ["--output", out_j])
    assert port_metric.main(flags + ["--output", out_p, "--device",
                                     "cpu"]) == 0
    with open(out_j) as f, open(out_p) as g:
        ref, got = json.load(f), json.load(g)
    assert got.keys() == ref.keys() and len(got["per_image"]) == N_FRAMES
    for key in ("mean_accuracy", "mean_miou"):
        assert got[key] == pytest.approx(ref[key], abs=1e-5), key
    for a, b in zip(got["per_image"], ref["per_image"]):
        assert (a["student"], a["teacher"]) == (b["student"], b["teacher"])
        for key in ("accuracy", "miou"):
            assert a[key] == pytest.approx(b[key], abs=1e-5), key


def test_metrics_cli_matches_jax(rendered, tmp_path):
    """Both metrics CLIs score the same renders (the train set copied in as
    a test method): results.json and per_view.json agree; LPIPS is null
    without weights."""
    import scripts.metrics as jax_metrics
    from feature3dgs_tpu_torch.cli import metrics as port_metrics
    models = {}
    for name in ("jax", "port"):
        models[name] = str(tmp_path / name)
        for sub in ("renders", "gt"):
            shutil.copytree(os.path.join(rendered, sub), os.path.join(
                models[name], "test", f"ours_{ITER}", sub))
    os.environ.pop("LPIPS_WEIGHTS", None)
    jax_metrics.main(["-m", models["jax"]])
    assert port_metrics.main(["-m", models["port"], "--device", "cpu"]) == 0
    for fname in ("results.json", "per_view.json"):
        with open(os.path.join(models["jax"], fname)) as f:
            ref = json.load(f)
        with open(os.path.join(models["port"], fname)) as f:
            got = json.load(f)
        assert got.keys() == ref.keys() == {f"ours_{ITER}"}, fname
        for method in ref:
            assert got[method].keys() == ref[method].keys()
            for key, value in ref[method].items():
                if key == "LPIPS" or value is None:
                    assert got[method][key] == value or all(
                        v is None for v in got[method][key].values())
                elif isinstance(value, dict):
                    assert got[method][key].keys() == value.keys()
                    for view, x in value.items():
                        assert got[method][key][view] == pytest.approx(
                            x, abs=1e-5), (key, view)
                else:
                    assert got[method][key] == pytest.approx(value, abs=1e-5)
