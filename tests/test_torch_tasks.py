"""PyTorch port vs the JAX package: the downstream-task modules.

Novel-view paths at 1e-12 (both numpy float64); edit masks exactly and the
edited SH DC at 1e-6; segmentation labels and every metric exactly; the
ADE20K labels and palette equal; the viewer modes (turbo exactly, edges,
points and normals at 1e-5 relative); LPIPS against ``lpips_distance`` with
one set of random VGG weights in an npz at 1e-5.
"""
import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.data.cameras import Camera as JCamera
from feature3dgs_tpu_torch.data.cameras import Camera as PCamera

from tests.torch_helpers import t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def _cameras(n=6, seed=0):
    """(JAX cameras, port cameras) on a jittered circle looking inwards."""
    rng = np.random.RandomState(seed)
    jc, pc = [], []
    for i in range(n):
        ang = 2 * math.pi * i / n + rng.uniform(-0.1, 0.1)
        eye = np.array([4 * math.sin(ang), rng.uniform(-0.5, 0.5),
                        4 * math.cos(ang)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        rot = np.stack([x, np.cross(z, x), z], 1)   # camera-to-world
        kw = dict(uid=i, colmap_id=i, R=rot, T=-rot.T @ eye, fovx=0.9,
                  fovy=0.7, image=None, image_name=f"r_{i}",
                  semantic_feature=None, width=64, height=48)
        jc.append(JCamera(**kw))
        pc.append(PCamera(**kw))
    return jc, pc


def test_paths_match_jax():
    from feature3dgs_tpu.render import paths as jpaths
    from feature3dgs_tpu_torch.render import paths as ppaths
    jc, pc = _cameras()
    for got, ref in ((ppaths.spiral_path(pc, n_frames=9),
                      jpaths.spiral_path(jc, n_frames=9)),
                     (ppaths.interpolate_poses(pc[0], pc[3], 7),
                      jpaths.interpolate_poses(jc[0], jc[3], 7))):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for a, b in zip(ppaths.spiral_path(pc, n_frames=5),
                    jpaths.spiral_path(jc, n_frames=5)):
        pcam = ppaths.camera_from_w2c(a, pc[1], 3)
        jcam = jpaths.camera_from_w2c(b, jc[1], 3)
        assert isinstance(pcam, PCamera)
        np.testing.assert_allclose(pcam.full_proj, jcam.full_proj,
                                   atol=1e-12)
        assert (pcam.image_name, pcam.width, pcam.fovy) == (
            jcam.image_name, jcam.width, jcam.fovy)


def _edit_inputs(n=300, f_dim=16, n_text=5, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, 1, f_dim).astype(np.float32)
    text = rng.randn(n_text, f_dim).astype(np.float32)
    # a third of the Gaussians lean towards text 0 ("car")
    feats[: n // 3, 0] += 2.0 * text[0]
    return feats, text


@pytest.mark.parametrize("name", ["edit_color", "edit_deletion",
                                  "edit_extraction"])
def test_edit_configs_match_jax(name):
    from feature3dgs_tpu.model import gaussians as JG
    from feature3dgs_tpu.render import editing as jediting
    from feature3dgs_tpu_torch import convert
    from feature3dgs_tpu_torch.model import gaussians as PG
    from feature3dgs_tpu_torch.render import editing as pediting
    path = os.path.join(CONFIGS, name + ".yaml")
    j_edit, j_objects, j_target = jediting.parse_edit_config(path)
    p_edit, p_objects, p_target = pediting.parse_edit_config(path)
    assert (p_objects, p_target) == (j_objects, j_target) == (
        ["car", "tree", "building", "sidewalk", "road"], "car")
    assert {k: v for k, v in p_edit.items() if k != "operations"} == \
        {k: v for k, v in j_edit.items() if k != "operations"}
    assert p_edit["operations"].keys() == j_edit["operations"].keys()

    n = 300
    feats, text = _edit_inputs(n)
    rng = np.random.RandomState(1)
    fields = {"xyz": rng.randn(n, 3), "features_dc": rng.randn(n, 1, 3),
              "features_rest": rng.randn(n, 3, 3) * 0.1,
              "scaling": rng.randn(n, 3), "rotation": rng.randn(n, 4),
              "opacity": rng.randn(n, 1), "semantic_feature": feats}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    pp, _ = convert.gaussians_from_numpy(fields, np.ones(n, bool), 1, "cpu")
    j_params, j_op = jediting.apply_edits(jp, jnp.asarray(text), j_edit)
    p_params, p_op = pediting.apply_edits(pp, t(text), p_edit)
    if j_op is None:
        assert p_op is None
    else:
        zero_j = np.asarray(j_op) == 0
        np.testing.assert_array_equal(p_op.numpy() == 0, zero_j)
        assert 0 < zero_j.sum() < n
        # the opacities the mask keeps: sigmoid rounds by an ulp apart
        np.testing.assert_allclose(p_op.numpy(), np.asarray(j_op), atol=1e-6)
    np.testing.assert_allclose(p_params.features_dc.numpy(),
                               np.asarray(j_params.features_dc), atol=1e-6)
    if name == "edit_color":
        changed = (p_params.features_dc != pp.features_dc).any(-1).any(-1)
        assert 0 < int(changed.sum()) < n
    for k in ("xyz", "opacity", "semantic_feature"):
        assert torch.equal(getattr(p_params, k), getattr(pp, k))
    assert PG.get_opacity(pp).shape == (n,)


@pytest.mark.parametrize("threshold,ids", [(None, [0]), (None, [0, 2]),
                                           (0.3, [1]), (0.3, [0, 1])])
def test_selection_scores_match_jax(threshold, ids):
    from feature3dgs_tpu.render import editing as jediting
    from feature3dgs_tpu_torch.render import editing as pediting
    feats, text = _edit_inputs(seed=3)
    feats = feats[:, 0]
    for fn in ("selection_scores", "selection_scores_delete"):
        ref = getattr(jediting, fn)(jnp.asarray(feats), jnp.asarray(text),
                                    threshold, ids)
        got = getattr(pediting, fn)(t(feats), t(text), threshold, ids)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=fn)
    one = pediting.selection_scores(t(feats), t(text[:1]), 0.1)
    ref = jediting.selection_scores(jnp.asarray(feats), jnp.asarray(text[:1]),
                                    0.1)
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref))


def test_edit_config_mapping_routes():
    """A JSON config (no PyYAML) and a mapping give the YAML file's edit;
    the chip smoke check's mappings are the three configs."""
    import json

    import yaml

    import chip_smoke
    from feature3dgs_tpu_torch.render import editing as pediting
    for name, mapping in chip_smoke.EDIT_CONFIGS.items():
        with open(os.path.join(CONFIGS, name + ".yaml")) as f:
            assert yaml.safe_load(f) == mapping
    mapping = chip_smoke.EDIT_CONFIGS["edit_color"]
    edit, objects, target = pediting.edit_from_config(mapping)
    dc = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(edit["operations"]["color_func"](dc),
                                  dc[:, [2, 1, 0]])
    assert (objects[0], target, edit["score_threshold"]) == ("car", "car", 0.2)


def test_clip_text_loads_precomputed_features(tmp_path):
    from feature3dgs_tpu.tasks import clip_text as jclip
    from feature3dgs_tpu_torch.tasks import clip_text as pclip
    emb = np.random.RandomState(0).randn(4, 8)
    np.save(tmp_path / "t.npy", emb)
    np.savez(tmp_path / "t.npz", emb=emb)
    for name in ("t.npy", "t.npz"):
        got = pclip.load_text_features(str(tmp_path / name))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jclip.load_text_features(str(tmp_path / name)))
    assert pclip.clip_available() == jclip.clip_available()


def test_ade20k_and_segmentation_match_jax():
    from feature3dgs_tpu.tasks import ade20k as jade
    from feature3dgs_tpu.tasks import segmentation as jseg
    from feature3dgs_tpu_torch.tasks import ade20k as pade
    from feature3dgs_tpu_torch.tasks import segmentation as pseg
    assert pade.LABELS == jade.LABELS and len(pade.LABELS) == 150
    np.testing.assert_array_equal(pade.PALETTE, jade.PALETTE)
    rng = np.random.RandomState(0)
    fmap = rng.randn(24, 32, 16).astype(np.float32)
    text = rng.randn(7, 16).astype(np.float32)
    lab, logits = pseg.segment_features(t(fmap), t(text))
    jlab, jlogits = jseg.segment_features(jnp.asarray(fmap), jnp.asarray(text))
    assert lab.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-6)
    lab = lab.numpy()
    np.testing.assert_array_equal(pseg.colorize_labels(lab),
                                  jseg.colorize_labels(lab))
    names = [f"c{i}" for i in range(7)]
    img, entries = pseg.legend_entries(lab, names)
    jimg, jentries = jseg.legend_entries(lab, names)
    np.testing.assert_array_equal(img, jimg)
    assert entries == jentries and len(entries) > 3
    other = rng.randint(0, 7, lab.shape)
    for fn, args in (("pixel_accuracy", (lab, other)),
                     ("mean_iou", (lab, other, 7)),
                     ("topk_frequent_iou", (other, lab, 4))):
        assert getattr(pseg, fn)(*args) == getattr(jseg, fn)(*args), fn
    one_based = rng.choice([4, 15, 29, 40, 58, 90, 3], lab.shape)
    np.testing.assert_array_equal(pseg.replica_remap(one_based),
                                  jseg.replica_remap(one_based))
    np.testing.assert_array_equal(pseg.resize_labels_nearest(lab, 11, 13),
                                  jseg.resize_labels_nearest(lab, 11, 13))


def test_render_modes_match_jax():
    """The turbo colormap exactly; Sobel edges at 1e-5; depth points at 5e-4
    and normals at 5e-3: both packages unproject through the f32 inverse of
    a projection with its near plane at 0.01, and each lands within 1.5e-4
    (points) and 1.5e-3 (normals) of the same math in float64. The normal
    of the bottom-right pixel, the cross product of two equal vectors (both
    neighbours are the zero padding), is rounding noise in either."""
    from feature3dgs_tpu.render import modes as jmodes
    from feature3dgs_tpu_torch.core import transforms
    from feature3dgs_tpu_torch.render import modes as pmodes
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:24, 0:32]
    depth = (3 + 0.5 * np.sin(xx / 5) + 0.3 * np.cos(yy / 4)).astype(
        np.float32)
    np.testing.assert_array_equal(pmodes.colormap(depth, "turbo"),
                                  jmodes.colormap(depth, "turbo"))
    assert pmodes.RENDER_ITEMS == jmodes.RENDER_ITEMS
    image = rng.rand(24, 32, 3).astype(np.float32)
    np.testing.assert_allclose(pmodes.gradient_map(t(image)).numpy(),
                               np.asarray(jmodes.gradient_map(
                                   jnp.asarray(image))), rtol=1e-5,
                               atol=1e-6)
    view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
    proj = (transforms.projection_matrix(0.01, 100.0, 1.0, 0.8) @ view
            ).astype(np.float32)
    interior = np.ones((24, 32), bool)
    interior[-1, -1] = False
    for fn, atol in (("depth_to_points", 5e-4), ("depth_to_normal", 5e-3)):
        got = getattr(pmodes, fn)(t(depth), t(proj)).numpy()
        ref = np.asarray(getattr(jmodes, fn)(jnp.asarray(depth),
                                             jnp.asarray(proj)))
        np.testing.assert_allclose(got[interior], ref[interior], atol=atol,
                                   err_msg=fn)
    pkg = {"color": image, "feature": rng.randn(24, 32, 8).astype(np.float32),
           "depth": depth}
    for mode, item in enumerate(pmodes.RENDER_ITEMS):
        got = pmodes.render_net_image({k: t(v) for k, v in pkg.items()},
                                      pmodes.RENDER_ITEMS, mode, t(proj))
        ref = np.asarray(jmodes.render_net_image(pkg, jmodes.RENDER_ITEMS,
                                                 mode, proj))
        assert got.shape == (24, 32, 3) and got.dtype == np.float32, item
        if item in ("Edge", "Curvature"):
            # a colormap index may move a step or two where the map sits on
            # a bin edge (curvature: from the normals' f32 noise, above, and
            # without the Sobel footprint of the noisy corner normal)
            diff = np.abs(got - ref).max(-1)
            if item == "Curvature":
                diff[-2:, -2:] = 0
            assert (diff > 0).mean() < 0.05 and diff.max() < 0.05, item
        elif item == "Normal":
            np.testing.assert_allclose(got[interior], ref[interior],
                                       atol=5e-3)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=item)


def test_lpips_matches_jax(tmp_path):
    from feature3dgs_tpu.metrics import lpips_jax as LJ
    from feature3dgs_tpu_torch.metrics import lpips as LP
    rng = np.random.RandomState(0)
    weights, prev, ci = {}, 3, 0
    for spec in LJ._VGG16:
        if spec == "M":
            continue
        weights[f"conv{ci}_w"] = (rng.randn(3, 3, prev, spec).astype(
            np.float32) / math.sqrt(9 * prev))
        weights[f"conv{ci}_b"] = rng.randn(spec).astype(np.float32) * 0.1
        prev, ci = spec, ci + 1
    for j, c in enumerate([64, 128, 256, 512, 512]):
        weights[f"lin{j}_w"] = np.abs(rng.randn(c).astype(np.float32)) * 0.05
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **weights)
    a = rng.rand(48, 40, 3).astype(np.float32)
    b = np.clip(a + rng.randn(48, 40, 3).astype(np.float32) * 0.1, 0, 1)
    ref = LJ.lpips_distance(a, b, weights=LJ.load_lpips_weights(path))
    got = LP.lpips_distance(a, b, weights=LP.load_lpips_weights(path, "cpu"))
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert LP.load_lpips_weights(str(tmp_path / "none.npz"), "cpu") is None
