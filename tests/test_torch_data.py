"""PyTorch port vs the JAX package: scene loading, cameras, config parsing
and the feature resize. The loaders are numpy copies, so cameras and points
must agree exactly. The resize is held to 3e-5 relative + 1e-5 absolute:
the JAX package runs its two interpolation products at Precision.HIGH
(3-pass bf16, ~1e-6 to 5e-5 relative by its own note, losses.py:44-51),
torch's bilinear kernel in plain f32."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from feature3dgs_tpu import config as jconfig
from feature3dgs_tpu.data import colmap as C
from feature3dgs_tpu.data.dataset import load_scene as jload_scene
from feature3dgs_tpu.train.losses import resize_bilinear_align_corners as jresize
from feature3dgs_tpu_torch import config as pconfig
from feature3dgs_tpu_torch.data.dataset import load_scene as pload_scene
from feature3dgs_tpu_torch.train.losses import resize_bilinear_align_corners

from tests.torch_helpers import CPU, t


def _colmap_scene(root, n_cams=5, w=64, h=48):
    from PIL import Image
    rng = np.random.RandomState(0)
    cams = [C.ColmapCamera(1, "PINHOLE", w, h,
                           np.array([50.0, 52.0, w / 2, h / 2])),
            C.ColmapCamera(2, "SIMPLE_PINHOLE", w, h,
                           np.array([48.0, w / 2, h / 2]))]
    imgs = []
    for i in range(n_cams):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        imgs.append(C.ColmapImage(i + 1, q, rng.randn(3), 1 + i % 2,
                                  f"img_{i:03d}.png"))
    C.write_dummy_model(os.path.join(root, "sparse/0"), cams, imgs,
                        rng.randn(40, 3), rng.randint(0, 256, (40, 3)))
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "sam_embeddings"))
    for i in range(n_cams):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "images", f"img_{i:03d}.png"))
        np.save(os.path.join(root, "sam_embeddings", f"img_{i:03d}_fmap_CxHxW.npy"),
                rng.randn(6, h // 2, w // 2).astype(np.float32))


@pytest.mark.parametrize("eval_split", [False, True])
def test_load_colmap_scene_matches_jax(tmp_path, eval_split):
    root = str(tmp_path)
    _colmap_scene(root)
    kw = dict(foundation_model="sam", resolution=2, eval_split=eval_split)
    ref, got = jload_scene(root, **kw), pload_scene(root, **kw)
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.colors, ref.colors)
    assert got.feature_dim == ref.feature_dim == 6
    np.testing.assert_allclose(got.nerf_norm["translate"],
                               ref.nerf_norm["translate"])
    for split in ("train_cameras", "test_cameras"):
        rc, gc = getattr(ref, split), getattr(got, split)
        assert [c.image_name for c in gc] == [c.image_name for c in rc]
        for a, b in zip(gc, rc):
            assert (a.width, a.height, a.fovx, a.fovy) == (
                b.width, b.height, b.fovx, b.fovy)
            np.testing.assert_array_equal(a.image, b.image)
            np.testing.assert_array_equal(a.semantic_feature, b.semantic_feature)
            pv, jv = a.to_view(CPU), b.to_view()
            for f in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
                np.testing.assert_array_equal(getattr(pv, f).numpy(),
                                              np.asarray(getattr(jv, f)), err_msg=f)
            assert (pv.width, pv.height) == (jv.width, jv.height)
            np.testing.assert_array_equal(pv.focal_x.numpy(), np.asarray(jv.focal_x))


def test_saved_config_parsing_matches_jax(tmp_path):
    """Both cfg_args formats: the JAX trainer's JSON and the original
    code's repr'd Namespace; flags left at defaults take saved values."""
    text = ("Namespace(sh_degree=2, source_path='/data/x', model_path='m', "
            "images='images', resolution=-1, white_background=True, "
            "eval=False, speedup=True, foundation_model='lseg', "
            "data_device='cuda', tile_w=16, tile_h=16, bwd_chunk=32)")
    assert pconfig.parse_saved_namespace(text) == \
        jconfig.parse_saved_namespace(text)
    model = tmp_path / "model"
    model.mkdir()
    (model / "cfg_args").write_text(text)

    def parsed(C, argv):
        import argparse
        ap = argparse.ArgumentParser()
        C.add_model_args(ap)
        C.add_pipeline_args(ap)
        C.add_raster_args(ap)
        args = C.combine_with_saved(ap, argv)
        return C.extract_model(args), C.extract_raster(args)

    for argv in (["-m", str(model)], ["-m", str(model), "--tile_size", "8",
                                      "--sh_degree", "1"]):
        (pm, pr), (jm, jr) = parsed(pconfig, argv), parsed(jconfig, argv)
        assert vars(pm) == {k: v for k, v in vars(jm).items()
                            if k != "render_items"}
        for f in ("tile_w", "tile_h", "chunk", "instance_capacity"):
            assert getattr(pr, f) == getattr(jr, f), f


@pytest.mark.parametrize("out_hw", [(24, 32), (48, 64), (7, 5), (1, 1)])
def test_feature_resize_matches_jax(out_hw):
    img = np.random.RandomState(0).randn(48, 64, 5).astype(np.float32)
    got = resize_bilinear_align_corners(t(img), *out_hw)
    ref = jresize(jnp.asarray(img), *out_hw)
    assert got.shape == (*out_hw, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=1e-5)
