"""PyTorch port vs the JAX package: renderer, decoder, PLY and decoder
checkpoints, and the render CLI's artifact tree.

Render outputs are held to the rasterizer bars (1e-5 absolute on color and
features, 1e-4 on depth, n_contrib exactly); file formats must round-trip
exactly; saved fp16 features agree within fp16 rounding of values that
agree to 2e-5.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.model import decoder as jdec
from feature3dgs_tpu.model import gaussians as JG
from feature3dgs_tpu.model import ply_io as jply
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.render import renderer as jrenderer
from feature3dgs_tpu.train import checkpoints as jckpt
from feature3dgs_tpu_torch import convert
from feature3dgs_tpu_torch.model import decoder as pdec
from feature3dgs_tpu_torch.model import gaussians as PG
from feature3dgs_tpu_torch.model import ply_io as pply
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.render import renderer as prenderer
from feature3dgs_tpu_torch.train import checkpoints as pckpt

from tests.torch_helpers import CPU, cameras, t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _fields(n=240, f_dim=16, sh_degree=3, seed=0) -> dict:
    """Seven GaussianParams arrays (pre-activation), numpy, seeded."""
    rng = np.random.RandomState(seed)
    m = (sh_degree + 1) ** 2
    f32 = np.float32
    return {
        "xyz": rng.uniform(-1.5, 1.5, (n, 3)).astype(f32),
        "features_dc": (rng.randn(n, 1, 3) * 0.5).astype(f32),
        "features_rest": (rng.randn(n, m - 1, 3) * 0.2).astype(f32),
        "scaling": rng.uniform(-3.5, -1.5, (n, 3)).astype(f32),
        "rotation": rng.randn(n, 4).astype(f32),   # un-normalized
        "opacity": rng.uniform(-1.0, 3.0, (n, 1)).astype(f32),
        "semantic_feature": rng.randn(n, 1, f_dim).astype(f32),
    }


def _both(fields, alive, sh_degree=3):
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    n = alive.shape[0]
    js = JG.GaussianState(alive=jnp.asarray(alive),
                          max_radii2d=jnp.zeros(n), xyz_gradient_accum=jnp.zeros(n),
                          denom=jnp.zeros(n), active_sh_degree=sh_degree)
    pp, ps = convert.gaussians_from_numpy(fields, alive, sh_degree, CPU)
    return (jp, js), (pp, ps)


@pytest.mark.parametrize("variant", ["plain", "override_opacity", "outside"])
def test_render_matches_jax(variant):
    fields = _fields()
    alive = np.ones(240, bool)
    alive[200:] = False     # capacity padding
    alive[::11] = False
    (jp, js), (pp, ps) = _both(fields, alive)
    jcam, pcam = cameras(64, 48)
    bg = np.array([0.2, 0.3, 0.9], np.float32)
    jkw, pkw = {}, {}
    if variant == "override_opacity":
        op = np.random.RandomState(9).uniform(0.3, 0.99, 240).astype(np.float32)
        jkw, pkw = dict(override_opacity=jnp.asarray(op)), dict(override_opacity=t(op))
    elif variant == "outside":
        jkw = pkw = dict(compute_cov3d_outside=True, convert_shs_outside=True)
    ref = jrenderer.render(
        jp, js, jcam, bg=jnp.asarray(bg),
        config=JRasterConfig(tile_w=16, tile_h=16, chunk=16,
                             instance_capacity=1 << 13, tile_capacity=1 << 10),
        **jkw)
    got = prenderer.render(pp, ps, pcam, bg=t(bg),
                           config=RasterConfig(tile_w=16, tile_h=16), **pkw)
    for name, atol in (("color", 1e-5), ("feature", 1e-5), ("depth", 1e-4),
                       ("alpha", 1e-5)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=atol,
                                   err_msg=name)
    np.testing.assert_array_equal(got.n_contrib.numpy(), np.asarray(ref.n_contrib))
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(ref.radii))
    assert int(got.total_instances) == int(ref.total_instances)
    assert float(got.color.std()) > 0.01  # a non-trivial image


def test_activations_and_decoder_match_jax():
    fields = _fields(n=64, f_dim=8)
    fields["rotation"][:3] = 0.0    # all-zero padding rows stay finite
    (jp, _), (pp, _) = _both(fields, np.ones(64, bool))
    for fn in ("get_scaling", "get_rotation", "get_opacity", "get_features",
               "get_semantic"):
        np.testing.assert_allclose(getattr(PG, fn)(pp).numpy(),
                                   np.asarray(getattr(JG, fn)(jp)),
                                   rtol=1e-6, atol=1e-7, err_msg=fn)
    assert np.isfinite(PG.get_rotation(pp).numpy()).all()

    jd = jdec.init_decoder(8, 32, seed=3)
    pd = pdec.init_decoder(8, 32, seed=3, device=CPU)
    for k in ("w", "b"):
        np.testing.assert_array_equal(pd[k].numpy(), np.asarray(jd[k]))
    fmap = np.random.RandomState(1).randn(12, 10, 8).astype(np.float32)
    np.testing.assert_allclose(
        pdec.apply_decoder(convert.decoder_from_numpy(
            {k: np.asarray(v) for k, v in jd.items()}, CPU), t(fmap)).numpy(),
        np.asarray(jdec.apply_decoder(jd, jnp.asarray(fmap))),
        rtol=1e-5, atol=1e-6)

    pts = np.random.RandomState(2).randn(30, 3).astype(np.float32)
    cols = np.random.RandomState(3).rand(30, 3).astype(np.float32)
    d2 = np.full(30, 2e-4, np.float32)
    jcp, _ = JG.create_from_pcd(pts, cols, max_sh_degree=3, feature_dim=16,
                                speedup=True, capacity=40, knn_mean_dists=d2)
    pcp, pcs = PG.create_from_pcd(pts, cols, max_sh_degree=3, feature_dim=16,
                                  speedup=True, capacity=40, knn_mean_dists=d2,
                                  device=CPU)
    for k in PG.GaussianParams.FIELDS:
        np.testing.assert_allclose(getattr(pcp, k).numpy(),
                                   np.asarray(getattr(jcp, k)), rtol=1e-6,
                                   err_msg=k)
    assert pcs.num_active == 30


def test_ply_and_decoder_checkpoint_cross_load(tmp_path):
    fields = _fields(n=50, f_dim=6)
    alive = np.ones(50, bool)
    alive[40:] = False
    (jp, js), (pp, ps) = _both(fields, alive)

    jpath = str(tmp_path / "jax.ply")
    jply.save_gaussians_ply(jpath, jp, js)
    ref_p, ref_s = jply.load_gaussians_ply(jpath, max_sh_degree=3)
    got_p, got_s = pply.load_gaussians_ply(jpath, max_sh_degree=3, device=CPU)
    for k in PG.GaussianParams.FIELDS:
        np.testing.assert_array_equal(getattr(got_p, k).numpy(),
                                      np.asarray(getattr(ref_p, k)), err_msg=k)
    np.testing.assert_array_equal(got_s.alive.numpy(), np.asarray(ref_s.alive))
    assert got_s.active_sh_degree == ref_s.active_sh_degree == 3

    ppath = str(tmp_path / "port.ply")
    pply.save_gaussians_ply(ppath, pp, ps)
    with open(ppath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()   # byte-identical files
    back_p, _ = jply.load_gaussians_ply(ppath, max_sh_degree=3)
    for k in PG.GaussianParams.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back_p, k)),
                                      fields[k][:40], err_msg=k)

    dec = jdec.init_decoder(6, 24, seed=5)
    path = jckpt.save_decoder_checkpoint(str(tmp_path), 7, dec)
    loaded = pckpt.load_decoder_checkpoint(path, device=CPU)
    for k in ("w", "b"):
        np.testing.assert_array_equal(loaded[k].numpy(), np.asarray(dec[k]))
        assert loaded[k].dtype == torch.float32


# --- render CLI, both packages, on a tiny Blender scene ---------------------

W, H, F_DIM, N_FRAMES, ITER = 64, 48, 8, 4, 7


def _look_at_c2w(pos):
    """OpenGL camera-to-world looking at the origin (y up)."""
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, back, pos
    return c2w


def _build_model(root: str, model: str):
    from PIL import Image
    rng = np.random.RandomState(0)
    frames = []
    os.makedirs(os.path.join(root, "train"))
    os.makedirs(os.path.join(root, "rgb_feature_langseg"))
    for i in range(N_FRAMES):
        ang = 0.4 * i
        pos = np.array([4.0 * np.sin(ang), 0.3, 4.0 * np.cos(ang)])
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": _look_at_c2w(pos).tolist()})
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, "train", f"r_{i}.png"))
        np.save(os.path.join(root, "rgb_feature_langseg",
                             f"r_{i}_fmap_CxHxW.npy"),
                rng.randn(4 * F_DIM, H // 2, W // 2).astype(np.float16))
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    from feature3dgs_tpu.data.ply import write_ply
    pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    write_ply(os.path.join(root, "points3d.ply"), {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "red": np.full(100, 128, np.uint8), "green": np.full(100, 128, np.uint8),
        "blue": np.full(100, 128, np.uint8)})

    fields = _fields(n=300, f_dim=F_DIM, seed=4)
    fields["xyz"] *= 0.7
    (jp, js), _ = _both(fields, np.ones(300, bool))
    jply.save_gaussians_ply(os.path.join(
        model, "point_cloud", f"iteration_{ITER}", "point_cloud.ply"), jp, js)
    jckpt.save_decoder_checkpoint(model, ITER, jdec.init_decoder(
        F_DIM, 4 * F_DIM, seed=1))
    jckpt.save_cfg_args(model, {
        "source_path": root, "model_path": model, "foundation_model": "lseg",
        "speedup": True, "sh_degree": 3, "white_background": True,
        "instance_capacity": 1 << 13, "tile_capacity": 1 << 10,
        "bwd_chunk": 64, "matmul_precision": "highest"})


def test_render_cli_matches_jax_cli(tmp_path):
    import scripts.render as jax_cli
    from feature3dgs_tpu_torch.cli import render as port_cli
    from PIL import Image

    root = str(tmp_path / "scene")
    model_j, model_p = str(tmp_path / "model_jax"), str(tmp_path / "model_port")
    _build_model(root, model_j)
    shutil.copytree(model_j, model_p)

    jax_cli.main(["-m", model_j, "--iteration", str(ITER)])
    port_cli.main(["-m", model_p, "--iteration", str(ITER), "--device", "cpu"])

    def tree(model):
        base = os.path.join(model, "train", f"ours_{ITER}")
        return base, sorted(os.path.relpath(os.path.join(d, f), base)
                            for d, _, fs in os.walk(base) for f in fs)

    base_j, files_j = tree(model_j)
    base_p, files_p = tree(model_p)
    assert files_p == files_j
    assert len([f for f in files_j if f.startswith("saved_feature")]) == 2 * N_FRAMES

    def img(base, rel):
        return np.asarray(Image.open(os.path.join(base, rel))).astype(int)

    for rel in files_j:
        if rel.startswith("saved_feature") and rel.endswith(".npy"):
            a, b = np.load(os.path.join(base_p, rel)), np.load(os.path.join(base_j, rel))
            assert a.dtype == b.dtype == np.float16
            assert a.shape == b.shape == (4 * F_DIM, H // 2, W // 2)
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                       rtol=2 ** -10, atol=2e-5, err_msg=rel)
        elif rel.startswith("saved_feature"):
            pt = torch.load(os.path.join(base_p, rel))
            assert pt.dtype == torch.float16
            np.testing.assert_array_equal(
                pt.numpy(), np.load(os.path.join(base_p, rel[:-3] + ".npy")))
        elif rel.startswith(("renders", "gt")):
            # 8-bit quantized from values that agree to 1e-5
            assert np.abs(img(base_p, rel) - img(base_j, rel)).max() <= 1, rel
        elif rel.startswith("depth"):
            diff = np.abs(img(base_p, rel) - img(base_j, rel)).max(-1)
            assert (diff > 0).mean() < 0.01, rel


def test_jet_colormap_and_pca_match_jax():
    from feature3dgs_tpu.render import modes as jmodes
    from feature3dgs_tpu_torch.render import modes as pmodes
    rng = np.random.RandomState(0)
    depth = rng.rand(48, 64).astype(np.float32) * 5 + 1
    depth[0, :256 // 64] = np.linspace(1, 6, 4)
    np.testing.assert_array_equal(pmodes.colormap(depth, "jet"),
                                  jmodes.colormap(depth, "jet"))
    fmap = rng.randn(20, 16, 12).astype(np.float32)
    np.testing.assert_allclose(pmodes.feature_pca_vis(fmap),
                               jmodes.feature_pca_vis(fmap), atol=1e-6)
    with pytest.raises(ValueError, match="not available"):
        pmodes.colormap(depth, "viridis")
