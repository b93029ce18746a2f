"""PyTorch port vs the JAX package: batched rendering (``rasterize_batch``,
``bin_gaussians_batch``, ``render_batch``).

The port's batch is bit-equal to one ``rasterize`` per view (the JAX
package asserts the same of itself, tests/test_rasterize.py:196-228), and
matches the JAX package's ``rasterize_batch`` at the rasterizer bars: 1e-5
absolute on color, features and alpha (1 - final_T), 1e-4 on depth,
``n_contrib`` exactly; the ``alpha_matmul`` mode at 4x its own contract
(1e-4 / 5e-4, n_contrib off by at most 1 on under 1% of the pixels),
because two implementations of the mode part by up to 1.7e-4 at 32-wide
tiles (ROADMAP.md Queue 3). The JAX side runs with backend "xla" and with
"pallas_interpret"; the port's plain compositor stands in for its kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.core import projection as jproj
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.ops import binning as jbin
from feature3dgs_tpu.ops.rasterize import rasterize_batch as jrasterize_batch
from feature3dgs_tpu.ops.rasterize import rect_radius as jrect_radius
from feature3dgs_tpu_torch.ops import binning as pbin
from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig, rasterize,
                                                 rasterize_batch)

from tests.torch_helpers import cameras, scene, t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 64, 48
SH = 2
CAMS = ((-4.0, 1.0), (-3.0, 1.1), (-5.5, 0.9))   # (cam_z, fovx)
FIELDS = ("color", "feature", "depth", "alpha", "n_contrib", "radii",
          "visibility", "total_instances", "max_tile_count", "feature_tiles")


def _both_cams(specs=CAMS):
    pairs = [cameras(W, H, cam_z=z, fovx=fx) for z, fx in specs]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    return jstack, [p[1] for p in pairs]


def _splats(g):
    return dict(scales=t(g["scales"]), rotations=t(g["rotations"]),
                shs=t(g["shs"]), sh_degree=SH)


@pytest.mark.parametrize("alpha_matmul", [False, True])
def test_batch_is_bit_equal_to_per_view_rasterize(alpha_matmul):
    g = scene(n=250, f_dim=8, seed=7, boost=2.0)
    _, views = _both_cams()
    bg = torch.tensor([0.2, 0.1, 0.5])
    cfg = RasterConfig(chunk=32, alpha_matmul=alpha_matmul)
    args = (t(g["means3d"]), t(g["opacities"]), t(g["feat"]))
    batch = rasterize_batch(*args, views, bg=bg, config=cfg, **_splats(g))
    for b, view in enumerate(views):
        one = rasterize(*args, view, bg=bg, config=cfg, **_splats(g))
        for name in FIELDS:
            assert torch.equal(getattr(batch, name)[b], getattr(one, name)), \
                (b, name)
    assert batch.color.shape == (3, H, W, 3)
    assert batch.total_instances.shape == batch.max_tile_count.shape == (3,)


def test_batch_of_one_and_stacked_views_equal_rasterize():
    """B = 1 is rasterize; a stacked CameraView is the list it stacks."""
    g = scene(n=200, f_dim=4, seed=2)
    _, views = _both_cams()
    args = (t(g["means3d"]), t(g["opacities"]), t(g["feat"]))
    one = rasterize(*args, views[1], **_splats(g))
    batch = rasterize_batch(*args, [views[1]], **_splats(g))
    for name in FIELDS:
        assert torch.equal(getattr(batch, name)[0], getattr(one, name)), name
    stacked = dataclasses.replace(
        views[0], **{f: torch.stack([getattr(v, f) for v in views])
                     for f in ("view", "proj", "campos", "tan_fovx",
                               "tan_fovy")})
    a = rasterize_batch(*args, stacked, **_splats(g))
    b = rasterize_batch(*args, views, **_splats(g))
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_batch_refuses_gradients_and_mixed_sizes():
    g = scene(n=50, f_dim=4, seed=1)
    _, views = _both_cams()
    means = t(g["means3d"]).requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        rasterize_batch(means, t(g["opacities"]), t(g["feat"]), views,
                        **_splats(g))
    with torch.no_grad():
        rasterize_batch(means, t(g["opacities"]), t(g["feat"]), views,
                        **_splats(g))
    small = cameras(32, 32)[1]
    with pytest.raises(ValueError, match="same-resolution"):
        rasterize_batch(t(g["means3d"]), t(g["opacities"]), t(g["feat"]),
                        [views[0], small], **_splats(g))


@pytest.mark.parametrize("backend,alpha_matmul", [
    ("xla", False), ("pallas_interpret", False), ("pallas_interpret", True)])
def test_batch_matches_jax_rasterize_batch(backend, alpha_matmul):
    g = scene(n=250, f_dim=8, seed=5, boost=2.0)
    jcams, views = _both_cams()
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    ref = jrasterize_batch(
        jnp.asarray(g["means3d"]), jnp.asarray(g["opacities"]),
        jnp.asarray(g["feat"]), jcams, scales=jnp.asarray(g["scales"]),
        rotations=jnp.asarray(g["rotations"]), shs=jnp.asarray(g["shs"]),
        sh_degree=SH, bg=jnp.asarray(bg),
        config=JRasterConfig(chunk=32, backend=backend,
                             instance_capacity=1 << 13, tile_capacity=1 << 10,
                             alpha_matmul=alpha_matmul))
    got = rasterize_batch(t(g["means3d"]), t(g["opacities"]), t(g["feat"]),
                          views, bg=t(bg), config=RasterConfig(
                              chunk=32, alpha_matmul=alpha_matmul),
                          **_splats(g))
    scale = 4 if alpha_matmul else 1
    bars = ((("color", "feature", "alpha"), 1e-4 * scale if alpha_matmul
             else 1e-5), (("depth",), 5e-4 * scale if alpha_matmul else 1e-4))
    for names, atol in bars:
        for name in names:
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=atol, err_msg=name)
    ncon = np.asarray(ref.n_contrib).astype(np.int64)
    if alpha_matmul:
        diff = np.abs(got.n_contrib.numpy() - ncon)
        assert (diff > 0).mean() < 0.01 and diff.max() <= 1
    else:
        np.testing.assert_array_equal(got.n_contrib.numpy(), ncon)
    for name in ("radii", "total_instances", "max_tile_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert float(got.color.std()) > 0.01


def test_capacity_cuts_one_camera_as_jax():
    """A capacity between the cameras' instance totals cuts camera 1 alone
    (the nearest camera has the most instances), per camera as the JAX
    package's vmap of bin_gaussians: totals, counts and every tile's list
    equal JAX's, and each camera's lists equal bin_gaussians of it alone."""
    g = scene(n=300, f_dim=4, seed=0, boost=2.0)
    jcams, _ = _both_cams(((-4.0, 1.0), (-3.0, 0.5), (-5.0, 1.2)))
    grid = jbin.TileGrid(W, H, 8, 8)

    def rects(cam):
        pre = jproj.preprocess(
            jnp.asarray(g["means3d"]), jnp.asarray(g["opacities"]), cam,
            scales=jnp.asarray(g["scales"]),
            rotations=jnp.asarray(g["rotations"]), shs=jnp.asarray(g["shs"]),
            sh_degree=SH)
        rmin, rmax = jproj.tile_rect(pre.xy, jrect_radius(pre.radius,
                                                          pre.opacity),
                                     grid.grid_x, grid.grid_y, 8, 8)
        area = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
        return rmin, rmax, pre.depth, pre.valid & (area > 0)

    rmin, rmax, depth, valid = jax.vmap(rects)(jcams)
    full = pbin.bin_gaussians_batch(t(rmin), t(rmax), t(depth), t(valid),
                                    pbin.TileGrid(*grid), instance_capacity=1 << 20)
    totals = full.total.tolist()
    assert totals[1] == max(totals)
    # the JAX expansion takes multiples of 128
    cap = -(-max(t_ for i, t_ in enumerate(totals) if i != 1) // 128) * 128
    assert cap < totals[1], totals
    ref = jax.vmap(lambda a, b, c, d: jbin.bin_gaussians(
        a, b, c, d, grid, instance_capacity=cap, tile_capacity=1 << 10))(
            rmin, rmax, depth, valid)
    got = pbin.bin_gaussians_batch(t(rmin), t(rmax), t(depth), t(valid),
                                   pbin.TileGrid(*grid), instance_capacity=cap)
    np.testing.assert_array_equal(got.total.numpy(), np.asarray(ref.total))
    counts = got.tile_counts.reshape(3, grid.num_tiles).numpy()
    np.testing.assert_array_equal(counts, np.asarray(ref.tile_counts))
    full_counts = full.tile_counts.reshape(3, grid.num_tiles).numpy()
    assert (counts[1] < full_counts[1]).any()
    np.testing.assert_array_equal(counts[[0, 2]], full_counts[[0, 2]])
    gid = got.gid_sorted.numpy()
    starts = got.tile_starts.numpy().reshape(3, grid.num_tiles)
    for b in range(3):
        one = pbin.bin_gaussians(t(rmin[b]), t(rmax[b]), t(depth[b]),
                                 t(valid[b]), pbin.TileGrid(*grid),
                                 instance_capacity=cap)
        lists_j = np.asarray(ref.tile_lists[b])
        for tile in range(grid.num_tiles):
            seg = gid[starts[b, tile]:starts[b, tile] + counts[b, tile]]
            o_s, o_c = int(one.tile_starts[tile]), int(one.tile_counts[tile])
            np.testing.assert_array_equal(seg, one.gid_sorted[o_s:o_s + o_c])
            np.testing.assert_array_equal(seg, lists_j[tile][:len(seg)])
        assert int(one.total) == totals[b]


def test_render_batch_override_opacity_matches_jax():
    from feature3dgs_tpu.model import gaussians as JG
    from feature3dgs_tpu.render import renderer as jrenderer
    from feature3dgs_tpu_torch import convert
    from feature3dgs_tpu_torch.render import renderer as prenderer
    rng = np.random.RandomState(11)
    n, f_dim = 200, 6
    fields = {
        "xyz": rng.uniform(-1.5, 1.5, (n, 3)),
        "features_dc": rng.randn(n, 1, 3) * 0.5,
        "features_rest": rng.randn(n, 8, 3) * 0.2,
        "scaling": rng.uniform(-3.5, -1.5, (n, 3)),
        "rotation": rng.randn(n, 4), "opacity": rng.uniform(-1, 3, (n, 1)),
        "semantic_feature": rng.randn(n, 1, f_dim)}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    alive = np.ones(n, bool)
    alive[::9] = False
    override = rng.rand(n).astype(np.float32)
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    js = JG.GaussianState(alive=jnp.asarray(alive), max_radii2d=jnp.zeros(n),
                          xyz_gradient_accum=jnp.zeros(n), denom=jnp.zeros(n),
                          active_sh_degree=SH)
    pp, ps = convert.gaussians_from_numpy(fields, alive, SH, "cpu")
    jcams, views = _both_cams(CAMS[:2])
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = jrenderer.render_batch(
        jp, js, jcams, bg=jnp.asarray(bg), override_opacity=jnp.asarray(
            override), config=JRasterConfig(backend="xla", chunk=32,
                                            instance_capacity=1 << 13,
                                            tile_capacity=1 << 10))
    got = prenderer.render_batch(pp, ps, views, bg=t(bg),
                                 override_opacity=t(override),
                                 config=RasterConfig(chunk=32))
    for name, atol in (("color", 1e-5), ("feature", 1e-5), ("alpha", 1e-5),
                       ("depth", 1e-4)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=atol,
                                   err_msg=name)
    np.testing.assert_array_equal(got.n_contrib.numpy(),
                                  np.asarray(ref.n_contrib))
    for b, view in enumerate(views):
        one = prenderer.render(pp, ps, view, bg=t(bg),
                               override_opacity=t(override),
                               config=RasterConfig(chunk=32))
        assert torch.equal(got.color[b], one.color)
