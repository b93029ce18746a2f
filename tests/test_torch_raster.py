"""PyTorch port vs the JAX package: compositing and ``rasterize``.

The bars are the JAX package's own for its Pallas kernel against the XLA
compositor (tests/test_pallas.py): 1e-5 absolute on color, features and
alpha; 1e-4 on depth; n_contrib, radii, visibility and the counters
exactly. On CPU the port runs the plain version of its CUDA kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.core import projection as jproj
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.ops import binning as jbin
from feature3dgs_tpu.ops.composite import composite, tile_pixel_coords
from feature3dgs_tpu.ops.rasterize import rasterize as jrasterize
from feature3dgs_tpu_torch.ops import binning as pbin
from feature3dgs_tpu_torch.ops import cuda_raster
from feature3dgs_tpu_torch.ops.composite import composite_plain
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig, rasterize

from tests.torch_helpers import cameras, scene, t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _check_forward(got, ref):
    np.testing.assert_allclose(np.asarray(got.color), np.asarray(ref.color),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.feature),
                               np.asarray(ref.feature), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(ref.depth),
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got.n_contrib),
                                  np.asarray(ref.n_contrib))


@pytest.mark.parametrize("boost,f_dim", [(None, 4), (3.0, 16)])
def test_composite_plain_matches_jax_composite(boost, f_dim):
    """Same preprocess outputs and tile lists into both compositors (the
    plain version at its own chunk length, 24, vs JAX's 16)."""
    width, height = 48, 32
    g = scene(n=300 if boost else 200, f_dim=f_dim, seed=1 if boost else 0,
              boost=boost)
    jcam, _ = cameras(width, height)
    grid = jbin.TileGrid(width, height, 16, 16)
    pre = jproj.preprocess(
        jnp.asarray(g["means3d"]), jnp.asarray(g["opacities"]), jcam,
        scales=jnp.asarray(g["scales"]), rotations=jnp.asarray(g["rotations"]),
        shs=jnp.asarray(g["shs"]), sh_degree=2)
    rmin, rmax = jproj.tile_rect(pre.xy, pre.radius, grid.grid_x, grid.grid_y,
                                 16, 16)
    area = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
    valid = pre.valid & (area > 0)
    jb = jbin.bin_gaussians(rmin, rmax, pre.depth, valid, grid,
                            instance_capacity=1 << 12, tile_capacity=1 << 9)
    ref = composite(jb.tile_lists, tile_pixel_coords(grid), pre.xy, pre.conic,
                    pre.opacity, pre.rgb, jnp.asarray(g["feat"]), pre.depth,
                    16, "highest", False)

    pb = pbin.bin_gaussians(t(rmin), t(rmax), t(pre.depth), t(valid),
                            pbin.TileGrid(width, height, 16, 16),
                            instance_capacity=1 << 12)
    got = composite_plain(t(pre.xy), t(pre.conic), t(pre.opacity), t(pre.rgb),
                          t(pre.depth), t(g["feat"]), pb.gid_sorted,
                          pb.tile_starts, pb.tile_counts,
                          pbin.TileGrid(width, height, 16, 16), chunk=24)
    _check_forward(got, ref)
    np.testing.assert_allclose(got.final_T.numpy(), np.asarray(ref.final_T),
                               atol=1e-5)
    if boost:  # the scene does exercise the T floor
        assert (np.asarray(ref.final_T) < 1e-3).any()


@pytest.mark.parametrize("f_dim,tile_w,width,height", [
    (4, 16, 48, 32), (128, 32, 64, 48)])
def test_rasterize_matches_jax_pallas(f_dim, tile_w, width, height):
    """Port rasterize (plain version on CPU) vs JAX rasterize through the
    Pallas kernel in interpret mode: boosted opacities, a non-zero bg and
    dead rows culled through active_mask."""
    n = 300
    g = scene(n=n, f_dim=f_dim, seed=1, boost=3.0)
    alive = np.ones(n, bool)
    alive[::7] = False
    bg = np.array([0.7, 0.4, 0.2], np.float32)
    jcam, pcam = cameras(width, height)
    common = dict(tile_w=tile_w, tile_h=16, instance_capacity=1 << 13)
    ref = jrasterize(
        jnp.asarray(g["means3d"]), jnp.asarray(g["opacities"]),
        jnp.asarray(g["feat"]), jcam, scales=jnp.asarray(g["scales"]),
        rotations=jnp.asarray(g["rotations"]), shs=jnp.asarray(g["shs"]),
        sh_degree=2, bg=jnp.asarray(bg), active_mask=jnp.asarray(alive),
        config=JRasterConfig(chunk=64, tile_capacity=1 << 10,
                             backend="pallas_interpret", **common))
    got = rasterize(
        t(g["means3d"]), t(g["opacities"]), t(g["feat"]), pcam,
        scales=t(g["scales"]), rotations=t(g["rotations"]), shs=t(g["shs"]),
        sh_degree=2, bg=t(bg), active_mask=t(alive),
        config=RasterConfig(chunk=32, **common))
    _check_forward(got, ref)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha),
                               atol=1e-5)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(ref.radii))
    np.testing.assert_array_equal(got.visibility.numpy(),
                                  np.asarray(ref.visibility))
    assert int(got.total_instances) == int(ref.total_instances)
    assert int(got.max_tile_count) == int(ref.max_tile_count)
    assert got.color.shape == (height, width, 3)
    assert got.feature_tiles.shape[-1] == f_dim
    assert not got.visibility.numpy()[~alive].any()


def _binned(n=120, f_dim=4, seed=3):
    from feature3dgs_tpu_torch.ops.rasterize import composite_inputs
    g = scene(n=n, f_dim=f_dim, seed=seed, boost=3.0)
    _, pcam = cameras(48, 32)
    return composite_inputs(
        t(g["means3d"]), t(g["opacities"]), t(g["feat"]), pcam,
        scales=t(g["scales"]), rotations=t(g["rotations"]), shs=t(g["shs"]),
        sh_degree=2, config=RasterConfig(tile_w=16, tile_h=16))


@pytest.mark.parametrize("broken", [None, "start_negative", "count_negative",
                                    "list_past_end", "id_negative",
                                    "id_past_n"])
def test_kernel_wrapper_checks_tile_lists(broken):
    """The kernel trusts the tile lists; the wrapper's check refuses any
    list that leaves gid_sorted and any id that names no Gaussian."""
    ci = _binned()
    gid = ci.bins.gid_sorted.clone()
    starts, counts = ci.bins.tile_starts.clone(), ci.bins.tile_counts.clone()
    n = ci.args[0].shape[0]
    assert gid.numel() > 0 and int(counts.max()) > 0
    busy = int(torch.argmax(counts))
    if broken == "start_negative":
        starts[busy] = -1
    elif broken == "count_negative":
        counts[busy] = -1
    elif broken == "list_past_end":
        counts[busy] += 1 + gid.numel() - int(starts[busy] + counts[busy])
    elif broken == "id_negative":
        gid[0] = -1
    elif broken == "id_past_n":
        gid[-1] = n
    if broken is None:
        cuda_raster.check_tile_lists(gid, starts, counts, n)
    else:
        with pytest.raises(ValueError, match="tile lists out of range"):
            cuda_raster.check_tile_lists(gid, starts, counts, n)


def test_composite_plain_work_stats():
    """The counts the chip smoke check takes its bound from: contributing
    pairs and Gaussians are subsets of tested ones, tested Gaussians are
    binned ones, and the Gaussians with a nonzero weight somewhere are
    exactly those that change the image when removed."""
    ci = _binned()
    stats: dict = {}
    base = composite_plain(*ci.args, chunk=16, stats=stats)
    tested, contrib = stats["tested_gaussians"], stats["contributing_gaussians"]
    assert 0 < stats["contributing"] <= stats["tested"]
    assert 0 < stats["entries_tested"] <= ci.bins.gid_sorted.numel()
    assert not (contrib & ~tested).any()
    assert not (tested & ~ci.valid).any()
    assert 0 < int(contrib.sum()) <= int(tested.sum())
    # a Gaussian that never contributes can take any colour and features
    args = list(ci.args)
    idle = ~contrib
    args[3] = torch.where(idle[:, None], torch.full_like(args[3], 7.0), args[3])
    args[5] = torch.where(idle[:, None], torch.full_like(args[5], 7.0), args[5])
    moved = composite_plain(*args, chunk=16)
    assert torch.equal(moved.color, base.color)
    assert torch.equal(moved.feature, base.feature)


def test_cpu_backends_never_launch_the_kernel():
    g = scene(n=50, f_dim=4, seed=2)
    _, pcam = cameras(48, 32)
    args = (t(g["means3d"]), t(g["opacities"]), t(g["feat"]), pcam)
    kw = dict(scales=t(g["scales"]), rotations=t(g["rotations"]),
              shs=t(g["shs"]), sh_degree=2)
    before = cuda_raster.FORWARD_LAUNCHES
    auto = rasterize(*args, **kw, config=RasterConfig(tile_w=16))
    plain = rasterize(*args, **kw, config=RasterConfig(tile_w=16,
                                                       backend="plain"))
    assert cuda_raster.FORWARD_LAUNCHES == before
    assert torch.equal(auto.color, plain.color)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rasterize(*args, **kw, config=RasterConfig(backend="cuda"))
    with pytest.raises(ValueError, match="backend"):
        RasterConfig(backend="pallas")
