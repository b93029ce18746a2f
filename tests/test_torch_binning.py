"""PyTorch port vs the JAX package: tile binning.

The per-tile lists must hold the same Gaussians in the same order; the JAX
package's 8-row filler entries (TPU DMA alignment) are stripped before
comparing, so lists and counts are compared, not raw tile_starts. Counts,
``total`` and the longest list must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from feature3dgs_tpu.core import projection as jproj
from feature3dgs_tpu.ops import binning as jbin
from feature3dgs_tpu.ops.rasterize import rect_radius
from feature3dgs_tpu_torch.ops import binning as pbin

from tests.torch_helpers import cameras, scene, t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rects(width, height, tile_w, tile_h, n=300, seed=0):
    """JAX preprocess + opacity-aware rects of one scene, as numpy."""
    g = scene(n=n, seed=seed, boost=2.0)
    g["means3d"][:60, 2] = 0.25  # equal depths: the sort must be stable
    jcam, _ = cameras(width, height)
    pre = jproj.preprocess(
        jnp.asarray(g["means3d"]), jnp.asarray(g["opacities"]), jcam,
        scales=jnp.asarray(g["scales"]), rotations=jnp.asarray(g["rotations"]),
        shs=jnp.asarray(g["shs"]), sh_degree=2)
    grid = jbin.TileGrid(width, height, tile_w, tile_h)
    rmin, rmax = jproj.tile_rect(pre.xy, rect_radius(pre.radius, pre.opacity),
                                 grid.grid_x, grid.grid_y, tile_w, tile_h)
    area = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
    valid = pre.valid & (area > 0)
    return (np.asarray(rmin), np.asarray(rmax), np.asarray(pre.depth),
            np.asarray(valid), grid)


def _jax_lists(bins) -> list[list[int]]:
    gid = np.asarray(bins.gid_sorted)
    starts, counts = np.asarray(bins.tile_starts), np.asarray(bins.tile_counts)
    out = []
    for s, c in zip(starts, counts):
        seg = gid[s:s + c]
        assert (seg >= 0).all(), "fillers sort after each tile's entries"
        out.append(seg.tolist())
    return out


def _port_lists(bins) -> list[list[int]]:
    gid = bins.gid_sorted.numpy()
    return [gid[s:s + c].tolist() for s, c in
            zip(bins.tile_starts.numpy(), bins.tile_counts.numpy())]


@pytest.mark.parametrize("tile_w,tile_h,width,height,capacity", [
    (16, 16, 48, 32, 1 << 12),
    (32, 16, 64, 48, 1 << 12),
    (16, 16, 64, 48, 256),  # overflow: whole Gaussians drop, highest first
])
def test_bin_gaussians_matches_jax(tile_w, tile_h, width, height, capacity):
    rmin, rmax, depth, valid, grid = _rects(width, height, tile_w, tile_h)
    ref = jbin.bin_gaussians(
        jnp.asarray(rmin), jnp.asarray(rmax), jnp.asarray(depth),
        jnp.asarray(valid), grid, instance_capacity=capacity,
        tile_capacity=1 << 9)
    got = pbin.bin_gaussians(
        t(rmin), t(rmax), t(depth), t(valid),
        pbin.TileGrid(width, height, tile_w, tile_h),
        instance_capacity=capacity)

    np.testing.assert_array_equal(got.tile_counts.numpy(),
                                  np.asarray(ref.tile_counts))
    assert int(got.total) == int(ref.total)
    assert int(got.tile_counts.max()) == int(np.asarray(ref.tile_counts).max())
    np.testing.assert_array_equal(got.num_tiles_touched.numpy(),
                                  np.asarray(ref.num_tiles_touched))
    assert _port_lists(got) == _jax_lists(ref)
    if capacity == 256:  # the overflow case does overflow
        assert int(ref.total) > capacity >= got.gid_sorted.shape[0]


def test_serving_scene_instance_count_matches_jax():
    """chip_smoke.py's serving scene (bench.py's: seed 0, 100K Gaussians,
    SH 3, opacity 0.5, 1216x800, 32x16 tiles), binned by both packages on
    the CPU: the same instance count, tile by tile."""
    import math
    from feature3dgs_tpu.core import transforms
    from feature3dgs_tpu.core.projection import CameraView
    from feature3dgs_tpu.model import gaussians as JG
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import projection as pproj
    from feature3dgs_tpu_torch.model import gaussians as PG
    from feature3dgs_tpu_torch.ops import rasterize as prast

    n, width, height = 100_000, 1216, 800
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    d2 = np.full(n, 2e-4, np.float32)
    view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 5.0]))
    proj = transforms.projection_matrix(0.01, 100.0, 1.2, 0.9) @ view
    campos = transforms.camera_center_from_view(view).astype(np.float32)

    jp, _ = JG.create_from_pcd(pts, cols, max_sh_degree=3, feature_dim=4,
                               knn_mean_dists=d2)
    jop = jnp.full((n,), 0.5, jnp.float32)
    jcam = CameraView(view=jnp.asarray(view), proj=jnp.asarray(proj),
                      campos=jnp.asarray(campos),
                      tan_fovx=jnp.float32(math.tan(0.6)),
                      tan_fovy=jnp.float32(math.tan(0.45)),
                      width=width, height=height)
    pre = jproj.preprocess(jp.xyz, jop, jcam, scales=JG.get_scaling(jp),
                           rotations=JG.get_rotation(jp),
                           shs=JG.get_features(jp), sh_degree=3)
    grid = jbin.TileGrid(width, height, 32, 16)
    rmin, rmax = jproj.tile_rect(pre.xy, rect_radius(pre.radius, pre.opacity),
                                 grid.grid_x, grid.grid_y, 32, 16)
    area = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
    ref = jbin.bin_gaussians(rmin, rmax, pre.depth, pre.valid & (area > 0),
                             grid, instance_capacity=393216,
                             tile_capacity=1 << 11, build_tile_lists=False)

    pp, _ = PG.create_from_pcd(pts, cols, max_sh_degree=3, feature_dim=4,
                               knn_mean_dists=d2, device="cpu")
    pcam = camera_from_numpy(view, proj, campos, math.tan(0.6),
                             math.tan(0.45), width, height, "cpu")
    ci = prast.composite_inputs(
        pp.xyz, torch_full(n, 0.5), PG.get_semantic(pp), pcam,
        scales=PG.get_scaling(pp), rotations=PG.get_rotation(pp),
        shs=PG.get_features(pp), sh_degree=3)
    np.testing.assert_array_equal(ci.bins.tile_counts.numpy(),
                                  np.asarray(ref.tile_counts))
    assert int(ci.bins.total) == int(ref.total) == SERVING_SCENE_INSTANCES


def torch_full(n, value):
    import torch
    return torch.full((n,), value, dtype=torch.float32)


# both packages' count on this scene (the JAX package's TPU bench recorded
# 304,627 for it: a TPU-side figure, not this CPU binning's)
SERVING_SCENE_INSTANCES = 303_278


@pytest.mark.parametrize("t_tiles,n_valid,n_unused", [(6, 300, 40),
                                                      (12, 2000, 0),
                                                      (4, 0, 16)])
def test_sort_instances_matches_jax(t_tiles, n_valid, n_unused):
    """The exchange receiver's sort: (tile, depth, id) triples in arrival
    order, unused slots (tile t_tiles, depth inf, id -1) among them, and
    depths drawn from a few values so that ties are many. Each tile's list
    equals the JAX package's once its filler entries are removed (equal
    depths keep their arrival order in both), the unused slots are cut off
    and the lists cover gid_sorted once, in order."""
    rng = np.random.RandomState(t_tiles)
    tile = rng.randint(0, t_tiles, n_valid).astype(np.int32)
    depth = rng.choice(np.float32([0.3, 1.25, 2.0, 7.5]), n_valid)
    gid = rng.permutation(4 * n_valid + 1)[:n_valid].astype(np.int32)
    at = np.sort(rng.choice(n_valid + n_unused, n_unused, replace=False))
    tile = np.insert(tile, at - np.arange(n_unused), t_tiles)
    depth = np.insert(depth, at - np.arange(n_unused), np.inf).astype(
        np.float32)
    gid = np.insert(gid, at - np.arange(n_unused), -1).astype(np.int32)
    counts = np.bincount(tile, minlength=t_tiles + 1)[:t_tiles].astype(
        np.int32)
    _, jgid, jstarts = jbin.sort_instances(
        jnp.asarray(tile), jnp.asarray(depth), jnp.asarray(gid),
        jnp.asarray(counts), t_tiles)
    jgid, jstarts = np.asarray(jgid), np.asarray(jstarts)
    pgid, pstarts, pcounts = pbin.sort_instances(t(tile), t(depth), t(gid),
                                                 t_tiles)
    pgid, pstarts = pgid.numpy(), pstarts.numpy()
    np.testing.assert_array_equal(pcounts.numpy(), counts)
    assert pgid.shape == (n_valid,) and pgid.dtype == np.int32
    np.testing.assert_array_equal(pstarts, np.cumsum(counts) - counts)
    for k in range(t_tiles):
        ours = pgid[pstarts[k]:pstarts[k] + counts[k]]
        np.testing.assert_array_equal(
            ours, jgid[jstarts[k]:jstarts[k] + counts[k]], err_msg=str(k))
        # arrival order among equal depths
        mine = np.flatnonzero(tile == k)
        want = mine[np.argsort(depth[mine], kind="stable")]
        np.testing.assert_array_equal(ours, gid[want])
