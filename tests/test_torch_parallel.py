"""PyTorch port vs the JAX package: several cameras a step on one device.

The backward compositing over a slice of the tile grid (``tile_base``) and
over B cameras' stacked grids (``n_per_camera``), the learning rates of an
iteration span, the tile-row partial resize, ``sharded_train_step`` on a
1 x 1 mesh, each against its JAX counterpart on the CPU at the small
scenes of tests/test_parallel.py (48x32 and 64x48 pixels, 60-150
Gaussians, 4 feature channels, 16x16 tiles); the trainer over them is in
tests/test_torch_parallel_trainer.py.

Bars: compositing gradients 5e-6 after dividing by each group's largest
magnitude (tests/test_pallas.py); the mesh step as tests/test_parallel.py
holds the JAX one against single-device steps: loss 2e-5 relative,
parameters 5e-5, xyz_gradient_accum 2e-5, denom exact, max_radii2d 1e-4.
Slices and batches are bit-equal to the full single-camera rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.core import projection as jproj
from feature3dgs_tpu.model import gaussians as JG
from feature3dgs_tpu.model import optim as joptim
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.ops import binning as jbin
from feature3dgs_tpu.ops.pallas_raster import composite_pallas
from feature3dgs_tpu.parallel import make_mesh as jmake_mesh
from feature3dgs_tpu.parallel import sharded as jsharded
from feature3dgs_tpu.train import losses as jlosses
from feature3dgs_tpu.train import trainer as jtrainer
from feature3dgs_tpu_torch import convert
from feature3dgs_tpu_torch.model import gaussians as PG
from feature3dgs_tpu_torch.model import optim as poptim
from feature3dgs_tpu_torch.ops import binning as pbin
from feature3dgs_tpu_torch.ops import composite as pcomp
from feature3dgs_tpu_torch.ops.composite import composite_plain_backward
from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig, composite,
                                                 composite_inputs,
                                                 composite_inputs_batch)
from feature3dgs_tpu_torch.parallel import (make_mesh, sharded_train_step,
                                            stack_cameras)
from feature3dgs_tpu_torch.train import losses as plosses
from feature3dgs_tpu_torch.train import trainer as ptrainer

from tests.torch_helpers import CPU, cameras, one_torch_thread, scene, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H, F_DIM = 48, 32, 4
JCFG = JRasterConfig(tile_w=16, tile_h=16, chunk=16,
                     instance_capacity=1 << 12, tile_capacity=1 << 9)
PCFG = RasterConfig(tile_w=16, tile_h=16, chunk=16, instance_capacity=1 << 12)
FIELDS = PG.GaussianParams.FIELDS


@pytest.fixture(autouse=True)
def _highest_resize_precision(monkeypatch):
    monkeypatch.setattr(jlosses, "SEPARABLE_PRECISION",
                        jax.lax.Precision.HIGHEST)


def _norm_close(name, got, ref, tol=5e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    s = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got / s, ref / s, atol=tol, err_msg=name)


def _views(n_cams, width=64, height=48, n=150, seed=2):
    """n_cams views of one numpy-seeded scene, preprocessed and binned by
    the port (one view alone, and all of them in one sort)."""
    g = {k: t(v) for k, v in scene(n=n, f_dim=F_DIM, seed=seed).items()}
    cams = [cameras(width, height, cam_z=-4.0 - 0.3 * i)[1]
            for i in range(n_cams)]
    kw = dict(scales=g["scales"], rotations=g["rotations"], shs=g["shs"],
              sh_degree=2, config=PCFG)
    singles = [composite_inputs(g["means3d"], g["opacities"], g["feat"], c,
                                **kw) for c in cams]
    batch = composite_inputs_batch(g["means3d"], g["opacities"], g["feat"],
                                   cams, **kw)
    return singles, batch


def _cotangents(n_tiles, p, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen) for shape in (
        (n_tiles, p, 3), (n_tiles, p, F_DIM), (n_tiles, p), (n_tiles, p))]


@pytest.mark.parametrize("n_tile", [2, 4])
def test_plain_backward_tile_slices_equal_the_full_rows(n_tile):
    """The plain backward over each rank's tile rows (its own sub-range of
    gid_sorted, rebased starts, ``tile_base``) writes the full call's rows
    bit for bit; 4 slices of a 3-row grid leave one rank only padding."""
    (ci,), _ = _views(1)
    grid = ci.grid
    fwd = pcomp.composite_plain(*ci.args, chunk=16)
    cts = _cotangents(grid.num_tiles, grid.pixels_per_tile, 0)
    state = (*cts, fwd.final_T, fwd.n_contrib)
    full = composite_plain_backward(*ci.args, *state, chunk=16)
    rows_loc = -(-grid.grid_y // n_tile)
    ranges = [(min(r * rows_loc, grid.grid_y) * grid.grid_x,
               min((r + 1) * rows_loc, grid.grid_y) * grid.grid_x)
              for r in range(n_tile)]
    assert ranges[-1][0] == ranges[-1][1] or n_tile == 2
    parts = pbin.tile_slices(*ci.args[6:9], ranges)
    offset = 0
    for (t0, t1), (gid, starts, counts) in zip(ranges, parts):
        rows = composite_plain_backward(
            *ci.args[:6], gid, starts, counts, grid,
            *(x[t0:t1] for x in state), chunk=16, tile_base=t0)
        n_rows = gid.shape[0]
        assert torch.equal(rows.geom, full.geom[offset:offset + n_rows])
        assert torch.equal(rows.feature, full.feature[offset:offset + n_rows])
        offset += n_rows
    assert offset == ci.bins.gid_sorted.shape[0]


@pytest.mark.parametrize("n_cams", [2, 3])
def test_plain_backward_batched_equals_per_view_rows(n_cams):
    """``n_per_camera``: one call over B cameras' stacked grids writes, for
    each camera, the rows of its own call bit for bit; one feature table
    serves every camera."""
    singles, batch = _views(n_cams)
    grid, n = batch.grid, singles[0].args[0].shape[0]
    fwd = pcomp.composite_plain(*batch.args, chunk=16, n_per_camera=n)
    cts = _cotangents(n_cams * grid.num_tiles, grid.pixels_per_tile, 1)
    state = (*cts, fwd.final_T, fwd.n_contrib)
    rows = composite_plain_backward(*batch.args, *state, chunk=16,
                                    n_per_camera=n)
    offset, t_n = 0, grid.num_tiles
    for b, ci in enumerate(singles):
        one = pcomp.composite_plain(*ci.args, chunk=16)
        assert torch.equal(one.n_contrib, fwd.n_contrib[b * t_n:(b + 1) * t_n])
        want = composite_plain_backward(
            *ci.args, *(x[b * t_n:(b + 1) * t_n] for x in state), chunk=16)
        n_rows = ci.bins.gid_sorted.shape[0]
        assert torch.equal(rows.geom[offset:offset + n_rows], want.geom)
        assert torch.equal(rows.feature[offset:offset + n_rows], want.feature)
        offset += n_rows
    assert offset == rows.geom.shape[0]


def test_slice_gradients_match_jax_pallas_interpret():
    """A slice of tile rows through the port's autograd Function (plain
    forward and backward at ``tile_base``) against JAX ``composite_pallas``
    over the same slice (its backward kernel walks ``tile_base`` + t, in
    interpret mode): per-Gaussian gradients at 5e-6."""
    g = scene(n=150, f_dim=F_DIM, seed=2)
    jcam, _ = cameras(W, H)
    jgrid = jbin.TileGrid(W, H, 16, 16)
    pre = jproj.preprocess(
        jnp.asarray(g["means3d"]), jnp.asarray(g["opacities"]), jcam,
        scales=jnp.asarray(g["scales"]), rotations=jnp.asarray(g["rotations"]),
        shs=jnp.asarray(g["shs"]), sh_degree=2)
    rmin, rmax = jproj.tile_rect(pre.xy, pre.radius, jgrid.grid_x,
                                 jgrid.grid_y, 16, 16)
    area = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
    valid = pre.valid & (area > 0)
    jb = jbin.bin_gaussians(rmin, rmax, pre.depth, valid, jgrid,
                            instance_capacity=1 << 12, tile_capacity=1 << 9)
    pgrid = pbin.TileGrid(W, H, 16, 16)
    pb = pbin.bin_gaussians(t(rmin), t(rmax), t(pre.depth), t(valid), pgrid,
                            instance_capacity=1 << 12)
    inputs = (pre.xy, pre.conic, pre.opacity, pre.rgb, pre.depth,
              jnp.asarray(g["feat"]))
    t0, t1 = 3, 6                                   # the second tile row
    cts = [np.asarray(c) for c in _cotangents(t1 - t0, 256, 3)]

    def pallas(xy, conic, op, rgb, depth, feat):
        o = composite_pallas(jb.tile_starts[t0:t1], jb.tile_counts[t0:t1],
                             jb.gid_sorted, jb.total, xy, conic, op,
                             (rgb, feat), depth, jnp.int32(t0), jgrid, 64,
                             False, True)
        return o.color, o.feature, o.depth, o.final_T

    _, vjp = jax.vjp(pallas, *inputs)
    refs = vjp(tuple(jnp.asarray(c) for c in cts))
    (gid, starts, counts), = pbin.tile_slices(pb.gid_sorted, pb.tile_starts,
                                              pb.tile_counts, [(t0, t1)])
    leaves = [t(x).requires_grad_() for x in inputs]
    out = composite((*leaves, gid, starts, counts, pgrid), PCFG, tile_base=t0)
    torch.autograd.backward([out.color, out.feature, out.depth, out.final_T],
                            [t(c) for c in cts])
    for name, leaf, ref in zip(("xy", "conic", "opacity", "rgb", "depth",
                                "feat"), leaves, refs):
        _norm_close(name, leaf.grad.numpy(), ref)


@pytest.mark.parametrize("span", [5, [1], [1, 2], [7, 8, 9, 10],
                                  list(range(2990, 2998))])
def test_group_lrs_over_a_span_match_jax(span):
    """Each rate summed over the span (the linear-scaling rule), as the JAX
    package's group_lrs gives it; a scalar step is one iteration's rates."""
    for jcfg, pcfg in ((joptim.LRConfig(), poptim.LRConfig()),
                       (joptim.LRConfig(position_lr_max_steps=30,
                                        position_lr_delay_steps=4),
                        poptim.LRConfig(position_lr_max_steps=30,
                                        position_lr_delay_steps=4))):
        ref = joptim.group_lrs(jcfg, np.asarray(span, np.int32), 3.5)
        got = poptim.group_lrs(pcfg, np.asarray(span), 3.5)
        for k in FIELDS:
            np.testing.assert_allclose(got[k], float(getattr(ref, k)),
                                       rtol=1e-6, err_msg=k)
    one = poptim.group_lrs(poptim.LRConfig(), 7, 3.5)
    assert poptim.group_lrs(poptim.LRConfig(), [7], 3.5) == one


@pytest.mark.parametrize("size,out,n_tile", [((48, 32), (16, 24), 2),
                                             ((64, 48), (24, 32), 4),
                                             ((64, 48), (48, 64), 2)])
def test_resize_from_tile_rows_matches_jax(size, out, n_tile):
    """Each rank's share of the resize and its gradient against the JAX
    package's (1e-5 max-normalised: both round the weights alike); the
    shares sum to ``resize_bilinear_from_tiles`` of the whole grid."""
    width, height = size
    out_h, out_w = out
    jg = jbin.TileGrid(width, height, 16, 16)
    pg = pbin.TileGrid(width, height, 16, 16)
    rows_loc = -(-pg.grid_y // n_tile)
    gy_pad = rows_loc * n_tile
    rng = np.random.RandomState(n_tile)
    tiles = rng.randn(gy_pad * pg.grid_x, 256, 5).astype(np.float32)
    tiles[pg.num_tiles:] = 0.0
    w = rng.randn(out_h, out_w, 5).astype(np.float32)
    total = 0
    for ti in range(n_tile):
        loc = tiles[ti * rows_loc * pg.grid_x:(ti + 1) * rows_loc * pg.grid_x]
        args = (out_h, out_w, ti * rows_loc, rows_loc, gy_pad)
        ref, jvjp = jax.vjp(lambda x: jlosses.resize_bilinear_from_tile_rows(
            x, jg, *args), jnp.asarray(loc))
        pt = t(loc).requires_grad_()
        got = plosses.resize_bilinear_from_tile_rows(pt, pg, *args)
        (got * t(w)).sum().backward()
        _norm_close(f"share {ti}", got.detach().numpy(), ref, 1e-5)
        _norm_close(f"d share {ti}", pt.grad.numpy(),
                    jvjp(jnp.asarray(w))[0], 1e-5)
        total = total + got.detach()
    whole = plosses.resize_bilinear_from_tiles(t(tiles[:pg.num_tiles]), pg,
                                               out_h, out_w)
    _norm_close("sum of shares", total.numpy(), whole.numpy(), 1e-5)


def _model(n=60, cap=64, seed=1):
    """tests/test_parallel.py's model, as a JAX TrainState and the port's."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    params, state = JG.create_from_pcd(pts, cols, max_sh_degree=2,
                                       feature_dim=F_DIM, capacity=cap)
    params = params.replace(semantic_feature=jnp.asarray(
        rng.randn(cap, 1, F_DIM).astype(np.float32)))
    state = state.replace(active_sh_degree=2)
    jts = jtrainer.TrainState(params=params, gstate=state,
                              adam=joptim.init_adam(params), decoder=None,
                              decoder_adam=None)
    fields = lambda p: {k: np.asarray(getattr(p, k)) for k in FIELDS}
    pts_ = convert.train_state_from_numpy({
        "params": fields(params),
        "gstate": {"alive": np.asarray(state.alive),
                   "max_radii2d": np.asarray(state.max_radii2d),
                   "xyz_gradient_accum": np.asarray(state.xyz_gradient_accum),
                   "denom": np.asarray(state.denom),
                   "active_sh_degree": state.active_sh_degree,
                   "spatial_lr_scale": state.spatial_lr_scale},
        "adam": {"mu": fields(jts.adam.mu), "nu": fields(jts.adam.nu),
                 "step": np.asarray(jts.adam.step)}}, CPU)
    return jts, pts_


def _batch(n_cams, seed=2):
    rng = np.random.RandomState(seed)
    cams = [cameras(W, H, cam_z=-4.0 - 0.5 * i) for i in range(n_cams)]
    gt_images = rng.rand(n_cams, H, W, 3).astype(np.float32)
    gt_features = rng.randn(n_cams, H // 2, W // 2, F_DIM).astype(np.float32)
    return cams, gt_images, gt_features


def _jax_mesh_step(jts, cams, gt_images, gt_features, mesh_shape):
    """JAX ``sharded_train_step`` over the first devices of the 8 CPU
    devices, on a copy of ``jts`` (the step donates its input)."""
    n = int(np.prod(mesh_shape))
    mesh = jmake_mesh(mesh_shape, devices=jax.devices()[:n])
    span = np.arange(1, len(cams) + 1, dtype=np.int32)
    with jax.set_mesh(mesh):
        return jsharded.sharded_train_step(
            jax.tree.map(jnp.copy, jts),
            jsharded.stack_cameras([c[0] for c in cams]),
            jnp.asarray(gt_images), jnp.asarray(gt_features), jnp.zeros(3),
            span, mesh=mesh, ocfg=jtrainer.OptimizationConfig(), rcfg=JCFG)


def check_step_against_jax(pts, pm, jts2, jm):
    """The mesh step's contract (tests/test_parallel.py:98-128)."""
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=2e-5, atol=1e-6)
    for k in ("l1", "l1_feature", "psnr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    for k in ("num_instances", "max_tile_count", "num_active", "finite"):
        assert int(pm[k]) == int(jm[k]), k
    for k in FIELDS:
        np.testing.assert_allclose(getattr(pts.params, k).numpy(),
                                   np.asarray(getattr(jts2.params, k)),
                                   atol=5e-5, err_msg=f"param {k}")
    np.testing.assert_allclose(pts.gstate.xyz_gradient_accum.numpy(),
                               np.asarray(jts2.gstate.xyz_gradient_accum),
                               atol=2e-5)
    np.testing.assert_array_equal(pts.gstate.denom.numpy(),
                                  np.asarray(jts2.gstate.denom))
    np.testing.assert_allclose(pts.gstate.max_radii2d.numpy(),
                               np.asarray(jts2.gstate.max_radii2d), atol=1e-4)
    assert int(pts.adam.step) == int(jts2.adam.step) == 1
    assert float(pts.gstate.xyz_gradient_accum.max()) > 0


@pytest.mark.parametrize("n_cams", [2, 4])
def test_sharded_train_step_1x1_matches_jax(n_cams, monkeypatch):
    """B cameras a step on one device: loss, metrics, the one Adam update
    over the iteration span and the folded densification statistics
    against JAX ``sharded_train_step`` on a 1 x 1 CPU mesh; the plain
    forward and backward run once each for the whole batch."""
    jts, pts = _model()
    cams, gt_images, gt_features = _batch(n_cams)
    jts2, jm = _jax_mesh_step(jts, cams, gt_images, gt_features, (1, 1))
    calls = {"forward": 0, "backward": 0}
    for name, key in (("composite_plain", "forward"),
                      ("composite_plain_backward", "backward")):
        real = getattr(pcomp, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(f"feature3dgs_tpu_torch.ops.rasterize.{name}",
                            counted)
    pm = sharded_train_step(
        pts, stack_cameras([c[1] for c in cams]), t(gt_images),
        t(gt_features), torch.zeros(3), np.arange(1, n_cams + 1),
        mesh=make_mesh((1, 1)), ocfg=ptrainer.OptimizationConfig(), rcfg=PCFG)
    assert calls == {"forward": 1, "backward": 1}
    check_step_against_jax(pts, pm, jts2, jm)


def test_sharded_step_refuses_what_is_not_ported():
    """The instance exchange without row-sharded Gaussians is refused with
    the JAX package's message, by the step and by the trainer; a mesh
    larger than the world is refused too."""
    _, pts = _model()
    cams, gt_images, gt_features = _batch(2)
    msg = "shard_instances requires shard_gaussians"
    with pytest.raises(ValueError, match=msg):
        sharded_train_step(
            pts, [c[1] for c in cams], t(gt_images), t(gt_features),
            torch.zeros(3), [1, 2], mesh=make_mesh((1, 1)),
            ocfg=ptrainer.OptimizationConfig(), rcfg=PCFG,
            shard_instances=True)
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.parallel import DistributedTrainer
    with pytest.raises(ValueError, match=msg):
        DistributedTrainer(synthetic_scene(n_cams=2, w=W, h=H, n_pts=20,
                                           f_dim=F_DIM),
                           mesh=make_mesh((1, 1)), shard_instances=True,
                           device="cpu")
    with pytest.raises(ValueError, match="world size of 4"):
        make_mesh((1, 4))
