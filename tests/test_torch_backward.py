"""PyTorch port vs the JAX package: gradients of the compositing and of
``render``.

On the CPU the port's compositing runs its plain versions (forward and
backward) inside the autograd Function of ``ops/rasterize.py``, and the
per-entry rows are summed per Gaussian by ``ops/segment.py``. The bar is
the JAX package's own for its Pallas kernel against the XLA compositor
(tests/test_pallas.py:98-101): every gradient group agrees at 5e-6 after
dividing by the group's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.core import projection as jproj
from feature3dgs_tpu.model import gaussians as JG
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.ops import binning as jbin
from feature3dgs_tpu.ops.composite import composite, tile_pixel_coords
from feature3dgs_tpu.ops.pallas_raster import composite_pallas
from feature3dgs_tpu.render import renderer as jrenderer
from feature3dgs_tpu_torch import convert
from feature3dgs_tpu_torch.model import gaussians as PG
from feature3dgs_tpu_torch.ops import binning as pbin
from feature3dgs_tpu_torch.ops import cuda_raster
from feature3dgs_tpu_torch.ops.composite import composite_plain_backward
from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig, composite as
                                                 pcomposite, composite_inputs)
from feature3dgs_tpu_torch.ops.segment import SegmentPlan
from feature3dgs_tpu_torch.render import renderer as prenderer

from tests.torch_helpers import CPU, cameras, scene, t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 5e-6
W, H = 48, 32


def _close(name, got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    s = max(float(np.abs(ref).max()), 1e-9)
    np.testing.assert_allclose(got / s, ref / s, atol=tol, err_msg=name)


def _preprocessed(f_dim):
    """One view preprocessed by the JAX package, binned by both packages."""
    g = scene(n=150, f_dim=f_dim, seed=2)
    jcam, _ = cameras(W, H)
    grid = jbin.TileGrid(W, H, 16, 16)
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
    pgrid = pbin.TileGrid(W, H, 16, 16)
    pb = pbin.bin_gaussians(t(rmin), t(rmax), t(pre.depth), t(valid), pgrid,
                            instance_capacity=1 << 12)
    inputs = (pre.xy, pre.conic, pre.opacity, pre.rgb, pre.depth,
              jnp.asarray(g["feat"]))
    return grid, jb, pgrid, pb, inputs


@pytest.mark.parametrize("f_dim,fag", [(4, False), (4, True), (128, False),
                                       (128, True)])
def test_compositing_gradients_match_jax(f_dim, fag):
    """Random cotangents on color, features, depth and final_T through the
    port's Function vs the JAX XLA compositor's VJP, and at F = 4 also vs
    the Pallas kernel's (interpret mode, ~10 s a case), as
    tests/test_pallas.py:71-101 holds the two against each other."""
    grid, jb, pgrid, pb, inputs = _preprocessed(f_dim)
    rng = np.random.RandomState(0)
    n_tiles, p = grid.num_tiles, grid.pixels_per_tile
    cts = (rng.randn(n_tiles, p, 3), rng.randn(n_tiles, p, f_dim),
           rng.randn(n_tiles, p), rng.randn(n_tiles, p))
    cts = tuple(c.astype(np.float32) for c in cts)

    def xla(xy, conic, op, rgb, depth, feat):
        o = composite(jb.tile_lists, tile_pixel_coords(grid), xy, conic, op,
                      rgb, feat, depth, 16, "highest", fag)
        return o.color, o.feature, o.depth, o.final_T

    def pallas(xy, conic, op, rgb, depth, feat):
        o = composite_pallas(jb.tile_starts, jb.tile_counts, jb.gid_sorted,
                             jb.total, xy, conic, op, (rgb, feat), depth, None,
                             grid, 64, fag, True)
        return o.color, o.feature, o.depth, o.final_T

    refs = {}
    for name, fn in (("xla", xla), ("pallas", pallas))[:2 if f_dim == 4 else 1]:
        _, vjp = jax.vjp(fn, *inputs)
        refs[name] = vjp(tuple(jnp.asarray(c) for c in cts))

    leaves = [t(x).requires_grad_() for x in inputs]
    out = pcomposite((*leaves, pb.gid_sorted, pb.tile_starts, pb.tile_counts,
                      pgrid),
                     RasterConfig(tile_w=16, tile_h=16, chunk=24,
                                  feature_alpha_grad=fag))
    torch.autograd.backward([out.color, out.feature, out.depth, out.final_T],
                            [t(c) for c in cts])
    for name, ref in refs.items():
        for group, leaf, r in zip(("xy", "conic", "opacity", "rgb", "depth",
                                   "feat"), leaves, ref):
            _close(f"{group} vs {name} (F={f_dim}, fag={fag})",
                   leaf.grad.numpy(), r)


def _fields(n=200, f_dim=4, seed=5) -> dict:
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {
        "xyz": rng.uniform(-1.5, 1.5, (n, 3)).astype(f32),
        "features_dc": (rng.randn(n, 1, 3) * 0.5).astype(f32),
        "features_rest": (rng.randn(n, 15, 3) * 0.2).astype(f32),
        "scaling": rng.uniform(-3.5, -1.5, (n, 3)).astype(f32),
        "rotation": rng.randn(n, 4).astype(f32),
        "opacity": rng.uniform(-1.0, 3.0, (n, 1)).astype(f32),
        "semantic_feature": rng.randn(n, 1, f_dim).astype(f32),
    }


def test_render_gradients_match_jax():
    """Gradients through the whole render (activations, SH, EWA projection
    with its frustum clamp, compositing) of every parameter group and of
    ndc_offset, vs jax.grad of the JAX render: a non-zero background and
    dead rows culled through ``alive``."""
    n, f_dim = 200, 4
    fields = _fields(n, f_dim)
    alive = np.ones(n, bool)
    alive[::9] = False
    bg = np.array([0.3, 0.1, 0.6], np.float32)
    jcam, pcam = cameras(W, H)
    rng = np.random.RandomState(3)
    tc = rng.rand(H, W, 3).astype(np.float32)
    tf = rng.randn(H, W, f_dim).astype(np.float32)
    td = rng.rand(H, W).astype(np.float32)
    ta = rng.rand(H, W).astype(np.float32)

    def loss_of(out, lib, conv):
        return (lib.mean(lib.abs(out.color - conv(tc)))
                + lib.mean(lib.abs(out.feature - conv(tf)))
                + lib.mean(out.depth * conv(td))
                + lib.mean(out.alpha * conv(ta)))

    js = JG.GaussianState(alive=jnp.asarray(alive), max_radii2d=jnp.zeros(n),
                          xyz_gradient_accum=jnp.zeros(n), denom=jnp.zeros(n),
                          active_sh_degree=3)
    jcfg = JRasterConfig(tile_w=16, tile_h=16, chunk=16,
                         instance_capacity=1 << 13, tile_capacity=1 << 10,
                         backend="xla")

    def jloss(params, offset):
        out = jrenderer.render(params, js, jcam, bg=jnp.asarray(bg),
                               config=jcfg, ndc_offset=offset)
        return loss_of(out, jnp, jnp.asarray)

    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    jg_params, jg_offset = jax.grad(jloss, argnums=(0, 1))(
        jp, jnp.zeros((n, 2), jnp.float32))

    pp, ps = convert.gaussians_from_numpy(fields, alive, 3, CPU)
    leaves = PG.GaussianParams(**{k: getattr(pp, k).requires_grad_()
                                  for k in PG.GaussianParams.FIELDS})
    offset = torch.zeros((n, 2), requires_grad=True)
    out = prenderer.render(leaves, ps, pcam, bg=t(bg),
                           config=RasterConfig(tile_w=16, tile_h=16),
                           ndc_offset=offset)
    loss_of(out, torch, t).backward()
    for k in PG.GaussianParams.FIELDS:
        _close(k, getattr(leaves, k).grad.numpy(), getattr(jg_params, k))
    _close("ndc_offset", offset.grad.numpy(), jg_offset)
    assert float(np.abs(np.asarray(jg_offset)).max()) > 0


def test_segment_sum_is_the_per_gaussian_sum_and_deterministic():
    rng = np.random.RandomState(0)
    gid = torch.from_numpy(rng.randint(0, 40, 500).astype(np.int32))
    rows = torch.from_numpy(rng.randn(500, 7).astype(np.float32))
    plan = SegmentPlan(gid, 50)
    got = plan.sum(rows)
    ref = torch.zeros((50, 7), dtype=torch.float64).index_add_(
        0, gid.long(), rows.double())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert not got[40:].any()                 # Gaussians with no entries
    assert torch.equal(SegmentPlan(gid, 50).sum(rows), got)
    assert plan.sum(rows[:, :0]).shape == (50, 0)


def test_plain_backward_rows_and_work_stats():
    """Every row of every tile's list is written (zeros past the tile's
    deepest contributor), the rows sum to the Function's gradients, and
    the work counts that the chip smoke check takes its bound from are
    consistent."""
    g = scene(n=120, f_dim=6, seed=3, boost=3.0)
    _, pcam = cameras(W, H)
    ci = composite_inputs(
        t(g["means3d"]), t(g["opacities"]), t(g["feat"]), pcam,
        scales=t(g["scales"]), rotations=t(g["rotations"]), shs=t(g["shs"]),
        sh_degree=2, config=RasterConfig(tile_w=16, tile_h=16))
    cfg = RasterConfig(tile_w=16, tile_h=16, chunk=16)
    out = pcomposite(ci.args, cfg)
    rng = np.random.RandomState(1)
    cts = [torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
           for x in (out.color, out.feature, out.depth, out.final_T)]
    stats: dict = {}
    rows = composite_plain_backward(*ci.args, *cts, out.final_T, out.n_contrib,
                                    chunk=16, stats=stats)
    starts, counts = ci.bins.tile_starts.long(), ci.bins.tile_counts.long()
    deepest = torch.minimum(out.n_contrib.long().amax(1), counts)
    for s, c, d in zip(starts.tolist(), counts.tolist(), deepest.tolist()):
        assert not rows.geom[s + d:s + c].any()
        assert not rows.feature[s + d:s + c].any()
    assert int(deepest.sum()) == stats["entries_walked"] > 0
    assert 0 < stats["contributing"] <= stats["walked"]
    walked, contrib = stats["walked_gaussians"], stats["contributing_gaussians"]
    assert not (contrib & ~walked).any() and int(contrib.sum()) > 0
    # rows of Gaussians that contribute nowhere are zero
    idle = ~contrib[ci.bins.gid_sorted.long()]
    assert not rows.geom[idle].any() and not rows.feature[idle].any()

    leaves = [a.detach().requires_grad_() for a in ci.args[:6]]
    again = pcomposite((*leaves, *ci.args[6:]), cfg)
    torch.autograd.backward([again.color, again.feature, again.depth,
                             again.final_T], cts)
    plan = SegmentPlan(ci.bins.gid_sorted, leaves[0].shape[0])
    dg = plan.sum(rows.geom)
    for leaf, cols in zip(leaves[:5], ((0, 2), (2, 5), (5, 6), (6, 9),
                                       (9, 10))):
        assert torch.equal(leaf.grad.reshape(dg.shape[0], -1),
                           dg[:, cols[0]:cols[1]])
    assert torch.equal(leaves[5].grad, plan.sum(rows.feature))


@pytest.mark.parametrize("broken", [None, "gap", "overlap", "short"])
def test_tile_partition_check(broken):
    """The backward kernel writes one row per list entry, so its wrapper
    (when asked) refuses lists that do not cover gid_sorted exactly once."""
    counts = torch.tensor([3, 0, 2, 4], dtype=torch.int32)
    starts = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    n_inst = 9
    if broken == "gap":
        starts[3] = 6
    elif broken == "overlap":
        starts[2] = 2
    elif broken == "short":
        n_inst = 10
    if broken is None:
        cuda_raster.check_tile_partition(starts, counts, n_inst)
    else:
        with pytest.raises(ValueError, match="exactly once"):
            cuda_raster.check_tile_partition(starts, counts, n_inst)
