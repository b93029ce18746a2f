"""PyTorch port vs the JAX package: the ``alpha_matmul`` mode.

The mode evaluates the Gaussian exponent as a dot of per-splat coefficients
with tile-local pixel monomials, in both packages. Its parity contract is
the JAX package's own (tests/test_pallas.py:386-446): same math, regrouped
floats, so 1e-4 absolute on color, features and final_T, 5e-4 on depth,
``n_contrib`` differing on fewer than 1% of the pixels by at most 1, and
gradients at 1e-4 after dividing by each group's largest magnitude. The JAX
side runs its Pallas kernels in interpret mode with ``alpha_matmul=True``;
the port runs the plain versions of its CUDA kernels' alpha mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.core import projection as jproj
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.ops import binning as jbin
from feature3dgs_tpu.ops.pallas_raster import composite_pallas
from feature3dgs_tpu.ops.rasterize import rasterize as jrasterize
from feature3dgs_tpu_torch import config as pconfig
from feature3dgs_tpu_torch.ops import binning as pbin
from feature3dgs_tpu_torch.ops import composite as pcomp
from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig, composite as
                                                 pcomposite, rasterize)

from tests.torch_helpers import cameras, scene, t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 48, 32


def _close_norm(name, got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    s = max(float(np.abs(ref).max()), 1e-9)
    np.testing.assert_allclose(got / s, ref / s, atol=tol, err_msg=name)


def _check_forward(got, ref):
    for k in ("color", "feature", "final_T"):
        np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(ref.depth),
                               atol=5e-4)
    diff = np.abs(np.asarray(got.n_contrib).astype(np.int64)
                  - np.asarray(ref.n_contrib))
    assert (diff > 0).mean() < 0.01 and diff.max() <= 1


def _binned(f_dim, boost=None):
    """tests/test_pallas.py:393-404's scene (200 Gaussians, seed 3, 48x32,
    16x16 tiles), preprocessed by the JAX package and binned by both."""
    g = scene(n=200, f_dim=f_dim, seed=3, boost=boost)
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


@pytest.mark.parametrize("f_dim,boost", [(4, None), (4, 3.0), (128, None)])
def test_alpha_matmul_compositing_matches_jax_pallas(f_dim, boost):
    """Forward outputs and the gradients of random cotangents: the port's
    plain alpha mode (through its autograd Function) vs the JAX Pallas
    kernels in interpret mode with alpha_matmul on."""
    grid, jb, pgrid, pb, inputs = _binned(f_dim, boost)
    rng = np.random.RandomState(0)
    n_tiles, p = grid.num_tiles, grid.pixels_per_tile
    cts = tuple(c.astype(np.float32) for c in (
        rng.randn(n_tiles, p, 3), rng.randn(n_tiles, p, f_dim),
        rng.randn(n_tiles, p), rng.randn(n_tiles, p)))

    def pallas(xy, conic, op, rgb, depth, feat):
        o = composite_pallas(jb.tile_starts, jb.tile_counts, jb.gid_sorted,
                             jb.total, xy, conic, op, (rgb, feat), depth, None,
                             grid, 64, False, True, 8, True)
        return o.color, o.feature, o.depth, o.final_T

    ref = composite_pallas(jb.tile_starts, jb.tile_counts, jb.gid_sorted,
                           jb.total, inputs[0], inputs[1], inputs[2],
                           (inputs[3], inputs[5]), inputs[4], None, grid, 64,
                           False, True, 8, True)
    _, vjp = jax.vjp(pallas, *inputs)
    ref_grads = vjp(tuple(jnp.asarray(c) for c in cts))

    leaves = [t(x).requires_grad_() for x in inputs]
    lists = (pb.gid_sorted, pb.tile_starts, pb.tile_counts, pgrid)
    cfg = RasterConfig(tile_w=16, tile_h=16, chunk=24, alpha_matmul=True)
    out = pcomposite((*leaves, *lists), cfg)
    _check_forward(out._replace(**{k: getattr(out, k).detach()
                                   for k in ("color", "feature", "depth",
                                             "final_T")}), ref)
    torch.autograd.backward([out.color, out.feature, out.depth, out.final_T],
                            [t(c) for c in cts])
    for group, leaf, r in zip(("xy", "conic", "opacity", "rgb", "depth",
                               "feat"), leaves, ref_grads):
        _close_norm(f"{group} (F={f_dim})", leaf.grad.numpy(), r)

    # and against the port's own exact mode, at the same bars
    exact_leaves = [t(x).requires_grad_() for x in inputs]
    exact = pcomposite((*exact_leaves, *lists),
                       RasterConfig(tile_w=16, tile_h=16, chunk=24))
    _check_forward(pcomp.CompositeOutput(*(x.detach() for x in out)),
                   pcomp.CompositeOutput(*(x.detach() for x in exact)))
    torch.autograd.backward(
        [exact.color, exact.feature, exact.depth, exact.final_T],
        [t(c) for c in cts])
    for group, a, b in zip(("xy", "conic", "opacity", "rgb", "depth", "feat"),
                           leaves, exact_leaves):
        _close_norm(f"{group} vs exact mode", a.grad.numpy(), b.grad.numpy())
    # the mode does regroup the floats: the outputs are not bit-equal
    assert not torch.equal(out.color, exact.color)


def test_alpha_coefficients_and_monomials():
    """power = coeff . mono equals the exact quadratic to rounding, in
    tile-local coordinates, with the tile row wrapping per image."""
    grid = pbin.TileGrid(64, 32, 16, 16)           # 4 x 2 tiles
    n_tiles = 2 * grid.num_tiles                   # two stacked images
    pix = pcomp.tile_pixel_coords(grid, n_tiles)
    origins = pix[:, 0]                            # each tile's first pixel
    mono = pcomp.tile_monomials(grid)
    assert mono.shape == (6, 256) and origins.shape == (n_tiles, 2)
    np.testing.assert_array_equal(origins[5].numpy(), [16.0, 16.0])
    np.testing.assert_array_equal(origins[8 + 5].numpy(), [16.0, 16.0])
    np.testing.assert_array_equal(mono[4].numpy(),
                                  (mono[1] * mono[2]).numpy())
    rng = np.random.RandomState(1)
    xy = t(rng.uniform(0, 64, (n_tiles, 5, 2)))
    conic = t(rng.uniform(0.05, 0.5, (n_tiles, 5, 3)))
    coeff, xl, yl = pcomp._alpha_coeff(xy, conic, origins)
    power = pcomp._alpha_power(coeff, mono)
    dx = xy[..., 0:1] - pix[:, None, :, 0]
    dy = xy[..., 1:2] - pix[:, None, :, 1]
    ca, cb, cc = (conic[..., i:i + 1] for i in range(3))
    exact = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    np.testing.assert_allclose(power.numpy(), exact.numpy(), rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_array_equal(xl.numpy(),
                                  (xy[..., 0:1] - origins[:, None, 0:1]).numpy())


@pytest.mark.parametrize("f_dim,tile_w,width,height", [(16, 32, 64, 48)])
def test_rasterize_alpha_matmul_matches_jax(f_dim, tile_w, width, height):
    """``rasterize`` end to end with RasterConfig(alpha_matmul=True) against
    the JAX rasterize through the Pallas kernels (interpret mode) in the
    same mode: images, and the gradients of a loss over them. The mode's
    bars were set at 16x16 tiles; the terms of its regrouped sum grow with
    the square of the tile-local coordinates, so at 32-wide tiles two
    orders of summation part by 4x as much and the bars are 4x as wide."""
    widen = (tile_w / 16) ** 2
    n = 250
    g = scene(n=n, f_dim=f_dim, seed=4, boost=2.0)
    alive = np.ones(n, bool)
    alive[::9] = False
    bg = np.array([0.3, 0.5, 0.1], np.float32)
    jcam, pcam = cameras(width, height)
    common = dict(tile_w=tile_w, tile_h=16, instance_capacity=1 << 13,
                  alpha_matmul=True)
    rng = np.random.RandomState(2)
    wc = rng.randn(height, width, 3).astype(np.float32)
    wf = rng.randn(height, width, f_dim).astype(np.float32)
    names = ("means3d", "opacities", "feat", "scales", "rotations", "shs")

    def jloss(means3d, opacities, feat, scales, rotations, shs):
        o = jrasterize(means3d, opacities, feat, jcam, scales=scales,
                       rotations=rotations, shs=shs, sh_degree=2,
                       bg=jnp.asarray(bg), active_mask=jnp.asarray(alive),
                       config=JRasterConfig(chunk=64, tile_capacity=1 << 10,
                                            backend="pallas_interpret",
                                            **common))
        loss = (jnp.sum(o.color * wc) + jnp.sum(o.feature * wf)
                + jnp.sum(o.depth) * 0.1)
        return loss, o

    (jl, ref), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                           has_aux=True)(
        *(jnp.asarray(g[k]) for k in names))

    leaves = {k: t(g[k]).requires_grad_() for k in names}
    got = rasterize(leaves["means3d"], leaves["opacities"], leaves["feat"],
                    pcam, scales=leaves["scales"],
                    rotations=leaves["rotations"], shs=leaves["shs"],
                    sh_degree=2, bg=t(bg), active_mask=t(alive),
                    config=RasterConfig(chunk=32, **common))
    loss = ((got.color * t(wc)).sum() + (got.feature * t(wf)).sum()
            + got.depth.sum() * 0.1)
    loss.backward()
    for k in ("color", "feature", "alpha"):
        np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                   np.asarray(getattr(ref, k)),
                                   atol=1e-4 * widen, err_msg=k)
    np.testing.assert_allclose(got.depth.detach().numpy(),
                               np.asarray(ref.depth), atol=5e-4 * widen)
    diff = np.abs(got.n_contrib.numpy().astype(np.int64)
                  - np.asarray(ref.n_contrib))
    assert (diff > 0).mean() < 0.01 and diff.max() <= 1
    np.testing.assert_array_equal(got.radii.detach().numpy(),
                                  np.asarray(ref.radii))
    assert int(got.total_instances) == int(ref.total_instances)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    for k, jg in zip(names, jgrads):
        _close_norm(f"d {k}", leaves[k].grad.numpy(), jg, 1e-4 * widen)


def test_alpha_matmul_flag_reaches_the_raster_config():
    import argparse
    parser = argparse.ArgumentParser()
    pconfig.add_raster_args(parser)
    assert pconfig.extract_raster(parser.parse_args([])).alpha_matmul is False
    cfg = pconfig.extract_raster(parser.parse_args(
        ["--alpha_matmul", "--tile_size", "16"]))
    assert cfg.alpha_matmul is True and (cfg.tile_w, cfg.tile_h) == (16, 16)
    assert RasterConfig().alpha_matmul is False
