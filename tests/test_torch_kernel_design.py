"""The design of the compositing kernels, as far as a CPU can check it:
the 3xTF32 split their feature products use, the folding of every
w-weighted sum into one product, and the launch plans.

Tolerances: the forward kernel's bar on features is 1e-5 absolute, the
backward's 5e-6 after dividing by the largest magnitude of the reference
(ROADMAP.md); the alpha_matmul mode's gradient bar is 1e-4 max-normalised.
"""
import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch.ops import cuda_raster
from feature3dgs_tpu_torch.ops.binning import TileGrid
from feature3dgs_tpu_torch.ops.composite import (composite_plain,
                                                 composite_plain_backward)
from feature3dgs_tpu_torch.ops.tf32 import (matmul_3xtf32_plain,
                                            matmul_tf32_plain, tf32_split)


def _norm_err(got, ref):
    return float((got.double() - ref).abs().max()) / float(ref.abs().max())


def test_tf32_split_is_exact_up_to_the_dropped_bits():
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4096) * np.exp(rng.uniform(-8, 8, 4096)))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    # hi has 11 significant bits: its low 13 mantissa bits are zero
    assert int((hi.view(torch.int32) & 8191).abs().max()) == 0
    assert int((lo.view(torch.int32) & 8191).abs().max()) == 0
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -22
    assert float((lo.abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_product_3xtf32_holds_the_bar_and_one_pass_misses(seed):
    """[512 pixels x 32 entries] . [32 x 128 channels], weights in [0, 1]
    summing to at most 1 a pixel, features ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    w = rng.rand(512, 32) * (rng.rand(512, 32) < 0.2)
    w /= np.maximum(w.sum(1, keepdims=True), 1.0)
    w = torch.from_numpy(w.astype(np.float32))
    feat = torch.from_numpy(rng.randn(32, 128).astype(np.float32))
    ref = w.double() @ feat.double()
    assert float((matmul_3xtf32_plain(w, feat).double() - ref).abs().max()) \
        <= 1e-6          # a tenth of the 1e-5 bar
    assert float((matmul_tf32_plain(w, feat).double() - ref).abs().max()) \
        > 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backward_product_3xtf32_holds_the_bar_and_one_pass_misses(seed):
    """[32 entries x 512 pixels] . [512 x 132] (128 feature cotangents,
    colour and depth)."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((rng.rand(32, 512) * (rng.rand(32, 512) < 0.15))
                         .astype(np.float32))
    g = torch.from_numpy((rng.randn(512, 132)
                          * np.exp(rng.uniform(-3, 0, (512, 1))))
                         .astype(np.float32))
    ref = w.double() @ g.double()
    assert _norm_err(matmul_3xtf32_plain(w, g), ref) <= 5e-7   # bar 5e-6
    assert _norm_err(matmul_tf32_plain(w, g), ref) > 5e-6


def test_monomial_product_3xtf32_holds_the_alpha_matmul_bar():
    """dL/dpower [32 x 512] . (1, X, Y, X^2, XY, Y^2) [512 x 6] of a 32x16
    tile: the six coefficient sums of the alpha_matmul mode as one product,
    at that mode's 1e-4 bar (and in fact at f32 grade)."""
    rng = np.random.RandomState(3)
    d_pow = torch.from_numpy((rng.randn(32, 512) * (rng.rand(32, 512) < 0.15)
                              * np.exp(rng.uniform(-6, 0, (32, 512))))
                             .astype(np.float32))
    lane = torch.arange(512)
    x, y = (lane % 32).float(), (lane // 32).float()
    mono = torch.stack([torch.ones(512), x, y, x * x, x * y, y * y], 1)
    ref = d_pow.double() @ mono.double()
    got = matmul_3xtf32_plain(d_pow, mono)
    for c in range(6):
        assert _norm_err(got[:, c], ref[:, c]) <= 1e-6, c


def _tiny_scene(f_dim, seed=0, n=40, tile=8, width=24, height=16):
    """Splats straight in screen space on a grid of 8x8 tiles, every tile's
    list holding every splat in depth order."""
    rng = np.random.RandomState(seed)
    grid = TileGrid(width=width, height=height, tile_w=tile, tile_h=tile)
    t = grid.num_tiles
    xy = rng.uniform(0, [width, height], (n, 2))
    conic = np.stack([rng.uniform(0.02, 0.2, n), rng.uniform(-0.01, 0.01, n),
                      rng.uniform(0.02, 0.2, n)], 1)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    args = (f32(xy), f32(conic), f32(rng.uniform(0.2, 0.9, n)),
            f32(rng.rand(n, 3)), f32(rng.uniform(1, 5, n)),
            f32(rng.randn(n, f_dim)),
            torch.arange(n, dtype=torch.int32).repeat(t),
            torch.arange(t, dtype=torch.int32) * n,
            torch.full((t,), n, dtype=torch.int32), grid)
    return args, grid, rng


@pytest.mark.parametrize("alpha_matmul", [False, True])
def test_folded_product_gives_the_rgb_depth_and_feature_rows(alpha_matmul):
    """w . [g_feat | g_color | g_depth] equals the d feat, d rgb and d depth
    rows of composite_plain_backward at 5e-6 (the weights w are read off a
    second backward whose feature cotangent is the identity over a tile's
    pixels)."""
    f_dim = 12
    args, grid, rng = _tiny_scene(f_dim)
    p, t = grid.pixels_per_tile, grid.num_tiles
    fwd = composite_plain(*args, chunk=16, alpha_matmul=alpha_matmul)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    g_color, g_feat = f32(rng.randn(t, p, 3)), f32(rng.randn(t, p, f_dim))
    g_depth, g_final = f32(rng.randn(t, p)), f32(rng.randn(t, p))
    ref = composite_plain_backward(
        *args, g_color, g_feat, g_depth, g_final, fwd.final_T, fwd.n_contrib,
        chunk=16, alpha_matmul=alpha_matmul)
    # the weights: d feat under g_feat = identity, with P feature channels
    probe = list(args)
    probe[5] = torch.zeros((args[0].shape[0], p))
    eye = torch.eye(p).expand(t, p, p).contiguous()
    w = composite_plain_backward(
        *probe, g_color, eye, g_depth, g_final, fwd.final_T, fwd.n_contrib,
        chunk=16, alpha_matmul=alpha_matmul).feature        # [L, P]
    assert float(w.max()) > 0.1 and float(w.min()) >= 0.0
    n = args[0].shape[0]
    for tile in range(t):
        rows = slice(tile * n, (tile + 1) * n)
        g_all = torch.cat([g_feat[tile], g_color[tile],
                           g_depth[tile][:, None]], 1)       # [P, F + 4]
        folded = w[rows].double() @ g_all.double()
        parts = ((folded[:, :f_dim], ref.feature[rows]),
                 (folded[:, f_dim:f_dim + 3], ref.geom[rows, 6:9]),
                 (folded[:, f_dim + 3], ref.geom[rows, 9]))
        for got, want in parts:
            scale = max(float(want.abs().max()), 1e-12)
            assert float((got - want.double()).abs().max()) / scale <= 5e-6
        emulated = matmul_3xtf32_plain(w[rows], g_all)
        assert _norm_err(emulated, folded) <= 5e-6


@pytest.mark.parametrize("f_dim", [0, 3, 4, 16, 128, 256, 512])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (8, 8), (32, 32)])
@pytest.mark.parametrize("alpha_matmul", [False, True])
def test_launch_plans(f_dim, tile, alpha_matmul):
    p = tile[0] * tile[1]
    fwd = cuda_raster.forward_plan(p, f_dim, alpha_matmul)
    assert fwd.halves == (2 if f_dim > 64 else 1)
    pixels = fwd.threads // fwd.halves      # of a tile, in one block
    assert pixels % 32 == 0 and fwd.threads <= 256
    assert pixels * fwd.splits >= p > pixels * (fwd.splits - 1)
    assert fwd.channel_tiles in (0, 1, 2, 4, 8)
    assert (fwd.channel_tiles == 0) == (f_dim == 0)
    per_block = 8 * fwd.channel_tiles * fwd.halves      # channels
    assert per_block * fwd.groups >= f_dim
    assert f_dim == 0 or per_block * (fwd.groups - 1) < f_dim
    # two blocks of the main configuration share an SM's shared memory
    assert fwd.smem_bytes <= cuda_raster.MAX_SMEM_BYTES // 2
    assert fwd.smem_bytes == cuda_raster.forward_smem_bytes(
        fwd.threads, fwd.channel_tiles, fwd.halves, alpha_matmul)

    bwd = cuda_raster.backward_plan(p, f_dim, alpha_matmul)
    assert bwd.entries in (32, 64) and bwd.entries <= p
    assert bwd.ring_rows in (8, 16, 32) and p % bwd.ring_rows == 0
    assert bwd.smem_bytes <= cuda_raster.MAX_SMEM_BYTES
    assert bwd.smem_bytes == cuda_raster.backward_smem_bytes(
        p, f_dim, alpha_matmul, bwd.entries, bwd.ring_rows)
    if p <= 512:
        assert bwd.entries == 64    # the cotangents stream once per 64


def test_main_configuration_plans():
    """32x16 tiles, F = 128: the numbers the sources' header notes state."""
    fwd = cuda_raster.forward_plan(512, 128)
    # 128 pixels x 128 channels a block: two threads a pixel, 4 blocks a tile
    assert fwd == cuda_raster.ForwardPlan(8, 2, 1, 4, 256, 55616)
    assert cuda_raster.forward_plan(512, 64) == cuda_raster.ForwardPlan(
        8, 1, 1, 2, 256, 55040)
    bwd = cuda_raster.backward_plan(512, 128)
    assert bwd == cuda_raster.BackwardPlan(64, 32, 199552)
    assert cuda_raster.backward_plan(512, 128, True).smem_bytes == 203648


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        cuda_raster.forward_plan(2048, 16)
    with pytest.raises(ValueError):
        cuda_raster.backward_plan(48, 16)       # not whole warps
    with pytest.raises(ValueError):
        cuda_raster.backward_plan(1024, 4096)   # no ring stage fits
