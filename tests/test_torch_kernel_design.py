"""The design of the compositing kernels, as far as a CPU can check it:
the 3xTF32 split their feature products use, the folding of every
w-weighted sum into one product, and the launch plans; and of the fused
Adam kernel: its launch plan and the elements each block updates, the
gradient layouts it reads, its table and the checks its wrapper makes
before a launch.

Tolerances: the forward kernel's bar on features is 1e-5 absolute, the
backward's 5e-6 after dividing by the largest magnitude of the reference
(ROADMAP.md); the alpha_matmul mode's gradient bar is 1e-4 max-normalised.
"""
import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch.ops import cuda_adam, cuda_raster
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


# the seven GaussianParams fields at N Gaussians, F semantic channels
def _field_counts(n, f):
    return [3 * n, 3 * n, 45 * n, 3 * n, 4 * n, n, f * n]


@pytest.mark.parametrize("counts", [
    [5], [4096], [4097], [0, 7, 0], [65536, 512],
    _field_counts(1_000_003, 128), _field_counts(1_000_000, 512),
    [1] * cuda_adam.MAX_TENSORS])
def test_adam_plan_chunks_and_grid(counts):
    plan = cuda_adam.adam_plan(counts)
    chunks = [-(-n // cuda_adam.CHUNK) for n in counts]
    assert plan.blocks == sum(chunks)
    assert len(plan.chunk_end) == cuda_adam.MAX_TENSORS
    assert list(plan.chunk_end[:len(counts)]) == list(np.cumsum(chunks))
    assert set(plan.chunk_end[len(counts):]) <= {plan.blocks}


def test_adam_plan_of_the_training_cells():
    """1 M Gaussians: 187 M elements at F = 128, 571 M at F = 512, in
    chunks of 4096 (256 threads x 4 float4)."""
    assert cuda_adam.CHUNK == 256 * 4 * 4
    assert cuda_adam.adam_plan(_field_counts(10 ** 6, 128)).blocks == 45_658
    assert cuda_adam.adam_plan(_field_counts(10 ** 6, 512)).blocks == 139_408
    # the decoder: w 128 x 512 and b 512
    assert cuda_adam.adam_plan([65_536, 512]) == cuda_adam.AdamPlan(
        (16,) + (17,) * 15, 17)


def _block_span(plan, counts, block):
    """(tensor, first element, end) of what a block updates, found as
    adam.cu's pick() finds them: the tensor is the number of chunk ends at
    or below the block, the chunk its offset from the tensor's first."""
    k = sum(block >= end for end in plan.chunk_end)
    start = (block - (plan.chunk_end[k - 1] if k else 0)) * cuda_adam.CHUNK
    return k, start, min(start + cuda_adam.CHUNK, counts[k])


@pytest.mark.parametrize("counts", [
    [5], [4097, 3], [0, 9000, 0, 1], [3, 4096 * 3 + 2, 8191], [65536, 512]])
def test_adam_blocks_cover_every_element_once(counts):
    """The blocks' spans tile each tensor exactly; within a span the float4
    a thread reads end where the tensor's last count % 4 elements (the
    scalar tail, one thread's) begin."""
    plan = cuda_adam.adam_plan(counts)
    seen = [np.zeros(n, np.int64) for n in counts]
    tails = 0
    for block in range(plan.blocks):
        k, start, end = _block_span(plan, counts, block)
        assert 0 <= start < end <= counts[k] and end - start <= 4096
        seen[k][start:end] += 1
        firsts = range(start, start + cuda_adam.CHUNK, 4)
        whole = [i for i in firsts if i + 4 <= counts[k]]
        tail = [i for i in firsts if i < counts[k] < i + 4]
        assert len(tail) <= 1
        if tail:
            tails += 1
            assert counts[k] - tail[0] == counts[k] % 4
            assert not whole or whole[-1] + 4 == tail[0]
        covered = 4 * len(whole) + (counts[k] % 4 if tail else 0)
        assert covered == end - start
    assert all((s == 1).all() for s in seen)
    assert tails == sum(n % 4 != 0 for n in counts)


def test_adam_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        cuda_adam.adam_plan([])
    with pytest.raises(ValueError):
        cuda_adam.adam_plan([1] * (cuda_adam.MAX_TENSORS + 1))
    with pytest.raises(ValueError):
        cuda_adam.adam_plan([-1])
    with pytest.raises(ValueError):
        cuda_adam.adam_plan([2 ** 31 * cuda_adam.CHUNK])


def _gaussian_grads(n):
    """The gradients autograd hands the SH fields: slices of one [n, 16, 3]
    gradient of their torch.cat."""
    g = torch.zeros(n, 16, 3)
    return g[:, :1], g[:, 1:]


@pytest.mark.parametrize("case,want", [
    ("contiguous", (0, 0)), ("misaligned", (3, 3)), ("dc", (3, 48)),
    ("rest", (45, 48)), ("one_row", (0, 0)), ("scalar", (0, 0)),
    ("empty", (0, 0)), ("rows_at_stride", (4, 10)), ("broadcast", (3, 0))])
def test_adam_grad_layouts(case, want):
    dc, rest = _gaussian_grads(7)
    x = {"contiguous": torch.zeros(7, 3), "misaligned": torch.zeros(22)[1:],
         "dc": dc, "rest": rest, "one_row": torch.zeros(1, 5),
         "scalar": torch.zeros(()), "empty": torch.zeros(0, 3),
         "rows_at_stride": torch.zeros(5, 10)[:, 2:6],
         "broadcast": torch.zeros(1, 3).expand(7, 3)}[case]
    if case == "misaligned":
        x = x.view(7, 3)
    assert cuda_adam.grad_layout(x.shape, x.stride(),
                                 x.data_ptr() % 16 == 0) == want


@pytest.mark.parametrize("case", ["transposed", "inner_stride"])
def test_adam_grad_layouts_refused(case):
    x = {"transposed": torch.zeros(4, 6).t(),
         "inner_stride": torch.zeros(5, 8)[:, ::2]}[case]
    with pytest.raises(ValueError, match="rows at a stride"):
        cuda_adam.grad_layout(x.shape, x.stride(), True)


def test_adam_table_packs_each_tensor_and_rounds_as_torch():
    entries = [cuda_adam.AdamEntry(64 + 16 * i, 65 + 16 * i, 66 + 16 * i,
                                   67 + 16 * i, n, 3 * i, 48 * i, lr)
               for i, (n, lr) in enumerate([(9, 1.6e-4), (5000, 0.0025 / 20),
                                            (3, 0.05)])]
    plan = cuda_adam.adam_plan([e.n for e in entries])
    t = cuda_adam.adam_table(entries, plan, 0.9, 0.999, 1e-15)
    for i, e in enumerate(entries):
        assert (t.p[i], t.g[i], t.m[i], t.v[i]) == (e.p, e.g, e.m, e.v)
        assert (t.n[i], t.g_row_len[i], t.g_row_stride[i]) == (
            e.n, e.g_row_len, e.g_row_stride)
        assert t.lr[i] == float(np.float32(e.lr))
    assert list(t.chunk_end) == list(plan.chunk_end)
    assert t.p[3] is None and t.n[3] == 0
    # each scalar as torch rounds the Python float of the plain version
    one = torch.ones(())
    for got, scalar in ((t.b1, 0.9), (t.one_minus_b1, 1 - 0.9),
                        (t.b2, 0.999), (t.one_minus_b2, 1 - 0.999),
                        (t.eps, 1e-15), (t.lr[1], 0.0025 / 20)):
        assert got == float(one * scalar)
    assert t.one_minus_b1 != float(np.float32(1) - np.float32(0.9))


def _group(n=6, f=5, device="cpu"):
    shapes = {"xyz": (n, 3), "features_dc": (n, 1, 3),
              "features_rest": (n, 15, 3), "opacity": (n, 1),
              "semantic_feature": (n, 1, f)}
    make = lambda: {k: torch.zeros(s, device=device)  # noqa: E731
                    for k, s in shapes.items()}
    params, mu, nu, grads = make(), make(), make(), make()
    grads["features_dc"], grads["features_rest"] = _gaussian_grads(n)
    lrs = dict.fromkeys(params, 1e-3)
    return params, grads, mu, nu, lrs


def test_adam_entries_of_a_gaussian_group():
    params, grads, mu, nu, lrs = _group()
    entries = cuda_adam.adam_entries(params, grads, mu, nu, lrs,
                                     torch.device("cpu"))
    assert [e.n for e in entries] == [18, 18, 270, 6, 30]
    assert [(e.g_row_len, e.g_row_stride) for e in entries] == [
        (0, 0), (3, 48), (45, 48), (0, 0), (0, 0)]
    assert entries[2].g == grads["features_dc"].data_ptr() + 12
    assert [e.p for e in entries] == [p.data_ptr() for p in params.values()]


@pytest.mark.parametrize("fault,match", [
    ("p_float64", "dtype"), ("mu_shape", "shape"),
    ("nu_transposed", "contiguous"), ("p_misaligned", "16-byte"),
    ("g_float64", "dtype"), ("g_shape", "shape"), ("g_meta", "is on"),
    ("g_transposed", "rows at a stride")])
def test_adam_entries_refuse_what_the_kernel_does_not_take(fault, match):
    params, grads, mu, nu, lrs = _group()
    if fault == "p_float64":
        params["xyz"] = params["xyz"].double()
    elif fault == "mu_shape":
        mu["opacity"] = torch.zeros(6)
    elif fault == "nu_transposed":
        nu["xyz"] = torch.zeros(3, 6).t()
    elif fault == "p_misaligned":
        params["opacity"] = torch.zeros(7)[1:].view(6, 1)
    elif fault == "g_float64":
        grads["xyz"] = grads["xyz"].double()
    elif fault == "g_shape":
        grads["opacity"] = torch.zeros(6)
    elif fault == "g_meta":
        grads["xyz"] = torch.zeros(6, 3, device="meta")
    else:
        grads["xyz"] = torch.zeros(3, 6).t()
    with pytest.raises(ValueError, match=match):
        cuda_adam.adam_entries(params, grads, mu, nu, lrs, torch.device("cpu"))


def test_adam_kernel_wrapper_refuses_cpu_tensors():
    params, grads, mu, nu, lrs = _group()
    step = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_adam.adam_cuda_(params, grads, mu, nu, step, lrs, None, b1=0.9,
                             b2=0.999, eps=1e-15)
