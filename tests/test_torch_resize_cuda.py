"""The tile-layout resize kernels (ops/csrc/resize.cu) on the card against
the plain path they replace.

Needs an NVIDIA GPU with nvcc: marked ``cuda`` and skipped elsewhere. On
the card, run without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_resize_cuda.py -q

``train/losses.py:resize_bilinear_from_tiles`` on CUDA tensors (one forward
and one backward launch) is held to ``tiles_to_image`` + ``F.interpolate``
(align_corners=True) and its autograd backward on the same tensors: the
forward bit for bit (the blend is written as ATen writes it, so nvcc
contracts its products into FMAs alike), the backward within 1e-6 of the
largest gradient magnitude (the same terms, summed in a fixed order where
ATen adds them with atomics). Shapes: the bench's 1216 x 800 ->
608 x 400 on 32 x 16 tiles, a crop that is not a multiple of the tile, an
upsample, single-pixel output axes, F = 3, 16, 128 and 512.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL_BWD = 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _grid(width, height, tile_w=32, tile_h=16):
    from feature3dgs_tpu_torch.ops.binning import TileGrid
    return TileGrid(width=width, height=height, tile_w=tile_w, tile_h=tile_h)


def _tiles(dev, grid, f, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((grid.num_tiles, grid.pixels_per_tile, f),
                       generator=gen, device=dev)


def plain(tiles, grid, out_h, out_w):
    from feature3dgs_tpu_torch.ops.rasterize import tiles_to_image
    from feature3dgs_tpu_torch.train.losses import \
        resize_bilinear_align_corners
    return resize_bilinear_align_corners(tiles_to_image(tiles, grid), out_h,
                                         out_w)


def both(tiles, grid, out_h, out_w, seed=1):
    """(kernel out, kernel grad, plain out, plain grad) of sum(out * w) for
    a seeded cotangent w."""
    from feature3dgs_tpu_torch.train.losses import resize_bilinear_from_tiles
    gen = torch.Generator(device=tiles.device).manual_seed(seed)
    w = torch.randn((out_h, out_w, tiles.shape[-1]), generator=gen,
                    device=tiles.device)
    res = []
    for fn in (resize_bilinear_from_tiles, plain):
        x = tiles.clone().requires_grad_()
        out = fn(x, grid, out_h, out_w)
        (out * w).sum().backward()
        res += [out.detach(), x.grad]
    return res


def held(name, k_out, k_grad, p_out, p_grad):
    assert k_out.shape == p_out.shape and k_out.is_contiguous(), name
    assert torch.equal(k_out.view(torch.int32), p_out.view(torch.int32)), name
    assert k_grad.shape == p_grad.shape, name
    scale = float(p_grad.abs().max())
    gap = float((k_grad - p_grad).abs().max())
    assert gap <= TOL_BWD * scale, f"{name}: gradient gap {gap} of {scale}"


@pytest.mark.parametrize("f", [3, 16, 128, 512])
def test_forward_and_backward_match_the_plain_path(dev, f):
    grid = _grid(200, 136)
    held(f"F={f}", *both(_tiles(dev, grid, f, seed=f), grid, 68, 100))


@pytest.mark.parametrize("f", [128, 512])
def test_bench_shape(dev, f):
    grid = _grid(1216, 800)
    held(f"bench F={f}", *both(_tiles(dev, grid, f, seed=f), grid, 400, 608))


@pytest.mark.parametrize("size,out,tile", [
    ((1000, 700), (350, 500), (32, 16)),      # crop off the tile grid
    ((40, 30), (70, 90), (8, 8)),             # upsample
    ((33, 17), (1, 9), (8, 4)),               # one output row
    ((33, 17), (7, 1), (8, 4)),               # one output column
    ((1, 5), (3, 6), (4, 4)),                 # one input column
])
@pytest.mark.parametrize("f", [3, 128])
def test_odd_shapes(dev, size, out, tile, f):
    grid = _grid(*size, *tile)
    k_out, k_grad, p_out, p_grad = both(_tiles(dev, grid, f), grid, *out)
    held(f"{size}->{out}", k_out, k_grad, p_out, p_grad)
    # the padded grid outside the crop gets exact zeros
    from feature3dgs_tpu_torch.ops.rasterize import tiles_to_image
    n = grid.num_tiles * grid.pixels_per_tile
    ids = torch.arange(n, device=dev).reshape(grid.num_tiles, -1, 1)
    outside = torch.ones(n, dtype=torch.bool, device=dev)
    outside[tiles_to_image(ids, grid).flatten()] = False
    assert bool((k_grad.reshape(n, f)[outside] == 0).all())


def test_same_size_is_a_no_op(dev):
    from feature3dgs_tpu_torch.ops import cuda_resize
    from feature3dgs_tpu_torch.ops.rasterize import tiles_to_image
    from feature3dgs_tpu_torch.train.losses import resize_bilinear_from_tiles
    grid = _grid(100, 70)
    tiles = _tiles(dev, grid, 16)
    before = (cuda_resize.RESIZE_LAUNCHES, cuda_resize.RESIZE_BWD_LAUNCHES)
    out = resize_bilinear_from_tiles(tiles, grid, 70, 100)
    assert torch.equal(out, tiles_to_image(tiles, grid))
    assert (cuda_resize.RESIZE_LAUNCHES,
            cuda_resize.RESIZE_BWD_LAUNCHES) == before


def test_two_runs_bit_equal_and_one_launch_a_call(dev):
    from feature3dgs_tpu_torch.ops import cuda_resize
    grid = _grid(1216, 800)
    tiles = _tiles(dev, grid, 128)
    runs = []
    for _ in range(2):
        before = (cuda_resize.RESIZE_LAUNCHES,
                  cuda_resize.RESIZE_BWD_LAUNCHES)
        k_out, k_grad, _, _ = both(tiles, grid, 400, 608)
        assert (cuda_resize.RESIZE_LAUNCHES - before[0],
                cuda_resize.RESIZE_BWD_LAUNCHES - before[1]) == (1, 1)
        runs.append((k_out, k_grad))
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_direct_calls_and_counted_path(dev):
    """The wrappers alone equal the autograd path, and the step's counter
    names the fused path on the card."""
    from feature3dgs_tpu_torch import tracing
    from feature3dgs_tpu_torch.ops import cuda_resize
    from feature3dgs_tpu_torch.train.losses import resize_bilinear_from_tiles
    grid = _grid(300, 200)
    tiles = _tiles(dev, grid, 64)
    g = torch.randn((100, 150, 64), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    with tracing.recording() as session:
        x = tiles.clone().requires_grad_()
        out = resize_bilinear_from_tiles(x, grid, 100, 150)
        out.backward(g)
    assert torch.equal(out.detach(),
                       cuda_resize.resize_forward_cuda(tiles, grid, 100, 150))
    assert torch.equal(x.grad,
                       cuda_resize.resize_backward_cuda(g, grid, 100, 150))
    summary = session.summary()
    assert summary["counters"].get("loss.resize_fused") == 1
    assert "loss.resize_plain" not in summary["counters"]
    assert summary["spans"]["loss.resize_backward"]["count"] == 1


def test_train_step_counts_one_fused_resize_a_step(dev):
    """A training step on the card resizes through the kernels: one
    ``loss.resize_fused`` and one ``loss.resize_backward`` span a step,
    no plain resize, one launch each way."""
    from feature3dgs_tpu_torch import tracing
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.ops import cuda_resize
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import Trainer
    scene = synthetic_scene(n_cams=2, w=64, h=48, n_pts=100, f_dim=8)
    tr = Trainer(scene, rcfg=RasterConfig(tile_w=16, tile_h=16, chunk=16,
                                          instance_capacity=1 << 12),
                 speedup=True, device="cuda")
    tr.step(sync=False)
    before = (cuda_resize.RESIZE_LAUNCHES, cuda_resize.RESIZE_BWD_LAUNCHES)
    with tracing.recording() as session:
        tr.step(sync=False)
        tr.step(sync=True)
    summary = session.summary()
    assert summary["counters"]["loss.resize_fused"] == 2
    assert "loss.resize_plain" not in summary["counters"]
    assert summary["spans"]["loss.resize_backward"]["count"] == 2
    assert (cuda_resize.RESIZE_LAUNCHES - before[0],
            cuda_resize.RESIZE_BWD_LAUNCHES - before[1]) == (2, 2)
