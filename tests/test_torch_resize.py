"""The feature resize from the tile layout (``train/losses.py:
resize_bilinear_from_tiles``) on the CPU: the kernels' wrapper refuses what
they cannot take, and CPU tensors take the plain path, counted.

The kernels themselves run on the card only
(tests/test_torch_resize_cuda.py); their agreement with the JAX package's
resize goes through the plain path, ``test_resize_from_tiles_matches_jax``
in tests/test_torch_train.py.
"""
import pytest
import torch
import torch.nn.functional as F

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.ops import cuda_resize
from feature3dgs_tpu_torch.ops.binning import TileGrid
from feature3dgs_tpu_torch.ops.rasterize import tiles_to_image
from feature3dgs_tpu_torch.train import losses

GRID = TileGrid(width=50, height=37, tile_w=16, tile_h=16)
T, P = GRID.num_tiles, GRID.pixels_per_tile
OUT = (20, 13)


def _bad(kind: str, shape: tuple) -> torch.Tensor:
    x = torch.zeros(shape)
    if kind == "dtype":
        return x.double()
    if kind == "shape":
        return torch.zeros((shape[0] - 1,) + shape[1:])
    if kind == "rank":
        return x.reshape(-1)
    if kind == "layout":
        return torch.zeros(shape[::-1]).transpose(0, 2)
    return x


@pytest.mark.parametrize("kind,match", [
    ("dtype", "dtype torch.float64"), ("shape", "has shape"),
    ("rank", "has shape"), ("layout", "must be contiguous"),
    ("cpu", "needs CUDA tensors")])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_wrapper_refuses(kind, match, direction):
    if direction == "forward":
        fn, x = cuda_resize.resize_forward_cuda, _bad(kind, (T, P, 8))
    else:
        fn, x = cuda_resize.resize_backward_cuda, _bad(kind, (*OUT, 8))
    with pytest.raises(ValueError, match=match):
        fn(x, GRID, *OUT)


@pytest.mark.parametrize("out", [(0, 13), (20, 0)])
def test_wrapper_refuses_an_empty_output(out):
    with pytest.raises(ValueError, match="both must be >= 1"):
        cuda_resize.resize_forward_cuda(torch.zeros((T, P, 8)), GRID, *out)


@pytest.mark.parametrize("out", [OUT, (37, 50)])
def test_cpu_takes_the_plain_path_and_counts_it(monkeypatch, out):
    """Values and gradient bit-equal to tiles_to_image + F.interpolate; no
    kernel wrapper is reached; each call counts one ``loss.resize_plain``
    (the same-size case too, which resizes nothing)."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel wrapper")

    monkeypatch.setattr(losses, "resize_forward_cuda", refuse)
    monkeypatch.setattr(losses, "resize_backward_cuda", refuse)
    gen = torch.Generator().manual_seed(0)
    tiles = torch.randn((T, P, 5), generator=gen)
    w = torch.randn((*out, 5), generator=gen)
    got_x, ref_x = tiles.clone().requires_grad_(), tiles.clone()
    ref_x.requires_grad_()
    with tracing.recording() as session:
        got = losses.resize_bilinear_from_tiles(got_x, GRID, *out)
        losses.resize_bilinear_from_tiles(tiles, GRID, *out)
    (got * w).sum().backward()
    img = tiles_to_image(ref_x, GRID).permute(2, 0, 1)[None]
    ref = F.interpolate(img, size=out, mode="bilinear",
                        align_corners=True)[0].permute(1, 2, 0)
    (ref * w).sum().backward()
    assert torch.equal(got, ref) and torch.equal(got_x.grad, ref_x.grad)
    assert session.summary()["counters"] == {"loss.resize_plain": 2}


def test_one_cpu_step_counts_one_plain_resize():
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import Trainer
    scene = synthetic_scene(n_cams=2, w=64, h=48, n_pts=100, f_dim=8)
    tr = Trainer(scene, rcfg=RasterConfig(tile_w=16, tile_h=16, chunk=16,
                                          instance_capacity=1 << 12),
                 speedup=True, device="cpu")
    tr.step(sync=False)
    with tracing.recording() as session:
        tr.step(sync=False)
        tr.step(sync=True)
    counters = session.summary()["counters"]
    assert counters["loss.resize_plain"] == 2
    assert "loss.resize_fused" not in counters
    assert "loss.resize_backward" not in session.summary()["spans"]
