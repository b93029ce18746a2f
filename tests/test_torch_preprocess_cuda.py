"""The preprocess kernels (ops/csrc/preprocess.cu) on the card against
their plain versions.

Needs an NVIDIA GPU with nvcc: marked ``cuda`` and skipped elsewhere. On
the card, run without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_preprocess_cuda.py -q

The forward kernel is held bit for bit to ``ops/rasterize.py:_prep_plain``
(``core/projection.py:preprocess``, ``rect_radius``, ``tile_rect`` and the
cull) run on the same CUDA tensors, and the backward kernel to
``core/projection.py:preprocess_backward``; NaN equals NaN. Both agree with
autograd through the plain ops within float32 rounding (5e-5 of each
group's largest magnitude). Scenes: 300 Gaussians at 64 x 48 and 1,000,000
at 1216 x 800 around bench.py's orbit (``bench_utils.bench_scene``'s
positions), random scales, rotations, opacities and SH, at degrees 0-4.
"""
import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

N_FULL = 1_000_000
TOL_AUTOGRAD = 5e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _small_camera(dev, width=64, height=48):
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import transforms
    view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
    proj = transforms.projection_matrix(0.01, 100.0, 1.0, 0.8) @ view
    return camera_from_numpy(view, proj, transforms.camera_center_from_view(
        view).astype(np.float32), math.tan(0.5), math.tan(0.4), width,
        height, dev)


def scene(dev, n, degree, seed=0):
    """(inputs, camera, grid): n Gaussians, SH rows for ``degree`` plus one
    spare row (rows above the degree are never read), dead rows under the
    active mask, a non-zero ndc_offset, scale_modifier 0.8. The small
    scene's means reach past the frustum clamp and behind the near plane;
    the full one is bench.py's 1 M-point cloud and orbit view 0."""
    from feature3dgs_tpu_torch.bench_utils import bench_camera, bench_scene
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    if n == N_FULL:
        params, _, _, _ = bench_scene(dev, n_gauss=n, f_dim=1)
        means = params.xyz.detach()
        cam = bench_camera(device=dev)
        log_scale = math.log(0.02) + 0.4 * randn(n, 3)
    else:
        means = (rand(n, 3) * 6.0 - 3.0)
        cam = _small_camera(dev)
        log_scale = rand(n, 3) * 2.5 - 3.5
    rot = randn(n, 4)
    rot = rot / rot.norm(dim=1, keepdim=True)
    rows = (degree + 1) ** 2 + 1
    inputs = {"means3d": means.contiguous(), "scales": torch.exp(log_scale),
              "rotations": rot.contiguous(),
              "shs": randn(n, rows, 3) * 0.4,
              "opacities": rand(n) * 0.9 + 0.05,
              "ndc_offset": randn(n, 2) * 1e-3,
              "active_mask": rand(n) > 0.05}
    return inputs, cam, RasterConfig().grid(cam.width, cam.height)


def plain_forward(x, cam, grid, degree, scale_modifier=0.8):
    from feature3dgs_tpu_torch.ops.rasterize import _prep_plain
    pre, xy, rect_min, rect_max, valid = _prep_plain(
        x["means3d"], x["opacities"], cam, grid, scales=x["scales"],
        rotations=x["rotations"], cov3d_precomp=None, shs=x["shs"],
        sh_degree=degree, colors_precomp=None, scale_modifier=scale_modifier,
        ndc_offset=x["ndc_offset"], active_mask=x["active_mask"])
    return (xy, pre.depth, pre.conic, pre.radius, pre.rgb, rect_min,
            rect_max, pre.valid, valid)


def kernel_forward(x, cam, grid, degree, scale_modifier=0.8):
    from feature3dgs_tpu_torch.ops.cuda_preprocess import (
        preprocess_forward_cuda)
    return preprocess_forward_cuda(
        x["means3d"], x["scales"], x["rotations"], x["shs"], x["opacities"],
        cam, grid, sh_degree=degree, scale_modifier=scale_modifier,
        ndc_offset=x["ndc_offset"], active_mask=x["active_mask"])


FWD_NAMES = ("xy", "depth", "conic", "radius", "rgb", "rect_min", "rect_max",
             "pre_valid", "valid")


def mismatches(got, want) -> int:
    """Elements whose bits differ, NaN equal to NaN."""
    got, want = got.contiguous(), want.contiguous()
    if got.dtype == torch.float32:
        both_nan = torch.isnan(got) & torch.isnan(want)
        differ = got.view(torch.int32) != want.view(torch.int32)
        return int((differ & ~both_nan).sum())
    return int((got != want).sum())


def assert_bit_equal(names, got, want, where):
    bad = {name: mismatches(g, w) for name, g, w in zip(names, got, want)}
    bad = {k: v for k, v in bad.items() if v}
    assert not bad, f"{where}: elements unlike the plain version's: {bad}"


def cotangents(n, dev, seed=1):
    """Random cotangents laid out as the compositing backward hands them:
    column slices of one [N, 10] array (xy 0:2, conic 2:5, rgb 6:9, depth
    9)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dg = torch.randn((n, 10), generator=gen, device=dev)
    return dg[:, 0:2], dg[:, 9], dg[:, 2:5], dg[:, 6:9]


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("n", [300, N_FULL])
def test_forward_bit_equal(dev, n, degree):
    x, cam, grid = scene(dev, n, degree, seed=degree)
    assert_bit_equal(FWD_NAMES, kernel_forward(x, cam, grid, degree),
                     plain_forward(x, cam, grid, degree),
                     f"forward n={n} degree={degree}")


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("n", [300, N_FULL])
def test_backward_bit_equal_and_close_to_autograd(dev, n, degree):
    from feature3dgs_tpu_torch.core.projection import preprocess_backward
    from feature3dgs_tpu_torch.ops.cuda_preprocess import (
        preprocess_backward_cuda)
    x, cam, grid = scene(dev, n, degree, seed=10 + degree)
    valid = plain_forward(x, cam, grid, degree)[-1]
    cts = cotangents(n, dev)
    args = (x["means3d"], x["scales"], x["rotations"], x["shs"], degree, 0.8,
            cam, valid, *cts)
    got = preprocess_backward_cuda(*args, want_ndc_offset=True)
    want = preprocess_backward(*args, want_ndc_offset=True)
    names = ("g_means3d", "g_scales", "g_rotations", "g_shs", "g_ndc_offset")
    assert_bit_equal(names, got, want, f"backward n={n} degree={degree}")
    rows = (degree + 1) ** 2
    assert not got[3][:, rows:].any(), "SH rows above the degree"
    assert not got[0][~valid].any() and not got[3][~valid].any()

    # autograd through the plain ops, the cotangents where valid
    keys = ("means3d", "scales", "rotations", "shs", "ndc_offset")
    leaves = {k: x[k].clone().requires_grad_() for k in keys}
    out = plain_forward({**x, **leaves}, cam, grid, degree)
    keep = valid.float()
    outs = (out[0], out[1], out[2], out[4])
    cts_valid = [c * (keep[:, None] if c.dim() == 2 else keep) for c in cts]
    ref = torch.autograd.grad(outs, [leaves[k] for k in keys], cts_valid)
    for name, g, r in zip(names, got, ref):
        r = torch.nan_to_num(r)
        scale = float(r.abs().max())
        err = float((g - r).abs().max()) / max(scale, 1e-30)
        assert err < TOL_AUTOGRAD, f"{name} vs autograd: {err:.2e}"


def test_none_cotangents_read_as_zero(dev):
    from feature3dgs_tpu_torch.core.projection import preprocess_backward
    from feature3dgs_tpu_torch.ops.cuda_preprocess import (
        preprocess_backward_cuda)
    x, cam, grid = scene(dev, 300, 3, seed=3)
    valid = plain_forward(x, cam, grid, 3)[-1]
    g_xy, g_depth, g_conic, g_rgb = cotangents(300, dev)
    args = (x["means3d"], x["scales"], x["rotations"], x["shs"], 3, 0.8, cam,
            valid, None, g_depth, None, g_rgb)
    got = preprocess_backward_cuda(*args)
    want = preprocess_backward(*args)
    assert got[4] is None and want[4] is None
    assert_bit_equal(("g_means3d", "g_scales", "g_rotations", "g_shs"),
                     got[:4], want[:4], "None cotangents")


def _model(dev, n=4000, seed=0):
    from feature3dgs_tpu_torch.model import gaussians as G
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    params, state = G.create_from_pcd(
        pts, cols, max_sh_degree=3, feature_dim=8, capacity=n,
        knn_mean_dists=np.full(n, 1e-3, np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params.features_rest = torch.randn(params.features_rest.shape,
                                       generator=gen, device=dev) * 0.2
    params.rotation = torch.randn(params.rotation.shape, generator=gen,
                                  device=dev)
    params.opacity = torch.randn(params.opacity.shape, generator=gen,
                                 device=dev)
    state.active_sh_degree = 3
    state.alive[::17] = False
    return params, state


def _views(dev, k=3):
    from feature3dgs_tpu_torch.bench_utils import bench_camera
    return [bench_camera(320, 240, device=dev, i=i) for i in range(k)]


def test_render_and_render_batch_bit_equal_one_launch_a_view(dev):
    from feature3dgs_tpu_torch.ops import cuda_preprocess
    from feature3dgs_tpu_torch.render.renderer import render, render_batch
    params, state = _model(dev)
    views = _views(dev)
    with torch.no_grad():
        before = cuda_preprocess.PREPROCESS_LAUNCHES
        singles = [render(params, state, v) for v in views]
        assert cuda_preprocess.PREPROCESS_LAUNCHES - before == len(views)
        batch = render_batch(params, state, views)
        assert cuda_preprocess.PREPROCESS_LAUNCHES - before == 2 * len(views)
    for b, one in enumerate(singles):
        for field in ("color", "feature", "depth", "alpha", "radii",
                      "n_contrib"):
            got, want = getattr(batch, field)[b], getattr(one, field)
            assert torch.equal(got, want), f"view {b}: {field}"


def test_render_one_launch_each_way_radii_as_the_plain_halves(dev):
    """A training render and its backward through the kernels: one forward
    and one backward preprocess launch, finite gradients of every field and
    of ndc_offset; radii and visibility equal those of ``backend="plain"``
    (the plain halves)."""
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops import cuda_preprocess
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.render.renderer import render
    params, state = _model(dev, seed=1)
    for k in G.GaussianParams.FIELDS:
        getattr(params, k).requires_grad_(True)
    view = _views(dev, 1)[0]
    ndc = torch.zeros((params.xyz.shape[0], 2), device=dev,
                      requires_grad=True)
    fwd0 = cuda_preprocess.PREPROCESS_LAUNCHES
    bwd0 = cuda_preprocess.PREPROCESS_BWD_LAUNCHES
    out = render(params, state, view, ndc_offset=ndc)
    loss = out.color.square().mean() + out.feature.abs().mean()
    grads = torch.autograd.grad(loss, [params.xyz, params.scaling,
                                       params.rotation, params.features_dc,
                                       params.features_rest, ndc])
    assert cuda_preprocess.PREPROCESS_LAUNCHES - fwd0 == 1
    assert cuda_preprocess.PREPROCESS_BWD_LAUNCHES - bwd0 == 1
    assert all(torch.isfinite(g).all() for g in grads)
    assert grads[0].abs().sum() > 0 and grads[-1].abs().sum() > 0
    with torch.no_grad():
        plain = render(params, state, view,
                       config=RasterConfig(backend="plain"))
    assert torch.equal(plain.radii, out.radii)
    assert torch.equal(plain.visibility, out.visibility)


def test_camera_from_transposed_matrices(dev):
    """A camera built from transposed matrices (as a viewer's arrive) is
    held row-major and renders as the same camera built from row-major
    ones; a camera handed over at other strides is refused."""
    import dataclasses

    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.render.renderer import render
    params, state = _model(dev, seed=2)
    view = _views(dev, 1)[0]
    args = [view.view.cpu().numpy(), view.proj.cpu().numpy(),
            view.campos.cpu().numpy(), float(view.tan_fovx),
            float(view.tan_fovy), view.width, view.height]
    built = camera_from_numpy(*args, device=dev)
    transposed = camera_from_numpy(args[0].T.copy().T, args[1].T.copy().T,
                                   *args[2:], device=dev)
    assert transposed.view.is_contiguous() and transposed.proj.is_contiguous()
    with torch.no_grad():
        a, b = render(params, state, built), render(params, state, transposed)
        for field in ("color", "feature", "depth", "radii", "n_contrib"):
            assert torch.equal(getattr(a, field), getattr(b, field)), field
        strided = dataclasses.replace(view, view=view.view.T.contiguous().T)
        with pytest.raises(ValueError, match="contiguous"):
            render(params, state, strided)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, cam, grid = scene(dev, 300, 3)
    x64 = {k: (v.double() if v.dtype == torch.float32 else v)
           for k, v in x.items()}
    with pytest.raises(ValueError, match="dtype"):
        kernel_forward(x64, cam, grid, 3)
    strided = dict(x, means3d=torch.randn(300, 6, device=dev)[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        kernel_forward(strided, cam, grid, 3)
    with pytest.raises(ValueError, match="cannot be read to degree"):
        kernel_forward(x, cam, grid, 4)
    cpu = {k: v.cpu() for k, v in x.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_forward(cpu, cam, grid, 3)


@pytest.mark.parametrize("backward", [False, True])
def test_kernels_do_not_spill(dev, backward):
    from feature3dgs_tpu_torch.ops import cuda_preprocess
    for degree in range(5):
        attrs = cuda_preprocess.kernel_attributes(backward, degree)
        assert attrs["local_bytes"] == 0, (degree, attrs)
        assert attrs["blocks_per_sm"] >= 2, (degree, attrs)
