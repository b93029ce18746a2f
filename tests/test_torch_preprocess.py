"""The per-Gaussian preprocess as one autograd Function
(``ops/rasterize.py:_Preprocess``) on the CPU: its plain halves, the route
that picks them, the kernels' launch plan, and the counters and span.

The closed-form backward (``core/projection.py:preprocess_backward`` with
``core/sh.py:sh_backward``) is held to ``torch.autograd.grad`` through the
plain ops it replaces (``_prep_plain``: ``preprocess``, the ``ndc_offset``
add, ``rect_radius`` and ``tile_rect``) for every differentiable input:
1e-10 of each group's largest magnitude in float64, 1e-5 in float32. The
kernels themselves run on the card only (tests/test_torch_preprocess_cuda.py).
"""
import math

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.core import projection as proj_lib
from feature3dgs_tpu_torch.core import transforms
from feature3dgs_tpu_torch.core.projection import CameraView
from feature3dgs_tpu_torch.ops import cuda_preprocess
from feature3dgs_tpu_torch.ops import rasterize as R

from tests.torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 64, 48
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
KEYS = ("means3d", "scales", "rotations", "shs", "ndc_offset")


def camera(dtype, view=None, tan_x=math.tan(0.5), tan_y=math.tan(0.4),
           width=W, height=H) -> CameraView:
    if view is None:
        view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
    proj = transforms.projection_matrix(0.01, 100.0, 2 * math.atan(tan_x),
                                        2 * math.atan(tan_y)) @ view
    f = lambda x: torch.tensor(np.asarray(x, np.float64), dtype=dtype)
    campos = -view[:3, :3].T @ view[:3, 3]
    return CameraView(f(view), f(proj), f(campos), f(tan_x), f(tan_y), width,
                      height)


def gaussians(n, degree, dtype, seed):
    """n Gaussians around a camera at z = 4 looking at the origin: the
    first 8 behind the near plane, the rest in a box wide enough that many
    lie past the 1.3 tan(fov) clamp; one SH row more than the degree
    reads; every 7th dead under the active mask."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-3.0, 3.0, (n, 3))
    means[:8, 2] = rng.uniform(-6.0, -3.9, 8)
    g = {"means3d": means,
         "scales": np.exp(rng.uniform(-3.5, -1.0, (n, 3))),
         "rotations": rng.randn(n, 4),
         "shs": rng.randn(n, (degree + 1) ** 2 + 1, 3) * 0.5,
         "opacities": rng.uniform(0.05, 0.95, n),
         "ndc_offset": rng.randn(n, 2) * 1e-3}
    g = {k: torch.tensor(v, dtype=dtype) for k, v in g.items()}
    g["active_mask"] = torch.tensor(np.arange(n) % 7 != 3)
    return g


def prep(fn, g, cam, degree, scale_modifier=0.7):
    """fn is ``R._prep_view`` (the Function, plain halves on the CPU) or
    ``R._prep_plain`` (autograd through the plain ops)."""
    route = {"config": R.RasterConfig()} if fn is R._prep_view else {}
    return fn(g["means3d"], g["opacities"], cam, R.RasterConfig().grid(
        cam.width, cam.height), scales=g["scales"], rotations=g["rotations"],
        cov3d_precomp=None, shs=g["shs"], sh_degree=degree,
        colors_precomp=None, scale_modifier=scale_modifier,
        ndc_offset=g["ndc_offset"], active_mask=g["active_mask"], **route)


def grads_both_ways(g, cam, degree, cotangents, outputs=(0, 1, 2, 3)):
    """Gradients of sum(ct * out) over the chosen differentiable outputs
    (xy, depth, conic, rgb) through the Function and through autograd of
    the plain ops; the cotangents are zero where not valid (as the
    compositing hands them)."""
    result = []
    for fn in (R._prep_view, R._prep_plain):
        leaves = {k: g[k].clone().requires_grad_() for k in KEYS}
        pre, xy, _, _, valid = prep(fn, {**g, **leaves}, cam, degree)
        outs = (xy, pre.depth, pre.conic, pre.rgb)
        picked = [outs[i] for i in outputs]
        cts = [cotangents[i] for i in outputs]
        result.append((torch.autograd.grad(picked, [leaves[k] for k in KEYS],
                                           cts, allow_unused=True), valid))
    return result


def random_cotangents(n, valid, dtype, seed):
    rng = np.random.RandomState(seed)
    keep = valid.to(dtype)
    return [torch.tensor(rng.randn(*shape), dtype=dtype) * keep.reshape(
        (n,) + (1,) * (len(shape) - 1)) for shape in ((n, 2), (n,), (n, 3),
                                                      (n, 3))]


def assert_close(got, want, tol, where):
    for name, a, b in zip(KEYS, got, want):
        b = torch.zeros_like(a) if b is None else b
        scale = float(torch.nan_to_num(b).abs().max())
        err = float((a - torch.nan_to_num(b)).abs().max()) / max(scale, 1e-30)
        assert err <= tol, f"{where}: {name} off by {err:.2e} of its largest"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_plain_backward_matches_autograd(degree, dtype):
    """Every differentiable input, scale_modifier 0.7, Gaussians behind the
    near plane, past the frustum clamp and dead under the mask."""
    n = 300
    g = gaussians(n, degree, dtype, seed=degree)
    cam = camera(dtype)
    with torch.no_grad():
        pre, xy, _, _, valid = prep(R._prep_plain, g, cam, degree)
    cts = random_cotangents(n, valid, dtype, seed=10 + degree)
    (got, valid_f), (want, valid_p) = grads_both_ways(g, cam, degree, cts)
    assert torch.equal(valid_f, valid_p)
    assert_close(got, want, TOL[dtype], f"degree {degree} {dtype}")

    # the cases the scene was built to hold, each present and culled to zeros
    t = proj_lib._affine3(g["means3d"], cam.view)
    past_clamp = (t[:, 0] / t[:, 2]).abs() > 1.3 * cam.tan_fovx
    assert int((past_clamp & valid).sum()) >= 5
    dead = ~g["active_mask"]
    behind = t[:, 2] <= 0.2
    assert behind[:8].all() and dead.any()
    for k, grad in zip(KEYS, got):
        assert not grad[behind | dead | ~valid].any(), k
    rows = (degree + 1) ** 2
    assert not got[3][:, rows:].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_non_invertible_cov2d_gets_exact_zeros(dtype):
    """A camera whose view rows 0 and 1 agree, W = H and tan_fovx = tan_fovy
    makes both Jacobian rows equal; Gaussians large enough that the 0.3
    low-pass is lost in the rounding then have a = b = c and det = 0 exactly.
    They are culled, and their gradients are exact zeros (autograd's are not
    finite there); in float64 the other rows match autograd."""
    view = np.array([[1.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0],
                     [0.0, 0.0, 1.0, 4.0], [0.0, 0.0, 0.0, 1.0]])
    cam = camera(dtype, view=view, tan_y=math.tan(0.5), width=W, height=W)
    n = 64
    g = gaussians(n, 2, dtype, seed=7)
    g["means3d"][:, 2] = g["means3d"][:, 2].abs()
    g["scales"][:16] = 1e8
    with torch.no_grad():
        cov3d = proj_lib.build_cov3d(g["scales"], g["rotations"], 0.7)
        cov2d = proj_lib.compute_cov2d(g["means3d"], cov3d, cam)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    singular = det == 0
    assert int(singular.sum()) >= 8
    with torch.no_grad():
        valid = prep(R._prep_plain, g, cam, 2)[-1]
    assert not valid[singular].any()
    # cotangents on the valid rows and, though no pixel would give them
    # any, on the singular ones
    reach = valid | singular
    cts = random_cotangents(n, reach, dtype, 1)
    (got, _), (want, _) = grads_both_ways(g, cam, 2, cts)
    ok = valid & (torch.arange(n) >= 16)
    for k, grad, ref in zip(KEYS, got, want):
        assert not grad[singular].any(), k
        assert torch.isfinite(grad).all(), k
        if dtype != torch.float64:
            continue    # the float32 rounding is held by the test above
        scale = float(torch.nan_to_num(ref[ok]).abs().max())
        err = float((grad[ok] - ref[ok]).abs().max()) / max(scale, 1e-30)
        assert err <= TOL[dtype], (k, err)


@pytest.mark.parametrize("outputs", [(3,), (0, 2), (1,)])
def test_unused_outputs_come_as_none_and_read_zero(outputs):
    """A loss that reaches only some outputs: the others' cotangents come to
    the backward as None (not materialised) and count as zero."""
    dtype, degree, n = torch.float64, 3, 200
    g = gaussians(n, degree, dtype, seed=3)
    cam = camera(dtype)
    with torch.no_grad():
        valid = prep(R._prep_plain, g, cam, degree)[-1]
    cts = random_cotangents(n, valid, dtype, seed=4)
    (got, _), (want, _) = grads_both_ways(g, cam, degree, cts, outputs)
    assert_close([torch.zeros_like(g[k]) if x is None else x
                  for k, x in zip(KEYS, got)], want, TOL[dtype],
                 f"outputs {outputs}")


def test_function_forward_equals_the_plain_ops():
    """The plain half's forward is the plain ops, bit for bit; ``pre.xy``
    is the offset xy there (the plain ops' ``pre.xy`` lacks the offset)."""
    g = gaussians(300, 3, torch.float32, seed=5)
    cam = camera(torch.float32)
    with torch.no_grad():
        pre_f, *rest_f = prep(R._prep_view, g, cam, 3)
        pre_p, *rest_p = prep(R._prep_plain, g, cam, 3)
    assert torch.equal(pre_f.xy, rest_p[0])
    for x, y in zip(list(pre_f[1:]) + rest_f, list(pre_p[1:]) + rest_p):
        assert torch.equal(x, y)


def _inputs_for_route(dtype=torch.float32):
    g = gaussians(50, 1, dtype, seed=2)
    return g, camera(dtype)


def test_route_follows_the_inputs():
    g, cam = _inputs_for_route()
    path = lambda config=R.RasterConfig(), **kw: R._preprocess_path(
        config, g["means3d"], kw.get("scales", g["scales"]),
        kw.get("rotations", g["rotations"]), kw.get("shs", g["shs"]),
        kw.get("cov3d", None), kw.get("colors", None))
    assert path() == "plain"
    assert path(R.RasterConfig(backend="plain")) == "plain"
    assert path(R.RasterConfig(backend="cuda")) == "kernels"
    assert path(cov3d=torch.zeros(50, 6), scales=None,
                rotations=None) == "autograd"
    assert path(colors=torch.zeros(50, 3), shs=None) == "autograd"
    # CUDA-only kernels: asked for on CPU tensors, the wrapper refuses
    with pytest.raises(ValueError, match="CUDA tensors"):
        R._prep_view(g["means3d"], g["opacities"], cam, R.RasterConfig(
            backend="cuda").grid(W, H), scales=g["scales"],
            rotations=g["rotations"], cov3d_precomp=None, shs=g["shs"],
            sh_degree=1, colors_precomp=None, scale_modifier=1.0,
            ndc_offset=None, active_mask=None,
            config=R.RasterConfig(backend="cuda"))


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """render, render_batch and rasterize with every SH / precomputed input
    on the CPU: the wrappers are never called."""
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.render.renderer import render, render_batch

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the preprocess kernels")
    monkeypatch.setattr(R, "preprocess_forward_cuda", refuse)
    monkeypatch.setattr(R, "preprocess_backward_cuda", refuse)
    rng = np.random.RandomState(0)
    n = 120
    params, state = G.create_from_pcd(
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        rng.rand(n, 3).astype(np.float32), max_sh_degree=2, feature_dim=4,
        capacity=n, knn_mean_dists=np.full(n, 1e-2, np.float32),
        device=torch.device("cpu"))
    state.active_sh_degree = 2
    for k in G.GaussianParams.FIELDS:
        getattr(params, k).requires_grad_(True)
    cam = camera(torch.float32)
    out = render(params, state, cam, ndc_offset=torch.zeros(
        (n, 2), requires_grad=True))
    out.color.sum().backward()
    render(params, state, cam, compute_cov3d_outside=True,
           convert_shs_outside=True).color.sum().backward()
    with torch.no_grad():
        render_batch(params, state, [cam, cam])
    assert params.xyz.grad is not None


def test_preprocess_plan_arithmetic():
    plan = cuda_preprocess.preprocess_plan(1_000_000, 3, 16)
    assert plan.threads == cuda_preprocess.THREADS == 128
    assert plan.blocks == 7813 and plan.sh_rows == 16
    assert plan.row_stride == 49
    assert plan.shared_bytes == 4 * (128 * 49 + 37)
    for degree, stride in ((0, 3), (1, 13), (2, 27), (3, 49), (4, 75)):
        p = cuda_preprocess.preprocess_plan(129, degree, 25)
        assert p.row_stride == stride and p.row_stride % 2 == 1
        assert p.row_stride >= 3 * p.sh_rows and p.blocks == 2
    assert cuda_preprocess.preprocess_plan(0, 0, 1).blocks == 0
    with pytest.raises(ValueError, match="degree"):
        cuda_preprocess.preprocess_plan(10, 5, 36)
    with pytest.raises(ValueError, match="cannot be read"):
        cuda_preprocess.preprocess_plan(10, 3, 9)
    with pytest.raises(ValueError, match="Gaussians"):
        cuda_preprocess.preprocess_plan(2 ** 29, 3, 16)
    # x / s for a Python float s on the card is x * float32(1 / s)
    assert cuda_preprocess.INV_THREE == float(np.float32(1 / 3))
    assert cuda_preprocess.INV_ALPHA_MIN == 255.0


def test_counters_and_backward_span():
    g = gaussians(120, 2, torch.float32, seed=1)
    cam = camera(torch.float32)
    leaves = {k: g[k].clone().requires_grad_() for k in KEYS}
    with tracing.recording() as session:
        with tracing.span("train.step"):
            pre, xy, *_ = prep(R._prep_view, {**g, **leaves}, cam, 2)
            R._prep_view(g["means3d"], g["opacities"], cam,
                         R.RasterConfig().grid(W, H), scales=None,
                         rotations=None,
                         cov3d_precomp=torch.zeros(120, 6) + 1e-4, shs=None,
                         sh_degree=0, colors_precomp=torch.zeros(120, 3),
                         scale_modifier=1.0, ndc_offset=None,
                         active_mask=None, config=R.RasterConfig())
            with tracing.span("train.backward"):
                torch.autograd.grad(xy.sum() + pre.rgb.sum(),
                                    [leaves["means3d"]])
    summary = session.summary()
    assert summary["counters"]["raster.preprocess_plain"] == 2
    assert "raster.preprocess_fused" not in summary["counters"]
    assert summary["spans"]["raster.preprocess"]["count"] == 2
    assert summary["spans"]["raster.preprocess_backward"]["count"] == 1
    rec = [r for r in session.spans if r[0] == "raster.preprocess_backward"]
    assert rec[0][1][0] == "train.backward"
