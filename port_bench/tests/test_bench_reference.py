"""The plain reference against itself at a tiny scene: blocks against one
block, the two-pass gradient against autograd through the whole view, its
Adam against torch's."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from port_bench.harness import scene
from port_bench.reference import render as R
from port_bench.reference import train as T

CFG = {"n_gaussians": 400, "feature_dim": 8, "speedup": True, "sh_degree": 3,
       "scene": {"box": 2.0, "scale": 0.08, "log_scale_std": 0.4,
                 "opacity": [0.05, 0.95], "sh_rest_std": 0.1,
                 "feature_std": 0.1, "teacher_std": 0.1}}
W, H = 80, 48


def tiny_view(seed=7):
    params = scene.draw_gaussians(CFG, seed, "cpu")
    cam = R.make_cam(np.eye(3), np.array([0.0, 0.0, 5.0]), 1.2, 0.9, W, H,
                     "cpu")
    return params, cam


def test_blocks_render_as_one_block():
    params, cam = tiny_view()
    s = R.project(R.activate(params), cam)
    bins = R.bin_tiles(s, W, H)
    whole = R.render(s, bins, W, H)
    blocks = list(R.tile_blocks(bins, budget=1))
    assert len(blocks) == bins.grid_x * bins.grid_y
    parts = [R.blend_block(s, bins, t0, t1) for t0, t1 in blocks]
    # the padding to each block's longest list changes only the rounding
    for k, name in enumerate(("color", "feat", "depth", "final_t")):
        tiles = torch.cat([p[k] for p in parts], 0)
        assert torch.allclose(R.tiles_to_image(tiles, bins, W, H),
                              getattr(whole, name), rtol=1e-5, atol=1e-5)


def test_two_pass_gradient_is_autograd_through_the_view():
    params, cam = tiny_view()
    dec = scene.draw_decoder(CFG, 7, "cpu")
    g = torch.Generator().manual_seed(1)
    gt = torch.rand((H, W, 3), generator=g)
    teacher = 0.1 * torch.randn((H // 2, W // 2, 8), generator=g)
    loss, gp, gd = T.gradients(params, dec, cam, gt, teacher)

    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    dl = {k: v.clone().requires_grad_() for k, v in dec.items()}
    s = R.project(R.activate(leaves), cam)
    bins = R.bin_tiles(s, W, H)
    n = bins.grid_x * bins.grid_y
    color, feat, _, _ = R.blend_block(s, bins, 0, n)
    img = lambda x: R.tiles_to_image(x, bins, W, H)
    direct = T.loss_of(img(color), img(feat), gt, teacher, dl)
    direct.backward()
    assert float(loss) == pytest.approx(float(direct.detach()), rel=1e-6)
    for k, v in leaves.items():
        ref = v.grad
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((gp[k] - ref).abs().max()) <= 1e-5 * scale, k
    for k, v in dl.items():
        assert torch.allclose(gd[k], v.grad, rtol=1e-5, atol=1e-9)


def test_adam_is_torch_adam():
    g = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(50, generator=g)}
    q = torch.nn.Parameter(p["a"].clone())
    opt = torch.optim.Adam([q], lr=0.01, eps=1e-15)
    mu, nu = {"a": torch.zeros(50)}, {"a": torch.zeros(50)}
    for step in range(1, 4):
        grad = torch.randn(50, generator=g)
        T.adam(p, {"a": grad}, mu, nu, step, {"a": 0.01}, 1e-15)
        q.grad = grad.clone()
        opt.step()
        assert torch.allclose(p["a"], q.detach(), rtol=1e-6, atol=1e-7)


def test_losses_fixed_points():
    img = torch.rand(3, 20, 30, generator=torch.Generator().manual_seed(2))
    assert float(T.ssim(img, img)) == pytest.approx(1.0, abs=1e-6)
    assert T.position_lr(15_000, 1.0) == pytest.approx(
        math.sqrt(0.00016 * 0.0000016))
    assert T.position_lr(0, 2.0) == pytest.approx(0.00032)


def test_culled_and_behind_the_camera():
    params, cam = tiny_view()
    params["xyz"][:10, 2] = -6.0          # behind the camera (view z < 0.2)
    s = R.project(R.activate(params), cam)
    assert not s.valid[:10].any() and (s.radius[:10] == 0).all()
    bins = R.bin_tiles(s, W, H)
    assert not torch.isin(bins.gid, torch.arange(10)).any()
