"""The yardstick's counts on tiny inputs against counts made by hand."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from port_bench.reference import render as R
from port_bench.yardstick import bounds, flops, peaks


def stack_scene(n=5, opacity=0.95, scale=300.0, f=4):
    """``n`` splats on the axis, one behind the other, so wide that alpha is
    ~opacity at every pixel of a 32x16 image (one tile): each pixel's
    transmittance after k splats is ~0.05^k, so the fourth would take it
    under 1e-4 and ends the pixel; three contribute."""
    z = torch.arange(n, dtype=torch.float32) * 0.1
    p = {"xyz": torch.stack([torch.zeros(n), torch.zeros(n), z], -1),
         "features_dc": torch.zeros(n, 1, 3),
         "features_rest": torch.zeros(n, 15, 3),
         "scaling": torch.full((n, 3), math.log(scale)),
         "rotation": torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
         "opacity": torch.full((n, 1), math.log(opacity / (1 - opacity))),
         "semantic_feature": torch.ones(n, 1, f)}
    cam = R.make_cam(np.eye(3), np.array([0.0, 0.0, 5.0]), 1.2, 0.9, 32, 16,
                     "cpu")
    s = R.project(R.activate(p), cam)
    bins = R.bin_tiles(s, 32, 16)
    stats = {}
    img = R.render(s, bins, 32, 16, stats=stats)
    return s, bins, img, stats


def test_reference_counts_the_stack_by_hand():
    _, bins, img, stats = stack_scene()
    assert bins.counts.tolist() == [5]
    assert stats["tested"] == 4 * 512          # the fourth ends each pixel
    assert stats["contributing"] == 3 * 512
    assert stats["walked"] == 3 * 512          # up to the last contributor
    assert stats["entries_tested"] == 4
    assert stats["entries_walked"] == 3
    assert stats["tested_gaussians"].tolist() == [True] * 4 + [False]
    assert stats["walked_gaussians"].tolist() == [True] * 3 + [False] * 2
    assert stats["contributing_gaussians"].tolist() == [True] * 3 + [False] * 2
    # transmittance left: 0.05^3 to within the splats' falloff
    assert torch.allclose(img.final_t, torch.full_like(img.final_t, 0.05 ** 3),
                          rtol=1e-2)


def test_bounds_of_the_stack_by_hand():
    _, _, _, stats = stack_scene(f=4)
    f, p = 4, 512
    n_bytes, ops = bounds.forward_bound(stats, 1, p, f)
    assert n_bytes == 4 * (6 * 4 + (4 + f) * 3 + 4 + 2 + p * (f + 6))
    assert ops == 15 * 2048 + (16 + 2 * f) * 1536
    n_bytes, ops = bounds.backward_bound(stats, 1, p, 5, f)
    assert n_bytes == 4 * (p * (f + 7) + 6 * 3 + 4 * 3 + 3 + 2 + 5 * (10 + f))
    assert ops == 15 * 1536 + (50 + 2 * f) * 1536
    secs, by = bounds.bound_seconds(3.35e12, 1.0)
    assert secs == pytest.approx(1.0) and by == "bytes"
    secs, by = bounds.bound_seconds(1.0, 67e12)
    assert secs == pytest.approx(1.0) and by == "operations"
    assert peaks.PEAK_F32_FLOPS == 67e12 and peaks.PEAK_BYTES == 3.35e12


def test_flops_of_tiny_shapes_by_hand():
    # a 2x3 image: 5 maps x 3 channels x 6 pixels x 2 passes x 11 taps x 2,
    # and 20 operations a channel-pixel for the SSIM terms
    assert flops.ssim(2, 3) == 5 * 3 * 6 * 44 + 20 * 3 * 6 == 4320
    assert flops.decoder(6, 2, 4, False) == 96
    assert flops.decoder(6, 2, 4, True) == 192
    stats = {"tested": 10, "contributing": 4, "walked": 6}
    assert flops.composite(stats, 2, False) == 150 + 4 * 20
    assert flops.composite(stats, 2, True) == 90 + 4 * 54
    view = flops.serve_view(7, stats, 3, 2, 2, 4, True)
    assert view == 7 * 430 + 230 + 2 * 6 * 2 * 4
    step = flops.train_step(7, 9, stats, stats, 3, 2, (1, 2), 2, 4, True, 100)
    assert step == (7 * 1290 + 230 + 306 + 9 * 12 + 2 * 7 * 2 * 2
                    + 32 + 64 + 3 * 4320 + 5 * (18 + 8) + 14 * 100)
