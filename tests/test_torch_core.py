"""PyTorch port vs the JAX package: SH, covariance, preprocess, tile rects.

Tolerances: elementwise f32 chains agree to 1e-5 relative or 1e-6
absolute (the two libraries' exp/sqrt may differ by an ulp); integer-valued
results (radius, valid, tile rectangles) must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.core import projection as jproj
from feature3dgs_tpu.core import sh as jsh
from feature3dgs_tpu.ops.rasterize import mark_visible, rect_radius
from feature3dgs_tpu_torch.core import projection as pproj
from feature3dgs_tpu_torch.core import sh as psh
from feature3dgs_tpu_torch.ops import rasterize as prast

from tests.torch_helpers import cameras, scene, t


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_rgb_matches_jax(degree):
    rng = np.random.RandomState(degree)
    n, m = 64, (degree + 1) ** 2
    sh = rng.randn(n, m, 3).astype(np.float32)
    means = rng.randn(n, 3).astype(np.float32)
    campos = np.array([0.1, -0.2, -4.0], np.float32)
    ref = jsh.sh_to_rgb(degree, jnp.asarray(sh), jnp.asarray(means),
                        jnp.asarray(campos))
    got = psh.sh_to_rgb(degree, t(sh), t(means), t(campos))
    _close(got, ref)
    assert psh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)
    rgb = rng.rand(n, 3).astype(np.float32)
    _close(psh.rgb_to_sh_dc(t(rgb)), jsh.rgb_to_sh_dc(jnp.asarray(rgb)))


def test_build_cov3d_matches_jax():
    g = scene(n=128, seed=3)
    # un-normalized quaternions: the covariance uses them as given
    rot = g["rotations"] * np.float32(1.7)
    for mod in (1.0, 0.5):
        ref = jproj.build_cov3d(jnp.asarray(g["scales"]), jnp.asarray(rot), mod)
        got = pproj.build_cov3d(t(g["scales"]), t(rot), mod)
        _close(got, ref)
    _close(pproj.quat_to_rotmat(t(rot)), jproj.quat_to_rotmat(jnp.asarray(rot)))


@pytest.mark.parametrize("width,height,seed", [(48, 32, 0), (64, 48, 1)])
def test_preprocess_matches_jax(width, height, seed):
    g = scene(n=300, seed=seed, max_sh_degree=3)
    # push a few points far off-axis, beyond the 1.3*tan_fov clamp
    g["means3d"][:20, 0] *= 6.0
    jcam, pcam = cameras(width, height)
    ref = jproj.preprocess(
        jnp.asarray(g["means3d"]), jnp.asarray(g["opacities"]), jcam,
        scales=jnp.asarray(g["scales"]), rotations=jnp.asarray(g["rotations"]),
        shs=jnp.asarray(g["shs"]), sh_degree=3)
    got = pproj.preprocess(
        t(g["means3d"]), t(g["opacities"]), pcam, scales=t(g["scales"]),
        rotations=t(g["rotations"]), shs=t(g["shs"]), sh_degree=3)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(ref.radius))
    for name in ("xy", "depth", "conic", "rgb"):
        _close(getattr(got, name).numpy()[v], np.asarray(getattr(ref, name))[v])


@pytest.mark.parametrize("tile_w,tile_h", [(16, 16), (32, 16)])
def test_tile_rect_and_rect_radius_match_jax(tile_w, tile_h):
    """Same inputs through both tile_rect / rect_radius: exact. Points
    include ones far outside the frame and huge radii."""
    rng = np.random.RandomState(tile_w)
    n = 400
    xy = rng.uniform(-300.0, 400.0, (n, 2)).astype(np.float32)
    xy[:50] = rng.uniform(0.0, 64.0, (50, 2)) // 16 * 16  # on tile borders
    radius = np.ceil(rng.uniform(0.0, 40.0, n)).astype(np.float32)
    radius[:10] = 0.0
    opacity = rng.uniform(0.0, 1.0, n).astype(np.float32)
    opacity[:5] = [0.0, 1e-13, 1.0 / 255.0, 0.999, 1.0]
    gx, gy = -(-64 // tile_w), -(-48 // tile_h)

    rr_ref = np.asarray(rect_radius(jnp.asarray(radius), jnp.asarray(opacity)))
    rr = prast.rect_radius(t(radius), t(opacity)).numpy()
    np.testing.assert_array_equal(rr, rr_ref)
    for r in (radius, rr_ref):
        lo_ref, hi_ref = jproj.tile_rect(jnp.asarray(xy), jnp.asarray(r), gx,
                                         gy, tile_w, tile_h)
        lo, hi = pproj.tile_rect(t(xy), t(r), gx, gy, tile_w, tile_h)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_ref))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_ref))
        assert lo.dtype == torch.int32


def test_mark_visible_matches_jax():
    g = scene(n=200, seed=5)
    g["means3d"][:, 2] *= 4.0  # some points behind the near plane
    jcam, pcam = cameras()
    np.testing.assert_array_equal(
        prast.mark_visible(t(g["means3d"]), pcam).numpy(),
        np.asarray(mark_visible(jnp.asarray(g["means3d"]), jcam)))
