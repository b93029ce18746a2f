"""PyTorch port vs the JAX package: losses, the feature resize, Adam, the
learning-rate schedule, the densification statistics and ``train_step``.

Inputs are made with numpy and handed to both packages; the port runs on
the CPU, through the plain versions of its kernels. The JAX feature resize
runs its matmul path at Precision.HIGH (3-pass bf16) by default; these
tests set it to HIGHEST, so that both packages compute in f32.

Bars: values rtol 1e-5 (losses, metrics, moments of a first Adam step);
gradients and Adam moments 1e-5 after dividing by each group's largest
magnitude (the compositing's own bar is 5e-6; SSIM and the resize add
their own f32 rounding); parameters only where the gradient exceeds 1e-3
of its group's largest, because a first Adam step moves every parameter
by lr * sign(g), however small g is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.model import decoder as jdec
from feature3dgs_tpu.model import density as jdensity
from feature3dgs_tpu.model import gaussians as JG
from feature3dgs_tpu.model import optim as joptim
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.ops import binning as jbin
from feature3dgs_tpu.train import losses as jlosses
from feature3dgs_tpu.train import trainer as jtrainer
from feature3dgs_tpu_torch import convert
from feature3dgs_tpu_torch.model import density as pdensity
from feature3dgs_tpu_torch.model import gaussians as PG
from feature3dgs_tpu_torch.model import optim as poptim
from feature3dgs_tpu_torch.ops import binning as pbin
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.train import losses as plosses
from feature3dgs_tpu_torch.train import trainer as ptrainer

from tests.torch_helpers import CPU, cameras, t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = PG.GaussianParams.FIELDS


@pytest.fixture(autouse=True)
def _highest_resize_precision(monkeypatch):
    monkeypatch.setattr(jlosses, "SEPARABLE_PRECISION",
                        jax.lax.Precision.HIGHEST)


def _close_norm(name, got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    s = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got / s, ref / s, atol=tol, err_msg=name)


def test_losses_and_their_gradients_match_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(40, 52, 3).astype(np.float32)
    b = np.clip(a + rng.randn(40, 52, 3).astype(np.float32) * 0.1, 0, 1)
    for name in ("ssim", "psnr", "l1_loss", "l2_loss"):
        np.testing.assert_allclose(
            float(getattr(plosses, name)(t(a), t(b))),
            float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5, err_msg=name)
    ja = jnp.asarray(a)
    jl, jl1 = jlosses.rgb_loss(ja, jnp.asarray(b), 0.2)
    jg = jax.grad(lambda x: jlosses.rgb_loss(x, jnp.asarray(b), 0.2)[0])(ja)
    pa = t(a).requires_grad_()
    pl, pl1 = plosses.rgb_loss(pa, t(b), 0.2)
    pl.backward()
    np.testing.assert_allclose([pl.item(), pl1.item()],
                               [float(jl), float(jl1)], rtol=1e-5)
    _close_norm("d rgb_loss", pa.grad.numpy(), jg)
    js = jax.grad(lambda x: jlosses.ssim(x, jnp.asarray(b)))(ja)
    ps = t(a).requires_grad_()
    plosses.ssim(ps, t(b)).backward()
    _close_norm("d ssim", ps.grad.numpy(), js)


@pytest.mark.parametrize("size,out", [((64, 48), (24, 32)),
                                      ((48, 32), (16, 24))])
def test_resize_from_tiles_matches_jax(size, out):
    """Values and the gradient of the tile-layout resize (the feature loss
    path), 32x16 and 16x16 tiles. Bar: 1e-5 after max-magnitude
    normalisation, because F.interpolate (the original train.py:101 call)
    computes each source coordinate in f32 and the JAX package in f64."""
    width, height = size
    out_h, out_w = out
    for tile_w, tile_h in ((32, 16), (16, 16)):
        jg = jbin.TileGrid(width, height, tile_w, tile_h)
        pg = pbin.TileGrid(width, height, tile_w, tile_h)
        rng = np.random.RandomState(tile_w)
        tiles = rng.randn(jg.num_tiles, jg.pixels_per_tile, 5).astype(
            np.float32)
        w = rng.randn(out_h, out_w, 5).astype(np.float32)
        jt = jnp.asarray(tiles)
        ref = jlosses.resize_bilinear_from_tiles(jt, jg, out_h, out_w)
        jgrad = jax.grad(lambda x: jnp.sum(jlosses.resize_bilinear_from_tiles(
            x, jg, out_h, out_w) * jnp.asarray(w)))(jt)
        pt = t(tiles).requires_grad_()
        got = plosses.resize_bilinear_from_tiles(pt, pg, out_h, out_w)
        (got * t(w)).sum().backward()
        _close_norm("resize", got.detach().numpy(), ref)
        _close_norm("d resize", pt.grad.numpy(), jgrad)


def _params_np(n, f_dim, seed):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {
        "xyz": rng.uniform(-1.5, 1.5, (n, 3)).astype(f32),
        "features_dc": (rng.randn(n, 1, 3) * 0.5).astype(f32),
        "features_rest": (rng.randn(n, 15, 3) * 0.2).astype(f32),
        "scaling": rng.uniform(-3.5, -1.5, (n, 3)).astype(f32),
        "rotation": rng.randn(n, 4).astype(f32),
        "opacity": rng.uniform(-1.0, 3.0, (n, 1)).astype(f32),
        "semantic_feature": (rng.randn(n, 1, f_dim) * 0.3).astype(f32),
    }


@pytest.mark.parametrize("keep", [None, True, False])
def test_adam_update_matches_jax(keep):
    """Two Adam steps from non-zero moments; keep=False leaves params,
    moments and the step counter as they were."""
    p_np = _params_np(30, 4, 1)
    rng = np.random.RandomState(2)
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              p_np.items()} for _ in range(2)]
    mu = {k: rng.randn(*v.shape).astype(np.float32) * 0.1
          for k, v in p_np.items()}
    nu = {k: rng.rand(*v.shape).astype(np.float32) * 0.01
          for k, v in p_np.items()}
    cfg = joptim.LRConfig(position_lr_delay_steps=5)
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in p_np.items()})
    js = joptim.AdamState(
        mu=JG.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=JG.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}),
        step=jnp.int32(7))
    pp = PG.GaussianParams(**{k: t(v) for k, v in p_np.items()})
    ps = poptim.AdamState(PG.GaussianParams(**{k: t(v) for k, v in mu.items()}),
                          PG.GaussianParams(**{k: t(v) for k, v in nu.items()}),
                          torch.tensor(7, dtype=torch.int32))
    for it, g in enumerate(grads, start=8):
        jl = joptim.group_lrs(cfg, jnp.int32(it), 1.5)
        jp, js = joptim.adam_update(
            jp, JG.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}),
            js, jl, keep=None if keep is None else jnp.bool_(keep))
        poptim.adam_update(
            pp, PG.GaussianParams(**{k: t(v) for k, v in g.items()}), ps,
            poptim.group_lrs(poptim.LRConfig(position_lr_delay_steps=5), it,
                             1.5),
            keep=None if keep is None else torch.tensor(keep))
    assert int(ps.step) == int(js.step) == (7 if keep is False else 9)
    for k in FIELDS:
        for name, a, b in (("param", pp, jp), ("mu", ps.mu, js.mu),
                           ("nu", ps.nu, js.nu)):
            np.testing.assert_allclose(getattr(a, k).numpy(),
                                       np.asarray(getattr(b, k)), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {k}")
        if keep is False:
            np.testing.assert_array_equal(getattr(pp, k).numpy(), p_np[k])


def test_tensor_adam_schedule_and_densification_stats_match_jax():
    rng = np.random.RandomState(4)
    dec = {"w": rng.randn(8, 32).astype(np.float32),
           "b": rng.randn(32).astype(np.float32)}
    jd = {k: jnp.asarray(v) for k, v in dec.items()}
    jst = joptim.init_tensor_adam(jd)
    pd = {k: t(v) for k, v in dec.items()}
    pst = poptim.init_tensor_adam(pd, CPU)
    for _ in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in dec.items()}
        jd, jst = joptim.tensor_adam_update(
            jd, {k: jnp.asarray(v) for k, v in g.items()}, jst, lr=1e-4)
        poptim.tensor_adam_update(pd, {k: t(v) for k, v in g.items()}, pst,
                                  lr=1e-4)
    for k in dec:
        for a, b in ((pd, jd), (pst.mu, jst.mu), (pst.nu, jst.nu)):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-5, atol=1e-8)

    for cfg in (joptim.LRConfig(), joptim.LRConfig(position_lr_delay_steps=50,
                                                   position_lr_max_steps=400)):
        pcfg = poptim.LRConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 7, 49, 50, 123, 399, 400, 30_000):
            jl = joptim.group_lrs(cfg, jnp.int32(step), 2.5)
            pl = poptim.group_lrs(pcfg, step, 2.5)
            for k in FIELDS:
                np.testing.assert_allclose(pl[k], float(getattr(jl, k)),
                                           rtol=1e-6, err_msg=f"{k} @ {step}")
        assert poptim.expon_lr(10, 1e-2, 1e-4, max_steps=20) == pytest.approx(
            float(joptim.expon_lr(10, 1e-2, 1e-4, max_steps=20)), rel=1e-6)

    n = 50
    alive = rng.rand(n) > 0.2
    vis = rng.rand(n) > 0.3
    radii = rng.rand(n).astype(np.float32) * 10
    ndc = rng.randn(n, 2).astype(np.float32)
    base = {k: rng.rand(n).astype(np.float32)
            for k in ("max_radii2d", "xyz_gradient_accum", "denom")}
    js = JG.GaussianState(alive=jnp.asarray(alive), **{
        k: jnp.asarray(v) for k, v in base.items()})
    js = jdensity.add_densification_stats(js, jnp.asarray(ndc),
                                          jnp.asarray(vis), jnp.asarray(radii))
    ps = PG.GaussianState(alive=t(alive), **{k: t(v) for k, v in base.items()})
    pdensity.add_densification_stats(ps, t(ndc), t(vis), t(radii))
    for k in base:
        np.testing.assert_allclose(getattr(ps, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-6,
                                   err_msg=k)
    frozen = PG.GaussianState(alive=t(alive),
                              **{k: t(v) for k, v in base.items()})
    pdensity.add_densification_stats(frozen, t(ndc), t(vis), t(radii),
                                     keep=torch.tensor(False))
    for k in base:
        np.testing.assert_array_equal(getattr(frozen, k).numpy(), base[k])


W, H = 64, 48
JCFG = JRasterConfig(tile_w=16, tile_h=16, chunk=16, instance_capacity=1 << 13,
                     tile_capacity=1 << 10, backend="xla")
PCFG = RasterConfig(tile_w=16, tile_h=16, chunk=16, instance_capacity=1 << 13)


def _to_numpy_state(ts) -> dict:
    """A JAX TrainState as the nested numpy dict train_state_from_numpy
    takes."""
    fields = lambda p: {k: np.asarray(getattr(p, k)) for k in FIELDS}
    gs = ts.gstate
    state = {
        "params": fields(ts.params),
        "gstate": {"alive": np.asarray(gs.alive),
                   "max_radii2d": np.asarray(gs.max_radii2d),
                   "xyz_gradient_accum": np.asarray(gs.xyz_gradient_accum),
                   "denom": np.asarray(gs.denom),
                   "active_sh_degree": gs.active_sh_degree,
                   "spatial_lr_scale": gs.spatial_lr_scale},
        "adam": {"mu": fields(ts.adam.mu), "nu": fields(ts.adam.nu),
                 "step": np.asarray(ts.adam.step)},
    }
    if ts.decoder is not None:
        state["decoder"] = {k: np.asarray(v) for k, v in ts.decoder.items()}
        da = ts.decoder_adam
        state["decoder_adam"] = {
            "mu": {k: np.asarray(v) for k, v in da.mu.items()},
            "nu": {k: np.asarray(v) for k, v in da.nu.items()},
            "step": np.asarray(da.step)}
    return state


@pytest.mark.parametrize("speedup", [False, True])
def test_train_step_matches_jax(speedup):
    """One step from the same TrainState (the JAX one carried across by
    train_state_from_numpy): loss and metrics, Adam moments, the
    densification statistics and the parameters that moved by more than
    their gradient's sign; then two more steps, whose losses still agree.
    Speed-up: 16 rendered channels lifted to 64 by the decoder."""
    n = 240
    f_dim, f_out = (16, 64) if speedup else (4, 4)
    p_np = _params_np(n, f_dim, 7)
    alive = np.ones(n, bool)
    alive[200:] = False                        # capacity padding
    alive[::13] = False
    rng = np.random.RandomState(8)
    gt_image = rng.rand(H, W, 3).astype(np.float32)
    gt_feature = (rng.randn(H // 2, W // 2, f_out) * 0.3).astype(np.float16)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jcam, pcam = cameras(W, H)

    gstate = JG.GaussianState(
        alive=jnp.asarray(alive), max_radii2d=jnp.zeros(n),
        xyz_gradient_accum=jnp.zeros(n), denom=jnp.zeros(n),
        active_sh_degree=3, spatial_lr_scale=1.7)
    params = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in p_np.items()})
    decoder = jdec.init_decoder(f_dim, f_out, seed=5) if speedup else None
    jts = jtrainer.TrainState(
        params=params, gstate=gstate, adam=joptim.init_adam(params),
        decoder=decoder,
        decoder_adam=joptim.init_tensor_adam(decoder) if speedup else None)
    pts = convert.train_state_from_numpy(_to_numpy_state(jts), CPU)
    ocfg = jtrainer.OptimizationConfig()
    pocfg = ptrainer.OptimizationConfig()

    jstep = jax.jit(lambda ts, it: jtrainer.train_step(
        ts, jcam, jnp.asarray(gt_image), jnp.asarray(gt_feature),
        jnp.asarray(bg), it, ocfg=ocfg, rcfg=JCFG, speedup=speedup,
        max_sh_degree=3))

    def pstep(it):
        return ptrainer.train_step(pts, pcam, t(gt_image),
                                   torch.from_numpy(gt_feature), t(bg), it,
                                   ocfg=pocfg, rcfg=PCFG, speedup=speedup)

    jts1, jm = jstep(jts, jnp.int32(1))
    pm = pstep(1)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert bool(pm["finite"]) and int(pm["num_active"]) == int(alive.sum())
    assert int(pts.adam.step) == 1
    for k in FIELDS:
        mu_ref = np.asarray(getattr(jts1.adam.mu, k))
        _close_norm(f"mu {k}", getattr(pts.adam.mu, k).numpy(), mu_ref)
        _close_norm(f"nu {k}", getattr(pts.adam.nu, k).numpy(),
                    np.asarray(getattr(jts1.adam.nu, k)))
        big = np.abs(mu_ref) > 1e-3 * np.abs(mu_ref).max()
        np.testing.assert_allclose(
            getattr(pts.params, k).numpy()[big],
            np.asarray(getattr(jts1.params, k))[big], rtol=1e-5, atol=1e-6,
            err_msg=f"param {k}")
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(pts.gstate, k).numpy(),
                                      np.asarray(getattr(jts1.gstate, k)))
    _close_norm("xyz_gradient_accum", pts.gstate.xyz_gradient_accum.numpy(),
                jts1.gstate.xyz_gradient_accum)
    assert float(pts.gstate.xyz_gradient_accum.max()) > 0
    if speedup:
        for k in ("w", "b"):
            _close_norm(f"decoder mu {k}", pts.decoder_adam.mu[k].numpy(),
                        jts1.decoder_adam.mu[k])

    jts_k = jts1
    for it in (2, 3):
        jts_k, jm = jstep(jts_k, jnp.int32(it))
        pm = pstep(it)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss @ {it}")


def test_train_step_discards_a_non_finite_step():
    """A NaN in the teacher map makes the loss non-finite: the whole update
    is discarded on the device (params, moments, step, statistics)."""
    n = 60
    p_np = _params_np(n, 4, 3)
    pp, gs = convert.gaussians_from_numpy(p_np, np.ones(n, bool), 3, CPU)
    ts = ptrainer.TrainState.create(pp, gs, device=CPU)
    _, pcam = cameras(48, 32)
    gt_feature = torch.zeros((16, 24, 4))
    gt_feature[3, 4, 1] = float("nan")
    m = ptrainer.train_step(ts, pcam, torch.rand(32, 48, 3), gt_feature,
                               torch.zeros(3), 1,
                               ocfg=ptrainer.OptimizationConfig(),
                               rcfg=RasterConfig(tile_w=16, tile_h=16),
                               speedup=False)
    assert not bool(m["finite"])
    assert int(ts.adam.step) == 0
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts.params, k).numpy(), p_np[k])
        assert not getattr(ts.adam.mu, k).any()
    assert not ts.gstate.denom.any() and not ts.gstate.max_radii2d.any()
