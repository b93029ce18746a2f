"""PyTorch port vs the JAX package: adaptive density control
(``densify_and_prune``, ``reset_opacity``), ``grow_capacity``,
``one_up_sh_degree`` and the 3-nearest-neighbour distances.

Both packages start from the same numpy state and get the same split noise
(the JAX draw, handed to the port as an array). Every decision must be the
same: ``alive``, the report's counts and which row lands in which slot are
compared exactly; parameters and Adam moments at 1e-6 (children's positions
go through a quaternion rotation and an einsum in either framework).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.model import density as jdensity
from feature3dgs_tpu.model import gaussians as JG
from feature3dgs_tpu.model import optim as joptim
from feature3dgs_tpu.ops import knn as jknn
from feature3dgs_tpu_torch.model import density as pdensity
from feature3dgs_tpu_torch.model import gaussians as PG
from feature3dgs_tpu_torch.model import optim as poptim
from feature3dgs_tpu_torch.ops import knn as pknn

from tests.torch_helpers import t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = PG.GaussianParams.FIELDS
EXTENT, PERCENT_DENSE, MAX_GRAD, MIN_OPACITY = 4.0, 0.01, 0.0002, 0.005


def _state_np(cap, alive, seed, f_dim=4):
    """Random parameters, Adam moments and densification statistics. Scales
    straddle percent_dense * extent = 0.04 (clones and splits) and a few
    exceed 0.1 * extent (the world-size prune); mean gradients straddle the
    threshold; some opacities lie under min_opacity."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    shapes = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (3, 3),
              "scaling": (3,), "rotation": (4,), "opacity": (1,),
              "semantic_feature": (1, f_dim)}
    params = {k: rng.randn(cap, *s).astype(f32) for k, s in shapes.items()}
    params["scaling"] = np.log(rng.uniform(0.005, 0.09, (cap, 1))
                               * rng.uniform(0.7, 1.0, (cap, 3))).astype(f32)
    params["scaling"][::7] = np.log(rng.uniform(0.3, 0.6, (len(
        params["scaling"][::7]), 3))).astype(f32)
    params["opacity"] = rng.uniform(-7.0, 2.0, (cap, 1)).astype(f32)
    mu = {k: rng.randn(cap, *s).astype(f32) * 0.1 for k, s in shapes.items()}
    nu = {k: rng.rand(cap, *s).astype(f32) * 0.01 for k, s in shapes.items()}
    denom = rng.randint(0, 4, cap).astype(f32)
    accum = (rng.uniform(0, 2.5 * MAX_GRAD, cap) * np.maximum(denom, 1)
             ).astype(f32)
    stats = {"max_radii2d": rng.rand(cap).astype(f32) * 30,
             "xyz_gradient_accum": accum, "denom": denom}
    return params, mu, nu, stats, np.asarray(alive, bool)


def _jax_side(params, mu, nu, stats, alive):
    jp = lambda d: JG.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
    gs = JG.GaussianState(alive=jnp.asarray(alive), **{
        k: jnp.asarray(v) for k, v in stats.items()})
    return jp(params), gs, joptim.AdamState(mu=jp(mu), nu=jp(nu),
                                            step=jnp.int32(11))


def _port_side(params, mu, nu, stats, alive):
    pp = lambda d: PG.GaussianParams(**{k: t(v.copy()) for k, v in d.items()})
    gs = PG.GaussianState(alive=t(alive.copy()), **{
        k: t(v.copy()) for k, v in stats.items()})
    return pp(params), gs, poptim.AdamState(
        pp(mu), pp(nu), torch.tensor(11, dtype=torch.int32))


def _round_both(state_np, key, use_screen_size_prune, extent=EXTENT):
    kw = dict(max_grad=MAX_GRAD, min_opacity=MIN_OPACITY,
              percent_dense=PERCENT_DENSE,
              use_screen_size_prune=use_screen_size_prune)
    cap = state_np[0]["xyz"].shape[0]
    noise = np.asarray(jax.random.normal(key, (2, cap, 3), jnp.float32))
    jout = jdensity.densify_and_prune(*_jax_side(*state_np), key,
                                      extent=extent, **kw)
    pout = pdensity.densify_and_prune(*_port_side(*state_np), t(noise),
                                      extent=extent, **kw)
    return jout, pout


def _assert_same_round(jout, pout):
    (jp, jgs, jadam, jrep), (pp, pgs, padam, prep) = jout, pout
    for name in jrep._fields:
        assert int(getattr(prep, name)) == int(getattr(jrep, name)), name
        assert getattr(prep, name).dim() == 0
    np.testing.assert_array_equal(pgs.alive.numpy(), np.asarray(jgs.alive))
    for k in ("max_radii2d", "xyz_gradient_accum", "denom"):
        assert not getattr(pgs, k).any() and not np.asarray(getattr(jgs, k)).any()
    assert int(padam.step) == int(jadam.step) == 11
    for k in FIELDS:
        for name, a, b in (("param", pp, jp), ("mu", padam.mu, jadam.mu),
                           ("nu", padam.nu, jadam.nu)):
            np.testing.assert_allclose(
                getattr(a, k).numpy(), np.asarray(getattr(b, k)), rtol=1e-6,
                atol=1e-6, err_msg=f"{name} {k}")
    # the verbatim copies (everything but a child's xyz and scaling) are
    # bit-equal, so every source row landed in the same slot
    for k in ("features_dc", "features_rest", "rotation", "opacity",
              "semantic_feature"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)


@pytest.mark.parametrize("use_screen_size_prune", [False, True])
def test_densify_and_prune_matches_jax(use_screen_size_prune):
    """Plenty of free slots, scattered among the alive rows."""
    cap = 144
    alive = np.zeros(cap, bool)
    alive[:60] = True
    alive[5:60:9] = False
    state_np = _state_np(cap, alive, seed=3)
    jout, pout = _round_both(state_np, jax.random.PRNGKey(5),
                             use_screen_size_prune)
    _assert_same_round(jout, pout)
    rep = pout[3]
    assert int(rep.num_cloned) > 0 and int(rep.num_split) > 0
    assert int(rep.num_pruned) > 0
    assert int(rep.granted_slots) == int(rep.wanted_slots)
    if use_screen_size_prune:       # the world-size prune removed more
        other = _round_both(state_np, jax.random.PRNGKey(5), False)[1][3]
        assert int(rep.num_pruned) > int(other.num_pruned)


def test_densify_without_a_free_slot_matches_jax():
    """Nothing fits: no row is written, no parent dies, the round still
    prunes and resets the statistics."""
    cap = 48
    state_np = _state_np(cap, np.ones(cap, bool), seed=4)
    jout, pout = _round_both(state_np, jax.random.PRNGKey(1), False)
    _assert_same_round(jout, pout)
    rep = pout[3]
    assert int(rep.wanted_slots) > 0 and int(rep.granted_slots) == 0
    unpruned = ~(torch.sigmoid(t(state_np[0]["opacity"][:, 0])) < MIN_OPACITY)
    np.testing.assert_array_equal(pout[1].alive.numpy(), unpruned.numpy())
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(pout[0], k).numpy(),
                                      state_np[0][k])


def test_split_that_does_not_fit_is_dropped_whole():
    """One free slot, one Gaussian that wants to split into two: the pair is
    dropped, the parent stays alive, the slot stays free."""
    cap = 16
    alive = np.ones(cap, bool)
    alive[9] = False
    params, mu, nu, stats, alive = _state_np(cap, alive, seed=6)
    stats["xyz_gradient_accum"][:] = 0.0
    stats["denom"][:] = 1.0
    stats["xyz_gradient_accum"][4] = 10 * MAX_GRAD      # the one hot row
    params["scaling"][4] = np.log(0.2)                  # large: a split
    params["opacity"][:] = 1.0                          # nothing to prune
    jout, pout = _round_both((params, mu, nu, stats, alive),
                             jax.random.PRNGKey(2), False)
    _assert_same_round(jout, pout)
    rep = pout[3]
    assert (int(rep.num_split), int(rep.num_cloned)) == (1, 0)
    assert (int(rep.wanted_slots), int(rep.granted_slots)) == (2, 1)
    assert int(rep.num_active) == cap - 1
    assert bool(pout[1].alive[4]) and not bool(pout[1].alive[9])

    # the same Gaussian as a clone takes the one slot
    params["scaling"][4] = np.log(0.01)
    jout, pout = _round_both((params, mu, nu, stats, alive),
                             jax.random.PRNGKey(2), False)
    _assert_same_round(jout, pout)
    assert int(pout[3].num_cloned) == 1 and bool(pout[1].alive[9])
    np.testing.assert_array_equal(pout[0].xyz[9].numpy(), params["xyz"][4])
    assert not pout[2].mu.xyz[9].any() and not pout[2].nu.opacity[9].any()


def test_clones_fill_before_splits_when_slots_run_short():
    """Three free slots for two clones and two splits: both clones land,
    the first split does not fit (one slot left), nor does the second."""
    cap = 24
    alive = np.ones(cap, bool)
    alive[[3, 11, 20]] = False
    params, mu, nu, stats, alive = _state_np(cap, alive, seed=8)
    stats["xyz_gradient_accum"][:] = 0.0
    stats["denom"][:] = 2.0
    stats["xyz_gradient_accum"][[1, 5, 8, 14]] = 50 * MAX_GRAD
    params["scaling"][[1, 14]] = np.log(0.01)           # clones
    params["scaling"][[5, 8]] = np.log(0.3)             # splits
    params["opacity"][:] = 1.0
    jout, pout = _round_both((params, mu, nu, stats, alive),
                             jax.random.PRNGKey(9), False)
    _assert_same_round(jout, pout)
    rep = pout[3]
    assert (int(rep.num_cloned), int(rep.num_split)) == (2, 2)
    assert (int(rep.wanted_slots), int(rep.granted_slots)) == (6, 3)
    assert int(rep.num_active) == 21 + 2
    np.testing.assert_array_equal(pout[0].xyz[3].numpy(), params["xyz"][1])
    np.testing.assert_array_equal(pout[0].xyz[11].numpy(), params["xyz"][14])
    assert not bool(pout[1].alive[20]) and bool(pout[1].alive[5])


def test_densify_takes_a_tensor_extent_and_checks_the_noise_shape():
    cap = 32
    alive = np.arange(cap) < 20
    state_np = _state_np(cap, alive, seed=2)
    kw = dict(max_grad=MAX_GRAD, min_opacity=MIN_OPACITY,
              percent_dense=PERCENT_DENSE, use_screen_size_prune=True)
    noise = torch.from_numpy(
        np.random.RandomState(0).randn(2, cap, 3).astype(np.float32))
    a = pdensity.densify_and_prune(*_port_side(*state_np), noise,
                                   extent=EXTENT, **kw)
    b = pdensity.densify_and_prune(*_port_side(*state_np), noise,
                                   extent=torch.tensor(EXTENT), **kw)
    assert torch.equal(a[1].alive, b[1].alive)
    assert torch.equal(a[0].xyz, b[0].xyz)
    with pytest.raises(ValueError, match="noise has shape"):
        pdensity.densify_and_prune(*_port_side(*state_np), noise[:, :8],
                                   extent=EXTENT, **kw)


def test_reset_opacity_matches_jax():
    cap = 40
    state_np = _state_np(cap, np.ones(cap, bool), seed=5)
    jp, _, jadam = _jax_side(*state_np)
    pp, _, padam = _port_side(*state_np)
    jp, jadam = jdensity.reset_opacity(jp, jadam)
    pdensity.reset_opacity(pp, padam)
    np.testing.assert_allclose(pp.opacity.numpy(), np.asarray(jp.opacity),
                               rtol=1e-6, atol=1e-6)
    assert float(torch.sigmoid(pp.opacity).max()) <= 0.01 + 1e-6
    assert not padam.mu.opacity.any() and not padam.nu.opacity.any()
    assert int(padam.step) == int(jadam.step) == 11
    for k in FIELDS:
        if k != "opacity":
            np.testing.assert_array_equal(getattr(pp, k).numpy(),
                                          state_np[0][k])
            np.testing.assert_array_equal(getattr(padam.mu, k).numpy(),
                                          state_np[1][k])


def test_grow_capacity_and_sh_degree_match_jax():
    cap, new_cap = 20, 48
    alive = np.arange(cap) % 3 != 0
    state_np = _state_np(cap, alive, seed=7)
    jp, jgs, jadam = _jax_side(*state_np)
    pp, pgs, padam = _port_side(*state_np)
    pgs.active_sh_degree, pgs.spatial_lr_scale = 2, 3.5
    jp2, jgs2, jmu2 = JG.grow_capacity(jp, jgs, new_cap, jadam.mu)
    pp2, pgs2, pmu2 = PG.grow_capacity(pp, pgs, new_cap, padam.mu)
    assert pp2.capacity == new_cap and pp.capacity == cap
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(pp2, k).numpy(),
                                      np.asarray(getattr(jp2, k)))
        np.testing.assert_array_equal(getattr(pmu2, k).numpy(),
                                      np.asarray(getattr(jmu2, k)))
    for k in ("alive", "max_radii2d", "xyz_gradient_accum", "denom"):
        np.testing.assert_array_equal(getattr(pgs2, k).numpy(),
                                      np.asarray(getattr(jgs2, k)))
    assert (pgs2.active_sh_degree, pgs2.spatial_lr_scale) == (2, 3.5)
    assert not pgs2.alive[cap:].any()
    # no growth: the same objects come back, with or without moments
    assert PG.grow_capacity(pp, pgs, cap) == (pp, pgs)
    assert PG.grow_capacity(pp, pgs, cap - 1, padam.mu)[2] is padam.mu

    for start in (0, 2, 3):
        js = JG.one_up_sh_degree(jgs.replace(active_sh_degree=start), 3)
        pgs.active_sh_degree = start
        assert (PG.one_up_sh_degree(pgs, 3).active_sh_degree
                == js.active_sh_degree == min(start + 1, 3))

    op = PG.get_opacity(pp, pgs.alive)
    np.testing.assert_allclose(op.numpy(),
                               np.asarray(JG.get_opacity(jp, jgs.alive)),
                               rtol=1e-6, atol=1e-7)
    assert not op[~pgs.alive].any()


@pytest.mark.parametrize("n", [1, 3, 4, 5, 600])
def test_mean_sq_dist_3nn_matches_jax(n):
    """Brute force up to four points, the native grid search beyond (the
    JAX package's first route, built separately); 1e-6 relative."""
    pts = np.random.RandomState(n).uniform(-2, 2, (n, 3)).astype(np.float32)
    got = pknn.mean_sq_dist_3nn(pts)
    ref = np.asarray(jknn.mean_sq_dist_3nn(pts))
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_create_from_pcd_computes_its_own_knn_like_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    cols = rng.rand(50, 3).astype(np.float32)
    jp, jgs = JG.create_from_pcd(pts, cols, max_sh_degree=2, feature_dim=8,
                                 capacity=64)
    pp, pgs = PG.create_from_pcd(pts, cols, max_sh_degree=2, feature_dim=8,
                                 capacity=64, device="cpu")
    for k in FIELDS:
        np.testing.assert_allclose(getattr(pp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(pgs.alive.numpy(), np.asarray(jgs.alive))
