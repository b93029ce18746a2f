"""The per-pixel oracle and the parity check of the PyTorch port.

``ops/oracle.py`` against the JAX package's ``oracle_composite`` on the same
numpy inputs (forward 1e-5 on color, features and final_T, 1e-4 on depth;
gradients through each package's preprocess at 5e-6 max-normalised), the
port's plain compositing route against the port's oracle on the four cases
of tests/test_rasterize.py:84-128 with that file's bars, and
``python -m feature3dgs_tpu_torch.cli.parity_check --device cpu``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature3dgs_tpu.core import projection as jproj
from feature3dgs_tpu.ops import RasterConfig as JRasterConfig
from feature3dgs_tpu.ops.oracle import oracle_composite as joracle
from feature3dgs_tpu_torch.core import projection as pproj
from feature3dgs_tpu_torch.ops.oracle import oracle_composite as poracle
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig, rasterize

from tests.torch_helpers import CPU, cameras, scene, t, one_torch_thread  # noqa: F401
from tests.utils import make_camera, random_gaussians

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SH_DEG = 48, 32, 2
CFG = RasterConfig(tile_w=16, tile_h=16, chunk=16, instance_capacity=1 << 12,
                   backend="plain")
GRID = CFG.grid(W, H)
JCAM, PCAM = cameras(W, H)
PARAMS = ("means3d", "scales", "rotations", "opacities", "shs", "feat")
OUTS = ("color", "feature", "depth", "final_T")


def _assert_close_robust(a, b, name, tight=2e-5, loose=0.02, frac=0.995):
    """tests/test_rasterize.py:72-81: f32 knife edges (alpha == 1/255,
    T == 1e-4) can flip a splat between op orders, so almost every pixel is
    held tight and the worst one loosely."""
    a, b = np.asarray(a), np.asarray(b)
    diff = np.abs(a - b)
    assert np.quantile(diff, frac) < tight, (
        f"{name}: q{frac} diff {np.quantile(diff, frac)} (max {diff.max()})")
    assert diff.max() < loose, f"{name}: max diff {diff.max()}"


def _targets(f_dim, seed=0):
    rng = np.random.RandomState(seed)
    return {"color": rng.rand(H, W, 3).astype(np.float32),
            "feature": rng.randn(H, W, f_dim).astype(np.float32),
            "depth": rng.rand(H, W).astype(np.float32)}


def _jax_oracle(g, bg, feature_alpha_grad=False):
    def f(means3d, scales, rotations, opacities, shs, feat):
        pre = jproj.preprocess(means3d, opacities, JCAM, scales=scales,
                               rotations=rotations, shs=shs, sh_degree=SH_DEG)
        return joracle(pre, feat, jnp.asarray(bg, jnp.float32),
                       JRasterConfig(tile_w=16, tile_h=16).grid(W, H),
                       feature_alpha_grad=feature_alpha_grad)
    return f


def _port_oracle(means3d, scales, rotations, opacities, shs, feat, bg,
                 feature_alpha_grad=False):
    pre = pproj.preprocess(means3d, opacities, PCAM, scales=scales,
                           rotations=rotations, shs=shs, sh_degree=SH_DEG)
    return poracle(pre, feat, torch.tensor(bg, dtype=torch.float32), GRID,
                   feature_alpha_grad=feature_alpha_grad)


def _port_plain(means3d, scales, rotations, opacities, shs, feat, bg):
    o = rasterize(means3d, opacities, feat, PCAM, scales=scales,
                  rotations=rotations, shs=shs, sh_degree=SH_DEG,
                  bg=torch.tensor(bg, dtype=torch.float32), config=CFG)
    return {"color": o.color, "feature": o.feature, "depth": o.depth,
            "final_T": 1.0 - o.alpha}


def _l1_loss(o, targets):
    """tests/test_rasterize.py's oracle loss, for either package."""
    return sum(abs(o[k] - targets[k]).mean()
               for k in ("color", "feature", "depth"))


def _port_grads(render, g, bg, targets, **kw):
    leaves = [t(g[k]).requires_grad_(True) for k in PARAMS]
    loss = _l1_loss(render(*leaves, bg, **kw),
                    {k: t(v) for k, v in targets.items()})
    return [x.numpy() for x in torch.autograd.grad(loss, leaves)]


ORACLE_CASES = {
    # name: (n, seed, opacity boost, background, feature_alpha_grad)
    "plain": (250, 0, None, (0.0, 0.0, 0.0), False),
    "saturated": (220, 3, 3.0, (0.0, 0.0, 0.0), False),
    "white_bg": (200, 4, None, (1.0, 1.0, 1.0), False),
    "feature_alpha_grad": (150, 5, None, (1.0, 0.5, 0.25), True),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_oracle_matches_jax_oracle(case):
    """Forward at 1e-5 (depth 1e-4) and gradients of every parameter
    through both preprocesses at 5e-6 max-normalised. Where the forward
    shows a threshold flip (a pixel past the tight bar), the count is
    reported and the gradients fall back to tests/test_rasterize.py's
    robust bars (5e-4 at the 99.5% quantile, 0.05 at worst)."""
    n, seed, boost, bg, fag = ORACLE_CASES[case]
    g = scene(n=n, f_dim=4, seed=seed, boost=boost)
    jf = _jax_oracle(g, bg, fag)
    jargs = [jnp.asarray(g[k]) for k in PARAMS]
    jo = jax.jit(jf)(*jargs)
    with torch.no_grad():
        po = _port_oracle(*[t(g[k]) for k in PARAMS], bg,
                          feature_alpha_grad=fag)
    flipped = 0
    for k in OUTS:
        tol = 1e-4 if k == "depth" else 1e-5
        diff = np.abs(po[k].numpy() - np.asarray(jo[k]))
        flipped += int((diff.reshape(H, W, -1).max(-1) > tol).sum())
    if boost:
        assert float(po["final_T"].min()) < 1e-3    # termination is reached
    targets = _targets(4, seed)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    jgrads = jax.jit(jax.grad(lambda *a: _l1_loss(jf(*a), jt),
                              argnums=tuple(range(6))))(*jargs)
    pgrads = _port_grads(_port_oracle, g, bg, targets, feature_alpha_grad=fag)
    if flipped:
        for k in OUTS:
            _assert_close_robust(po[k].numpy(), jo[k], f"{case} {k} "
                                 f"({flipped} flipped pixels)",
                                 loose=0.2 if k == "depth" else 0.02)
    else:
        for k in OUTS:
            np.testing.assert_allclose(po[k].numpy(), np.asarray(jo[k]),
                                       rtol=0, atol=1e-4 if k == "depth"
                                       else 1e-5, err_msg=f"{case} {k}")
    for name, a, b in zip(PARAMS, pgrads, jgrads):
        b = np.asarray(b)
        s = max(float(np.abs(b).max()), 1e-8)
        if flipped:
            _assert_close_robust(a / s, b / s, f"{case} grad {name} "
                                 f"({flipped} flipped pixels)",
                                 tight=5e-4, loose=0.05)
        else:
            np.testing.assert_allclose(a / s, b / s, rtol=0, atol=5e-6,
                                       err_msg=f"{case} grad {name}")


def _forward_pair(g, bg):
    args = [t(g[k]) for k in PARAMS]
    with torch.no_grad():
        return _port_plain(*args, bg), _port_oracle(*args, bg)


def test_plain_route_matches_oracle():
    out, o = _forward_pair(scene(n=250, f_dim=4, seed=0), (0.0, 0.0, 0.0))
    _assert_close_robust(out["color"], o["color"], "color")
    _assert_close_robust(out["feature"], o["feature"], "feature")
    _assert_close_robust(out["depth"], o["depth"], "depth", loose=0.2)
    _assert_close_robust(out["final_T"], o["final_T"], "final_T")


def test_plain_route_matches_oracle_saturated():
    # High opacity: early termination (T < 1e-4) and the done latch.
    out, o = _forward_pair(scene(n=600, f_dim=4, seed=3, boost=3.0),
                           (0.0, 0.0, 0.0))
    assert float(out["final_T"].min()) < 1e-3        # termination hit
    _assert_close_robust(out["color"], o["color"], "color")
    _assert_close_robust(out["depth"], o["depth"], "depth", loose=0.2)


def test_plain_route_white_background():
    out, o = _forward_pair(scene(n=200, f_dim=4, seed=4), (1.0, 1.0, 1.0))
    _assert_close_robust(out["color"], o["color"], "color")


def test_plain_route_gradients_match_oracle():
    g = scene(n=150, f_dim=4, seed=5)
    targets = _targets(4)
    bg = (1.0, 0.5, 0.25)
    gp = _port_grads(_port_plain, g, bg, targets)
    go = _port_grads(_port_oracle, g, bg, targets)
    for name, a, b in zip(PARAMS, gp, go):
        s = max(float(np.abs(b).max()), 1e-8)
        _assert_close_robust(a / s, b / s, f"grad {name}", tight=5e-4,
                             loose=0.05)


def test_parity_scene_is_the_scripts():
    """cli.parity_check's scene: tests/utils.py's arrays from the same
    seed, its camera, and at SH degree 3 the colours JAX computes from the
    script's 9 coefficient rows (the clamped row index)."""
    from feature3dgs_tpu_torch.cli import parity_check as pc
    from feature3dgs_tpu_torch.data.synthetic import random_gaussians as prg
    ours = prg(n=pc.N_GAUSS, f_dim=pc.F_DIM, seed=0)
    theirs = random_gaussians(n=pc.N_GAUSS, f_dim=pc.F_DIM, seed=0)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    sc = pc.parity_scene(device="cpu")
    jcam = make_camera(width=pc.WIDTH, height=pc.HEIGHT)
    for k in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(getattr(sc["cam"], k).numpy(),
                                      np.asarray(getattr(jcam, k)), err_msg=k)
    jpre = jproj.preprocess(*[theirs[k] for k in ("means3d", "opacities")],
                            jcam, scales=theirs["scales"],
                            rotations=theirs["rotations"],
                            shs=theirs["shs"], sh_degree=pc.SH_DEGREE)
    ppre = pproj.preprocess(sc["means3d"], sc["opacities"], sc["cam"],
                            **{k: v for k, v in sc["kw"].items() if k != "bg"})
    np.testing.assert_allclose(ppre.rgb.numpy(), np.asarray(jpre.rgb),
                               rtol=0, atol=1e-6)


def test_parity_check_cli_on_cpu():
    """The CLI as a user runs it: exit 0, plain-vs-oracle passes, the
    script's keys on its comparison line and its closing line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "feature3dgs_tpu_torch.cli.parity_check",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [ln.get("compare") for ln in lines[:-1]] == ["plain-vs-oracle"]
    assert set(lines[0]) == {
        "compare", "color_max", "feature_max", "depth_max", "alpha_max",
        "d_means_relmax", "d_opacity_relmax", "d_feature_relmax", "pass"}
    assert lines[0]["pass"] is True
    assert lines[-1] == {"backend": "plain", "platform": "cpu",
                         "all_pass": True}
