"""PyTorch port vs the JAX package: ``DistributedTrainer``, the host loop
of several cameras a step, on a 1 x 1 mesh on the CPU.

The parity test runs both trainers on the scene of
tests/test_torch_trainer.py (48x32, 4 feature channels, 80 points, 5
cameras) from the same seed at B = 4, with the JAX package's split noise
handed to the port, as that file does for ``Trainer``. The schedule test
holds the port alone: SH bumps, densify and reset over iteration spans,
the log points of ``train``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from feature3dgs_tpu.model import optim as joptim
from feature3dgs_tpu.parallel import make_mesh as jmake_mesh
from feature3dgs_tpu.parallel.trainer import DistributedTrainer as JDist
from feature3dgs_tpu.train import losses as jlosses
from feature3dgs_tpu.train import trainer as jtrainer
from feature3dgs_tpu_torch.model import optim as poptim
from feature3dgs_tpu_torch.parallel import DistributedTrainer, make_mesh
from feature3dgs_tpu_torch.train import trainer as ptrainer

from tests.test_torch_parallel import F_DIM, FIELDS, H, JCFG, PCFG, W
from tests.test_torch_trainer import _NoiseFromJax, _scenes
from tests.torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# a step's one update carries four iterations' learning rates, so the sign
# flips of near-zero Adam components that tests/test_torch_trainer.py
# bounds at 1e-4 a step move the loss further
LOSS_RTOL = 5e-4


class _DistNoiseFromJax(DistributedTrainer, _NoiseFromJax):
    """The port's DistributedTrainer with the JAX trainer's split noise."""


def test_distributed_trainer_matches_jax(monkeypatch):
    """8 iterations at B = 4 on a 1 x 1 mesh, spanning densify rounds at 4
    and 8 and an opacity reset at 8, against the JAX DistributedTrainer:
    the same cameras in the same order, the same densify decisions and
    num_active; the parameters part as in tests/test_torch_trainer.py.
    Losses at 5e-4: a step's one update carries four iterations' learning
    rates, so the sign flips of near-zero Adam components that
    tests/test_torch_trainer.py bounds at 1e-4 a step move it further."""
    monkeypatch.setattr(jlosses, "SEPARABLE_PRECISION",
                        jax.lax.Precision.HIGHEST)
    jscene, pscene = _scenes(n_cams=5)
    common = dict(iterations=8, densify_from_iter=2, densification_interval=4,
                  opacity_reset_interval=8, densify_until_iter=100,
                  densify_grad_threshold=2e-5)
    jo = jtrainer.OptimizationConfig(
        lr=joptim.LRConfig(position_lr_max_steps=8), **common)
    po = ptrainer.OptimizationConfig(
        lr=poptim.LRConfig(position_lr_max_steps=8), **common)
    kw = dict(max_sh_degree=3, feature_dim=F_DIM, capacity_headroom=1.5,
              seed=5, cameras_per_step=4)
    jrcfg = dataclasses.replace(JCFG, instance_capacity=1 << 13,
                                backend="xla")
    prcfg = dataclasses.replace(PCFG, instance_capacity=1 << 13)
    jmesh = jmake_mesh((1, 1), devices=jax.devices()[:1])
    jt = JDist(jscene, mesh=jmesh, ocfg=jo, rcfg=jrcfg, **kw)
    pt = _DistNoiseFromJax(pscene, mesh=make_mesh((1, 1)), ocfg=po,
                           rcfg=prcfg, device="cpu", **kw)
    assert pt.ts.params.capacity == jt.ts.params.capacity

    jreports = []
    real_densify = jtrainer.densify_step

    def recording_densify(*a, **k):
        ts, report = real_densify(*a, **k)
        jreports.append({name: int(v) for name, v in
                         report._asdict().items()})
        return ts, report

    monkeypatch.setattr(jtrainer, "densify_step", recording_densify)
    picked = {"jax": [], "port": []}
    for tr, name in ((jt, "jax"), (pt, "port")):
        real = tr.pick_camera

        def pick(_real=real, _name=name):
            cam = _real()
            picked[_name].append(cam.uid)
            return cam
        tr.pick_camera = pick

    with jax.set_mesh(jmesh):
        for step in range(2):
            jm = jt.step()
            pm = pt.step()
            it = 4 * (step + 1)
            assert pt.iteration == jt.iteration == it
            assert pm["finite"] == float(jm["finite"]) == 1.0
            assert int(pm["num_active"]) == int(jm["num_active"]), it
            assert int(pm["num_instances"]) == int(jm["num_instances"]), it
            np.testing.assert_allclose(pm["loss"], float(jm["loss"]),
                                       rtol=LOSS_RTOL, err_msg=f"loss @ {it}")
        jt.flush_maintenance(drain=True)
    pt.flush_maintenance(drain=True)
    assert picked["port"] == picked["jax"] and len(picked["jax"]) == 8
    assert [r["iteration"] for r in pt.densify_log] == [4, 8]
    assert len(jreports) == 2
    for mine, ref in zip(pt.densify_log, jreports):
        assert {k: mine[k] for k in ref} == ref
    assert sum(r["num_cloned"] + r["num_split"] for r in jreports) > 0
    assert pt.ts.params.capacity == jt.ts.params.capacity
    assert int(pt.ts.adam.step) == int(jt.ts.adam.step) == 2
    alive = pt.ts.gstate.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(jt.ts.gstate.alive))
    lrs = poptim.group_lrs(po.lr, [1, 2, 3, 4], pt.extent)
    for k in FIELDS:
        diff = np.abs(getattr(pt.ts.params, k).numpy()[alive]
                      - np.asarray(getattr(jt.ts.params, k))[alive])
        assert (diff <= 2 * lrs[k]).mean() >= 0.85, (k, diff.max())
        assert diff.max() <= 2 * 2 * lrs[k], (k, diff.max())


def test_distributed_trainer_schedule_over_spans():
    """The SH degree rises once for each multiple of 1000 inside a step's
    span; the densify round and the opacity reset fire when their interval
    boundary falls inside the span; ``train`` logs at the steps that cross
    a log boundary and at the end."""
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    sc = synthetic_scene(n_cams=4, w=W, h=H, n_pts=60, f_dim=F_DIM, seed=0)
    ocfg = ptrainer.OptimizationConfig(
        iterations=3000, densify_from_iter=5, densification_interval=10,
        opacity_reset_interval=14, densify_until_iter=100)
    tr = DistributedTrainer(sc, mesh=make_mesh((1, 1)), cameras_per_step=3,
                            ocfg=ocfg, rcfg=PCFG, max_sh_degree=2,
                            capacity_headroom=2.0, device="cpu")
    tr.iteration = 998
    tr.step(sync=False)                   # 999..1001
    assert tr.ts.gstate.active_sh_degree == 1
    tr.iteration = 1997
    tr.step(sync=False)                   # 1998..2000
    assert tr.ts.gstate.active_sh_degree == 2
    tr.iteration = 5
    events = []
    tr._densify_inputs = lambda: (events.append(("densify", tr.iteration))
                                  or (torch.zeros(2, tr.ts.params.capacity, 3),
                                      tr._extent_dev))
    real_reset = ptrainer.reset_opacity_step

    def reset(ts):
        events.append(("reset", tr.iteration))
        return real_reset(ts)
    # the maintenance (Trainer._dispatch_maintenance) looks it up there
    ptrainer.reset_opacity_step = reset
    try:
        for _ in range(4):                # spans 6-8, 9-11, 12-14, 15-17
            tr.step(sync=False)
        tr.flush_maintenance(drain=True)
    finally:
        ptrainer.reset_opacity_step = real_reset
    # span 9-11 holds 10 (a round), 12-14 holds 14 (a reset); each runs
    # when the next step starts
    assert events == [("densify", 11), ("reset", 14)]
    tr.iteration = 0
    history = tr.train(iterations=7, log_every=4)
    assert [h["iteration"] for h in history] == [6, 9]
