"""A run with the timed path broken underneath reads ``correct`` false: the
harness's look for a chip skipped, the rest of a run driven on the CPU at a
tiny size, each fault the cell can have planted in the program."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import run_tiny

from port_bench.harness import spec

BENCH = spec.benchmark()


def cell(name):
    return spec.cell(name, BENCH)


def _clone_state(ts):
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.model import optim
    copy = lambda p: G.GaussianParams(**{k: getattr(p, k).clone()
                                         for k in G.GaussianParams.FIELDS})
    gstate = dataclasses.replace(ts.gstate, **{
        k: getattr(ts.gstate, k).clone() for k in
        ("alive", "max_radii2d", "xyz_gradient_accum", "denom")})
    dec = None if ts.decoder is None else {k: v.clone()
                                           for k, v in ts.decoder.items()}
    dec_adam = None if ts.decoder_adam is None else optim.TensorAdamState(
        {k: v.clone() for k, v in ts.decoder_adam.mu.items()},
        {k: v.clone() for k, v in ts.decoder_adam.nu.items()},
        ts.decoder_adam.step.clone())
    return type(ts)(copy(ts.params), gstate,
                    optim.AdamState(copy(ts.adam.mu), copy(ts.adam.nu),
                                    ts.adam.step.clone()), dec, dec_adam)


@pytest.mark.parametrize("name", ["train_lseg128su_steady",
                                  "train_lseg512_steady"])
def test_sound_training_run_is_correct(name):
    assert run_tiny(cell(name))["correct"]


@pytest.mark.parametrize("name", ["train_lseg128su_steady",
                                  "train_lseg512_steady"])
def test_step_that_leaves_the_state_unchanged(monkeypatch, name):
    from feature3dgs_tpu_torch.train import trainer
    real = trainer.train_step

    def unchanged(ts, *args, **kw):
        return real(_clone_state(ts), *args, **kw)

    monkeypatch.setattr(trainer, "train_step", unchanged)
    r = run_tiny(cell(name))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["serve_lseg128su_view",
                                  "serve_lseg128su_batch8"])
def test_sound_serving_run_is_correct(name):
    assert run_tiny(cell(name))["correct"]


@pytest.mark.parametrize("name", ["serve_lseg128su_view",
                                  "serve_lseg128su_batch8"])
@pytest.mark.parametrize("field", ["color", "feature"])
def test_answer_altered_where_it_is_produced(monkeypatch, name, field):
    """One part in a thousand added to every rendered colour, or one part
    in a thousand of the decoded features."""
    from feature3dgs_tpu_torch.model import decoder
    from feature3dgs_tpu_torch.render import renderer
    if field == "color":
        for fn in ("render", "render_batch"):
            real = getattr(renderer, fn)
            monkeypatch.setattr(renderer, fn, lambda *a, _r=real, **k: (
                lambda o: o._replace(color=o.color + 1e-3))(_r(*a, **k)))
    else:
        real = decoder.apply_decoder
        monkeypatch.setattr(decoder, "apply_decoder",
                            lambda p, f: real(p, f) * (1 + 1e-3))
    assert not run_tiny(cell(name))["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    """render_batch renders the first half of its views and hands them out
    again for the second half."""
    from feature3dgs_tpu_torch.render import renderer
    real = renderer.render_batch

    def half(params, state, cams, **kw):
        b = len(cams)
        out = real(params, state, cams[: b // 2], **kw)
        return type(out)(*(torch.cat([v, v], 0) if v.dim() else v
                           for v in out))

    monkeypatch.setattr(renderer, "render_batch", half)
    assert not run_tiny(cell("serve_lseg128su_batch8"))["correct"]
