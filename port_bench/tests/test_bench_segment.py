"""The segmenting cell, ``segment_sam64su_auto``, at a tiny width on the CPU:
its parts found by name, a sound run correct, runs whose embedding or
post-processing is altered where the program produces it not correct, the
planted faults and the TF32 control each over a limit, a traced run's
spans, counters and count, and a program without the mask decoder's
post-processing on the card stopped before anything is drawn.

    python -m pytest port_bench/tests/test_bench_segment.py -q
"""
from __future__ import annotations

import time

import pytest
import torch

from conftest import ROOT, SEED

from port_bench import run
from port_bench.harness import check, spec

BENCH = spec.benchmark(ROOT)
NAME = "segment_sam64su_auto"
TINY_VISION = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                   global_attn_indexes=[1], window_size=4, image_size=256,
                   patch_size=16, output_channels=32, mlp_dim=64,
                   num_pos_feats=16)
SPANS = {"sam_decode_ms.serve": "sam.decode",
         "sam_post_ms.serve": "sam.postprocess",
         "sam_select_ms.serve": "sam.select"}


def tiny_cell(**gen):
    """The cell with a 96 x 64 scene of 3,000 Gaussians, 8 channels
    rendered and decoded to 32, a 16 x 16 embedding grid, decoder width 32
    with 2 heads, 4 x 4 points in batches of 8, the published filters."""
    cell = spec.cell(NAME, BENCH)
    c = cell.config
    config = dict(
        c, n_gaussians=3000, width=96, height=64, feature_dim=32,
        teacher_grid=[11, 16], vision=TINY_VISION,
        prompt_encoder=dict(c["prompt_encoder"], hidden_size=32,
                            image_size=256),
        mask_decoder=dict(c["mask_decoder"], hidden_size=32, mlp_dim=64,
                          num_attention_heads=2, iou_head_hidden_dim=32),
        generator=dict(c["generator"], points_per_side=4,
                       points_per_batch=8, **gen),
        draw=dict(hyper_out_scale=256.0, iou_out_shift=0.9))
    return cell._replace(config=config, traffic=dict(
        cell.traffic, warmup_requests=1, trace_requests=2,
        blocking_requests=1))


def run_tiny(trace=False, control=False, seed=SEED, **gen):
    return run.run_cell(tiny_cell(**gen), seed, 0.3, trace,
                        torch.device("cpu"), time.perf_counter(),
                        control=control)


def test_parts_found_by_name():
    cell = spec.cell(NAME, BENCH)
    assert cell.chips == 1 and cell.config["name"] == "sam64_speedup"
    assert cell.config["reduced"] == []
    assert cell.traffic["entry"] == "segment"
    for part in ("run", "reference", "numbers", "count", "frozen"):
        assert callable(getattr(cell.entry, part))
    assert set(cell.limits) == {"embedding_gap", "logit_gap", "iou_gap",
                                "selection_mismatch"}
    assert cell.limits["selection_mismatch"] == 0
    assert {m["name"] for m in cell.metrics} == {"view_ms", "peak_mem_gib",
                                                 "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(SPANS) | {
        "sam_decoder_roofline.serve", "mfu.serve", "idle_share.serve",
        "launches.serve", "blocking_calls.serve", "host_waits.serve",
        "fwd_roofline.serve", "preprocess_ms.serve", "binning_ms.serve",
        "instances.serve", "decoder_ms.serve"}
    for m in cell.metrics + cell.per_layer:
        assert callable(spec.reader(m["name"]))
        if m["name"] in SPANS:
            assert m["workloads"] == [NAME] and m["moves"] == "view_ms"


def test_sound_run_is_correct():
    r = run_tiny()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for name in ("embedding_gap", "logit_gap", "iou_gap"):
        c = r["checks"][name]
        assert c["value"] < c["limit"] / 10, (name, c)
    assert r["checks"]["selection_mismatch"]["value"] == 0
    assert set(r["metrics"]) == {"view_ms", "setup_s"}


def test_embedding_altered_where_it_is_produced(monkeypatch):
    """One part in a thousand of every decoded feature map."""
    from feature3dgs_tpu_torch.model import decoder
    real = decoder.apply_decoder
    monkeypatch.setattr(decoder, "apply_decoder",
                        lambda *a, **k: real(*a, **k) * (1 + 1e-3))
    r = run_tiny()
    assert not r["correct"], r["checks"]
    assert r["checks"]["embedding_gap"]["value"] > \
        r["checks"]["embedding_gap"]["limit"]


def test_post_processing_altered_where_it_is_produced(monkeypatch):
    """The program's post-processed logits shifted by a tenth: its
    selection no longer is the reference's on the same low-resolution
    logits, though the decoder's numbers hold."""
    from feature3dgs_tpu_torch.encoders import sam_decode
    real = sam_decode.postprocess_masks
    monkeypatch.setattr(sam_decode, "postprocess_masks",
                        lambda *a, **k: real(*a, **k) + 0.1)
    r = run_tiny(pred_iou_thresh=0.0, stability_score_thresh=0.0)
    assert not r["correct"], r["checks"]
    assert r["checks"]["selection_mismatch"]["value"] > 0
    assert r["checks"]["logit_gap"]["value"] <= \
        r["checks"]["logit_gap"]["limit"]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32: 10 mantissa bits, ties away from zero."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulated(tf32: bool):
    """``check.precision`` on the CPU: with ``tf32`` every product and
    transposed convolution takes its operands rounded to TF32."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        if not tf32:
            yield
            return
        F = torch.nn.functional
        real = (F.linear, torch.Tensor.__matmul__, F.conv_transpose2d)
        F.linear = lambda x, w, b=None: real[0](_tf32(x), _tf32(w), b)
        torch.Tensor.__matmul__ = lambda a, b: real[1](_tf32(a), _tf32(b))
        F.conv_transpose2d = lambda x, w, b=None, *a, **k: real[2](
            _tf32(x), _tf32(w), b, *a, **k)
        try:
            yield
        finally:
            F.linear, torch.Tensor.__matmul__, F.conv_transpose2d = real
    return cm()


def test_control_and_faults_fail_the_limits(monkeypatch):
    """The TF32 control fails a limit, and so does each planted fault of
    the decoder, on the numbers it reads, and each of the selection, on
    ``selection_mismatch`` alone."""
    monkeypatch.setattr(check, "precision", _emulated)
    r = run_tiny(control=True)
    assert r["correct"], r["checks"]
    limits = tiny_cell().limits
    tf32 = r["control"]["tf32"]
    assert any(tf32[n] > limits[n] for n in limits), tf32
    assert tf32["logit_gap"] > limits["logit_gap"], tf32
    frozen = r["control"]["frozen"]
    from port_bench.reference import sam_mask_decoder as D
    for fault in D.FAULTS:
        over = [n for n in ("logit_gap", "iou_gap", "selection_mismatch")
                if frozen[f"{n}.{fault}"] > limits[n]]
        assert "logit_gap" in over, (fault, frozen)
        assert frozen[f"embedding_gap.{fault}"] == 0.0
    for fault in D.SELECTION_FAULTS:
        over = [n for n in limits if frozen[f"{n}.{fault}"] > limits[n]]
        assert over == ["selection_mismatch"], (fault, frozen)


def test_traced_run_counts_and_records():
    """Per view: 16 prompts, 2 decodes, a post-processing a batch and one
    for the kept masks, a select a batch, a crop and a call; the count's
    decoder operations."""
    from feature3dgs_tpu_torch import tracing
    from port_bench.yardstick import sam_decoder
    r = run_tiny(trace=True)
    assert r["correct"], r["checks"]
    # no card: no device intervals, so no share, launch count or span time
    assert set(r["metrics"]) == {"blocking_calls.serve", "host_waits.serve",
                                 "instances.serve"}
    summary = tracing.last_session().summary()
    views = 2
    assert summary["counters"]["sam.prompts"] == 16 * views
    spans = {k: v["count"] for k, v in summary["spans"].items()}
    assert spans["sam.decode"] == 2 * views
    assert spans["sam.postprocess"] == (2 + 1) * views
    assert spans["sam.select"] == (2 + 1 + 1) * views
    for name in SPANS.values():
        assert summary["spans"][name]["device_self_ms"] is None
    cell = tiny_cell()
    traced = {"units": 2, "cameras": [], "geometry": {
        k: torch.zeros((0, n)) for k, n in (("xyz", 3), ("scaling", 3),
                                            ("rotation", 4),
                                            ("opacity", 1))}}
    counted = cell.entry.count(cell.config, traced, "cpu")
    assert counted["sam_decode_ops"] == 2 * sam_decoder.view_ops(cell.config)


def test_only_kept_requests_are_captured(monkeypatch):
    """The reservoir's slot is drawn before a request runs: the hook copies
    the model's outputs of the kept requests alone, each batch once, to
    the host, and the kept answers hold every batch and the candidates."""
    cell = tiny_cell()
    calls = []
    real = cell.entry._Capture._hook

    def hook(self, mod, args, out):
        calls.append(self.on)
        real(self, mod, args, out)

    monkeypatch.setattr(cell.entry._Capture, "_hook", hook)
    out = cell.entry.run(cell.config, cell.traffic, SEED, 2.0,
                         torch.device("cpu"), False)
    answers = out["readings"]["answers"]
    assert len(answers) == cell.traffic["kept_answers"] < out["units"] - 3
    for a in answers:
        assert a["low_res"].shape == (16, 3, 64, 64)
        assert a["low_res"].device.type == a["embedding"].device.type == \
            "cpu"
        assert a["candidates"] > 0 and a["records"]
    # two batches a request of the window
    assert len(calls) == 2 * out["units"]
    assert 2 * len(answers) <= sum(calls) < len(calls) - 2
    assert sum(calls) % 2 == 0


def test_a_program_without_device_post_processing_stops_at_once(monkeypatch):
    """As on a program older than ``postprocess_masks``: the run raises
    before it draws anything."""
    from feature3dgs_tpu_torch.encoders import sam_decode
    from port_bench.harness import scene
    monkeypatch.delattr(sam_decode, "postprocess_masks")
    drawn = []
    monkeypatch.setattr(scene, "draw_gaussians",
                        lambda *a, **k: drawn.append(1))
    with pytest.raises(RuntimeError, match="postprocess_masks"):
        run_tiny()
    assert not drawn
