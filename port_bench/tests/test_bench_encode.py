"""The encoder's cell, ``encode_samvith_export``, at a tiny width on the CPU:
its parts found by name, a sound run correct, a run whose embedding is
altered where it is produced not correct, the planted faults and the TF32
control each over the limits, and a traced run's counters and count. On
the CPU TF32 does nothing, so there the control's products take their
operands rounded to TF32's 10-bit mantissa, as the card's tensor cores
do; on the card ``test_bench_control.py`` holds the real one.

    python -m pytest port_bench/tests/test_bench_encode.py -q
"""
from __future__ import annotations

import contextlib
import shutil
import time

import pytest
import torch

from conftest import ROOT, SEED

from port_bench import run
from port_bench.harness import check, spec

BENCH = spec.benchmark(ROOT)
NAME = "encode_samvith_export"
TINY_VISION = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
                   global_attn_indexes=[1, 3], window_size=3, image_size=128,
                   patch_size=16, output_channels=16, mlp_dim=64)
TINY_TRAFFIC = dict(width=76, height=50, distinct_images=3, warmup_images=1,
                    trace_images=2, blocking_images=1)
SPANS = {"sam_prep_ms.serve": "sam.preprocess",
         "sam_window_ms.serve": "sam.window_block",
         "sam_global_ms.serve": "sam.global_block",
         "sam_neck_ms.serve": "sam.neck"}


def tiny_cell():
    cell = spec.cell(NAME, BENCH)
    return cell._replace(config=dict(cell.config, vision=TINY_VISION),
                         traffic=dict(cell.traffic, **TINY_TRAFFIC))


def run_tiny(trace=False, control=False, seed=SEED):
    return run.run_cell(tiny_cell(), seed, 0.3, trace, torch.device("cpu"),
                        time.perf_counter(), control=control)


def test_parts_found_by_name():
    cell = spec.cell(NAME, BENCH)
    assert cell.chips == 1 and cell.config["name"] == "sam_vith"
    assert cell.config["reduced"] == []
    assert cell.traffic["entry"] == "encode"
    for part in ("run", "reference", "numbers", "count", "frozen"):
        assert callable(getattr(cell.entry, part))
    assert set(cell.limits) == {"embedding_gap", "embedding_max_gap",
                                "pixel_gap"}
    assert {m["name"] for m in cell.metrics} == {"view_ms", "peak_mem_gib",
                                                 "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(SPANS) | {
        "mfu.serve", "idle_share.serve", "launches.serve",
        "blocking_calls.serve"}
    for m in cell.metrics + cell.per_layer:
        assert callable(spec.reader(m["name"]))
        if m["name"] in SPANS:
            assert m["workloads"] == [NAME] and m["moves"] == "view_ms"


def test_sound_run_is_correct():
    r = run_tiny()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for name in ("embedding_gap", "embedding_max_gap"):
        c = r["checks"][name]
        assert c["value"] < c["limit"] / 10
    # the processor's pixels and the reference's a rounding apart at most
    assert r["checks"]["pixel_gap"]["value"] <= 1 + 1e-4
    assert set(r["metrics"]) == {"view_ms", "setup_s"}


def test_embedding_altered_where_it_is_produced(monkeypatch):
    """One part in a thousand of every embedding encode_image returns."""
    from feature3dgs_tpu_torch.encoders import sam_encoder
    real = sam_encoder.encode_image
    monkeypatch.setattr(sam_encoder, "encode_image",
                        lambda *a, **k: real(*a, **k) * (1 + 1e-3))
    r = run_tiny()
    assert not r["correct"], r["checks"]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32: 10 mantissa bits, ties away from zero."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _emulated(tf32: bool):
    """``check.precision`` on the CPU: with ``tf32`` every product and
    convolution takes its operands rounded to TF32."""
    if not tf32:
        yield
        return
    F = torch.nn.functional
    real = (F.linear, torch.matmul, torch.einsum, F.conv2d)
    F.linear = lambda x, w, b=None: real[0](_tf32(x), _tf32(w), b)
    torch.matmul = lambda a, b: real[1](_tf32(a), _tf32(b))
    torch.einsum = lambda eq, *ops: real[2](eq, *[_tf32(o) for o in ops])
    F.conv2d = lambda x, w, b=None, *a, **k: real[3](_tf32(x), _tf32(w), b,
                                                     *a, **k)
    try:
        yield
    finally:
        F.linear, torch.matmul, torch.einsum, F.conv2d = real


def test_control_and_faults_fail_the_limits(monkeypatch):
    """The TF32 control fails a limit; each planted fault fails every limit
    of the numbers it reads: the network's faults both embedding gaps, the
    nearest-pixel resize the pixel gap."""
    monkeypatch.setattr(check, "precision", _emulated)
    r = run_tiny(control=True)
    assert r["correct"], r["checks"]
    cell = tiny_cell()
    limits = cell.limits
    tf32 = r["control"]["tf32"]
    assert any(tf32[n] > limits[n] for n in limits), tf32
    frozen = r["control"]["frozen"]
    from port_bench.reference import sam_vit as V
    faults = {k.split(".", 1)[1] for k in frozen}
    assert faults == set(V.FAULTS) | {cell.entry.PIXEL_FAULT}
    for key, v in frozen.items():
        assert v > limits[key.split(".", 1)[0]], (key, frozen)
    for fault in V.FAULTS:
        assert f"embedding_gap.{fault}" in frozen
    assert f"pixel_gap.{cell.entry.PIXEL_FAULT}" in frozen


def test_traced_run_counts_and_records():
    from feature3dgs_tpu_torch import tracing
    from port_bench.yardstick import vit
    r = run_tiny(trace=True)
    assert r["correct"], r["checks"]
    # no card: no device intervals, so no share, launch count or span time
    assert set(r["metrics"]) == {"blocking_calls.serve"}
    summary = tracing.last_session().summary()
    assert summary["counters"]["sam.images"] == 2
    assert summary["counters"]["host_wait.sam_embedding"] == 2
    for name in SPANS.values():
        assert summary["spans"][name]["device_self_ms"] is None
    assert summary["spans"]["sam.window_block"]["count"] == 2 * 2
    cell = tiny_cell()
    assert cell.entry.count(cell.config, {"units": 2}, "cpu") == {
        "ops": 2 * vit.image_ops(TINY_VISION)}


def test_a_program_without_build_sam_fails_before_the_window(tmp_path,
                                                             monkeypatch):
    """As on a program older than ``build_sam``: the run raises at once."""
    from feature3dgs_tpu_torch.encoders import sam_encoder
    monkeypatch.delattr(sam_encoder, "build_sam")
    with pytest.raises(AttributeError, match="build_sam"):
        run_tiny()


def test_a_benchmark_without_the_entry_names_it(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "port_bench" / "entries" / "encode.py").unlink()
    with pytest.raises(FileNotFoundError, match="entries/encode.py"):
        spec.cell(NAME, BENCH, tmp_path / "port_bench")
