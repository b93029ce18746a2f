"""The LSeg export's cell, ``encode_lsegvitl16_export``, at a tiny width on
the CPU: its parts found by name, a sound run correct, a run whose map is
altered where it is produced not correct, nor one whose export is one fp16
step off with its network output sound, the planted faults and the TF32
control each over the limits, a traced run's counters and count, and a
program without ``export_features`` stopped before anything is drawn. On
the CPU TF32 does nothing, so there the control's products take their
operands rounded to TF32's 10-bit mantissa, as the card's tensor cores do;
on the card ``test_bench_control.py`` holds the real one.

    python -m pytest port_bench/tests/test_bench_encode_lseg.py -q
"""
from __future__ import annotations

import contextlib
import time

import pytest
import torch

from conftest import ROOT, SEED

from port_bench import run
from port_bench.harness import check, spec

BENCH = spec.benchmark(ROOT)
NAME = "encode_lsegvitl16_export"
# test_torch_encoders.py's tiny widths; five blocks, so that the hooks can
# move one block early
TINY_NET = dict(vit_dim=32, vit_depth=5, vit_heads=2, patch=8,
                hooks=[1, 2, 3, 4], reassemble=[8, 8, 8, 8], features=8,
                out_c=16, img_size=32)
TINY_IMAGE = dict(width=96, height=64)
TINY_TRAFFIC = dict(distinct_images=3, warmup_images=1, trace_images=2,
                    blocking_images=1)
SPANS = {"lseg_prep_ms.serve": ("lseg.preprocess",),
         "lseg_vit_ms.serve": ("lseg.block",),
         "lseg_dpt_ms.serve": ("lseg.reassemble", "lseg.fusion",
                               "lseg.head"),
         "lseg_export_ms.serve": ("lseg.export",)}


def tiny_cell():
    cell = spec.cell(NAME, BENCH)
    return cell._replace(config=dict(cell.config, net=TINY_NET,
                                     image=TINY_IMAGE),
                         traffic=dict(cell.traffic, **TINY_TRAFFIC))


def run_tiny(trace=False, control=False, seed=SEED):
    return run.run_cell(tiny_cell(), seed, 0.3, trace, torch.device("cpu"),
                        time.perf_counter(), control=control)


def test_parts_found_by_name():
    cell = spec.cell(NAME, BENCH)
    assert cell.chips == 1 and cell.config["name"] == "lseg_vitl16"
    assert cell.config["reduced"] == []
    assert cell.traffic["entry"] == "encode_lseg"
    for part in ("run", "reference", "numbers", "count", "frozen"):
        assert callable(getattr(cell.entry, part))
    assert set(cell.limits) == {"feature_gap", "feature_max_gap",
                                "export_gap"}
    assert {m["name"] for m in cell.metrics} == {"view_ms", "peak_mem_gib",
                                                 "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(SPANS) | {
        "lseg_vit_roofline.serve", "mfu.serve", "idle_share.serve",
        "launches.serve", "blocking_calls.serve", "host_waits.serve"}
    for m in cell.metrics + cell.per_layer:
        assert callable(spec.reader(m["name"]))
        if m["name"].startswith("lseg_"):
            assert m["workloads"] == [NAME] and m["moves"] == "view_ms"


def test_sound_run_is_correct():
    r = run_tiny()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for name in ("feature_gap", "feature_max_gap"):
        c = r["checks"][name]
        assert c["value"] < c["limit"] / 10
    # the export chain alone: the reference's chain on the program's own
    # float32 map gives the program's export bit for bit
    assert r["checks"]["export_gap"]["value"] == 0
    assert set(r["metrics"]) == {"view_ms", "setup_s"}


def test_map_altered_where_it_is_produced(monkeypatch):
    """One part in a thousand of every map the network returns."""
    from feature3dgs_tpu_torch.encoders import lseg_net
    real = lseg_net.build_lseg

    def build(*a, **k):
        net = real(*a, **k)
        net.register_forward_hook(lambda m, args, out: out * (1 + 1e-3))
        return net

    monkeypatch.setattr(lseg_net, "build_lseg", build)
    r = run_tiny()
    assert not r["correct"], r["checks"]
    assert r["checks"]["feature_gap"]["value"] > 5e-4


def test_export_one_fp16_step_off(monkeypatch):
    """Every exported value one fp16 step up, the network's output
    untouched: only the export gap sees it."""
    from feature3dgs_tpu_torch.encoders import lseg_net
    real = lseg_net.export_features

    def export(*a, **k):
        e = real(*a, **k)
        return torch.nextafter(e, torch.full_like(e, float("inf")))

    monkeypatch.setattr(lseg_net, "export_features", export)
    r = run_tiny()
    assert not r["correct"], r["checks"]
    assert r["checks"]["feature_gap"]["value"] == 0
    assert r["checks"]["feature_max_gap"]["value"] == 0
    c = r["checks"]["export_gap"]
    assert c["value"] > c["limit"], c


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
    real = (F.linear, torch.matmul, F.conv2d, F.conv_transpose2d)
    F.linear = lambda x, w, b=None: real[0](_tf32(x), _tf32(w), b)
    torch.matmul = lambda a, b: real[1](_tf32(a), _tf32(b))
    F.conv2d = lambda x, w, b=None, *a, **k: real[2](_tf32(x), _tf32(w), b,
                                                     *a, **k)
    F.conv_transpose2d = lambda x, w, b=None, *a, **k: real[3](
        _tf32(x), _tf32(w), b, *a, **k)
    try:
        yield
    finally:
        F.linear, torch.matmul, F.conv2d, F.conv_transpose2d = real


def test_control_and_faults_fail_the_limits(monkeypatch):
    """The TF32 control fails a limit; each planted fault fails every limit
    of the numbers it reads: the network's faults both feature gaps and
    the export gap, the stride resize with aligned corners the export
    gap."""
    from port_bench.reference import lseg_dpt as L
    monkeypatch.setattr(check, "precision", _emulated)
    r = run_tiny(control=True)
    assert r["correct"], r["checks"]
    limits = tiny_cell().limits
    tf32 = r["control"]["tf32"]
    assert any(tf32[n] > limits[n] for n in limits), tf32
    frozen = r["control"]["frozen"]
    faults = {k.split(".", 1)[1] for k in frozen}
    assert faults == set(L.FAULTS) | {L.EXPORT_FAULT}
    for key, v in frozen.items():
        assert v > limits[key.split(".", 1)[0]], (key, frozen)
    for fault in L.FAULTS:
        assert {f"{n}.{fault}" for n in limits} <= set(frozen)
    assert f"export_gap.{L.EXPORT_FAULT}" in frozen


def test_traced_run_counts_and_records():
    from feature3dgs_tpu_torch import tracing
    from port_bench.yardstick import lseg
    r = run_tiny(trace=True)
    assert r["correct"], r["checks"]
    # no card: no device intervals, so no share, launch count or span time
    assert set(r["metrics"]) == {"blocking_calls.serve", "host_waits.serve"}
    assert r["metrics"]["host_waits.serve"]["value"] == 2
    summary = tracing.last_session().summary()
    assert summary["counters"]["lseg.images"] == 2
    assert summary["counters"]["lseg.tokens"] == 2 * (8 * 12 + 1)
    assert summary["counters"]["host_wait.lseg_export"] == 2
    for names in SPANS.values():
        for name in names:
            assert summary["spans"][name]["device_self_ms"] is None
    assert summary["spans"]["lseg.block"]["count"] == 2 * 5
    cell = tiny_cell()
    ops = lseg.image_ops(TINY_NET, 64, 96)
    assert cell.entry.count(cell.config, {"units": 2}, "cpu") == dict(
        {k: 2 * v for k, v in ops.items()}, ops=2 * sum(ops.values()))


def test_a_program_without_export_features_stops_before_drawing(
        monkeypatch):
    """As on a program older than ``export_features``: the run raises at
    once, before the images or the weights are drawn."""
    from feature3dgs_tpu_torch.encoders import lseg_net
    cell = tiny_cell()
    drawn = []
    monkeypatch.setattr(cell.entry, "draw_images",
                        lambda *a: drawn.append("images"))
    monkeypatch.setattr(cell.entry, "weights",
                        lambda *a: drawn.append("weights"))
    monkeypatch.delattr(lseg_net, "export_features")
    with pytest.raises(RuntimeError, match="export_features"):
        run.run_cell(cell, SEED, 0.3, False, torch.device("cpu"),
                     time.perf_counter())
    assert drawn == []
