"""The metrics that read the program's own spans and counters
(``harness/program_trace.py``): on the CPU a traced tiny cell fills the
counters and leaves every time out, and a program without the tracing
module gives no number and no error."""
from __future__ import annotations

import sys

import pytest
from conftest import ROOT, run_tiny

from port_bench.harness import spec

BENCH = spec.benchmark(ROOT)
PROGRAM = {m["name"]: m for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")
           and not m["name"].startswith("blocking_calls.")}
SPANS = {"raster.preprocess", "raster.binning", "loss.resize", "decoder",
         "raster.segment_sum", "optim.adam"}


def test_thirteen_program_metrics():
    assert len(PROGRAM) == 13
    for name, m in PROGRAM.items():
        kind = name.rsplit(".", 1)[1]
        assert m["moves"] == ("train_step_ms" if kind == "train"
                              else "view_ms")
        assert all(w.startswith(kind) for w in m["workloads"])


@pytest.mark.parametrize("cell_name", ["train_lseg128su_steady",
                                       "serve_lseg128su_batch8"])
def test_traced_tiny_cell_fills_counters_not_times(cell_name):
    from feature3dgs_tpu_torch import tracing
    cell = spec.cell(cell_name, BENCH)
    r = run_tiny(cell, trace=True)
    mine = {m["name"] for m in cell.per_layer} & set(PROGRAM)
    counters = {n for n in mine if PROGRAM[n]["source"] == "program_counter"}
    assert counters and counters <= set(r["metrics"])
    for n in counters:
        assert r["metrics"][n]["value"] > 0
    # the spans were recorded; only their card times are missing here
    summary = tracing.last_session().summary()
    for n in mine - counters:
        assert n not in r["metrics"]
    recorded = set(summary["spans"])
    assert {"raster.preprocess", "raster.binning", "decoder"} <= recorded
    for s in recorded:
        assert summary["spans"][s]["device_self_ms"] is None
        assert summary["spans"][s]["host_ms"] > 0


def test_program_without_tracing_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "feature3dgs_tpu_torch.tracing", None)
    ctx = {"kind": "train", "traced": {"units": 10}}
    for name in PROGRAM:
        kind = name.rsplit(".", 1)[1]
        assert spec.reader(name)(dict(ctx, kind=kind)) is None
