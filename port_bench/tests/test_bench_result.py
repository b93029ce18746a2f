"""The run's result line and its refusals: the keys the driver reads, the
checks last, no result without a card, and none without the program."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT, SEED, run_tiny

from port_bench.harness import spec

BENCH = spec.benchmark(ROOT)
UNITS = {m["name"]: m["unit"]
         for m in BENCH["end_to_end"] + BENCH["per_layer"]}


def test_result_keys_traced_and_untraced():
    for name, trace in (("train_lseg128su_steady", True),
                        ("serve_lseg128su_view", False)):
        cell = spec.cell(name, BENCH)
        r = run_tiny(cell, trace=trace)
        assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                               "device"]
        assert list(r)[-1] == "checks"
        assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
        assert set(r["device"]) >= {"platform", "kind", "count",
                                    "memory_peak_bytes"}
        if trace:
            assert {"busy_s", "window_s"} <= set(r["device"])
        wanted = {m["name"] for m in (cell.per_layer if trace
                                      else cell.metrics)}
        assert set(r["metrics"]) <= wanted
        for k, v in r["metrics"].items():
            assert v["unit"] == UNITS[k] and isinstance(v["value"], float)
        for k, c in r["checks"].items():
            assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
        json.dumps(r)


def test_no_card_no_result():
    done = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "serve_lseg128su_view", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert done.returncode != 0 and done.stdout == ""


def test_no_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and this folder: the run
    fails for want of the program (the look for a card skipped)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = textwrap.dedent(f'''
        import json, sys, time
        sys.path.insert(0, {str(tmp_path / "port_bench" / "tests")!r})
        import torch
        from port_bench.harness import spec
        from conftest import run_tiny
        r = run_tiny(spec.cell("serve_lseg128su_view", spec.benchmark()))
        print(json.dumps(r))
        ''')
    done = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(tmp_path),
                               "PATH": "/usr/bin:/bin"})
    assert done.returncode != 0 and done.stdout == ""
    assert "feature3dgs_tpu_torch" in done.stderr
