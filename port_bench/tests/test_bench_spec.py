"""BENCHMARK.json against the benchmark's contract, every part of every cell
found by name, and a new cell added with files alone."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT, SEED, TINY_CONFIG, TINY_TRAFFIC

from port_bench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = spec.benchmark(ROOT)


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in names
        names.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert e["moves"] in e2e


def test_every_cell_reports_its_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for name in cells:
        cell = spec.cell(name, BENCH)
        names = {m["name"] for m in cell.metrics}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            # the metric it moves is reported in the same cell
            assert m["moves"] in names


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_parts_found_by_name(w):
    cell = spec.cell(w["name"], BENCH)
    assert cell.config["name"] == w["config"]
    assert cell.traffic["entry"] in ("train", "serve")
    assert cell.limits
    for m in cell.metrics + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_config_files_hold_the_configurations():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["feature_dim"] == 512


def test_a_cell_added_with_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, metric and cell, added to a
    copy of the benchmark as new files and new entries only, run there."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    base = tmp_path / "port_bench"
    cfg = json.loads((base / "configs" / "lseg128_speedup.json").read_text())
    cfg.update(TINY_CONFIG, name="tiny_sh1", sh_degree=1)
    cfg["source"] = "a throwaway test configuration"
    (base / "configs" / "tiny_sh1.json").write_text(json.dumps(cfg))
    traffic = dict(json.loads((base / "traffic" / "serve_view.json")
                              .read_text()), **TINY_TRAFFIC["serve"])
    traffic["batch"] = 2
    (base / "traffic" / "serve_pair.json").write_text(json.dumps(traffic))
    (base / "limits" / "serve_tiny_pair.json").write_text(json.dumps(
        json.loads((base / "limits" / "serve_lseg128su_view.json")
                   .read_text())))
    (base / "metrics" / "views_done.py").write_text(textwrap.dedent('''
        def read(ctx):
            return ctx["units"]
        '''))
    bench["configs"].append({"name": "tiny_sh1", "source": cfg["source"],
                             "file": "port_bench/configs/tiny_sh1.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "serve_tiny_pair", "config": "tiny_sh1",
                               "traffic": "serve_pair", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "views_done", "unit": "views",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["serve_tiny_pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent(f'''
        import json, sys, time
        import torch
        torch.set_num_threads(2)
        import port_bench
        assert port_bench.__file__.startswith({str(tmp_path)!r})
        from port_bench import run
        from port_bench.harness import spec
        cell = spec.cell("serve_tiny_pair", spec.benchmark())
        r = run.run_cell(cell, {SEED}, 0.3, False, torch.device("cpu"),
                         time.perf_counter())
        print(json.dumps(r))
        ''')
    env = {"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin"}
    done = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    r = json.loads(done.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["metrics"]["views_done"]["value"] >= 2
    assert r["metrics"]["views_done"]["value"] % 2 == 0
    # peak memory reads nothing on the CPU; view_ms and the p95 list other
    # cells
    assert set(r["metrics"]) == {"views_done", "setup_s"}
