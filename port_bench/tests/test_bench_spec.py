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
    assert (spec.HERE / "entries" / f"{cell.traffic['entry']}.py").is_file()
    for part in ("run", "reference", "numbers", "count"):
        assert callable(getattr(cell.entry, part))
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


TOY_ENTRY = '''
"""A seeded matrix product: the program's side in float32, its reference
in float64 (float32 for the control)."""
import time

import torch

from port_bench.harness import trace


def product(a, b):
    return a @ b


def inputs(cfg, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    n = cfg["size"]
    return (torch.randn(n, n, generator=g, device=device),
            torch.randn(n, n, generator=g, device=device))


def run(cfg, traffic, seed, seconds, device, trace_on):
    a, b = inputs(cfg, seed, device)
    for _ in range(traffic["warmup"]):
        product(a, b)
    setup_end = t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        c = product(a, b)
        n += 1
    out = {"unit_kind": "product", "units": n,
           "window_s": time.perf_counter() - t0, "setup_end": setup_end,
           "attempted": n, "failed": 0, "readings": {"c": c},
           "peak_bytes": 0}
    if trace_on:
        traced = {}
        with trace.profiled(device, traced):
            for _ in range(traffic["traced"]):
                product(a, b)
        traced["units"] = traffic["traced"]
        out["traced"] = traced
    return out


def reference(cfg, traffic, seed, out, device, tf32=False):
    a, b = inputs(cfg, seed, device)
    dtype = torch.float32 if tf32 else torch.float64
    return {"c": a.to(dtype) @ b.to(dtype)}


def numbers(prog, ref):
    r = ref["c"].double()
    gap = (prog["c"].double() - r).abs().max() / r.abs().max()
    return {"product_gap": float(gap)}


def count(cfg, traced, device):
    return {"ops": 2 * cfg["size"] ** 3}
'''

TOY_READERS = {
    "product_ms": '''
def read(ctx):
    if ctx["kind"] != "product" or not ctx["units"]:
        return None
    return 1e3 * ctx["window_s"] / ctx["units"]
''',
    "product_mops": '''
def read(ctx):
    t = ctx.get("traced")
    if ctx["kind"] != "product" or t is None:
        return None
    return t["ops"] / 1e6
'''}


def _toy_copy(tmp_path, entry="toy_product"):
    """A copy of the benchmark with a new kind of work (a matrix product)
    added as new files and new entries only: its entry, configuration,
    traffic mix, limits, two metric readers and one cell."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "port_bench"
    (base / "entries" / "toy_product.py").write_text(TOY_ENTRY)
    (base / "configs" / "toy_64.json").write_text(json.dumps(
        {"name": "toy_64", "source": "a throwaway test configuration",
         "size": 64}))
    (base / "traffic" / "toy_loop.json").write_text(json.dumps(
        {"entry": entry, "warmup": 2, "traced": 3}))
    (base / "limits" / "toy_64_loop.json").write_text(json.dumps(
        {"product_gap": 1e-4}))
    for name, src in TOY_READERS.items():
        (base / "metrics" / f"{name}.py").write_text(src)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy_64", "source": "test",
                             "file": "port_bench/configs/toy_64.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy_64_loop", "config": "toy_64",
                               "traffic": "toy_loop", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "product_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["toy_64_loop"]})
    bench["per_layer"].append({"name": "product_mops", "unit": "Mop",
                               "better": "higher", "source": "device_trace",
                               "layer": "toy", "moves": "product_ms",
                               "workloads": ["toy_64_loop"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, base


@pytest.mark.parametrize("case", ["sound", "traced", "perturbed"])
def test_a_kind_of_work_added_with_files_alone(tmp_path, case):
    """The toy cell runs through ``run.run_cell`` from the copy: sound it is
    correct and reports its own metrics; with its answer altered where it is
    produced, by one part in a thousand, it is not correct."""
    _toy_copy(tmp_path)
    script = textwrap.dedent(f'''
        import json, sys, time
        import torch
        torch.set_num_threads(2)
        import port_bench
        assert port_bench.__file__.startswith({str(tmp_path)!r})
        from port_bench import run
        from port_bench.harness import spec
        cell = spec.cell("toy_64_loop", spec.benchmark())
        if {case == "perturbed"}:
            real = cell.entry.product
            cell.entry.product = lambda a, b: real(a, b) * (1 + 1e-3)
        r = run.run_cell(cell, {SEED}, 0.2, {case == "traced"},
                         torch.device("cpu"), time.perf_counter())
        print(json.dumps(r))
        ''')
    env = {"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin"}
    done = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    r = json.loads(done.stdout.strip().splitlines()[-1])
    gap = r["checks"]["product_gap"]
    assert set(r["checks"]) == {"product_gap"} and gap["limit"] == 1e-4
    if case == "perturbed":
        assert not r["correct"] and gap["value"] > 5e-4, r["checks"]
        return
    assert r["correct"] and gap["value"] < 1e-5, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    if case == "traced":
        assert r["metrics"] == {"product_mops": {"value": 2 * 64 ** 3 / 1e6,
                                                 "unit": "Mop"}}
    else:
        assert set(r["metrics"]) == {"product_ms", "setup_s"}


def test_a_missing_entry_is_named_before_anything_is_drawn(tmp_path):
    bench, base = _toy_copy(tmp_path, entry="toy_absent")
    with pytest.raises(FileNotFoundError, match="entries/toy_absent.py"):
        spec.cell("toy_64_loop", bench, base)
