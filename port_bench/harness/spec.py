"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; each lives in a file of its own under this benchmark's
folder, found by name:

  configs/<config>.json   sizes, the scene recipe and the resume state
  traffic/<traffic>.json  the entry driven and its loop
  limits/<workload>.json  the correctness limits of one cell
  metrics/<metric>.py     one reader per metric, ``read(ctx)``

A new configuration, traffic mix, cell or metric is new files and new
entries in ``BENCHMARK.json``; no file that is there changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parents[1]


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list       # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path | None = None) -> dict:
    root = HERE.parent if root is None else Path(root)
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` with its files read from ``base``."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    config = load_json(base / "configs" / f"{w['config']}.json")
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    limits = load_json(base / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str, base: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, ctx: dict, base: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read in ``ctx``."""
    out = {}
    for m in entries:
        value = reader(m["name"], base)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
