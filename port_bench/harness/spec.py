"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; each lives in a file of its own under this benchmark's
folder, found by name:

  configs/<config>.json   sizes, the scene recipe and the resume state
  traffic/<traffic>.json  the entry driven (its "entry") and its loop
  entries/<entry>.py      the kind of work a traffic mix drives
  limits/<workload>.json  the correctness limits of one cell
  metrics/<metric>.py     one reader per metric, ``read(ctx)``

An entry module holds all that is particular to its kind of work:
  run(cfg, traffic, seed, seconds, device, trace_on) -> out
      sets the program up from the seed, warms it up, drives it for
      ``seconds`` and returns {"unit_kind", "units", "window_s",
      "setup_end", "attempted", "failed", "readings", "peak_bytes"} and
      optionally "latencies_s", "inputs" and "traced" (a
      ``trace.profiled`` window with "units", and what ``count`` reads);
  reference(cfg, traffic, seed, out, device, tf32=False) -> readings
      the plain reference's readings of what ``out`` holds, worked out
      from the seed, in the control's lower precision with ``tf32``;
  numbers(prog, ref) -> {name: value}, the numbers the limits bound;
  count(cfg, traced, device) -> {key: value}
      the traced window's work, added to ``ctx["traced"]`` for the metric
      readers ({} where there is nothing to count);
  and, for the control's further readings (calibration only), optionally
  frozen(cfg, traffic, seed, out, device) -> readings with a fault
  planted, and leaves(prog, ref) -> each leaf's gaps.
The readers see ``ctx["kind"]`` = ``out["unit_kind"]``.

A new configuration, traffic mix, kind of work, cell or metric is new
files and new entries in ``BENCHMARK.json``; no file that is there changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

HERE = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list       # BENCHMARK.json metric entries this cell reports
    per_layer: list
    entry: ModuleType   # entries/<the traffic's entry>.py


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
    mod = entry(traffic["entry"], base)
    limits = load_json(base / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], mod)


def _load(path: Path, prefix: str, name: str) -> ModuleType:
    """The module in ``path``, loaded under a name of its own."""
    full = prefix + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod     # where a dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, base: Path = HERE) -> ModuleType:
    """The module ``entries/<name>.py``."""
    path = base / "entries" / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise FileNotFoundError(f"the traffic's entry {name!r} names "
                                f"entries/{name}.py, which {base} lacks")
    return _load(path, "port_bench_entry_", name)


def reader(metric: str, base: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _load(base / "metrics" / f"{metric}.py", "port_bench_metric_",
                 metric).read


def read_metrics(entries: list, ctx: dict, base: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read in ``ctx``."""
    out = {}
    for m in entries:
        value = reader(m["name"], base)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
