"""The port's benchmark: one run of one cell.

    python port_bench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Runs from the root of a checkout holding ``BENCHMARK.json``, this folder and
the program (``feature3dgs_tpu_torch``). The cell's configuration, traffic
mix, entry, limits and metric readers are found by name
(``harness/spec.py``). The entry (``entries/<entry>.py``) makes its inputs
from the seed on the card, sets the program up and warms it up
(``setup_s``), drives the traffic for ``--seconds``, reads the peak memory
and frees the program's state; the run then compares what the timed path
produced with the entry's plain reference (``harness/check.py``). With
``--trace 1`` the entry also profiles a short window, and the run reports
the per-layer metrics, the device's busy time and a breakdown; otherwise
the end-to-end metrics.

The last lines on standard error are the numbers compared, each with its
limit; the last line on standard output is the result:
  {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
   "checks"}
It exits non-zero, printing no result, without a CUDA card (or fewer cards
than the cell asks for), and if JAX or the JAX package was imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# caches at fixed places inside the checkout; transformers must not load JAX
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from port_bench.harness import check, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "feature3dgs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
             device: torch.device, t_start: float, control: bool = False
             ) -> dict:
    """One run of ``cell``: the result's keys, "checks" last. With
    ``control`` the result also holds "control": the numbers of the
    reference computed in the precision below put in the program's place
    (calibration only; the benchmark's runs never compute it)."""
    cfg, traffic, entry = cell.config, cell.traffic, cell.entry
    out = entry.run(cfg, traffic, seed, seconds, device, trace_on)
    kind = out["unit_kind"]
    ctx = {"kind": kind, "units": out["units"], "window_s": out["window_s"],
           "latencies_s": out.get("latencies_s"),
           "setup_s": out["setup_end"] - t_start,
           "peak_bytes": out["peak_bytes"]}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    breakdown = None
    traced = out.pop("traced", None)
    if traced is not None:
        events, window = traced.pop("events"), traced.pop("window")
        iv = (trace.device_intervals(events, window)
              if device.type == "cuda" else [])
        counted = entry.count(cfg, traced, device)
        ctx["traced"] = dict(traced, **counted, intervals=iv,
                             busy_s=trace.busy_us(iv) / 1e6,
                             window_s=(window[1] - window[0]) / 1e6)
        if iv:
            breakdown = {"device_ops": trace.top_ops(iv),
                         "idle_gaps": trace.idle_gaps(events, iv, window)}
        del events

    t_check = time.perf_counter()
    numbers = check.run(entry, cfg, traffic, seed, out, device)
    print(f"reference: {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    correct, checks = check.judge(numbers, cell.limits)
    controlled = (check.control(entry, cfg, traffic, seed, out, device)
                  if control else None)
    metrics = spec.read_metrics(cell.per_layer if trace_on else cell.metrics,
                                ctx)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(out["peak_bytes"])}
    if trace_on:
        dev.update(busy_s=ctx["traced"]["busy_s"],
                   window_s=ctx["traced"]["window_s"])
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if controlled is not None:
        result["control"] = controlled
    result["checks"] = checks
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the card only",
              file=sys.stderr)
        return 2
    cell = spec.cell(args.workload, spec.benchmark(ROOT))
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
