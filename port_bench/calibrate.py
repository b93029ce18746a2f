"""Readings for the correctness limits: runs of one cell on many seeds in
one process, each with the program's numbers and, optionally, the
control's (the reference computed in TF32 in the program's place).

    python port_bench/calibrate.py --workload <name> --seeds 11 12 13
        [--control 11 12 13] [--seconds 2]

One JSON line a seed: {"seed", "correct", "checks", "control"?,
"metrics"}. The benchmark's own runs never call this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import run  # noqa: E402
from port_bench.harness import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload, spec.benchmark(ROOT))
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run.run_cell(cell, seed, args.seconds, False,
                         torch.device("cuda"), t0,
                         control=seed in args.control)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "checks": r["checks"],
                          "control": r.get("control"),
                          "metrics": r["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
