"""Segment-sum formulations (instance rows -> per-Gaussian rows) on the
card: the port of ``scripts/micro_segsum.py``.

    python -m feature3dgs_tpu_torch.cli.micro_segsum [--l 552960]
        [--n 100000] [--c 256] [--iters 10] [--device cpu]

The backward writes one gradient row per (Gaussian, tile) instance, and
each Gaussian's gradient is the sum of its rows. The inputs are the
script's numpy draws in its order (``build_inputs``): d_slab [l, c] and
owner ids gid [l] in [0, n), a quarter of them the dropped id n. Every
variant (the script's five by name, then the port's ``segment_plan_sum``)
is held against the first with the script's check (``check_close``:
``assert_allclose``'s atol 1e-3 and rtol 1e-7, on the card; a
disagreement raises), then timed: a CUDA-event span of a
synchronised call, median of ``--iters`` (``bench_utils.profiled_step_ms``).
The first line names the card and its power limit; then one line a
variant, the script's (name, ms, sizes, platform) and its bytes bound: the
live rows of d_slab and gid read once and the [n, c] sums written once, at
``bench_utils.PEAK_BYTES``.

Eager PyTorch has no compiler that fuses a gather into a scatter or not,
so the script's five formulations map onto the eager calls each variant's
docstring names.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser

import numpy as np
import torch

from feature3dgs_tpu_torch.ops.segment import SegmentPlan


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description="Segment-sum formulations (PyTorch "
                        "port of scripts/micro_segsum.py)")
    ap.add_argument("--l", type=int, default=552_960, help="instance rows")
    ap.add_argument("--n", type=int, default=100_000, help="gaussians")
    ap.add_argument("--c", type=int, default=256, help="lanes")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def build_inputs(l: int, n: int, c: int):
    """The script's (d_slab [l, c] float32, gid [l] int32), drawn from
    RandomState(0) in its order (scripts/micro_segsum.py:38-43)."""
    rng = np.random.RandomState(0)
    d_slab = rng.randn(l, c).astype(np.float32)
    # ~75% live rows with tile-ordered (unsorted by id) owners
    gid = rng.randint(0, n, size=l).astype(np.int32)
    gid[rng.rand(l) < 0.25] = n
    return d_slab, gid


def plain_at_add(d, s, n):
    """``index_add_`` into n + 1 rows (the dropped rows all add into row
    n), then ``[:n]``: float atomics, in no fixed order."""
    return d.new_zeros((n + 1, d.shape[1])).index_add_(0, s, d)[:n]


def oob_drop(d, s, n):
    """The dead rows left out of the scatter. ``index_add_`` has no mode
    that drops an out-of-range index, so a boolean compaction removes them
    first: the host reads its size, and the call blocks there."""
    keep = s < n
    return d.new_zeros((n, d.shape[1])).index_add_(0, s[keep], d[keep])


def spill_spread(d, s, n):
    """Dead rows spread over 1024 spill rows past n (slot & 1023, as the
    script does), so that a quarter of all rows do not add into one."""
    spill = n + (torch.arange(s.shape[0], device=s.device) & 1023)
    s2 = torch.where(s >= n, spill, s)
    return d.new_zeros((n + 1024, d.shape[1])).index_add_(0, s2, d)[:n]


def sorted_fused(d, s, n):
    """The port's own path, ``ops/segment.py``: a stable sort of the ids,
    then each group summed in that order (no atomics: the same bits every
    run), with the plan built inside the call. On the card the sum is one
    kernel that reads the rows where they lie (``ops/csrc/segment.cu``);
    elsewhere ``segment_reduce`` over the rows gathered into plan order."""
    return SegmentPlan(s, n).sum(d)


def sorted_materialized(d, s, n):
    """A stable sort, an explicit ``d[perm]``, then ``index_add_`` on the
    sorted ids (the script's control)."""
    sid, perm = torch.sort(s, stable=True)
    return d.new_zeros((n + 1, d.shape[1])).index_add_(0, sid, d[perm])[:n]


def check_close(name: str, got, ref) -> None:
    """The script's check, ``assert_allclose(got, ref, atol=1e-3)`` (rtol
    1e-7), on the tensors' device."""
    if not torch.allclose(got, ref, rtol=1e-7, atol=1e-3):
        err = float((got - ref).abs().max())
        raise AssertionError(f"micro_segsum: {name} differs from "
                             f"plain_at_add by {err} (atol 1e-3)")


VARIANTS = (("plain_at_add", plain_at_add), ("oob_drop", oob_drop),
            ("spill_spread", spill_spread), ("sorted_fused", sorted_fused),
            ("sorted_materialized", sorted_materialized))


def variants(gid: torch.Tensor, n: int) -> list:
    """(name, fn(d, s)) of the script's five and ``segment_plan_sum``:
    ``SegmentPlan.sum`` with the plan of ``gid`` built here, outside the
    timed call, as the backward builds one plan for all its row arrays. On
    the card that is the segment-sum kernel alone (``ops/csrc/segment.cu``,
    one launch); on the CPU ``segment_reduce(rows[order])``."""
    plan = SegmentPlan(gid, n)
    out = [(name, lambda d, s, fn=fn: fn(d, s, n)) for name, fn in VARIANTS]
    return out + [("segment_plan_sum", lambda d, s: plan.sum(d))]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import (bytes_bound_ms,
                                                   device_label, platform,
                                                   profiled_step_ms)
    dev = default_device(args.device)
    print(device_label(dev), flush=True)
    l, n, c = args.l, args.n, args.c
    d_np, gid_np = build_inputs(l, n, c)
    live = int((gid_np < n).sum())
    bound = bytes_bound_ms(4 * (live * c + l + n * c))
    d_slab = torch.from_numpy(d_np).to(dev)
    seg = torch.from_numpy(gid_np).to(dev)
    del d_np
    ref = None
    for name, fn in variants(seg, n):
        out = fn(d_slab, seg)
        if ref is None:
            ref = out
        else:
            check_close(name, out, ref)
        ms = profiled_step_ms(lambda: fn(d_slab, seg), n=args.iters,
                              device=dev)
        print(f"{name:22s} {ms:8.4f} ms   [{l}x{c} -> {n}x{c}, "
              f"{platform(dev)}]   bound {bound:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
